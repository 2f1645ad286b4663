"""The port's single-proof verifier (plonky25_torch.verifier) against the
JAX package's, field for field: the fixture proof
(tests/fixtures/proof_fibonacci_refimpl.json, made by
scripts/make_torch_fixtures.py) and the two small proofs of
artifacts/attestation_small.json, the transcript, the tamper battery of
tests/test_verifier_e2e.py, and the witness carried across from JAX.  The
JAX verifier's results on these proofs are computed once by
scripts/make_torch_fixtures.py (tests/fixtures/torch_tests_jax_values.json)
instead of compiling the JAX verifier in every run."""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

import plonky25_torch.proof as tproof
import plonky25_tpu.proof as jproof
from plonky25_torch.constants import GOLDILOCKS_P as P
from plonky25_torch.convert import from_jax
from plonky25_torch.fields import gl as tgl
from plonky25_torch.models import FibonacciAir as TFib
from plonky25_torch.verifier import get_verifier as t_get_verifier
from plonky25_torch.verifier import verify_proof as t_verify
from plonky25_torch.witness import pack_witness as t_pack
from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.models.fibonacci import FibonacciAir as JFib
from plonky25_tpu.verifier import verify_proof as j_verify
from plonky25_tpu.witness import pack_witness as j_pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
CASES = ["fixture", "small0", "small1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the test run
    shares the CPU between several worker processes, and PyTorch's default
    of one thread per core in each of them oversubscribes it (see
    tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_case(name):
    """(proof JSON, FriConfig kwargs) of a named case."""
    if name == "fixture":
        with open(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json")) as f:
            return json.load(f), dict(log_blowup=1, num_queries=100,
                                      proof_of_work_bits=16)
    with open(os.path.join(ROOT, "artifacts", "attestation_small.json")) as f:
        blob = json.load(f)
    return blob["proofs"][int(name[-1])], blob["fc"]


def _jax_fields(d):
    """A result of the JAX verify_proof as stored by the fixture script:
    the fields of _fields, alpha and zeta as tuples."""
    return {k: tuple(v) if k in ("alpha", "zeta") else v
            for k, v in d.items()}


@pytest.fixture(scope="module")
def jax_values():
    with open(os.path.join(FIXTURES, "torch_tests_jax_values.json")) as f:
        return json.load(f)


class Case:
    """One proof in both packages' types, with both packages' verdicts (the
    JAX package's from the fixture file)."""

    def __init__(self, name, jax_values):
        obj, fc = _load_case(name)
        self.t_proof = tproof.proof_from_json(obj)
        self.j_proof = jproof.proof_from_json(obj)
        self.t_fc = tproof.FriConfig(**fc)
        self.j_fc = jproof.FriConfig(**fc)
        self.t_result = t_verify(self.t_proof, TFib(), self.t_fc, device="cpu")
        self.jax = jax_values["verifier"][name]
        self.j_fields = _jax_fields(self.jax["fields"])


@pytest.fixture(scope="module")
def cases(jax_values):
    return {name: Case(name, jax_values) for name in CASES}


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(FIXTURES, "proof_fibonacci_expected.json")) as f:
        return json.load(f)


def _ext(x, to_u64):
    return (int(to_u64(x.c0)), int(to_u64(x.c1)))


def _fields(r, to_u64):
    """Every VerifyResult field as plain Python values."""
    out = {k: bool(np.asarray(getattr(r, k))) for k in
           ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok", "shape_ok")}
    if r.shape_ok:
        out["alpha"] = _ext(r.alpha, to_u64)
        out["zeta"] = _ext(r.zeta, to_u64)
        out["query_indices"] = np.asarray(r.query_indices).tolist()
    return out


def _t_fields(r):
    return _fields(r, tgl.to_u64)


def _j_fields(r):
    return _fields(r, jgl.to_u64)


@pytest.mark.parametrize("name", CASES)
def test_proof_json_round_trip_is_exact(name):
    obj, _ = _load_case(name)
    back = tproof.proof_to_json(tproof.proof_from_json(obj))
    assert back == obj == jproof.proof_to_json(jproof.proof_from_json(obj))
    if name == "fixture":
        with open(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json")) as f:
            assert json.dumps(back, separators=(",", ":")) == f.read()


def test_fixture_accepted_with_the_expected_transcript(cases, expected):
    got = _t_fields(cases["fixture"].t_result)
    assert got["ok"] and got["shape_ok"]
    assert {k: got[k] for k in expected["verdict"]} == expected["verdict"]
    assert list(got["alpha"]) == expected["alpha"]
    assert list(got["zeta"]) == expected["zeta"]
    assert got["query_indices"] == expected["query_indices"]


@pytest.mark.parametrize("name", CASES)
def test_result_fields_match_jax(cases, name):
    c = cases[name]
    assert _t_fields(c.t_result) == c.j_fields
    assert _t_fields(c.t_result)["ok"]


@pytest.mark.parametrize("name", CASES)
def test_transcript_samples_match_jax(cases, name):
    c = cases[name]
    t_cfg = tproof.derive_config(c.t_proof, c.t_fc)
    tv = t_get_verifier(TFib(), t_cfg, "cpu")
    j = c.jax
    t = tv._transcript_fn(t_pack(c.t_proof, t_cfg, "cpu")["obs"][None])
    assert tgl.to_u64(t["samples"][0]).tolist() == j["samples"]
    assert t["pow_ok"].tolist() == [j["pow_ok"]]
    assert t["index"][0].tolist() == j["index"]
    chal = tv.fri_challenges(c.t_proof)
    assert [list(b) for b in chal.betas] == j["betas"]
    assert chal.query_indices == j["query_indices"]


def test_fri_challenges_match_the_expected_file(cases, expected):
    c = cases["fixture"]
    tv = t_get_verifier(TFib(), tproof.derive_config(c.t_proof, c.t_fc), "cpu")
    chal = tv.fri_challenges(c.t_proof)
    assert [list(b) for b in chal.betas] == expected["betas"]
    assert chal.query_indices == expected["query_indices"]


def _tamper(proof, kind):
    p = copy.deepcopy(proof)
    fp = p.opening_proof.fri_proof
    if kind == "pow":
        fp.pow_witness += 1
    elif kind == "merkle_sibling":
        p.opening_proof.query_openings[17][0].opening_proof[3][2] ^= 1
    elif kind == "fold_sibling":
        s = fp.query_proofs[5].commit_phase_openings[1]
        s.sibling_value = (s.sibling_value[0] ^ 1, s.sibling_value[1])
    elif kind == "final_poly":
        fp.final_poly = (fp.final_poly[0] + 1, fp.final_poly[1])
    return p


@pytest.mark.parametrize("kind, flag", [
    ("pow", "pow_ok"), ("merkle_sibling", "merkle_ok"),
    ("fold_sibling", "fold_ok"), ("final_poly", "fold_ok")])
def test_tamper_rejected_like_jax(cases, jax_values, kind, flag):
    c = cases["fixture"]
    t = _t_fields(t_verify(_tamper(c.t_proof, kind), TFib(), c.t_fc,
                           device="cpu"))
    j = _jax_fields(jax_values["verifier_tamper"][kind])
    assert t == j
    assert not t["ok"] and not t[flag]


def test_wrong_query_count_is_a_shape_failure(cases):
    c = cases["fixture"]
    t = t_verify(c.t_proof, TFib(),
                 tproof.FriConfig(log_blowup=1, num_queries=99,
                                  proof_of_work_bits=16), device="cpu")
    j = j_verify(c.j_proof, JFib(),
                 jproof.FriConfig(log_blowup=1, num_queries=99,
                                  proof_of_work_bits=16))
    assert _t_fields(t) == _j_fields(j)
    assert not t.shape_ok and not bool(t.ok)


def test_malformed_proof_fails_closed(cases):
    c = cases["fixture"]
    p = copy.deepcopy(c.t_proof)
    del p.opening_proof.query_openings[3][1].opening_proof[-1]
    r = t_verify(p, TFib(), c.t_fc, device="cpu")
    assert not r.shape_ok and not bool(r.ok)


def _leaves(w):
    """Flatten a witness into (path, tensor) pairs."""
    out = []

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out.append((path, x))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (k,))
        else:
            for i, v in enumerate(x):
                walk(v, path + (i,))
    walk(w, ())
    return out


@pytest.fixture(scope="module")
def witnesses(cases):
    c = cases["fixture"]
    t_cfg = tproof.derive_config(c.t_proof, c.t_fc)
    j_cfg = jproof.derive_config(c.j_proof, c.j_fc)
    own = t_pack(c.t_proof, t_cfg, "cpu")
    carried = from_jax(
        jax.tree.map(np.asarray, j_pack(c.j_proof, j_cfg)), device="cpu")
    return t_cfg, own, carried


def test_pack_witness_equals_the_carried_jax_witness(witnesses):
    _, own, carried = witnesses
    a, b = _leaves(own), _leaves(carried)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype == torch.int64, path
        assert torch.equal(x, y), path


def test_verifier_gives_the_same_result_on_both_witnesses(cases, witnesses):
    cfg, own, carried = witnesses
    v = t_get_verifier(TFib(), cfg, "cpu")
    r_own, r_carried = v.verify_witness(own), v.verify_witness(carried)
    assert _t_fields(r_own) == _t_fields(r_carried) == \
        _t_fields(cases["fixture"].t_result)


@pytest.mark.parametrize("widths, depths", [
    ((3, 2), (4, 4)),      # rows fit one sponge chunk: the walks fuse
    ((5, 2), (4, 4)),      # a row wider than RATE: each batch walks alone
    ((3, 2), (4, 3)),      # mixed depths: each batch walks alone
])
def test_batch_all_fn_matches_jax_merkle_walks(widths, depths):
    """_batch_all_fn's verdicts on synthetic openings equal the JAX
    package's verify_batch_single, batch by batch; the commitments are the
    true roots except one corrupted lane per batch."""
    from plonky25_tpu.ops.sponge import hash_rows, merkle_path

    obj, fc = _load_case("fixture")
    cfg = tproof.derive_config(tproof.proof_from_json(obj),
                               tproof.FriConfig(**fc))
    v = t_get_verifier(TFib(), cfg, "cpu")
    rng = np.random.default_rng(sum(widths) + sum(depths))
    n = 6
    index = rng.integers(0, 1 << min(depths), size=n)
    vals, sibs, commits, want = [], [], [], np.ones(n, bool)
    for b, (w, d) in enumerate(zip(widths, depths)):
        rows = rng.integers(0, 1 << 63, size=(n, 1, w), dtype=np.uint64)
        path = rng.integers(0, 1 << 63, size=(n, d, 4), dtype=np.uint64)
        root, _ = merkle_path(hash_rows(jgl.from_u64(rows.reshape(n, w))),
                              index.astype(np.uint32), jgl.from_u64(path))
        root = np.asarray(jgl.to_u64(root), dtype=object)
        root[b + 1, 0] = (root[b + 1, 0] + 1) % P
        want[b + 1] = False
        vals.append(tgl.from_u64(rows, "cpu"))
        sibs.append(tgl.from_u64(path, "cpu"))
        commits.append(tgl.from_u64(root, "cpu"))
    got = v._batch_all_fn(torch.from_numpy(index), vals, sibs, commits)
    assert got.tolist() == want.tolist()


def test_save_proof_is_byte_equal_to_jax(cases, tmp_path):
    """save_proof writes the compact JSON of JAX's save_proof; the fixture
    round-trips through it byte for byte."""
    c = cases["fixture"]
    ours, theirs = tmp_path / "t.json", tmp_path / "j.json"
    tproof.save_proof(c.t_proof, str(ours))
    jproof.save_proof(c.j_proof, str(theirs))
    with open(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json")) as f:
        fixture = f.read()
    assert ours.read_text() == theirs.read_text() == fixture
    assert tproof.proof_to_json(tproof.load_proof(str(ours))) == \
        json.loads(fixture)


def test_error_classes_match_jax():
    import plonky25_torch
    import plonky25_torch.errors as terr
    import plonky25_tpu.errors as jerr

    for name in ("P25Error", "FriError", "InvalidProofShape",
                 "InvalidPowWitness"):
        t, j = getattr(terr, name), getattr(jerr, name)
        assert [k.__name__ for k in t.__mro__] == \
            [k.__name__ for k in j.__mro__]
        assert getattr(plonky25_torch, name) is t
    assert issubclass(terr.InvalidPowWitness, terr.FriError)
    assert plonky25_torch.check_proof_shape is terr.check_proof_shape


def test_inconsistent_air_is_refused_before_the_d2_guard():
    """An AIR with a challenge and no stage-2 matrix, at ext_degree 3: the
    JAX verifier raises the consistency check's ValueError before its D=2
    guard, and so does the port."""
    import dataclasses

    from plonky25_torch.verifier import TorchVerifier
    from plonky25_tpu.verifier import TpuVerifier

    class TBad(TFib):
        def num_challenges(self):
            return 1

    class JBad(JFib):
        def num_challenges(self):
            return 1

    obj, fc = _load_case("fixture")
    t_cfg = dataclasses.replace(tproof.derive_config(
        tproof.proof_from_json(obj), tproof.FriConfig(**fc)), ext_degree=3)
    j_cfg = dataclasses.replace(jproof.derive_config(
        jproof.proof_from_json(obj), jproof.FriConfig(**fc)), ext_degree=3)
    with pytest.raises(ValueError) as t:
        TorchVerifier(TBad(), t_cfg, device="cpu")
    with pytest.raises(ValueError) as j:
        TpuVerifier(JBad(), j_cfg)
    assert str(t.value) == str(j.value)
    assert "num_challenges()=1 requires stage2_width() > 0" in str(t.value)
    with pytest.raises(NotImplementedError):
        TorchVerifier(TFib(), t_cfg, device="cpu")


def test_exports_match_jax():
    """The names plonky25_tpu and plonky25_tpu.parallel export, apart from
    the multi-device ones (a later slice), are exported by the port."""
    import plonky25_torch
    import plonky25_torch.parallel as tpar
    import plonky25_tpu
    import plonky25_tpu.parallel as jpar

    top = ["FriConfig", "P3Config", "Proof", "load_proof", "proof_from_json",
           "proof_to_json", "save_proof", "derive_config", "Air",
           "VerifierConstraintFolder", "FilteredAirBuilder", "P25Error",
           "FriError", "InvalidProofShape", "InvalidPowWitness",
           "check_proof_shape"]
    par = ["BatchVerifier", "stack_witnesses", "tile_witness",
           "verify_proof_batch"]
    for mod_t, mod_j, names in ((plonky25_torch, plonky25_tpu, top),
                                (tpar, jpar, par)):
        for name in names:
            assert hasattr(mod_j, name) and hasattr(mod_t, name), name
