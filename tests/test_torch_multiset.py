"""MultisetAir in the port: the first AIR with two quotient chunks.  The
port against the JAX package and its int oracle, bit for bit (tolerance
0), on the CPU, at the shape of tests/test_multiset.py (16 rows,
FriConfig(1, 4, 2)):

  * the two-chunk quotient piece by piece against the JAX TpuProver and
    TpuVerifier stages: the quotient evaluations, the chunks' committed
    LDE rows and root, the opened chunks, the verifier's reconstruction;
  * pad_pairs, the stage-2 grand product against the JAX and host
    builders, its zero-denominator error;
  * prove(device="cpu") byte-equal to refimpl.prover.prove, VerifyResult
    equal to plonky25_tpu.verifier.verify_proof on a permutation and on
    the non-permutations of tests/test_multiset.py:59-85.
"""

import json
import random

import jax
import numpy as np
import pytest
import torch

import plonky25_torch.proof as tproof
from plonky25_torch.convert import from_jax
from plonky25_torch.fields import gl, gl2
from plonky25_torch.models import MultisetAir, pad_pairs
from plonky25_torch.ops.mmcs import DeviceMerkleTree
from plonky25_torch.ops.ntt import \
    barycentric_eval_ext as t_barycentric_eval_ext
from plonky25_torch.prover import TorchProver, prove
from plonky25_torch.refimpl.field import Gl2
from plonky25_torch.verifier import get_verifier, verify_proof
from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.fields.extension import GL2 as JGL2
from plonky25_tpu.models.multiset_air import MultisetAir as JMultisetAir
from plonky25_tpu.models.multiset_air import pad_pairs as j_pad_pairs
from plonky25_tpu.ops.ntt import barycentric_eval_ext
from plonky25_tpu.proof import FriConfig as JFriConfig
from plonky25_tpu.proof import derive_config as j_derive_config
from plonky25_tpu.proof import proof_from_json as j_proof_from_json
from plonky25_tpu.proof import proof_to_json as j_proof_to_json
from plonky25_tpu.prover.prove import TpuProver
from plonky25_tpu.refimpl.prover import prove as ref_prove
from plonky25_tpu.refimpl.verifier import verify as ref_verify
from plonky25_tpu.verifier import _publics_device
from plonky25_tpu.verifier import get_verifier as j_get_verifier
from plonky25_tpu.verifier import verify_proof as j_verify_proof
from plonky25_tpu.witness import pack_witness as j_pack_witness

P = 0xFFFFFFFF00000001
FC = (1, 4, 2)
FLAGS = ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok", "shape_ok")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the test run
    shares the CPU between several worker processes, and PyTorch's default
    of one thread per core in each of them oversubscribes it many times
    over, which slows a CPU proof by well over an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(n=13, seed=3):
    """tests/test_multiset.py's streams: side A position-tagged values,
    side B the same multiset in another order."""
    rng = random.Random(seed)
    side_a = [(tag + 1, rng.randrange(1 << 63)) for tag in range(n)]
    side_b = list(side_a)
    rng.shuffle(side_b)
    return side_a, side_b


def _compact(obj):
    return json.dumps(obj, separators=(",", ":"))


def _ints(x):
    """A port or JAX GL / GL2 value as nested Python ints."""
    if hasattr(x, "c0"):
        return [_ints(x.c0), _ints(x.c1)]
    if isinstance(x, gl.GL):
        return np.asarray(gl.to_u64(x)).tolist()
    return np.asarray(jgl.to_u64_np(x)).tolist()


def _b1(x):
    """A JAX value as a port value with a leading proof axis of 1."""
    return from_jax(jax.tree.map(np.asarray, x), "cpu")[None]


@pytest.fixture(scope="module")
def perm():
    trace = pad_pairs(*_streams())
    oracle = ref_prove(JMultisetAir(), trace, JFriConfig(*FC))
    return trace, oracle, j_proof_to_json(oracle)


def _both(proof_json):
    """The port's and the JAX package's VerifyResult fields."""
    t = verify_proof(tproof.proof_from_json(proof_json), MultisetAir(),
                     tproof.FriConfig(*FC), device="cpu")
    j = j_verify_proof(j_proof_from_json(proof_json), JMultisetAir(),
                       JFriConfig(*FC))
    out = []
    for r in (t, j):
        f = {k: bool(np.asarray(getattr(r, k))) for k in FLAGS}
        f.update(alpha=_ints(r.alpha), zeta=_ints(r.zeta),
                 query_indices=np.asarray(r.query_indices).tolist())
        out.append(f)
    return out


# ------------------------------------------------ the two-chunk quotient


@pytest.fixture(scope="module")
def chunks(perm):
    """The JAX TpuProver's quotient stages on the permutation trace at the
    oracle proof's own transcript values (its challenges, alpha and zeta,
    from the JAX verifier's transcript stage), so that every piece also
    ties to the proof: the chunks' root is its quotient commitment."""
    trace, oracle, _ = perm
    cfg = j_derive_config(oracle, JFriConfig(*FC))
    jv = j_get_verifier(JMultisetAir(), cfg)
    w = j_pack_witness(oracle, cfg)
    t = jv._s_transcript(w["obs"])
    jp = TpuProver(JMultisetAir(), 4, JFriConfig(*FC))
    cols = jgl.from_u64(np.asarray(trace, dtype=np.uint64).T.copy())
    chs = [tuple(_ints(c)) for c in t["challenges"]]
    s = {"jp": jp, "jv": jv, "w": w, "cols": cols, "alpha": t["alpha"],
         "zeta": t["zeta"], "challenges": t["challenges"],
         "tp": TorchProver(MultisetAir(), 4, tproof.FriConfig(*FC),
                           device="cpu"),
         # the JAX builder is held by test_build_stage2_device_matches_jax
         "s2": jgl.from_u64(np.asarray(
             JMultisetAir().build_stage2(trace, chs), dtype=np.uint64))}
    s["q_evals"] = jax.jit(jp._quotient_fn)(
        cols, s["alpha"], _publics_device(jp.air), s["s2"], s["challenges"])
    s["q_rows"] = jp._commit_chunks_fn(s["q_evals"])
    # the chunks' openings as TpuProver._opened_fn computes them
    s["qc"] = [barycentric_eval_ext(jgl.stack([ev.c0, ev.c1]), shift,
                                    s["zeta"])
               for ev, shift in ((s["q_evals"][ci::2], jp.chunk_shifts[ci])
                                 for ci in range(2))]
    return s


def test_two_chunk_quotient_matches_jax(chunks):
    assert chunks["tp"].n_chunks == 2
    got = chunks["tp"]._quotient_fn(
        _b1(chunks["cols"]), _b1(chunks["alpha"]), _b1(chunks["s2"]),
        [_b1(c) for c in chunks["challenges"]])
    assert _ints(got[0]) == _ints(chunks["q_evals"])


def test_two_chunk_commitment_matches_jax(perm, chunks):
    """The chunks' LDE as 4 base columns (rows of the quotient tree), and
    the tree's root, which is the oracle proof's quotient commitment."""
    got = chunks["tp"]._commit_chunks_fn(_b1(chunks["q_evals"]))
    assert got.shape == (1, 4, 32)
    assert np.asarray(_ints(got[0]), dtype=object).T.tolist() == \
        _ints(chunks["q_rows"])
    assert _ints(DeviceMerkleTree(got).root[0]) == \
        perm[1].commitments.quotient_chunks.value


def test_two_chunk_openings_match_jax(perm, chunks):
    """Both quotient chunks at zeta (and the trace and stage-2 columns at
    zeta and zeta * g), equal to the JAX evaluations and the proof's."""
    got = chunks["tp"]._opened_fn(
        _b1(chunks["cols"]), _b1(chunks["q_evals"]), _b1(chunks["zeta"]),
        from_jax(jax.tree.map(np.asarray, chunks["s2"]), "cpu")[None])
    assert len(got) == 5 and got[2].shape == (1, 2, 2)
    qc = [list(zip(*_ints(got[2][0, ci]))) for ci in range(2)]
    assert [list(zip(*_ints(c))) for c in chunks["qc"]] == qc
    ov = perm[1].opened_values
    assert qc == [list(map(tuple, c)) for c in ov.quotient_chunks]
    assert [list(zip(*_ints(g[0]))) for g in got[:2] + got[3:]] == [
        list(map(tuple, v)) for v in (ov.trace_local, ov.trace_next,
                                      ov.stage2_local, ov.stage2_next)]


@pytest.mark.parametrize("bump_chunk", [None, 0, 1])
def test_two_chunk_reconstruction_matches_jax(perm, chunks, bump_chunk):
    """The verifier's _final_fn on the proof's openings: accepted as they
    are, rejected with either chunk's value changed, in both packages;
    and the port's reconstructed quotient at zeta equals the quotient
    polynomial's value there, from its evaluations on the coset."""
    w = dict(chunks["w"])
    if bump_chunk is not None:
        qc = w["quotient_chunks"]
        w["quotient_chunks"] = JGL2(qc.c0, type(qc.c1)(
            qc.c1.lo.at[bump_chunk, 0].add(1), qc.c1.hi))
    jv = chunks["jv"]
    want = bool(jv._s_final(
        chunks["alpha"], chunks["zeta"], w["trace_local"], w["trace_next"],
        w["quotient_chunks"], _publics_device(jv.air), w["stage2_local"],
        w["stage2_next"], chunks["challenges"]))
    tv = get_verifier(MultisetAir(), tproof.derive_config(
        tproof.proof_from_json(perm[2]), tproof.FriConfig(*FC)), "cpu")
    tw = {k: _b1(v) for k, v in w.items()
          if k in ("trace_local", "trace_next", "quotient_chunks",
                   "stage2_local", "stage2_next")}
    zeta = _b1(chunks["zeta"])
    got = bool(tv._final_fn(
        _b1(chunks["alpha"]), zeta, tw["trace_local"], tw["trace_next"],
        tw["quotient_chunks"], {}, tw["stage2_local"], tw["stage2_next"],
        [_b1(c) for c in chunks["challenges"]])[0])
    assert got == want == (bump_chunk is None)
    if bump_chunk is None:
        q = from_jax(jax.tree.map(np.asarray, chunks["q_evals"]), "cpu")
        direct = t_barycentric_eval_ext(
            gl.stack([q.c0, q.c1])[None], 7, zeta)           # (1, 2)
        direct = gl2.add(direct[:, 0], gl2.mul(
            gl2.monomial(1, (1,), "cpu"), direct[:, 1]))
        assert _ints(tv._quotient_at(zeta, tw["quotient_chunks"])) == \
            _ints(direct)


# ------------------------------------------------ stage 2 and pad_pairs


@pytest.mark.parametrize("n, min_height", [(0, 4), (5, 4), (13, 4), (16, 1)])
def test_pad_pairs_matches_jax(n, min_height):
    side_a, side_b = _streams(n, seed=n)
    assert pad_pairs(side_a, side_b, min_height) == \
        j_pad_pairs(side_a, side_b, min_height)


def test_pad_pairs_refuses_unequal_sides():
    with pytest.raises(ValueError):
        pad_pairs([(1, 2)], [])


def test_build_stage2_device_matches_jax_and_host(perm, chunks):
    trace = perm[0]
    chs = [tuple(_ints(c)) for c in chunks["challenges"]]
    host = MultisetAir().build_stage2(trace, chs)
    assert host == _ints(chunks["s2"])
    cols = np.asarray(trace, dtype=np.uint64).T.copy()
    got = MultisetAir().build_stage2_device(
        gl.from_u64(cols, "cpu"), [gl2.from_u64_pair(*c, "cpu") for c in chs])
    assert gl.to_u64(got).tolist() == host
    want = JMultisetAir().build_stage2_device(jgl.from_u64(cols),
                                              chunks["challenges"])
    assert _ints(want) == host
    assert host[0][-1] == 1 and host[1][-1] == 0      # a permutation


def test_zero_denominator_raises(perm):
    """gamma equal to a compressed side-B pair: both builders raise, as the
    int oracle's Gl2.div does."""
    trace = perm[0]
    delta = (12345, 678)
    tb, vb = trace[3][2], trace[3][3]
    gamma = Gl2.add_base(Gl2.mul_base(delta, vb), tb)
    with pytest.raises(ZeroDivisionError):
        MultisetAir().build_stage2(trace, [gamma, delta])
    with pytest.raises(ZeroDivisionError):
        MultisetAir().build_stage2_device(
            gl.from_u64(np.asarray(trace, dtype=np.uint64).T.copy(), "cpu"),
            [gl2.from_u64_pair(*gamma, "cpu"), gl2.from_u64_pair(*delta, "cpu")])


# ------------------------------------------------ proofs and verdicts


def test_prove_is_byte_equal_to_refimpl(perm):
    trace, _, want = perm
    got = prove(MultisetAir(), trace, tproof.FriConfig(*FC), device="cpu")
    assert _compact(tproof.proof_to_json(got)) == _compact(want)


def test_verify_result_matches_jax(perm):
    ours, theirs = _both(perm[2])
    assert ours == theirs and ours["ok"]


def _non_permutation(kind):
    """tests/test_multiset.py:59-85: one value, one tag or a multiplicity
    differs between the sides."""
    side_a, side_b = _streams(n=9, seed=5)
    bad = list(side_b)
    if kind == "value":
        t0, v0 = bad[4]
        bad[4] = (t0, (v0 + 1) % P)
    elif kind == "tag":
        t0, v0 = bad[2]
        bad[2] = (t0 + 1000, v0)
    else:
        bad[1] = bad[0]
    return pad_pairs(side_a, bad)


@pytest.mark.parametrize("kind", ["value", "tag", "multiplicity"])
def test_non_permutation_rejected_like_jax(kind):
    proof = ref_prove(JMultisetAir(), _non_permutation(kind), JFriConfig(*FC))
    ours, theirs = _both(j_proof_to_json(proof))
    assert ours == theirs
    assert not ours["ok"] and not ours["quotient_ok"]
    assert ours["pow_ok"] and ours["merkle_ok"] and ours["fold_ok"]
    assert not ref_verify(proof, JMultisetAir(), JFriConfig(*FC)).ok
