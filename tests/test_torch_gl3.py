"""D=3 in the port: GF(p^3) = GF(p)[X]/(X^3 - 7) against the JAX package and
the int oracles, bit for bit (tolerance 0: the arithmetic is exact), on
the CPU, and the degree-3 proofs of tests/test_d3.py through the port's
serde and verifier guard:

  * fields/extension3.py's ops against plonky25_tpu.fields.extension3 and
    against refimpl.field.Gl3 (the port's copy and the JAX package's), on
    seeded numpy inputs with the edge values 0, 1, p - 1 and 2^32;
  * Ops.fold_constraints (vector constraints at point shapes (B,) and
    (B, q)) against the int Horner fold;
  * a D=3 proof made by the JAX package's int prover (refimpl.prover.
    prove(..., ext_degree=3), fib(8), FriConfig(1, 2, 1)): it round-trips
    through the port's JSON byte for byte, derive_config gives
    ext_degree 3, check_proof_shape accepts it, and verify_proof refuses
    it with NotImplementedError as the JAX verify_proof does.
"""

import json

import jax
import numpy as np
import pytest
import torch

from plonky25_torch.errors import check_proof_shape
from plonky25_torch.fields import gl, gl3
from plonky25_torch.fields.extension3 import GL3, Ops
from plonky25_torch.models import FibonacciAir
from plonky25_torch.proof import FriConfig, derive_config, proof_from_json
from plonky25_torch.proof import proof_to_json
from plonky25_torch.refimpl.field import Gl2, Gl3, ext_ops
from plonky25_torch.verifier import verify_proof
from plonky25_tpu.fields import extension3 as jgl3
from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky25_tpu.models.fibonacci import fibonacci_trace
from plonky25_tpu.proof import FriConfig as JFriConfig
from plonky25_tpu.proof import proof_to_json as j_proof_to_json
from plonky25_tpu.refimpl.field import Gl3 as JGl3
from plonky25_tpu.refimpl.prover import prove as ref_prove
from plonky25_tpu.verifier import verify_proof as j_verify_proof

P = 0xFFFFFFFF00000001
N = 64
EDGE = [0, 1, P - 1, 1 << 32]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test run shares the CPU between worker
    processes (see tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(seed):
    """N GF(p^3) values as a (3, N) uint64 array, the first few edge
    values in every coefficient."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=(3, N), dtype=np.uint64)
    for i, e in enumerate(EDGE):
        a[:, i] = e
        a[i % 3, len(EDGE) + i] = e
    return a


def _t(a) -> GL3:
    return GL3(*(gl.from_u64(c, "cpu") for c in a))


def _j(a):
    return jgl3.GL3(*(jgl.from_u64(c) for c in a))


def _ints(x):
    """A port GL3 or a JAX GL3 -> N tuples of three Python ints."""
    if isinstance(x.c0, gl.GL):
        cs = [np.asarray(gl.to_u64(c), dtype=object).reshape(-1) for c in x]
    else:
        cs = [np.asarray(jgl.to_u64_np(c), dtype=object).reshape(-1)
              for c in x]
    return [tuple(int(v) for v in t) for t in zip(*cs)]


def _rows(a):
    return [tuple(int(v) for v in a[:, i]) for i in range(a.shape[1])]


@pytest.fixture(scope="module")
def inputs():
    x, y = _sample(3), _sample(4)
    y[:, 0] = [5, 0, 0]          # keep every divisor nonzero
    b = np.random.default_rng(5).integers(0, P, size=N, dtype=np.uint64)
    b[:len(EDGE)] = EDGE
    return x, y, b


BINARY = ("add", "sub", "mul", "div")
UNARY = ("neg", "square", "inv")


@pytest.fixture(scope="module")
def jax_results(inputs):
    """The JAX extension3 ops on the same inputs, each jitted once."""
    x, y, b = inputs
    jx, jy, jb = _j(x), _j(y), jgl.from_u64(b)
    out = {op: _ints(jax.jit(getattr(jgl3, op))(jx, jy)) for op in BINARY}
    out.update({op: _ints(jax.jit(getattr(jgl3, op))(jx)) for op in UNARY})
    out["mul_base"] = _ints(jax.jit(jgl3.mul_base)(jx, jb))
    out["eq"] = np.asarray(jax.jit(jgl3.eq)(jx, jx)).tolist()
    return out


@pytest.mark.parametrize("op", BINARY + UNARY + ("mul_base",))
def test_gl3_ops_match_jax_and_the_int_oracles(inputs, jax_results, op):
    x, y, b = inputs
    tx, ty = _t(x), _t(y)
    if op in BINARY:
        got = getattr(gl3, op)(tx, ty)
        want = [getattr(Gl3, op)(u, v) for u, v in zip(_rows(x), _rows(y))]
        j_want = [getattr(JGl3, op)(u, v)
                  for u, v in zip(_rows(x), _rows(y))]
    elif op in UNARY:
        got = getattr(gl3, op)(tx)
        want = [getattr(Gl3, op)(u) if op != "inv" or any(u)
                else (0, 0, 0) for u in _rows(x)]
        j_want = [getattr(JGl3, op)(u) if op != "inv" or any(u)
                  else (0, 0, 0) for u in _rows(x)]
    else:
        got = gl3.mul_base(tx, gl.from_u64(b, "cpu"))
        want = [Gl3.mul_base(u, int(v)) for u, v in zip(_rows(x), b)]
        j_want = [JGl3.mul_base(u, int(v)) for u, v in zip(_rows(x), b)]
    assert _ints(got) == want == j_want == jax_results[op]


def test_gl3_shape_helpers_and_eq(inputs, jax_results):
    x, y, _ = inputs
    tx, ty = _t(x), _t(y)
    assert gl3.eq(tx, tx).tolist() == jax_results["eq"] == [True] * N
    assert gl3.eq(tx, ty).tolist() == [u == v for u, v in
                                      zip(_rows(x), _rows(y))]
    for e in range(3):
        m = gl3.monomial(e, (2,), "cpu")
        assert _ints(m) == [Gl3.monomial(e)] * 2 == \
            [JGl3.monomial(e)] * 2 == _ints(jgl3.monomial(e, (2,)))
    st = gl3.stack([tx[:3], ty[:3]], dim=0)
    assert st.shape == (2, 3) and _ints(st) == _ints(tx[:3]) + _ints(ty[:3])
    bc = gl3.broadcast_to(tx[:1], (4,))
    assert _ints(bc) == _ints(tx[:1]) * 4
    assert _ints(gl3.mul(gl3.inv(ty), ty)) == [Gl3.ONE] * N
    assert _ints(Ops.from_parts(*(gl3.from_base(c) for c in tx))) == \
        _rows(x)                                  # c0 + X c1 + X^2 c2
    ops = Ops((N,), "cpu")
    assert _ints(ops.take(gl3.stack([tx, ty]), [1])[0]) == _rows(y)
    assert _ints(ops.const_base([3, P + 4]).reshape(2)) == [(3, 0, 0),
                                                            (4, 0, 0)]
    assert ext_ops(2) is Gl2 and ext_ops(3) is Gl3
    with pytest.raises(ValueError):
        ext_ops(4)


@pytest.mark.parametrize("point_shape", [(3,), (2, 4)])
def test_fold_constraints_matches_the_int_horner_fold(point_shape):
    rng = np.random.default_rng(len(point_shape))
    shapes = [(5,) + point_shape, point_shape, (2, 3) + point_shape,
              (4,) + (1,) * len(point_shape)]
    cs = [rng.integers(0, P, size=(3,) + s, dtype=np.uint64) for s in shapes]
    alpha = rng.integers(0, P, size=(3,) + point_shape, dtype=np.uint64)
    ops = Ops(point_shape, "cpu")
    got = ops.fold_constraints(_t(alpha), [_t(c) for c in cs])
    assert got.shape == point_shape
    n_pts = int(np.prod(point_shape))
    flat = []                         # every constraint as (n_pts,) ints
    for c, s in zip(cs, shapes):
        k = int(np.prod(s[:len(s) - len(point_shape)] or (1,)))
        full = np.broadcast_to(c.reshape((3, k) + s[len(s) - len(point_shape):]),
                               (3, k) + point_shape).reshape(3, k, n_pts)
        flat += [[tuple(int(v) for v in full[:, i, j]) for j in range(n_pts)]
                 for i in range(k)]
    al = alpha.reshape(3, n_pts)
    want = []
    for j in range(n_pts):
        acc = Gl3.ZERO
        a = tuple(int(v) for v in al[:, j])
        for c in flat:
            acc = Gl3.add(Gl3.mul(acc, a), c[j])
        want.append(acc)
    assert _ints(got) == want
    assert _ints(ops.fold_constraints(_t(alpha), [])) == [Gl3.ZERO] * n_pts


FC = (1, 2, 1)


@pytest.fixture(scope="module")
def d3_proof_json():
    proof = ref_prove(JFibonacciAir(), fibonacci_trace(8), JFriConfig(*FC),
                      ext_degree=3)
    return json.dumps(j_proof_to_json(proof), separators=(",", ":")), proof


def test_d3_proof_round_trips_through_the_port_serde(d3_proof_json):
    text, _ = d3_proof_json
    proof = proof_from_json(json.loads(text))
    assert json.dumps(proof_to_json(proof), separators=(",", ":")) == text
    assert len(proof.opened_values.trace_local[0]) == 3
    assert len(proof.opening_proof.fri_proof.final_poly) == 3
    cfg = derive_config(proof, FriConfig(*FC))
    assert cfg.ext_degree == 3 and cfg.quotient_opened_values_len == 3
    check_proof_shape(proof, cfg)             # no raise


def test_d3_proof_is_refused_by_verify_proof(d3_proof_json):
    text, j_proof = d3_proof_json
    with pytest.raises(NotImplementedError):
        verify_proof(proof_from_json(json.loads(text)), FibonacciAir(),
                     FriConfig(*FC), device="cpu")
    with pytest.raises(NotImplementedError):
        j_verify_proof(j_proof, JFibonacciAir(), JFriConfig(*FC))
