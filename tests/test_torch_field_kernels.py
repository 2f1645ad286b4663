"""The field kernels (plonky25_torch/csrc/goldilocks.cu, launched by
plonky25_torch/ops/goldilocks.py) and the launcher's shape-and-stride plan.

On the CPU: the plan of broadcast, transposed, expanded and 0-d operands,
read back through the strides it gives; the rank limit; the launcher's
refusals; the fields' CPU path never launching and being each op's
`limb_chain`; the `field.*` counters through the tracing table and a
launch record.  On the card (marked
`cuda`, skipped without a GPU): every op, bit-equal to the limb path on
the CPU, on random and edge values, broadcast and non-contiguous
operands, inside a captured StaticProgram and its replay, with its
counters; count_int_ops of a launch equal to the CPU's.  This file imports no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_field_kernels.py"""

import numpy as np
import pytest
import torch

from plonky25_torch.constants import GOLDILOCKS_P as P
from plonky25_torch.fields import gl, gl2
from plonky25_torch.fields.extension import GL2
from plonky25_torch.fields.goldilocks import GL
from plonky25_torch.ops import goldilocks as kernels
from plonky25_torch.utils import profiling, roofline
from plonky25_torch.utils.graphs import StaticProgram

# 0, 1, p - 1 (hi limb 2^32 - 1), p - 2 (lo limb 2^32 - 1 under the
# largest hi), p - 2^32, a lo limb of 2^32 - 1 alone, 2^32, 2^63
EDGE = [0, 1, 2, P - 1, P - 2, P - (1 << 32), (1 << 32) - 1, 1 << 32,
        1 << 63]
# op -> (the field function, operand kinds)
OPS = {"gl_add": (gl.add, "gl", "gl"), "gl_sub": (gl.sub, "gl", "gl"),
       "gl_mul": (gl.mul, "gl", "gl"),
       "gl2_add": (gl2.add, "gl2", "gl2"), "gl2_sub": (gl2.sub, "gl2", "gl2"),
       "gl2_mul": (gl2.mul, "gl2", "gl2"),
       "gl2_mul_base": (gl2.mul_base, "gl2", "gl")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (see
    tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the plan

def _read_back(t, dims, strides):
    """t read through the plan's axes and strides, as the kernel reads it."""
    return t.as_strided(dims, strides, t.storage_offset())


def _base(*shape):
    return torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)


def _z(*shape):
    return torch.zeros((), dtype=torch.int64).expand(shape)


# name -> (operands, the merged axes the plan should leave)
PLANS = {
    "dense": ([_base(4, 5, 6), _base(4, 5, 6) + 1], [120]),
    "expanded_zero": ([_base(4, 8), _z(4, 8)], [32]),
    "movedim": ([_base(8, 16, 5).movedim(2, 0), _base(5, 8, 16)], [5, 128]),
    "const_k11": ([_base(3, 1, 1), _base(3, 4, 6)], [3, 24]),
    "alpha_column": ([_base(4)[:, None], _base(4, 7)], [4, 7]),
    "zero_dim": ([torch.tensor(5), _base(9)], [9]),
    "both_zero_dim": ([torch.tensor(5), torch.tensor(7)], [1]),
    "sliced": ([_base(6, 10)[:, 1:6], _base(6, 5)], [6, 5]),
    "evenly_strided": ([_base(6, 10)[:, ::2], _base(6, 5)], [30]),
    "row_of_matrix": ([_base(6, 10)[:, 3], _base(6)], [6]),
    "outer_broadcast": ([_base(1, 3, 1), _base(5, 1, 7)], [5, 3, 7]),
    "leading_ones": ([_base(1, 1, 12), _base(12)], [12]),
    "zero_size": ([_base(0, 4), _base(1, 4)], [0, 4]),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_reads_every_operand_as_broadcast(case):
    """Each operand read through the plan's strides is the operand
    broadcast to the output shape, flattened onto the merged axes; the
    axes merged as far as every operand allows."""
    tensors, want_dims = PLANS[case]
    shape, dims, strides = kernels.plan(tensors)
    assert shape == tuple(torch.broadcast_shapes(*(t.shape for t in tensors)))
    assert dims == want_dims
    assert int(np.prod(dims)) == int(np.prod(shape))
    assert len(strides) == len(tensors)
    for t, st in zip(tensors, strides):
        assert len(st) == len(dims)
        want = t.expand(shape).reshape(dims)
        assert torch.equal(_read_back(t, dims, st), want)


def test_plan_keeps_broadcast_strides_zero():
    """A broadcast axis reads stride 0: the expanded zero and the (k, 1,
    1) constant are never copied."""
    _, _, strides = kernels.plan([_base(4, 8), _z(4, 8)])
    assert strides[1] == [0]
    _, dims, strides = kernels.plan([_base(3, 1, 1), _base(3, 4, 6)])
    assert strides == [[1, 0], [24, 1]] and dims == [3, 24]


def test_plan_refuses_more_axes_than_the_kernel_takes():
    """Seven axes that no operand lets merge raise; six do not."""
    a7 = _base(2, 1, 2, 1, 2, 1, 2)
    b7 = _base(1, 3, 1, 3, 1, 3, 1)
    with pytest.raises(ValueError, match="at most 6"):
        kernels.plan([a7, b7])
    _, dims, _ = kernels.plan([_base(2, 1, 2, 1, 2, 1),
                               _base(1, 3, 1, 3, 1, 3)])
    assert dims == [2, 3, 2, 3, 2, 3]


def test_plan_refuses_shapes_that_do_not_broadcast():
    with pytest.raises(ValueError, match="do not broadcast"):
        kernels.plan([_base(3, 4), _base(5)])


def test_launch_refuses_cpu_and_non_int64_operands():
    a = _base(4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch("gl_add", (a, a, a, a))
    with pytest.raises(TypeError, match="int64"):
        kernels.launch("gl_add", (a, a, a.float(), a))
    with pytest.raises(ValueError, match="takes 4"):
        kernels.launch("gl_add", (a, a))


@pytest.mark.parametrize("op", sorted(OPS))
def test_cpu_operands_run_the_limb_chain(op, monkeypatch):
    """On the CPU every field op runs its limb chain and launches nothing."""
    def no_launch(*_):
        raise AssertionError("launched on CPU tensors")

    monkeypatch.setattr(kernels, "launch", no_launch)
    fn, ka, kb = OPS[op]
    x, y = _operand(ka, (5,), 1, "cpu"), _operand(kb, (5,), 2, "cpu")
    want = _ints(_reference(op, x, y))
    assert _ints(fn(x, y)) == want


def test_field_counters_follow_tracing_and_launch_records():
    """A launch counts where tracing is on, nothing where it is off;
    inside recording_launches it goes to the record, which a replay adds
    where tracing is on."""
    launches, elements = kernels.COUNTERS["gl2_mul"]
    # what launch() reports once a launch went through
    profiling.launched(kernels.counts_of("gl2_mul", 10))
    assert launches not in profiling.table().counts
    with profiling.recording() as t:
        profiling.launched(kernels.counts_of("gl2_mul", 10))
        profiling.launched(kernels.counts_of("gl2_mul", 6))
        assert profiling.field_launches() == {"gl2_mul": 2}
    assert (t.counts[launches], t.counts[elements]) == (2, 16)
    with profiling.recording() as t:
        with profiling.recording_launches() as rec:
            profiling.launched(kernels.counts_of("gl2_mul", 7))
        assert launches not in t.counts
        assert (rec.counts[launches], rec.counts[elements]) == (1, 7)
        profiling.replay_launches(rec)
        profiling.replay_launches(rec)
    assert (t.counts[launches], t.counts[elements]) == (2, 14)
    assert not profiling.launch_record_open()


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_count_of_a_launch_is_its_limb_chains(op):
    """count_int_ops charges a field kernel's launch (on the card) what
    the op's limb chain dispatches on the CPU, broadcast operands
    included, so a function counts the same on both."""
    fn, ka, kb = OPS[op]
    x, y = _operand(ka, (3, 4), 1, "cpu"), _operand(kb, (4,), 2, "cpu")
    counter = roofline._Counter()
    with counter:
        counter.field_launch(op, tuple(_limbs(x) + _limbs(y)))
    assert roofline.count_int_ops(fn, x, y) == roofline.OpCount(
        counter.ops, counter.exact)
    assert counter.ops > 0 and counter.exact


@pytest.mark.parametrize("op", sorted(OPS))
def test_limb_chain_is_the_cpu_op(op):
    """limb_chain(op), the plain version the kernel is held to, is the
    field op's CPU path on the op's limb tensors, broadcast included."""
    fn, ka, kb = OPS[op]
    x, y = _operand(ka, (3, 4), 1, "cpu"), _operand(kb, (4,), 2, "cpu")
    got = kernels.limb_chain(op)(*_limbs(x), *_limbs(y))
    want = _limbs(fn(x, y))
    assert len(got) == kernels.OPS[op][1] == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------ values

def _values(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _gl(values, device):
    if values.ndim == 0:    # from_u64 takes arrays of at least one axis
        return gl.constant(int(values), device)
    return gl.from_u64(values, device)


def _operand(kind, shape, seed, device):
    if kind == "gl":
        return _gl(_values(shape, seed), device)
    return GL2(_gl(_values(shape, seed), device),
               _gl(_values(shape, seed + 1000), device))


def _reference(op, x, y):
    """The limb chain on CPU copies of the operands."""
    cpu = lambda v: tuple(t.cpu() for t in v)  # noqa: E731
    fn = OPS[op][0]
    if isinstance(x, GL2):
        x = GL2(GL(*cpu(x.c0)), GL(*cpu(x.c1)))
    else:
        x = GL(*cpu(x))
    if isinstance(y, GL2):
        y = GL2(GL(*cpu(y.c0)), GL(*cpu(y.c1)))
    else:
        y = GL(*cpu(y))
    return fn(x, y)


def _limbs(v):
    return list(v.c0) + list(v.c1) if isinstance(v, GL2) else list(v)


def _ints(v):
    return [t.cpu().tolist() for t in _limbs(v)]


def _assert_bit_equal(got, want):
    gl_, wl = _limbs(got), _limbs(want)
    assert len(gl_) == len(wl)
    for g, w in zip(gl_, wl):
        assert g.device.type == "cuda"
        assert tuple(g.shape) == tuple(w.shape)
        assert torch.equal(g.cpu(), w)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _viewed(kind, base_shape, view, seed, device="cuda"):
    """An operand made on `device` and viewed with `view`, applied to
    every limb tensor."""
    v = _operand(kind, base_shape, seed, device)
    if kind == "gl":
        return GL(view(v.lo), view(v.hi))
    return GL2(GL(view(v.c0.lo), view(v.c0.hi)),
               GL(view(v.c1.lo), view(v.c1.hi)))


# name -> ((base shape, view) of x, (base shape, view) of y)
ident = lambda t: t  # noqa: E731
LAYOUTS = {
    "same_shape": (((33, 65), ident), ((33, 65), ident)),
    "zero_dim": (((1000,), ident), ((), ident)),
    "movedim": (((8, 16, 5), lambda t: t.movedim(2, 0)), ((5, 8, 16), ident)),
    "const_k11": (((7, 1, 1), ident), ((7, 9, 33), ident)),
    "alpha_column": (((6,), lambda t: t[:, None]), ((6, 40), ident)),
    "sliced": (((12, 40), lambda t: t[:, 1::3]),
               ((12, 13), lambda t: t.t().contiguous().t())),
    "zero_size": (((0, 4), ident), ((1, 4), ident)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(OPS))
def test_kernel_matches_limb_chain_on_gpu(op):
    """Random values at sizes from one element to beyond a full grid, and
    every pair of edge values, bit-equal to the limb chain on the CPU."""
    _card()
    fn, ka, kb = OPS[op]
    for n in (1, 255, 257, 100_003, (1 << 21) + 5):
        x, y = _operand(ka, (n,), n, "cuda"), _operand(kb, (n,), n + 1, "cuda")
        _assert_bit_equal(fn(x, y), _reference(op, x, y))
    e = np.asarray(EDGE, dtype=np.uint64)
    ea, eb = np.repeat(e, len(e)), np.tile(e, len(e))
    x = _gl(ea, "cuda") if ka == "gl" else GL2(_gl(ea, "cuda"),
                                               _gl(eb[::-1].copy(), "cuda"))
    y = _gl(eb, "cuda") if kb == "gl" else GL2(_gl(eb, "cuda"),
                                               _gl(ea[::-1].copy(), "cuda"))
    _assert_bit_equal(fn(x, y), _reference(op, x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("op", sorted(OPS))
def test_kernel_reads_broadcast_and_strided_operands(op, layout):
    """Views as the fold and the prover pass them, read as they lie, both
    ways round; the outputs fresh and contiguous."""
    _card()
    fn, ka, kb = OPS[op]
    (sx, vx), (sy, vy) = LAYOUTS[layout]
    for swap in (False, True):
        if swap and ka != kb:
            continue
        x, y = _viewed(ka, sx, vx, 1), _viewed(kb, sy, vy, 2)
        if swap:
            x, y = y, x
        got = fn(x, y)
        _assert_bit_equal(got, _reference(op, x, y))
        assert all(t.is_contiguous() for t in _limbs(got))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["alpha_column", "const_k11", "movedim",
                                    "same_shape", "zero_dim"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_count_of_a_launch_on_the_card_is_the_cpus(op, layout):
    """count_int_ops of a field op on card operands (a launch, charged
    through observe_launches) equals its count on CPU operands of the
    same values and layout (the limb chain, dispatched)."""
    _card()
    fn, ka, kb = OPS[op]
    (sx, vx), (sy, vy) = LAYOUTS[layout]
    on = {d: (_viewed(ka, sx, vx, 1, d), _viewed(kb, sy, vy, 2, d))
          for d in ("cpu", "cuda")}
    got = roofline.count_int_ops(fn, *on["cuda"])
    assert got == roofline.count_int_ops(fn, *on["cpu"])
    assert got.int_ops > 0 and got.exact


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(OPS))
def test_kernel_reads_the_expanded_zero_component(op):
    """A GL2 whose c1 is an expanded 0-d zero (the prover's base-field
    columns), and a GL operand that is one."""
    _card()
    fn, ka, kb = OPS[op]
    shape = (4, 257)
    z = torch.zeros((), dtype=torch.int64, device="cuda").expand(shape)
    zero = GL(z, z)
    x = _operand(ka, shape, 3, "cuda")
    x = GL2(x.c0, zero) if ka == "gl2" else x
    y = _operand(kb, shape, 4, "cuda")
    y = GL2(y.c0, zero) if kb == "gl2" else zero
    _assert_bit_equal(fn(x, y), _reference(op, x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(OPS))
def test_kernel_in_a_captured_program_and_its_counters(op):
    """The op inside a StaticProgram: captured at its first run, replayed
    on new inputs, bit-equal each time; under tracing an eager call
    counts one launch of its elements, a replay the capture's one."""
    _card()
    fn, ka, kb = OPS[op]
    launches, elements = kernels.COUNTERS[op]
    n = 4099
    x, y = _operand(ka, (n,), 5, "cuda"), _operand(kb, (n,), 6, "cuda")
    with profiling.recording() as t:
        got = fn(x, y)
    assert (t.counts[launches], t.counts[elements]) == (1, n)
    _assert_bit_equal(got, _reference(op, x, y))
    prog = StaticProgram(fn, (x, y), "cuda", name="field")
    _assert_bit_equal(prog(x, y), _reference(op, x, y))
    assert prog._graph is not None
    assert prog._launches.counts == {launches: 1, elements: n}
    x2, y2 = _operand(ka, (n,), 7, "cuda"), _operand(kb, (n,), 8, "cuda")
    with profiling.recording() as t:
        got = prog(x2, y2)
        torch.cuda.synchronize()
    assert (t.counts[launches], t.counts[elements]) == (1, n)
    _assert_bit_equal(got, _reference(op, x2, y2))
