"""plonky25_torch/utils/roofline.py on the CPU: count_int_ops against
counts written out by hand, the Poseidon2 work model charged in place of
whatever runs the permutation, the H100 bound of the kernel line (0.610 ms
at 2^21 states), mfu_report's record, and no TPU figure among the
ceilings.  The counts are exact integers (tolerance 0); the bound is held
to the kernel line's three decimals."""

import numpy as np
import pytest
import torch

from plonky25_torch.fields import gl
from plonky25_torch.ops import ntt
from plonky25_torch.ops import poseidon2 as p2
from plonky25_torch.utils import roofline as rl
from plonky25_torch.utils.roofline import OpCount, count_int_ops
from plonky25_tpu.utils import roofline as jax_roofline

P = 0xFFFFFFFF00000001


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (see
    tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gl(shape, seed):
    rng = np.random.default_rng(seed)
    return gl.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), "cpu")


def test_count_of_field_ops_written_out_by_hand():
    a, b = _gl((8,), 1), _gl((8,), 2)
    # gl.add per element: lo add; hi add, shift, add; mask; tlo sub; thi
    # sub, shift, add; compare; two wheres; mask
    add = 1 + 3 + 1 + 1 + 3 + 1 + 2 + 1
    # gl.sub: the same shape with the signs swapped
    sub = 1 + 3 + 1 + 1 + 3 + 1 + 2 + 1
    eq = 2 + 1                              # two limb compares, one and
    assert count_int_ops(gl.add, a, b) == OpCount(8 * add, True)
    assert count_int_ops(lambda x, y: gl.eq(gl.sub(x, y), x), a, b) == \
        OpCount(8 * (sub + eq), True)
    # one op per output element, broadcasting included; views are free
    x, y = torch.arange(4).reshape(4, 1), torch.arange(3).reshape(1, 3)
    assert count_int_ops(lambda: (x + y).reshape(-1)[2:] >> 1) == \
        OpCount(12 + 10, True)
    assert count_int_ops(lambda: torch.cat([x, x]).expand(8, 5)) == \
        OpCount(0, True)


def test_an_uncounted_op_makes_the_count_inexact():
    x = torch.arange(6)
    got = count_int_ops(lambda: torch.cumsum(x + 1, 0))
    assert got == OpCount(6 + 6, False)


@pytest.mark.parametrize("lane_major", [False, True])
def test_a_permutation_is_charged_by_the_work_model(lane_major, monkeypatch):
    n = 5
    s = _gl((12, n) if lane_major else (n, 12), 3)
    fn = p2.poseidon2_permute_soa if lane_major else p2.poseidon2_permute
    model = OpCount(n * rl.P2_OPS["total"], True)
    assert count_int_ops(fn, s) == model
    # with work around it: that work is counted as well
    assert count_int_ops(lambda: gl.add(fn(s), s)) == OpCount(
        model.int_ops + 13 * 12 * n, True)
    # whatever runs it: an implementation with other (and uncounted) ops
    # is charged the same
    plain = ("poseidon2_permute_soa_plain" if lane_major
             else "poseidon2_permute_plain")
    monkeypatch.setattr(p2, plain, lambda st: gl.GL(
        torch.cumsum(st.lo, 0) * 0 + st.lo, st.hi.clone()))
    assert count_int_ops(fn, s) == model
    assert p2._observers == []


def test_the_auto_dispatch_is_charged_the_same():
    s = _gl((3, 12), 4)
    assert count_int_ops(p2.poseidon2_permute_auto, s) == \
        count_int_ops(p2.poseidon2_permute, s)


def test_coset_ntt_count_is_steady_and_exact():
    c = _gl((4, 1 << 6), 5)
    ntt.coset_ntt(c, 7)
    first, second = (count_int_ops(ntt.coset_ntt, c, 7) for _ in range(2))
    assert first == second and first.exact and first.int_ops > 0


def test_work_model_and_bound_at_2_pow_21():
    assert rl.P2_OPS == {"fma_pipe": 2944, "alu_pipe": 0,
                         "either_pipe": 6780, "total": 9724}
    assert rl.P2_BYTES_PER_STATE == 12 * 2 * 8 * 2 == 384
    assert round(rl.clocks_per_state(rl.P2_OPS), 1) == 76.0
    ms, by = rl.poseidon2_bound_ms(1 << 21, 132, 1.98e9)
    assert round(ms, 3) == 0.610 and by == "operations"
    assert rl.poseidon2_bound_ms(1 << 21) == (ms, by)   # the defaults
    # the kernel line's arithmetic before the roofline module existed
    ops_ms = (1 << 21) * rl.clocks_per_state(rl.P2_OPS) / (132 * 1.98e9) * 1e3
    bytes_ms = (1 << 21) * 12 * 2 * 8 * 2 / 3.35e12 * 1e3
    assert ms == max(ops_ms, bytes_ms)
    # bytes bind where the instructions are few
    assert rl.bound_ms(10, 1.0, 1e6)[1] == "bytes"


def test_mfu_report_keeps_jax_keys_and_stays_below_one():
    per_state = OpCount(rl.P2_OPS["total"], True)
    sol = rl.speed_of_light_items_per_sec(per_state)
    assert sol == rl.INT_PEAK_H100 / 9724
    r = rl.mfu_report("poseidon2_permute_w12", per_state, sol / 4,
                      bytes_per_item=rl.P2_BYTES_PER_STATE)
    for key in ("kernel", "u32_ops_per_item", "items_per_sec",
                "achieved_u32_ops_per_sec", "mfu", "count_exact",
                "int_peak_u32_ops_per_sec", "bytes_per_item",
                "roofline_share", "bound_by"):
        assert key in r, key
    assert not any("v5e" in k or "vpu" in k or "ceiling" in k for k in r)
    assert r["mfu"] == pytest.approx(0.25)
    assert r["roofline_share"] == pytest.approx(0.25)
    assert r["bound_by"] == "operations" and r["count_exact"] is True
    # at the 2^21 bound's rate the share is 1.0, from the same yardstick
    ms, _ = rl.poseidon2_bound_ms(1 << 21)
    at_bound = rl.mfu_report("k", per_state, (1 << 21) / (ms / 1e3),
                             bytes_per_item=rl.P2_BYTES_PER_STATE)
    assert at_bound["roofline_share"] == pytest.approx(1.0)
    assert at_bound["mfu"] <= at_bound["roofline_share"] + 1e-12
    assert rl.speed_of_light_items_per_sec(OpCount(0, True)) == float("inf")


def test_no_constant_comes_from_a_v5e():
    names = [n for n in dir(rl) if n.isupper()]
    assert not [n for n in names if "V5E" in n or "VPU" in n or "U32" in n]
    tpu = {jax_roofline.VPU_PEAK_V5E, jax_roofline.U32_CEILING_V5E, 1.5e9}
    consts = [getattr(rl, n) for n in names
              if isinstance(getattr(rl, n), (int, float))]
    assert not set(consts) & tpu
    assert rl.INT_PEAK_H100 == rl.int_peak(132, 1.98e9) == 128 * 132 * 1.98e9
    assert rl.HBM_BYTES_PER_S == 3.35e12
    assert (rl.ALU_PER_CLK, rl.FMA_PER_CLK, rl.DISPATCH_PER_CLK) == \
        (64, 64, 128)
