"""Two-adic NTT, coset LDE and barycentric evaluation over Goldilocks, on
the port's limb tensors; the counterpart of plonky25_tpu/ops/ntt.py.

The transforms are plain PyTorch ops (the JAX package has no Pallas kernel
here): radix-2 Cooley-Tukey (DIT, natural or bit-reversed input, natural
output) and Gentleman-Sande (DIF, natural input, bit-reversed output), each
stage a reshape, two half-slices, one twiddle product and a concatenation.
An NTT's output is fixed by the mathematics, so these two forms serve every
length; the JAX package's six-step form was TPU layout work and gives the
same values, so its threshold `SIX_STEP_MIN_LOG` (a TPU layout choice) has
no counterpart.  The four-step factorization (`ntt_four_step`,
`coset_ntt_four_step`) is kept because it is what splits over devices: with
a mesh its exchanges are torch.distributed all-to-alls (the prover's
`lde_mesh` route).

Tables (root powers, coset points, LDE scales, bit-reversal indices) are
built on the tensor's device, by doubling products and by
`reverse_bits_len_u32`, and cached per shape and device: at 2^21 points a
table built from Python ints would cost seconds of host time per call.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.distributed as dist

from ..constants import GOLDILOCKS_P as P
from ..fields import gl, gl2
from ..fields.extension import GL2
from ..fields.goldilocks import GL
from ..refimpl.field import Gl
from ..utils.bits import log2_strict, reverse_bits_len_u32
from ..utils.tree import tree_map


def powers(base: int, n: int, device) -> GL:
    """(base^0, base^1, ..., base^(n-1)) on `device`: each doubling step
    multiplies the table so far by base^k and appends it."""
    out = gl.ones((1,), device)
    base %= P
    while out.shape[0] < n:
        k = out.shape[0]
        out = gl.concatenate(
            [out, gl.mul(out, gl.full((), pow(base, k, P), device))])
    return out[:n]


@lru_cache(maxsize=None)
def _bitrev(log_n: int, device) -> torch.Tensor:
    """Bit-reversal permutation of [0, 2^log_n) as an int64 index tensor."""
    idx = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    return reverse_bits_len_u32(idx, log_n)


@lru_cache(maxsize=None)
def _root_powers(log_n: int, inverse: bool, device) -> GL:
    """(w^0, ..., w^(N/2-1)), w the two-adic generator of order N (its
    inverse when `inverse`)."""
    w = Gl.two_adic_generator(log_n)
    if inverse:
        w = Gl.inv(w)
    return powers(w, max(1, (1 << log_n) // 2), device)


def _stage_twiddles(log_n: int, s: int, inverse: bool, device) -> GL:
    """Twiddles of DIT stage s (half-size m = 2^s): w_N^(j * N/2^(s+1)) for
    j in [m], a strided view of the root-power table."""
    tab = _root_powers(log_n, inverse, device)
    stride = (1 << log_n) >> (s + 1)
    return tab[::stride][:1 << s]


def _butterfly_stages(x: GL, log_n: int, inverse: bool, dif: bool) -> GL:
    """Run the DIT butterflies (stages ascending, (e, o) -> (e + w o,
    e - w o)) or the DIF ones (descending, (e, o) -> (e + o, (e - o) w))."""
    n = 1 << log_n
    batch = x.shape[:-1]
    for s in (range(log_n - 1, -1, -1) if dif else range(log_n)):
        m = 1 << s
        tw = _stage_twiddles(log_n, s, inverse, x.device)       # (m,)
        a = x.reshape(*batch, n // (2 * m), 2 * m)
        e, o = a[..., :m], a[..., m:]
        if dif:
            lo_half, hi_half = gl.add(e, o), gl.mul(tw, gl.sub(e, o))
        else:
            t = gl.mul(tw, o)
            lo_half, hi_half = gl.add(e, t), gl.sub(e, t)
        x = gl.concatenate([lo_half, hi_half], dim=-1).reshape(*batch, n)
    return x


def _ntt_flat(x: GL, inverse: bool = False, scale: bool = True,
              in_bitrev: bool = False) -> GL:
    """Radix-2 DIT NTT along the last axis: natural order in (bit-reversed
    with in_bitrev=True), natural order out.  inverse=True computes the
    inverse transform, with its 1/N factor when `scale`."""
    log_n = log2_strict(x.shape[-1])
    if log_n == 0:
        return x
    if not in_bitrev:
        x = x[..., _bitrev(log_n, x.device)]
    x = _butterfly_stages(x, log_n, inverse, dif=False)
    if inverse and scale:
        x = gl.mul(gl.full((), Gl.inv((1 << log_n) % P), x.device), x)
    return x


def _ntt_flat_dif(x: GL, inverse: bool = False) -> GL:
    """Radix-2 DIF NTT along the last axis: natural order in, bit-reversed
    order out, no gather: _ntt_flat_dif(x)[rev(k)] == _ntt_flat(x)[k].  The
    1/N factor of an inverse transform is NOT applied."""
    log_n = log2_strict(x.shape[-1])
    return _butterfly_stages(x, log_n, inverse, dif=True)


def ntt(x: GL, inverse: bool = False) -> GL:
    """NTT along the last axis; natural order in and out; inverse=True
    includes the 1/N scale."""
    return _ntt_flat(x, inverse)


def intt(x: GL) -> GL:
    return ntt(x, inverse=True)


@lru_cache(maxsize=None)
def _shift_powers(shift: int, log_n: int, device) -> GL:
    return powers(shift, 1 << log_n, device)


def coset_ntt(coeffs: GL, shift: int) -> GL:
    """Evaluate the polynomials with coefficients `coeffs` (..., N) on the
    coset shift * <g_N>."""
    log_n = log2_strict(coeffs.shape[-1])
    return ntt(gl.mul(_shift_powers(shift % P, log_n, coeffs.device), coeffs))


def coset_intt(evals: GL, shift: int) -> GL:
    """Coefficients of the polynomials whose evaluations on shift * <g_N>
    are `evals` (..., N)."""
    log_n = log2_strict(evals.shape[-1])
    pw = _shift_powers(Gl.inv(shift % P), log_n, evals.device)
    return gl.mul(pw, intt(evals))


@lru_cache(maxsize=None)
def _lde_scale(log_n: int, in_shift: int, out_shift: int, device,
               bitrev: bool) -> GL:
    """1/N * (out_shift / in_shift)^k for coefficient k: the inverse
    transform's 1/N, the de-coset and the re-coset in one table; at
    position rev(k) instead when `bitrev` (two_adic.rs:61-71)."""
    ratio = out_shift % P * Gl.inv(in_shift % P) % P
    tab = gl.mul(gl.full((), Gl.inv((1 << log_n) % P), device),
                 powers(ratio, 1 << log_n, device))
    return tab[_bitrev(log_n, device)] if bitrev else tab


def coset_lde_pair(evals: GL, in_shift: int, log_blowup: int,
                   out_shift: int = 7) -> GL:
    """Low-degree extend evals (..., N) on in_shift*<g_N> to
    out_shift*<g_{N*2^log_blowup}>, natural order out, with no bit-reversal
    gather: a DIF inverse transform (bit-reversed coefficients), the scale
    table in bit-reversed positions, zero padding as a zero interleave, and
    a DIT forward transform on bit-reversed input."""
    n = evals.shape[-1]
    log_n = log2_strict(n)
    batch = evals.shape[:-1]
    c_rev = _ntt_flat_dif(evals, inverse=True)
    c_rev = gl.mul(_lde_scale(log_n, in_shift, out_shift, evals.device, True),
                   c_rev)
    blow = 1 << log_blowup
    z = gl.zeros(batch + (n, blow - 1), evals.device)
    big = gl.concatenate([c_rev.reshape(*batch, n, 1), z], dim=-1)
    return _ntt_flat(big.reshape(*batch, n * blow), in_bitrev=True)


def coset_lde_to_rev(evals: GL, in_shift: int, log_blowup: int,
                     out_shift: int = 7) -> GL:
    """coset_lde_pair in BIT-REVERSED output order, the Merkle commit layout
    (utils.rs:20-43): an unscaled inverse DIT transform, the combined scale,
    zero padding, and a DIF forward transform, whose bit-reversed output is
    the wanted order."""
    n = evals.shape[-1]
    log_n = log2_strict(n)
    coeffs = _ntt_flat(evals, inverse=True, scale=False)
    coeffs = gl.mul(
        _lde_scale(log_n, in_shift, out_shift, evals.device, False), coeffs)
    pad = gl.zeros(evals.shape[:-1] + ((n << log_blowup) - n,), evals.device)
    return _ntt_flat_dif(gl.concatenate([coeffs, pad], dim=-1))


@lru_cache(maxsize=None)
def coset_points(log_n: int, shift: int, device) -> GL:
    """shift * g^i for i in [N], g the two-adic generator of order N."""
    return gl.mul(gl.full((), shift % P, device),
                  powers(Gl.two_adic_generator(log_n), 1 << log_n, device))


def _sum_last(x: GL2) -> GL2:
    """Sum along the last axis (a power-of-two length) by halving."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = gl2.add(x[..., :half], x[..., half:])
    return x[..., 0]


def barycentric_eval_ext(evals: GL, shift: int, z: GL2,
                         col_slab: int = None) -> GL2:
    """Evaluate base-field polynomials at an extension point from their
    evaluations on shift*<g_N>:

        p(z) = (z^N - s^N) / (N s^N) * sum_i e_i x_i / (z - x_i).

    evals: GL (*S, C, N); z: GL2 (*S,), one point per leading index.
    Returns GL2 (*S, C).  One batched extension inversion.  With col_slab,
    more than 2 * col_slab columns are summed col_slab at a time, the
    tables shared (the JAX prover's _bary_cols): the (*S, slab, N) GF(p^2)
    terms are the only temporary that grows with C."""
    n, c = evals.shape[-1], evals.shape[-2]
    log_n = log2_strict(n)
    xs = coset_points(log_n, shift, evals.device)              # (N,)
    inv_dens = gl2.inv(gl2.sub_base(z[..., None], xs))[..., None, :]
    s_n = pow(shift, n, P)
    z_n = gl2.exp_power_of_2(z, log_n)
    front = gl2.mul_base(
        gl2.sub_base(z_n, gl.full((), s_n, evals.device)),
        gl.full((), Gl.inv(n % P * s_n % P), evals.device))[..., None]
    step = c if not col_slab or c <= 2 * col_slab else col_slab
    outs = []
    for i in range(0, c, step):
        weights = gl.mul(evals[..., i:i + step, :], xs)        # (*S, C', N)
        outs.append(gl2.mul(front, _sum_last(gl2.mul_base(inv_dens,
                                                          weights))))
    return outs[0] if len(outs) == 1 else gl2.concatenate(outs, dim=-1)


def coset_lde(evals: GL, log_blowup: int, shift: int = 7) -> GL:
    """Low-degree extend evaluations on <g_N> to the coset
    shift * <g_(N * 2^log_blowup)> (the reference's disjoint-domain shift
    7, two_adic.rs:61-71), natural order."""
    return coset_lde_pair(evals, 1, log_blowup, shift)


def barycentric_eval(evals: GL, shift: int, z: GL) -> GL:
    """Evaluate the polynomials interpolating `evals` (..., N) on the coset
    shift * <g_N> at base-field points z (...,), one per leading index:

        p(z) = (z^N - s^N) / (N s^N) * sum_i e_i x_i / (z - x_i),
        x_i = s g^i.

    One batched inversion; the sum halves the last axis."""
    n = evals.shape[-1]
    log_n = log2_strict(n)
    dev = evals.device
    xs = coset_points(log_n, shift, dev)                       # (N,)
    inv_dens = gl.inv(gl.sub(GL(z.lo[..., None], z.hi[..., None]), xs))
    s = gl.mul(gl.mul(evals, xs), inv_dens)
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = gl.add(s[..., :half], s[..., half:])
    s_n = pow(shift, n, P)
    front = gl.mul(gl.sub(gl.pow_const(z, n), gl.full(z.shape, s_n, dev)),
                   gl.full((), Gl.inv(n % P * s_n % P), dev))
    return gl.mul(front, s[..., 0])


# ------------------------------------------------------------ four-step

def _swap_last(x: GL) -> GL:
    """(..., A, B) -> the view (..., B, A)."""
    return GL(x.lo.transpose(-1, -2), x.hi.transpose(-1, -2))


@lru_cache(maxsize=None)
def _four_step_twiddles(log_a: int, log_b: int, inverse: bool, device) -> GL:
    """w_N^(i * j) for i in [A], j in [B], N = A * B, GL (A, B); w the
    two-adic generator of order N (its inverse when `inverse`)."""
    w = Gl.two_adic_generator(log_a + log_b)
    if inverse:
        w = Gl.inv(w)
    table = powers(w, 1 << (log_a + log_b), device)
    i = torch.arange(1 << log_a, dtype=torch.int64, device=device)
    j = torch.arange(1 << log_b, dtype=torch.int64, device=device)
    return table[i[:, None] * j[None, :]]


def ntt_four_step(x: GL, inverse: bool = False) -> GL:
    """Four-step NTT of a length-A*B vector viewed as an (A, B) matrix,
    row-major (element k = x[k // B, k % B]): (1) length-A transforms of
    the columns; (2) the twiddles w_N^(i * j); (3) length-B transforms of
    the rows; the result M read out transposed, X[j * A + i] = M[i, j]
    (`four_step_output`).  inverse=True includes the 1/N scale (1/A in
    step 1, 1/B in step 3).  x: GL (..., A, B) -> M GL (..., A, B)."""
    log_a, log_b = log2_strict(x.shape[-2]), log2_strict(x.shape[-1])
    x = _swap_last(ntt(_swap_last(x), inverse))
    x = gl.mul(_four_step_twiddles(log_a, log_b, inverse, x.device), x)
    return ntt(x, inverse)


def four_step_output(m: GL) -> GL:
    """The natural-order NTT vector of a four-step result M (..., A, B):
    X[j * A + i] = M[i, j]."""
    a, b = m.shape[-2], m.shape[-1]
    t = _swap_last(m)
    return GL(t.lo.reshape(*m.shape[:-2], a * b),
              t.hi.reshape(*m.shape[:-2], a * b))


def _exchange(blocks: GL, group) -> GL:
    """all_to_all over `group` of GL blocks (n, ...): block k goes to rank
    k, and block k of the result came from rank k.  Both limbs travel in
    one call."""
    send = torch.stack([blocks.lo, blocks.hi], dim=1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return GL(recv[:, 0], recv[:, 1])


def _gather_rows(x: GL, group, n: int) -> GL:
    """all_gather over `group` of each rank's row block (..., A/n, B),
    concatenated in rank order along the row axis: (..., A, B)."""
    send = torch.stack([x.lo, x.hi]).contiguous()
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    full = torch.cat(parts, dim=-2)
    return GL(full[0], full[1])


def coset_ntt_four_step(coeffs: GL, shift: int, log_rows: int = 3,
                        mesh=None, axis: str = None) -> GL:
    """coset_ntt(coeffs, shift) through the four-step factorization of its
    length N = A * B, A = 2^log_rows: natural order out, the same values.

    With `mesh` (a torch.distributed DeviceMesh; `axis` names its
    dimension, the first by default) each of its n ranks holds A/n rows of
    the (A, B) view, and the exchanges that the JAX package left to XLA are
    explicit all-to-alls: rows to column blocks (each rank then holds all
    A rows of B/n columns) for the length-A transforms and the twiddles,
    then back to full rows for the length-B transforms.  An all-gather of
    the row blocks follows, because the prover downstream runs replicated:
    every rank returns the whole result."""
    n = coeffs.shape[-1]
    log_n = log2_strict(n)
    if not 0 <= log_rows <= log_n:
        raise ValueError(f"log_rows={log_rows} for a length-{n} transform")
    a, b = 1 << log_rows, n >> log_rows
    batch = coeffs.shape[:-1]
    view = gl.mul(_shift_powers(shift % P, log_n, coeffs.device),
                  coeffs).reshape(*batch, a, b)
    if mesh is None:
        return four_step_output(ntt_four_step(view))

    from ..parallel.mesh import axis_group

    group, rank, ranks = axis_group(mesh, axis)
    if a % ranks or b % ranks:
        raise ValueError(f"a ({a}, {b}) four-step view does not split over "
                         f"{ranks} ranks")
    ar, bc = a // ranks, b // ranks
    rows = view[..., rank * ar:(rank + 1) * ar, :]         # (..., A/n, B)
    # rows -> column blocks: block k (..., A/n, B/n) to rank k
    cols = _exchange(tree_map(                  # (n, ..., A/n, B/n)
        lambda t: t.reshape(*batch, ar, ranks, bc).movedim(-2, 0), rows),
        group)
    cols = tree_map(lambda t: t.movedim(0, -3).reshape(*batch, a, bc), cols)
    cols = _swap_last(ntt(_swap_last(cols)))
    tw = _four_step_twiddles(log_rows, log_n - log_rows, False, coeffs.device)
    cols = gl.mul(tw[:, rank * bc:(rank + 1) * bc], cols)
    # column blocks -> full rows: rows [k A/n, (k + 1) A/n) to rank k
    rows = _exchange(tree_map(                  # (n, ..., A/n, B/n)
        lambda t: t.reshape(*batch, ranks, ar, bc).movedim(-3, 0), cols),
        group)
    rows = tree_map(lambda t: t.movedim(0, -2).reshape(*batch, ar, b), rows)
    return four_step_output(_gather_rows(ntt(rows), group, ranks))
