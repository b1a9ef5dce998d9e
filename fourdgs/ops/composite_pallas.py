"""Per-tile ordered alpha compositing: a Pallas kernel (Triton route) and
its plain XLA reference.

Replaces the reference's fragment shader + fixed-function blend
(Splat4DFragShader.GLSL + GL_SRC_ALPHA/GL_ONE_MINUS_SRC_ALPHA,
Application.cpp:137-154). The kernel follows the per-tile design of the 3D
Gaussian Splatting CUDA rasterizer (Kerbl et al., SIGGRAPH 2023): one
program per (tile, pixel block); every pixel keeps its accumulators in
registers and blends the tile's depth-ordered splat records front to back,
one splat at a time, reading each record once; the program stops once every
pixel of its block is saturated.

Gradients: `composite_records` carries a custom VJP whose backward kernel
follows the same design. With splats front-to-back and per pixel
    C   = sum_i alpha_i c_i T_i,   A = sum_i alpha_i^2 T_i,
    T_i = prod_{j<i} (1 - alpha_j),   T_fin = prod_i (1 - alpha_i)
the cotangents are
    dL/dalpha_i = T_i [g_C . (c_i - R_C,i) + g_A (2 alpha_i - R_A,i)
                       - g_T Q_i]
where R_X,i = sum_{j>i} x_j alpha_j prod_{i<k<j} (1 - alpha_k) blends the
splats behind i back to front (x = c for C, x = alpha for A) and
Q_i = prod_{k>i} (1 - alpha_k). The backward first re-walks the forward
front to back to find where it stopped and its final transmittance, then
walks back to front from there, recovering T_i = T_{i+1} / (1 - alpha_i)
and accumulating R and Q by multiplication: nothing is formed as a
difference of two large sums. `_xla_composite_from_records` is the plain
reference both are checked against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from fourdgs.ops import interpret_mode

# Record rows (F dimension of the (T, F, M) per-tile record array).
N_FIELDS = 10
_C_SX, _C_SY, _C_V0X, _C_V0Y = 0, 1, 2, 3
_C_IL0, _C_IL1 = 4, 5
_C_R, _C_G, _C_B, _C_AEFF = 6, 7, 8, 9

ALPHA_MAX = 1.0 - 1e-6
T_SATURATED = 1e-6   # a block whose every pixel is below this stops early
STEP = 32            # splats between two early-stop checks
RESCALE = 2.0 ** 64  # the backward carries T as s * RESCALE**-k
PIXEL_BLOCK = 256    # pixels per program (power of two dividing the tile)


def record_fields(proj, p00, p11, pad_to: int | None = None) -> jax.Array:
    """(N_FIELDS, N) record field matrix for every projected splat.

    a_eff premultiplies color alpha, temporal opacity and the frustum-cull
    flag, so the kernel's alpha is a_eff * exp(-q/2) under the coverage
    clip. Centers are stored in k units (NDC offset over the projection
    diagonal), matching the kernel's pixel coordinates. pad_to appends
    zero columns up to that width."""
    dtype = proj.mx.dtype
    a_eff = proj.opacity * proj.a * proj.valid.astype(dtype)
    rec = jnp.stack([
        proj.mx / p00, proj.my / p11,
        proj.v0x, proj.v0y,
        1.0 / proj.l0, 1.0 / proj.l1,
        proj.r, proj.g, proj.b,
        a_eff,
    ], axis=0)                                         # (10, N)
    if pad_to is not None and pad_to > rec.shape[1]:
        rec = jnp.pad(rec, ((0, 0), (0, pad_to - rec.shape[1])))
    return rec


def pack_records(proj, tile_splat: jax.Array, tile_live: jax.Array,
                 p00, p11, rec: jax.Array | None = None) -> jax.Array:
    """Gather per-tile splat records into the kernel layout (T, F, M);
    tile_live zeroes a_eff for dead list entries. `rec` passes a
    precomputed record_fields matrix (shared with the tail)."""
    if rec is None:
        rec = record_fields(proj, p00, p11)
    gathered = rec[:, tile_splat].transpose(1, 0, 2)   # (T, F, M)
    return gathered.at[:, _C_AEFF, :].multiply(
        tile_live.astype(gathered.dtype))


def identity_carry(t_tiles: int, dtype=jnp.float32, p: int = 1024) -> jax.Array:
    """(T, 8, P) carry for the first depth slab: empty accumulators, full
    transmittance. Rows: r, g, b, a, transmittance, 0, 0, 0."""
    c = jnp.zeros((t_tiles, 8, p), dtype)
    return c.at[:, 4, :].set(1.0)


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------

def _splat_alpha(kx, ky, rec):
    """Per-pixel coverage terms of one splat record (scalars) over a pixel
    block: (dx, dy, e0, e1, n0, n1, w, cover, aw, alpha)."""
    sx, sy, v0x, v0y, il0, il1, _, _, _, a_eff = rec
    dx = kx - sx
    dy = ky - sy
    e0 = v0x * dx + v0y * dy
    e1 = v0y * dx - v0x * dy
    n0 = e0 * il0
    n1 = e1 * il1
    q = 64.0 * (n0 * n0 + n1 * n1)
    w = jnp.exp(-0.5 * q)
    cover = (jnp.abs(n0) <= 0.5) & (jnp.abs(n1) <= 0.5) & (w >= 1e-4)
    aw = a_eff * w
    alpha = jnp.minimum(jnp.where(cover, aw, 0.0), ALPHA_MAX)
    return dx, dy, e0, e1, n0, n1, w, cover, aw, alpha


def _walk(n, trans_of, body, state):
    """Front-to-back walk over splats [0, n) in STEP-sized runs, stopping
    at a run boundary once every pixel's transmittance is saturated. The
    forward and backward kernels share it, so both stop at the same splat.
    Returns (number of splats walked, final state)."""
    def cond(c_state):
        c, st = c_state
        return (c * STEP < n) & (jnp.max(trans_of(st)) > T_SATURATED)

    def run(c_state):
        c, st = c_state
        lo = c * STEP
        return c + 1, jax.lax.fori_loop(lo, jnp.minimum(lo + STEP, n),
                                        body, st)

    c, state = jax.lax.while_loop(cond, run, (jnp.int32(0), state))
    return jnp.minimum(c * STEP, n), state


def _fwd_kernel(counts_ref, rec_ref, kx_ref, ky_ref, carry_ref, out_ref, *,
                pblk: int):
    t = pl.program_id(0)
    pix = pl.ds(pl.program_id(1) * pblk, pblk)
    kx = kx_ref[t, 0, pix]
    ky = ky_ref[t, 0, pix]

    def splat(i, acc):
        r, g, b, a, trans = acc
        rec = tuple(rec_ref[t, f, i] for f in range(N_FIELDS))
        alpha = _splat_alpha(kx, ky, rec)[-1]
        wgt = alpha * trans
        return (r + wgt * rec[_C_R], g + wgt * rec[_C_G],
                b + wgt * rec[_C_B], a + alpha * wgt, trans * (1.0 - alpha))

    _, acc = _walk(counts_ref[t], lambda st: st[4], splat,
                   tuple(carry_ref[t, c, pix] for c in range(5)))
    for c in range(5):
        out_ref[t, c, pix] = acc[c]
    for c in range(5, 8):
        out_ref[t, c, pix] = jnp.zeros_like(kx)


def _bwd_kernel(counts_ref, rec_ref, kx_ref, ky_ref, carry_ref, g_ref,
                drec_in_ref, drec_ref, *, pblk: int):
    """One (tile, pixel block) backward: writes this block's share of the
    record cotangents into drec[t, block] (zero where never reached).
    Transmittance is carried as s * RESCALE**-k, so that neither walk
    loses it to underflow; pixels below RESCALE**-1 contribute nothing."""
    del drec_in_ref   # aliased with drec_ref: the zero initialisation
    t = pl.program_id(0)
    blk = pl.program_id(1)
    pix = pl.ds(blk * pblk, pblk)
    kx = kx_ref[t, 0, pix]
    ky = ky_ref[t, 0, pix]
    gr, gg, gb, ga, gt = (g_ref[t, c, pix] for c in range(5))

    def rec_of(i):
        return tuple(rec_ref[t, f, i] for f in range(N_FIELDS))

    def forward(i, st):
        trans, s, k = st
        one_m = 1.0 - _splat_alpha(kx, ky, rec_of(i))[-1]
        s = s * one_m
        small = s < 1.0 / RESCALE
        return (trans * one_m, jnp.where(small, s * RESCALE, s),
                k + small.astype(jnp.int32))

    t_in = carry_ref[t, 4, pix]
    n_done, (_, s, k) = _walk(counts_ref[t], lambda st: st[0], forward,
                              (t_in, t_in, jnp.zeros(t_in.shape, jnp.int32)))

    def backward(j, st):
        s, k, rr, rg, rb, ra, q = st
        i = n_done - 1 - j
        rec = rec_of(i)
        v0x, v0y, il0, il1 = rec[_C_V0X], rec[_C_V0Y], rec[_C_IL0], rec[_C_IL1]
        cr, cg, cb, a_eff = rec[_C_R], rec[_C_G], rec[_C_B], rec[_C_AEFF]
        dx, dy, e0, e1, n0, n1, w, cover, aw, alpha = _splat_alpha(kx, ky,
                                                                   rec)
        one_m = 1.0 - alpha
        s = s / one_m
        big = (k > 0) & (s >= 1.0)
        s = jnp.where(big, s * (1.0 / RESCALE), s)
        k = k - big.astype(jnp.int32)
        trans = jnp.where(k == 0, s, 0.0)                 # T_i
        wgt = alpha * trans
        d_alpha = trans * (gr * (cr - rr) + gg * (cg - rg) + gb * (cb - rb)
                           + ga * (2.0 * alpha - ra) - gt * q)
        d_aw = jnp.where(cover & (aw < ALPHA_MAX), d_alpha, 0.0)
        d_q = d_aw * a_eff * w * (-0.5)
        dn0 = 128.0 * n0 * d_q
        dn1 = 128.0 * n1 * d_q
        d = (jnp.sum(-dn0 * v0x * il0 - dn1 * v0y * il1),
             jnp.sum(-dn0 * v0y * il0 + dn1 * v0x * il1),
             jnp.sum(dn0 * dx * il0 - dn1 * dy * il1),
             jnp.sum(dn0 * dy * il0 + dn1 * dx * il1),
             jnp.sum(dn0 * e0),
             jnp.sum(dn1 * e1),
             jnp.sum(gr * wgt),
             jnp.sum(gg * wgt),
             jnp.sum(gb * wgt),
             jnp.sum(d_aw * w))
        for f in range(N_FIELDS):
            drec_ref[t, blk, f, i] = d[f]
        return (s, k, alpha * cr + one_m * rr, alpha * cg + one_m * rg,
                alpha * cb + one_m * rb, alpha * alpha + one_m * ra,
                one_m * q)

    zero = jnp.zeros_like(kx)
    jax.lax.fori_loop(0, n_done, backward,
                      (s, k, zero, zero, zero, zero, zero + 1.0))


def _pixel_block(p: int) -> int:
    pblk = min(p, PIXEL_BLOCK)
    assert p % pblk == 0 and pblk & (pblk - 1) == 0, (
        f"tile of {p} pixels: the Triton compositor needs a power-of-two "
        f"pixel block dividing the tile")
    return pblk


def _params(pblk: int):
    return plt.CompilerParams(num_warps=max(1, min(8, pblk // 64)),
                              num_stages=1)


def _composite_fwd_triton(records, counts, kx, ky, carry):
    """records (T, F, M), counts (T,), kx/ky (T, 1, P), carry (T, 8, P)
    -> (T, 8, P)."""
    t_tiles = records.shape[0]
    p = kx.shape[-1]
    pblk = _pixel_block(p)
    return pl.pallas_call(
        functools.partial(_fwd_kernel, pblk=pblk),
        grid=(t_tiles, p // pblk),
        out_shape=jax.ShapeDtypeStruct((t_tiles, 8, p), records.dtype),
        backend="triton", compiler_params=_params(pblk),
        interpret=interpret_mode(), name="composite_fwd",
    )(counts, records, kx, ky, carry)


def _composite_bwd_triton(records, counts, kx, ky, carry, g):
    t_tiles, f, m = records.shape
    p = kx.shape[-1]
    pblk = _pixel_block(p)
    nblk = p // pblk
    zeros = jnp.zeros((t_tiles, nblk, f, m), records.dtype)
    part = pl.pallas_call(
        functools.partial(_bwd_kernel, pblk=pblk),
        grid=(t_tiles, nblk),
        out_shape=jax.ShapeDtypeStruct(zeros.shape, zeros.dtype),
        input_output_aliases={6: 0},
        backend="triton", compiler_params=_params(pblk),
        interpret=interpret_mode(), name="composite_bwd",
    )(counts, records, kx, ky, carry, g, zeros)
    return jnp.sum(part, axis=1)


@jax.custom_vjp
def _composite_triton(records, counts, kx, ky, carry):
    return _composite_fwd_triton(records, counts, kx, ky, carry)


def _composite_triton_fwd(records, counts, kx, ky, carry):
    out = _composite_fwd_triton(records, counts, kx, ky, carry)
    return out, (records, counts, kx, ky, carry, out)


def _composite_triton_bwd(res, g):
    records, counts, kx, ky, carry, fwd_out = res
    d_records = _composite_bwd_triton(records, counts, kx, ky, carry, g)
    # Cotangent w.r.t. the incoming carry (closed form): rgb/a accumulators
    # pass through additively (d = g); every contribution and trans_out
    # scale with trans_in, so d_trans_in = [g . (out - carry parts)] /
    # trans_in.
    trans_in = carry[:, 4:5, :]
    num = (jnp.sum(g[:, 0:4, :] * (fwd_out[:, 0:4, :] - carry[:, 0:4, :]),
                   axis=1, keepdims=True)
           + g[:, 4:5, :] * fwd_out[:, 4:5, :])
    d_trans = jnp.where(trans_in > 0.0,
                        num / jnp.maximum(trans_in, 1e-30), 0.0)
    d_carry = jnp.concatenate(
        [g[:, 0:4, :], d_trans, jnp.zeros_like(g[:, 5:8, :])], axis=1)
    return d_records, None, None, None, d_carry


_composite_triton.defvjp(_composite_triton_fwd, _composite_triton_bwd)


# ---------------------------------------------------------------------------
# plain reference
# ---------------------------------------------------------------------------

def _xla_composite_from_records(records, counts, kx, ky, carry=None):
    """Plain XLA composite over the packed (T, F, M) records: the reference
    the kernel is checked against, differentiable by autodiff. Entries past
    `counts` must carry a_eff 0 (pack_records guarantees it)."""
    del counts
    t_tiles = records.shape[0]
    dtype = records.dtype
    kxf = kx.reshape(t_tiles, 1, -1)
    kyf = ky.reshape(t_tiles, 1, -1)
    col = lambda c: records[:, c, :][..., None]          # noqa: E731

    dx = kxf - col(_C_SX)
    dy = kyf - col(_C_SY)
    n0 = (col(_C_V0X) * dx + col(_C_V0Y) * dy) * col(_C_IL0)
    n1 = (col(_C_V0Y) * dx - col(_C_V0X) * dy) * col(_C_IL1)
    q = 64.0 * (n0 * n0 + n1 * n1)
    w = jnp.exp(-0.5 * q)
    cover = (jnp.abs(n0) <= 0.5) & (jnp.abs(n1) <= 0.5) & (w >= 1e-4)
    alpha = jnp.clip(col(_C_AEFF) * w * cover.astype(dtype), 0.0, ALPHA_MAX)
    log1m = jnp.log1p(-alpha)
    t_excl = jnp.exp(jnp.cumsum(log1m, axis=1) - log1m)
    wgt = alpha * t_excl                                  # (T, M, P)
    if carry is not None:
        wgt = wgt * carry[:, 4:5, :].reshape(t_tiles, 1, -1)
    rgb = jnp.einsum("tmp,tcm->tcp", wgt, records[:, _C_R:_C_B + 1, :],
                     preferred_element_type=dtype,
                     precision=jax.lax.Precision.HIGHEST)  # (T, 3, P)
    a_out = jnp.sum(alpha * wgt, axis=1)
    trans = jnp.exp(jnp.sum(log1m, axis=1))
    out = jnp.concatenate([
        rgb, a_out[:, None, :], trans[:, None, :],
        jnp.zeros((t_tiles, 3, rgb.shape[-1]), dtype)], axis=1)
    if carry is not None:
        out = out.at[:, 0:4, :].add(carry[:, 0:4, :].reshape(t_tiles, 4, -1))
        out = out.at[:, 4:5, :].multiply(
            carry[:, 4:5, :].reshape(t_tiles, 1, -1))
    return out


def composite_records(records, counts, kx, ky, carry, impl: str = "triton"):
    """(T, F, M) records + (T, 8, P) carry -> (T, 8, P): rows r, g, b, a,
    transmittance. carry holds accumulators of an earlier (nearer) depth
    slab; use identity_carry() for the first slab. impl "triton" runs the
    kernel (custom VJP), "xla" the plain reference."""
    if impl == "xla":
        return _xla_composite_from_records(records, counts, kx, ky, carry)
    assert impl == "triton", impl
    return _composite_triton(records, counts, kx, ky, carry)

