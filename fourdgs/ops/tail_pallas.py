"""Streaming banded-OIT tail compositor: a Pallas kernel (Triton route) and
its plain XLA reference.

Closes the depth-cap gap vs the reference, which blends EVERY fragment of
every splat with no depth cap (Splat4DFragShader.GLSL:22-31 + painter's
blend, Application.cpp:150-154). The exact per-tile head composites the
nearest pairs (key <= per-tile cut); this stage takes the exact complement
(key > cut) without sorting or gathering the deep pairs:

  * Pairs stream in EMISSION order: each splat re-walks its bbox tile slots.
    Splats are expected in Morton (3D Z-order) of position, a one-time
    scene-build reorder (splats/packed.morton_order), which keeps the
    accumulator updates of neighbouring splats local.
  * Ordering is approximated by DEPTH BANDS: each `chunk` of splats is
    assigned one of K global depth bands by its mean quantized depth.
    Band-vs-band compositing is ordered; within a band, accumulation is
    order-independent (weighted OIT). Per band x tile x coarse sample the
    stage accumulates 6 planes:
        A = sum(alpha), Ar/Ag/Ab = sum(alpha * rgb), A2 = sum(alpha^2),
        L = sum(log1p(-alpha))
    exp(L) is the EXACT product of (1 - alpha) over the band's pairs
    (products commute), so total transmittance is order-exact up to the
    log1p/exp round trip; only within-band COLOR mixing is approximate.
    The alpha channel uses A2/A to match the head's sum(alpha^2 T).
  * Evaluation is at COARSE samples, one per (by x bx)-pixel block
    (RenderConfig.tail_block), with the splat's footprint widened by the
    block's box-filter variance at preserved mass; the tail field is then
    bilinearly upsampled and blended under the head's transmittance.

The kernel runs one program per block of splats and adds every pair's
planes into the global (band, tile, plane, sample) accumulator with
atomics; the backward kernel needs none, since each program owns its
splats' cotangents. `tail_accumulate_xla` is the plain reference (a
scatter-add), differentiable by autodiff.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from fourdgs.ops import interpret_mode
from fourdgs.render.tiles import QUANT_DEPTH_BITS

ALPHA_MAX = 1.0 - 1e-6
_QSCALE = float(np.sqrt(32.0))    # folds exp(-0.5 * 64 * q) into the prescale
N_PLANES = 6                      # A, Ar, Ag, Ab, A2, L
_P_A, _P_AR, _P_AG, _P_AB, _P_A2, _P_L = range(N_PLANES)
SPLAT_BLOCK = 128                 # splats per kernel program (power of two)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def tail_meta(alive, tx0, tx1, ty0, ty1, dbits, chunk: int):
    """(6, Np) int32 meta operand: [tx0, tx1, ty0, ty1, dbits, raw span
    (0 for dead splats)]. The budget window (main stream: span <= budget;
    big tier: budget < span <= big budget) is applied by tail_accumulate's
    (budget_lo, budget] arguments, so one meta array serves both streams.
    Padded to a `chunk` multiple with dead entries."""
    n = tx0.shape[0]
    span = jnp.where(alive, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    meta = jnp.stack([r.astype(jnp.int32)
                      for r in (tx0, tx1, ty0, ty1, dbits, span)])
    npad = _ceil_to(n, chunk)
    return jnp.pad(meta, ((0, 0), (0, npad - n)))


def step_bands(meta, chunk: int, band_cuts, budget_lo: int = 0,
               budget_hi: int = 1 << 30):
    """(S,) global depth band of every `chunk` of splats: the band of the
    chunk's mean live depth (searchsorted over the K-1 cuts). The
    (budget_lo, budget_hi] span window selects the stream's live splats."""
    dbits = meta[4].reshape(-1, chunk)
    span = meta[5].reshape(-1, chunk)
    live = (span > budget_lo) & (span <= budget_hi)
    d_sum = jnp.sum(jnp.where(live, dbits, 0), axis=1)
    d_mean = d_sum // jnp.maximum(jnp.sum(live, axis=1), 1)
    # band_cuts are quantiles of NEGATED dbits (ascending = near-to-far);
    # query with the negated mean so band 0 is the nearest band.
    return jnp.sum((-d_mean)[:, None] >= band_cuts[None, :],
                   axis=1).astype(jnp.int32)


def global_band_cuts(sample_keys, k_bands: int):
    """(K-1,) ascending dbit cuts = depth quantiles of a live key sample.
    Smaller dbits = farther (dbits are bits of 1/depth), but band ORDER
    must be front-to-back: band 0 = nearest = LARGEST dbits. We therefore
    cut on NEGATED dbits; callers band with searchsorted over these."""
    dead = jnp.iinfo(jnp.int32).max
    d = jnp.where(sample_keys == dead, jnp.int32(-(1 << 20)),
                  -(sample_keys & ((1 << QUANT_DEPTH_BITS) - 1)))
    ds = jax.lax.sort(d, is_stable=False)       # ascending -d = near first
    m = jnp.sum(ds > jnp.int32(-(1 << 20)))     # live count (at the top)
    start = ds.shape[0] - m
    qs = start + (jnp.arange(1, k_bands, dtype=jnp.int32)
                  * m) // k_bands
    return ds[jnp.minimum(qs, ds.shape[0] - 1)]


def tail_params_row(tile_h: int, tile_w: int, block, w: int, h: int,
                    p00, p11, ty_base: int = 0):
    """(8,) f32 kernel constants: affine sample coords in k units +
    box-filter variances. `block` = (by, bx) coarse pixel block;
    `ty_base` offsets band-relative tile rows (tile-row banding)."""
    by, bx = block
    kx_t = (tile_w * 2.0 / w) / p00
    kx_j = (bx * 2.0 / w) / p00
    kx_0 = ((bx * 0.5) * 2.0 / w - 1.0) / p00
    ky_t = -(tile_h * 2.0 / h) / p11
    ky_j = -(by * 2.0 / h) / p11
    ky_0 = (1.0 - (ty_base * tile_h + by * 0.5) * 2.0 / h) / p11
    bx2 = (bx * 2.0 / w / p00) ** 2 / 12.0
    by2 = (by * 2.0 / h / p11) ** 2 / 12.0
    return jnp.stack([kx_t, kx_j, kx_0, ky_t, ky_j, ky_0, bx2,
                      by2]).astype(jnp.float32)


def combine_bands(acc):
    """Fold per-band OIT sums into a front-to-back composite.

    acc (T, K, N_PLANES, S) -> (rgb (T, 3, S), alpha (T, S), trans (T, S)).
    Per band k: tau_k = exp(L_k) is the EXACT product of (1 - alpha) over
    the band's pairs; the band's emitted color is the alpha-weighted mean
    (Ar..)/A scaled by its absorbed fraction (1 - tau_k); the alpha channel
    uses A2/A matching the head kernel's sum(alpha^2 T) semantics. Bands
    composite in order under the exclusive running transmittance."""
    # AD-safe empty-band handling: 0/eps is fine forward but its VJP is
    # inf * 0 = NaN; divide by a where-guarded denominator and zero the
    # result through the mask instead.
    has = acc[:, :, _P_A] > 0.0                          # (T, K, S)
    a_safe = jnp.where(has, acc[:, :, _P_A], 1.0)
    tau = jnp.exp(acc[:, :, _P_L])
    w = 1.0 - tau
    t_run = jnp.cumprod(tau, axis=1)
    t_excl = jnp.concatenate(
        [jnp.ones_like(t_run[:, :1]), t_run[:, :-1]], axis=1)
    wgt = jnp.where(has, t_excl * w / a_safe, 0.0)        # (T, K, S)
    rgb = jnp.einsum("tks,tcks->tcs", wgt,
                     acc[:, :, _P_AR:_P_AB + 1].transpose(0, 2, 1, 3),
                     precision=jax.lax.Precision.HIGHEST)
    alpha = jnp.sum(wgt * acc[:, :, _P_A2], axis=1)
    return rgb, alpha, t_run[:, -1]


def fold_upsample_tail(acc, k_bands: int, nx: int, ny: int, tile_h: int,
                       tile_w: int, s_cy: int, s_cx: int, dtype):
    """Fold the (K * nx * ny, 6 * samples) band accumulator into a
    full-resolution tail field: returns (ny*nx, 5, tile_h*tile_w)
    [r, g, b, a, trans].

    The bilinear upsample runs on the GLOBAL coarse image (not per tile),
    so the tail field is smooth across tile borders; shared by the
    single-device pipeline and the distributed converged path (which sums
    the additive accumulator first)."""
    n_samp = s_cy * s_cx
    acc_t = acc.reshape(k_bands, nx, ny, N_PLANES, n_samp).transpose(
        2, 1, 0, 3, 4).reshape(ny * nx, k_bands, N_PLANES, n_samp)
    rgb_c, alpha_c, trans_c = combine_bands(acc_t)
    coarse = jnp.concatenate(
        [rgb_c, alpha_c[:, None], trans_c[:, None]], axis=1)     # (T, 5, S)
    img_c = coarse.reshape(ny, nx, 5, s_cy, s_cx).transpose(
        2, 0, 3, 1, 4).reshape(5, ny * s_cy, nx * s_cx)
    up = jax.image.resize(
        img_c, (5, ny * tile_h, nx * tile_w), method="bilinear")
    return up.reshape(5, ny, tile_h, nx, tile_w).transpose(
        1, 3, 0, 2, 4).reshape(ny * nx, 5, tile_h * tile_w).astype(dtype)


def blend_tail_under_head(carry, upt):
    """Blend an upsampled tail field under the head carry's per-pixel
    transmittance: carry (T, >=5, P) [r,g,b,a,trans,...], upt (T, 5, P).
    Returns (T, 5, P) updated [r, g, b, a, trans]."""
    t_head = carry[:, 4:5, :]
    return jnp.concatenate([
        carry[:, 0:3, :] + t_head * upt[:, 0:3, :],
        carry[:, 3:4, :] + t_head * upt[:, 3:4, :],
        t_head * upt[:, 4:5, :]], axis=1)


# ---------------------------------------------------------------------------
# shared pair math (kernels and reference)
# ---------------------------------------------------------------------------

def _widen(fields, params):
    """Per-splat footprint widened by the coarse block's box-filter
    variance at preserved mass: l_w^2 = l^2 + c, so il_w = il * m with
    m = rsqrt(1 + c il^2), and the amplitude scales by m0 * m1 (without
    it every pair's alpha integral would inflate by the widening).
    Returns (c0, c1, m0, m1)."""
    _, _, v0x, v0y, il0, il1 = fields[:6]
    bx2, by2 = params[6], params[7]
    c0 = bx2 * v0x * v0x + by2 * v0y * v0y
    c1 = bx2 * v0y * v0y + by2 * v0x * v0x
    m0 = jax.lax.rsqrt(1.0 + c0 * il0 * il0)
    m1 = jax.lax.rsqrt(1.0 + c1 * il1 * il1)
    return c0, c1, m0, m1


def _slot_loop(meta, cut_of, nx: int, ny: int, budget: int, budget_lo: int,
               body, carry):
    """Fold body(live, tx, ty, carry) -> carry over the bbox slots of every
    splat: (tx, ty) is the slot's tile, live whether the pair is a tail
    pair of this stream (slot inside the bbox, span in (budget_lo,
    budget], key beyond the tile's head cut). Carried (ox, oy) offsets
    walk the bbox row-major without a divide; a loop rather than an
    unrolled walk keeps the kernels' code size independent of the budget."""
    tx0, tx1, ty0, ty1, dbits, span = meta
    nxs = tx1 - tx0 + 1
    nys = ty1 - ty0 + 1
    stream = (span > budget_lo) & (span <= budget)

    def slot(s, state):
        ox, oy, carry = state
        tx = tx0 + ox
        ty = ty0 + oy
        tid = jnp.clip(ty * nx + tx, 0, nx * ny - 1)
        key = (tid << QUANT_DEPTH_BITS) | dbits
        live = stream & (s < span) & (oy < nys) & (key > cut_of(tid))
        carry = body(live, tx, ty, carry)
        ox = ox + 1
        wrap = ox >= nxs
        return (jnp.where(wrap, 0, ox), jnp.where(wrap, oy + 1, oy), carry)

    zero = jnp.zeros_like(tx0)
    return jax.lax.fori_loop(0, budget, slot, (zero, zero, carry))[2]


def _sample_alpha(fields, params, m0, m1, gate, tx, ty, jx, jy,
                  exact_clip: bool):
    """Alpha of each pair at coarse sample (jy, jx) of its tile, plus the
    terms the backward pass needs: (alpha, w, cov, e0, e1, n0, n1, dx, dy,
    il0w, il1w)."""
    sx, sy, v0x, v0y, il0, il1 = fields[:6]
    kx_t, kx_j, kx_0, ky_t, ky_j, ky_0 = params[:6]
    # _QSCALE folds the exponent's 64 * 0.5 factor: w = exp(-(n0^2 + n1^2)).
    il0w = il0 * m0 * _QSCALE
    il1w = il1 * m1 * _QSCALE
    dx = kx_t * tx.astype(jnp.float32) + (kx_j * jx + kx_0) - sx
    dy = ky_t * ty.astype(jnp.float32) + (ky_j * jy + ky_0) - sy
    e0 = v0x * dx + v0y * dy
    e1 = v0y * dx - v0x * dy
    n0 = e0 * il0w
    n1 = e1 * il1w
    w = jnp.exp(-(n0 * n0 + n1 * n1))
    cov = w >= 1e-4
    if exact_clip:
        # The head's exact quad clip |n| <= 0.5, in widened-n units (the
        # reference evaluates fragments only inside the quad,
        # Splat4DVertexShaderInstanced.GLSL:145-147).
        cov = cov & (jnp.abs(n0) <= (0.5 * _QSCALE) * m0) \
            & (jnp.abs(n1) <= (0.5 * _QSCALE) * m1)
    alpha = jnp.minimum(jnp.where(cov, gate * w, 0.0), ALPHA_MAX)
    return alpha, w, cov, e0, e1, n0, n1, dx, dy, il0w, il1w


def _sample_xy(j, s_cx: int):
    """Coarse-sample column and row of sample j (row-major) as floats."""
    return (jax.lax.rem(j, s_cx).astype(jnp.float32),
            jax.lax.div(j, s_cx).astype(jnp.float32))


def _planes(alpha, fields):
    cr, cg, cb = fields[6], fields[7], fields[8]
    return (alpha, alpha * cr, alpha * cg, alpha * cb, alpha * alpha,
            jnp.log1p(-alpha))


# ---------------------------------------------------------------------------
# Triton kernels
# ---------------------------------------------------------------------------

def _scatter_add(acc_ref, rows, col: int, val, mask, interpret: bool):
    if interpret:
        # The interpreter's atomic_add keeps only one of several updates
        # that hit the same address; a scatter-add keeps them all.
        acc_ref[...] = acc_ref[...].at[rows, col].add(
            jnp.where(mask, val, 0.0))
    else:
        plt.atomic_add(acc_ref, (rows, col), val, mask=mask)


def _load_block(params_ref, band_ref, cut_ref, fields_ref, meta_ref, *,
                blk: int, chunk: int):
    g = pl.program_id(0)
    sl = pl.ds(g * blk, blk)
    fields = tuple(fields_ref[k, sl] for k in range(10))
    meta = tuple(meta_ref[k, sl] for k in range(6))
    params = tuple(params_ref[k] for k in range(8))
    idx = g * blk + jax.lax.broadcasted_iota(jnp.int32, (blk,), 0)
    step = jnp.minimum(idx // chunk, band_ref.shape[0] - 1)
    band = band_ref[step]
    cut_of = lambda tid: cut_ref[tid]                     # noqa: E731
    return sl, fields, meta, params, band, cut_of


def _tail_fwd_kernel(params_ref, band_ref, cut_ref, fields_ref, meta_ref,
                     acc_in_ref, acc_ref, *, blk: int, chunk: int,
                     budget: int, budget_lo: int, nx: int, ny: int,
                     s_cy: int, s_cx: int, exact_clip: bool,
                     interpret: bool):
    del acc_in_ref   # aliased with acc_ref: the zero initialisation
    _, fields, meta, params, band, cut_of = _load_block(
        params_ref, band_ref, cut_ref, fields_ref, meta_ref, blk=blk,
        chunk=chunk)
    n_samp = s_cy * s_cx
    _, _, m0, m1 = _widen(fields, params)
    a_mass = fields[9] * (m0 * m1)

    def slot(live, tx, ty, carry):
        @pl.when(jnp.max(live.astype(jnp.int32)) > 0)
        def _slot():
            row = jnp.where(live, (band * nx + tx) * ny + ty, 0)
            gate = jnp.where(live, a_mass, 0.0)

            @pl.loop(0, n_samp)
            def _sample(j):
                jx, jy = _sample_xy(j, s_cx)
                alpha = _sample_alpha(fields, params, m0, m1, gate, tx, ty,
                                      jx, jy, exact_clip)[0]
                hit = alpha > 0.0
                for p, v in enumerate(_planes(alpha, fields)):
                    _scatter_add(acc_ref, row, p * n_samp + j, v, hit,
                                 interpret)
        return carry

    _slot_loop(meta, cut_of, nx, ny, budget, budget_lo, slot, ())


def _tail_bwd_kernel(params_ref, band_ref, cut_ref, fields_ref, meta_ref,
                     dacc_ref, df_ref, *, blk: int, chunk: int, budget: int,
                     budget_lo: int, nx: int, ny: int, s_cy: int, s_cx: int,
                     exact_clip: bool):
    """Mirrors the forward pair walk; each pair gathers its six plane
    cotangents from d_acc and the chain rule accumulates per-splat field
    cotangents in registers (no atomics: a program owns its splats)."""
    sl, fields, meta, params, band, cut_of = _load_block(
        params_ref, band_ref, cut_ref, fields_ref, meta_ref, blk=blk,
        chunk=chunk)
    n_samp = s_cy * s_cx
    _, _, v0x, v0y, il0, il1, cr, cg, cb, a_eff = fields
    bx2, by2 = params[6], params[7]
    c0, c1, m0, m1 = _widen(fields, params)
    zero = jnp.zeros_like(il0)

    # Sums over slots and samples: sx, sy, (il0 m0), (il1 m1), v0x and v0y
    # through the pair geometry, colors, and the gate a_eff * m0 * m1.
    def slot(live, tx, ty, acc):
        row = jnp.where(live, (band * nx + tx) * ny + ty, 0)
        gate = jnp.where(live, a_eff * (m0 * m1), 0.0)

        def sample(j, acc):
            (d_sx, d_sy, d_ilm0, d_ilm1, d_v0x, d_v0y, d_cr, d_cg, d_cb,
             d_gate) = acc
            jx, jy = _sample_xy(j, s_cx)
            (alpha, w, cov, e0, e1, n0, n1, dx, dy, il0w,
             il1w) = _sample_alpha(fields, params, m0, m1, gate, tx, ty,
                                   jx, jy, exact_clip)
            dp = [plt.load(dacc_ref.at[row, p * n_samp + j], mask=live,
                           other=0.0) for p in range(N_PLANES)]
            d_alpha = (dp[_P_A] + dp[_P_AR] * cr + dp[_P_AG] * cg
                       + dp[_P_AB] * cb + 2.0 * alpha * dp[_P_A2]
                       - dp[_P_L] / (1.0 - alpha))
            d_aw = jnp.where(cov & (gate * w < ALPHA_MAX), d_alpha, 0.0)
            dqn = d_aw * gate * w * (-2.0)     # d w / d n_i = -2 n_i w
            dn0 = n0 * dqn
            dn1 = n1 * dqn
            return (d_sx - (dn0 * v0x * il0w + dn1 * v0y * il1w),
                    d_sy - (dn0 * v0y * il0w - dn1 * v0x * il1w),
                    d_ilm0 + _QSCALE * dn0 * e0,
                    d_ilm1 + _QSCALE * dn1 * e1,
                    d_v0x + dn0 * dx * il0w - dn1 * dy * il1w,
                    d_v0y + dn0 * dy * il0w + dn1 * dx * il1w,
                    d_cr + dp[_P_AR] * alpha,
                    d_cg + dp[_P_AG] * alpha,
                    d_cb + dp[_P_AB] * alpha,
                    d_gate + d_aw * w)

        return jax.lax.fori_loop(0, n_samp, sample, acc)

    (d_sx, d_sy, d_ilm0, d_ilm1, d_v0x, d_v0y, d_cr, d_cg, d_cb,
     d_gate) = _slot_loop(meta, cut_of, nx, ny, budget, budget_lo, slot,
                          (zero,) * 10)
    # Widening chain: il_w = il * m, m = rsqrt(1 + c il^2), gate ~ m0 m1.
    d_m0 = d_ilm0 * il0 + d_gate * a_eff * m1
    d_m1 = d_ilm1 * il1 + d_gate * a_eff * m0
    d_u0 = d_m0 * (-0.5) * m0 * m0 * m0
    d_u1 = d_m1 * (-0.5) * m1 * m1 * m1
    d_c0 = d_u0 * il0 * il0
    d_c1 = d_u1 * il1 * il1
    out = (d_sx, d_sy,
           d_v0x + 2.0 * v0x * (d_c0 * bx2 + d_c1 * by2),
           d_v0y + 2.0 * v0y * (d_c0 * by2 + d_c1 * bx2),
           d_ilm0 * m0 + d_u0 * 2.0 * c0 * il0,
           d_ilm1 * m1 + d_u1 * 2.0 * c1 * il1,
           d_cr, d_cg, d_cb, d_gate * m0 * m1)
    for k in range(10):
        df_ref[k, sl] = out[k]


def _kernel_operands(fields, meta, cut, blk):
    npts = _ceil_to(meta.shape[1], blk)
    fields = jnp.pad(fields, ((0, 0), (0, npts - fields.shape[1])))
    meta = jnp.pad(meta, ((0, 0), (0, npts - meta.shape[1])))
    return fields, meta, cut.astype(jnp.int32), npts


def _tail_fwd_triton(fields, meta, band, cut, params_row, static):
    (k_bands, nx, ny, chunk, budget, budget_lo, s_cy, s_cx,
     exact_clip) = static
    blk = SPLAT_BLOCK
    fields_p, meta_p, cut, npts = _kernel_operands(fields, meta, cut, blk)
    acc0 = jnp.zeros((k_bands * nx * ny, N_PLANES * s_cy * s_cx),
                     jnp.float32)
    interpret = interpret_mode()
    kern = functools.partial(
        _tail_fwd_kernel, blk=blk, chunk=chunk, budget=budget,
        budget_lo=budget_lo, nx=nx, ny=ny, s_cy=s_cy, s_cx=s_cx,
        exact_clip=exact_clip, interpret=interpret)
    return pl.pallas_call(
        kern, grid=(npts // blk,),
        out_shape=jax.ShapeDtypeStruct(acc0.shape, acc0.dtype),
        input_output_aliases={5: 0},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret, name="tail_fwd",
    )(params_row, band, cut, fields_p, meta_p, acc0)


def _tail_bwd_triton(fields, meta, band, cut, params_row, d_acc, static):
    (k_bands, nx, ny, chunk, budget, budget_lo, s_cy, s_cx,
     exact_clip) = static
    blk = SPLAT_BLOCK
    fields_p, meta_p, cut, npts = _kernel_operands(fields, meta, cut, blk)
    kern = functools.partial(
        _tail_bwd_kernel, blk=blk, chunk=chunk, budget=budget,
        budget_lo=budget_lo, nx=nx, ny=ny, s_cy=s_cy, s_cx=s_cx,
        exact_clip=exact_clip)
    df = pl.pallas_call(
        kern, grid=(npts // blk,),
        out_shape=jax.ShapeDtypeStruct((10, npts), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret_mode(), name="tail_bwd",
    )(params_row, band, cut, fields_p, meta_p, d_acc)
    return df[:, :fields.shape[1]]


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def _tail_triton(fields, meta, band, cut, params_row, static):
    return _tail_fwd_triton(fields, meta, band, cut, params_row, static)


def _tail_triton_fwd(fields, meta, band, cut, params_row, static):
    acc = _tail_fwd_triton(fields, meta, band, cut, params_row, static)
    return acc, (fields, meta, band, cut, params_row)


def _float0_like(x):
    return np.zeros(x.shape, jax.dtypes.float0)


def _tail_triton_bwd(static, res, d_acc):
    fields, meta, band, cut, params_row = res
    df = _tail_bwd_triton(fields, meta, band, cut, params_row, d_acc, static)
    return (df, _float0_like(meta), _float0_like(band), _float0_like(cut),
            jnp.zeros_like(params_row))


_tail_triton.defvjp(_tail_triton_fwd, _tail_triton_bwd)


def tail_accumulate(fields, meta, band, cut, params_row, k_bands: int,
                    nx: int, ny: int, chunk: int, budget: int, s_cy: int,
                    s_cx: int, budget_lo: int = 0, exact_clip: bool = False,
                    impl: str = "triton"):
    """Accumulate every tail pair into the band accumulator.

    fields (10, N) f32 record rows; meta (6, Np) i32 from tail_meta (Np a
    multiple of chunk); band (Np // chunk,) i32 from step_bands; cut (T,)
    i32 per-tile head cut keys; params_row (8,) f32 from tail_params_row.
    Returns acc (k_bands * nx * ny, 6 * s_cy * s_cx) f32: row (band, tx,
    ty), column (plane, sample). impl "triton" runs the kernels (custom
    VJP w.r.t. fields), "xla" the plain reference."""
    if impl == "xla":
        return tail_accumulate_xla(fields, meta, band, cut, params_row,
                                   k_bands=k_bands, nx=nx, ny=ny,
                                   chunk=chunk, budget=budget, s_cy=s_cy,
                                   s_cx=s_cx, budget_lo=budget_lo,
                                   exact_clip=exact_clip)
    assert impl == "triton", impl
    static = (k_bands, nx, ny, chunk, budget, budget_lo, s_cy, s_cx,
              exact_clip)
    return _tail_triton(fields, meta, band, cut, params_row, static)


def tail_accumulate_xla(fields, meta, band, cut, params_row, k_bands: int,
                        nx: int, ny: int, chunk: int, budget: int,
                        s_cy: int, s_cx: int, budget_lo: int = 0,
                        exact_clip: bool = False):
    """Plain XLA reference of tail_accumulate: per slot, every pair's six
    planes at every sample, scatter-added into the accumulator."""
    n_samp = s_cy * s_cx
    npts = meta.shape[1]
    if fields.shape[1] != npts:
        fields = jnp.pad(fields, ((0, 0), (0, npts - fields.shape[1])))
    fields = tuple(fields)
    cut = cut.astype(jnp.int32)
    params = tuple(params_row[i] for i in range(8))
    acc = jnp.zeros((k_bands * nx * ny, N_PLANES * n_samp), jnp.float32)
    _, _, m0, m1 = _widen(fields, params)
    a_mass = fields[9] * (m0 * m1)
    band_full = jnp.repeat(band, chunk)
    jx = jnp.arange(n_samp) % s_cx
    jy = jnp.arange(n_samp) // s_cx
    col = lambda a: a[:, None]                            # noqa: E731
    fields_c = tuple(col(f) for f in fields)

    def slot(live, tx, ty, acc):
        gate = jnp.where(live, a_mass, 0.0)
        alpha = _sample_alpha(fields_c, params, col(m0), col(m1), col(gate),
                              col(tx), col(ty), jx[None, :], jy[None, :],
                              exact_clip)[0]               # (Np, n_samp)
        planes = jnp.concatenate(_planes(alpha, fields_c), axis=1)
        row = jnp.where(live, (band_full * nx + tx) * ny + ty, 0)
        return acc.at[row].add(jnp.where(live[:, None], planes, 0.0))

    return _slot_loop(meta, lambda tid: cut[tid], nx, ny, budget, budget_lo,
                      slot, acc)
