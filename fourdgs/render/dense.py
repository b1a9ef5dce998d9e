"""Dense (all-splats-vs-all-pixels) renderer — the reference-exact golden model.

This is the semantic ground truth the tiled/Pallas pipelines are tested
against. It reproduces the reference's fixed-function pipeline exactly:

* fragment weight + discard: Splat4DFragShader.GLSL:16-30 (via
  render/project.pixel_weight),
* painter's-algorithm blending with straight alpha, GL_SRC_ALPHA /
  GL_ONE_MINUS_SRC_ALPHA, blend on / depth test off (Application.cpp:137-154):
      C <- a*src.rgb + (1-a)*C,   A <- a*src.a + (1-a)*A,  a = top*w*src.a
* back-to-front order by ascending 1/distance radix keys (Scenes.h:312-328);
  ties preserve splat-index order because the reference sort is stable.

Rather than looping pixels (the GPU rasterizer's job in the reference), the
whole composite is expressed as a scan over front-to-back splat chunks with a
running per-pixel log-transmittance; inside a chunk the ordered blend becomes
an exclusive cumsum of log(1 - alpha) followed by a [pixels x chunk] @
[chunk x 4] matmul (at HIGHEST precision) — fully differentiable, no
data-dependent shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from fourdgs.core.camera import Camera, pixel_centers_ndc
from fourdgs.render.project import (Projected, eigen2x2, pixel_weight,
                                    project_splats)
from fourdgs.splats.gaussians import (Splats2D, Splats3D, Splats4D,
                                      mean_in_time_sortkey)

# Keep log(1 - alpha) finite: alpha == 1 only occurs for a fully saturating
# splat, where the difference is invisible but the gradient would be NaN.
ALPHA_MAX = 1.0 - 1e-6


def painter_to_front_to_back(depth_key: jax.Array) -> jax.Array:
    """Permutation putting splats in front-to-back order, matching the
    reference painter order exactly (including tie behavior).

    The reference stable-radix-sorts ascending keys 1/distance and draws in
    that order (back-to-front); front-to-back is that order reversed.
    """
    order_painter = jnp.argsort(depth_key, stable=True)
    return order_painter[::-1]


def sort_front_to_back(proj: Projected) -> Projected:
    order = painter_to_front_to_back(proj.depth)
    return jax.tree_util.tree_map(lambda a: a[order], proj)


def composite_dense(proj: Projected, px: jax.Array, py: jax.Array,
                    p00: jax.Array, p11: jax.Array,
                    background: jax.Array, chunk: int = 256,
                    premultiplied: bool = False) -> jax.Array:
    """Alpha-composite front-to-back-ordered splats over a pixel grid.

    proj fields (N,), px/py (H, W) NDC pixel centers, background (4,) rgba.
    Returns (H, W, 4). N is padded to a multiple of `chunk`.

    premultiplied reproduces the 3D fragment shader's output convention
    (Splat3DFragShaderFull.GLSL:22: color = c * RGBA before the fixed
    GL_SRC_ALPHA blend), i.e. the blended rgb is additionally scaled by the
    Gaussian weight; the 2D/4D shaders emit straight color (default).
    """
    h, w = px.shape
    dtype = px.dtype
    n = proj.count
    n_pad = -n % chunk
    if n_pad:
        def pad(a):
            widths = [(0, n_pad)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, widths)
        proj = jax.tree_util.tree_map(pad, proj)
    n_chunks = proj.count // chunk

    pxf = px.reshape(-1)
    pyf = py.reshape(-1)
    npix = pxf.shape[0]

    chunked = jax.tree_util.tree_map(
        lambda a: a.reshape((n_chunks, chunk) + a.shape[1:]), proj)

    def step(carry, chunk_proj):
        rgb_acc, a_acc, log_t = carry
        weight, cover = pixel_weight(chunk_proj, pxf, pyf, p00, p11)  # (C, P)
        gate = (cover & chunk_proj.valid[:, None]).astype(dtype)
        # Zero-padding splats have l = 0 and produce 0/0 = NaN weights at
        # k = 0; coverage is False there, so gating the weight (not just
        # alpha) keeps the premultiplied path NaN-free.
        weight = jnp.where(cover, weight, 0.0)
        alpha = chunk_proj.opacity[:, None] * weight * chunk_proj.a[:, None] * gate
        alpha = jnp.clip(alpha, 0.0, ALPHA_MAX)
        log1m = jnp.log1p(-alpha)
        # Transmittance in front of each splat of this chunk.
        t_excl = jnp.exp(log_t[None, :] + jnp.cumsum(log1m, axis=0) - log1m)
        wgt = alpha * t_excl  # (C, P)
        cw = wgt * weight if premultiplied else wgt
        rgb_chunk = jnp.stack([chunk_proj.r, chunk_proj.g, chunk_proj.b], axis=-1)
        rgb_acc = rgb_acc + jnp.einsum("cp,cd->pd", cw, rgb_chunk,
                                       preferred_element_type=dtype,
                                       precision=jax.lax.Precision.HIGHEST)
        # GL alpha channel: out.a = a*src.a + (1-a)*dst.a with src.a = a.
        a_acc = a_acc + jnp.sum(alpha * wgt, axis=0)
        log_t = log_t + jnp.sum(log1m, axis=0)
        return (rgb_acc, a_acc, log_t), None

    init = (jnp.zeros((npix, 3), dtype), jnp.zeros((npix,), dtype),
            jnp.zeros((npix,), dtype))
    (rgb, a, log_t), _ = jax.lax.scan(step, init, chunked)
    t_final = jnp.exp(log_t)
    rgb = rgb + t_final[:, None] * background[:3]
    a = a + t_final * background[3]
    return jnp.concatenate([rgb, a[:, None]], axis=-1).reshape(h, w, 4)


# ---------------------------------------------------------------------------
# generic GL blend explorer (DebugMenus.h:211-274 analog)
# ---------------------------------------------------------------------------

# The blend-factor set the reference's explorer exposes (glBlendFunc enums).
BLEND_FACTORS = ("zero", "one", "src_alpha", "one_minus_src_alpha",
                 "dst_alpha", "one_minus_dst_alpha",
                 "src_color", "one_minus_src_color",
                 "dst_color", "one_minus_dst_color")


def _blend_factor(name: str, src_rgba, dst_rgba):
    """Per-channel GL blend factor (rgb factors use the matching channel for
    *_color; alpha factors broadcast), for (..., 4) rgba tensors."""
    sa = src_rgba[..., 3:4]
    da = dst_rgba[..., 3:4]
    one = jnp.ones_like(src_rgba)
    table = {
        "zero": jnp.zeros_like(src_rgba),
        "one": one,
        "src_alpha": jnp.broadcast_to(sa, src_rgba.shape),
        "one_minus_src_alpha": jnp.broadcast_to(1.0 - sa, src_rgba.shape),
        "dst_alpha": jnp.broadcast_to(da, src_rgba.shape),
        "one_minus_dst_alpha": jnp.broadcast_to(1.0 - da, src_rgba.shape),
        "src_color": src_rgba,
        "one_minus_src_color": 1.0 - src_rgba,
        "dst_color": dst_rgba,
        "one_minus_dst_color": 1.0 - dst_rgba,
    }
    if name not in table:
        raise ValueError(f"unknown blend factor {name!r}; "
                         f"choose from {BLEND_FACTORS}")
    return table[name]


def composite_dense_blend(proj: Projected, px: jax.Array, py: jax.Array,
                          p00, p11, background: jax.Array,
                          src_factor: str = "src_alpha",
                          dst_factor: str = "one_minus_src_alpha",
                          premultiplied: bool = False) -> jax.Array:
    """Back-to-front composite under an ARBITRARY glBlendFunc pair — the
    analog of the reference's blend-function explorer
    (DebugMenus.h:211-274 driving glBlendFunc at Application.cpp:150).

    `proj` must be in *front-to-back* order (like composite_dense); the scan
    walks it back to front applying dst = src*F_src + dst*F_dst per GL
    semantics, with fragment discard leaving dst untouched. O(N) sequential
    over splats — an exploration tool for showcase scenes, not the
    production compositor (whose SRC_ALPHA/ONE_MINUS_SRC_ALPHA special case
    has the closed transmittance form)."""
    h, w = px.shape
    dtype = px.dtype
    pxf = px.reshape(-1)
    pyf = py.reshape(-1)
    npix = pxf.shape[0]

    # Back-to-front = reversed front-to-back.
    proj_btf = jax.tree_util.tree_map(lambda a: a[::-1], proj)

    def step(dst, sp):
        weight, cover = pixel_weight(sp, pxf, pyf, p00, p11)   # (1, P)
        weight = jnp.where(cover, weight, 0.0)[0]
        cover = (cover[0] & sp.valid).astype(dtype)
        alpha = jnp.clip(sp.opacity * weight * sp.a, 0.0, 1.0)
        rgb = jnp.broadcast_to(jnp.stack([sp.r[0], sp.g[0], sp.b[0]]),
                               (npix, 3))
        if premultiplied:
            rgb = rgb * weight[:, None]
        src = jnp.concatenate([rgb, alpha[:, None]], axis=-1)  # (P, 4)
        fs = _blend_factor(src_factor, src, dst)
        fd = _blend_factor(dst_factor, src, dst)
        blended = src * fs + dst * fd
        # Fragment discard: below-threshold fragments don't touch dst.
        live = (cover * (weight >= 1e-4))[:, None]
        return dst + live * (blended - dst), None

    per_splat = jax.tree_util.tree_map(lambda a: a[:, None], proj_btf)
    init = jnp.broadcast_to(background, (npix, 4)).astype(dtype)
    out, _ = jax.lax.scan(step, init, per_splat)
    return out.reshape(h, w, 4)


# ---------------------------------------------------------------------------
# full-scene entry points
# ---------------------------------------------------------------------------

def render_splats3d(splats: Splats3D, camera: Camera,
                    opacity: Optional[jax.Array] = None,
                    sort_mean3: Optional[jax.Array] = None,
                    background=(0.0, 0.0, 0.0, 1.0),
                    sort: bool = True, chunk: int = 256,
                    premultiplied: bool = False) -> jax.Array:
    """Render 3D splats (optionally with per-splat extra opacity, i.e. an
    already-sliced 4D scene) through the dense golden path. Returns (H,W,4).

    Set premultiplied=True for the reference's dedicated 3D path
    (Splat3DFragShaderFull.GLSL:22 emits c*RGBA); the 4D scenes use straight
    color (Splat4DFragShader.GLSL:29, the default here)."""
    dtype = splats.position.dtype
    op = jnp.ones((splats.count,), dtype) if opacity is None else opacity
    proj = project_splats(splats.position, splats.cov, splats.color, op,
                          camera, sort_mean3=sort_mean3)
    if sort:
        proj = sort_front_to_back(proj)
    else:
        # Unsorted reference order: painter draws index 0 first, so
        # front-to-back is reversed index order.
        proj = jax.tree_util.tree_map(lambda a: a[::-1], proj)
    pmat = camera.proj_matrix().astype(dtype)
    px, py = pixel_centers_ndc(camera.width, camera.height, dtype)
    return composite_dense(proj, px, py, pmat[0, 0], pmat[1, 1],
                           jnp.asarray(background, dtype), chunk=chunk,
                           premultiplied=premultiplied)


def render_splats4d(splats: Splats4D, camera: Camera, t,
                    min_opacity=0.0, background=(0.0, 0.0, 0.0, 1.0),
                    sort: bool = True, chunk: int = 256) -> jax.Array:
    """Render a 4D scene at time t — the full flagship path: temporal slice +
    opacity (GLSL :83-95), EWA, distance sort with the reference's quirky
    sort mean (Scenes.h:314-319), ordered composite."""
    sliced, top = splats.at_time(t, min_opacity)
    sort_mean = mean_in_time_sortkey(splats.position, splats.cov, t)
    return render_splats3d(sliced, camera, opacity=top, sort_mean3=sort_mean,
                           background=background, sort=sort, chunk=chunk)


def project_splats2d(splats: Splats2D, camera: Camera) -> Tuple[Projected, jax.Array, jax.Array]:
    """Screen-space projection of 2D splats — Splat2DVSI.GLSL:59-94 in its
    shipped SCREEN_SPACE_POS configuration.

    The shader maps a splat at world xy to clip space via
        ss  = normalized(uProj * (x, y, -1, 1)) = (P00 x, P11 y, ssz, 1)
        pos = uProj * ((R S u, -5, 1) + ss),  w_clip = 5 - ssz
    so center_ndc = (P00 ss.x, P11 ss.y) / (5 - ssz) and an NDC offset delta
    corresponds to k = R S u = delta * (5 - ssz) / (P00, P11).

    Two deliberate reference quirks are reproduced (GLSL :67-79): the
    eigenvalues are doubled (l = sqrt(2 lambda)) and S = diag(l1, l0) pairs
    the *larger* scale with the lambda_min eigenvector — the rendered ellipse
    is the 90-degree-rotated, doubled version of the stored covariance. We
    encode that by storing swapped lengths in the Projected record.

    Returns (proj, p00_eff, p11_eff) where the effective projection diagonal
    absorbs the (5 - ssz) divisor so pixel_weight() works unchanged.
    """
    dtype = splats.position.dtype
    pmat = camera.proj_matrix().astype(dtype)
    p00, p11 = pmat[0, 0], pmat[1, 1]
    ssz = -pmat[2, 2] + pmat[2, 3]  # z of uProj*(x,y,-1,1) with w_clip = 1
    denom = 5.0 - ssz               # w_clip of the quad vertices

    lmin, lmax, v0 = eigen2x2(splats.cov)
    l0 = jnp.sqrt(2.0 * lmin)
    l1 = jnp.sqrt(2.0 * lmax)

    n = splats.count
    proj = Projected(
        mx=splats.position[:, 0] * p00 * p00 / denom,
        my=splats.position[:, 1] * p11 * p11 / denom,
        depth=jnp.zeros((n,), dtype),          # no sorting in the 2D scene
        view_z=jnp.full((n,), 5.0, dtype),
        v0x=v0[:, 0], v0y=v0[:, 1],
        l0=l1,                                  # swap quirk (GLSL :76)
        l1=l0,
        r=splats.color[:, 0], g=splats.color[:, 1], b=splats.color[:, 2],
        a=splats.color[:, 3],
        opacity=jnp.ones((n,), dtype),
        valid=jnp.ones((n,), bool),
    )
    return proj, p00 / denom, p11 / denom


def render_splats2d(splats: Splats2D, camera: Camera,
                    background=(0.0, 0.0, 0.0, 1.0), chunk: int = 256) -> jax.Array:
    """Render the 2D-Gaussians workload (Scenes.h:1443-1610): unsorted painter
    order over the splat list."""
    dtype = splats.position.dtype
    proj, p00e, p11e = project_splats2d(splats, camera)
    proj = jax.tree_util.tree_map(lambda a: a[::-1], proj)  # reversed = front-to-back
    px, py = pixel_centers_ndc(camera.width, camera.height, dtype)
    return composite_dense(proj, px, py, p00e, p11e,
                           jnp.asarray(background, dtype), chunk=chunk)
