"""EWA projection: world-space 3D covariance -> screen-space conic + footprint.

Re-derivation of the per-vertex math in the reference's flagship shader
`Shader/Splats4D/Splat4DVertexShaderInstanced.GLSL:97-147` (identical in the
3D shader `Splat3DVertexShaderFull.GLSL:64-95` and the CPU mirror
`Splat.h:355-431`), vectorized over all splats at once.

With V3 = view[:3,:3] (row-major) and camera-space position (x, y, z), the
reference computes (de-transposing its column-major GLM literals):

    J_std = [[1/z, 0, -x/z^2],
             [0, 1/z, -y/z^2],          (GLSL :119-123)
             [0,   0,    0  ]]
    cov2  = (J_std V3) Sigma3 (J_std V3)^T   upper-left 2x2   (:125-130)

i.e. textbook EWA in NDC units (no focal-length scaling — the projection
matrix diagonal is applied when positioning the quad instead). The 2x2
eigendecomposition (:59-78) then yields the splat's screen frame:

    lambda_min/max = max(m -/+ sqrt(m^2 - p), 1e-6)
    v0 = normalize((b, lambda_min - a)),  v1 = perp(v0)
    conic = (R S S R^T)^{-1},  S = diag(sqrt(lambda))

A pixel at NDC offset delta from the splat center maps to the shader's
interpolated fragment coordinate x_f = 8 k, where

    k = (delta_x / P00, delta_y / P11)

(P00/P11 the projection diagonal; the factor 8 is the reference's fragment
footprint trick, GLSL :145-146 — the unit quad spans 1 sigma but fragment
coordinates are scaled 8x, giving a 4-sigma half-extent). The Gaussian weight
is exp(-0.5 x_f^T conic x_f), discarded below 1e-4 (Splat4DFragShader:30) and
clipped to the rasterized quad |k_eig,i| <= 0.5 * l_i.

Frustum cull (GLSL :108-115): drop the splat when z_ndc < 0 or > 1 or
|x_ndc|, |y_ndc| > 1.2 (note the asymmetric z test against the GL [-1, 1]
depth range — a reference quirk we reproduce).

LAYOUT NOTE: all per-splat quantities are separate 1-D (N,) component
arrays ("scalar SoA"). Batched (N, k) / (N, k, k) tensors with tiny trailing
dims lower to tiny-matrix dot ops and strided layouts; pure scalar component
arithmetic fuses into one elementwise pass instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from fourdgs.core.camera import Camera

# Reference constants.
LAMBDA_EPS = 1e-6          # eigenvalue clamp (GLSL :67)
CULL_BOUND = 1.2           # NDC xy cull bound (GLSL :109)
ALPHA_DISCARD = 1e-4       # fragment discard threshold (Splat4DFragShader:30)
FOOTPRINT_SCALE = 8.0      # fragment-coordinate scale (GLSL :146)
# Radius of the w >= 1e-4 discard threshold in normalized quad coords:
# exp(-32 r^2) = 1e-4  =>  r = sqrt(ln(1e4)/32) = 0.536492; +0.1% slack.
R_COVER = 0.5371


def eigen2x2_scalar(a, b, c):
    """Closed-form symmetric 2x2 eigendecomposition on component arrays,
    matching the shader's GetEigenValues2x2/GetEigenVectors2x2 (GLSL :59-78)
    including the 1e-6 clamp. Input [[a, b], [b, c]]; returns
    (lmin, lmax, v0x, v0y) with (v0x, v0y) the unit lambda_min eigenvector.

    The reference computes v0 = normalize((b, lmin - a)) with no guard: for
    b == 0 that vector can vanish and GLSL normalize(0) is undefined. We
    resolve the UB deterministically: fall back to the axis matching the
    smaller diagonal entry.
    """
    m = 0.5 * (a + c)
    p = a * c - b * b
    d = jnp.sqrt(jnp.maximum(m * m - p, 1e-24))
    lmin = jnp.maximum(m - d, LAMBDA_EPS)
    lmax = jnp.maximum(m + d, LAMBDA_EPS)
    vx, vy = b, lmin - a
    norm = jnp.sqrt(vx * vx + vy * vy)
    ok = norm > 1e-12
    inv = 1.0 / jnp.maximum(norm, 1e-30)
    fx = jnp.where(a <= c, 1.0, 0.0)
    fy = 1.0 - fx
    v0x = jnp.where(ok, vx * inv, fx)
    v0y = jnp.where(ok, vy * inv, fy)
    return lmin, lmax, v0x, v0y


def eigen2x2(cov2: jax.Array):
    """Matrix-shaped wrapper over eigen2x2_scalar for small-N callers/tests.
    cov2 (..., 2, 2) -> (lmin, lmax, v0 (..., 2))."""
    lmin, lmax, v0x, v0y = eigen2x2_scalar(
        cov2[..., 0, 0], cov2[..., 0, 1], cov2[..., 1, 1])
    return lmin, lmax, jnp.stack([v0x, v0y], axis=-1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Projected:
    """Scalar structure-of-arrays of screen-space splats — the
    analog of the vertex-shader outputs (oSig/oColor/oFragPos/oFaulty/
    oTimeOpacity). Every field is a 1-D (N,) array (see module layout note).
    Lengths l are in k units (NDC offset over the projection diagonal)."""
    mx: jax.Array        # splat center NDC x
    my: jax.Array        # splat center NDC y
    depth: jax.Array     # sort key: 1 / |mu(t) - cam|  (Scenes.h:318)
    view_z: jax.Array    # camera-space -z (positive in front)
    v0x: jax.Array       # unit eigenvector (lambda_min) x
    v0y: jax.Array
    l0: jax.Array        # sqrt(lambda_min)
    l1: jax.Array        # sqrt(lambda_max)
    r: jax.Array
    g: jax.Array
    b: jax.Array
    a: jax.Array         # color alpha
    opacity: jax.Array   # temporal (or 1.0) opacity multiplier
    valid: jax.Array     # bool: survived frustum cull

    @property
    def count(self) -> int:
        return self.mx.shape[0]

    def half_extent_ndc(self, p00: jax.Array, p11: jax.Array):
        """Half extents (hx, hy) in NDC of the visible footprint, for tile
        binning. A pixel contributes only if it passes BOTH coverage tests
        (ops/composite_pallas.py `cover`): the quad clip |n_i| <= 0.5 AND the
        discard threshold w >= 1e-4, i.e. n0^2 + n1^2 <= ln(1e4)/32. The
        footprint is therefore quad INTERSECT ellipse; per axis the AABB is
        the min of the two shapes' AABBs. The ellipse bound trims the quad's
        corners (up to 24% tighter at 45 deg rotation), which means fewer
        (tile, splat) pairs and less pair-budget overflow with a bit-identical
        image. R_COVER carries ~0.1% slack so compiled-FMA rounding at the
        w-threshold can never un-cover a pixel outside the box."""
        ax, ay = jnp.abs(self.v0x), jnp.abs(self.v0y)
        qx = 0.5 * (ax * self.l0 + ay * self.l1)
        qy = 0.5 * (ay * self.l0 + ax * self.l1)
        ex = R_COVER * jnp.sqrt((self.v0x * self.l0) ** 2
                                + (self.v0y * self.l1) ** 2)
        ey = R_COVER * jnp.sqrt((self.v0y * self.l0) ** 2
                                + (self.v0x * self.l1) ** 2)
        return jnp.minimum(qx, ex) * p00, jnp.minimum(qy, ey) * p11


def project_components(mx, my, mz, cov3, colors, opacity, camera: Camera,
                       sort_mean: Optional[Tuple] = None) -> Projected:
    """Project N world-space Gaussians given as component arrays.

    mx/my/mz: (N,) world mean; cov3: 6-tuple (c00, c01, c02, c11, c12, c22);
    colors: 4-tuple (r, g, b, a); opacity: (N,) temporal term (1.0 for 3D);
    sort_mean optionally overrides the distance-sort position (the reference
    sorts 4D scenes by the quirky SplatData::GetMeanInTime, Scenes.h:317).
    """
    dtype = mx.dtype
    view = camera.view_matrix().astype(dtype)
    proj = camera.proj_matrix().astype(dtype)
    c00, c01, c02, c11, c12, c22 = cov3
    cr, cg, cb, ca = colors

    v = [[view[0, 0], view[0, 1], view[0, 2]],
         [view[1, 0], view[1, 1], view[1, 2]],
         [view[2, 0], view[2, 1], view[2, 2]]]
    t0, t1, t2 = view[0, 3], view[1, 3], view[2, 3]

    # Camera space (GLSL :104).
    xc = v[0][0] * mx + v[0][1] * my + v[0][2] * mz + t0
    yc = v[1][0] * mx + v[1][1] * my + v[1][2] * mz + t1
    zc = v[2][0] * mx + v[2][1] * my + v[2][2] * mz + t2

    # Clip -> NDC (proj row3 = (0,0,-1,0)).
    w_clip = -zc
    inv_w = 1.0 / jnp.where(jnp.abs(w_clip) > 1e-9, w_clip,
                            jnp.where(w_clip < 0, -1e-9, 1e-9))
    sx = proj[0, 0] * xc * inv_w
    sy = proj[1, 1] * yc * inv_w
    z_ndc = (proj[2, 2] * zc + proj[2, 3]) * inv_w

    # Frustum cull (GLSL :108-115).
    valid = ((z_ndc >= 0.0) & (z_ndc <= 1.0)
             & (jnp.abs(sx) <= CULL_BOUND) & (jnp.abs(sy) <= CULL_BOUND))

    # A = J_std V3 (2x3), J rows = d(x/z, y/z)/d cam.
    zs = jnp.where(jnp.abs(zc) > 1e-6, zc, jnp.where(zc < 0, -1e-6, 1e-6))
    f = 1.0 / zs
    gx = xc * f
    gy = yc * f
    a00 = f * (v[0][0] - gx * v[2][0])
    a01 = f * (v[0][1] - gx * v[2][1])
    a02 = f * (v[0][2] - gx * v[2][2])
    a10 = f * (v[1][0] - gy * v[2][0])
    a11 = f * (v[1][1] - gy * v[2][1])
    a12 = f * (v[1][2] - gy * v[2][2])

    # cov2 = A Sigma A^T, Sigma symmetric.
    # row-vector products u_i = A_i Sigma (3 components each).
    u0x = a00 * c00 + a01 * c01 + a02 * c02
    u0y = a00 * c01 + a01 * c11 + a02 * c12
    u0z = a00 * c02 + a01 * c12 + a02 * c22
    q00 = u0x * a00 + u0y * a01 + u0z * a02
    q01 = u0x * a10 + u0y * a11 + u0z * a12
    u1x = a10 * c00 + a11 * c01 + a12 * c02
    u1y = a10 * c01 + a11 * c11 + a12 * c12
    u1z = a10 * c02 + a11 * c12 + a12 * c22
    q11 = u1x * a10 + u1y * a11 + u1z * a12

    lmin, lmax, v0x, v0y = eigen2x2_scalar(q00, q01, q11)

    # Depth sort key (Scenes.h:314-319): 1 / euclidean distance.
    smx, smy, smz = (mx, my, mz) if sort_mean is None else sort_mean
    cam_p = camera.position.astype(dtype)
    dx = smx - cam_p[0]
    dy = smy - cam_p[1]
    dz = smz - cam_p[2]
    dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    depth = 1.0 / jnp.maximum(dist, 1e-12)

    n = mx.shape[0]
    return Projected(
        mx=sx, my=sy, depth=depth, view_z=-zc,
        v0x=v0x, v0y=v0y, l0=jnp.sqrt(lmin), l1=jnp.sqrt(lmax),
        r=jnp.broadcast_to(cr, (n,)), g=jnp.broadcast_to(cg, (n,)),
        b=jnp.broadcast_to(cb, (n,)), a=jnp.broadcast_to(ca, (n,)),
        opacity=jnp.broadcast_to(jnp.asarray(opacity, dtype), (n,)),
        valid=valid,
    )


def project_splats(mean3: jax.Array, cov3: jax.Array, color: jax.Array,
                   opacity: jax.Array, camera: Camera,
                   sort_mean3: Optional[jax.Array] = None) -> Projected:
    """Matrix-shaped convenience wrapper (small scenes, tests): mean3 (N,3),
    cov3 (N,3,3), color (N,4)."""
    cov = (cov3[:, 0, 0], cov3[:, 0, 1], cov3[:, 0, 2],
           cov3[:, 1, 1], cov3[:, 1, 2], cov3[:, 2, 2])
    colors = (color[:, 0], color[:, 1], color[:, 2], color[:, 3])
    sm = None if sort_mean3 is None else (sort_mean3[:, 0], sort_mean3[:, 1],
                                          sort_mean3[:, 2])
    return project_components(mean3[:, 0], mean3[:, 1], mean3[:, 2], cov,
                              colors, opacity, camera, sort_mean=sm)


def pixel_weight(proj2d: Projected, px: jax.Array, py: jax.Array,
                 p00: jax.Array, p11: jax.Array):
    """Gaussian weight of every (splat, pixel) pair plus the quad-coverage
    mask — the fragment-shader math (Splat4DFragShader.GLSL:16-30).

    px, py: pixel NDC coords with shape P... (any shape); splat fields (N,).
    Returns (weight, coverage) with shape (N,) + P.

    weight = exp(-0.5 * 64 * ((k_eig0 / l0)^2 + (k_eig1 / l1)^2)), i.e. the
    conic applied to x_f = 8 k in the splat eigenframe; coverage is the
    rasterized-quad clip |k_eig,i| <= 0.5 l_i AND weight >= 1e-4.
    """
    pshape = px.shape
    px = px.reshape((1,) + pshape)
    py = py.reshape((1,) + pshape)
    expand = (slice(None),) + (None,) * len(pshape)

    dx = (px - proj2d.mx[expand]) / p00
    dy = (py - proj2d.my[expand]) / p11
    v0x = proj2d.v0x[expand]
    v0y = proj2d.v0y[expand]
    k0 = v0x * dx + v0y * dy        # component along v0 (lambda_min axis)
    k1 = v0y * dx - v0x * dy        # component along v1 = (v0y, -v0x)
    n0 = k0 / proj2d.l0[expand]
    n1 = k1 / proj2d.l1[expand]
    q = (FOOTPRINT_SCALE * FOOTPRINT_SCALE) * (n0 * n0 + n1 * n1)
    weight = jnp.exp(-0.5 * q)
    coverage = (jnp.abs(n0) <= 0.5) & (jnp.abs(n1) <= 0.5) & (weight >= ALPHA_DISCARD)
    return weight, coverage
