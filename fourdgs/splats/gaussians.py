"""Gaussian splat parameterizations: covariance builders and 4D time slicing.

This is the re-design of the host-side math in the reference's
`Splat.h` (classes Splat2D :559-653, Splat3D :331-556, Splat4D :85-329 and
SplatUtils :31-83). Instead of per-splat C++ objects, splats are
structure-of-array pytrees and every builder is a batched, differentiable jnp
function, so covariance construction runs on-device inside the render jit and
gradients flow to every parameter (position, rotation, scale, lifetime,
velocity, color).

All matrices are row-major math matrices (see core/camera.py); all reference
GLM column-major constructions have been de-transposed.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from fourdgs.core.transforms import quat_normalize, quat_to_mat3

# -2 ln(0.5): precomputed constant the reference uses when fade == 0.5
# (Splat.h:29,139).
STD_LOWER = 1.3862943611198906


# ---------------------------------------------------------------------------
# covariance builders
# ---------------------------------------------------------------------------

def build_cov2d(v0: jax.Array, l0: jax.Array, l1: jax.Array) -> jax.Array:
    """2D covariance from an eigenvector + eigenvalues — Splat2D (Splat.h:562-582).

    The reference stores sqrt of the eigenvalues into S, i.e.
    Sigma = R diag(l0, l1) R^T with R = [v0 | perp(v0)] (columns).
    v0: (..., 2), l0/l1: (...,). Returns (..., 2, 2).
    """
    v0 = v0 / jnp.maximum(jnp.linalg.norm(v0, axis=-1, keepdims=True), 1e-12)
    v1 = jnp.stack([v0[..., 1], -v0[..., 0]], axis=-1)  # Splat.h:568
    r = jnp.stack([v0, v1], axis=-1)  # columns
    s2 = jnp.stack([l0, l1], axis=-1)
    return jnp.einsum("...ik,...k,...jk->...ij", r, s2, r)


def build_cov3d(quat: jax.Array, scale: jax.Array) -> jax.Array:
    """3D covariance Sigma = R S S R^T — Splat3D ctor (Splat.h:340-344).

    quat: (..., 4) wxyz (normalized internally), scale: (..., 3) std devs.
    """
    r = quat_to_mat3(quat_normalize(quat))
    return jnp.einsum("...ik,...k,...jk->...ij", r, scale * scale, r)


def isoclinic_left(q: jax.Array) -> jax.Array:
    """Left-isoclinic 4x4 rotation of a unit quaternion — Splat4D ctor A
    (Splat.h:103-109), de-transposed from the GLM column-major literal."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([a, b, c, d], axis=-1),
        jnp.stack([-b, a, d, -c], axis=-1),
        jnp.stack([-c, -d, a, b], axis=-1),
        jnp.stack([-d, c, -b, a], axis=-1),
    ], axis=-2)


def isoclinic_right(q: jax.Array) -> jax.Array:
    """Right-isoclinic 4x4 rotation — Splat4D ctor A (Splat.h:111-117)."""
    p, q_, r, s = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([p, q_, r, s], axis=-1),
        jnp.stack([-q_, p, -s, r], axis=-1),
        jnp.stack([-r, s, p, -q_], axis=-1),
        jnp.stack([-s, -r, q_, p], axis=-1),
    ], axis=-2)


def build_cov4d_isoclinic(rot0: jax.Array, rot1: jax.Array, scale4: jax.Array) -> jax.Array:
    """4D covariance from two unit quaternions (SO(4) = left x right isoclinic)
    and four scales — Splat4D constructor A (Splat.h:91-130).

    Sigma4 = (Ml Mr) S S^T (Ml Mr)^T.
    """
    ml = isoclinic_left(quat_normalize(rot0))
    mr = isoclinic_right(quat_normalize(rot1))
    rot = ml @ mr
    return jnp.einsum("...ik,...k,...jk->...ij", rot, scale4 * scale4, rot)


def motion_sigma_t(lifetime: jax.Array, fade: jax.Array) -> jax.Array:
    """Temporal variance sigma_t = lifetime^2 / (-2 ln fade) — Splat.h:139.

    The reference special-cases fade == 0.5 with a precomputed constant; the
    formula is identical, so we just evaluate it (and it stays differentiable
    in `fade`). fade must lie in (0, 1).
    """
    return (lifetime * lifetime) / (-2.0 * jnp.log(fade))


def build_cov4d_motion(quat: jax.Array, scale3: jax.Array, lifetime: jax.Array,
                       fade: jax.Array, velocity: jax.Array) -> jax.Array:
    """4D covariance from the motion parameterization — Splat4D constructor B
    (Splat.h:132-159):

        sigma_t = lifetime^2 / (-2 ln fade)
        tvec    = velocity * sigma_t
        Sigma3  = R S S R^T
        Sigma4  = [[Sigma3 + tvec tvec^T / sigma_t, tvec],
                   [tvec^T,                         sigma_t]]

    This guarantees the conditional spatial covariance at any t equals Sigma3
    and the conditional mean moves linearly with `velocity`.
    """
    st = motion_sigma_t(lifetime, fade)
    tvec = velocity * st[..., None]
    sig3 = build_cov3d(quat, scale3)
    upper = sig3 + tvec[..., :, None] * tvec[..., None, :] / st[..., None, None]
    top = jnp.concatenate([upper, tvec[..., :, None]], axis=-1)
    bottom = jnp.concatenate([tvec, st[..., None]], axis=-1)[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# 4D -> 3D conditional slice + temporal opacity
# ---------------------------------------------------------------------------

def slice_cov4d(pos4: jax.Array, cov4: jax.Array, t: jax.Array):
    """Condition a 4D Gaussian on time t — the flagship-kernel math
    (Splat4DVertexShaderInstanced.GLSL:84-95, Splat4D::Draw Splat.h:163-184):

        mu(t)      = mu_xyz + Sigma_{1:3,4} / Sigma_44 * (t - mu_t)
        Sigma3 | t = Sigma_{1:3,1:3} - Sigma_{1:3,4} Sigma_{4,1:3} / Sigma_44

    pos4: (..., 4) = (x, y, z, mu_t); cov4: (..., 4, 4); t scalar or (...,).
    Returns (mean3, cov3) with shapes (..., 3) and (..., 3, 3).
    """
    t = jnp.asarray(t, pos4.dtype)
    sig_t = cov4[..., 3, 3]
    sig34 = cov4[..., :3, 3]  # symmetric: == cov4[..., 3, :3]
    inv_st = 1.0 / sig_t
    mean3 = pos4[..., :3] + sig34 * (inv_st * (t - pos4[..., 3]))[..., None]
    cov3 = cov4[..., :3, :3] - sig34[..., :, None] * (sig34 * inv_st[..., None])[..., None, :]
    return mean3, cov3


def temporal_opacity(pos4: jax.Array, cov4: jax.Array, t: jax.Array,
                     min_opacity=0.0) -> jax.Array:
    """p(t) = max(exp(-1/2 (t - mu_t)^2 / Sigma_44), min_opacity)
    — Splat4DVertexShaderInstanced.GLSL:48-51,83."""
    t = jnp.asarray(t, pos4.dtype)
    dt = t - pos4[..., 3]
    p = jnp.exp(-0.5 * dt * dt / cov4[..., 3, 3])
    return jnp.maximum(p, jnp.asarray(min_opacity, pos4.dtype))


def mean_in_time_sortkey(pos4: jax.Array, cov4: jax.Array, t: jax.Array) -> jax.Array:
    """The *sorting* mean used by every 4D scene's per-frame key computation,
    SplatData::GetMeanInTime (Scenes.h:28-36):

        mu_sort(t) = mu_xyz + Sigma_{4,1:3} * (t - mu_t)

    NOTE this intentionally reproduces a reference quirk: the scene struct
    advances the mean by the raw covariance row Sigma_{4,1:3} = velocity *
    sigma_t, NOT by the true conditional velocity Sigma_{4,1:3} / Sigma_44
    that the shader uses for rendering (GLSL :86). Depth order is therefore
    computed at a slightly different position than the rendered splat — we
    replicate it so sort order (and thus blending) matches the reference
    frame-for-frame.
    """
    t = jnp.asarray(t, pos4.dtype)
    return pos4[..., :3] + cov4[..., 3, :3] * (t - pos4[..., 3])[..., None]


# ---------------------------------------------------------------------------
# splat batch pytrees (structure-of-arrays)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Splats2D:
    """N two-dimensional Gaussians — the Gaussians2D workload (Scenes.h:1443).

    position: (N, 2) screen/world xy; color: (N, 4) rgba; cov: (N, 2, 2).
    """
    position: jax.Array
    color: jax.Array
    cov: jax.Array

    @property
    def count(self) -> int:
        return self.position.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Splats3D:
    """N static 3D Gaussians: position (N,3), color (N,4) rgba, cov (N,3,3)."""
    position: jax.Array
    color: jax.Array
    cov: jax.Array

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def from_params(position, quat, scale, color) -> "Splats3D":
        return Splats3D(position=jnp.asarray(position),
                        color=jnp.asarray(color),
                        cov=build_cov3d(jnp.asarray(quat), jnp.asarray(scale)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Splats4D:
    """N four-dimensional (space-time) Gaussians — the SplatData SSBO struct
    (Scenes.h:22-37): position (N,4) = (xyz, mu_t), color (N,4) rgba,
    cov (N,4,4)."""
    position: jax.Array
    color: jax.Array
    cov: jax.Array

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def from_motion(position4, quat, scale3, lifetime, fade, velocity, color) -> "Splats4D":
        """Batch version of Splat4D constructor B (Splat.h:132-159), the
        parameterization every demo scene uses."""
        return Splats4D(
            position=jnp.asarray(position4),
            color=jnp.asarray(color),
            cov=build_cov4d_motion(jnp.asarray(quat), jnp.asarray(scale3),
                                   jnp.asarray(lifetime), jnp.asarray(fade),
                                   jnp.asarray(velocity)),
        )

    @staticmethod
    def from_isoclinic(position4, rot0, rot1, scale4, color) -> "Splats4D":
        """Batch version of Splat4D constructor A (Splat.h:91-130)."""
        return Splats4D(
            position=jnp.asarray(position4),
            color=jnp.asarray(color),
            cov=build_cov4d_isoclinic(jnp.asarray(rot0), jnp.asarray(rot1),
                                      jnp.asarray(scale4)),
        )

    def at_time(self, t: jax.Array, min_opacity=0.0):
        """Slice to (Splats3D, temporal_opacity(N,)) at time t."""
        mean3, cov3 = slice_cov4d(self.position, self.cov, t)
        top = temporal_opacity(self.position, self.cov, t, min_opacity)
        return Splats3D(position=mean3, color=self.color, cov=cov3), top


def concatenate_splats4d(parts) -> Splats4D:
    return Splats4D(position=jnp.concatenate([p.position for p in parts]),
                    color=jnp.concatenate([p.color for p in parts]),
                    cov=jnp.concatenate([p.cov for p in parts]))
