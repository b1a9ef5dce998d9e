"""Scalar structure-of-arrays splat math for the 10M+ regime.

Why this exists: tiny-matrix einsums over huge batches (e.g. R S S R^T for
10M splats) lower to dot ops over (N, 3, 3) operands with strided layouts.
The scalable representation is one 1-D (N,) array per scalar component:
everything is elementwise, XLA fuses the whole chain, and no (N, k, k)
intermediate ever reaches device memory.

This module mirrors the math of splats/gaussians.py (same reference
citations) in component form and is property-tested against it. Symmetric
matrices are stored as their upper triangles:

    cov3: (c00, c01, c02, c11, c12, c22)
    cov4: cov3 + (c03, c13, c23, c33)
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp


# Field lists for the packed pytrees (kept as plain dicts of (N,) arrays so
# optimizers/shardings treat every component uniformly).
PARAM4D_FIELDS = ("px", "py", "pz", "pt", "qw", "qx", "qy", "qz",
                  "sx", "sy", "sz", "lifetime", "fade", "vx", "vy", "vz",
                  "cr", "cg", "cb", "ca")
COV3_FIELDS = ("c00", "c01", "c02", "c11", "c12", "c22")
COV4_EXTRA = ("c03", "c13", "c23", "c33")


def params4d_from_arrays(position4, quat, scale3, lifetime, fade, velocity,
                         color) -> Dict[str, jax.Array]:
    """Split (N,k) parameter arrays into the packed (N,) component dict."""
    position4 = jnp.asarray(position4)
    quat = jnp.asarray(quat)
    scale3 = jnp.asarray(scale3)
    velocity = jnp.asarray(velocity)
    color = jnp.asarray(color)
    n = position4.shape[0]
    return dict(
        px=position4[:, 0], py=position4[:, 1], pz=position4[:, 2],
        pt=position4[:, 3],
        qw=quat[:, 0], qx=quat[:, 1], qy=quat[:, 2], qz=quat[:, 3],
        sx=scale3[:, 0], sy=scale3[:, 1], sz=scale3[:, 2],
        lifetime=jnp.broadcast_to(jnp.asarray(lifetime), (n,)),
        fade=jnp.broadcast_to(jnp.asarray(fade), (n,)),
        vx=velocity[:, 0], vy=velocity[:, 1], vz=velocity[:, 2],
        cr=color[:, 0], cg=color[:, 1], cb=color[:, 2], ca=color[:, 3],
    )


def rot_from_quat(qw, qx, qy, qz):
    """Component form of glm::toMat3 (Splat.h:141); normalizes internally.
    Returns the 9 rotation components r00..r22."""
    inv = jax.lax.rsqrt(qw * qw + qx * qx + qy * qy + qz * qz + 1e-30)
    w, x, y, z = qw * inv, qx * inv, qy * inv, qz * inv
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def cov3_from_quat_scale(qw, qx, qy, qz, sx, sy, sz):
    """Sigma3 = R diag(s^2) R^T in components (Splat3D ctor, Splat.h:340-344)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = rot_from_quat(qw, qx, qy, qz)
    s0, s1, s2 = sx * sx, sy * sy, sz * sz
    c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return c00, c01, c02, c11, c12, c22


def cov4_motion(params: Dict[str, jax.Array]):
    """Sigma4 of the motion parameterization (Splat4D ctor B,
    Splat.h:132-159) in components. Returns the 10-tuple
    (c00, c01, c02, c11, c12, c22, c03, c13, c23, c33)."""
    st = (params["lifetime"] ** 2) / (-2.0 * jnp.log(params["fade"]))
    tx, ty, tz = params["vx"] * st, params["vy"] * st, params["vz"] * st
    c00, c01, c02, c11, c12, c22 = cov3_from_quat_scale(
        params["qw"], params["qx"], params["qy"], params["qz"],
        params["sx"], params["sy"], params["sz"])
    inv_st = 1.0 / st
    return (c00 + tx * tx * inv_st, c01 + tx * ty * inv_st,
            c02 + tx * tz * inv_st, c11 + ty * ty * inv_st,
            c12 + ty * tz * inv_st, c22 + tz * tz * inv_st,
            tx, ty, tz, st)


def slice4d(params: Dict[str, jax.Array], cov4, t, min_opacity=0.0):
    """Conditional slice + temporal opacity (GLSL :48-51,83-95) in
    components. Returns (mx, my, mz, cov3_6tuple, opacity, sort_mx/my/mz).

    sort_* reproduce the reference's quirky sorting mean
    (SplatData::GetMeanInTime, Scenes.h:28-36): advanced by Sigma_{4,1:3}
    itself rather than the conditional velocity.
    """
    (c00, c01, c02, c11, c12, c22, c03, c13, c23, c33) = cov4
    dt = jnp.asarray(t, c33.dtype) - params["pt"]
    inv_st = 1.0 / c33
    mx = params["px"] + c03 * inv_st * dt
    my = params["py"] + c13 * inv_st * dt
    mz = params["pz"] + c23 * inv_st * dt
    s00 = c00 - c03 * c03 * inv_st
    s01 = c01 - c03 * c13 * inv_st
    s02 = c02 - c03 * c23 * inv_st
    s11 = c11 - c13 * c13 * inv_st
    s12 = c12 - c13 * c23 * inv_st
    s22 = c22 - c23 * c23 * inv_st
    opacity = jnp.maximum(jnp.exp(-0.5 * dt * dt * inv_st),
                          jnp.asarray(min_opacity, c33.dtype))
    sort_mx = params["px"] + c03 * dt
    sort_my = params["py"] + c13 * dt
    sort_mz = params["pz"] + c23 * dt
    return (mx, my, mz, (s00, s01, s02, s11, s12, s22), opacity,
            (sort_mx, sort_my, sort_mz))


def morton_order(params: Dict[str, jax.Array], bits: int = 10):
    """Reorder a packed scalar-SoA parameter dict by the 3D Morton
    (Z-order) code of splat position — a ONE-TIME scene-build step
    (mirroring the reference's one-time init() work, Scenes.h:226-287).

    Spatially adjacent splats become adjacent in memory, which gives the
    streaming banded-OIT tail compositor (ops/tail_pallas.py) screen-tile
    locality for ANY camera: the splats of one kernel program then add
    into a few neighbouring accumulator rows, and each chunk of splats
    takes one depth band that fits it. Rendering is correct for any
    order; this is purely a performance layout. Long-running fits that
    drift positions can re-run it between jitted phases (it changes no
    values, only order).
    """
    px, py, pz = params["px"], params["py"], params["pz"]

    def q(x):
        lo = jnp.min(x)
        span = jnp.maximum(jnp.max(x) - lo, 1e-12)
        return jnp.clip((x - lo) / span * (1 << bits), 0,
                        (1 << bits) - 1).astype(jnp.uint32)

    def spread(v):
        # Interleave: insert two zero bits between each of the 10 bits.
        v = (v | (v << 16)) & jnp.uint32(0x030000FF)
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    code = (spread(q(px)) | (spread(q(py)) << 1)
            | (spread(q(pz)) << 2)).astype(jnp.int32)
    order = jnp.argsort(code)
    return {k: v[order] for k, v in params.items()}


def pad_packed_params(params: Dict[str, jax.Array], multiple: int = 2048):
    """Pad a packed scalar-SoA parameter dict with DEAD splats to a length
    multiple — a ONE-TIME scene-build step.

    Why: every in-frame `jnp.pad` of a (N,) field to the tail kernel's
    chunk multiple is a full-array copy (XLA pad writes a fresh array),
    and a frame pads many derived fields. Padding the SCENE once makes
    every derived field already chunk-aligned, so those pads become
    no-ops. Pad splats have opacity 0 (ca=0: a_eff == 0 -> alpha == 0
    everywhere) and epsilon scales; they may emit a handful of zero-alpha
    pairs, which composite to exactly nothing.
    """
    n = params["px"].shape[0]
    npad = -(-n // multiple) * multiple
    if npad == n:
        return params
    pad = npad - n
    fill = dict(qw=1.0, sx=1e-6, sy=1e-6, sz=1e-6, lifetime=1e-6,
                fade=0.5, ca=0.0)

    def ext(k, v):
        return jnp.concatenate(
            [v, jnp.full((pad,), fill.get(k, 0.0), v.dtype)])
    return {k: ext(k, v) for k, v in params.items()}
