"""Losses for differentiable splat rendering.

The reference has no training at all (SURVEY.md section 0: forward-only
viewer); this subsystem is the capability this build adds. Photometric L2
plus a lightweight SSIM (the standard 3DGS recipe is L1 + 0.2*(1-SSIM);
we expose the pieces and a combined helper).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def l2(img: jax.Array, target: jax.Array) -> jax.Array:
    return jnp.mean((img[..., :3] - target[..., :3]) ** 2)


def l1(img: jax.Array, target: jax.Array) -> jax.Array:
    return jnp.mean(jnp.abs(img[..., :3] - target[..., :3]))


def _avg_pool(x: jax.Array, k: int) -> jax.Array:
    """k x k mean pooling with stride 1, channels last (H, W, C)."""
    w = jnp.ones((k, k, 1, 1), x.dtype) / (k * k)
    x4 = x[None]  # NHWC
    out = jax.lax.conv_general_dilated(
        x4, jnp.tile(w, (1, 1, 1, 1)), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=1,
    ) if x.shape[-1] == 1 else None
    if out is None:
        outs = []
        for c in range(x.shape[-1]):
            outs.append(jax.lax.conv_general_dilated(
                x4[..., c:c + 1], w, (1, 1), "VALID",
                dimension_numbers=("NHWC", "HWIO", "NHWC")))
        out = jnp.concatenate(outs, axis=-1)
    return out[0]


def ssim(img: jax.Array, target: jax.Array, k: int = 7,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> jax.Array:
    """Mean SSIM over RGB with a k x k uniform window."""
    x = img[..., :3]
    y = target[..., :3]
    mu_x = _avg_pool(x, k)
    mu_y = _avg_pool(y, k)
    xx = _avg_pool(x * x, k) - mu_x * mu_x
    yy = _avg_pool(y * y, k) - mu_y * mu_y
    xy = _avg_pool(x * y, k) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (xx + yy + c2)
    return jnp.mean(num / den)


def photometric(img: jax.Array, target: jax.Array,
                ssim_weight: float = 0.2) -> jax.Array:
    """L1 + w * (1 - SSIM): the standard splat-fitting objective."""
    loss = l1(img, target)
    if ssim_weight > 0:
        loss = (1.0 - ssim_weight) * loss + ssim_weight * (1.0 - ssim(img, target))
    return loss
