"""Depth-ordering helpers.

The reference sorts per frame with a GPU radix sort fed by a host loop
(Scenes.h:312-328 + GPU_RADIX_SORT/radix_sort.hpp). Here ordering is a pure
on-device computation: `jax.lax.sort` over the same keys, which XLA hands
to a CUB radix sort on the GPU (see ARCHITECTURE.md "sorting").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def painter_order(depth_key: jax.Array) -> jax.Array:
    """Ascending stable order over 1/distance keys — exactly the order the
    reference draws in (back-to-front; ties keep splat-index order, matching
    the stable radix sort)."""
    return jnp.argsort(depth_key, stable=True)


def front_to_back_order(depth_key: jax.Array) -> jax.Array:
    return painter_order(depth_key)[::-1]


def inverse_permutation(order: jax.Array) -> jax.Array:
    """rank[order[j]] = j."""
    n = order.shape[0]
    return jnp.zeros((n,), order.dtype).at[order].set(
        jnp.arange(n, dtype=order.dtype))


def front_to_back_rank(depth_key: jax.Array) -> jax.Array:
    """Rank of each splat in front-to-back order (0 = nearest drawn last)."""
    return inverse_permutation(front_to_back_order(depth_key).astype(jnp.int32))
