"""Adaptive density control: gradient-driven clone/split + opacity pruning.

Capability extension beyond the reference (it has no trainer at all —
SURVEY.md section 4/5): the 3D-Gaussian-splatting-style densification loop
adapted to the 4D motion parameterization and to static shapes. Everything
is static-shape: the splat count never changes inside jit. Instead, the
parameter pytree has a fixed capacity; pruning *frees* slots (alpha -> 0) and
densification *fills* freed slots with clones/splits of the
highest-gradient splats. Capacity growth is an (unjitted) re-pad between
training phases (`pad_params`).

Mechanism (mirrors Kerbl et al. 3DGS adaptive control, re-derived for the
packed pytree):
  * accumulate the norm of dL/d(spatial position) per splat across steps;
  * splats with average gradient above `grad_thresh` are reconstruction
    candidates: *split* if their largest scale exceeds `split_scale`
    (the geometry is too coarse), else *clone* (coverage is too sparse);
  * splats with opacity below `prune_alpha` are pruned;
  * the k-th best candidate fills the k-th freed slot — a pure
    argsort/gather/scatter program with no dynamic shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from fourdgs.splats.packed import rot_from_quat


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DensifyState:
    """Per-splat gradient statistics accumulated between densify events."""
    grad_accum: jax.Array   # (N,) summed ||dL/d position||
    steps: jax.Array        # () number of accumulated steps


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_thresh: float = 2e-6   # avg positional-grad norm triggering densify
    split_scale: float = 2.0    # max scale above which candidates split
    split_factor: float = 1.6   # scale shrink on split (3DGS uses 1.6)
    prune_alpha: float = 5e-3   # opacity below which a splat is pruned
    # Optimizer-state policy at densify events:
    #   "slots" — zero Adam moments ONLY at changed slots (pruned /
    #             refilled / split parents); untouched splats keep their
    #             momentum history and the global step count survives.
    #   "all"   — full opt.init: every moment AND the step count reset,
    #             which restarts Adam's bias correction (a temporary
    #             whole-model learning-rate kick). MEASURED tradeoff on
    #             the cluster-recovery fit (tests/test_train.py): the
    #             kick lets the configuration re-optimize around new
    #             children (final loss 3.3e-4 vs 4.1e-4 with "slots",
    #             which barely beats no-densify there); on large scenes
    #             the kick perturbs millions of converged splats for a
    #             handful of new ones. Default "slots" for stability;
    #             use "all" for small aggressive fits.
    opt_reset: str = "slots"    # "slots" | "all"


def init_state(n: int, dtype=jnp.float32) -> DensifyState:
    return DensifyState(grad_accum=jnp.zeros((n,), dtype),
                        steps=jnp.zeros((), jnp.int32))


def accumulate(state: DensifyState, grads: Dict[str, jax.Array]) -> DensifyState:
    """Fold one training step's parameter gradients into the statistics.
    `grads` is the same pytree as the params (trainer layout: position4
    (N, 4), ...). Uses the spatial-position gradient norm as the
    reconstruction-pressure signal."""
    g = grads["position4"][:, :3]
    return DensifyState(
        grad_accum=state.grad_accum + jnp.sqrt(jnp.sum(g * g, axis=-1)),
        steps=state.steps + 1)


def _sample_in_gaussian(key, quat, scale3):
    """One sample from N(0, R diag(s^2) R^T) per splat — new child positions
    for splits land inside the parent's footprint."""
    n = quat.shape[0]
    eps = jax.random.normal(key, (n, 3), scale3.dtype) * scale3
    qw, qx, qy, qz = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    r = rot_from_quat(qw, qx, qy, qz)
    x = r[0] * eps[:, 0] + r[1] * eps[:, 1] + r[2] * eps[:, 2]
    y = r[3] * eps[:, 0] + r[4] * eps[:, 1] + r[5] * eps[:, 2]
    z = r[6] * eps[:, 0] + r[7] * eps[:, 1] + r[8] * eps[:, 2]
    return jnp.stack([x, y, z], axis=-1)


def densify_step(params: Dict[str, jax.Array], state: DensifyState,
                 key: jax.Array, cfg: DensifyConfig = DensifyConfig()
                 ) -> Tuple[Dict[str, jax.Array], DensifyState, Dict[str, jax.Array]]:
    """One densify/prune event. Returns (new_params, reset_state, info).

    Static-shape: the pytree keeps its capacity. Pruned splats either get
    overwritten by a new clone/split child or have their opacity zeroed.
    info carries diagnostic counts (n_pruned, n_cloned, n_split).
    """
    n = params["position4"].shape[0]
    dtype = params["position4"].dtype
    avg_grad = state.grad_accum / jnp.maximum(state.steps, 1).astype(dtype)

    alpha = params["color"][:, 3]
    alive = alpha > cfg.prune_alpha
    prune = ~alive

    max_scale = jnp.max(jnp.abs(params["scale3"]), axis=-1)
    candidate = alive & (avg_grad > cfg.grad_thresh)
    do_split = candidate & (max_scale > cfg.split_scale)

    # Rank freed slots (pruned first, stable) and candidates (best first).
    slot_order = jnp.argsort(jnp.where(prune, 0, 1), stable=True)
    cand_key = jnp.where(candidate, -avg_grad, jnp.inf)
    cand_order = jnp.argsort(cand_key, stable=True)

    slot = slot_order            # k-th freed slot
    src = cand_order             # k-th best candidate
    pair_valid = prune[slot] & candidate[src]

    # Child parameters gathered from the sources.
    child = {f: jnp.take(a, src, axis=0) for f, a in params.items()}
    split_src = do_split[src]
    shrink = jnp.where(split_src, 1.0 / cfg.split_factor, 1.0)[:, None]
    child_scale = child["scale3"] * shrink
    offset = _sample_in_gaussian(key, child["quat"], child["scale3"])
    child_pos3 = child["position4"][:, :3] + jnp.where(
        split_src[:, None], offset, jnp.zeros_like(offset))
    child["position4"] = jnp.concatenate(
        [child_pos3, child["position4"][:, 3:]], axis=-1)
    child["scale3"] = child_scale

    # Start from params with pruned splats silenced (alpha 0), then
    # (a) shrink split parents in place, (b) scatter children into slots.
    out = dict(params)
    out["color"] = params["color"].at[:, 3].multiply(alive.astype(dtype))
    parent_shrink = jnp.where(do_split, 1.0 / cfg.split_factor, 1.0)
    out["scale3"] = out["scale3"] * parent_shrink[:, None]

    for f in out:
        cur = out[f]
        new = child[f]
        mask = pair_valid.reshape((n,) + (1,) * (cur.ndim - 1))
        updated = jnp.where(mask, new, jnp.take(cur, slot, axis=0))
        out[f] = cur.at[slot].set(updated)

    # Slots whose contents changed identity this event: pruned slots
    # (silenced or refilled with a child) and split parents (scale jumps by
    # split_factor). Everything else keeps its parameters bit-identically —
    # the trainer resets Adam moments ONLY at these slots (optimizer
    # momentum on an untouched splat is still valid history).
    changed = prune | do_split
    changed = changed.at[slot].set(changed[slot] | pair_valid)

    info = dict(n_pruned=jnp.sum(prune), n_placed=jnp.sum(pair_valid),
                n_split=jnp.sum(pair_valid & split_src),
                n_cloned=jnp.sum(pair_valid & ~split_src),
                changed=changed)
    return out, init_state(n, dtype), info


def reset_opt_slots(opt_state, changed: jax.Array, n: int):
    """Zero Adam first/second moments at `changed` slots only, preserving
    untouched slots' momentum history (and the global step count, whose
    bias correction is ~1 at any realistic step — zeroed moments behave as
    a fresh start). Works on any optax state pytree: every leaf whose
    leading axis is the splat capacity is masked."""
    def mask_leaf(leaf):
        if hasattr(leaf, "shape") and leaf.ndim >= 1 and leaf.shape[0] == n:
            keep = (~changed).reshape((n,) + (1,) * (leaf.ndim - 1))
            return leaf * keep.astype(leaf.dtype)
        return leaf
    return jax.tree_util.tree_map(mask_leaf, opt_state)


def pad_params(params: Dict[str, jax.Array], capacity: int
               ) -> Dict[str, jax.Array]:
    """Grow the pytree to `capacity` slots; new slots are dead (alpha 0,
    benign geometry). Run between jitted phases — this changes shapes."""
    n = params["position4"].shape[0]
    extra = capacity - n
    if extra <= 0:
        return params
    out = {}
    for f, a in params.items():
        pad = jnp.zeros((extra,) + a.shape[1:], a.dtype)
        if f == "scale3":
            pad = pad + 1e-3
        elif f == "lifetime":
            pad = pad + 1.0
        elif f == "fade":
            pad = pad + 0.5
        elif f == "quat":
            pad = pad.at[:, 0].set(1.0)
        out[f] = jnp.concatenate([a, pad], axis=0)
    return out


def alive_count(params: Dict[str, jax.Array],
                prune_alpha: float = 5e-3) -> jax.Array:
    return jnp.sum(params["color"][:, 3] > prune_alpha)
