"""Single-host training loop for fitting 4D splat scenes to images.

Complements fourdgs/parallel/distributed.py (the multi-chip step): this is
the simple path — one device (or jit-auto-sharded), camera/time batches via
scan. The reference has no checkpoint/resume at all (SURVEY.md section 5 —
scene reset is unload()+init()); here parameter pytrees round-trip through
a plain npz file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from fourdgs.core.camera import Camera
from fourdgs.parallel.distributed import materialize_splats
from fourdgs.render.pipeline import RenderConfig, render_splats4d
from fourdgs.train import loss as L


@dataclasses.dataclass
class FitResult:
    params: Dict[str, jax.Array]
    losses: List[float]


class MetricsLogger:
    """Structured training metrics: one JSON object per event appended to a
    JSONL file (and optionally echoed). The reference's only metric surface
    is an ImGui FPS readout (DebugMenus.h:114); training metrics are a new
    capability, logged in a grep/pandas-friendly shape."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._t0 = __import__("time").time()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, event: str, **fields) -> None:
        import json
        import time
        rec = {"event": event, "wall_s": round(time.time() - self._t0, 3),
               **{k: (float(v) if hasattr(v, "dtype") or
                      isinstance(v, (int, float)) else v)
                  for k, v in fields.items()}}
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)

    def close(self) -> None:
        if self._f:
            self._f.close()


def make_loss_fn(camera: Camera, cfg: RenderConfig, min_opacity=0.0,
                 ssim_weight: float = 0.0) -> Callable:
    def loss_fn(params, target, t):
        splats = materialize_splats(params)
        img = render_splats4d(splats, camera, t, min_opacity, cfg=cfg)
        if ssim_weight > 0:
            return L.photometric(img, target, ssim_weight)
        return L.l2(img, target)
    return loss_fn


def fit(params: Dict[str, jax.Array],
        frames: Iterable[Tuple[jax.Array, float]],
        camera: Camera,
        steps: int = 200,
        learning_rate: float = 5e-3,
        cfg: RenderConfig = RenderConfig(),
        ssim_weight: float = 0.0,
        log_every: int = 0,
        densify_cfg: "Optional[DensifyConfig]" = None,
        densify_every: int = 50,
        densify_until: float = 0.7,
        seed: int = 0,
        metrics: Optional[MetricsLogger] = None) -> FitResult:
    """Fit splat parameters to (target_image, t) frames by cycling through
    them with Adam. Small-scale convenience API; for multi-chip use
    parallel.distributed.make_sharded_train_step.

    Adaptive density control (train/densify.py) is wired in when
    `densify_cfg` is given: positional-gradient norms accumulate every
    step, and every `densify_every` steps (until `densify_until * steps`)
    low-opacity splats are pruned and their slots refilled with clones /
    splits of the highest-pressure splats. Capacity is static (pad the
    pytree with densify.pad_params beforehand to leave headroom). At each
    densify event the optimizer state follows DensifyConfig.opt_reset:
    "slots" (default) zeroes Adam moments only at changed slots so
    untouched splats keep their momentum; "all" re-initializes everything
    including the step count (a bias-correction learning-rate kick — see
    the measured tradeoff in DensifyConfig)."""
    from fourdgs.train import densify as D

    frames = list(frames)
    loss_fn = make_loss_fn(camera, cfg, ssim_weight=ssim_weight)
    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, target, t):
        loss, grads = jax.value_and_grad(loss_fn)(params, target, t)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    dstate = None
    densify_jit = None
    accumulate_jit = None
    if densify_cfg is not None:
        n = params["position4"].shape[0]
        dstate = D.init_state(n, params["position4"].dtype)
        densify_jit = jax.jit(
            lambda p, s, k: D.densify_step(p, s, k, densify_cfg))
        accumulate_jit = jax.jit(D.accumulate)
    key = jax.random.PRNGKey(seed)

    losses = []
    for i in range(steps):
        target, t = frames[i % len(frames)]
        params, opt_state, loss, grads = step(params, opt_state, target,
                                              jnp.asarray(t))
        losses.append(float(loss))
        if metrics is not None and (log_every == 0 or i % max(log_every, 1) == 0):
            metrics.log("train_step", step=i, loss=losses[-1], t=float(t))
        if densify_cfg is not None:
            dstate = accumulate_jit(dstate, grads)
            if (i + 1) % densify_every == 0 and i + 1 < densify_until * steps:
                key, sub = jax.random.split(key)
                params, dstate, info = densify_jit(params, dstate, sub)
                if densify_cfg.opt_reset == "all":
                    opt_state = opt.init(params)
                else:
                    opt_state = D.reset_opt_slots(
                        opt_state, info["changed"], n)
                if metrics is not None:
                    metrics.log("densify", step=i,
                                n_pruned=int(info["n_pruned"]),
                                n_placed=int(info["n_placed"]),
                                n_split=int(info["n_split"]))
                if log_every:
                    print(f"step {i}: densify pruned="
                          f"{int(info['n_pruned'])} placed="
                          f"{int(info['n_placed'])} split="
                          f"{int(info['n_split'])}")
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return FitResult(params=params, losses=losses)


# ---------------------------------------------------------------------------
# checkpointing (new capability; reference has none — SURVEY.md section 5)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, params: Dict[str, jax.Array],
                    step: Optional[int] = None) -> None:
    """Save a flat parameter dict to `path` (".npz" appended if missing)."""
    np.savez(path if path.endswith(".npz") else path + ".npz",
             **{k: np.asarray(v) for k, v in params.items()},
             __step__=np.asarray(-1 if step is None else step))


def load_checkpoint(path: str) -> Dict[str, jax.Array]:
    """Load a parameter dict written by save_checkpoint."""
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as data:
        return {k: jnp.asarray(v) for k, v in data.items()
                if not k.startswith("__")}
