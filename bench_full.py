"""Extended benchmark suite beyond the headline line of bench.py:

  * frames/s + splats/s across scene sizes (forward), plus 4K at 10M
  * bwd/fwd time ratio (full gradient step vs forward render)
  * multi-device scaling efficiency of the sharded train step, when JAX
    sees more than one GPU

Needs a GPU (exits nonzero without one). Prints the card's name, power
limit and device count, then a JSON object per line (one per measurement),
each naming the device.
"""

from __future__ import annotations

import json
import sys
import time


def timed(fn, *args, reps=3):
    """Best wall time of fn(*args) ended by block_until_ready (after one
    warm-up call)."""
    import jax
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    import jax
    import jax.numpy as jnp
    import optax

    from bench import bench_camera, build_cube_scene, require_gpu
    from fourdgs.core.camera import Camera
    from fourdgs.render.autoconfig import auto_render_config
    from fourdgs.render.pipeline import RenderConfig, render_params4d_packed
    from fourdgs.splats.packed import morton_order, pad_packed_params
    from fourdgs.utils.cache import enable_compile_cache

    enable_compile_cache()
    device = require_gpu()
    sizes = [100_000, 1_000_000, 10_000_000]
    backend = "pallas"
    width, height = 1920, 1088
    camera = bench_camera(width, height)

    def cfg_for(n, w, h):
        # EVERY size/resolution uses the library's auto-configuration with
        # zero overrides — the same derivation as bench.py.
        return auto_render_config(n, w, h)

    # --- forward scaling over scene size (+ the 4K resolution line) ----
    # 4K: tile-row banding + the resolution-scaled pair budget.
    resolutions = [(width, height), (3840, 2160)]
    for n in sizes:
        params = jax.block_until_ready(pad_packed_params(
            morton_order(build_cube_scene(n)), 16384))
        for (w, h) in resolutions:
            if (w, h) != (width, height) and n != sizes[-1]:
                continue   # 4K only at the flagship size
            cam_n = camera if (w, h) == (width, height) else bench_camera(w, h)
            cfg_n = cfg_for(n, w, h)
            render = jax.jit(lambda s: render_params4d_packed(
                s, cam_n, 0.0, cfg=cfg_n, return_aux=True))
            img, aux = render(params)
            fwd = timed(lambda s: render(s)[0], params)
            print(json.dumps({
                "metric": f"forward frame @{n} splats {w}x{h} ({backend})",
                "value": 1.0 / fwd, "unit": "fps",
                "splats_per_s": n / fwd, "device": device,
                "overflow": int(aux["overflowed"]),
                "compact_dropped": int(aux.get("compact_dropped", 0)),
                "resid_transmittance": float(
                    aux["resid_transmittance"])}), flush=True)
        cfg_n = cfg_for(n, width, height)

        # --- bwd/fwd ratio at every size (incl. 10M, roadmap item 3) ----
        def loss(p, cfg_n=cfg_n):
            img = render_params4d_packed(p, camera, 0.0, cfg=cfg_n)
            return jnp.mean(img[..., :3] ** 2)
        try:
            render1 = jax.jit(
                lambda s: render_params4d_packed(s, camera, 0.0, cfg=cfg_n))
            fwd = timed(render1, params)
            grad = jax.jit(jax.grad(loss))
            bwd = timed(grad, params)
            print(json.dumps({
                "metric": f"grad step @{n} splats ({backend})",
                "value": bwd / fwd, "unit": "bwd/fwd ratio",
                "grad_s": bwd, "device": device}), flush=True)
        except Exception as e:  # pragma: no cover — surfaced, not masked
            # Emit the message too so a shape bug / NaN assert is
            # distinguishable from a genuine RESOURCE_EXHAUSTED (ADVICE r1).
            print(json.dumps({
                "metric": f"grad step @{n} splats ({backend})",
                "value": None, "unit": "bwd/fwd ratio",
                "error": f"{type(e).__name__}: {str(e)[:300]}"}), flush=True)
        del params

    # --- multi-device scaling ------------------------------------------
    n_dev = len(jax.devices())
    if n_dev > 1:
        from fourdgs.parallel import distributed as D
        from fourdgs.parallel.mesh import make_mesh

        cam_s = Camera.create(position=(0, 0, 0), width=256, height=256)
        cfg_s = RenderConfig(max_splats_per_tile=512, splat_chunk=64)
        n = 100_000
        ks = jax.random.split(jax.random.PRNGKey(0), 6)
        params = dict(
            position4=jnp.concatenate([
                jax.random.uniform(ks[0], (n, 3), minval=-30, maxval=30),
                jnp.zeros((n, 1))], -1).at[:, 2].add(-80.0),
            quat=jax.random.normal(ks[2], (n, 4)),
            scale3=jnp.full((n, 3), 1.0),
            lifetime=jnp.full((n,), 10.0), fade=jnp.full((n,), 0.5),
            velocity=jnp.zeros((n, 3)),
            color=jax.random.uniform(ks[5], (n, 4), minval=0.2, maxval=1.0))
        target = jnp.zeros((cam_s.height, cam_s.width, 4))
        opt = optax.adam(1e-3)
        for exchange in ("allgather", "alltoall"):
            times = {}
            for nd in [1, n_dev]:
                mesh = make_mesh(jax.devices()[:nd])
                step = jax.jit(D.make_sharded_train_step(
                    cam_s, mesh, opt, cfg_s, exchange=exchange))
                st = opt.init(params)
                run = lambda: step(params, st, target, 0.0)[2]
                times[nd] = timed(run)
            eff = times[1] / (times[n_dev] * n_dev)
            print(json.dumps({
                "metric": f"train-step scaling 1 -> {n_dev} devices, "
                          f"{exchange} exchange",
                "value": eff, "unit": "scaling efficiency",
                "t1_s": times[1], f"t{n_dev}_s": times[n_dev],
                "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
