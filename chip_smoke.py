"""Smoke test of fourdgs on NVIDIA GPUs: the quickest proof that the system
starts on the card and that its kernels compile and agree with their plain
references.

    python chip_smoke.py           one GPU, every phase below
    python chip_smoke.py --four    four GPUs: only the sharded training step
                                   (three exchanges) against one card

Phases (one process, one card):
  1. the card: nvidia-smi name and power limit, JAX device kind and count;
  2. each kernel, forward and backward, compiled (its lowered HLO holds
     the Triton custom call), against its plain reference at real widths:
     the slab compositor at the 10M frame's head shapes, the tail on the
     real 1M-splat stream at 1920x1088;
  3. the converged 10M-splat frame at 1920x1088 through
     render_params4d_packed + auto_render_config: finite, nothing
     overflowed, dropped or truncated; memory analysis and frame times;
  4. a few Adam steps of train.trainer.fit at 1M splats, 1920x1088, with
     the converged configuration: finite losses, updated parameters;
  5. validate_kernels.py's checks and thresholds.

Any failure exits nonzero. The last line printed is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# Workload sizes: (tiles, records per tile, pixels per tile) of the
# compositor check; (splats, width, height) of the others.
SIZES = dict(composite=(1020, 256, 2048), tail=(1_000_000, 1920, 1088),
             frame=(10_000_000, 1920, 1088), train=(1_000_000, 1920, 1088))


def _log(msg: str) -> None:
    print(msg, flush=True)


def _triton_calls(fn, *args) -> int:
    """Triton custom calls in fn's lowered HLO: proof that the kernels are
    compiled for the card, not interpreted."""
    import jax
    return jax.jit(fn).lower(*args).as_text().count("xla.gpu.triton")


def _timed(fn, *args, reps: int = 5):
    import jax
    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, times


def phase_kernels(card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import validate_kernels as VK
    from fourdgs.ops import composite_pallas as C
    from fourdgs.ops import interpret_mode
    from fourdgs.ops import tail_pallas as TP

    assert not interpret_mode(), "kernels would run in the interpreter"
    # Slab compositor at the 10M frame's head shapes: 1020 tiles of
    # 16x128 pixels, 256 records per tile.
    t_tiles, m, p = SIZES["composite"]
    fx = VK.build_fixture(p, seed=3, t_tiles=t_tiles, m=m)
    args = [jnp.asarray(fx[k]) for k in ("rec", "counts", "kx", "ky",
                                         "carry")]
    g = jnp.asarray(fx["g"])

    def fwd(impl):
        return lambda r, n, kx, ky, c: C.composite_records(r, n, kx, ky, c,
                                                           impl=impl)

    def vjp(impl):
        def pull(r, n, kx, ky, c):
            _, f = jax.vjp(lambda r_, c_: C.composite_records(
                r_, n, kx, ky, c_, impl=impl), r, c)
            return f(g)
        return pull

    n_calls = _triton_calls(vjp("triton"), *args)
    assert n_calls >= 2, f"composite: {n_calls} Triton calls in fwd+bwd"
    res = {}
    for name, make in (("fwd", fwd), ("bwd", vjp)):
        outs = {}
        for impl in ("triton", "xla"):
            outs[impl], times = _timed(jax.jit(make(impl)), *args)
            res[f"{name}_{impl}_ms"] = [round(t * 1e3, 3) for t in times]
        if name == "fwd":
            err = float(jnp.max(jnp.abs(outs["triton"] - outs["xla"])))
            res["fwd_max_abs_diff"] = err
            assert err < 1e-4, f"composite fwd differs by {err}"
        else:
            # Live records only: the kernel never reads those past counts.
            live = np.arange(m)[None, None, :] < fx["counts"][:, None, None]
            d_k, d_x = (np.asarray(outs[i][0]) * live
                        for i in ("triton", "xla"))
            rel = float(np.max(np.abs(d_k - d_x)) / max(
                np.max(np.abs(d_x)), 1e-3))
            res["bwd_rel_diff"] = rel
            assert rel < 1e-4, f"composite d_records differs by {rel}"
    _log(f"kernels: composite {t_tiles}x{m} records, {p} px tiles, "
         f"compiled ({n_calls} Triton calls) [{card}]: {json.dumps(res)}")

    # Tail on the real 1M-splat stream at 1920x1088.
    n, w, h = SIZES["tail"]
    arrays, static = VK.tail_operands(n, w, h)
    run = {impl: jax.jit(lambda a, impl=impl: TP.tail_accumulate(
        **a, **static, impl=impl)) for impl in ("triton", "xla")}
    pulls, d_acc = VK.tail_vjp_fns(arrays, static)
    n_calls = _triton_calls(run["triton"], arrays)
    n_bwd = _triton_calls(pulls["triton"], arrays["fields"], d_acc)
    assert n_calls >= 1 and n_bwd >= 1, (
        f"tail: {n_calls} fwd, {n_bwd} bwd Triton calls")
    tail = VK.check_tail_kernel(arrays, static)
    assert tail["nonzero"] and tail["max_plane_rel_err"] <= 1e-4, tail
    tail_bwd = VK.check_tail_vjp(arrays, static)
    assert tail_bwd["nonzero"] and tail_bwd["max_field_rel_err"] <= 1e-3, (
        tail_bwd)
    for impl in ("triton", "xla"):
        _, times = _timed(run[impl], arrays)
        tail[f"{impl}_ms"] = [round(t * 1e3, 3) for t in times]
        _, times = _timed(pulls[impl], arrays["fields"], d_acc)
        tail_bwd[f"{impl}_ms"] = [round(t * 1e3, 3) for t in times]
    _log(f"kernels: tail fwd {n:,} splats {w}x{h}, compiled ({n_calls} "
         f"Triton calls) [{card}]: {json.dumps(tail)}")
    _log(f"kernels: tail bwd {n:,} splats {w}x{h}, compiled ({n_bwd} "
         f"Triton calls) [{card}]: {json.dumps(tail_bwd)}")


def phase_frame(card: str) -> None:
    import jax
    import jax.numpy as jnp
    from bench import bench_camera, build_cube_scene
    from fourdgs.render.autoconfig import auto_render_config
    from fourdgs.render.pipeline import render_params4d_packed
    from fourdgs.splats.packed import morton_order, pad_packed_params

    n, w, h = SIZES["frame"]
    params = jax.block_until_ready(
        pad_packed_params(morton_order(build_cube_scene(n)), 16384))
    cam = bench_camera(w, h)
    cfg = auto_render_config(n, w, h, converged=True)
    render = jax.jit(lambda p, t: render_params4d_packed(
        p, cam, t, cfg=cfg, return_aux=True))
    t = jnp.asarray(0.0)
    t0 = time.perf_counter()
    compiled = render.lower(params, t).compile()
    _log(f"frame: compiled in {time.perf_counter() - t0:.1f}s; "
         f"memory_analysis: {compiled.memory_analysis()}")
    (img, aux), times = _timed(compiled, params, t)
    assert img.shape == (h, w, 4), img.shape
    assert bool(jnp.all(jnp.isfinite(img))), "non-finite pixels"
    for key in ("overflowed", "compact_dropped", "resid_transmittance"):
        assert float(aux[key]) == 0.0, (key, float(aux[key]))
    _log(f"frame: {n:,} splats {w}x{h} converged, mean rgb "
         f"{float(jnp.mean(img[..., :3]))}, live pairs "
         f"{int(aux['live_pairs'])}, frame ms "
         f"{[round(x * 1e3, 3) for x in times]} [{card}]")


def packed_to_fit_params(p: dict) -> dict:
    """bench.build_cube_scene's packed components -> the trainable pytree
    of train.trainer.fit (parallel.distributed.materialize_splats)."""
    import jax.numpy as jnp
    stack = lambda *ks: jnp.stack([p[k] for k in ks], axis=1)  # noqa: E731
    return dict(position4=stack("px", "py", "pz", "pt"),
                quat=stack("qw", "qx", "qy", "qz"),
                scale3=stack("sx", "sy", "sz"),
                lifetime=p["lifetime"], fade=p["fade"],
                velocity=stack("vx", "vy", "vz"),
                color=stack("cr", "cg", "cb", "ca"))


def phase_train(card: str) -> None:
    import jax
    import jax.numpy as jnp
    from bench import bench_camera, build_cube_scene
    from fourdgs.parallel.distributed import materialize_splats
    from fourdgs.render.autoconfig import auto_render_config
    from fourdgs.render.pipeline import render_splats4d
    from fourdgs.splats.packed import morton_order
    from fourdgs.train.trainer import fit

    (n, w, h), steps = SIZES["train"], 3
    cam = bench_camera(w, h)
    cfg = auto_render_config(n, w, h, converged=True)
    params = packed_to_fit_params(morton_order(build_cube_scene(n, seed=1)))
    target = jax.jit(lambda p: render_splats4d(
        materialize_splats(p), cam, 0.0, cfg=cfg))(
            packed_to_fit_params(morton_order(build_cube_scene(n, seed=2))))
    t0 = time.perf_counter()
    result = fit(params, [(target, 0.0)], cam, steps=steps,
                 learning_rate=0.05, cfg=cfg)
    secs = time.perf_counter() - t0
    losses = result.losses
    assert len(losses) == steps and all(map(jnp.isfinite, losses)), losses
    for k, v in result.params.items():
        assert bool(jnp.all(jnp.isfinite(v))), f"non-finite {k}"
    moved = float(jnp.max(jnp.abs(result.params["color"] - params["color"])))
    assert moved > 0.0, "Adam moved nothing"
    _log(f"train: fit {n:,} splats {w}x{h} converged, {steps} Adam steps "
         f"in {secs:.1f}s incl. compile, losses {losses}, max color update "
         f"{moved} [{card}]")


def phase_validate(refs, card: str) -> None:
    import validate_kernels as VK
    results, ok = VK.run_checks(refs)
    _log(f"validate [{card}]: {json.dumps(results)}")
    assert ok, "validate_kernels thresholds not met"


def phase_four(card: str) -> None:
    """The sharded training step on four cards (allgather, alltoall and
    alltoall-converged exchanges) against the same step on one card."""
    import jax
    from __graft_entry__ import compare_sharded_step
    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs 4 GPUs, JAX sees {len(devs)}"
    for line in compare_sharded_step(devs[:4]):
        _log(f"four: {line} [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded step on four GPUs")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "fourdgs")):
        print("chip_smoke.py needs the fourdgs checkout beside it",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import validate_kernels as VK
    refs = None
    if not args.four:
        # The f64 references come from a CPU-only child, before this
        # process opens the card.
        refs = VK.compute_refs()

    from fourdgs.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    from bench import gpu_name_and_power
    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    if device["platform"] != "gpu":
        print(f"no GPU: JAX platform is {device['platform']!r}",
              file=sys.stderr)
        return 1
    card = gpu_name_and_power()
    _log(card)
    _log(f"device: {device['kind']} x{device['count']}")

    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        if args.four:
            phase_four(card)
        else:
            for name, phase in (("kernels", phase_kernels),
                                ("frame", phase_frame),
                                ("train", phase_train),
                                ("validate", lambda c: phase_validate(refs,
                                                                      c))):
                t1 = time.perf_counter()
                phase(card)
                _log(f"phase {name}: {time.perf_counter() - t1:.1f}s")
    _log(f"all phases: {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
