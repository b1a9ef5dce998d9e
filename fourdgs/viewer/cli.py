"""Headless scene viewer: render demo scenes to PNG frames.

Replaces the reference's GLFW/ImGui interactive app (Application.cpp +
DebugMenus.h) with a CLI: pick a scene, a time (or a time sweep), camera
overrides, and get frames on disk.

    python -m fourdgs.viewer.cli --scene linear --t 12 --out frame.png
    python -m fourdgs.viewer.cli --scene rotation --sweep 0:90:16 --out anim
    python -m fourdgs.viewer.cli --list
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(prog="fourdgs-view", description=__doc__)
    p.add_argument("--scene", default="linear",
                   help="scene name (see --list)")
    p.add_argument("--list", action="store_true", help="list scenes and exit")
    p.add_argument("--t", type=float, default=0.0, help="scene time")
    p.add_argument("--sweep", default=None,
                   help="render a sweep start:stop:frames instead of one t")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--out", default="frame.png",
                   help="output PNG (or directory prefix for sweeps)")
    p.add_argument("--backend", default="xla", choices=["xla", "pallas", "dense"])
    p.add_argument("--converged", action="store_true",
                   help="composite EVERY pair (exact head + streaming "
                        "banded-OIT tail; pallas backend, Morton-ordered "
                        "scene) — matches the reference's no-depth-cap "
                        "blend")
    p.add_argument("--min-opacity", type=float, default=0.0)
    p.add_argument("--no-sort", action="store_true",
                   help="draw in splat-index order (reference's sort toggle)")
    p.add_argument("--cam-pos", default=None, help="x,y,z camera override")
    p.add_argument("--cam-dir", default=None, help="x,y,z orientation override")
    p.add_argument("--background", default="0,0,0,1")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--grid", action="store_true",
                   help="overlay the reference's ground grid (Scenes.h:303)")
    p.add_argument("--axis", action="store_true",
                   help="overlay the xyz axis cross (Scenes.h:304)")
    p.add_argument("--blend", default=None, metavar="SRC,DST",
                   help="blend-function explorer (DebugMenus.h:211-274): "
                        "any glBlendFunc factor pair, e.g. "
                        "'src_alpha,one_minus_src_alpha' or 'one,one'; "
                        "forces the dense back-to-front compositor. "
                        "See fourdgs.render.dense.BLEND_FACTORS")
    p.add_argument("--set", action="append", default=[], metavar="FIELD=V[,V..]",
                   help="per-splat parameter override (the single-splat "
                        "editor analog, DebugMenus.h:75-208): e.g. "
                        "--set scale=2,0.5,1 --set color=1,0,0,0.8 "
                        "--set lifetime=5 --set position=0,1,-10,0 "
                        "--set quat=1,0,0.3,0 --set velocity=1,0,0. "
                        "Applies to all splats, or one with --splat-index")
    p.add_argument("--splat-index", type=int, default=None,
                   help="restrict --set overrides to one splat")
    return p


def apply_overrides(splats, sets, index):
    """Apply --set FIELD=values overrides to a splat pytree (any of
    Splats2D/3D/4D or a packed dict). Vector fields broadcast a single
    value; --splat-index restricts to one row."""
    import dataclasses

    import jax.numpy as jnp
    aliases = {"scale": "scale3", "pos": "position", "dir": "velocity",
               "rot": "quat"}
    for spec in sets:
        if "=" not in spec:
            raise SystemExit(f"--set {spec!r}: expected FIELD=V[,V...]")
        field, _, raw = spec.partition("=")
        field = aliases.get(field.strip(), field.strip())
        vals = jnp.asarray([float(v) for v in raw.split(",")])
        is_dc = dataclasses.is_dataclass(splats)
        names = ([f.name for f in dataclasses.fields(splats)] if is_dc
                 else list(splats.keys()))
        # Accept both exact names and common aliases across splat classes.
        cands = [n for n in names if n == field or n.rstrip("34") == field
                 or field.rstrip("34") == n.rstrip("34")]
        if not cands:
            raise SystemExit(f"--set: no field {field!r}; has {names}")
        name = cands[0]
        cur = getattr(splats, name) if is_dc else splats[name]
        if vals.shape[0] == 1 and cur.ndim >= 1:
            newrow = jnp.broadcast_to(vals, cur.shape[1:] or (1,))
        else:
            want = cur.shape[1:] if cur.ndim > 1 else ()
            if want and vals.shape != want:
                raise SystemExit(f"--set {name}: expected {want[0]} values, "
                                 f"got {vals.shape[0]}")
            newrow = vals if want else vals[0]
        if index is None:
            new = jnp.broadcast_to(newrow, cur.shape).astype(cur.dtype)
        else:
            new = cur.at[index].set(jnp.asarray(newrow, cur.dtype))
        splats = (dataclasses.replace(splats, **{name: new}) if is_dc
                  else {**splats, name: new})
    return splats


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from fourdgs.utils.cache import enable_compile_cache
    enable_compile_cache()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from fourdgs.core.camera import Camera
    from fourdgs.io.png import write_png
    from fourdgs.render import dense as dense_mod
    from fourdgs.render import pipeline as pipe_mod
    from fourdgs.render.pipeline import RenderConfig
    from fourdgs.scenes.scenes import SCENES
    from fourdgs.splats.gaussians import Splats2D, Splats3D

    if args.list:
        for name in SCENES:
            print(name)
        return 0

    if args.scene not in SCENES:
        print(f"unknown scene {args.scene!r}; use --list", file=sys.stderr)
        return 2

    # Route --set overrides: generator keyword parameters first (the
    # single-splat editor analog for the showcase scenes), remaining specs
    # as array-level pytree edits.
    import inspect
    gen = SCENES[args.scene]
    sig_params = inspect.signature(gen).parameters
    aliases = {"scale": ("scale", "scale3"), "pos": ("position",),
               "dir": ("velocity",), "rot": ("quat",)}
    gen_kwargs, array_sets = {}, []
    for spec in args.set:
        field = spec.partition("=")[0].strip()
        raw = spec.partition("=")[2]
        cands = aliases.get(field, (field,)) + (field,)
        hit = next((c for c in cands if c in sig_params), None)
        if hit is not None and args.splat_index in (None, 0):
            vals = [float(v) for v in raw.split(",")]
            gen_kwargs[hit] = vals[0] if len(vals) == 1 and hit in (
                "lifetime", "fade") else tuple(vals)
        else:
            array_sets.append(spec)

    splats, st = gen(**gen_kwargs)
    if array_sets:
        splats = apply_overrides(splats, array_sets, args.splat_index)
    campos = tuple(map(float, args.cam_pos.split(","))) if args.cam_pos else st.camera_position
    camdir = tuple(map(float, args.cam_dir.split(","))) if args.cam_dir else st.camera_orientation
    bg = tuple(map(float, args.background.split(",")))
    cam = Camera.create(position=campos, orientation=camdir,
                        width=args.width, height=args.height)

    if args.converged:
        # Derived by the library's auto-configuration (round 5) with the
        # small-scene/viewer-friendly tile shape; every pair composited.
        from fourdgs.render.autoconfig import auto_render_config
        cfg = auto_render_config(400_000, args.width, args.height,
                                 background=bg, tile_h=8,
                                 max_splats_per_tile=256,
                                 max_tiles_per_splat=8,
                                 depth_prune_cap=256, tail_block=(4, 8),
                                 tail_chunk=1024)
    elif args.backend == "pallas":
        cfg = RenderConfig(tile_h=8, tile_w=128, backend="pallas", background=bg)
    else:
        cfg = RenderConfig(background=bg)

    blend = None
    if args.blend:
        parts = [b.strip() for b in args.blend.split(",")]
        if len(parts) != 2:
            print("--blend expects SRC,DST", file=sys.stderr)
            return 2
        blend = tuple(parts)

    def render_blend(t):
        """Blend-function explorer path: dense back-to-front composite
        under the chosen glBlendFunc pair."""
        from fourdgs.core.camera import pixel_centers_ndc
        from fourdgs.splats.gaussians import mean_in_time_sortkey
        from fourdgs.render.project import project_splats
        if isinstance(splats, Splats2D):
            proj, p00e, p11e = dense_mod.project_splats2d(splats, cam)
            proj = jax.tree_util.tree_map(lambda a: a[::-1], proj)
        else:
            if isinstance(splats, Splats3D):
                sliced, top, sm = splats, None, None
            else:
                sliced, top = splats.at_time(t, args.min_opacity)
                sm = mean_in_time_sortkey(splats.position, splats.cov, t)
            import jax.numpy as jnp
            op = (jnp.ones((sliced.count,)) if top is None else top)
            proj = project_splats(sliced.position, sliced.cov, sliced.color,
                                  op, cam, sort_mean3=sm)
            proj = dense_mod.sort_front_to_back(proj)
            pmat = cam.proj_matrix()
            p00e, p11e = pmat[0, 0], pmat[1, 1]
        px, py = pixel_centers_ndc(cam.width, cam.height)
        import jax.numpy as jnp
        return dense_mod.composite_dense_blend(
            proj, px, py, p00e, p11e, jnp.asarray(bg),
            src_factor=blend[0], dst_factor=blend[1],
            premultiplied=isinstance(splats, Splats3D))

    def render_at(t):
        if blend is not None:
            img = render_blend(t)
        elif isinstance(splats, Splats2D):
            img = dense_mod.render_splats2d(splats, cam, background=bg)
        elif isinstance(splats, Splats3D):
            if args.backend == "dense":
                img = dense_mod.render_splats3d(splats, cam, background=bg,
                                                sort=not args.no_sort,
                                                premultiplied=True)
            else:
                img = pipe_mod.render_splats3d(splats, cam, cfg=cfg)
        elif args.backend == "dense":
            img = dense_mod.render_splats4d(splats, cam, t, args.min_opacity,
                                            background=bg, sort=not args.no_sort)
        else:
            img = pipe_mod.render_splats4d(splats, cam, t, args.min_opacity, cfg=cfg)
        if args.grid or args.axis:
            from fourdgs.render import overlay
            if args.grid:
                img = overlay.draw_grid(img, cam)
            if args.axis:
                img = overlay.draw_axis(img, cam)
        return img

    render = jax.jit(render_at)

    if args.sweep:
        start, stop, frames = args.sweep.split(":")
        ts = np.linspace(float(start), float(stop), int(frames))
        os.makedirs(args.out, exist_ok=True)
        for i, t in enumerate(ts):
            t0 = time.time()
            img = np.asarray(render(float(t)))
            path = os.path.join(args.out, f"frame_{i:04d}.png")
            write_png(path, img)
            print(f"{path}  t={t:.2f}  {time.time()-t0:.3f}s")
    else:
        t0 = time.time()
        img = np.asarray(render(args.t))
        write_png(args.out, img)
        print(f"{args.out}  t={args.t:.2f}  {img.shape}  {time.time()-t0:.3f}s "
              f"(mean rgb {img[..., :3].mean():.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
