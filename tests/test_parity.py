"""End-to-end parity: the full production pipeline against the dense
ground-truth renderer (VERDICT round 2, item 5).

The golden suite pins the DENSE renderer (tests/test_golden.py); these tests
hold the tiled pipeline — including the bench configuration's quantized
(tile|depth) sort, pair compaction, two-tier emission and progressive
deepening — to that same ground truth, with the truncation residual
(aux["resid_transmittance"]) asserted negligible so the comparison is
meaningful by construction: per-pixel error from tile-capacity truncation is
bounded by the residual transmittance of truncated tiles.

Remaining differences come from (a) 20-bit depth quantization flipping the
order of near-equal-depth overlapping splats and (b) f32 accumulation-order
drift; both are far below the asserted tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _cube_scene(n=20000, seed=3):
    from bench import build_cube_scene
    return build_cube_scene(n, seed=seed)


def _camera(w=512, h=256):
    from fourdgs.core.camera import Camera
    return Camera.create(position=(420.0, 300.0, 420.0),
                         orientation=(-1.0, -0.7, -1.0),
                         far=5000.0, width=w, height=h)


def _dense_image(params, camera, t=0.0):
    """Dense ground truth from the packed scalar-SoA parameter dict (the
    inverse of packed.params4d_from_arrays; equivalence pinned by
    tests/test_packed.py)."""
    from fourdgs.render import dense
    from fourdgs.splats.gaussians import Splats4D
    p = params
    splats = Splats4D.from_motion(
        position4=jnp.stack([p["px"], p["py"], p["pz"], p["pt"]], -1),
        quat=jnp.stack([p["qw"], p["qx"], p["qy"], p["qz"]], -1),
        scale3=jnp.stack([p["sx"], p["sy"], p["sz"]], -1),
        lifetime=p["lifetime"], fade=p["fade"],
        velocity=jnp.stack([p["vx"], p["vy"], p["vz"]], -1),
        color=jnp.stack([p["cr"], p["cg"], p["cb"], p["ca"]], -1))
    return dense.render_splats4d(splats, camera, t, 0.0)


@pytest.mark.slow
def test_bench_stack_matches_dense():
    """The exact bench.py feature stack (quantized sort + compaction +
    two-tier emission + slab deepening compositor) vs the dense model."""
    from fourdgs.render.pipeline import RenderConfig, render_params4d_packed

    params = _cube_scene()
    camera = _camera()
    # Mirrors the SHIPPED bench.py stack: quantized sort, two-tier
    # emission, depth pruning, row-sort compaction, one big
    # deepening slab (scaled to the test scene).
    cfg = RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                       max_splats_per_tile=512, max_tiles_per_splat=4,
                       splat_chunk=128, quantized_depth_sort=True,
                       sort_compact_keep_cols=256, compact_row_len=512,
                       big_splat_budget=16, big_splat_keep_cols=128,
                       deepening_passes=2, deepening_fraction=1.0,
                       deepening_schedule=(1536,),
                       depth_prune_cap=2048)
    img, aux = render_params4d_packed(params, camera, 0.0, cfg=cfg,
                                      return_aux=True)
    assert int(aux["overflowed"]) == 0
    assert int(aux["compact_dropped"]) == 0
    resid = float(aux["resid_transmittance"])
    assert resid < 1e-3, f"truncation residual {resid} — config not converged"

    want = np.asarray(_dense_image(params, camera))
    got = np.asarray(img)
    diff = np.abs(got - want)
    assert diff.mean() < 2e-3, f"mean|diff|={diff.mean():.5f}"
    assert float((diff > 0.05).mean()) < 1e-3, \
        f"{(diff > 0.05).mean():.2%} of pixels off by >0.05"


@pytest.mark.slow
def test_exact_path_matches_dense():
    """The exact-sort xla-backend path (golden-test configuration family)
    vs the dense model at a truncation-free capacity."""
    from fourdgs.render.pipeline import RenderConfig, render_params4d_packed

    params = _cube_scene(n=6000)
    camera = _camera(256, 128)
    cfg = RenderConfig(max_splats_per_tile=2048, splat_chunk=64,
                       max_tiles_per_splat=16)
    img, aux = render_params4d_packed(params, camera, 0.0, cfg=cfg,
                                      return_aux=True)
    assert int(aux["overflowed"]) == 0
    assert float(aux["resid_transmittance"]) < 1e-3

    want = np.asarray(_dense_image(params, camera))
    got = np.asarray(img)
    diff = np.abs(got - want)
    assert diff.mean() < 5e-4, f"mean|diff|={diff.mean():.5f}"
    assert diff.max() < 0.02, f"max|diff|={diff.max():.4f}"
