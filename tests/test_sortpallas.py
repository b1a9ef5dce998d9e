"""Pair-sort plumbing: the depth-prune cut-key lookup and its pipeline
integration (CPU). The GPU sorts with XLA's own lax.sort."""

import jax.numpy as jnp
import numpy as np
import pytest

DEAD = np.iinfo(np.int32).max


def test_apply_cutkeys_matches_numpy():
    from fourdgs.render.tiles import apply_cutkeys
    rng = np.random.default_rng(7)
    t = 300
    s = 256 * 128 * 2 + 777
    cut = rng.integers(0, 1 << 29, t, dtype=np.int32)
    tile = rng.integers(0, t, s, dtype=np.int32)
    key = (tile.astype(np.int64) << 20 | rng.integers(0, 1 << 20, s)
           ).astype(np.int32)
    key[rng.choice(s, s // 5, replace=False)] = DEAD
    got = np.asarray(apply_cutkeys(jnp.asarray(key), jnp.asarray(cut)))
    safe_tile = np.clip(key >> 20, 0, t - 1)
    want = np.where(key == DEAD, DEAD,
                    np.where(key <= cut[safe_tile], key, DEAD))
    assert np.array_equal(got, want)


def _bench_like_cfgs(prune_cap=0, keep=512):
    from fourdgs.render.pipeline import RenderConfig
    return RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                        max_splats_per_tile=256, max_tiles_per_splat=4,
                        splat_chunk=128, quantized_depth_sort=True,
                        sort_compact_keep_cols=keep,
                        big_splat_budget=16, big_splat_keep_cols=128,
                        deepening_passes=3, deepening_fraction=1.0,
                        depth_prune_cap=prune_cap)


def _render(params, camera, cfg):
    from fourdgs.render.pipeline import render_params4d_packed
    return render_params4d_packed(params, camera, 0.0, cfg=cfg,
                                  return_aux=True)


def _scene(n=4000):
    from bench import build_cube_scene
    from fourdgs.core.camera import Camera
    params = build_cube_scene(n, seed=11)
    camera = Camera.create(position=(420.0, 300.0, 420.0),
                           orientation=(-1.0, -0.7, -1.0),
                           far=5000.0, width=256, height=128)
    return params, camera


@pytest.mark.slow
def test_pipeline_depth_prune_keeps_image():
    params, camera = _scene(n=8000)
    cap = 256 * 3
    img0, aux0 = _render(params, camera, _bench_like_cfgs(keep=4096))
    img1, aux1 = _render(params, camera,
                         _bench_like_cfgs(prune_cap=cap, keep=4096))
    assert int(aux1["prune_underkeep"]) == 0
    assert int(aux1["compact_dropped"]) == 0
    assert int(aux1["live_pairs"]) <= int(aux0["live_pairs"])
    # Pruned pairs are deeper than anything the compositor blends; the
    # image is bounded by the truncation residual either way.
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                               atol=2e-2)
    assert float(np.abs(np.asarray(img1) - np.asarray(img0)).mean()) < 1e-3
