"""The converged pipeline (exact head + banded tail) as auto_render_config
derives it, at a tiny size: Triton kernels (interpreted) against the plain
XLA references, image and gradient, and the kernels' lowering for the GPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.core.camera import Camera
from fourdgs.render.autoconfig import auto_render_config
from fourdgs.render.pipeline import render_params4d_packed

N = 2000
CAM = Camera.create(position=(130.0, 90.0, 130.0),
                    orientation=(-1.0, -0.7, -1.0),
                    far=5000.0, width=256, height=64)


@pytest.fixture(scope="module")
def scene():
    from bench import build_cube_scene
    from fourdgs.splats.packed import morton_order
    # The bench cube shrunk to 120^3 and seen from nearby, so the splats
    # cover several pixels and the deepest tiles overflow the head.
    params = {k: v * 0.3 if k in ("px", "py", "pz") else v
              for k, v in build_cube_scene(N, seed=7).items()}
    params = morton_order(params)
    cfg = auto_render_config(N, CAM.width, CAM.height, tile_h=8,
                             max_splats_per_tile=64, depth_prune_cap=64,
                             tail_chunk=256, tail_block=(4, 16),
                             big_splat_budget=0)
    plain = dataclasses.replace(cfg, composite_impl="xla", tail_impl="xla")
    return params, cfg, plain


def _loss(params, cfg):
    img = render_params4d_packed(params, CAM, 0.0, cfg=cfg)
    return jnp.mean(img[..., :3] ** 2)


def test_converged_render_matches_plain(scene):
    params, cfg, plain = scene
    img_k, aux = render_params4d_packed(params, CAM, 0.0, cfg=cfg,
                                        return_aux=True)
    img_x = render_params4d_packed(params, CAM, 0.0, cfg=plain)
    for key in ("overflowed", "compact_dropped", "resid_transmittance"):
        assert float(aux[key]) == 0.0, key
    # The head cap is below the deepest tile: the tail carries real pairs.
    assert int(aux["max_tile_pairs"]) > cfg.max_splats_per_tile
    assert float(jnp.mean(img_k[..., :3])) > 1e-3
    np.testing.assert_allclose(np.asarray(img_k), np.asarray(img_x),
                               atol=1e-5)


def test_converged_grad_matches_plain(scene):
    params, cfg, plain = scene
    g_k = jax.grad(_loss)(params, cfg)
    g_x = jax.grad(_loss)(params, plain)
    for k in ("px", "py", "pz", "qw", "sx", "cr", "cg", "ca"):
        gk, gx = np.asarray(g_k[k]), np.asarray(g_x[k])
        assert np.isfinite(gk).all(), k
        scale = max(float(np.max(np.abs(gx))), 1e-12)
        np.testing.assert_allclose(gk / scale, gx / scale, atol=1e-4,
                                   err_msg=k)
    assert float(np.max(np.abs(np.asarray(g_k["cr"])))) > 0.0


def test_kernels_lower_to_triton_for_gpu(scene, monkeypatch):
    # Lowering for CUDA needs no card: with the interpreter switched off,
    # every kernel of the converged forward and backward must become a
    # Triton custom call (catches Triton lowering errors here).
    from fourdgs.ops import composite_pallas, tail_pallas
    params, cfg, _ = scene
    for mod in (composite_pallas, tail_pallas):
        monkeypatch.setattr(mod, "interpret_mode", lambda: False)
    lowered = jax.jit(jax.grad(_loss), static_argnums=1).trace(
        params, cfg).lower(lowering_platforms=("cuda",))
    # composite fwd + bwd, tail fwd + bwd
    assert lowered.as_text().count("xla.gpu.triton") == 4
