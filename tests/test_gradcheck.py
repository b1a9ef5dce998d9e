"""Finite-difference gradient checks for the full tiled render pipeline.

SURVEY.md section 7 step 6: central-difference gradcheck of EVERY trainable
parameter class — position4 (px/py/pz/pt), rotation quaternion, scale3,
lifetime, fade, velocity, color — against jax.grad through the packed
flagship path (splats/packed.py -> render/project.py -> render/pipeline.py),
for both the XLA compositor and the Pallas kernel (interpret mode on CPU).

Run in float64 (x64 enabled locally) so FD truncation error (~h^2 = 1e-12)
is far below the tolerance: a shared analytic error in any VJP — e.g. the
hand-written backward compositor's back-to-front cotangents — cannot hide
behind self-consistency tests.

The forward is differentiable almost everywhere; the measure-zero seams
(quad-coverage clip at |n| = 0.5, the 1e-4 fragment discard, depth-order
ties) are avoided by a deterministic scene and a tiny step (h = 1e-6), so a
perturbation essentially never pushes a pixel across a seam.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.core.camera import Camera
from fourdgs.render.pipeline import RenderConfig, render_params4d_packed
from fourdgs.splats.packed import PARAM4D_FIELDS

W, H = 128, 32          # one pallas tile row: tiles must be (8, 128)
N = 6
T_EVAL = 0.37
H_STEP = 1e-6


def _scene():
    """Six well-separated 4D splats covering several tiles, all parameter
    classes active (nonzero velocity, t != pt so temporal opacity and the
    conditional slice both carry gradients)."""
    rng = np.random.default_rng(7)
    f = lambda *a: jnp.asarray(np.asarray(a), jnp.float64)
    params = dict(
        px=f(-3.0, -1.2, 0.4, 1.8, 3.1, -0.3),
        py=f(0.5, -0.6, 0.9, -0.2, 0.1, -0.8),
        pz=f(-9.0, -11.0, -10.0, -12.5, -9.5, -10.5),
        pt=f(0.0, 0.1, -0.2, 0.3, -0.1, 0.2),
        qw=f(*rng.normal(1.0, 0.2, N)),
        qx=f(*rng.normal(0.0, 0.3, N)),
        qy=f(*rng.normal(0.0, 0.3, N)),
        qz=f(*rng.normal(0.0, 0.3, N)),
        sx=f(*rng.uniform(0.5, 1.2, N)),
        sy=f(*rng.uniform(0.5, 1.2, N)),
        sz=f(*rng.uniform(0.5, 1.2, N)),
        lifetime=f(*rng.uniform(2.0, 4.0, N)),
        fade=f(*rng.uniform(0.3, 0.7, N)),
        vx=f(*rng.normal(0.0, 0.4, N)),
        vy=f(*rng.normal(0.0, 0.4, N)),
        vz=f(*rng.normal(0.0, 0.4, N)),
        cr=f(*rng.uniform(0.2, 0.9, N)),
        cg=f(*rng.uniform(0.2, 0.9, N)),
        cb=f(*rng.uniform(0.2, 0.9, N)),
        ca=f(*rng.uniform(0.4, 0.8, N)),
    )
    camera = Camera.create(position=(0.0, 0.0, 0.0),
                           orientation=(0.0, 0.0, -1.0),
                           width=W, height=H, dtype=jnp.float64)
    return params, camera


def _loss_fn(camera, cfg):
    wts = jnp.asarray(
        np.random.default_rng(3).uniform(-1.0, 1.0, (H, W, 3)), jnp.float64)

    def loss(params):
        img = render_params4d_packed(params, camera, jnp.float64(T_EVAL),
                                     cfg=cfg)
        return jnp.sum(img[..., :3] * wts)

    return jax.jit(loss)


def _check_all_fields(cfg, fields=PARAM4D_FIELDS, tol=1e-5):
    with jax.enable_x64():
        params, camera = _scene()
        loss = _loss_fn(camera, cfg)
        grads = jax.jit(jax.grad(loss))(params)
        bad = []
        for field in fields:
            g = np.asarray(grads[field])
            for i in range(N):
                v = params[field]
                e = jnp.zeros_like(v).at[i].set(H_STEP)
                fd = (float(loss({**params, field: v + e}))
                      - float(loss({**params, field: v - e}))) / (2 * H_STEP)
                scale = max(1.0, abs(fd), abs(g[i]))
                if abs(fd - g[i]) > tol * scale:
                    bad.append((field, i, fd, float(g[i])))
        assert not bad, f"grad mismatches (field, idx, fd, ad): {bad}"
        # Sanity: the loss actually depends on every parameter class.
        for field in fields:
            assert np.any(np.asarray(grads[field]) != 0.0), field


class TestGradcheckXLA:
    def test_all_parameter_classes(self):
        cfg = RenderConfig(tile_h=8, tile_w=128, backend="xla",
                           max_splats_per_tile=16, max_tiles_per_splat=16,
                           splat_chunk=8)
        _check_all_fields(cfg)


class TestGradcheckPallas:
    def test_all_parameter_classes(self):
        # Interpret-mode kernel (CPU test env); f64 end to end, exercising
        # the hand-written backward kernel's back-to-front cotangents.
        cfg = RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                           max_splats_per_tile=128, max_tiles_per_splat=16)
        _check_all_fields(cfg)

    def test_progressive_deepening_matches(self):
        # Deepening (slab) path: same gradients as single-pass at slab
        # boundaries crossing the splat lists.
        with jax.enable_x64():
            params, camera = _scene()
            cfg1 = RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                                max_splats_per_tile=128,
                                max_tiles_per_splat=16)
            cfg2 = RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                                max_splats_per_tile=128,
                                max_tiles_per_splat=16,
                                deepening_passes=3, deepening_fraction=1.0)
            g1 = jax.jit(jax.grad(_loss_fn(camera, cfg1)))(params)
            g2 = jax.jit(jax.grad(_loss_fn(camera, cfg2)))(params)
            for k in PARAM4D_FIELDS:
                np.testing.assert_allclose(np.asarray(g1[k]),
                                           np.asarray(g2[k]),
                                           rtol=1e-9, atol=1e-12, err_msg=k)
