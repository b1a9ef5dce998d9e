"""Scene-generator and IO tests: reference splat counts, format roundtrips,
PNG integrity, and a render smoke for each scene family."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.core.camera import Camera
from fourdgs.io import native, png, vdata
from fourdgs.render import dense, pipeline
from fourdgs.render.pipeline import RenderConfig
from fourdgs.scenes import models as M
from fourdgs.scenes import scenes as S
from fourdgs.splats.gaussians import Splats2D, Splats3D, Splats4D


class TestModels:
    def test_icosphere_counts(self):
        # 1 subdivision -> 42 unique vertices (the reference's Icosphere.vdata).
        m = M.icosphere(1)
        assert m.count == 42
        np.testing.assert_allclose(np.linalg.norm(m.position, axis=1), 1.0,
                                   atol=1e-5)

    def test_torus_normals_unit(self):
        m = M.torus()
        np.testing.assert_allclose(np.linalg.norm(m.normal, axis=1), 1.0,
                                   atol=1e-5)

    def test_synthetic_sd(self):
        sm = M.synthetic_sd_model(n=300)
        assert sm.count >= 297
        evals = np.linalg.eigvalsh(sm.cov[:, :3, :3])
        assert (evals > 0).all()  # PSD spatial covariances


class TestSceneGenerators:
    def test_counts_match_reference(self):
        # LinearMotion: model x 50 steps (Scenes.h:194,232);
        # NonLinear/Rotation/Broken/Square: x 92 (Scenes.h:460).
        model = M.torus(10, 10)  # 100 verts, fast
        splats, _ = S.linear_motion(model=model)
        assert splats.count == 100 * 50
        splats, _ = S.non_linear_motion(model=model)
        assert splats.count == 100 * 92
        splats, _ = S.clouds()
        assert splats.count == 150
        splats, _ = S.gaussians_2d()
        assert splats.count == 20

    def test_all_scenes_generate_finite(self):
        model = M.torus(8, 8)
        for name, fn in S.SCENES.items():
            kwargs = {}
            import inspect
            if "model" in inspect.signature(fn).parameters and name != "objectdisplay":
                kwargs["model"] = model
            splats, st = fn(**kwargs)
            for leaf in jax.tree_util.tree_leaves(splats):
                assert np.isfinite(np.asarray(leaf)).all(), name

    def test_linear_scene_renders(self):
        model = M.torus(8, 8)
        splats, st = S.linear_motion(model=model, steps=5)
        cam = Camera.create(position=st.camera_position,
                            orientation=st.camera_orientation,
                            width=64, height=64)
        img = np.asarray(pipeline.render_splats4d(
            splats, cam, 2.0, cfg=RenderConfig(max_splats_per_tile=256)))
        assert np.isfinite(img).all()
        assert img[..., :3].max() > 0.01

    def test_2d_scene_renders(self):
        splats, st = S.gaussians_2d()
        cam = Camera.create(width=64, height=64)
        img = np.asarray(dense.render_splats2d(splats, cam))
        assert np.isfinite(img).all() and img[..., :3].max() > 0.01

    def test_rotation_normals_corotate(self):
        # At dt=23 (92 steps x 4 deg/step -> 92 deg?? no: 23*4 = 92 deg);
        # just check normals rotate rigidly: dot products preserved.
        model = M.torus(6, 6)
        splats, _ = S.rotation_motion(model=model, steps=2)
        n = model.count
        cov_t0 = np.asarray(splats.cov[:n, :3, :3])
        cov_t1 = np.asarray(splats.cov[n:2 * n, :3, :3])
        np.testing.assert_allclose(np.linalg.eigvalsh(cov_t0),
                                   np.linalg.eigvalsh(cov_t1), atol=1e-3)


class TestIO:
    def test_vdata_roundtrip(self):
        m = M.icosphere(1)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "x.vdata")
            vdata.save_vdata(p, m)
            m2 = vdata.load_vdata(p)
            np.testing.assert_allclose(m2.position, m.position, atol=1e-5)
            np.testing.assert_allclose(m2.normal, m.normal, atol=1e-5)

    def test_sd_roundtrip(self):
        sm = M.synthetic_sd_model(n=60)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "x.sd")
            vdata.save_sd(p, sm)
            sm2 = vdata.load_sd(p)
            np.testing.assert_allclose(sm2.cov, sm.cov, rtol=1e-4, atol=1e-6)

    def test_partial_record_dropped(self):
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "x.vdata")
            with open(p, "w") as f:
                f.write("1 2 3 0 0 1\n4 5 6 0 1")  # second record incomplete
            m = vdata.load_vdata(p)
            assert m.count == 1

    def test_native_matches_python(self):
        if not native.available():
            pytest.skip("native lib not built")
        m = M.torus(12, 12)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "x.vdata")
            vdata.save_vdata(p, m)
            nat = native.read_floats(p)
            with open(p) as f:
                py = np.array(f.read().split(), dtype=np.float32)
            np.testing.assert_allclose(nat, py, rtol=1e-6)

    def test_native_cache_roundtrip(self):
        if not native.available():
            pytest.skip("native lib not built")
        rec = np.random.rand(500, 23).astype(np.float32)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "c.bin")
            assert native.write_cache(p, rec)
            back = native.read_cache(p)
            np.testing.assert_array_equal(back, rec)

    def test_png_roundtrip(self):
        img = np.random.rand(20, 30, 4).astype(np.float32)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "x.png")
            png.write_png(p, img)
            back = png.read_png(p)
            np.testing.assert_array_equal(back, png.to_uint8(img))


class TestPallasInterpret:
    """The Triton compositor runs in the Pallas interpreter on the CPU with
    the semantics it has compiled on the GPU."""

    def test_matches_dense(self):
        key = jax.random.PRNGKey(7)
        n = 120
        k1, k2, k3, k4 = jax.random.split(key, 4)
        pos = jax.random.uniform(k1, (n, 3), minval=-10, maxval=10).at[:, 2].add(-30.0)
        from fourdgs.splats.gaussians import build_cov3d
        splats = Splats3D(
            position=pos,
            color=jax.random.uniform(k4, (n, 4), minval=0.1, maxval=1.0),
            cov=build_cov3d(jax.random.normal(k2, (n, 4)),
                            jax.random.uniform(k3, (n, 3), minval=0.5, maxval=3.0)))
        cam = Camera.create(position=(0, 0, 0), width=256, height=64)
        cfg = RenderConfig(tile_h=8, tile_w=128, max_splats_per_tile=256,
                           backend="pallas")
        img_p = np.asarray(pipeline.render_splats3d(splats, cam, cfg=cfg))
        img_d = np.asarray(dense.render_splats3d(splats, cam))
        np.testing.assert_allclose(img_p, img_d, atol=2e-5)

    def test_grad_through_pallas(self):
        key = jax.random.PRNGKey(8)
        n = 40
        from fourdgs.splats.gaussians import build_cov3d
        pos = jax.random.uniform(key, (n, 3), minval=-5, maxval=5).at[:, 2].add(-20.0)
        splats = Splats3D(position=pos,
                          color=jnp.full((n, 4), 0.7),
                          cov=build_cov3d(jnp.tile(jnp.array([1.0, 0, 0, 0]), (n, 1)),
                                          jnp.full((n, 3), 1.5)))
        cam = Camera.create(position=(0, 0, 0), width=128, height=32)
        cfg = RenderConfig(tile_h=8, tile_w=128, max_splats_per_tile=128,
                           backend="pallas")

        def loss(p):
            s = Splats3D(position=p, color=splats.color, cov=splats.cov)
            return jnp.mean(pipeline.render_splats3d(s, cam, cfg=cfg) ** 2)

        g = jax.grad(loss)(splats.position)
        assert np.isfinite(np.asarray(g)).all()
        # Grad must agree with the XLA backend's grad (the VJP twin).
        def loss_x(p):
            s = Splats3D(position=p, color=splats.color, cov=splats.cov)
            return jnp.mean(pipeline.render_splats3d(
                s, cam, cfg=RenderConfig(tile_h=8, tile_w=128,
                                         max_splats_per_tile=128)) ** 2)
        gx = jax.grad(loss_x)(splats.position)
        np.testing.assert_allclose(np.asarray(g), np.asarray(gx), atol=1e-6)


if __name__ == "__main__":
    import sys
    sys.exit(pytest.main([__file__, "-q"]))


class TestPallasBackwardKernel:
    def test_bwd_kernel_matches_twin_autodiff(self):
        """The hand-written backward kernel vs jax.grad of the XLA twin on
        identical gated records (interpret mode)."""
        import jax
        import jax.numpy as jnp
        from fourdgs.ops.composite_pallas import (N_FIELDS, _C_AEFF,
                                                  _xla_composite_from_records,
                                                  composite_records,
                                                  identity_carry)
        t_tiles, m, p = 2, 256, 1024
        ks = jax.random.split(jax.random.PRNGKey(0), 9)
        rec = jnp.zeros((t_tiles, N_FIELDS, m))
        rec = rec.at[:, 0, :].set(jax.random.uniform(ks[0], (t_tiles, m), minval=-0.3, maxval=0.3))
        rec = rec.at[:, 1, :].set(jax.random.uniform(ks[1], (t_tiles, m), minval=-0.3, maxval=0.3))
        ang = jax.random.uniform(ks[2], (t_tiles, m)) * 6.28
        rec = rec.at[:, 2, :].set(jnp.cos(ang))
        rec = rec.at[:, 3, :].set(jnp.sin(ang))
        rec = rec.at[:, 4, :].set(1.0 / jax.random.uniform(ks[3], (t_tiles, m), minval=0.05, maxval=0.4))
        rec = rec.at[:, 5, :].set(1.0 / jax.random.uniform(ks[4], (t_tiles, m), minval=0.05, maxval=0.4))
        rec = rec.at[:, 6:9, :].set(jax.random.uniform(ks[5], (t_tiles, 3, m)))
        counts = jnp.array([256, 77], jnp.int32)
        live = (jnp.arange(m)[None, :] < counts[:, None]).astype(jnp.float32)
        rec = rec.at[:, _C_AEFF, :].set(
            jax.random.uniform(ks[6], (t_tiles, m), minval=0.1, maxval=0.9) * live)
        kx = jax.random.uniform(ks[7], (t_tiles, 1, p), minval=-0.4, maxval=0.4)
        ky = jax.random.uniform(ks[8], (t_tiles, 1, p), minval=-0.4, maxval=0.4)
        cot = jax.random.normal(jax.random.PRNGKey(42), (t_tiles, 8, p)) * 0.1

        carry = identity_carry(t_tiles)
        gp = jax.grad(lambda r: jnp.sum(
            composite_records(r, counts, kx, ky, carry) * cot))(rec)
        gx = jax.grad(lambda r: jnp.sum(
            _xla_composite_from_records(r, counts, kx, ky).reshape(t_tiles, 8, p) * cot))(rec)
        mask = np.asarray(live)[:, None, :]
        np.testing.assert_allclose(np.asarray(gp) * mask, np.asarray(gx) * mask,
                                   atol=1e-5)
