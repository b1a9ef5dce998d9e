"""Parity: the packed scalar-SoA path (splats/packed.py +
render_params4d_packed) must agree with the matrix-form golden path — same
math, different (scalable) layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.core.camera import Camera
from fourdgs.render import dense, pipeline
from fourdgs.render.pipeline import RenderConfig, render_params4d_packed
from fourdgs.splats import gaussians as G
from fourdgs.splats import packed as PK


def make_params(key, n=128):
    ks = jax.random.split(key, 6)
    pos4 = jnp.concatenate([
        jax.random.uniform(ks[0], (n, 3), minval=-8, maxval=8),
        jax.random.uniform(ks[1], (n, 1), minval=0.0, maxval=4.0)], -1)
    pos4 = pos4.at[:, 2].add(-30.0)
    return dict(position4=pos4,
                quat=jax.random.normal(ks[2], (n, 4)),
                scale3=jax.random.uniform(ks[3], (n, 3), minval=0.5, maxval=2.5),
                lifetime=jnp.full((n,), 2.0),
                fade=jnp.full((n,), 0.5),
                velocity=jax.random.normal(ks[4], (n, 3)) * 0.5,
                color=jax.random.uniform(ks[5], (n, 4), minval=0.1, maxval=1.0))


class TestPackedMath:
    def test_cov4_components_match_matrix(self):
        p = make_params(jax.random.PRNGKey(0))
        pk = PK.params4d_from_arrays(**p)
        cov4_m = G.build_cov4d_motion(p["quat"], p["scale3"], p["lifetime"],
                                      p["fade"], p["velocity"])
        c = PK.cov4_motion(pk)
        pairs = [(c[0], cov4_m[:, 0, 0]), (c[1], cov4_m[:, 0, 1]),
                 (c[2], cov4_m[:, 0, 2]), (c[3], cov4_m[:, 1, 1]),
                 (c[4], cov4_m[:, 1, 2]), (c[5], cov4_m[:, 2, 2]),
                 (c[6], cov4_m[:, 0, 3]), (c[7], cov4_m[:, 1, 3]),
                 (c[8], cov4_m[:, 2, 3]), (c[9], cov4_m[:, 3, 3])]
        for i, (got, want) in enumerate(pairs):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=2e-5, atol=1e-5, err_msg=str(i))

    def test_slice_matches_matrix(self):
        p = make_params(jax.random.PRNGKey(1))
        pk = PK.params4d_from_arrays(**p)
        c = PK.cov4_motion(pk)
        mx, my, mz, cov3, top, sort_m = PK.slice4d(pk, c, 1.7, min_opacity=0.05)
        splats = G.Splats4D.from_motion(**p)
        sliced, top_m = splats.at_time(1.7, 0.05)
        np.testing.assert_allclose(np.stack([mx, my, mz], -1),
                                   np.asarray(sliced.position), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(top), np.asarray(top_m),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(cov3[1]),
                                   np.asarray(sliced.cov[:, 0, 1]),
                                   rtol=1e-4, atol=1e-4)
        sm = G.mean_in_time_sortkey(splats.position, splats.cov, 1.7)
        np.testing.assert_allclose(np.stack(sort_m, -1), np.asarray(sm),
                                   rtol=1e-4, atol=1e-4)


class TestPackedRender:
    def test_matches_dense(self):
        p = make_params(jax.random.PRNGKey(2))
        pk = PK.params4d_from_arrays(**p)
        cam = Camera.create(position=(0, 0, 0), width=96, height=64)
        cfg = RenderConfig(max_splats_per_tile=256, splat_chunk=32)
        img_packed = np.asarray(render_params4d_packed(pk, cam, 1.0, cfg=cfg))
        img_dense = np.asarray(dense.render_splats4d(
            G.Splats4D.from_motion(**p), cam, 1.0))
        np.testing.assert_allclose(img_packed, img_dense, atol=5e-4)

    def test_packed_grads(self):
        p = make_params(jax.random.PRNGKey(3), n=48)
        pk = PK.params4d_from_arrays(**p)
        cam = Camera.create(position=(0, 0, 0), width=64, height=32)
        cfg = RenderConfig(max_splats_per_tile=128, splat_chunk=32)

        def loss(params):
            return jnp.mean(render_params4d_packed(params, cam, 0.5, cfg=cfg) ** 2)

        g = jax.jit(jax.grad(loss))(pk)
        for k, v in g.items():
            assert np.isfinite(np.asarray(v)).all(), k
        assert any(np.abs(np.asarray(v)).max() > 0 for v in g.values())


if __name__ == "__main__":
    import sys
    sys.exit(pytest.main([__file__, "-q"]))


class TestPackRowsKernel:
    """The record layout the kernels read: record_fields' padded (10, Np)
    matrix and pack_records' per-tile gather, forward and VJP."""

    def _proj(self, comps):
        from types import SimpleNamespace
        mx, my, v0x, v0y, l0, l1, r, g, b, a_eff = comps
        return SimpleNamespace(mx=mx, my=my, v0x=v0x, v0y=v0y, l0=l0, l1=l1,
                               r=r, g=g, b=b, opacity=a_eff, a=1.0,
                               valid=jnp.ones_like(mx, bool))

    def _rec_inputs(self, key, n=1900, pad_to=2048):
        ks = jax.random.split(key, 10)
        comps = [jax.random.uniform(k, (n,), minval=0.2, maxval=1.0)
                 for k in ks]
        return comps, 1.7, 2.3

    def _rec_jnp(self, comps, p00, p11, pad_to):
        mx, my, v0x, v0y, l0, l1, r, g, b, a_eff = comps
        rows = [mx / p00, my / p11, v0x, v0y, 1.0 / l0, 1.0 / l1,
                r, g, b, a_eff]
        return jnp.stack([jnp.pad(x, (0, pad_to - x.shape[0]))
                          for x in rows])

    def test_pack_core_fwd_matches_stack(self):
        from fourdgs.ops.composite_pallas import record_fields
        comps, p00, p11 = self._rec_inputs(jax.random.PRNGKey(0))
        out = record_fields(self._proj(comps), p00, p11, pad_to=2048)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(self._rec_jnp(comps, p00, p11, 2048)),
            rtol=1e-6)

    def test_pack_core_bwd_matches_stack_vjp(self):
        from fourdgs.ops.composite_pallas import record_fields
        comps, p00, p11 = self._rec_inputs(jax.random.PRNGKey(1))
        cot = jax.random.normal(jax.random.PRNGKey(2), (10, 2048))

        def via_fields(cs):
            return jnp.sum(record_fields(self._proj(cs), p00, p11,
                                         pad_to=2048) * cot)

        def via_stack(cs):
            return jnp.sum(self._rec_jnp(cs, p00, p11, 2048) * cot)

        g_f = jax.grad(via_fields)(tuple(comps))
        g_s = jax.grad(via_stack)(tuple(comps))
        for a, b in zip(g_f, g_s):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)

    def test_pack_record_fields_fwd(self):
        # Unpadded and padded layouts agree; pad columns are zero; a pad
        # width below N leaves the matrix as it is.
        from fourdgs.ops.composite_pallas import record_fields
        comps, p00, p11 = self._rec_inputs(jax.random.PRNGKey(3))
        proj = self._proj(comps)
        plain = np.asarray(record_fields(proj, p00, p11))
        padded = np.asarray(record_fields(proj, p00, p11, pad_to=2048))
        assert plain.shape == (10, 1900) and padded.shape == (10, 2048)
        np.testing.assert_array_equal(padded[:, :1900], plain)
        assert not padded[:, 1900:].any()
        np.testing.assert_array_equal(
            np.asarray(record_fields(proj, p00, p11, pad_to=1024)), plain)

    def test_pack_record_fields_bwd(self):
        # pack_records' per-tile gather (T, F, M) with dead entries' a_eff
        # zeroed, and its VJP (a scatter-add back onto the records).
        from fourdgs.ops.composite_pallas import (N_FIELDS, pack_records,
                                                  record_fields)
        comps, p00, p11 = self._rec_inputs(jax.random.PRNGKey(4))
        rng = np.random.default_rng(6)
        tile_splat = jnp.asarray(rng.integers(0, 1900, (5, 64)), jnp.int32)
        tile_live = jnp.asarray(rng.random((5, 64)) < 0.7)
        rec = record_fields(self._proj(comps), p00, p11)
        got = pack_records(None, tile_splat, tile_live, p00, p11, rec=rec)
        want = np.asarray(rec)[:, np.asarray(tile_splat)].transpose(1, 0, 2)
        want[:, N_FIELDS - 1] *= np.asarray(tile_live)
        np.testing.assert_array_equal(np.asarray(got), want)
        cot = jax.random.normal(jax.random.PRNGKey(5), got.shape)
        g = jax.grad(lambda r: jnp.sum(pack_records(
            None, tile_splat, tile_live, p00, p11, rec=r) * cot))(rec)
        mask = jnp.ones_like(got).at[:, N_FIELDS - 1].multiply(
            tile_live.astype(got.dtype))
        g_want = jnp.zeros_like(rec).at[:, tile_splat].add(
            (cot * mask).transpose(1, 0, 2))
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_want),
                                   rtol=1e-6, atol=1e-6)
