"""Pair-compaction (render/tiles.py:compact_pairs) and tight-bbox tests.

Compaction shrinks the pair array ahead of the global sort (the frame's
dominant stage at 10M splats); these tests pin (a) losslessness when the
column budget is ample, (b) honest drop accounting when it is not, and
(c) that the quad-intersect-ellipse bbox never excludes a covered pixel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.core.camera import Camera
from fourdgs.render import dense, pipeline
from fourdgs.render.pipeline import RenderConfig
from fourdgs.render.project import R_COVER, project_splats
from fourdgs.render.tiles import COMPACT_ROW_LEN, compact_pairs
from fourdgs.splats import gaussians as G

DEAD = jnp.iinfo(jnp.int32).max


def make_scene(key, n=200, spread=10.0):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    pos = jax.random.uniform(k1, (n, 3), minval=-spread, maxval=spread)
    pos = pos.at[:, 2].add(-30.0)
    quat = jax.random.normal(k2, (n, 4))
    scale = jax.random.uniform(k3, (n, 3), minval=0.5, maxval=3.0)
    color = jax.random.uniform(k4, (n, 4), minval=0.1, maxval=1.0)
    return G.Splats3D(position=pos, color=color,
                      cov=G.build_cov3d(quat, scale))


CAM = Camera.create(position=(0.0, 0.0, 0.0), width=96, height=64)


class TestCompactPairs:
    def _pairs(self, s=3 * COMPACT_ROW_LEN + 777, live_frac=0.4, seed=0):
        ka, kb = jax.random.split(jax.random.PRNGKey(seed))
        key = jax.random.randint(ka, (s,), 0, 1 << 30, dtype=jnp.int32)
        live = jax.random.uniform(kb, (s,)) < live_frac
        key = jnp.where(live, key, DEAD)
        val = jnp.arange(s, dtype=jnp.int32)
        return key, val

    def test_lossless_with_ample_budget(self):
        key, val = self._pairs()
        keep = COMPACT_ROW_LEN // 2  # 0.4 live << 0.5 keep
        kc, vc, dropped = compact_pairs(key, val, DEAD, keep)
        assert int(dropped) == 0
        # Exactly the live (key, val) multiset survives.
        live = np.asarray(key) != np.iinfo(np.int32).max
        got = {(int(k), int(v)) for k, v in zip(np.asarray(kc),
                                                np.asarray(vc))
               if k != np.iinfo(np.int32).max}
        want = {(int(k), int(v)) for k, v in
                zip(np.asarray(key)[live], np.asarray(val)[live])}
        assert got == want

    def test_drop_accounting_when_budget_too_small(self):
        key, val = self._pairs(live_frac=0.6)
        keep = COMPACT_ROW_LEN // 4
        kc, vc, dropped = compact_pairs(key, val, DEAD, keep)
        live_total = int(jnp.sum(key != DEAD))
        kept_live = int(jnp.sum(kc != DEAD))
        assert int(dropped) == live_total - kept_live > 0

    def test_rows_keep_smallest_keys(self):
        # Kept keys per strided row are that row's smallest: sorting the
        # kept output must equal sorting the live input when lossless.
        key, val = self._pairs(seed=3)
        kc, vc, _ = compact_pairs(key, val, DEAD, COMPACT_ROW_LEN // 2)
        ks = np.sort(np.asarray(kc))
        ref = np.sort(np.asarray(key))[: ks.shape[0]]
        np.testing.assert_array_equal(ks[ks != np.iinfo(np.int32).max],
                                      ref[ref != np.iinfo(np.int32).max])

    def test_compact_flag_ids_exact_sparse(self):
        """Hot-block extraction returns exactly the flagged index set for
        sparse flags, including clustered ones, with dropped == 0."""
        from fourdgs.render.tiles import compact_flag_ids
        rng = np.random.default_rng(5)
        n = 256 * 1024
        for flags in (
                rng.random(n) < 1e-4,                       # uniform sparse
                np.r_[np.zeros(n - 2048, bool),             # one hot cluster
                      rng.random(2048) < 0.2],
                np.zeros(n, bool)):                         # empty
            ids, dropped = compact_flag_ids(jnp.asarray(flags))
            got = np.asarray(ids)
            got = set(got[got != np.iinfo(np.int32).max].tolist())
            assert got == set(np.flatnonzero(flags).tolist())
            assert int(dropped) == 0

    def test_compact_flag_ids_overflow_is_loud(self):
        """Flags past the hot-block capacity are COUNTED, never silent."""
        from fourdgs.render.tiles import compact_flag_ids
        n = 256 * 1024
        # One flag in every 1024-block: 256 hot blocks > hot_cap 8.
        flags = np.zeros(n, bool)
        flags[::1024] = True
        ids, dropped = compact_flag_ids(jnp.asarray(flags), hot_cap=8)
        kept = int(np.sum(np.asarray(ids) != np.iinfo(np.int32).max))
        assert kept == 8
        assert int(dropped) == 256 - 8

    def test_pipeline_image_unchanged(self):
        splats = make_scene(jax.random.PRNGKey(5))
        base = RenderConfig(max_splats_per_tile=256, splat_chunk=32,
                            quantized_depth_sort=True)
        with_c = RenderConfig(max_splats_per_tile=256, splat_chunk=32,
                              quantized_depth_sort=True,
                              sort_compact_keep_cols=COMPACT_ROW_LEN)
        img0, aux0 = pipeline.render_splats3d(splats, CAM, cfg=base,
                                              return_aux=True)
        img1, aux1 = pipeline.render_splats3d(splats, CAM, cfg=with_c,
                                              return_aux=True)
        assert "compact_dropped" not in aux0
        assert int(aux1["compact_dropped"]) == 0
        np.testing.assert_allclose(np.asarray(img1), np.asarray(img0),
                                   atol=1e-6)


class TestTwoTierEmission:
    def _big_scene(self):
        # Mix of small splats and a few huge ones spanning many tiles.
        splats = make_scene(jax.random.PRNGKey(11), n=120)
        cov = splats.cov.at[:6].multiply(64.0)  # ~8x linear footprint
        return G.Splats3D(position=splats.position, color=splats.color,
                          cov=cov)

    def test_matches_single_tier_big_budget(self):
        splats = self._big_scene()
        ref_cfg = RenderConfig(max_splats_per_tile=256, splat_chunk=32,
                               quantized_depth_sort=True,
                               max_tiles_per_splat=32)
        two_cfg = RenderConfig(max_splats_per_tile=256, splat_chunk=32,
                               quantized_depth_sort=True,
                               max_tiles_per_splat=4, big_splat_budget=32)
        img_ref, aux_ref = pipeline.render_splats3d(splats, CAM, cfg=ref_cfg,
                                                    return_aux=True)
        img_two, aux_two = pipeline.render_splats3d(splats, CAM, cfg=two_cfg,
                                                    return_aux=True)
        assert int(aux_ref["overflowed"]) == 0
        assert int(aux_two["overflowed"]) == 0
        np.testing.assert_allclose(np.asarray(img_two), np.asarray(img_ref),
                                   atol=2e-5)
        # And the small budget alone WOULD have overflowed (the tier matters)
        small = RenderConfig(max_splats_per_tile=256, splat_chunk=32,
                             quantized_depth_sort=True, max_tiles_per_splat=4)
        _, aux_small = pipeline.render_splats3d(splats, CAM, cfg=small,
                                                return_aux=True)
        assert int(aux_small["overflowed"]) > 0

    def test_overflow_counts_spans_beyond_big_budget(self):
        splats = self._big_scene()
        tiny_big = RenderConfig(max_splats_per_tile=256, splat_chunk=32,
                                quantized_depth_sort=True,
                                max_tiles_per_splat=2, big_splat_budget=3)
        _, aux = pipeline.render_splats3d(splats, CAM, cfg=tiny_big,
                                          return_aux=True)
        assert int(aux["overflowed"]) > 0


class TestTightBBox:
    def test_bbox_contains_every_covered_pixel(self):
        """For random projected splats, any pixel passing the compositor's
        cover test (quad clip AND w >= 1e-4) lies inside half_extent_ndc."""
        splats = make_scene(jax.random.PRNGKey(7), n=64)
        proj = project_splats(splats.position, splats.cov, splats.color,
                              jnp.ones((splats.count,)), CAM)
        pmat = CAM.proj_matrix()
        p00, p11 = pmat[0, 0], pmat[1, 1]
        hx, hy = proj.half_extent_ndc(p00, p11)

        # Dense NDC pixel grid.
        xs = (jnp.arange(CAM.width) + 0.5) / CAM.width * 2.0 - 1.0
        ys = 1.0 - (jnp.arange(CAM.height) + 0.5) / CAM.height * 2.0
        px, py = jnp.meshgrid(xs, ys)
        px, py = px.ravel(), py.ravel()

        kx = px / p00
        ky = py / p11
        for i in range(int(splats.count)):
            if not bool(proj.valid[i]):
                continue
            dx = kx - proj.mx[i] / p00
            dy = ky - proj.my[i] / p11
            n0 = (proj.v0x[i] * dx + proj.v0y[i] * dy) / proj.l0[i]
            n1 = (proj.v0y[i] * dx - proj.v0x[i] * dy) / proj.l1[i]
            w = jnp.exp(-0.5 * 64.0 * (n0 * n0 + n1 * n1))
            cover = (jnp.abs(n0) <= 0.5) & (jnp.abs(n1) <= 0.5) & (w >= 1e-4)
            inside = ((jnp.abs(px - proj.mx[i]) <= hx[i] + 1e-6)
                      & (jnp.abs(py - proj.my[i]) <= hy[i] + 1e-6))
            assert not bool(jnp.any(cover & ~inside))

    def test_tighter_than_quad_bound(self):
        splats = make_scene(jax.random.PRNGKey(8), n=128)
        proj = project_splats(splats.position, splats.cov, splats.color,
                              jnp.ones((splats.count,)), CAM)
        pmat = CAM.proj_matrix()
        hx, hy = proj.half_extent_ndc(pmat[0, 0], pmat[1, 1])
        qx = 0.5 * (jnp.abs(proj.v0x) * proj.l0
                    + jnp.abs(proj.v0y) * proj.l1) * pmat[0, 0]
        qy = 0.5 * (jnp.abs(proj.v0y) * proj.l0
                    + jnp.abs(proj.v0x) * proj.l1) * pmat[1, 1]
        assert bool(jnp.all(hx <= qx + 1e-7))
        assert bool(jnp.all(hy <= qy + 1e-7))
        # and strictly tighter for a decent share of rotated splats
        assert float(jnp.mean((hx < qx * 0.999))) > 0.2
