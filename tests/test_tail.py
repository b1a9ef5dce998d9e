"""Streaming banded-OIT tail (ops/tail_pallas.py): the Triton kernels (in
interpret mode) against the plain XLA reference, forward and backward, the
depth banding, and the band-combine math. Compiled execution is checked on
the GPU by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.ops import tail_pallas as TP


def _fixture(n=3000, nx=6, ny=10, k_bands=3, chunk=256, budget=3, seed=0):
    rng = np.random.default_rng(seed)
    tx0 = rng.integers(0, nx, n).astype(np.int32)
    ty0 = rng.integers(0, ny, n).astype(np.int32)
    tx1 = np.minimum(tx0 + rng.integers(0, 3, n), nx - 1).astype(np.int32)
    ty1 = np.minimum(ty0 + rng.integers(0, 3, n), ny - 1).astype(np.int32)
    alive = rng.random(n) > 0.2
    dbits = rng.integers(0, 1 << 20, n).astype(np.int32)
    fields = np.zeros((10, n), np.float32)
    fields[0] = rng.normal(0, 0.5, n)      # sx (k units)
    fields[1] = rng.normal(0, 0.5, n)
    th = rng.uniform(0, 2 * np.pi, n)
    fields[2] = np.cos(th)
    fields[3] = np.sin(th)
    fields[4] = 1.0 / rng.uniform(0.05, 0.4, n)
    fields[5] = 1.0 / rng.uniform(0.05, 0.4, n)
    fields[6:9] = rng.uniform(0, 1, (3, n))
    fields[9] = rng.uniform(0, 0.95, n)
    cut = ((np.arange(nx * ny, dtype=np.int32) << 20)
           | rng.integers(0, 1 << 20, nx * ny).astype(np.int32))
    # k-unit affine sample params: arbitrary but consistent.
    params_row = np.array([0.22, 0.028, -0.9, -0.18, -0.04, 0.8,
                           1e-4, 2e-4], np.float32)
    meta = TP.tail_meta(jnp.asarray(alive), jnp.asarray(tx0),
                        jnp.asarray(tx1), jnp.asarray(ty0),
                        jnp.asarray(ty1), jnp.asarray(dbits), chunk)
    npad = meta.shape[1]
    f = jnp.asarray(np.pad(fields, ((0, 0), (0, npad - n))))
    steps = npad // chunk
    band = jnp.asarray(rng.integers(0, k_bands, steps).astype(np.int32))
    return dict(fields=f, meta=meta, band=band,
                cut=jnp.asarray(cut), params_row=jnp.asarray(params_row),
                k_bands=k_bands, nx=nx, ny=ny, chunk=chunk, budget=budget)


def _args(fx):
    return (fx["fields"], fx["meta"], fx["band"], fx["cut"],
            fx["params_row"])


_STATIC = ("k_bands", "nx", "ny", "chunk", "budget")


@pytest.mark.parametrize("s_cy,s_cx", [(4, 16), (2, 8)])
def test_tail_kernel_matches_twin(s_cy, s_cx):
    fx = _fixture()
    kw = {k: fx[k] for k in _STATIC}
    got = TP.tail_accumulate(*_args(fx), s_cy=s_cy, s_cx=s_cx, **kw)
    want = TP.tail_accumulate_xla(*_args(fx), s_cy=s_cy, s_cx=s_cx, **kw)
    # f32 atomics vs a scatter-add: only the summation order differs.
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    # Nontrivial fixture: something actually accumulated.
    assert float(jnp.sum(jnp.abs(got))) > 1.0


@pytest.mark.parametrize("exact_clip", [False, True])
def test_tail_kernel_span_window_matches_twin(exact_clip):
    # The big-tier stream: only splats with budget_lo < span <= budget,
    # walked with the larger budget.
    fx = _fixture(n=2000, budget=9, seed=5)
    kw = {k: fx[k] for k in _STATIC}
    kw.update(budget_lo=2, s_cy=2, s_cx=4, exact_clip=exact_clip)
    got = TP.tail_accumulate(*_args(fx), **kw)
    want = TP.tail_accumulate_xla(*_args(fx), **kw)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert float(jnp.sum(jnp.abs(got))) > 1.0


def test_step_bands_near_chunks_first():
    # A chunk of near splats (large dbits) lands in band 0, a far one in
    # the last band; dead splats do not move a chunk's mean.
    chunk, n = 4, 12
    dbits = np.array([900] * 4 + [500] * 4 + [100] * 3 + [999], np.int32)
    span = np.array([1] * 11 + [0], np.int32)
    meta = jnp.asarray(np.stack([np.zeros(n, np.int32)] * 4
                                + [dbits, span]))
    cuts = jnp.asarray([-700, -300], jnp.int32)
    band = TP.step_bands(meta, chunk, cuts)
    np.testing.assert_array_equal(np.asarray(band), [0, 1, 2])


def test_band_cuts_order_and_combine():
    # global_band_cuts: nearest pairs (largest dbits) must land in band 0.
    rng = np.random.default_rng(0)
    dbits = rng.integers(0, 1 << 20, 5000).astype(np.int32)
    keys = (rng.integers(0, 100, 5000).astype(np.int32) << 20) | dbits
    keys[:500] = np.iinfo(np.int32).max          # dead
    cuts = TP.global_band_cuts(jnp.asarray(keys), 4)
    assert np.all(np.diff(np.asarray(cuts)) >= 0)
    near = np.searchsorted(np.asarray(cuts), -int(dbits.max()),
                           side="right")
    far = np.searchsorted(np.asarray(cuts), -int(dbits[dbits > 0].min()),
                          side="right")
    assert near == 0 and far == 3

    # combine: one band, uniform alpha a over m pairs at one sample ->
    # transmittance (1-a)^m exactly; color -> c * (1 - (1-a)^m).
    a, m, c = 0.1, 7, 0.6
    A = a * m
    L = np.log1p(-a) * m
    planes = jnp.asarray([[A, A * c, A * c, A * c, a * A, L]],
                         jnp.float32)  # (tiles=1, planes) at 1 sample
    rgb, alpha, trans = TP.combine_bands(
        planes.reshape(1, 1, 6, 1))     # (T, K, planes, S)
    np.testing.assert_allclose(float(trans[0, 0]), (1 - a) ** m, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(rgb[0, :, 0]),
                               c * (1 - (1 - a) ** m), rtol=1e-5)
    np.testing.assert_allclose(float(alpha[0, 0]),
                               a * (1 - (1 - a) ** m), rtol=1e-5)


def test_tail_backward_matches_twin_ad():
    """Hand-written tail backward kernel vs jax.grad through the XLA twin:
    field cotangents must agree (the twin is plain jnp, so its AD is the
    ground truth for the kernel's chain rule, including the
    mass-preserving-widening terms)."""
    fx = _fixture(n=1500, chunk=256, seed=4)
    kw = {k: fx[k] for k in _STATIC}
    s_cy, s_cx = 2, 16
    wts = jax.random.normal(jax.random.PRNGKey(3),
                            (TP.N_PLANES * s_cy * s_cx,))

    def loss_kernel(f):
        acc = TP.tail_accumulate(f, *_args(fx)[1:], s_cy=s_cy, s_cx=s_cx,
                                 **kw)
        return jnp.sum(acc * wts[None, :].reshape(1, -1))

    def loss_twin(f):
        acc = TP.tail_accumulate_xla(f, *_args(fx)[1:], s_cy=s_cy,
                                     s_cx=s_cx, **kw)
        return jnp.sum(acc * wts[None, :].reshape(1, -1))

    gk = np.asarray(jax.grad(loss_kernel)(fx["fields"]))
    gt = np.asarray(jax.grad(loss_twin)(fx["fields"]))
    scale = max(np.abs(gt).max(), 1e-3)
    assert np.abs(gk).sum() > 0          # nontrivial
    np.testing.assert_allclose(gk / scale, gt / scale, atol=5e-3)


@pytest.mark.slow
def test_training_through_converged_stack():
    """A few Adam steps through the FULL converged pipeline (exact head +
    banded tail, kernels interpreted) must reduce the loss: the tail's
    hand-written backward drives real parameter learning end to end."""
    from fourdgs.core.camera import Camera
    from fourdgs.render.pipeline import RenderConfig, render_params4d_packed
    from bench import build_cube_scene
    import optax

    cam = Camera.create(position=(420.0, 300.0, 420.0),
                        orientation=(-1.0, -0.7, -1.0),
                        far=5000.0, width=256, height=64)
    cfg = RenderConfig(tile_h=8, tile_w=128, backend="pallas",
                       max_splats_per_tile=128, max_tiles_per_splat=8,
                       splat_chunk=32, quantized_depth_sort=True,
                       big_splat_budget=16, depth_prune_cap=128,
                       depth_prune_safety=1.2, deepening_fraction=1.0,
                       tail_mode="banded", tail_bands=4, tail_block=(4, 8),
                       tail_chunk=256)
    params = build_cube_scene(1200, seed=7)
    target = render_params4d_packed(
        build_cube_scene(1200, seed=8), cam, 0.0, cfg=cfg)

    def loss_fn(p):
        img = render_params4d_packed(p, cam, 0.0, cfg=cfg)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    opt = optax.adam(5e-2)
    st = opt.init(params)
    step = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for _ in range(4):
        l, g = step(params)
        assert all(bool(jnp.all(jnp.isfinite(v))) for v in g.values())
        up, st = opt.update(g, st, params)
        params = optax.apply_updates(params, up)
        losses.append(float(l))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
