"""The sharded photometric loss on an image whose size is not a tile
multiple: the bottom row and right column of tiles reach past the image,
and those pixels must not enter the loss (a 4-device virtual CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.core.camera import Camera
from fourdgs.parallel import distributed as D
from fourdgs.parallel.mesh import make_mesh
from fourdgs.render import pipeline
from fourdgs.render.pipeline import RenderConfig

# 48x40 with 32x32 tiles: a partial tile column and a partial tile row.
CAM = Camera.create(position=(0.0, 0.0, 0.0), width=48, height=40)
CFG = RenderConfig(max_splats_per_tile=128, splat_chunk=32)


def _scene(n=64):
    ks = jax.random.split(jax.random.PRNGKey(11), 6)
    pos4 = jnp.concatenate([
        jax.random.uniform(ks[0], (n, 3), minval=-14.0, maxval=14.0),
        jnp.zeros((n, 1))], axis=-1).at[:, 2].add(-30.0)
    return dict(
        position4=pos4,
        quat=jax.random.normal(ks[1], (n, 4)),
        scale3=jax.random.uniform(ks[2], (n, 3), minval=1.0, maxval=3.0),
        lifetime=jnp.full((n,), 2.0),
        fade=jnp.full((n,), 0.5),
        velocity=jnp.zeros((n, 3)),
        color=jax.random.uniform(ks[3], (n, 4), minval=0.1, maxval=1.0))


@pytest.mark.parametrize("exchange,atol", [("allgather", 1e-5),
                                           ("alltoall", 2e-5)])
def test_sharded_loss_leaves_out_off_image_pixels(exchange, atol):
    mesh = make_mesh(jax.devices()[:4])
    params = _scene()
    target = jnp.full((CAM.height, CAM.width, 4), 0.05)
    npx = CAM.height * CAM.width * 3

    def loss_ref(p):
        img = pipeline.render_splats4d(D.materialize_splats(p), CAM, 0.0,
                                       cfg=CFG)
        return jnp.sum((img[..., :3] - target[..., :3]) ** 2) / npx

    loss_sh = D.make_sharded_loss(CAM, mesh, CFG, exchange=exchange)
    l_sh, g_sh = jax.jit(jax.value_and_grad(
        lambda p: loss_sh(p, target, 0.0)))(params)
    l_rf, g_rf = jax.jit(jax.value_and_grad(loss_ref))(params)
    np.testing.assert_allclose(float(l_sh), float(l_rf), rtol=1e-4)
    for k in params:
        np.testing.assert_allclose(np.asarray(g_sh[k]), np.asarray(g_rf[k]),
                                   atol=atol, err_msg=k)


def test_converged_sharded_step_matches_one_device(monkeypatch):
    """__graft_entry__.compare_sharded_step's converged mode (the check
    `chip_smoke.py --four` runs on four GPUs) with the plain references in
    place of the kernels: the sharded step's loss and gradients against
    the one-device ones, with the tail reached."""
    import dataclasses

    import __graft_entry__ as GE

    setup = GE._sharded_setup

    def converged_plain(*args):
        camera, modes, params, target = setup(*args)
        modes = tuple((label, ex, shard, dataclasses.replace(
            cfg, composite_impl="xla", tail_impl="xla"))
            for label, ex, shard, cfg in modes
            if label == "alltoall-converged")
        return camera, modes, params, target

    monkeypatch.setattr(GE, "_sharded_setup", converged_plain)
    lines = list(GE.compare_sharded_step(jax.devices()[:4]))
    assert len(lines) == 1 and "deepest tile" in lines[0], lines
