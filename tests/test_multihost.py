"""Multi-PROCESS execution test (SURVEY.md section 4e): 2 processes x 4
virtual CPU devices run the all_to_all sharded train step through
`jax.distributed` and must produce the single-process loss.

This is the missing piece between "single-process multi-device" (everything
in tests/test_parallel.py) and a real multi-host cluster: the same mesh
axes, but device meshes spanning processes, global arrays assembled from
process-local shards, and the JAX coordination service standing in for the
reference's (nonexistent) distributed runtime."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_train_step_matches_single():
    port = _free_port()
    procs = []
    env_base = {k: v for k, v in os.environ.items()
                if not k.startswith(("JAX_", "XLA_"))}
    for i in range(2):
        env = dict(env_base,
                   JAX_PLATFORMS="cpu",
                   JAX_COORDINATOR=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(i))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "_mh_worker.py")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            line = [l for l in out.splitlines() if l.startswith("{")][-1]
            outs.append(json.loads(line))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    # Both processes see the same (replicated) loss and updated params.
    assert outs[0]["loss"] == pytest.approx(outs[1]["loss"], rel=1e-6)
    assert outs[0]["params_l1"] == pytest.approx(outs[1]["params_l1"],
                                                rel=1e-6)

    # Single-process reference on the in-process 8-device mesh (conftest):
    # identical (2, 4) mesh shape, same scene, same step.
    import jax
    import jax.numpy as jnp
    import optax

    from fourdgs.core.camera import Camera
    from fourdgs.parallel import distributed as D
    from fourdgs.parallel.mesh import make_mesh, splat_sharding_flat
    from fourdgs.render.pipeline import RenderConfig

    sys.path.insert(0, ROOT)
    from __graft_entry__ import _tiny_scene

    mesh = make_mesh(jax.devices()[:8])
    assert dict(mesh.shape) == {"data": 2, "tile": 4}
    params = _tiny_scene(n=64, seed=1)
    params = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, splat_sharding_flat(mesh)), params)
    camera = Camera.create(position=(0.0, 0.0, 0.0), width=64, height=32)
    cfg = RenderConfig(max_splats_per_tile=128, splat_chunk=32,
                       max_tiles_per_splat=8)
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    step = jax.jit(D.make_sharded_train_step(camera, mesh, optimizer, cfg,
                                             exchange="alltoall"))
    _, _, loss = step(params, opt_state,
                      jnp.zeros((camera.height, camera.width, 4)),
                      jnp.asarray(0.5))
    assert outs[0]["loss"] == pytest.approx(float(loss), rel=1e-5)
