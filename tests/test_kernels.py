"""The kernels' plumbing: the compile-or-interpret choice, the compile cache,
chip_smoke.py's refusal without a GPU, and the Triton compositor (in the
interpreter) against its plain reference at two tile shapes."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fourdgs.ops import composite_pallas as C
from fourdgs.ops import interpret_mode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,interpret", [("cpu", True),
                                                ("gpu", False),
                                                ("metal", None)])
def test_interpret_mode_choice(platform, interpret):
    if interpret is None:
        with pytest.raises(RuntimeError, match="metal"):
            interpret_mode(platform)
    else:
        assert interpret_mode(platform) is interpret


def test_compile_cache_in_checkout(monkeypatch):
    from fourdgs.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        ignored = subprocess.run(["git", "check-ignore", "-q",
                                  os.path.join(path, "entry")],
                                 cwd=ROOT).returncode
        assert ignored == 0, ".jax_cache must be git-ignored"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from fourdgs.utils import cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        # Nothing is set in code: JAX reads the variable itself.
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _records(t_tiles, m, p, seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), 9)
    u = lambda k, lo, hi, s=(t_tiles, m): jax.random.uniform(  # noqa: E731
        k, s, minval=lo, maxval=hi)
    ang = u(ks[2], 0.0, 6.28)
    counts = jnp.asarray([m, m // 3] + [m // 2] * (t_tiles - 2), jnp.int32)
    live = (jnp.arange(m)[None] < counts[:, None]).astype(jnp.float32)
    rec = jnp.stack([u(ks[0], -0.3, 0.3), u(ks[1], -0.3, 0.3),
                     jnp.cos(ang), jnp.sin(ang),
                     1.0 / u(ks[3], 0.05, 0.4), 1.0 / u(ks[4], 0.05, 0.4),
                     u(ks[5], 0.0, 1.0), u(ks[6], 0.0, 1.0),
                     u(ks[5], 0.0, 1.0) * 0.5,
                     u(ks[6], 0.1, 0.9) * live], axis=1)
    kx = u(ks[7], -0.4, 0.4, (t_tiles, 1, p))
    ky = u(ks[8], -0.4, 0.4, (t_tiles, 1, p))
    carry = C.identity_carry(t_tiles, p=p).at[:, 0:4].set(0.05).at[
        :, 4].set(0.8)
    return rec, counts, kx, ky, carry, live


# (tile_h, tile_w): the 8x128 tiles of the small configs and a square
# 16x16 tile, one pixel block each or several.
TILES = [(8, 128), (16, 16)]


@pytest.mark.parametrize("tile", TILES)
def test_composite_triton_fwd(tile):
    rec, counts, kx, ky, carry, _ = _records(3, 96, tile[0] * tile[1], 0)
    got = C.composite_records(rec, counts, kx, ky, carry)
    want = C.composite_records(rec, counts, kx, ky, carry, impl="xla")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-6)
    assert float(jnp.min(got[:, 4])) < 0.5       # real blending happened


@pytest.mark.parametrize("tile", TILES)
def test_composite_triton_bwd(tile):
    rec, counts, kx, ky, carry, live = _records(3, 96, tile[0] * tile[1], 1)
    cot = jax.random.normal(jax.random.PRNGKey(7), carry.shape)

    def grads(impl):
        return jax.grad(lambda r, c: jnp.sum(C.composite_records(
            r, counts, kx, ky, c, impl=impl) * cot), argnums=(0, 1))(
                rec, carry)

    (dr_k, dc_k), (dr_x, dc_x) = grads("triton"), grads("xla")
    mask = np.asarray(live)[:, None, :]          # entries past counts
    scale = float(np.max(np.abs(np.asarray(dr_x) * mask)))
    np.testing.assert_allclose(np.asarray(dr_k) * mask / scale,
                               np.asarray(dr_x) * mask / scale, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dc_k), np.asarray(dc_x),
                               atol=1e-5)


@pytest.mark.gpu
def test_kernels_compile_on_gpu(gpu):
    rec, counts, kx, ky, carry, _ = _records(4, 64, 1024, 2)
    fn = jax.jit(lambda *a: C.composite_records(*a))
    assert "xla.gpu.triton" in fn.lower(rec, counts, kx, ky,
                                        carry).as_text()
    np.testing.assert_allclose(
        np.asarray(fn(rec, counts, kx, ky, carry)),
        np.asarray(C.composite_records(rec, counts, kx, ky, carry,
                                       impl="xla")), atol=1e-5)
