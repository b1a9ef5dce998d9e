"""Tests for the 1D/2D/3D simplex noise utilities (the analog of
the vendored SimplexNoise dependency, Dependencies/SIMPLEX_NOISE/
SimplexNoise.cpp — unused by reference app code but shipped; SURVEY.md
section 2.1 #21)."""

import jax
import jax.numpy as jnp
import numpy as np

from fourdgs.utils import simplex as S


class TestSimplex:
    def test_ranges(self):
        x = jnp.linspace(-20.0, 20.0, 5001)
        for v in (S.snoise1(x), S.snoise2(x, x * 0.7 + 3.0),
                  S.snoise3(x, x * 0.7 + 3.0, x * 1.3 - 2.0)):
            v = np.asarray(v)
            assert np.all(np.abs(v) <= 1.0 + 1e-5)
            assert v.std() > 0.2          # actually varies

    def test_deterministic(self):
        x = jnp.linspace(0.0, 5.0, 100)
        a = np.asarray(S.snoise3(x, x + 1, x + 2))
        b = np.asarray(S.snoise3(x, x + 1, x + 2))
        np.testing.assert_array_equal(a, b)

    def test_differentiable(self):
        for f in (lambda a: S.snoise1(a),
                  lambda a: S.snoise2(a, 1.7),
                  lambda a: S.snoise3(a, 1.7, -2.2)):
            g = jax.grad(f)(jnp.float32(0.33))
            assert np.isfinite(float(g))

    def test_fractal_octave_accumulation(self):
        x = jnp.linspace(-3.0, 3.0, 400)
        f1 = np.asarray(S.fractal1(x, octaves=1))
        n1 = np.asarray(S.snoise1(x))
        np.testing.assert_allclose(f1, n1, rtol=1e-6)
        f4 = np.asarray(S.fractal3(x, x * 2, x * 3, octaves=4))
        assert np.all(np.abs(f4) <= 1.0 + 1e-5)

    def test_continuity(self):
        # No jumps across integer lattice boundaries (quartic falloff
        # vanishes at the simplex edges).
        eps = 1e-4
        for f in (S.snoise1, lambda a: S.snoise2(a, 0.37),
                  lambda a: S.snoise3(a, 0.37, 1.21)):
            lo = float(f(jnp.float32(2.0 - eps)))
            hi = float(f(jnp.float32(2.0 + eps)))
            assert abs(hi - lo) < 1e-2
