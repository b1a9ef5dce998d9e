"""Hand-written Pallas kernels (Triton route) and their plain references.

`interpret_mode` is the one place that decides how a kernel runs: compiled
for the GPU, or in the Pallas interpreter on the CPU (tests only). Any other
platform is an error rather than a silent fallback.
"""

from __future__ import annotations

import jax


def interpret_mode(platform: str | None = None) -> bool:
    """True when Pallas kernels must run interpreted (CPU), False when they
    compile for the GPU. `platform` defaults to JAX's default backend."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"fourdgs kernels compile for the GPU (Triton) or run interpreted on "
        f"the CPU; platform {platform!r} is neither")
