"""Small shared helpers — the analog of the reference's Utils
(Utils.{h,cpp}: minf/maxf/lerp/mapf, Utils.cpp:115-133, plus matrix/vector
printers used for debugging)."""

from __future__ import annotations

import jax
import numpy as np


def lerp(a, b, t):
    """Utils::lerp (Utils.cpp:125-128)."""
    return a + (b - a) * t


def mapf(x, in_min, in_max, out_min, out_max):
    """Utils::mapf (Utils.cpp:130-133): linear range remap."""
    return (x - in_min) / (in_max - in_min) * (out_max - out_min) + out_min


def format_mat(m, name: str = "mat", precision: int = 5) -> str:
    """Readable matrix dump (Utils::Mat4Print analog)."""
    arr = np.asarray(m)
    rows = "\n".join("  [" + ", ".join(f"{v:+.{precision}f}" for v in row) + "]"
                     for row in np.atleast_2d(arr))
    return f"{name} {arr.shape}:\n{rows}"


def tree_bytes(tree) -> int:
    """Total byte size of all array leaves (memory accounting helper)."""
    return sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(tree)
               if hasattr(leaf, "nbytes"))
