"""Automatic pipeline configuration from scene/image size.

One function from (n_splats, width, height) to a loss-free RenderConfig,
so every scene size and resolution runs with zero overrides. The values
below were found loss-free on the 400^3 cube scene (bench.build_cube_scene)
at 200K/1M/10M splats at 1080p and 10M at 4K:

* pair budget (max_tiles_per_splat): the same scene's footprints span
  proportionally more tiles at higher resolution; budget = ceil(4 *
  resolution scale).
* compaction keep (sort_compact_keep_cols): the depth prune's cap is
  per-tile, so SMALLER scenes keep a LARGER fraction of their pair slots;
  a fixed small keep drops real pairs there (loud via compact_dropped).
* exact head slab / prune cap: the exact head covers the visually
  dominant near field while the banded tail streams the rest.
* tail block 16x16: halving the tail's sample count vs 8x16 costs no
  measurable parity error (within-band OIT mixing dominates, not sample
  resolution).
"""

from __future__ import annotations

import math

from fourdgs.render.pipeline import RenderConfig


def auto_render_config(n_splats: int, width: int, height: int,
                       converged: bool = True, **overrides) -> RenderConfig:
    """Derive a loss-free production RenderConfig for the slab pipeline.

    converged=True (default) enables the streaming banded-OIT tail (zero
    pair truncation — the reference's blend-everything semantics;
    Splat4DFragShader.GLSL:22-31). Any explicit RenderConfig field can be
    forced via **overrides (overrides win).

    Callers should Morton-order the scene once at build time
    (splats/packed.morton_order) for tail locality, and watch
    aux["compact_dropped"] / aux["overflowed"] — the derivations below
    keep both at 0 on every scale measured (200K/1M/10M at 1080p, 10M at
    4K); a loud nonzero means a scene shape outside the measured envelope
    and a wider keep/budget.
    """
    res_scale = max(width / 1920.0, height / 1088.0, 1.0)
    budget = math.ceil(4 * res_scale)
    # keep = row live mean + >5 sigma over 512-slot rows. In converged
    # mode the 256-block prune sampler (tiles.depth_prune_cutkeys) lands
    # the kept volume at its target (~0.94M pairs at 10M splats = mean
    # 12/row, sigma 3.5): keep 32 holds at +5.7 sigma. The non-converged
    # mode prunes at safety 2.0 (higher live fraction): keep 48. Small
    # scenes keep a larger fraction (prune is per-tile): 192.
    if n_splats >= 2_000_000:
        compact = 32 if converged else 48
    else:
        compact = 192
    cfg = dict(
        tile_h=16, tile_w=128, backend="pallas",
        max_splats_per_tile=384,
        max_tiles_per_splat=budget,
        splat_chunk=128,
        quantized_depth_sort=True,
        sort_compact_keep_cols=compact,
        big_splat_budget=16,
        big_splat_keep_cols=128,
        deepening_passes=6,
        deepening_fraction=0.34,
        compact_row_len=512,
        depth_prune_cap=384,
    )
    if converged:
        cfg.update(
            # Head slab 256 (vs the non-converged 384): head depth is
            # parity-FLAT (a slab sweep 128->768 moved the 1M parity p99
            # by nothing — the envelope is tail-sampling-bound, see
            # ARCHITECTURE.md).
            max_splats_per_tile=256,
            depth_prune_cap=256,
            depth_prune_safety=1.2,
            tail_mode="banded",
            tail_bands=8,
            tail_block=(16, 16),
            # Depth bands are assigned per 16384 Morton-ordered splats.
            tail_chunk=16384,
            # The head's exact quad clip in the tail too: semantically
            # faithful to the reference's quad-bounded fragments. It does
            # not move the parity gate's p99 (ARCHITECTURE.md).
            tail_exact_clip=True,
        )
    else:
        cfg.update(depth_prune_safety=2.0)
    cfg.update(overrides)
    return RenderConfig(**cfg)
