"""The production render pipeline: project -> bin -> sort -> composite.

This replaces the reference's per-frame critical path (SURVEY.md section
3.3): instead of a host loop computing sort keys, two host->device uploads,
8 radix passes with full memory barriers, and an instanced draw, the whole
frame is one jit: every stage is on device and the composite runs per image
tile with only the splats that touch it.

Two composite backends with identical semantics:
  * "xla"    — pure jnp fixed-capacity compositor (correctness baseline)
  * "pallas" — the depth-slab compositor of ops/composite_pallas.py (plus
               the banded tail of ops/tail_pallas.py); `composite_impl` and
               `tail_impl` pick their Triton kernels or the plain XLA
               references

The pipeline is differentiable end to end: binning/sorting produce integer
plumbing (no gradient needed, matching the non-differentiability of a
discrete ordering), while alpha/color/transmittance math carries gradients
to every splat parameter.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from fourdgs.core.camera import Camera
from fourdgs.render.project import (Projected, project_components,
                                    project_splats)
from fourdgs.render.sort import front_to_back_order
from fourdgs.render.tiles import (TILE_H, TILE_W, assemble_image, bin_splats,
                                  tile_grid, tile_pixel_ndc)
from fourdgs.splats.gaussians import (Splats3D, Splats4D,
                                      mean_in_time_sortkey)

ALPHA_MAX = 1.0 - 1e-6


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static pipeline configuration (hashable; safe as a jit static arg)."""
    tile_h: int = TILE_H
    tile_w: int = TILE_W
    max_tiles_per_splat: int = 16   # pair budget per splat (bbox tiles)
    max_splats_per_tile: int = 1024  # per-tile composite capacity
    splat_chunk: int = 64            # composite chunk (scan step) size
    backend: str = "xla"             # "xla" | "pallas"
    # Slab compositor and tail implementations (backend="pallas"):
    # "triton" runs the Pallas kernels (compiled on the GPU, interpreted on
    # the CPU), "xla" the plain references they are checked against.
    composite_impl: str = "triton"
    tail_impl: str = "triton"
    background: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    # 10M+ fast path: fused (tile | quantized-depth) single-key sort instead
    # of exact argsort + permutation (see render/tiles.py). Exact ordering
    # differences are below visual precision; tests use the exact path.
    quantized_depth_sort: bool = False
    # Pair compaction ahead of the global sort (quantized path only): a
    # batched row sort over strided rows of compact_row_len slots pushes
    # dead pair slots to row tails; keep this many columns of each row
    # (0 = off). Size it at live_fraction * compact_row_len + margin;
    # dropped live pairs are counted in aux["compact_dropped"] — keep it 0.
    sort_compact_keep_cols: int = 0
    compact_row_len: int = 8192
    # Two-tier pair emission (quantized path): splats whose bbox spans more
    # than max_tiles_per_splat tiles are compacted (fixed capacity
    # big_splat_keep_cols per 8192-wide row) and re-emitted with this slot
    # budget (0 = off). Kills pair-budget overflow without paying a larger
    # budget for every splat.
    big_splat_budget: int = 0
    big_splat_keep_cols: int = 128
    # Progressive deepening (pallas backend): composite depth slabs of
    # max_splats_per_tile, then re-composite ONLY still-unsaturated tiles
    # with the next slab (carrying rgb/alpha/transmittance). Bounds memory
    # and gather traffic by actual per-pixel depth complexity instead of a
    # hard truncation. passes=1 == plain fixed-capacity behavior.
    deepening_passes: int = 1
    deepening_fraction: float = 0.25  # static budget of tiles per deep pass
    # Optional static per-pass slab sizes for the deepening passes
    # (len == deepening_passes - 1). One big second slab instead of many
    # uniform ones pays the per-pass selection/gather/scatter overhead once
    # (the 10M bench: 5 x 512 re-gathers -> 1 x 2560). () = uniform slabs.
    deepening_schedule: Tuple[int, ...] = ()
    # Per-tile depth pruning (quantized, single-chip): drop pairs deeper
    # than ~depth_prune_safety x this cap per tile before the sort. Set to
    # the maximum composited depth (max_splats_per_tile * deepening_passes);
    # 0 = off. aux["prune_underkeep"] verifies the statistical guarantee.
    depth_prune_cap: int = 0
    depth_prune_safety: float = 2.0
    # Streaming banded-OIT tail (ops/tail_pallas.py): "banded" composites
    # EVERY pair beyond the per-tile cut — the exact complement of the
    # head — at coarse resolution with depth-band ordering, closing the
    # depth-cap truncation gap vs the reference's blend-everything
    # pipeline. Requires backend="pallas", quantized sort, and
    # depth_prune_cap > 0 (the prune pre-filters; the post-sort
    # tie-exclusive re-cut then bounds the head at <= max_splats_per_tile
    # nearest pairs, so pass 1 composites the whole head). Splats should
    # be in Morton order (scene-build reorder, splats/packed.morton_order)
    # for the kernel's screen-tile locality; correctness does not depend
    # on it.
    tail_mode: str = "off"          # "off" | "banded"
    tail_bands: int = 8             # depth bands (ordered; OIT within)
    tail_block: Tuple[int, int] = (8, 8)   # coarse px block (y, x)
    tail_chunk: int = 2048          # splats per depth-band assignment
    # Apply the head's exact |n| <= 0.5 quad clip in the tail kernel too
    # (reference: fragments only exist inside the quad,
    # Splat4DVertexShaderInstanced.GLSL:145-147). Without it the tail
    # integrates each splat's w in [1e-4, 3.4e-4) fringe OUTSIDE the quad
    # over ~1000 pairs/pixel — measured as the dominant term of the 1M
    # parity gate's p99 (round 5).
    tail_exact_clip: bool = False


def _pad_pairs(pair_splat: jax.Array, m: int) -> jax.Array:
    """Append m dead entries so every dynamic slice [start, start+m) is in
    range (tile_start <= P always)."""
    return jnp.concatenate([pair_splat, jnp.zeros((m,), pair_splat.dtype)])


def _gather_pair_rows(pair_padded: jax.Array, starts: jax.Array, m: int):
    """(T,) starts -> (T, m) contiguous windows of the sorted pair array.

    vmap-of-dynamic_slice lowers to a gather with slice_sizes=(m,) —
    contiguous row reads — instead of T*m independent element gathers."""
    def row(s):
        return jax.lax.dynamic_slice_in_dim(pair_padded, s, m)
    return jax.vmap(row)(starts)


def _gather_tile_lists(proj: Projected, binning, cfg: RenderConfig,
                       num_tiles: int):
    """Fixed-capacity per-tile splat lists from the CSR pair arrays.

    Returns (tile_splat_idx (T, M) int32, tile_live (T, M) bool). Tiles with
    more than M splats are truncated at M — the M nearest splats win, which
    is the correct approximation direction for front-to-back compositing.
    """
    m = cfg.max_splats_per_tile
    starts = binning.tile_start[:-1]                      # (T,)
    counts = binning.tile_start[1:] - starts              # (T,)
    tile_splat = _gather_pair_rows(_pad_pairs(binning.pair_splat, m),
                                   starts, m)             # (T, M)
    live = jnp.arange(m, dtype=jnp.int32)[None, :] < counts[:, None]
    return tile_splat, live


def _composite_tiles_xla(proj: Projected, tile_splat: jax.Array,
                         tile_live: jax.Array, px: jax.Array, py: jax.Array,
                         p00, p11, background: jax.Array,
                         chunk: int, return_resid: bool = False):
    """Pure-XLA per-tile ordered composite.

    tile_splat (T, M) indexes into proj fields; px/py (T, P) NDC pixel
    coords. Scan over M in chunks with per-pixel running log-transmittance;
    within a chunk the ordered blend is an exclusive cumsum. Returns
    (T, P, 4).
    """
    t_tiles, m = tile_splat.shape
    p = px.shape[1]
    dtype = px.dtype

    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    if pad:
        tile_splat = jnp.pad(tile_splat, ((0, 0), (0, pad)))
        tile_live = jnp.pad(tile_live, ((0, 0), (0, pad)))
    tile_splat = tile_splat.reshape(t_tiles, n_chunks, chunk)
    tile_live = tile_live.reshape(t_tiles, n_chunks, chunk)

    # Per-splat fields stay separate 1-D (N,) arrays ("scalar SoA" — see the
    # layout note in render/project.py); each chunk gathers what it needs.
    a_eff = proj.opacity * proj.a * proj.valid.astype(dtype)

    def step(carry, inputs):
        rgb_acc, a_acc, log_t = carry
        sidx, live = inputs                       # (T, C), (T, C)
        take = lambda f: f[sidx][..., None]       # (T, C, 1)
        dx = (px[:, None, :] - take(proj.mx)) / p00  # (T, C, P)
        dy = (py[:, None, :] - take(proj.my)) / p11
        v0x, v0y = take(proj.v0x), take(proj.v0y)
        k0 = v0x * dx + v0y * dy
        k1 = v0y * dx - v0x * dy
        n0 = k0 / take(proj.l0)
        n1 = k1 / take(proj.l1)
        q = 64.0 * (n0 * n0 + n1 * n1)
        w = jnp.exp(-0.5 * q)
        cover = (jnp.abs(n0) <= 0.5) & (jnp.abs(n1) <= 0.5) & (w >= 1e-4)
        gate = (cover & live[..., None]).astype(dtype)
        alpha = jnp.clip(take(a_eff) * w * gate, 0.0, ALPHA_MAX)
        log1m = jnp.log1p(-alpha)                 # (T, C, P)
        t_excl = jnp.exp(log_t[:, None, :] + jnp.cumsum(log1m, axis=1) - log1m)
        wgt = alpha * t_excl
        rgb_chunk = jnp.stack([proj.r[sidx], proj.g[sidx], proj.b[sidx]],
                              axis=-1)            # (T, C, 3)
        rgb_acc = rgb_acc + jnp.einsum("tcp,tcd->tpd", wgt, rgb_chunk,
                                       preferred_element_type=dtype,
                                       precision=jax.lax.Precision.HIGHEST)
        a_acc = a_acc + jnp.sum(alpha * wgt, axis=1)
        log_t = log_t + jnp.sum(log1m, axis=1)
        return (rgb_acc, a_acc, log_t), None

    init = (jnp.zeros((t_tiles, p, 3), dtype), jnp.zeros((t_tiles, p), dtype),
            jnp.zeros((t_tiles, p), dtype))
    (rgb, a, log_t), _ = jax.lax.scan(
        step, init,
        (tile_splat.transpose(1, 0, 2), tile_live.transpose(1, 0, 2)))
    t_fin = jnp.exp(log_t)
    rgb = rgb + t_fin[..., None] * background[:3]
    a = a + t_fin * background[3]
    tiles = jnp.concatenate([rgb, a[..., None]], axis=-1)
    if return_resid:
        return tiles, t_fin
    return tiles


def render_projected(proj: Projected, camera: Camera,
                     cfg: RenderConfig = RenderConfig(),
                     p00=None, p11=None, return_aux: bool = False):
    """Tile-binned render of already-projected splats. Returns (H, W, 4),
    or (image, aux) with return_aux — aux surfaces the binning health
    counters (pair-budget overflow, live pair count, deepest tile) so
    callers can assert/log instead of silently truncating.

    p00/p11 override the projection diagonal for paths with a non-standard
    pixel->k mapping (the 2D screen-space scene)."""
    dtype = proj.mx.dtype
    pmat = camera.proj_matrix().astype(dtype)
    if p00 is None:
        p00, p11 = pmat[0, 0], pmat[1, 1]
    w, h = camera.width, camera.height

    ny0, nx0 = tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    tile_limit = (1 << 11) - 1
    use_quant = cfg.quantized_depth_sort
    if not use_quant:
        order = front_to_back_order(proj.depth)
        proj = jax.tree_util.tree_map(lambda a: a[order], proj)

    # Tile-row banding: the quantized key packs an 11-bit tile id; images
    # beyond 2047 tiles (4K at 16x128 = 4050) render as ceil-split bands
    # of tile rows, each band running the whole fast path with
    # band-relative ids (VERDICT r3 #4: the path used to refuse and fall
    # back to the ~1 s exact sort).
    if use_quant and ny0 * nx0 >= tile_limit:
        rows_per_band = max(1, tile_limit // nx0)
        n_bands = -(-ny0 // rows_per_band)
    else:
        rows_per_band, n_bands = ny0, 1

    px, py, _ = tile_pixel_ndc(w, h, cfg.tile_h, cfg.tile_w, dtype)
    bg = jnp.asarray(cfg.background, dtype)

    band_tiles, band_resid, band_aux = [], [], []
    for b in range(n_bands):
        lo_row = b * rows_per_band
        nb = min(rows_per_band, ny0 - lo_row)
        band = None if n_bands == 1 else (lo_row, nb)
        # named_scope markers segment jax.profiler traces by stage.
        with jax.named_scope("bin_sort"):
            binning = bin_splats(
                proj, p00, p11, w, h,
                tile_h=cfg.tile_h, tile_w=cfg.tile_w,
                max_tiles_per_splat=cfg.max_tiles_per_splat,
                quantized_depth=use_quant,
                compact_keep_cols=(cfg.sort_compact_keep_cols
                                   if use_quant else 0),
                big_splat_budget=cfg.big_splat_budget,
                big_splat_keep_cols=cfg.big_splat_keep_cols,
                compact_row_len=cfg.compact_row_len,
                depth_prune_cap=cfg.depth_prune_cap,
                depth_prune_safety=cfg.depth_prune_safety,
                head_cap=(cfg.max_splats_per_tile
                          if cfg.tail_mode == "banded" else 0),
                tile_row_band=band)
        px_b = px[lo_row * nx0:(lo_row + nb) * nx0]
        py_b = py[lo_row * nx0:(lo_row + nb) * nx0]
        counts = binning.tile_start[1:] - binning.tile_start[:-1]
        with jax.named_scope("composite"):
            if cfg.backend == "pallas":
                tiles, resid = _composite_pallas_progressive(
                    proj, binning, px_b, py_b, p00, p11, bg, cfg,
                    return_resid=True, image_size=(w, h),
                    tile_row_band=band)
            else:
                tile_splat, tile_live = _gather_tile_lists(
                    proj, binning, cfg, nb * nx0)
                tiles, t_fin = _composite_tiles_xla(
                    proj, tile_splat, tile_live, px_b, py_b, p00, p11, bg,
                    cfg.splat_chunk, return_resid=True)
                truncated = counts > cfg.max_splats_per_tile
                if binning.tile_pruned is not None:
                    # Pairs dropped by the depth prune are truncation
                    # error too: a pruned tile reports its residual even
                    # when the kept list fits the capacity exactly
                    # (ADVICE r3: boundary gap).
                    truncated = truncated | binning.tile_pruned
                resid = t_fin * truncated[:, None]
        band_tiles.append(tiles)
        band_resid.append(jnp.max(resid))
        band_aux.append((binning, counts))

    tiles = (band_tiles[0] if n_bands == 1
             else jnp.concatenate(band_tiles, axis=0))
    img = assemble_image(tiles, w, h, cfg.tile_h, cfg.tile_w)
    if not return_aux:
        return img
    binnings = [b for b, _ in band_aux]
    aux = {
        "overflowed": sum(b.overflowed for b in binnings),
        "live_pairs": sum(b.tile_start[-1] for b in binnings),
        "max_tile_pairs": jnp.max(jnp.stack(
            [jnp.max(c) for _, c in band_aux])),
        # Per-pixel error bound on tile-capacity truncation: the remaining
        # transmittance of any tile whose pair list was truncated bounds
        # the total contribution of every dropped pair (sum of dropped
        # alpha*T <= T at truncation). 0 == the image is exact w.r.t.
        # per-tile capacity; goldens assert this stays < tolerance so
        # binning/bbox changes cannot silently re-pin truncation artifacts
        # (round-2 regression: see VERDICT.md weak #1/#2).
        "resid_transmittance": jnp.max(jnp.stack(band_resid)),
    }
    if binnings[0].compact_dropped is not None:
        aux["compact_dropped"] = sum(b.compact_dropped for b in binnings)
    if binnings[0].prune_underkeep is not None:
        aux["prune_underkeep"] = sum(b.prune_underkeep for b in binnings)
    return img, aux


def _composite_pallas_progressive(proj: Projected, binning, px, py, p00, p11,
                                  background, cfg: RenderConfig,
                                  return_resid: bool = False,
                                  image_size=None, tile_row_band=None):
    """Progressive-deepening composite (pallas backend; handles passes=1).

    Pass 1 composites every tile's nearest `max_splats_per_tile` splats.
    Each further pass selects up to `deepening_fraction * T` tiles that are
    still unsaturated (max per-pixel transmittance above threshold) AND have
    splats left, gathers their next depth slab, and continues compositing
    from the carried (rgb, alpha, transmittance). A per-tile slab counter
    tracks progress, so a tile passed over in one round (budget) resumes
    where it left off in a later round. Tiles whose transmittance saturated
    are exact already (error < 1e-6); the cap only ever truncates tiles that
    stay translucent through every slab — which is why a small slab (512)
    plus a handful of passes beats one big fixed capacity: the gather
    traffic adapts to each tile's true depth complexity.
    """
    from fourdgs.ops.composite_pallas import (composite_records,
                                              identity_carry, pack_records,
                                              record_fields)
    m = cfg.max_splats_per_tile
    dtype = px.dtype
    t_tiles, p = px.shape
    starts = binning.tile_start[:-1]
    counts_full = binning.tile_start[1:] - starts
    if binning.head_counts is not None and cfg.tail_mode == "banded":
        # Post-sort re-cut: the head owns exactly these nearest pairs;
        # the banded tail owns the complement {key > prune_cut}.
        counts_full = binning.head_counts
    pair_pad = _pad_pairs(binning.pair_splat, m)
    kx = (px / p00).reshape(t_tiles, 1, p)
    ky = (py / p11).reshape(t_tiles, 1, p)
    arange_m = jnp.arange(m, dtype=jnp.int32)

    # ONE record-field matrix serves the head's strip gather AND the tail's
    # field stream.
    rec_shared = None
    if cfg.tail_mode == "banded" and binning.prune_cut is not None:
        rec_shared = record_fields(proj, p00, p11)
    composite = functools.partial(composite_records, impl=cfg.composite_impl)

    with jax.named_scope("pass1_pack"):
        rows0 = _gather_pair_rows(pair_pad, starts, m)
        live0 = arange_m[None, :] < counts_full[:, None]
        rec0 = pack_records(proj, rows0, live0, p00, p11, rec=rec_shared)
    with jax.named_scope("pass1_kernel"):
        out = composite(rec0, jnp.minimum(counts_full, m).astype(jnp.int32),
                        kx, ky, identity_carry(t_tiles, dtype, p))
    pairs_done = jnp.minimum(counts_full, m)

    t_cap = max(128, int(round(t_tiles * cfg.deepening_fraction)))
    t_cap = min(t_cap, t_tiles)
    use_tail = (cfg.tail_mode == "banded"
                and binning.prune_cut is not None)
    if use_tail:
        # The head owns exactly {key <= prune_cut}, and the post-sort
        # tie-exclusive re-cut guarantees head_counts <= max_splats_per_
        # tile — so pass 1 above already composited the ENTIRE head
        # (pairs_done == counts_full for every tile; the resid reporting
        # below would flag any violation loudly as truncation). No
        # exhaust loop is needed, which also keeps the whole tail-mode
        # forward free of lax.while_loop and therefore differentiable.
        with jax.named_scope("tail"):
            w_img, h_img = image_size
            out = _apply_banded_tail(out, proj, binning, p00, p11, cfg,
                                     w_img, h_img,
                                     tile_row_band=tile_row_band,
                                     fields=rec_shared)
        schedule = ()
    else:
        schedule = cfg.deepening_schedule or (m,) * (cfg.deepening_passes - 1)
        assert len(schedule) == cfg.deepening_passes - 1, \
            (cfg.deepening_schedule, cfg.deepening_passes)
    # Pad the slab pair array so the largest scheduled slab slices in-range.
    if schedule and max(schedule) > m:
        pair_pad = _pad_pairs(binning.pair_splat, max(schedule))
    for mi in schedule:
      with jax.named_scope(f"deepen_{mi}_select"):
        arange_mi = jnp.arange(mi, dtype=jnp.int32)
        remaining = counts_full - pairs_done
        unsat = jnp.max(out[:, 4, :], axis=1) > 1e-6
        active = unsat & (remaining > 0)
        # Deterministic top-t_cap active tiles (inactive fillers are no-ops:
        # their live mask is empty and their counter does not advance).
        order = jnp.argsort(-active.astype(jnp.int32), stable=True)
        sel = order[:t_cap]
        act = active[sel]
        base = starts[sel] + pairs_done[sel]
      with jax.named_scope(f"deepen_{mi}_pack"):
        rows = _gather_pair_rows(pair_pad, base, mi)
        off = pairs_done[sel][:, None] + arange_mi[None, :]
        live = act[:, None] & (off < counts_full[sel][:, None])
        rec = pack_records(proj, rows, live, p00, p11)
      with jax.named_scope(f"deepen_{mi}_kernel"):
        cnt = jnp.where(act,
                        jnp.clip(counts_full[sel] - pairs_done[sel], 0, mi),
                        0).astype(jnp.int32)
        # sel is a permutation prefix (entries distinct); fillers have
        # cnt 0 and write their carry back unchanged.
        out = out.at[sel].set(composite(rec, cnt, kx[sel], ky[sel], out[sel]))
        pairs_done = pairs_done.at[sel].add(jnp.where(act, cnt, 0))

    rgb = out[:, 0:3, :] + out[:, 4:5, :] * background[:3, None]
    a = out[:, 3, :] + out[:, 4, :] * background[3]
    tiles = jnp.concatenate([rgb, a[:, None, :]], axis=1).transpose(0, 2, 1)
    if return_resid:
        truncated = (counts_full - pairs_done) > 0
        if binning.tile_pruned is not None and not use_tail:
            # Depth-pruned pairs are truncation error too (ADVICE r3): a
            # pruned tile whose kept list fits the composited depth exactly
            # must still report its residual transmittance. With the banded
            # tail, pruned-away pairs are composited (not dropped), so only
            # genuine head under-exhaustion would count — and the exhaust
            # loop drives that to zero.
            truncated = truncated | binning.tile_pruned
        return tiles, out[:, 4, :] * truncated[:, None]
    return tiles


def tail_streams(proj: Projected, binning, p00, p11, cfg: RenderConfig,
                 w: int, h: int, tile_row_band=None, fields=None):
    """The tail_accumulate calls that composite every pair beyond the
    per-tile prune cut: a list of (scope name, keyword arguments), the main
    stream first and the big-splat tier (if any) second. Their summed
    accumulators form the tail field."""
    from fourdgs.ops import tail_pallas as TPL
    from fourdgs.ops.composite_pallas import record_fields
    from fourdgs.render.tiles import (quantized_depth_bits, sample_blocks,
                                      splat_tile_bbox)

    ny, nx = tile_grid(w, h, cfg.tile_h, cfg.tile_w)
    dead = jnp.iinfo(jnp.int32).max
    alive, tx0, tx1, ty0, ty1 = splat_tile_bbox(
        proj, p00, p11, w, h, cfg.tile_h, cfg.tile_w)
    ty_base = 0
    if tile_row_band is not None:
        # Band coordinates: mirror bin_splats' tile_row_band clip exactly
        # so the tail's tile ids match the band-relative cut table.
        ty_base, ny = tile_row_band
        alive = alive & (ty1 >= ty_base) & (ty0 < ty_base + ny)
        ty0 = jnp.clip(ty0 - ty_base, 0, ny - 1)
        ty1 = jnp.clip(ty1 - ty_base, 0, ny - 1)
    dbits = quantized_depth_bits(proj.depth)
    if fields is None:
        fields = record_fields(proj, p00, p11)             # (10, N)

    # Global depth-band cuts from a contiguous-block subsample of live
    # depth bits (the first 128 of every 8192).
    n = dbits.shape[0]
    db_live = jnp.where(alive, dbits, dead)
    if n >= 16384:
        db_live = sample_blocks(db_live, stride=8192, take=128)
    band_cuts = TPL.global_band_cuts(db_live, cfg.tail_bands)

    # Affine sample-coordinate params (k units; see tail_pallas docstring;
    # ty_base folds the tile-row band's pixel offset into the constants).
    by, bx = cfg.tail_block
    s_cy, s_cx = cfg.tile_h // by, cfg.tile_w // bx
    assert s_cy * by == cfg.tile_h and s_cx * bx == cfg.tile_w, \
        (cfg.tail_block, cfg.tile_h, cfg.tile_w)
    common = dict(
        cut=binning.prune_cut,
        params_row=TPL.tail_params_row(cfg.tile_h, cfg.tile_w,
                                       cfg.tail_block, w, h, p00, p11,
                                       ty_base),
        k_bands=cfg.tail_bands, nx=nx, ny=ny, s_cy=s_cy, s_cx=s_cx,
        exact_clip=cfg.tail_exact_clip)

    chunk = cfg.tail_chunk
    # ONE raw meta array (budget windows applied per stream) serves the
    # main stream, the banding, and the big-tier gather.
    meta = TPL.tail_meta(alive, tx0, tx1, ty0, ty1, dbits, chunk)
    band = TPL.step_bands(meta, chunk, band_cuts, 0, cfg.max_tiles_per_splat)
    streams = [("tail_main", dict(
        common, fields=fields, meta=meta, band=band, chunk=chunk,
        budget=cfg.max_tiles_per_splat))]

    if binning.big_ids is not None:
        # Big-tier stream: the kept wide-span splat ids re-walked with the
        # big budget window (exactly the head's big tier). The id list is
        # tiny after the second-level compaction, so two row gathers
        # (fields, meta) are cheap.
        ids = binning.big_ids
        safe = jnp.minimum(ids, n - 1)
        meta_b = jnp.where((ids == dead)[None, :], 0, meta[:, safe])
        chunk_b = min(512, _ceil8(ids.shape[0]))
        npad = -(-ids.shape[0] // chunk_b) * chunk_b
        meta_b = jnp.pad(meta_b, ((0, 0), (0, npad - ids.shape[0])))
        band_b = TPL.step_bands(meta_b, chunk_b, band_cuts,
                                cfg.max_tiles_per_splat, cfg.big_splat_budget)
        streams.append(("tail_big", dict(
            common, fields=fields[:, safe], meta=meta_b, band=band_b,
            chunk=chunk_b, budget=cfg.big_splat_budget,
            budget_lo=cfg.max_tiles_per_splat)))
    return streams


def _apply_banded_tail(out, proj: Projected, binning, p00, p11,
                       cfg: RenderConfig, w: int, h: int,
                       tile_row_band=None, fields=None):
    """Composite every pair beyond the per-tile prune cut into the carry.

    Streams the full splat set through the banded-OIT coarse tail
    (ops/tail_pallas.py — zero sorting, zero gathers), folds the K ordered
    depth bands, bilinearly upsamples the coarse tail field, and blends it
    under the head's per-pixel transmittance. `out` is the (T, 8, P) head
    carry (pre-background); returns the updated carry."""
    from fourdgs.ops import tail_pallas as TPL

    acc = 0.0
    for scope, kw in tail_streams(proj, binning, p00, p11, cfg, w, h,
                                  tile_row_band, fields):
        with jax.named_scope(scope):
            acc = acc + TPL.tail_accumulate(**kw, impl=cfg.tail_impl)
    ny, nx = kw["ny"], kw["nx"]
    s_cy, s_cx = kw["s_cy"], kw["s_cx"]
    k_bands = cfg.tail_bands
    dtype = out.dtype

    # Fold bands, upsample the coarse tail field, blend under T_head.
    with jax.named_scope("tail_combine"):
        upt = TPL.fold_upsample_tail(acc, k_bands, nx, ny, cfg.tile_h,
                                     cfg.tile_w, s_cy, s_cx, dtype)
        blended = TPL.blend_tail_under_head(out, upt)
        return jnp.concatenate([blended, out[:, 5:8, :]], axis=1)


def _ceil8(x: int) -> int:
    return -(-x // 8) * 8


def _composite_pairrec_progressive(rec_pairs: jax.Array, tile_start: jax.Array,
                                   px, py, p00, p11, background,
                                   cfg: RenderConfig, head_counts=None,
                                   return_carry: bool = False):
    """Progressive slab composite straight from a tile-major sorted
    pair-record array (P, N_FIELDS) — records are CONTIGUOUS per tile, so
    every slab load is a dynamic row slice: no random gather at all. This
    is the compositor of the all_to_all sharded path, whose exchange
    delivers records already in pair order.

    Same per-tile slab-counter deepening as _composite_pallas_progressive.
    """
    from fourdgs.ops.composite_pallas import (N_FIELDS, composite_records,
                                              identity_carry)
    m = cfg.max_splats_per_tile
    dtype = px.dtype
    t_tiles, p = px.shape
    starts = tile_start[:-1]
    counts_full = tile_start[1:] - starts
    if head_counts is not None:
        # Post-sort re-cut (distributed tail mode): the head owns exactly
        # these nearest pairs; the banded tail composites the rest.
        counts_full = head_counts
    rec_pad = jnp.concatenate(
        [rec_pairs, jnp.zeros((m, N_FIELDS), rec_pairs.dtype)], axis=0)
    kx = (px / p00).reshape(t_tiles, 1, p)
    ky = (py / p11).reshape(t_tiles, 1, p)
    arange_m = jnp.arange(m, dtype=jnp.int32)

    def slab_recs(base, live):
        """(T_sel,) row starts -> (T_sel, N_FIELDS, m) kernel records;
        `live` masks contiguous-array bleed into the next tile's records."""
        rows = jax.vmap(
            lambda s: jax.lax.dynamic_slice(rec_pad, (s, 0),
                                            (m, N_FIELDS)))(base)
        rows = rows * live[..., None].astype(rows.dtype)
        return jnp.swapaxes(rows, 1, 2)

    live0 = arange_m[None, :] < counts_full[:, None]
    rec0 = slab_recs(starts, live0)
    composite = functools.partial(composite_records, impl=cfg.composite_impl)
    out = composite(rec0, jnp.minimum(counts_full, m).astype(jnp.int32),
                    kx, ky, identity_carry(t_tiles, dtype, p))
    slab_done = jnp.ones((t_tiles,), jnp.int32)

    t_cap = min(t_tiles, max(128, int(round(t_tiles * cfg.deepening_fraction))))
    for _ in range(1, cfg.deepening_passes):
        remaining = counts_full - slab_done * m
        unsat = jnp.max(out[:, 4, :], axis=1) > 1e-6
        active = unsat & (remaining > 0)
        order = jnp.argsort(-active.astype(jnp.int32), stable=True)
        sel = order[:t_cap]
        act = active[sel]
        base = starts[sel] + slab_done[sel] * m
        off = slab_done[sel][:, None] * m + arange_m[None, :]
        live = act[:, None] & (off < counts_full[sel][:, None])
        rec = slab_recs(base, live)
        cnt = jnp.where(act,
                        jnp.clip(counts_full[sel] - slab_done[sel] * m, 0, m),
                        0).astype(jnp.int32)
        out_s = composite(rec, cnt, kx[sel], ky[sel], out[sel])
        out = out.at[sel].set(out_s)
        slab_done = slab_done.at[sel].add(act.astype(jnp.int32))

    if return_carry:
        return out
    rgb = out[:, 0:3, :] + out[:, 4:5, :] * background[:3, None]
    a = out[:, 3, :] + out[:, 4, :] * background[3]
    return jnp.concatenate([rgb, a[:, None, :]], axis=1).transpose(0, 2, 1)


# ---------------------------------------------------------------------------
# high-level entries (mirror render/dense.py signatures)
# ---------------------------------------------------------------------------

def render_splats3d(splats: Splats3D, camera: Camera,
                    opacity: Optional[jax.Array] = None,
                    sort_mean3: Optional[jax.Array] = None,
                    cfg: RenderConfig = RenderConfig(),
                    return_aux: bool = False):
    dtype = splats.position.dtype
    op = jnp.ones((splats.count,), dtype) if opacity is None else opacity
    proj = project_splats(splats.position, splats.cov, splats.color, op,
                          camera, sort_mean3=sort_mean3)
    return render_projected(proj, camera, cfg, return_aux=return_aux)


def render_splats2d(splats, camera: Camera,
                    cfg: RenderConfig = RenderConfig()) -> jax.Array:
    """Tiled render of the 2D screen-space workload (Scenes.h:1443-1610).

    Unsorted painter order over the splat list (the 2D scene never sorts);
    front-to-back = reversed index order, expressed through the depth keys
    so the pipeline's ordering machinery applies unchanged."""
    from fourdgs.render.dense import project_splats2d
    proj, p00e, p11e = project_splats2d(splats, camera)
    n = proj.count
    # Painter order == index order (the 2D scene draws unsorted): ascending
    # keys in index order, reversed by the pipeline for front-to-back.
    proj = dataclasses.replace(
        proj, depth=jnp.arange(n, dtype=proj.mx.dtype))
    return render_projected(proj, camera, cfg, p00=p00e, p11=p11e)


def render_splats4d(splats: Splats4D, camera: Camera, t,
                    min_opacity=0.0,
                    cfg: RenderConfig = RenderConfig(),
                    return_aux: bool = False):
    """The flagship path: 4D slice + EWA + tiled ordered composite, one jit,
    zero host round trips. For 10M+ splats use render_params4d_packed,
    which never materializes (N, 4, 4) covariance tensors."""
    sliced, top = splats.at_time(t, min_opacity)
    sort_mean = mean_in_time_sortkey(splats.position, splats.cov, t)
    return render_splats3d(sliced, camera, opacity=top, sort_mean3=sort_mean,
                           cfg=cfg, return_aux=return_aux)


def render_params4d_packed(params: dict, camera: Camera, t, min_opacity=0.0,
                           cfg: RenderConfig = RenderConfig(),
                           return_aux: bool = False):
    """Production-scale flagship path on the packed scalar-SoA
    parameterization (splats/packed.py): covariance construction, temporal
    slicing and EWA all fuse into one elementwise pass — nothing with a tiny
    trailing dim is ever materialized. `params` is a dict of (N,) component
    arrays (PARAM4D_FIELDS)."""
    from fourdgs.splats import packed as PK
    with jax.named_scope("project"):
        cov4 = PK.cov4_motion(params)
        mx, my, mz, cov3, opacity, sort_mean = PK.slice4d(params, cov4, t,
                                                          min_opacity)
        colors = (params["cr"], params["cg"], params["cb"], params["ca"])
        proj = project_components(mx, my, mz, cov3, colors, opacity, camera,
                                  sort_mean=sort_mean)
    return render_projected(proj, camera, cfg, return_aux=return_aux)
