"""Tile binning: map each projected splat to the image tiles it covers.

Replaces the GL rasterizer's implicit scatter of quads to pixels. The image is divided into TILE_H x TILE_W pixel tiles; each splat's
rasterized-quad bounding box (Projected.half_extent_ndc) selects a rectangle
of tiles. Because XLA needs static shapes, each splat emits a fixed budget of
(tile, splat) pairs (`max_tiles_per_splat`); splats whose bbox covers more
tiles contribute their top-left `max_tiles_per_splat` rectangle and the
overflow count is reported so callers can widen the budget. Pairs are then
key-sorted by (tile_id, front-to-back order) with a single fused on-device
`lax.sort` — this replaces the reference's CPU key loop + GPU radix sort
round trip (Scenes.h:312-328, GPU_RADIX_SORT/radix_sort.hpp:258-389).

The per-tile contiguous ranges (CSR offsets) are recovered with a
searchsorted over the sorted tile ids.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from fourdgs.render.project import Projected

TILE_H = 32
TILE_W = 32


def tile_grid(width: int, height: int, tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Number of tiles (ny, nx) covering a width x height image (padded up)."""
    return (-(-height // tile_h), -(-width // tile_w))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TileBinning:
    """Sorted (tile, splat) pair lists + CSR offsets.

    pair_splat:  (P,) int32 splat index per pair, sorted by (tile, depth order)
    pair_tile:   (P,) int32 tile id per pair (ny*nx for invalid/padding pairs)
    tile_start:  (T+1,) int32 CSR offsets into the pair arrays
    overflowed:  () int32 number of splats whose bbox exceeded the pair budget
    """
    pair_splat: jax.Array
    pair_tile: jax.Array
    tile_start: jax.Array
    overflowed: jax.Array
    # live pairs lost to the compaction column cap (None when compaction is
    # off); callers surface it via aux — never silently nonzero.
    compact_dropped: jax.Array | None = None
    # depth pruning's statistical guarantee, verified: tiles that were
    # pruned (finite cut key) yet ended with fewer pairs than the composite
    # cap (None when pruning is off); callers surface it — never silently
    # nonzero.
    prune_underkeep: jax.Array | None = None
    # (T,) bool: tiles whose pair list was cut by the depth prune (finite
    # cut key). Compositors OR this into the truncation mask so a tile
    # left with exactly the composite capacity still reports its residual
    # transmittance (pairs dropped by the prune are truncation error too).
    tile_pruned: jax.Array | None = None
    # (T,) int32 per-tile prune cut keys (None when pruning is off): the
    # head/tail partition boundary — the banded-OIT tail compositor
    # (ops/tail_pallas.py) takes exactly the complement {key > cut}.
    prune_cut: jax.Array | None = None
    # (T,) int32 per-tile head pair counts under the post-sort re-cut
    # (None unless head_cap was given): the head composites exactly this
    # many nearest pairs per tile; everything beyond (kept OR pruned) has
    # key > prune_cut and belongs to the tail.
    head_counts: jax.Array | None = None
    # (big_splat_keep_cols,) int32 kept big-tier splat ids (INT32_MAX for
    # empty capacity slots; None when the two-tier emission is off). The
    # tail compositor's big stream re-walks exactly these ids.
    big_ids: jax.Array | None = None


QUANT_DEPTH_BITS = 20

COMPACT_ROW_LEN = 8192  # default row length of the pair compaction
DEAD = jnp.iinfo(jnp.int32).max


def compact_pairs(key: jax.Array, val: jax.Array, dead: int, keep_cols: int,
                  row_len: int = COMPACT_ROW_LEN):
    """Shrink a mostly-dead pair array before the global sort.

    The pair arrays have a fixed slot budget (max_tiles_per_splat * N) but
    few slots are live after the depth prune, and the global kv `lax.sort`
    pays for every dead slot. A batched sort of rows of `row_len` slots
    pushes every row's dead slots (key == dead sentinel = int32 max) to its
    tail; keeping the first `keep_cols` columns then drops almost only dead
    slots. Rows are STRIDED views of the flat array (element i of row r is
    key[i * rows + r]) so each row samples splats uniformly across the
    whole range and across bbox slots — row liveness concentrates around
    the global live fraction even for spatially-ordered splat lists (a
    contiguous split would let one model region saturate a row).

    Returns flat (key_kept, val_kept, dropped): dropped counts LIVE pairs
    lost to the cap — callers must surface it (aux) and size keep_cols so
    it is 0 in practice (row live mean + ~6 binomial sigma).
    """
    s = key.shape[0]
    rows = -(-s // row_len)
    row_len = -(-s // rows)
    pad = rows * row_len - s
    if pad:
        key = jnp.concatenate([key, jnp.full((pad,), dead, key.dtype)])
        val = jnp.concatenate([val, jnp.zeros((pad,), val.dtype)])
    kr = key.reshape(row_len, rows).T
    vr = val.reshape(row_len, rows).T
    ks, vs = jax.lax.sort((kr, vr), dimension=1, num_keys=1, is_stable=False)
    if keep_cols >= row_len:
        # Nothing to drop; pad columns up (small scenes where the caller's
        # keep_cols exceeds the row length).
        cpad = keep_cols - row_len
        dropped = jnp.int32(0)
        ks = jnp.concatenate(
            [ks, jnp.full((rows, cpad), dead, ks.dtype)], axis=1)
        vs = jnp.concatenate([vs, jnp.zeros((rows, cpad), vs.dtype)], axis=1)
    else:
        dropped = jnp.sum(ks[:, keep_cols:] != dead)
        ks = ks[:, :keep_cols]
        vs = vs[:, :keep_cols]
    return ks.reshape(-1), vs.reshape(-1), dropped


def sample_blocks(x: jax.Array, stride: int, take: int) -> jax.Array:
    """Evenly spaced contiguous-block subsample of a 1-D array: the first
    `take` elements of every whole `stride`-element window."""
    nb = max(1, x.shape[0] // stride)
    return x[:nb * stride].reshape(nb, -1)[:, :take].reshape(-1)


def apply_cutkeys(key: jax.Array, cut: jax.Array) -> jax.Array:
    """Depth prune: keys deeper than their tile's cut (key > cut[key >> 20])
    become DEAD; DEAD keys stay DEAD."""
    tile = jnp.clip(key >> QUANT_DEPTH_BITS, 0, cut.shape[0] - 1)
    return jnp.where(key <= cut[tile], key, DEAD)


def compact_flag_ids(flag: jax.Array, blk: int = 1024, hot_cap: int = 1024,
                     keep: int = 24):
    """Compact the indices of a SPARSE boolean flag via hot-block
    two-level extraction.

    The big-splat tier needs {i : flag[i]} for a population of ~100-1000
    out of 10M+; a direct compact_pairs row-sort over all N costs a full
    10M-slot sort to find them. Instead:
    (1) one cheap any() reduction over contiguous `blk`-blocks, (2) a
    tiny sort compacts the <= hot_cap flagged block ids, (3) a vmapped
    contiguous-slice gather pulls just those blocks (hot_cap * blk
    elements), (4) compact_pairs runs on that small volume. Flagged ids
    beyond capacity — blocks past hot_cap or per-row keep overflow —
    are counted in `dropped`, never silent.

    Returns (ids, dropped): ids is a (hot_cap * blk // COMPACT_ROW_LEN *
    keep,) int32 array of flagged indices (dead = int32 max sentinel in
    unused capacity). Requires flag.shape[0] % blk == 0."""
    n = flag.shape[0]
    assert n % blk == 0, (n, blk)
    dead = jnp.iinfo(jnp.int32).max
    iota = jnp.arange(n, dtype=jnp.int32)
    fkey = jnp.where(flag, iota, dead)
    nb = n // blk
    hot = jnp.any(flag.reshape(nb, blk), axis=1)
    hot_cap = min(nb, hot_cap)
    hkey = jnp.where(hot, jnp.arange(nb, dtype=jnp.int32), dead)
    sel = jax.lax.sort(hkey, is_stable=False)[:hot_cap]
    miss = sel == dead
    starts = jnp.minimum(sel, nb - 1) * blk
    seg = jax.vmap(
        lambda s0: jax.lax.dynamic_slice_in_dim(fkey, s0, blk))(starts)
    seg = jnp.where(miss[:, None], dead, seg).reshape(-1)
    ids, _, dropped = compact_pairs(seg, seg, dead, keep)
    # Flagged ids in blocks past hot_cap were never gathered: loud.
    dropped = dropped + (jnp.sum(flag) - jnp.sum(seg != dead))
    return ids, dropped


def splat_tile_bbox(proj: Projected, p00, p11, width: int, height: int,
                    tile_h: int, tile_w: int):
    """Per-splat tile-space bbox + liveness: (alive, tx0, tx1, ty0, ty1).
    Shared by the single-chip binner and the distributed pair router."""
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    hx_ndc, hy_ndc = proj.half_extent_ndc(p00, p11)
    cx = (proj.mx + 1.0) * 0.5 * width       # pixels
    cy = (1.0 - proj.my) * 0.5 * height      # row 0 = top
    hx = hx_ndc * 0.5 * width
    hy = hy_ndc * 0.5 * height
    tx0 = jnp.clip(jnp.floor((cx - hx) / tile_w), 0, nx - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor((cx + hx) / tile_w), 0, nx - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor((cy - hy) / tile_h), 0, ny - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor((cy + hy) / tile_h), 0, ny - 1).astype(jnp.int32)
    on_screen = ((cx + hx >= 0) & (cx - hx <= width) &
                 (cy + hy >= 0) & (cy - hy <= height))
    return proj.valid & on_screen, tx0, tx1, ty0, ty1


def _emit_pair_slots(alive, tx0, tx1, ty0, ty1, nx, num_tiles: int,
                     max_tiles_per_splat: int, tile_range=None,
                     splat_ids=None):
    """Fixed-budget (tile, splat) pair emission, slot-major.

    Returns (tids, lives, splat_idx, overflowed): per-slot lists of (N,)
    tile ids (num_tiles for dead) and live masks, the concatenated (S*N,)
    splat index array, and the count of splats whose bbox exceeded the
    budget. `splat_ids` overrides the emitted splat indices (the big-splat
    tier emits for a compacted id subset).

    LAYOUT: slot-major — one (N,) array per slot, concatenated. Each
    slot's arrays are elementwise in the splat, so they fuse into the
    projection pass.
    """
    n = alive.shape[0]
    nx_span = tx1 - tx0 + 1
    ny_span = ty1 - ty0 + 1
    span = nx_span * ny_span
    overflowed = jnp.sum((span > max_tiles_per_splat) & alive)

    idx1 = (jnp.arange(n, dtype=jnp.int32) if splat_ids is None
            else splat_ids.astype(jnp.int32))
    # Walk the bbox rectangle with CARRIED (sx, sy) offsets — adds and
    # compares only, no per-slot integer division (sy = s // nx_span).
    sx = jnp.zeros_like(tx0)
    sy = jnp.zeros_like(ty0)
    tids, lives = [], []
    for s in range(max_tiles_per_splat):
        live_s = alive & (s < span) & (sy < ny_span)
        tid_s = (ty0 + sy) * nx + (tx0 + sx)
        if tile_range is not None:
            lo, n_local = tile_range
            live_s = live_s & (tid_s >= lo) & (tid_s < lo + n_local)
        tids.append(jnp.where(live_s, tid_s, num_tiles))
        lives.append(live_s)
        if s + 1 < max_tiles_per_splat:
            sx = sx + 1
            wrap = sx >= nx_span
            sx = jnp.where(wrap, 0, sx)
            sy = jnp.where(wrap, sy + 1, sy)
    splat_idx = jnp.concatenate([idx1] * max_tiles_per_splat)
    return tids, lives, splat_idx, overflowed


def quantized_depth_bits(depth: jax.Array) -> jax.Array:
    """Top QUANT_DEPTH_BITS of the positive-float distance (= 1/depth-key):
    positive-float bit patterns are integer-monotone, so packing them under
    the tile id yields tile-major front-to-back order in one sort."""
    dist = 1.0 / jnp.maximum(depth, 1e-30)
    dbits = jax.lax.bitcast_convert_type(dist, jnp.int32) >> (32 - QUANT_DEPTH_BITS)
    return jnp.clip(dbits, 0, (1 << QUANT_DEPTH_BITS) - 1)


def bin_splats(proj: Projected, p00, p11, width: int, height: int,
               tile_h: int = TILE_H, tile_w: int = TILE_W,
               max_tiles_per_splat: int = 16,
               quantized_depth: bool = False,
               tile_range=None, compact_keep_cols: int = 0,
               big_splat_budget: int = 0,
               big_splat_keep_cols: int = 128,
               compact_row_len: int = COMPACT_ROW_LEN,
               depth_prune_cap: int = 0,
               depth_prune_safety: float = 2.0,
               head_cap: int = 0,
               tile_row_band=None) -> TileBinning:
    """Build sorted (tile, splat) pairs.

    tile_range=(lo, n_local): restrict binning to the local tile window
    [lo, lo + n_local) — pairs outside it are dead, and tile_start covers
    only the window (length n_local + 1, tile lo at index 0). `lo` may be a
    traced value (each device's slice under shard_map); `n_local` must be
    static. This is what makes the sharded pipeline's per-device work scale:
    gathers and composite see only the device's own tiles.

    Two orderings:

    * quantized_depth=False (exact, default): `proj` must already be
      permuted into front-to-back order (render/sort.front_to_back_order);
      pairs are emitted in splat order and ONE stable sort by tile id leaves
      every tile's slice depth-ordered.

    * quantized_depth=True (the 10M+ fast path): skips the O(N) argsort and
      the 14-array permutation entirely. Each pair's sort key packs
      (tile_id << 20) | top-20-bits-of-float(distance): positive-float bit
      patterns are monotone as integers, so one single-key sort yields
      tile-major, front-to-back order. Depth ties within ~6 significant
      digits break by splat index (the reference's radix sort breaks exact
      ties the same way, drawn mirror-ordered; visually indistinguishable).
      A single call requires num_tiles < 2^11 - 1 (the key's tile-id
      budget); images beyond that render as tile-row bands via
      `tile_row_band` (render/pipeline.py) — the resolution ceiling is
      gone (4K = 2 bands).
    """
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    num_tiles = ny * nx

    # Fully off-screen bboxes produce empty ranges once gated by `valid`;
    # on-screen test: bbox intersects the image at all.
    alive, tx0, tx1, ty0, ty1 = splat_tile_bbox(proj, p00, p11, width,
                                                height, tile_h, tile_w)

    if tile_row_band is not None:
        # TILE-ROW BANDING (static): restrict to tile rows
        # [ty_base, ty_base + ny_band) and re-express everything in band
        # coordinates. This is how the quantized fast path escapes its
        # 11-bit tile-id budget at any resolution (VERDICT r3 #4): a 4K
        # image (30 x 135 = 4050 tiles at 16x128) renders as ceil-split
        # bands each under 2047 tiles, every band running the unmodified
        # emission/prune/sort/composite/tail machinery.
        ty_base, ny = tile_row_band
        num_tiles = ny * nx
        alive = alive & (ty1 >= ty_base) & (ty0 < ty_base + ny)
        ty0 = jnp.clip(ty0 - ty_base, 0, ny - 1)
        ty1 = jnp.clip(ty1 - ty_base, 0, ny - 1)

    # Two-tier emission (quantized path): the common case keeps the small
    # slot budget; the rare wide-span splats (span > budget — e.g. large
    # near-camera splats; ~0.01% of the 10M cube) are compacted into a
    # fixed-capacity id list and re-emitted with `big_splat_budget` slots.
    # Pair-slot cost stays ~budget*N + big_budget*capacity instead of
    # raising the budget for everyone, and the pair-budget overflow that
    # silently dropped those splats' far tiles goes to zero. Every loss
    # path stays accounted: spans beyond even the big budget and big splats
    # past capacity both count into `overflowed`.
    two_tier = bool(big_splat_budget) and quantized_depth
    if two_tier:
        assert big_splat_budget > max_tiles_per_splat
        span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
        is_big = alive & (span > max_tiles_per_splat)
        alive1 = alive & ~is_big
    else:
        alive1 = alive

    with jax.named_scope("emit"):
        tids, lives, splat_idx, overflowed = _emit_pair_slots(
            alive1, tx0, tx1, ty0, ty1, nx, num_tiles, max_tiles_per_splat,
            tile_range)

    if quantized_depth:
        assert num_tiles < (1 << 11) - 1, (
            "quantized_depth needs num_tiles < 2047; use the exact path")
        dbits = quantized_depth_bits(proj.depth)
        dead = jnp.iinfo(jnp.int32).max
        with jax.named_scope("emit"):
            key = jnp.concatenate([
                jnp.where(live_s, (tid_s << QUANT_DEPTH_BITS) | dbits, dead)
                for tid_s, live_s in zip(tids, lives)])
        if two_tier:
          with jax.named_scope("emit_big"):
            n = alive.shape[0]
            if n % 1024 == 0 and n >= 128 * 1024:
                # Hot-block extraction (compact_flag_ids): finds the
                # ~100-1000 wide-span splats without row-sorting all N
                # slots. Capacity = hot_cap*blk/8192*keep = 3072 ids;
                # drops are loud (overflowed), zero in practice.
                ids, big_dropped = compact_flag_ids(is_big)
            else:
                # Small/unpadded scenes: the direct two-level compaction
                # (first pass capacity scales with N; the second shrinks
                # it so every downstream gather cost scales with the
                # tiny real population).
                ids, _, big_dropped = compact_pairs(bk0 := jnp.where(
                    is_big, jnp.arange(n, dtype=jnp.int32), dead), bk0,
                    dead, big_splat_keep_cols)
                ids, _, big_dropped2 = compact_pairs(ids, ids, dead,
                                                     4 * big_splat_keep_cols)
                big_dropped = big_dropped + big_dropped2
            blive = ids != dead
            safe = jnp.minimum(ids, n - 1)
            # ONE stacked gather for every per-splat field the big tier
            # needs: a multi-row gather fetches all rows of an index for
            # about the cost of one 1-D gather.
            bfields = jnp.stack([tx0, tx1, ty0, ty1, dbits, span])[:, safe]
            btx0, btx1, bty0, bty1, dbits_b, span_b = bfields
            tidsb, livesb, sidxb, _ = _emit_pair_slots(
                blive, btx0, btx1, bty0, bty1, nx,
                num_tiles, big_splat_budget, tile_range, splat_ids=safe)
            keyb = jnp.concatenate([
                jnp.where(l, (ti << QUANT_DEPTH_BITS) | dbits_b, dead)
                for ti, l in zip(tidsb, livesb)])
            key = jnp.concatenate([key, keyb])
            splat_idx = jnp.concatenate([splat_idx, sidxb])
            # Span overflow counted only among KEPT big splats: one dropped
            # by the capacity cap is already in big_dropped (counting its
            # span overflow too would double-count it).
            overflowed = (jnp.sum(blive & (span_b > big_splat_budget))
                          + big_dropped)
            big_ids = ids
        else:
            big_ids = None
        prune_cut = None
        if depth_prune_cap and tile_range is None:
            # Drop pairs deeper than any slab the compositor will ever
            # blend (per-tile sample-estimated threshold) BEFORE the sort:
            # at 10M splats the majority of emitted pairs are beyond the
            # composite cap and would be sorted and gathered for nothing.
            with jax.named_scope("depth_prune"):
                prune_cut = depth_prune_cutkeys(key, num_tiles,
                                                depth_prune_cap,
                                                safety=depth_prune_safety)
                key = apply_cutkeys(key, prune_cut)
        compact_dropped = None
        if compact_keep_cols:
            with jax.named_scope("compact"):
                key, splat_idx, compact_dropped = compact_pairs(
                    key, splat_idx, dead, compact_keep_cols,
                    row_len=compact_row_len)
        # Unstable: ties within a (tile, 20-bit depth) bucket order
        # arbitrarily — the reference's radix sort breaks exact ties
        # arbitrarily too.
        with jax.named_scope("global_sort"):
            key_s, splat_s = jax.lax.sort((key, splat_idx), num_keys=1,
                                          is_stable=False)
        tid_s = jnp.where(key_s == dead, num_tiles,
                          key_s >> QUANT_DEPTH_BITS)
        if tile_range is not None:
            lo, n_local = tile_range
            tile_ids = lo + jnp.arange(n_local + 1, dtype=jnp.int32)
        else:
            tile_ids = jnp.arange(num_tiles + 1, dtype=jnp.int32)
        # Clip padding-tile bounds to num_tiles: dead keys are int32 max, so
        # every bound at/above num_tiles lands at the dead block's start and
        # out-of-image tiles get zero counts.
        with jax.named_scope("csr"):
            bounds = jnp.minimum(tile_ids, num_tiles) << QUANT_DEPTH_BITS
            tile_start = searchsorted_i32(key_s, bounds)
        prune_underkeep = None
        tile_pruned = None
        head_counts = None
        if prune_cut is not None:
            # Verify the sample-statistical guarantee: every tile that was
            # actually pruned must still hold >= the composite cap.
            counts = tile_start[1:] - tile_start[:-1]
            t_max = ((jnp.arange(num_tiles, dtype=jnp.int32) + 1)
                     << QUANT_DEPTH_BITS) - 1
            tile_pruned = prune_cut < t_max
            prune_underkeep = jnp.sum(tile_pruned
                                      & (counts < depth_prune_cap))
            if head_cap:
                # POST-SORT RE-CUT (tail mode): the sample-estimated prune
                # cut only bounds the kept set loosely (tie blocks and
                # sampling variance can leave 10-60x head_cap in a tile —
                # measured 32K at the 10M bench). With the sorted keys in
                # hand, move the head/tail boundary so the head composites
                # AT MOST head_cap nearest pairs: for overfull tiles the
                # cut is one below the head_cap-th key, which pushes that
                # key's whole tie block to the tail (pairs sharing one
                # quantized depth are arbitrarily ordered anyway — the
                # band-OIT tail treats them no worse than the sort does).
                # EVERYTHING beyond the cut — kept or pruned — satisfies
                # key > prune_cut, the tail compositor's exact complement,
                # and the head's exhaust loop is a guaranteed no-op.
                starts_q = tile_start[:-1]
                last = starts_q + jnp.minimum(counts, head_cap) - 1
                kcut = key_s[jnp.maximum(last, 0)]
                head_cut = jnp.where(counts > head_cap, kcut - 1, kcut)
                head_cut = jnp.where(counts > 0, head_cut, t_max)
                ub = searchsorted_i32(key_s, head_cut + 1)
                head_counts = ub - starts_q
                prune_cut = head_cut
                tile_pruned = head_counts < counts
    else:
        tid = jnp.concatenate(tids)
        # Two-key sort (tile id, splat index): `proj` is pre-permuted into
        # front-to-back order, so ascending splat index within a tile IS
        # depth order — equivalent to the stable single-key sort but
        # independent of pair emission order.
        tid_s, splat_s = jax.lax.sort((tid, splat_idx), num_keys=2,
                                      is_stable=False)
        if tile_range is not None:
            lo, n_local = tile_range
            bounds = jnp.minimum(lo + jnp.arange(n_local + 1, dtype=jnp.int32),
                                 num_tiles)
        else:
            bounds = jnp.arange(num_tiles + 1, dtype=jnp.int32)
        tile_start = searchsorted_i32(tid_s, bounds)

    if not quantized_depth:
        compact_dropped = None
        prune_underkeep = None
        tile_pruned = None
        prune_cut = None
        head_counts = None
        big_ids = None
    return TileBinning(pair_splat=splat_s, pair_tile=tid_s,
                       compact_dropped=compact_dropped,
                       prune_underkeep=prune_underkeep,
                       tile_pruned=tile_pruned, prune_cut=prune_cut,
                       head_counts=head_counts, big_ids=big_ids,
                       tile_start=tile_start, overflowed=overflowed)


def depth_prune_cutkeys(key: jax.Array, num_tiles: int, cap: int,
                        stride: int = 67, safety: float = 2.0) -> jax.Array:
    """Per-tile depth cut keys for pruning never-composited pairs.

    The compositor only ever blends the nearest `cap` pairs of a tile
    (slab size x deepening passes); at 10M splats the majority of emitted
    pairs are deeper than that and are sorted/gathered for nothing. This
    estimates, per tile, the key of roughly the (cap * safety)-th nearest
    pair from a strided 1/stride sample of the quantized keys: pairs with
    key > cut[tile] can be dropped BEFORE the pair sort.

    Statistics: the sample rank r = ceil(cap * safety / stride) has true
    rank ~ N(stride * r, stride * sqrt(r)); with safety 2 and cap >= 512
    the kept count per tile is >= cap at > 5 sigma. The default stride is
    PRIME: the pair array is a concatenation of slot-major blocks whose
    lengths share large power-of-two factors, and a power-of-two stride
    resonates with that structure (it samples the same splats in every
    slot block and fixed columns of the big-tier id matrix — measured 30x
    oversampling of big-tier pairs in near-camera tiles, under-keeping two
    tiles at the 10M bench). A prime stride walks every residue class.
    The comparison is INCLUSIVE (keep key <= cut) so a tie block at the
    cut key is kept whole — a tile whose pairs share one quantized depth
    keeps everything.
    Tiles with fewer sampled pairs than r keep everything (cut = the
    tile's maximal key). Callers verify the guarantee after binning via
    `prune_underkeep` (tiles pruned yet left with < cap pairs) in aux.

    Returns (T,) int32 cut keys: keep pair iff key <= cut[key >> 20].
    """
    # Sample by CONTIGUOUS 256-wide blocks spread evenly over the array.
    # A block's consecutive slots are consecutive splat ids within one
    # emission slot — independent draws for i.i.d. scenes; for
    # spatially-sorted (Morton) splat lists each block is ONE locality,
    # and a tile's cut estimate rests on the few blocks covering it: the
    # estimator's variance is LOCALITY-count-bound, not sample-count-
    # bound (a phase shift of a 1024-wide block grid swung the total kept
    # volume 15%, enough to breach the compaction keep margin; 256-wide
    # blocks at the same sample volume carry 4x the localities).
    # `prune_underkeep` verifies the outcome either way.
    blk = 256
    if key.shape[0] < stride * blk * 128:
        # Small arrays: the strided gather is cheap and mixes better than
        # a handful of blocks would.
        sample = key[::stride]
    else:
        sample = sample_blocks(key, stride=stride * blk, take=blk)
    ss = jax.lax.sort(sample, is_stable=False)
    tile_ids = jnp.arange(num_tiles + 1, dtype=jnp.int32)
    start = searchsorted_i32(ss, tile_ids << QUANT_DEPTH_BITS)   # (T+1,)
    r = start[:-1] + int(-(-cap * safety // stride))
    val = ss[jnp.minimum(r, ss.shape[0] - 1)]
    keep_all = r >= start[1:]          # fewer sampled than the rank
    tile_max = ((tile_ids[1:]) << QUANT_DEPTH_BITS) - 1
    return jnp.where(keep_all, tile_max, jnp.minimum(val, tile_max))


def searchsorted_i32(sorted_arr: jax.Array, queries: jax.Array) -> jax.Array:
    """Left-bisect positions of `queries` in 1-D `sorted_arr`, int32: an
    explicit binary search of log2(P) tiny gathers, independent of how
    the backend lowers jnp.searchsorted."""
    p = sorted_arr.shape[0]
    lo = jnp.zeros(queries.shape, jnp.int32)
    hi = jnp.full(queries.shape, p, jnp.int32)
    # Fixed trip count (no dynamic control flow under jit). bit_length(p)+1
    # guarantees the bracket [lo, hi) shrinks to empty: halving p for
    # bit_length(p) steps leaves at most a size-1 interval, and one more
    # step resolves it (a size-1 bracket still needs its comparison).
    steps = p.bit_length() + 1
    for _ in range(steps):
        mid = (lo + hi) >> 1
        take = sorted_arr[jnp.minimum(mid, p - 1)]
        live = mid < hi                    # bracket not yet empty
        go_right = live & (take < queries)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(live & ~go_right, mid, hi)
    return lo


def tile_pixel_ndc(width: int, height: int, tile_h: int = TILE_H,
                   tile_w: int = TILE_W, dtype=jnp.float32):
    """NDC coords of pixel centers for every tile: returns (px, py) of shape
    (T, tile_h * tile_w) where T = ny * nx, plus the (ny, nx) grid. Pixels
    outside the true image (padding tiles on the bottom/right) still get
    coordinates; callers crop the assembled image."""
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    ty = jnp.arange(ny, dtype=jnp.int32)
    tx = jnp.arange(nx, dtype=jnp.int32)
    iy = jnp.arange(tile_h, dtype=jnp.int32)
    ix = jnp.arange(tile_w, dtype=jnp.int32)
    # Global pixel coordinates per (tile_y, tile_x, in_y, in_x).
    gy = (ty[:, None, None, None] * tile_h + iy[None, None, :, None]).astype(dtype)
    gx = (tx[None, :, None, None] * tile_w + ix[None, None, None, :]).astype(dtype)
    px = (gx + 0.5) / width * 2.0 - 1.0
    py = 1.0 - (gy + 0.5) / height * 2.0
    px = jnp.broadcast_to(px, (ny, nx, tile_h, tile_w)).reshape(ny * nx, tile_h * tile_w)
    py = jnp.broadcast_to(py, (ny, nx, tile_h, tile_w)).reshape(ny * nx, tile_h * tile_w)
    return px, py, (ny, nx)


def assemble_image(tiles_rgba: jax.Array, width: int, height: int,
                   tile_h: int = TILE_H, tile_w: int = TILE_W) -> jax.Array:
    """(T, tile_h*tile_w, 4) tile buffers -> (H, W, 4) image (cropped)."""
    ny, nx = tile_grid(width, height, tile_h, tile_w)
    img = tiles_rgba.reshape(ny, nx, tile_h, tile_w, 4)
    img = img.transpose(0, 2, 1, 3, 4).reshape(ny * tile_h, nx * tile_w, 4)
    return img[:height, :width]
