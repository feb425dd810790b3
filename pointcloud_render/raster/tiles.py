"""Tile binning: assign primitives to framebuffer tiles (XLA, static shapes).

The screen is cut into tile_h x tile_w tiles (8 x 128 by default).  Each primitive's pixel bbox selects the tiles it may touch:

* primitives touching <= max_tiles_per_prim tiles are expanded into
  (tile_id, prim_id) entries, stably sorted by tile, and packed into a
  dense (num_tiles, max_per_tile) index table (rank-capped, -1 padded);
* larger primitives (the ground plane spans the whole screen) go to a
  small global "big list" that every tile processes.

Determinism: entries are generated in ascending primitive order and the
sort is stable, so each tile's list is ascending in primitive index —
the per-tile lexicographic (depth, index) reduction then matches the
oracle exactly.  Overflow beyond max_per_tile / max_big is COUNTED and
returned so callers can re-bin with a bigger capacity (no silent drops).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TileBins:
    table: jax.Array  # (num_tiles, max_per_tile) int32 prim ids, -1 pad
    counts: jax.Array  # (num_tiles,) int32 — true per-tile counts (uncapped)
    big_list: jax.Array  # (max_big,) int32 prim ids, -1 pad
    big_count: jax.Array  # () int32 true big-prim count (uncapped)
    tiles_y: int = dataclasses.field(metadata=dict(static=True), default=0)
    tiles_x: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def overflowed(self):
        """() int32: total entries dropped by capacity caps."""
        cap = self.table.shape[1]
        tile_drop = jnp.sum(jnp.maximum(self.counts - cap, 0))
        big_drop = jnp.maximum(self.big_count - self.big_list.shape[0], 0)
        return tile_drop + big_drop


def tile_overflow(prims, width: int, height: int, tile_h: int = 8,
                  tile_w: int = 128, max_per_tile: int = 512,
                  max_tiles_per_prim: int = 16, max_big: int = 64):
    """() int32: entries the capacity-capped table WOULD drop for this
    scene/config (must mirror bin_primitives' defaults).  Cheap — one
    scatter-add instead of the full binning sort — so sharded/streaming
    paths can return it alongside every render (no silent truncation).
    """
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    num_tiles = tiles_y * tiles_x

    xmin, xmax = prims.bbox[:, 0], prims.bbox[:, 1]
    ymin, ymax = prims.bbox[:, 2], prims.bbox[:, 3]
    tx0 = jnp.clip(jnp.floor(xmin / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    tx1 = jnp.clip(jnp.floor(xmax / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty0 = jnp.clip(jnp.floor(ymin / tile_h).astype(jnp.int32), 0, tiles_y - 1)
    ty1 = jnp.clip(jnp.floor(ymax / tile_h).astype(jnp.int32), 0, tiles_y - 1)
    ntx = tx1 - tx0 + 1
    nty = ty1 - ty0 + 1
    span = ntx * nty
    is_big = (span > max_tiles_per_prim) & prims.valid
    is_small = (span <= max_tiles_per_prim) & prims.valid

    slot = np.arange(max_tiles_per_prim, dtype=np.int32)[None, :]
    ex = slot % ntx[:, None]
    ey = slot // ntx[:, None]
    slot_ok = (slot < span[:, None]) & is_small[:, None]
    tile_id = (ty0[:, None] + ey) * tiles_x + (tx0[:, None] + ex)
    tile_id = jnp.where(slot_ok, tile_id, num_tiles)

    counts = jnp.zeros((num_tiles + 1,), jnp.int32).at[
        tile_id.reshape(-1)].add(slot_ok.reshape(-1).astype(jnp.int32))
    tile_drop = jnp.sum(jnp.maximum(counts[:num_tiles] - max_per_tile, 0))
    big_drop = jnp.maximum(jnp.sum(is_big.astype(jnp.int32)) - max_big, 0)
    return tile_drop + big_drop


def bin_primitives(prims, width: int, height: int, tile_h: int = 8,
                   tile_w: int = 128, max_per_tile: int = 512,
                   max_tiles_per_prim: int = 16, max_big: int = 64) -> TileBins:
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    num_tiles = tiles_y * tiles_x
    p = prims.count

    xmin, xmax = prims.bbox[:, 0], prims.bbox[:, 1]
    ymin, ymax = prims.bbox[:, 2], prims.bbox[:, 3]
    # Covered pixel columns are ceil(xmin-0.5)..floor(xmax-0.5); using the
    # raw bbox for tile ranges over-covers by at most one tile — harmless.
    tx0 = jnp.clip(jnp.floor(xmin / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    tx1 = jnp.clip(jnp.floor(xmax / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty0 = jnp.clip(jnp.floor(ymin / tile_h).astype(jnp.int32), 0, tiles_y - 1)
    ty1 = jnp.clip(jnp.floor(ymax / tile_h).astype(jnp.int32), 0, tiles_y - 1)
    ntx = tx1 - tx0 + 1
    nty = ty1 - ty0 + 1
    span = ntx * nty
    is_big = (span > max_tiles_per_prim) & prims.valid
    is_small = (span <= max_tiles_per_prim) & prims.valid

    # Expand each small prim into max_tiles_per_prim candidate slots.
    slot = np.arange(max_tiles_per_prim, dtype=np.int32)[None, :]  # (1, S)
    ex = slot % ntx[:, None]
    ey = slot // ntx[:, None]
    slot_ok = (slot < span[:, None]) & is_small[:, None]
    tile_id = (ty0[:, None] + ey) * tiles_x + (tx0[:, None] + ex)
    tile_id = jnp.where(slot_ok, tile_id, num_tiles)  # sentinel = num_tiles
    prim_id = jnp.broadcast_to(
        np.arange(p, dtype=np.int32)[:, None], tile_id.shape)

    flat_tiles = tile_id.reshape(-1)
    flat_prims = prim_id.reshape(-1)
    # Direct pair sort; int16 keys when the tile count allows (narrower
    # keys sort faster).  Stability is NOT required for correctness — the
    # kernels' lexicographic (depth, id) merge is order-independent — but
    # lax.sort is stable anyway, keeping tables ascending in prim id.
    if num_tiles + 1 < 32767:
        k16, sorted_prims = jax.lax.sort(
            (flat_tiles.astype(jnp.int16), flat_prims), num_keys=1,
            is_stable=True)
        sorted_tiles = k16.astype(jnp.int32)
    else:
        sorted_tiles, sorted_prims = jax.lax.sort(
            (flat_tiles, flat_prims), num_keys=1, is_stable=True)

    starts = jnp.searchsorted(sorted_tiles,
                              np.arange(num_tiles + 1, dtype=np.int32))
    counts = (starts[1:] - starts[:-1]).astype(jnp.int32)
    rank = np.arange(sorted_tiles.shape[0], dtype=np.int32) - starts[sorted_tiles]

    keep = (sorted_tiles < num_tiles) & (rank < max_per_tile)
    flat_idx = jnp.where(keep, sorted_tiles * max_per_tile + rank,
                         num_tiles * max_per_tile)
    table = jnp.full((num_tiles * max_per_tile + 1,), -1, jnp.int32)
    table = table.at[flat_idx].set(sorted_prims, mode="drop")
    table = table[:-1].reshape(num_tiles, max_per_tile)

    # Big list (ascending prim index by construction of cumsum).
    big_rank = jnp.cumsum(is_big.astype(jnp.int32)) - 1
    big_idx = jnp.where(is_big & (big_rank < max_big), big_rank, max_big)
    big_list = jnp.full((max_big + 1,), -1, jnp.int32)
    big_list = big_list.at[big_idx].set(
        np.arange(p, dtype=np.int32), mode="drop")
    big_list = big_list[:-1]
    big_count = jnp.sum(is_big.astype(jnp.int32))

    return TileBins(table=table, counts=counts, big_list=big_list,
                    big_count=big_count, tiles_y=tiles_y, tiles_x=tiles_x)
