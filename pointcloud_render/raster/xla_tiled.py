"""Tiled XLA gather rasterizer: binned primitives, per-tile reduction.

The screen-space analogue of a block-sparse matmul: tiles are the output
blocks, each tile gathers only its binned primitives and reduces them
with a two-stage lexicographic min (min depth, then min index among
depth-equal) — exact, deterministic, scatter-free.  This is the portable
fast path and the structural blueprint for the Pallas kernel (same
binning, same reduction, the kernel just keeps the tile in VMEM and
skips empty chunks).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_render.raster.coverage import eval_coverage_depth
from pointcloud_render.raster.primitives import KIND_TRIANGLE
from pointcloud_render.raster.tiles import bin_primitives

# Plain numpy scalars: module-level jnp values would be created inside an
# active trace if this module is first imported during tracing, leaking
# tracers into globals (found the hard way).
INF = np.float32(np.inf)
IMAX = np.int32(2147483647)


def _reduce_chunk(kind, params, valid, ids, qx, qy):
    """Evaluate a chunk of prims on a pixel block; lexicographic winner.

    kind/params/valid/ids: (..., C[, 12]); qx, qy: (..., th, tw).
    Returns depth (..., th, tw), index (..., th, tw).
    """
    cov, z = eval_coverage_depth(
        lambda i: params[..., i, None, None], qx[..., None, :, :],
        qy[..., None, :, :],
        (kind == KIND_TRIANGLE)[..., None, None])  # (..., C, th, tw)
    cov &= valid[..., None, None]
    z = jnp.where(cov, z, INF)
    dmin = jnp.min(z, axis=-3)
    contender = jnp.where(z == dmin[..., None, :, :], ids[..., None, None], IMAX)
    imin = jnp.min(contender, axis=-3)
    return dmin, imin


def _lex_merge(d0, i0, d1, i1):
    take1 = (d1 < d0) | ((d1 == d0) & (i1 < i0))
    return jnp.where(take1, d1, d0), jnp.where(take1, i1, i0)


def rasterize_tiled(prims, width: int, height: int, tile_h: int = 8,
                    tile_w: int = 128, max_per_tile: int = 512,
                    chunk: int = 32, tile_batch: int = 16, max_big: int = 64):
    """Returns (depth (H,W) f32 +inf-empty, index (H,W) i32 -1-empty)."""
    bins = bin_primitives(prims, width, height, tile_h=tile_h, tile_w=tile_w,
                          max_per_tile=max_per_tile, max_big=max_big)
    tiles_y, tiles_x = bins.tiles_y, bins.tiles_x
    num_tiles = tiles_y * tiles_x
    pad_tiles = (-num_tiles) % tile_batch
    table = jnp.pad(bins.table, ((0, pad_tiles), (0, 0)), constant_values=-1)
    n_batches = (num_tiles + pad_tiles) // tile_batch

    tile_ids = np.arange(num_tiles + pad_tiles, dtype=np.int32)

    # In-tile pixel-center offsets.
    oy = (np.arange(tile_h, dtype=np.float32) + 0.5)[:, None]
    ox = (np.arange(tile_w, dtype=np.float32) + 0.5)[None, :]

    kind_all, params_all, valid_all = prims.kind, prims.params, prims.valid
    n_chunks = max_per_tile // chunk
    assert max_per_tile % chunk == 0

    big_ids = bins.big_list
    big_safe = jnp.maximum(big_ids, 0)
    big_kind = kind_all[big_safe]
    big_params = params_all[big_safe]
    big_valid = valid_all[big_safe] & (big_ids >= 0)

    def tile_batch_fn(batch_idx):
        tid = (batch_idx * tile_batch
               + jax.lax.iota(jnp.int32, tile_batch))
        ttab = jax.lax.dynamic_slice_in_dim(table, batch_idx * tile_batch,
                                            tile_batch)  # (B, MPT)
        # Tile origins computed from the traced ids (keeps constants out of
        # the executable parameter list).
        tile_x0 = ((tid % tiles_x) * tile_w).astype(jnp.float32)
        tile_y0 = ((tid // tiles_x) * tile_h).astype(jnp.float32)
        qx = tile_x0[:, None, None] + ox[None]  # (B, th, tw)
        qy = tile_y0[:, None, None] + oy[None]

        depth = jnp.full((tile_batch, tile_h, tile_w), INF)
        index = jnp.full((tile_batch, tile_h, tile_w), IMAX)

        def chunk_step(c, carry):
            d, i = carry
            ids = jax.lax.dynamic_slice_in_dim(ttab, c * chunk, chunk, axis=1)
            safe = jnp.maximum(ids, 0)
            k = kind_all[safe]
            pr = params_all[safe]
            va = valid_all[safe] & (ids >= 0)
            cd, ci = _reduce_chunk(k, pr, va, ids, qx, qy)
            return _lex_merge(d, i, cd, ci)

        depth, index = jax.lax.fori_loop(
            0, n_chunks, chunk_step, (depth, index))

        # Big primitives (ground plane etc.) hit every tile.
        bd, bi = _reduce_chunk(
            jnp.broadcast_to(big_kind, (tile_batch,) + big_kind.shape),
            jnp.broadcast_to(big_params, (tile_batch,) + big_params.shape),
            jnp.broadcast_to(big_valid, (tile_batch,) + big_valid.shape),
            jnp.broadcast_to(big_ids, (tile_batch,) + big_ids.shape),
            qx, qy)
        return _lex_merge(depth, index, bd, bi)

    depth_t, index_t = jax.lax.map(tile_batch_fn,
                                   np.arange(n_batches, dtype=np.int32))
    depth_t = depth_t.reshape(num_tiles + pad_tiles, tile_h, tile_w)
    index_t = index_t.reshape(num_tiles + pad_tiles, tile_h, tile_w)
    depth_t = depth_t[:num_tiles].reshape(tiles_y, tiles_x, tile_h, tile_w)
    index_t = index_t[:num_tiles].reshape(tiles_y, tiles_x, tile_h, tile_w)
    depth = depth_t.transpose(0, 2, 1, 3).reshape(tiles_y * tile_h,
                                                  tiles_x * tile_w)
    index = index_t.transpose(0, 2, 1, 3).reshape(tiles_y * tile_h,
                                                  tiles_x * tile_w)
    depth = depth[:height, :width]
    index = index[:height, :width]
    index = jnp.where(jnp.isinf(depth), -1, index)
    return depth, index
