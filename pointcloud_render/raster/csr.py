"""The exact CSR rasterizer: anchor-sorted binning, then a per-tile walk.

Front end (plain XLA, shared by both walks):

* Every valid disc/capsule (and, with ``bin_triangles``, triangle) whose
  bbox covers at most ``span x span`` tiles is BINNED: it is sorted once
  by the key ``anchor * span^2 + class``, where the anchor is its
  top-left tile and the class its spill pattern.  Wider prims sort just
  past the binned keys under a sentinel key, invalid prims after them,
  so the sorted tail holds the big list without a scatter.
* CSR range starts: ``searchsorted`` over every (anchor, class) ordinal.
* The range table: tile t walks every prim anchored at t plus each
  neighbour anchor's spill-class subset.  The class ordinals are chosen
  so every such subset is ONE contiguous range of the sorted order
  (span=2: ordinals 0 = none, 1 = x-spill, 2 = both, 3 = y-spill; left
  neighbours need {1, 2}, upper {2, 3}, diagonal {2}).  The big list
  (at most ``max_big`` prims) is the last range of every tile.
* Exact rows, one per sorted prim, as a structure of arrays: the 12
  params, the prim id as f32 (exact below 2^24) and the triangle flag.

The walk evaluates each tile's ranges over its pixel block with the
contract's per-pixel math and keeps the lexicographic minimum of
(depth, id).  The id tie-break makes the winner independent of the
order in which rows are visited, so ranges and chunks can be walked in
any order.  Nothing is capped except the big list, whose overflow is
reported (0 = exact).

Two implementations of the same walk over the same ranges and rows:

* :func:`walk_xla` — plain XLA: per batch of tiles, a loop that gathers
  ``chunk`` rows per tile and evaluates them with
  ``coverage.eval_coverage_depth``.  The reference, and the CPU path.
* :func:`walk_triton` — a Pallas kernel through Triton for NVIDIA GPUs:
  one program per tile loads its own range bounds, streams its rows in
  power-of-two chunks with masked loads, keeps the tile's (depth, id)
  accumulator in registers and stores it once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from pointcloud_render.raster.coverage import eval_coverage_depth
from pointcloud_render.raster.primitives import (
    KIND_CAPSULE,
    KIND_DISC,
    KIND_TRIANGLE,
)

INF = np.float32(np.inf)
F_EMPTY = np.float32(1 << 24)  # > every representable prim id
DEFAULT_MAX_BIG = 1024
WALKS = ("xla", "triton")

# Row fields: params 0..11, then these.
F_ID = 12
F_TRI = 13

# Rows per chunk: a power of two between these, picked per soup by
# pick_chunk (the Triton block shape must be a power of two).
MIN_CHUNK = 4
MAX_CHUNK = {"xla": 32, "triton": 8}
# The XLA walk evaluates (tiles x chunk x pixels) per loop step; tiles
# are batched so one step stays under this many elements.
XLA_STEP_ELEMS = 1 << 24
# Triton launch parameters, measured at 1080p on an H100 (PERF.md,
# "Kernel decision"): 4 warps beat 8 at every chunk; num_stages 1-4 time
# the same within noise (the walk's loads are data-dependent gathers).
TRITON_NUM_WARPS = 4
TRITON_NUM_STAGES = 2


def tile_grid(width: int, height: int, tile_h: int, tile_w: int):
    """(tiles_x, tiles_y) covering the image; edge tiles overhang it."""
    return -(-width // tile_w), -(-height // tile_h)


def _check_shape(prims, tile_h, tile_w, span):
    for v in (tile_h, tile_w):
        if v < 1 or v & (v - 1):
            raise ValueError(f"tile sides must be powers of two, got "
                             f"{tile_h}x{tile_w}")
    if span < 1:
        raise ValueError(f"span must be >= 1, got {span}")
    if prims.count >= (1 << 24):
        raise ValueError("float id encoding supports < 2^24 primitives")


def _key_dtype(num_tiles, span):
    """int16 keys sort faster; use them whenever every ordinal plus the
    two sentinels fits."""
    fits16 = num_tiles * span * span + 2 <= np.iinfo(np.int16).max
    return np.int16 if fits16 else np.int32


def _bin(prims, tile_h, tile_w, tiles_x, tiles_y, bin_triangles, span):
    """Per-prim (anchor, class) keys + one unstable sort.

    Returns (sorted_keys, sorted_prims, n_small, big_count): the binned
    prims are the sorted prefix [0, n_small), the big prims the next
    big_count positions (in arbitrary order — exact under the per-pair
    (depth, id) tie-break).
    """
    p = prims.count
    num_tiles = tiles_x * tiles_y
    xmin, xmax = prims.bbox[:, 0], prims.bbox[:, 1]
    ymin, ymax = prims.bbox[:, 2], prims.bbox[:, 3]
    tx0 = jnp.clip(jnp.floor(xmin / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    tx1 = jnp.clip(jnp.floor(xmax / tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty0 = jnp.clip(jnp.floor(ymin / tile_h).astype(jnp.int32), 0, tiles_y - 1)
    ty1 = jnp.clip(jnp.floor(ymax / tile_h).astype(jnp.int32), 0, tiles_y - 1)
    binnable = (prims.kind == KIND_DISC) | (prims.kind == KIND_CAPSULE)
    if bin_triangles:
        binnable = binnable | (prims.kind == KIND_TRIANGLE)
    fits = (tx1 - tx0 < span) & (ty1 - ty0 < span) & binnable
    is_small = prims.valid & fits
    is_big = prims.valid & ~fits

    sx = tx1 - tx0
    sy = ty1 - ty0
    if span == 2:
        cls = sx + 3 * sy - 2 * (sx * sy)  # 0 none, 1 x, 2 both, 3 y
    else:
        cls = sy * span + sx
    anchor = ty0 * tiles_x + tx0
    kdtype = _key_dtype(num_tiles, span)
    sent_big = kdtype(num_tiles * span * span)
    sent_invalid = kdtype(sent_big + 1)
    key = jnp.where(is_small, (anchor * (span * span) + cls).astype(kdtype),
                    jnp.where(is_big, sent_big, sent_invalid))
    sorted_keys, sorted_prims = jax.lax.sort(
        (key, jnp.arange(p, dtype=jnp.int32)), num_keys=1, is_stable=False)
    n_small = jnp.searchsorted(sorted_keys, sent_big).astype(jnp.int32)
    n_valid = jnp.searchsorted(sorted_keys, sent_invalid).astype(jnp.int32)
    return sorted_keys, sorted_prims, n_small, n_valid - n_small


def _range_specs(span):
    """Static (dy, dx, c_lo, c_hi): tile t walks the prims of anchor
    t - dy * tiles_x - dx whose class ordinal lies in [c_lo, c_hi)."""
    if span == 2:
        return [(0, 0, 0, 4), (0, 1, 1, 3), (1, 0, 2, 4), (1, 1, 2, 3)]
    k2 = span * span
    specs = [(0, 0, 0, k2)]
    for dy in range(span):
        for dx in range(span):
            if dx == 0 and dy == 0:
                continue
            if dx == 0:
                specs.append((dy, 0, dy * span, k2))
            else:
                # Row-major classes: the subset {spanx > dx, spany >= dy}
                # is contiguous per spany row.
                for cy in range(dy, span):
                    specs.append((dy, dx, cy * span + dx, cy * span + span))
    return specs


def _range_table(starts, tiles_x, tiles_y, span, big_start, big_n):
    """(T, R) int32 range starts and lengths per tile; the last column is
    the big list (the same range for every tile)."""
    k2 = span * span
    t = np.arange(tiles_x * tiles_y, dtype=np.int32)
    tx = t % tiles_x
    ty = t // tiles_x
    rs, rn = [], []
    for dy, dx, lo, hi in _range_specs(span):
        ok = (tx >= dx) & (ty >= dy)
        a = np.where(ok, t - dy * tiles_x - dx, 0)
        s = starts[k2 * a + lo]
        rs.append(s)
        rn.append(jnp.where(ok, starts[k2 * a + hi] - s, 0))
    rs.append(jnp.broadcast_to(big_start, t.shape))
    rn.append(jnp.broadcast_to(big_n, t.shape))
    return jnp.stack(rs, axis=1), jnp.stack(rn, axis=1)


def _rows(prims, sorted_prims, pad):
    """(N_FIELDS, P + pad) f32 rows in sorted order, zero-padded so a
    chunk that starts at any live row stays inside the array."""
    params = prims.params[sorted_prims]
    is_tri = prims.kind[sorted_prims] == KIND_TRIANGLE
    rows = jnp.concatenate([
        params.T,
        sorted_prims.astype(jnp.float32)[None],
        is_tri.astype(jnp.float32)[None],
    ], axis=0)
    return jnp.pad(rows, ((0, 0), (0, pad)))


def pick_chunk(walk: str, num_prims: int, num_tiles: int) -> int:
    """Rows per chunk: the power of two nearest above the mean binned
    rows per tile, clamped to [MIN_CHUNK, MAX_CHUNK[walk]] — small soups
    waste fewer masked lanes, dense ones take the tuned maximum."""
    mean = -(-num_prims // max(num_tiles, 1))
    c = 1 << max(int(mean) - 1, 0).bit_length()
    return int(min(max(c, MIN_CHUNK), MAX_CHUNK[walk]))


def _merge(acc_d, acc_i, z, cov, idf, axis):
    """Fold a chunk's covered (z, id) candidates into the accumulator:
    lexicographic min over ``axis``, then against the accumulator."""
    zc = jnp.where(cov, z, INF)
    dmin = jnp.min(zc, axis=axis)
    imin = jnp.min(jnp.where(cov & (zc == jnp.expand_dims(dmin, axis)),
                             idf, F_EMPTY), axis=axis)
    better = (dmin < acc_d) | ((dmin == acc_d) & (imin < acc_i))
    return jnp.where(better, dmin, acc_d), jnp.where(better, imin, acc_i)


def _pixel_centers(tiles, tiles_x, tile_h, tile_w):
    """Pixel centers of each tile's (tile_h, tile_w) block: (B, th, tw)."""
    ty = (tiles // tiles_x)[:, None, None]
    tx = (tiles % tiles_x)[:, None, None]
    py = jnp.arange(tile_h, dtype=jnp.int32)[None, :, None]
    px = jnp.arange(tile_w, dtype=jnp.int32)[None, None, :]
    qx = (tx * tile_w + px).astype(jnp.float32) + 0.5
    qy = (ty * tile_h + py).astype(jnp.float32) + 0.5
    return (jnp.broadcast_to(qx, (tiles.shape[0], tile_h, tile_w)),
            jnp.broadcast_to(qy, (tiles.shape[0], tile_h, tile_w)))


def walk_xla(rows, rs, rn, tiles_x, tile_h, tile_w, chunk):
    """The plain-XLA walk -> (depth, idf), each (T, tile_h, tile_w).

    Per batch of tiles, a loop whose trip count is the batch's largest
    row count / chunk.  Step k gathers rows k*chunk .. k*chunk+chunk-1 of
    every tile's concatenated ranges (masked past the tile's total).
    """
    num_tiles, n_ranges = rs.shape
    batch = max(1, min(num_tiles, XLA_STEP_ELEMS // (chunk * tile_h
                                                     * tile_w)))
    n_batches = -(-num_tiles // batch)
    pad = n_batches * batch - num_tiles
    rs = jnp.pad(rs, ((0, pad), (0, 0)))
    rn = jnp.pad(rn, ((0, pad), (0, 0)))
    cum = jnp.cumsum(rn, axis=1)
    prev = cum - rn
    tiles = jnp.arange(n_batches * batch, dtype=jnp.int32)

    def split(x):
        return x.reshape((n_batches, batch) + x.shape[1:])

    lane = jnp.arange(chunk, dtype=jnp.int32)

    def one_batch(args):
        tl, rs_b, cum_b, prev_b = args
        qx, qy = _pixel_centers(tl, tiles_x, tile_h, tile_w)
        qx, qy = qx[:, None], qy[:, None]  # (B, 1, th, tw)
        trips = (jnp.max(cum_b[:, -1]) + chunk - 1) // chunk

        def body(k, acc):
            j = k * chunk + lane  # (C,)
            r = jnp.sum(j[None, :, None] >= cum_b[:, None, :], axis=-1)
            live = r < n_ranges  # (B, C)
            rc = jnp.minimum(r, n_ranges - 1)
            pos = (jnp.take_along_axis(rs_b, rc, axis=1) + j[None]
                   - jnp.take_along_axis(prev_b, rc, axis=1))
            g = rows[:, jnp.where(live, pos, 0)]  # (F, B, C)
            cov, z = eval_coverage_depth(lambda f: g[f, ..., None, None],
                                         qx, qy,
                                         g[F_TRI, ..., None, None] > 0)
            cov = cov & live[..., None, None]
            return _merge(acc[0], acc[1], z, cov,
                          g[F_ID][..., None, None], axis=1)

        init = (jnp.full((batch, tile_h, tile_w), INF, jnp.float32),
                jnp.full((batch, tile_h, tile_w), F_EMPTY, jnp.float32))
        return jax.lax.fori_loop(0, trips, body, init)

    depth, idf = jax.lax.map(
        one_batch, (split(tiles), split(rs), split(cum), split(prev)))
    shape = (n_batches * batch, tile_h, tile_w)
    return (depth.reshape(shape)[:num_tiles],
            idf.reshape(shape)[:num_tiles])


def _make_kernel(n_ranges, tiles_x, tile_h, tile_w, chunk, bin_triangles):
    npx = tile_h * tile_w

    def kernel(rs_ref, rn_ref, rows_ref, depth_ref, idf_ref):
        tile = pl.program_id(0)
        tx = tile % tiles_x
        ty = tile // tiles_x
        pix = jnp.arange(npx, dtype=jnp.int32)
        qx = ((tx * tile_w + pix % tile_w).astype(jnp.float32) + 0.5)[None]
        qy = ((ty * tile_h + pix // tile_w).astype(jnp.float32) + 0.5)[None]
        lane = jnp.arange(chunk, dtype=jnp.int32)

        def walk_range(start, count, with_tri, acc):
            def body(k, acc):
                base = start + k * chunk
                live = lane < count - k * chunk

                def col(f):
                    v = pl_triton.load(rows_ref.at[f, pl.ds(base, chunk)],
                                       mask=live, other=0.0)
                    return v[:, None]

                cov, z = eval_coverage_depth(
                    col, qx, qy, col(F_TRI) > 0 if with_tri else None)
                cov = cov & live[:, None]
                return _merge(acc[0], acc[1], z, cov, col(F_ID), axis=0)

            trips = jax.lax.div(count + chunk - 1, chunk)
            return jax.lax.fori_loop(0, trips, body, acc)

        def binned(r, acc):
            return walk_range(rs_ref[tile, r], rn_ref[tile, r],
                              bin_triangles, acc)

        acc = (jnp.full((npx,), INF, jnp.float32),
               jnp.full((npx,), F_EMPTY, jnp.float32))
        acc = jax.lax.fori_loop(0, n_ranges - 1, binned, acc)
        # The big list holds the ground and other triangles in any soup.
        acc = walk_range(rs_ref[tile, n_ranges - 1],
                         rn_ref[tile, n_ranges - 1], True, acc)
        depth_ref[tile, :] = acc[0]
        idf_ref[tile, :] = acc[1]

    return kernel


def walk_triton(rows, rs, rn, tiles_x, tile_h, tile_w, chunk,
                bin_triangles, interpret=False):
    """The Triton walk -> (depth, idf), each (T, tile_h, tile_w).

    One program per tile, no state carried between programs: blocks run
    in any order on the card's SMs.  ``interpret`` runs the kernel on
    the CPU (tests only)."""
    num_tiles, n_ranges = rs.shape
    npx = tile_h * tile_w
    kernel = _make_kernel(n_ranges, tiles_x, tile_h, tile_w, chunk,
                          bin_triangles)
    depth, idf = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((num_tiles, npx), jnp.float32)] * 2,
        grid=(num_tiles,),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=TRITON_NUM_WARPS, num_stages=TRITON_NUM_STAGES),
        interpret=interpret,
        name="csr_walk",
    )(rs, rn, rows)
    shape = (num_tiles, tile_h, tile_w)
    return depth.reshape(shape), idf.reshape(shape)


def rasterize_csr(prims, width: int, height: int, walk: str,
                  max_big: int = DEFAULT_MAX_BIG,
                  bin_triangles: bool = False, span: int = 2,
                  tile_h: int = 32, tile_w: int = 32, chunk=None,
                  interpret: bool = False):
    """Returns (depth (H, W) f32 +inf-empty, index (H, W) i32 -1-empty,
    overflow () i32 — big-list prims past ``max_big``, 0 = exact).

    ``walk``: "xla" or "triton" (raster/render.py picks it from the
    platform).  ``chunk``: rows per step, a power of two (default
    pick_chunk).  ``interpret`` runs the Triton kernel on the CPU.
    """
    if walk not in WALKS:
        raise ValueError(f"unknown walk {walk!r}; expected one of {WALKS}")
    _check_shape(prims, tile_h, tile_w, span)
    tiles_x, tiles_y = tile_grid(width, height, tile_h, tile_w)
    num_tiles = tiles_x * tiles_y
    if chunk is None:
        chunk = pick_chunk(walk, prims.count, num_tiles)
    elif chunk < 1 or chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two, got {chunk}")
    if num_tiles * span * span + 2 >= (1 << 31):
        raise ValueError("tile grid too large for the int32 bin key")

    sorted_keys, sorted_prims, n_small, big_count = _bin(
        prims, tile_h, tile_w, tiles_x, tiles_y, bin_triangles, span)
    k2 = span * span
    bounds = np.arange(num_tiles * k2 + 1).astype(sorted_keys.dtype)
    starts = jnp.searchsorted(sorted_keys, bounds).astype(jnp.int32)
    rs, rn = _range_table(starts, tiles_x, tiles_y, span, n_small,
                          jnp.minimum(big_count, max_big))
    rows = _rows(prims, sorted_prims, chunk)
    if walk == "xla":
        depth_t, idf_t = walk_xla(rows, rs, rn, tiles_x, tile_h, tile_w,
                                  chunk)
    else:
        depth_t, idf_t = walk_triton(rows, rs, rn, tiles_x, tile_h, tile_w,
                                     chunk, bin_triangles,
                                     interpret=interpret)

    def assemble(t):
        return t.reshape(tiles_y, tiles_x, tile_h, tile_w) \
            .transpose(0, 2, 1, 3) \
            .reshape(tiles_y * tile_h, tiles_x * tile_w)[:height, :width]

    depth = assemble(depth_t)
    index = jnp.where(jnp.isinf(depth), -1,
                      assemble(idf_t).astype(jnp.int32))
    return depth, index, jnp.maximum(big_count - max_big, 0)


def bin_diagnostics(prims, width: int, height: int,
                    max_big: int = DEFAULT_MAX_BIG,
                    bin_triangles: bool = False, span: int = 2,
                    tile_h: int = 32, tile_w: int = 32):
    """Big-list overflow of a render with these settings (0 = exact),
    without rasterizing.  ``bin_triangles``/``span`` must mirror the
    render being certified."""
    _check_shape(prims, tile_h, tile_w, span)
    tiles_x, tiles_y = tile_grid(width, height, tile_h, tile_w)
    _, _, _, big_count = _bin(prims, tile_h, tile_w, tiles_x, tiles_y,
                              bin_triangles, span)
    return jnp.maximum(big_count - max_big, 0)
