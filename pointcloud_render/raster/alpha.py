"""Order-independent alpha compositing for disc splats (WBOIT-style).

BASELINE.json config 3 calls for sphere/disc splats with per-point radius
and alpha compositing.  A depth-sorted over-blend is order-dependent and
hostile to vector hardware; instead this implements weighted-blended OIT:

    w_i(q)  = alpha_i * exp(-d_i(q)^2 / (2 * sigma_i^2)),  sigma = r/2
    rgb(q)  = (sum_i w_i c_i) / (sum_i w_i)
    cover(q)= 1 - exp(-sum_i alpha_i * G_i(q))
    out     = cover * rgb + (1 - cover) * background

Commutative sums only — deterministic under any accumulation order and
point permutation (up to float addition reordering across backends,
which tests bound at ~1e-5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_render.raster.coverage import pixel_centers
from pointcloud_render.raster.project import project_points


def splat_gaussians(positions, camera, radii, colors, alphas):
    """Project points -> per-splat screen gaussians (SoA dict)."""
    proj = project_points(positions, camera, radii=radii)
    n = proj["px"].shape[0]
    colors = jnp.broadcast_to(jnp.asarray(colors, jnp.float32), (n, 3))
    alphas = jnp.broadcast_to(jnp.asarray(alphas, jnp.float32), (n,))
    return dict(px=proj["px"], py=proj["py"], r=proj["r_px"],
                valid=proj["valid"], color=colors, alpha=alphas)


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "chunk", "background"))
def composite_bruteforce(splats, width: int, height: int, chunk: int = 32,
                         background=(1.0, 1.0, 1.0)):
    """Accumulating reference implementation (chunked full-screen scan)."""
    n = splats["px"].shape[0]
    pad = (-n) % chunk
    sp = {k: jnp.pad(v, ((0, pad),) + ((0, 0),) * (v.ndim - 1))
          for k, v in splats.items()}
    qx, qy = pixel_centers(height, width)

    def step(carry, i):
        acc_c, acc_w = carry
        sl = i * chunk
        px = jax.lax.dynamic_slice_in_dim(sp["px"], sl, chunk)
        py = jax.lax.dynamic_slice_in_dim(sp["py"], sl, chunk)
        r = jax.lax.dynamic_slice_in_dim(sp["r"], sl, chunk)
        va = jax.lax.dynamic_slice_in_dim(sp["valid"], sl, chunk)
        co = jax.lax.dynamic_slice_in_dim(sp["color"], sl, chunk)
        al = jax.lax.dynamic_slice_in_dim(sp["alpha"], sl, chunk)

        dx = qx[None] - px[:, None, None]
        dy = qy[None] - py[:, None, None]
        d2 = dx * dx + dy * dy
        r2 = (r * r)[:, None, None]
        sigma2 = jnp.maximum(r2 * 0.25, 1e-12)
        g = jnp.exp(-d2 / (2.0 * sigma2))
        inside = (d2 <= r2) & va[:, None, None]
        w = jnp.where(inside, al[:, None, None] * g, 0.0)
        acc_w = acc_w + jnp.sum(w, axis=0)
        acc_c = acc_c + jnp.einsum("nhw,nc->hwc", w, co,
                                   precision=jax.lax.Precision.HIGHEST)
        return (acc_c, acc_w), None

    init = (jnp.zeros((height, width, 3), jnp.float32),
            jnp.zeros((height, width), jnp.float32))
    (acc_c, acc_w), _ = jax.lax.scan(
        step, init, np.arange((n + pad) // chunk, dtype=np.int32))
    return _resolve(acc_c, acc_w, background)


def _resolve(acc_c, acc_w, background):
    """The weight sum serves double duty: color normalizer AND opacity
    accumulator (w_i = alpha_i * G_i, so sum(w) is exactly the exponent
    of the coverage term in the module formula)."""
    rgb = acc_c / jnp.maximum(acc_w, 1e-12)[..., None]
    cover = 1.0 - jnp.exp(-acc_w)
    bg = np.asarray(background, np.float32)
    return jnp.clip(cover[..., None] * rgb + (1 - cover[..., None]) * bg,
                    0.0, 1.0)


def composite_tiled(splats, width: int, height: int, tile_h: int = 8,
                    tile_w: int = 128, max_per_tile: int = 1024,
                    chunk: int = 32, tile_batch: int = 16,
                    background=(1.0, 1.0, 1.0)):
    """Binned accumulation (same tiling machinery as the z-buffer path)."""
    from pointcloud_render.raster.primitives import ScreenPrimitives
    from pointcloud_render.raster.tiles import bin_primitives

    n = splats["px"].shape[0]
    px, py, r = splats["px"], splats["py"], splats["r"]
    params = jnp.stack(
        [px, py, r * r, splats["alpha"], splats["color"][:, 0],
         splats["color"][:, 1], splats["color"][:, 2]], axis=1)
    params = jnp.pad(params, ((0, 0), (0, 5)))
    bbox = jnp.stack([px - r, px + r, py - r, py + r], axis=1)
    prims = ScreenPrimitives(
        kind=jnp.zeros((n,), jnp.int32), params=params,
        color=splats["color"], valid=splats["valid"], bbox=bbox,
        normal=jnp.zeros((n, 3), jnp.float32))
    bins = bin_primitives(prims, width, height, tile_h=tile_h, tile_w=tile_w,
                          max_per_tile=max_per_tile)
    tiles_y, tiles_x = bins.tiles_y, bins.tiles_x
    num_tiles = tiles_y * tiles_x
    pad_tiles = (-num_tiles) % tile_batch
    table = jnp.pad(bins.table, ((0, pad_tiles), (0, 0)), constant_values=-1)
    n_batches = (num_tiles + pad_tiles) // tile_batch

    oy = (np.arange(tile_h, dtype=np.float32) + 0.5)[:, None]
    ox = (np.arange(tile_w, dtype=np.float32) + 0.5)[None, :]
    n_chunks = max_per_tile // chunk

    def tile_batch_fn(batch_idx):
        tid = batch_idx * tile_batch + jax.lax.iota(jnp.int32, tile_batch)
        ttab = jax.lax.dynamic_slice_in_dim(table, batch_idx * tile_batch,
                                            tile_batch)
        qx = ((tid % tiles_x) * tile_w).astype(jnp.float32)[:, None, None] \
            + ox[None]
        qy = ((tid // tiles_x) * tile_h).astype(jnp.float32)[:, None, None] \
            + oy[None]

        def chunk_step(c, carry):
            acc_c, acc_w = carry
            ids = jax.lax.dynamic_slice_in_dim(ttab, c * chunk, chunk, axis=1)
            safe = jnp.maximum(ids, 0)
            pr = params[safe]  # (B, C, 12)
            va = prims.valid[safe] & (ids >= 0)
            dx = qx[:, None] - pr[..., 0][..., None, None]
            dy = qy[:, None] - pr[..., 1][..., None, None]
            d2 = dx * dx + dy * dy
            r2 = pr[..., 2][..., None, None]
            sigma2 = jnp.maximum(r2 * 0.25, 1e-12)
            g = jnp.exp(-d2 / (2.0 * sigma2))
            inside = (d2 <= r2) & va[..., None, None]
            w = jnp.where(inside, pr[..., 3][..., None, None] * g, 0.0)
            acc_w = acc_w + jnp.sum(w, axis=1)
            col = pr[..., 4:7]  # (B, C, 3)
            acc_c = acc_c + jnp.einsum(
                "bchw,bck->bhwk", w, col,
                precision=jax.lax.Precision.HIGHEST)
            return acc_c, acc_w

        init = (jnp.zeros((tile_batch, tile_h, tile_w, 3), jnp.float32),
                jnp.zeros((tile_batch, tile_h, tile_w), jnp.float32))
        return jax.lax.fori_loop(0, n_chunks, chunk_step, init)

    acc_c, acc_w = jax.lax.map(tile_batch_fn,
                               np.arange(n_batches, dtype=np.int32))
    acc_c = acc_c.reshape(num_tiles + pad_tiles, tile_h, tile_w, 3)
    acc_w = acc_w.reshape(num_tiles + pad_tiles, tile_h, tile_w)
    acc_c = acc_c[:num_tiles].reshape(tiles_y, tiles_x, tile_h, tile_w, 3) \
        .transpose(0, 2, 1, 3, 4).reshape(tiles_y * tile_h,
                                          tiles_x * tile_w, 3)
    acc_w = acc_w[:num_tiles].reshape(tiles_y, tiles_x, tile_h, tile_w) \
        .transpose(0, 2, 1, 3).reshape(tiles_y * tile_h, tiles_x * tile_w)
    acc_c = acc_c[:height, :width]
    acc_w = acc_w[:height, :width]
    return _resolve(acc_c, acc_w, background)
