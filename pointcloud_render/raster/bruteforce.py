"""Brute-force XLA rasterizer: every primitive against every pixel.

O(P * H * W) — the simplest possible backend that implements the shared
contract on any JAX device.  Used as the cross-check between the NumPy
oracle and the fast tiled backends, and as the fallback for tiny scenes.
Primitives stream through a lax.scan in chunks so peak memory stays at
CHUNK * H * W.

Determinism: the running z-buffer carries (depth, index); the per-chunk
reduction and the cross-chunk combine both use lexicographic
(depth, index) min, matching the oracle exactly.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_render.raster.coverage import eval_coverage_depth, pixel_centers
from pointcloud_render.raster.primitives import KIND_TRIANGLE

INF = np.float32(np.inf)  # numpy: safe to create at in-trace import time


def _lex_min(d0, i0, d1, i1):
    """Lexicographic (depth, index) minimum of two buffers."""
    take1 = (d1 < d0) | ((d1 == d0) & (i1 < i0))
    return jnp.where(take1, d1, d0), jnp.where(take1, i1, i0)


def rasterize_bruteforce(prims, width: int, height: int, chunk: int = 8):
    """Returns (depth (H,W) f32 +inf-empty, index (H,W) i32 -1-empty)."""
    p = prims.count
    pad = (-p) % chunk
    kind = jnp.pad(prims.kind, (0, pad))
    params = jnp.pad(prims.params, ((0, pad), (0, 0)))
    valid = jnp.pad(prims.valid, (0, pad))
    ids = np.arange(p + pad, dtype=np.int32)

    qx, qy = pixel_centers(height, width)
    n_chunks = (p + pad) // chunk

    def step(carry, chunk_idx):
        depth, index = carry
        sl = chunk_idx * chunk
        k = jax.lax.dynamic_slice_in_dim(kind, sl, chunk)
        pr = jax.lax.dynamic_slice_in_dim(params, sl, chunk)
        va = jax.lax.dynamic_slice_in_dim(valid, sl, chunk)
        pid = jax.lax.dynamic_slice_in_dim(ids, sl, chunk)

        cov, z = eval_coverage_depth(
            lambda i: pr[:, i, None, None], qx, qy,
            (k == KIND_TRIANGLE)[:, None, None])  # (chunk, H, W)
        cov &= va[:, None, None]
        z = jnp.where(cov, z, INF)
        pidb = jnp.where(cov, pid[:, None, None],
                         jnp.int32(2147483647))
        # Reduce the chunk axis lexicographically: argmin over packed order.
        # depth is positive; ties broken by smaller id -> reduce sequentially
        # over the (small, static) chunk for exactness.
        cd, ci = z[0], pidb[0]
        for j in range(1, chunk):
            cd, ci = _lex_min(cd, ci, z[j], pidb[j])
        depth, index = _lex_min(depth, index, cd, ci)
        return (depth, index), None

    init = (jnp.full((height, width), INF),
            jnp.full((height, width), 2147483647, jnp.int32))
    (depth, index), _ = jax.lax.scan(step, init,
                                     np.arange(n_chunks, dtype=np.int32))
    index = jnp.where(jnp.isinf(depth), -1, index)
    return depth, index
