"""NumPy reference rasterizer — the correctness oracle.

Slow, loopy, independent: iterates primitives in index order and updates
each one's integer bbox window with a strict depth test (z < zbuf), which
together with ascending iteration implements the shared contract —
winner per pixel = lexicographic min of (depth, primitive index).

All arithmetic is float32 with the exact expression shapes of
coverage.eval_coverage_depth.  Backends match this oracle bit-for-bit on
disc depth and on every winner index away from coverage edges; where a
compiler contracts a mul+add into an FMA (XLA on either device, Triton),
capsule/triangle depth can differ in the last ulp and a pixel exactly on
a coverage edge can flip (see coverage.py).  SURVEY.md §4 item 2: this oracle is the
north-star metric's ground truth; Mitsuba's Monte Carlo output cannot be
a pixel oracle.
"""

from __future__ import annotations

import numpy as np

from pointcloud_render.raster.primitives import (
    KIND_CAPSULE,
    KIND_DISC,
    KIND_TRIANGLE,
)


def rasterize_reference(prims, width: int, height: int):
    """Rasterize a ScreenPrimitives soup (numpy-converted) on the CPU.

    Returns:
      depth: (H, W) float32, +inf where empty.
      index: (H, W) int32 winning primitive row, -1 where empty.
    """
    kind = np.asarray(prims.kind)
    params = np.asarray(prims.params, np.float32)
    valid = np.asarray(prims.valid)
    bbox = np.asarray(prims.bbox, np.float32)

    depth = np.full((height, width), np.inf, np.float32)
    index = np.full((height, width), -1, np.int32)

    for i in range(kind.shape[0]):
        if not valid[i]:
            continue
        xmin, xmax, ymin, ymax = bbox[i]
        # Pixel centers at col + 0.5: covered cols satisfy col + 0.5 in
        # [xmin, xmax] -> ceil(xmin - 0.5) .. floor(xmax - 0.5).
        c0 = max(int(np.ceil(xmin - 0.5)), 0)
        c1 = min(int(np.floor(xmax - 0.5)), width - 1)
        r0 = max(int(np.ceil(ymin - 0.5)), 0)
        r1 = min(int(np.floor(ymax - 0.5)), height - 1)
        if c1 < c0 or r1 < r0:
            continue
        qx = (np.arange(c0, c1 + 1, dtype=np.float32) + np.float32(0.5))[None, :]
        qy = (np.arange(r0, r1 + 1, dtype=np.float32) + np.float32(0.5))[:, None]
        p = params[i]
        if kind[i] in (KIND_DISC, KIND_CAPSULE):
            dx = qx - p[0]
            dy = qy - p[1]
            t = np.clip((dx * p[4] + dy * p[5]) * p[8], np.float32(0.0),
                        np.float32(1.0)).astype(np.float32)
            cx = dx - t * p[4]
            cy = dy - t * p[5]
            rad = p[3] + p[7] * t
            cov = cx * cx + cy * cy <= rad * rad
            z = p[2] + p[6] * t
        elif kind[i] == KIND_TRIANGLE:
            e0 = p[0] * qy - p[1] * qx + p[2]
            e1 = p[3] * qy - p[4] * qx + p[5]
            e2 = p[6] * qy - p[7] * qx + p[8]
            iz = e0 * p[9] + e1 * p[10] + e2 * p[11]
            cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (iz > 0)
            z = np.where(iz > 0, np.float32(1.0) / np.where(iz > 0, iz, 1), np.inf)
            z = z.astype(np.float32)
        else:
            continue
        window_d = depth[r0:r1 + 1, c0:c1 + 1]
        window_i = index[r0:r1 + 1, c0:c1 + 1]
        better = cov & (z < window_d)  # strict: earlier index wins ties
        window_d[better] = np.broadcast_to(z, better.shape)[better]
        window_i[better] = i
    return depth, index
