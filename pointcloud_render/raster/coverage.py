"""The per-pixel coverage/depth evaluator shared by every accelerated backend.

Pure mul/add/compare float32 (no sqrt; the only division is the triangle's
perspective 1/iz) — see primitives.py: IEEE elementwise ops are
reproducible between the NumPy oracle and every backend, which is what
makes the "depth-exact match rate" metric meaningful.  Two caveats: a
compiler may contract a mul+add into an FMA (XLA on CPU and GPU, Triton),
which rounds once instead of twice — capsule/triangle depth can then
differ in the last ulp and a pixel exactly on a coverage edge can flip;
disc depth is a plain copy of z and stays bit-exact.  GPU f32 division
may differ from the correctly rounded one by an ulp — triangle depth
ties within 1 ulp are broken by primitive index.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

def eval_coverage_depth(col, qx, qy, is_tri=None):
    """Evaluate primitives against pixel centers, fully broadcast.

    Args:
      col: ``col(i)`` -> parameter ``i`` (0..11) of the rows, shaped to
        broadcast against the pixels (e.g. (C, 1, 1) against (H, W)).
        Each parameter is read once.
      qx, qy: pixel-center coordinates.
      is_tri: bool mask of the rows that are triangles, broadcastable like
        ``col(i)``; None when no row is a triangle (the triangle half is
        then not traced).

    Returns:
      covered: bool; depth: float32 (garbage where not covered), both of
      the broadcast shape of rows x pixels.
    """
    x0, y0, z0, r0 = col(0), col(1), col(2), col(3)
    sdx, sdy, sdz, sdr, il2 = col(4), col(5), col(6), col(7), col(8)

    # --- disc OR capsule (discs are degenerate capsules; one path):
    # [x0,y0,z0,r0, dx,dy,dz,dr, 1/len^2, -,-,-] ---
    dx = qx - x0
    dy = qy - y0
    t = jnp.clip((dx * sdx + dy * sdy) * il2, 0.0, 1.0)
    cx = dx - t * sdx
    cy = dy - t * sdy
    rad = r0 + sdr * t
    covered = cx * cx + cy * cy <= rad * rad
    depth = z0 + sdz * t
    if is_tri is None:
        return covered, depth

    # --- triangle: [ex0,ey0,c0, ex1,ey1,c1, ex2,ey2,c2, a0,a1,a2] ---
    e0 = x0 * qy - y0 * qx + z0
    e1 = r0 * qy - sdx * qx + sdy
    e2 = sdz * qy - sdr * qx + il2
    iz = e0 * col(9) + e1 * col(10) + e2 * col(11)
    tri_cov = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (iz > 0)
    tri_depth = 1.0 / jnp.where(iz > 0, iz, 1.0)
    return (jnp.where(is_tri, tri_cov, covered),
            jnp.where(is_tri, tri_depth, depth))


def pixel_centers(height, width, y0=0, x0=0):
    """(H, W) pixel-center coordinate grids for a screen region."""
    qy = (np.arange(height, dtype=np.float32) + np.float32(y0) + 0.5)[:, None]
    qx = (np.arange(width, dtype=np.float32) + np.float32(x0) + 0.5)[None, :]
    return (np.broadcast_to(qx, (height, width)),
            np.broadcast_to(qy, (height, width)))
