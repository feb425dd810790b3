"""Per-point camera stage: world -> camera -> screen, with frustum cull.

This replaces the reference's scene-XML emission + Mitsuba camera
(reference: traj_ball_renderer.py:309-333): instead of writing one XML
shape per point, the whole cloud is transformed by one fused XLA program.

Conventions (the rasterization contract — the CPU oracle, the XLA scatter
backend and the Pallas kernel all implement exactly this):

* camera space: +x image-right, +y image-up, +z viewing depth;
* focal length in pixels: f = width / (2 * tan(fov_x / 2))  (fov is
  specified along x, Mitsuba's default fov_axis, reference:
  traj_ball_renderer.py:19);
* pixel coords: px = W/2 + f * x/z, py = H/2 - f * y/z; pixel centers
  sample at (col + 0.5, row + 0.5);
* a point is visible iff near < z < far;
* a sphere of world radius r projects to a disc of radius f * r / z.

The 3x3 rotation is applied with explicit multiply-adds rather than a
matmul so results are reproducible against the float32 NumPy oracle (a
float32 matmul may run in TF32 on a GPU unless its precision is pinned).
A compiler may still contract a mul+add into an FMA, which differs from
the oracle in the last ulp at most.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def apply_world_to_camera(positions, w2c):
    """(N, 3) world -> (N, 3) camera space via explicit muladds."""
    p = jnp.asarray(positions, jnp.float32)
    m = jnp.asarray(w2c, jnp.float32)  # (3, 4)
    x = p[:, 0] * m[0, 0] + p[:, 1] * m[0, 1] + p[:, 2] * m[0, 2] + m[0, 3]
    y = p[:, 0] * m[1, 0] + p[:, 1] * m[1, 1] + p[:, 2] * m[1, 2] + m[1, 3]
    z = p[:, 0] * m[2, 0] + p[:, 1] * m[2, 1] + p[:, 2] * m[2, 2] + m[2, 3]
    return x, y, z


def project_points(positions, camera, radii=None):
    """Project world points through a Camera.

    Returns dict of (N,) arrays: px, py (pixel coords), z (camera depth),
    r_px (projected radius; zeros if radii is None), valid (near/far cull;
    points fully off-screen are additionally culled by bbox).
    """
    x, y, z = apply_world_to_camera(positions, camera.world_to_camera_matrix())
    focal = camera.width / (2.0 * camera.tan_half_fov_x)
    safe_z = jnp.where(z <= 0, 1.0, z)
    inv_z = 1.0 / safe_z
    px = camera.width * 0.5 + focal * x * inv_z
    py = camera.height * 0.5 - focal * y * inv_z
    valid = (z > camera.near) & (z < camera.far)
    if radii is None:
        r_px = jnp.zeros_like(z)
    else:
        r_px = focal * jnp.asarray(radii, jnp.float32) * inv_z
    # Off-screen cull (bbox entirely outside the film).
    valid &= (px + r_px >= 0) & (px - r_px <= camera.width)
    valid &= (py + r_px >= 0) & (py - r_px <= camera.height)
    # Pin the projected values against XLA's fma contraction: without
    # the barrier, a consumer sub/add (e.g. a capsule builder's
    # x1 - r1) may contract r_px's final multiply in SOME compilations
    # and not others, so the same scene's soup could differ in the low
    # bit across program shapes.  The barrier materializes the four
    # vectors (one packed pass, negligible) and makes every downstream
    # soup field a plain op on fixed operands — a precondition for the
    # packed-column build (capsules_from_vertex_columns) being
    # bit-identical to the polyline build under jit.
    px, py, z, r_px = jax.lax.optimization_barrier((px, py, z, r_px))
    return dict(px=px, py=py, z=z, r_px=r_px, valid=valid)
