"""Procedural teardrop ("droplet") mesh.

The reference writes a temp OBJ once per run and instances it per point via
Mitsuba (reference: traj_renderer.py:102-153).  Geometry: 16 rings x 20
segments over theta in [0, pi]; a spherical cap of radius 0.008 for
theta <= pi/3, then a tail tapering as r*(1-t)^2 with a z offset of
-0.035*t*0.8.  Quads are split into two triangles with the reference's
winding.  Here the mesh is produced as arrays (vectorized) for direct
rasterization / instancing on the device; OBJ export is kept for
file-level parity.
"""

from __future__ import annotations

import os

import numpy as np

N_SEGMENTS = 20  # reference: traj_renderer.py:111
N_RINGS = 16  # reference: traj_renderer.py:112
BASE_RADIUS = 0.008  # reference: traj_renderer.py:113
LENGTH = 0.035  # reference: traj_renderer.py:114
CAP_THETA = np.pi / 3  # reference: traj_renderer.py:124
TAIL_Z_FACTOR = 0.8  # reference: traj_renderer.py:130


def droplet_mesh(dtype=np.float32):
    """Returns (vertices (V,3), faces (F,3) int32); V=340, F=640."""
    i = np.arange(N_RINGS + 1, dtype=np.float64)  # ring index
    j = np.arange(N_SEGMENTS, dtype=np.float64)  # segment index
    theta = np.pi * i / N_RINGS  # (R+1,)
    phi = 2 * np.pi * j / N_SEGMENTS  # (S,)

    t = (theta - CAP_THETA) / (2 * np.pi / 3)
    in_cap = theta <= CAP_THETA
    r = np.where(in_cap, BASE_RADIUS, BASE_RADIUS * (1 - t) ** 2)
    z_offset = np.where(in_cap, 0.0, -LENGTH * t * TAIL_Z_FACTOR)

    sin_t, cos_t = np.sin(theta), np.cos(theta)
    x = (r * sin_t)[:, None] * np.cos(phi)[None, :]
    y = (r * sin_t)[:, None] * np.sin(phi)[None, :]
    z = (r * cos_t + z_offset)[:, None] * np.ones_like(phi)[None, :]
    vertices = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(dtype)

    ri = np.arange(N_RINGS)[:, None]  # (R, 1)
    sj = np.arange(N_SEGMENTS)[None, :]  # (1, S)
    v0 = ri * N_SEGMENTS + sj
    v1 = ri * N_SEGMENTS + (sj + 1) % N_SEGMENTS
    v2 = (ri + 1) * N_SEGMENTS + sj
    v3 = (ri + 1) * N_SEGMENTS + (sj + 1) % N_SEGMENTS
    tri_a = np.stack([v0, v2, v1], axis=-1).reshape(-1, 3)
    tri_b = np.stack([v1, v2, v3], axis=-1).reshape(-1, 3)
    faces = np.stack([tri_a, tri_b], axis=1).reshape(-1, 3).astype(np.int32)
    return vertices, faces


def instance_droplets(rotations, translations, dtype=None):
    """Instance the droplet mesh per point: (N,4,4)|(N,3,3)+(N,3) -> world.

    Returns (verts (N*V, 3), faces (N*F, 3) int32).  The per-vertex
    transform is explicit broadcast muladds — a (N,3,3)@(3,V) matmul
    may run in TF32 on a GPU and break parity with the reference float32
    matrices.
    """
    import jax.numpy as jnp  # local: host callers may stay numpy-only

    mesh_v, mesh_f = droplet_mesh()
    v = np.asarray(mesh_v, np.float32)  # (V, 3)
    rot = jnp.asarray(rotations, jnp.float32)
    if rot.ndim == 3 and rot.shape[1:] == (4, 4):
        t = rot[:, :3, 3]
        rot = rot[:, :3, :3]
    else:
        t = jnp.asarray(translations, jnp.float32)
    n = rot.shape[0]
    # world[n, vtx, i] = sum_j rot[n, i, j] * v[vtx, j] + t[n, i]
    world = (
        rot[:, None, :, 0] * v[None, :, None, 0]
        + rot[:, None, :, 1] * v[None, :, None, 1]
        + rot[:, None, :, 2] * v[None, :, None, 2]
        + t[:, None, :]
    )  # (N, V, 3)
    nv = v.shape[0]
    faces = (np.asarray(mesh_f, np.int32)[None, :, :]
             + (np.arange(n, dtype=np.int32) * nv)[:, None, None])
    return world.reshape(n * nv, 3), faces.reshape(-1, 3)


# Capsule LOD of the droplet: a head sphere plus a tapering tail capsule.
# The mesh's tail tip sits at z = r*cos(pi) - LENGTH*1.0*0.8 ~= -(LENGTH*0.8);
# rotation maps -z to the unit velocity, so the tail points ALONG +v
# (reference rest orientation: traj_renderer.py:171 with the tail at -z,
# traj_renderer.py:128-134).
TAIL_TIP_OFFSET = LENGTH * TAIL_Z_FACTOR  # 0.028 along +v from the center


def droplet_capsule_lod(positions, velocities):
    """(N,3),(N,3) -> head centers/radii + tail segment endpoints.

    For screen sizes of ~10-20 px (all reference scenes) this silhouette is
    visually indistinguishable from the 640-triangle mesh at ~300x less
    rasterization work.  Zero/near-zero velocities keep the identity
    orientation (tail along -z world), matching the rotation contract.
    """
    import jax.numpy as jnp

    p = jnp.asarray(positions, jnp.float32)
    v = jnp.asarray(velocities, jnp.float32)
    norm = jnp.linalg.norm(v, axis=1, keepdims=True)
    unit = jnp.where(norm < 1e-6, jnp.array([0.0, 0.0, -1.0], jnp.float32),
                     v / jnp.where(norm < 1e-6, 1.0, norm))
    tail_tip = p + unit * TAIL_TIP_OFFSET
    return p, jnp.full((p.shape[0],), BASE_RADIUS, jnp.float32), tail_tip


def write_droplet_obj(path: str) -> str:
    """Export the droplet mesh as OBJ (reference temp-file parity,
    traj_renderer.py:147-153: 'v x y z' at 6 decimals, 1-based faces)."""
    vertices, faces = droplet_mesh(dtype=np.float64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
    return os.path.abspath(path)
