"""Velocity-aligned droplet orientation (Rodrigues) — exact and vectorized.

The reference orients each droplet so its default -z tip axis points along
the (unit) velocity, via an explicit axis-angle/Rodrigues construction with
three edge cases: near-zero velocity -> identity; parallel -> identity;
antiparallel -> pi rotation about a perpendicular axis
(reference: traj_renderer.py:159-202).

``rotation_from_velocity`` replays that float64 scalar math exactly for the
state-layer contract; ``rotation_matrices_from_velocities`` is the
branchless float32 jnp version that vmaps over the whole cloud inside jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

VELOCITY_EPS = 1e-6  # reference: traj_renderer.py:165
AXIS_EPS = 1e-8  # reference: traj_renderer.py:177
DEFAULT_TIP_AXIS = (0.0, 0.0, -1.0)  # droplet rest orientation, traj_renderer.py:171


def rotation_from_velocity(velocity, translation) -> np.ndarray:
    """Exact host-side replay; returns the flattened 4x4 row-major matrix."""
    velocity = np.array(velocity, dtype=np.float64)
    vel_norm = np.linalg.norm(velocity)
    if vel_norm < VELOCITY_EPS:
        matrix = np.eye(4, dtype=np.float64)
        matrix[:3, 3] = translation
        return matrix.flatten()

    target = velocity / vel_norm
    default = np.array(DEFAULT_TIP_AXIS, dtype=np.float64)
    dot = np.clip(np.dot(default, target), -1.0, 1.0)
    axis = np.cross(default, target)
    axis_norm = np.linalg.norm(axis)

    if axis_norm < AXIS_EPS:
        if dot > 0.999:
            matrix = np.eye(4, dtype=np.float64)
            matrix[:3, 3] = translation
            return matrix.flatten()
        # Antiparallel: rotate pi about any perpendicular axis.
        helper = (np.array([1.0, 0.0, 0.0]) if abs(target[0]) < 0.9
                  else np.array([0.0, 1.0, 0.0]))
        axis = np.cross(target, helper)
        axis_norm = np.linalg.norm(axis)
        axis = axis / axis_norm if axis_norm > AXIS_EPS else np.array([0.0, 1.0, 0.0])
        angle = np.pi
    else:
        axis = axis / axis_norm
        angle = np.arccos(dot)

    cos_a, sin_a = np.cos(angle), np.sin(angle)
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]], dtype=np.float64)
    rot = np.eye(3) + sin_a * k + (1 - cos_a) * (k @ k)
    matrix = np.eye(4, dtype=np.float64)
    matrix[:3, :3] = rot
    matrix[:3, 3] = translation
    return matrix.flatten()


def rotation_matrices_from_velocities(velocities, positions):
    """Branchless jnp batch version: (N,3),(N,3) -> (N,4,4) float32.

    All three reference branches are evaluated and selected with where():
    no data-dependent control flow, so this traces into one fused XLA
    program (and onto the VPU) for the whole cloud.
    """
    v = jnp.asarray(velocities, jnp.float32)
    t = jnp.asarray(positions, jnp.float32)
    n = v.shape[0]

    vel_norm = jnp.linalg.norm(v, axis=1)
    safe_norm = jnp.where(vel_norm < VELOCITY_EPS, 1.0, vel_norm)
    target = v / safe_norm[:, None]

    default = np.array(DEFAULT_TIP_AXIS, np.float32)
    # Pinned: a float32 matmul may run in TF32 on a GPU.
    dot = jnp.clip(jnp.matmul(target, default,
                              precision=jax.lax.Precision.HIGHEST),
                   -1.0, 1.0)
    axis = jnp.cross(jnp.broadcast_to(default, (n, 3)), target)
    axis_norm = jnp.linalg.norm(axis, axis=1)

    # Antiparallel fallback axis (reference: traj_renderer.py:183-188).
    helper = jnp.where(
        (jnp.abs(target[:, 0]) < 0.9)[:, None],
        np.array([1.0, 0.0, 0.0], np.float32),
        np.array([0.0, 1.0, 0.0], np.float32),
    )
    anti_axis = jnp.cross(target, helper)
    anti_norm = jnp.linalg.norm(anti_axis, axis=1)
    anti_axis = jnp.where(
        (anti_norm > AXIS_EPS)[:, None],
        anti_axis / jnp.where(anti_norm > AXIS_EPS, anti_norm, 1.0)[:, None],
        np.array([0.0, 1.0, 0.0], np.float32),
    )

    degenerate = axis_norm < AXIS_EPS
    unit_axis = jnp.where(
        degenerate[:, None],
        anti_axis,
        axis / jnp.where(degenerate, 1.0, axis_norm)[:, None],
    )
    angle = jnp.where(degenerate, jnp.pi, jnp.arccos(dot))

    cos_a = jnp.cos(angle)
    sin_a = jnp.sin(angle)
    ax, ay, az = unit_axis[:, 0], unit_axis[:, 1], unit_axis[:, 2]
    zeros = jnp.zeros_like(ax)
    k = jnp.stack([
        jnp.stack([zeros, -az, ay], axis=-1),
        jnp.stack([az, zeros, -ax], axis=-1),
        jnp.stack([-ay, ax, zeros], axis=-1),
    ], axis=-2)  # (N, 3, 3)
    eye = np.eye(3, dtype=np.float32)
    # For a unit axis a, K@K == a a^T - I (an elementwise outer product:
    # a float32 matmul may run in TF32 on a GPU, ~1e-3 accuracy).
    kk = unit_axis[:, :, None] * unit_axis[:, None, :] - eye
    rot = eye + sin_a[:, None, None] * k + (1 - cos_a)[:, None, None] * kk

    # Identity when the velocity is negligible or already aligned.
    is_identity = (vel_norm < VELOCITY_EPS) | (degenerate & (dot > 0.999))
    rot = jnp.where(is_identity[:, None, None], eye, rot)

    mats = jnp.zeros((n, 4, 4), jnp.float32)
    mats = mats.at[:, :3, :3].set(rot)
    mats = mats.at[:, :3, 3].set(t)
    mats = mats.at[:, 3, 3].set(1.0)
    return mats


def random_rotation_matrix(seed: int, translation) -> np.ndarray:
    """Seeded random rotation fallback when no velocity exists.

    Replays reference: traj_renderer.py:398-418 exactly (NumPy legacy RNG
    seeded per point index), so position-only droplet scenes reproduce.
    """
    rng = np.random.RandomState(seed)
    axis = rng.randn(3)
    axis = axis / np.linalg.norm(axis)
    angle = rng.uniform(0, 2 * np.pi)
    cos_a, sin_a = np.cos(angle), np.sin(angle)
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    rot = np.eye(3) + sin_a * k + (1 - cos_a) * (k @ k)
    matrix = np.eye(4)
    matrix[:3, :3] = rot
    matrix[:3, 3] = translation
    return matrix.flatten()
