"""Cameras and the five reference trajectory presets.

The reference drives a Mitsuba perspective sensor from a look-at pose whose
origin is a pure function of the frame index (reference:
traj_ball_renderer.py:281-307 and the variants in traj_renderer.py:519-527,
traj_b0.py:84-115, traj_b1.py:84-115, traj_original.py:62-66).  Here the
same trajectory functions exist in two forms:

* ``camera_origin(preset, frame_index, total_frames)`` — exact host-side
  float64 replay for bit-compatibility tests and pipeline use;
* ``camera_origin_jax`` — branchless jnp version usable under jit/vmap so a
  whole trajectory's poses evaluate as one XLA program.

Projection model: perspective pinhole with the field of view specified
along the image x axis (Mitsuba's default fov_axis, reference:
traj_ball_renderer.py:19 ``fov = 36``), near/far clips 0.1/100, film
1920x1080 (reference: traj_ball_renderer.py:14-27).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# --- fixed sensor constants of the reference ------------------------------
IMAGE_WIDTH = 1920  # reference: traj_ball_renderer.py:24
IMAGE_HEIGHT = 1080  # reference: traj_ball_renderer.py:25
NEAR_CLIP = 0.1  # reference: traj_ball_renderer.py:15
FAR_CLIP = 100.0  # reference: traj_ball_renderer.py:14
FOV_TRAJ = 36.0  # degrees, reference: traj_ball_renderer.py:19
FOV_EXAMPLE = 30.0  # degrees, reference: example_renderer.py:22
UP = (0.0, 0.0, 1.0)  # reference: traj_ball_renderer.py:17

# Look-at targets per preset (reference: traj_ball_renderer.py:17,
# traj_b0.py:19, traj_b1.py:19, example_renderer.py:20).
TARGETS = {
    "example": (0.0, 0.0, 0.0),
    "traj": (0.0, 0.0, -0.05),
    "traj_ball": (0.0, 0.0, -0.05),
    "traj_vel": (0.0, 0.0, -0.05),
    "traj_b0": (-0.02, 0.15, -0.05),
    "traj_b1": (0.0, -0.02, 0.0),
    "traj_original": (0.0, 0.0, -0.05),
}

LAST_MOTION_FRAME = 199  # reference: traj_ball_renderer.py:287
FADE_FRAMES = 20  # reference: traj_ball_renderer.py:288
TOTAL_FRAMES = 220  # reference: traj_ball_renderer.py:428

# Two-phase waypoint tables: (start, mid, final). Phase 1 runs frames
# 0..199 start->mid with progress f/199, phase 2 runs frames 200..219
# mid->final with progress (f-199)/20.
_WAYPOINTS = {
    # reference: traj_ball_renderer.py:290-305 (same fn in traj_vel_renderer)
    "traj_ball": ((2.8, 2.8, 3.0), (1.8, 1.8, 1.8), (1.6, 1.6, 1.6)),
    "traj_vel": ((2.8, 2.8, 3.0), (1.8, 1.8, 1.8), (1.6, 1.6, 1.6)),
    # reference: traj_b0.py:94-115
    "traj_b0": ((-2.2, -3.3, 2.0), (-1.3, -2.5, 0.8), (-1.0, -2.0, 0.7)),
    # reference: traj_b1.py:94-100
    "traj_b1": ((-3.5, -2.5, 2.8), (-2.3, -1.5, 1.2), (-2.0, -1.2, 1.0)),
}


def camera_origin(
    preset: str, frame_index: int, total_frames: int = TOTAL_FRAMES
) -> Tuple[float, float, float]:
    """Exact replay of the reference camera-origin schedules."""
    if preset == "example":
        # Static pose baked into the XML head (reference: example_renderer.py:20).
        return (2.2, 2.2, 4.2)
    if preset == "traj":
        # Linear dolly over the whole run (reference: traj_renderer.py:519-527).
        progress = frame_index / max(total_frames - 1, 1)
        return (2.8 - 2.0 * progress, 2.8 - 2.0 * progress, 3.0 - 2.0 * progress)
    if preset == "traj_original":
        # Constant frame-199 pose (reference: traj_original.py:62-66).
        return (-1.8, -1.8, 1.8)
    start, mid, final = _WAYPOINTS[preset]
    if frame_index <= LAST_MOTION_FRAME:
        p = frame_index / max(LAST_MOTION_FRAME, 1)
        a, b = start, mid
    else:
        p = (frame_index - LAST_MOTION_FRAME) / max(FADE_FRAMES, 1)
        a, b = mid, final
    return tuple(a[i] + (b[i] - a[i]) * p for i in range(3))


def camera_origin_jax(preset: str, frame_index, total_frames: int = TOTAL_FRAMES):
    """Branchless jnp version of :func:`camera_origin` (frame_index may be traced)."""
    # NOTE: constants below stay NumPy so they embed as HLO literals under
    # jit (trace-time jnp arrays become hoisted executable parameters and
    # trip a pjit executable-cache bug in this JAX build).
    f = jnp.asarray(frame_index, jnp.float32)
    if preset == "example":
        return jnp.asarray(np.array([2.2, 2.2, 4.2], np.float32))
    if preset == "traj":
        p = f / max(total_frames - 1, 1)
        return np.array([2.8, 2.8, 3.0], np.float32) - 2.0 * p
    if preset == "traj_original":
        return jnp.asarray(np.array([-1.8, -1.8, 1.8], np.float32))
    start, mid, final = (
        np.array(w, np.float32) for w in _WAYPOINTS[preset]
    )
    p1 = f / LAST_MOTION_FRAME
    p2 = (f - LAST_MOTION_FRAME) / FADE_FRAMES
    phase1 = start + (mid - start) * p1
    phase2 = mid + (final - mid) * p2
    return jnp.where(f <= LAST_MOTION_FRAME, phase1, phase2)


def look_at_axes(origin, target, up=UP):
    """Orthonormal camera frame: right / up / forward.

    forward points from origin toward target; right = forward x up;
    camera-up = right x forward.  Image x increases along right, image y
    increases downward (along -camera-up).  NOTE: the reference hands the
    pose to Mitsuba's lookat (traj_ball_renderer.py:17); our rasterizer
    defines its own (right-handed, non-mirrored) pixel convention — the
    bit-compatible contract is the pose itself, not Mitsuba's film axes.
    """
    xp = jnp if isinstance(origin, jax.Array) or isinstance(target, jax.Array) else np
    origin = xp.asarray(origin, dtype=xp.float32)
    target = xp.asarray(target, dtype=xp.float32)
    up = xp.asarray(up, dtype=xp.float32)
    forward = target - origin
    forward = forward / xp.linalg.norm(forward)
    right = xp.cross(forward, up)
    right = right / xp.linalg.norm(right)
    cam_up = xp.cross(right, forward)
    return right, cam_up, forward


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """A posed perspective camera (pytree; all fields traceable)."""

    origin: jax.Array  # (3,)
    target: jax.Array  # (3,)
    up: jax.Array = dataclasses.field(
        default_factory=lambda: np.array(UP, np.float32)
    )
    fov_x_degrees: float = dataclasses.field(
        default=FOV_TRAJ, metadata=dict(static=True)
    )
    width: int = dataclasses.field(default=IMAGE_WIDTH, metadata=dict(static=True))
    height: int = dataclasses.field(default=IMAGE_HEIGHT, metadata=dict(static=True))
    near: float = dataclasses.field(default=NEAR_CLIP, metadata=dict(static=True))
    far: float = dataclasses.field(default=FAR_CLIP, metadata=dict(static=True))

    @property
    def tan_half_fov_x(self) -> float:
        return math.tan(math.radians(self.fov_x_degrees) * 0.5)

    def world_to_camera_matrix(self):
        """(3, 4) matrix mapping world points to camera space.

        Camera space: +x along image-right, +y along image-up, +z along the
        viewing direction (depth).  Returned as a single (3, 4).
        """
        right, cam_up, forward = look_at_axes(self.origin, self.target, self.up)
        rot = jnp.stack([right, cam_up, forward])  # (3, 3), rows are axes
        # Explicit muladds, NOT `-rot @ origin`: a float32 dot may run
        # in TF32 on a GPU, perturbing the translation (and every
        # projected pixel) vs the float32 NumPy oracle — the same reason
        # project.py avoids matmuls (CLAUDE.md bit-exactness convention).
        o = jnp.asarray(self.origin, jnp.float32)
        trans = -(rot[:, 0] * o[0] + rot[:, 1] * o[1] + rot[:, 2] * o[2])
        return jnp.concatenate([rot, trans[:, None]], axis=1)

    @staticmethod
    def from_preset(
        preset: str, frame_index: int = 0, total_frames: int = TOTAL_FRAMES
    ) -> "Camera":
        origin = jnp.asarray(
            camera_origin(preset, frame_index, total_frames), jnp.float32
        )
        target = jnp.asarray(TARGETS[preset], jnp.float32)
        fov = FOV_EXAMPLE if preset == "example" else FOV_TRAJ
        return Camera(origin=origin, target=target, fov_x_degrees=fov)
