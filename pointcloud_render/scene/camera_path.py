"""User-defined camera paths (generalizing the reference's schedules).

Every reference trajectory is a piecewise-linear waypoint schedule with
hardcoded constants (SURVEY.md §2 C4); CameraPath expresses arbitrary
ones — N waypoints, per-segment frame counts, linear or Catmull-Rom
interpolation — evaluable on the host (exact) or traced (for the
on-device trajectory scan).  The reference presets are reproducible as
CameraPath values (tested), so custom flythroughs are first-class
instead of requiring a new subclass per path (the reference's pattern,
traj_b0.py:84-115).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from pointcloud_render.scene.camera import (
    FOV_TRAJ,
    IMAGE_HEIGHT,
    IMAGE_WIDTH,
    Camera,
)


@dataclasses.dataclass(frozen=True)
class CameraPath:
    """Waypoint flythrough: K waypoints, K-1 segments.

    Frame f in segment s covers progress (f - start_s) / frames_s; the
    final frame of the schedule sits at the last waypoint.  Reference
    semantics note: the reference's two-phase schedules divide by the
    SEGMENT frame count with the segment's last frame mapping to
    progress 1.0 (traj_ball_renderer.py:294) — same here.
    """

    waypoints: Tuple[Tuple[float, float, float], ...]
    segment_frames: Tuple[int, ...]
    target: Tuple[float, float, float] = (0.0, 0.0, -0.05)
    fov_x_degrees: float = FOV_TRAJ
    interpolation: str = "linear"  # "linear" | "catmull"

    def __post_init__(self):
        if len(self.waypoints) < 1:
            raise ValueError("need at least one waypoint")
        if len(self.segment_frames) != max(len(self.waypoints) - 1, 0):
            raise ValueError("segment_frames must have len(waypoints) - 1")
        if any(nf <= 0 for nf in self.segment_frames):
            # A zero segment divides by zero on the host path and emits
            # NaN origins on the traced path — reject up front.
            raise ValueError(f"segment_frames must be positive, got "
                             f"{self.segment_frames}")

    @property
    def total_frames(self) -> int:
        return sum(self.segment_frames) + 1 if self.segment_frames else 1

    # -- host (exact) -------------------------------------------------------
    def origin(self, frame_index: int):
        w = [np.asarray(p, np.float64) for p in self.waypoints]
        if len(w) == 1:
            return tuple(w[0])
        f = float(frame_index)
        start = 0.0
        for s, nf in enumerate(self.segment_frames):
            if f <= start + nf or s == len(self.segment_frames) - 1:
                t = min(max((f - start) / nf, 0.0), 1.0)
                return tuple(self._interp(w, s, t))
            start += nf
        return tuple(w[-1])

    def _interp(self, w, s, t):
        if self.interpolation == "linear" or len(w) == 2:
            return w[s] + (w[s + 1] - w[s]) * t
        # Catmull-Rom with endpoint reflection (same construction as the
        # reference's trail spline, traj_renderer.py:282-295).
        p1, p2 = w[s], w[s + 1]
        p0 = w[s - 1] if s > 0 else w[0] - (w[1] - w[0])
        p3 = w[s + 2] if s + 2 < len(w) else w[-1] + (w[-1] - w[-2])
        t2, t3 = t * t, t * t * t
        return 0.5 * ((2 * p1) + (-p0 + p2) * t
                      + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                      + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)

    # -- traced -------------------------------------------------------------
    def origin_jax(self, frame_index):
        """Branchless traced form: per-segment values folded back-to-front
        so the first segment containing the frame wins."""
        f = jnp.asarray(frame_index, jnp.float32)
        w = [np.asarray(p, np.float32) for p in self.waypoints]
        if len(w) == 1:
            return jnp.asarray(w[0]) + 0.0 * f

        starts = np.concatenate([[0.0], np.cumsum(self.segment_frames)])
        vals, bounds = [], []
        for s, nf in enumerate(self.segment_frames):
            t = jnp.clip((f - starts[s]) / nf, 0.0, 1.0)
            if self.interpolation == "linear" or len(w) == 2:
                val = w[s] + (w[s + 1] - w[s]) * t
            else:
                p1, p2 = w[s], w[s + 1]
                p0 = w[s - 1] if s > 0 else w[0] - (w[1] - w[0])
                p3 = w[s + 2] if s + 2 < len(w) else w[-1] + (w[-1] - w[-2])
                t2, t3 = t * t, t * t * t
                val = 0.5 * ((2 * p1) + (-p0 + p2) * t
                             + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                             + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)
            vals.append(val)
            bounds.append(starts[s] + nf)
        out = vals[-1]
        for s in range(len(vals) - 2, -1, -1):
            out = jnp.where(f <= bounds[s], vals[s], out)
        return out

    def camera(self, frame_index, width: int = IMAGE_WIDTH,
               height: int = IMAGE_HEIGHT) -> Camera:
        origin = (self.origin_jax(frame_index)
                  if hasattr(frame_index, "dtype")
                  else jnp.asarray(self.origin(frame_index), jnp.float32))
        return Camera(origin=origin,
                      target=np.asarray(self.target, np.float32),
                      fov_x_degrees=self.fov_x_degrees,
                      width=width, height=height)


# The reference two-phase flythroughs as CameraPath values (equivalence
# is pinned by tests against scene.camera.camera_origin).
REFERENCE_PATHS = {
    "traj_ball": CameraPath(
        waypoints=((2.8, 2.8, 3.0), (1.8, 1.8, 1.8), (1.6, 1.6, 1.6)),
        segment_frames=(199, 20)),
    "traj_b0": CameraPath(
        waypoints=((-2.2, -3.3, 2.0), (-1.3, -2.5, 0.8), (-1.0, -2.0, 0.7)),
        segment_frames=(199, 20), target=(-0.02, 0.15, -0.05)),
    "traj_b1": CameraPath(
        waypoints=((-3.5, -2.5, 2.8), (-2.3, -1.5, 1.2), (-2.0, -1.2, 1.0)),
        segment_frames=(199, 20), target=(0.0, -0.02, 0.0)),
}
