"""Declarative scene presets replaying the seven reference scripts.

The reference customizes by subclassing renderer classes and copying whole
files with edited constants (SURVEY.md §2 duplication note; traj_b1 is
traj_b0 with ~10 lines changed).  Here each script is one ScenePreset
value; the pipeline consumes presets, so a new variant is a dataclass
literal instead of a file copy.

Every constant is cited to its reference source; the golden pipeline tests
replay these against the transliteration oracles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from pointcloud_render.scene.pointcloud import (
    DEFAULT_POINT_COLOR,
    DEFAULT_SPHERE_RADIUS,
    TRAIL_COLOR,
    TRAIL_RADIUS,
)


@dataclasses.dataclass(frozen=True)
class ScenePreset:
    name: str
    camera_preset: str  # key into scene.camera trajectory/target tables
    fov_x_degrees: float  # 36 traj / 30 example
    flip_x: bool  # transform_coordinates x-flip (False for b0/b1/original)
    splat: str  # "sphere" | "droplet"
    trail: Optional[str]  # None | "velocity" | "history"
    trail_schedule: str  # "ball" | "vel" | "fixed"
    ground_half_extent: float
    ground_center: Tuple[float, float, float]
    samples_per_pixel: int  # reference provenance only (path-tracer spp)
    input_folder: str
    file_pattern: str  # frame-file name synthesis
    frames: Sequence[int]  # frame indices driven by the batch CLI
    total_frames: int = 220
    output_folder: str = "render"
    positions_only: bool = False  # example_renderer drops extra columns
    iterate_stack: bool = False  # example iterates all frames of 3-D stacks
    point_color: Tuple[float, float, float] = DEFAULT_POINT_COLOR
    point_radius: float = DEFAULT_SPHERE_RADIUS
    trail_color: Tuple[float, float, float] = TRAIL_COLOR
    trail_radius: float = TRAIL_RADIUS
    history_window: int = 20  # traj_renderer.py:755
    # Frames past this index reuse its file (the traj family's fade
    # frames 200-219 reload frame_0199, traj_ball_renderer.py:434-439).
    # None = every frame has its own file (the example preset renders
    # pts_0..pts_661 with NO clamp, example_renderer.py:209-211 — a
    # total_frames>200 heuristic wrongly caught it).
    reuse_frame_after: Optional[int] = 199

    def frame_file(self, frame_index: int) -> str:
        """Frame-file name for an index (see reuse_frame_after)."""
        if "{n" in self.file_pattern:
            n = frame_index
            if self.reuse_frame_after is not None:
                n = min(n, self.reuse_frame_after)
            return self.file_pattern.format(n=n)
        return self.file_pattern

    def output_name(self, frame_index: int, stem: str) -> str:
        """Reference output naming (traj_ball_renderer.py:376)."""
        if self.name == "example":
            return stem
        return f"frame_{frame_index:04d}_b0" if frame_index > 199 else stem


_TRAJ_FRAMES = tuple(range(220))

EXAMPLE = ScenePreset(
    # reference: example_renderer.py (static camera, 256 spp, ground z=-0.2)
    name="example",
    camera_preset="example",
    fov_x_degrees=30.0,  # example_renderer.py:22
    flip_x=True,
    splat="sphere",
    trail=None,
    trail_schedule="fixed",
    ground_half_extent=10.0,  # example_renderer.py:59
    ground_center=(0.0, 0.0, -0.2),  # example_renderer.py:60
    samples_per_pixel=256,  # example_renderer.py:24
    input_folder="ply",
    file_pattern="pts_{n}.ply",  # example_renderer.py:211
    frames=tuple(range(662)),  # pts_0..pts_661
    total_frames=662,
    positions_only=True,
    iterate_stack=True,
    reuse_frame_after=None,  # every pts_i.ply is its own frame
)

TRAJ = ScenePreset(
    # reference: traj_renderer.py (droplets + history-fit trails, 256 spp)
    name="traj",
    camera_preset="traj",
    fov_x_degrees=36.0,
    flip_x=True,
    splat="droplet",
    trail="history",
    trail_schedule="fixed",
    ground_half_extent=10.0,  # traj_renderer.py:69
    ground_center=(0.0, 0.0, -0.5),  # traj_renderer.py:70
    samples_per_pixel=256,  # traj_renderer.py:28
    input_folder="trajectory_ply",
    file_pattern="frame_{n:04d}_b0.ply",
    frames=_TRAJ_FRAMES,
)

TRAJ_BALL = ScenePreset(
    # reference: traj_ball_renderer.py (spheres + velocity trails, 128 spp)
    name="traj_ball",
    camera_preset="traj_ball",
    fov_x_degrees=36.0,
    flip_x=True,
    splat="sphere",
    trail="velocity",
    trail_schedule="ball",  # traj_ball_renderer.py:119-124
    ground_half_extent=10.0,
    ground_center=(0.0, 0.0, -0.5),
    samples_per_pixel=128,
    input_folder="trajectory_ply",
    file_pattern="frame_{n:04d}_b0.ply",
    frames=_TRAJ_FRAMES,
)

TRAJ_VEL = ScenePreset(
    # reference: traj_vel_renderer.py (droplets + 3-phase velocity trails)
    name="traj_vel",
    camera_preset="traj_vel",
    fov_x_degrees=36.0,
    flip_x=True,
    splat="droplet",
    trail="velocity",
    trail_schedule="vel",  # traj_vel_renderer.py:215-224
    ground_half_extent=10.0,
    ground_center=(0.0, 0.0, -0.5),
    samples_per_pixel=128,
    input_folder="trajectory_ply",
    file_pattern="frame_{n:04d}_b0.ply",
    frames=_TRAJ_FRAMES,
)

TRAJ_B0 = ScenePreset(
    # reference: traj_b0.py (no x-flip, custom path/target, big ground)
    name="traj_b0",
    camera_preset="traj_b0",
    fov_x_degrees=36.0,
    flip_x=False,  # traj_b0.py:62-82
    splat="sphere",
    trail="velocity",
    trail_schedule="fixed",  # traj_b0.py:127
    ground_half_extent=20.0,  # traj_b0.py:45
    ground_center=(10.0, 10.0, -0.8),  # traj_b0.py:46
    samples_per_pixel=128,
    input_folder="batch_0",
    file_pattern="frame_{n:04d}_b0.ply",
    frames=_TRAJ_FRAMES,
)

TRAJ_B1 = dataclasses.replace(
    TRAJ_B0,
    # reference: traj_b1.py — identical to b0 except waypoints/target
    # (handled by camera_preset), input folder and file suffix.
    name="traj_b1",
    camera_preset="traj_b1",
    input_folder="batch_1",
    file_pattern="frame_{n:04d}_b1.ply",
)

TRAJ_ORIGINAL = ScenePreset(
    # reference: traj_original.py (constant f199 camera, frames 139-199)
    name="traj_original",
    camera_preset="traj_original",
    fov_x_degrees=36.0,
    flip_x=False,  # traj_original.py:40-60
    splat="sphere",
    trail="velocity",
    trail_schedule="fixed",  # traj_original.py:77
    ground_half_extent=10.0,  # inherits ball TAIL, traj_ball_renderer.py:58-65
    ground_center=(0.0, 0.0, -0.5),
    samples_per_pixel=128,
    input_folder="trajectory_ply",
    file_pattern="frame_{n:04d}_b0.ply",
    frames=(139, 159, 179, 199),  # traj_original.py:153
)

PRESETS = {
    p.name: p
    for p in (EXAMPLE, TRAJ, TRAJ_BALL, TRAJ_VEL, TRAJ_B0, TRAJ_B1,
              TRAJ_ORIGINAL)
}
