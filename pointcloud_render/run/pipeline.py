"""The per-frame pipeline: load -> standardize -> transform -> render -> save.

Replaces the reference's Renderer.process() (traj_ball_renderer.py:365-398):
instead of writing an O(N) XML scene plus one temp curve file per point and
calling Mitsuba, the whole frame is a single jitted XLA program per
(preset, N, history-length) signature, cached across the trajectory.

The host side keeps the reference's exact state semantics (float64 NumPy
standardize/transform — the bit-compatibility contract); the device side
is float32.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_render.configs import ScenePreset
from pointcloud_render.geometry import droplet as droplet_mod
from pointcloud_render.geometry import rotation as rotation_mod
from pointcloud_render.geometry import trails as trails_mod
from pointcloud_render.io import loaders, png
from pointcloud_render.raster.primitives import (
    ScreenPrimitives,
    capsules_from_polylines,
    capsules_from_vertex_columns,
    discs_from_points,
    triangles_from_mesh,
)
from pointcloud_render.raster.project import project_points
from pointcloud_render.raster.render import (
    FrameBuffers,
    RasterConfig,
    ground_plane,
    render,
)
from pointcloud_render.scene import normalize
from pointcloud_render.scene.camera import TARGETS, Camera, camera_origin_jax

# Straight velocity trails render as this many collinear capsules (same
# union coverage as the reference's 20 — see build_primitives).
VEL_TRAIL_RENDER_SEGMENTS = 8


#: Static per-trail capsule-row budget of the adaptive velocity-trail
#: build (``trail_segments="adaptive"``).  4 matches the tuned fixed
#: default, so the soup SHAPES (and the sharding layout) are identical
#: to ``trail_segments=4`` — only the per-trail validity pattern and
#: vertex t values change.
TRAIL_ADAPTIVE_BUDGET = 4

#: Raster tile edge assumed by the adaptive segment-count heuristic
#: (the csr backend's 32x32-pixel tiles).  A heuristic input
#: only — any k renders exactly; this just picks the cheapest.
_TILE = 32.0


def _adaptive_trail_segment_counts(positions, direction, trail_length,
                                   camera, radius_world,
                                   budget: int = TRAIL_ADAPTIVE_BUDGET):
    """Per-trail slot-optimal segment count k in 1..budget.

    A k-segment split of a straight screen-space trail of tile extents
    (a, b) = (ex, ey)/32 bins ~ k * (a/k + 1) * (b/k + 1)
    = a*b/k + a + b + k slots: splitting a DIAGONAL trail shrinks the
    quadratic bbox term while every split adds its +1-tile alignment
    slab, so the optimum is k* ~ sqrt(a*b) — 1 for the short trails
    that dominate the cloud, more for long close-camera diagonals
    (measured ratios vs fixed k=4: 0.77-0.89 of total frame slots over
    the trajectory).  Segments whose extent would overflow the span-4
    binning (> 3 tiles per axis) get a large penalty so the big list
    only sees trails no in-budget k can fit.
    """
    far = positions + direction * trail_length[:, None]
    pr = project_points(jnp.concatenate([jnp.asarray(positions,
                                                     jnp.float32), far]),
                        camera, radii=radius_world)
    n = positions.shape[0]
    ex = jnp.abs(pr["px"][n:] - pr["px"][:n]) + pr["r_px"][:n] \
        + pr["r_px"][n:]
    ey = jnp.abs(pr["py"][n:] - pr["py"][:n]) + pr["r_px"][:n] \
        + pr["r_px"][n:]
    emax = jnp.maximum(ex, ey)
    costs = []
    for kk in range(1, budget + 1):
        c = kk * (ex / (_TILE * kk) + 1.0) * (ey / (_TILE * kk) + 1.0)
        c = c + jnp.where(emax / kk > 3.0 * _TILE, 1e6, 0.0)
        costs.append(c)
    return jnp.argmin(jnp.stack(costs), axis=0).astype(jnp.int32) + 1


def build_primitives(preset: ScenePreset, camera: Camera, positions,
                     velocities=None, frame_index=0, history=None,
                     rotations=None, droplet_lod: str = "capsule",
                     return_layout: bool = False,
                     trail_segments: int = None,
                     packed_build: bool = True):
    """Assemble the frame's primitive soup (traceable).

    Primitive order (= depth-tie priority): ground, splats, trails.

    With ``return_layout=True`` also returns the soup's part layout as a
    list of ``(rows, rows_per_point)`` tuples (``rows_per_point == 0`` for
    fixed furniture like the ground).  Every per-point part is row-major in
    point index, so the layout is enough to map a row of a point-SHARD's
    soup to its id in the full-cloud soup (parallel/render_parallel.py).

    ``trail_segments`` overrides VEL_TRAIL_RENDER_SEGMENTS (velocity
    trails only; 1..20).  Fewer, longer capsules shrink the soup
    proportionally (sort/row-gather/build are O(prims)) at the cost of a
    coarser chord approximation and a larger per-capsule screen bbox
    (quadratically more binned tiles for diagonal trails, earlier
    big-list spill) — a measured per-scene trade, exposed for A/B
    (bench.py --trail-segments).
    """
    parts = [ground_plane(camera, preset.ground_half_extent,
                          preset.ground_center)]
    per_point = [0]  # ground: fixed rows, not per-point
    color = np.asarray(preset.point_color, np.float32)
    n = positions.shape[0]

    if preset.splat == "sphere":
        parts.append(discs_from_points(
            positions, camera, np.full((n,), preset.point_radius, np.float32), color))
        per_point.append(1)
    elif preset.splat == "droplet":
        if rotations is None:
            if velocities is None:
                rotations = np.broadcast_to(np.eye(4, dtype=np.float32),
                                            (n, 4, 4))
            else:
                rotations = rotation_mod.rotation_matrices_from_velocities(
                    velocities, positions)
        if droplet_lod == "mesh":
            verts, faces = droplet_mod.instance_droplets(rotations, positions)
            tris = triangles_from_mesh(verts, faces, camera, color)
            parts.append(tris)
            # Near-clipping emits two stacked blocks of F rows each
            # (primitives._near_clip_triangles); both blocks are row-major
            # per point, so the layout records them as two entries.
            per_point.append(("split2", tris.count // (2 * n)))
        else:
            # Capsule LOD: head sphere + tapering tail along the rotated
            # -z axis (column 2 of R gives R @ (0,0,-1) = tail direction).
            tail_dir = -rotations[:, :3, 2]
            tip = positions + tail_dir * droplet_mod.TAIL_TIP_OFFSET
            parts.append(discs_from_points(
                positions, camera,
                np.full((n,), droplet_mod.BASE_RADIUS, np.float32), color))
            per_point.append(1)
            # Tapered tail: mesh radius at the cap edge down to a point
            # (the teardrop's r*(1-t)^2 profile, traj_renderer.py:129).
            taper = np.broadcast_to(
                np.array([droplet_mod.BASE_RADIUS * 0.6,
                          droplet_mod.BASE_RADIUS * 0.05], np.float32),
                (n, 2))
            if packed_build:
                ones = np.ones((n,), bool)
                parts.append(capsules_from_vertex_columns(
                    [jnp.asarray(positions, jnp.float32), tip],
                    [ones, ones], camera, taper, color))
            else:
                seg = jnp.stack([positions, tip], axis=1)  # (N, 2, 3)
                parts.append(capsules_from_polylines(
                    seg, np.ones((n, 2), bool), camera, taper, color))
            per_point.append(1)
    else:
        raise ValueError(f"unknown splat kind {preset.splat!r}")

    if preset.trail == "velocity" and velocities is not None:
        # A velocity trail is a STRAIGHT constant-radius polyline
        # (trails.py: p + dir * L * ts); its projection stays a straight
        # line, so a coarser subsample of the same endpoints is a CLOSE
        # APPROXIMATION of the 20-segment union — but not exact: the
        # projected capsule radius r_px tapers with true 1/z while each
        # screen capsule interpolates z and r linearly in its screen
        # parameter, so coarser segments shift sub-pixel coverage and
        # depth slightly (the roundtrip test bounds winner flips at
        # ~0.1% of pixels).  Rendering uses
        # VEL_TRAIL_RENDER_SEGMENTS segments — 2.5x fewer primitives —
        # kept short enough (<= ~1/8 of the trail)
        # that each segment still fits the 2x2-tile binning of the csr
        # backend instead of falling to the O(T x big) list.
        # The state-layer 21-point trail (golden vs the reference's
        # curve files) is unchanged; this is the render-layer soup.
        # Only the sampled vertices are COMPUTED (bit-identical to
        # subsampling the full 21-point build; ~60% of the trail-point
        # work at 1M points was discarded vertices).
        segs = (VEL_TRAIL_RENDER_SEGMENTS if trail_segments is None
                else trail_segments)
        if segs == "adaptive":
            # Per-trail slot-optimal k in 1..TRAIL_ADAPTIVE_BUDGET:
            # static budget+1 vertices per trail (same soup shapes and
            # sharding layout as fixed segments=budget); rows past a
            # trail's k are invalid, so they sort past every binned key
            # and bin ZERO slots.  Each trail's geometry is bit-equal
            # to the fixed k-segment sampled build (fidelity certified
            # per preset like the fixed counts — utils/fidelity.py).
            direction, tlen, _ = trails_mod.velocity_trail_lengths(
                positions, velocities, frame_index, preset.trail_schedule)
            k = _adaptive_trail_segment_counts(
                jnp.asarray(positions, jnp.float32), direction, tlen,
                camera, preset.trail_radius)
            ends, vertex_valid = trails_mod.velocity_trails_adaptive(
                positions, velocities, frame_index, k,
                TRAIL_ADAPTIVE_BUDGET, preset.trail_schedule)
        else:
            if not 1 <= segs <= trails_mod.N_TRAIL_POINTS:
                raise ValueError(
                    "trail_segments must be 'adaptive' or in 1.."
                    f"{trails_mod.N_TRAIL_POINTS}")
            sub = np.round(np.linspace(0, trails_mod.N_TRAIL_POINTS,
                                       segs + 1)).astype(np.int32)
            if packed_build:
                # Packed-column build: bit-identical geometry with one
                # (N,) column per trail vertex instead of (N, K) polyline
                # arrays (capsules_from_vertex_columns docstring).
                vcols, valid = trails_mod.velocity_trail_vertex_columns(
                    positions, velocities, frame_index, sub,
                    preset.trail_schedule)
                parts.append(capsules_from_vertex_columns(
                    vcols, [valid] * len(vcols), camera,
                    preset.trail_radius,
                    np.asarray(preset.trail_color, np.float32)))
                per_point.append(len(vcols) - 1)
                ends = None
            else:
                ends, valid = trails_mod.velocity_trails_sampled(
                    positions, velocities, frame_index, sub,
                    preset.trail_schedule)
                vertex_valid = jnp.broadcast_to(valid[:, None],
                                                ends.shape[:2])
        if ends is not None:
            parts.append(capsules_from_polylines(
                ends, vertex_valid, camera, preset.trail_radius,
                np.asarray(preset.trail_color, np.float32)))
            per_point.append(ends.shape[1] - 1)
    elif preset.trail == "history" and history is not None \
            and history.shape[0] > 0:
        pts, valid, keep = trails_mod.catmull_rom_trails(history, positions)
        vertex_valid = keep & valid[:, None]
        parts.append(capsules_from_polylines(
            pts, vertex_valid, camera, preset.trail_radius,
            np.asarray(preset.trail_color, np.float32)))
        per_point.append(pts.shape[1] - 1)

    soup = ScreenPrimitives.concatenate(parts)
    if not return_layout:
        return soup
    layout = []
    for part, c in zip(parts, per_point):
        if isinstance(c, tuple):  # ("split2", faces_per_point)
            half = part.count // 2
            layout += [(half, c[1]), (half, c[1])]
        else:
            layout.append((part.count, c))
    return soup, layout


def _make_step(preset, raster_config, droplet_lod, with_vel, with_history,
               with_rotations, film=None):
    import dataclasses as _dc

    from pointcloud_render.shading import aa
    from pointcloud_render.scene.camera import IMAGE_HEIGHT, IMAGE_WIDTH

    if preset.splat != "sphere" and droplet_lod == "mesh":
        # Mesh-LOD droplets: bin the small triangles so only the ground
        # rides the big list.
        raster_config = _dc.replace(raster_config, bin_triangles=True)
    ss = raster_config.supersample
    if ss > 1:
        # Supersampling scales every screen extent by ss; binning at
        # span * ss keeps the same primitives off the big list as the
        # 1x render (exactness-neutral: span only moves prims between
        # the binned ranges and the big list).
        raster_config = _dc.replace(raster_config,
                                    span=raster_config.span * ss)

    def step(positions, velocities, frame_index, history, rotations):
        origin = camera_origin_jax(preset.camera_preset, frame_index,
                                   preset.total_frames)
        w, h = film if film else (IMAGE_WIDTH, IMAGE_HEIGHT)
        camera = Camera(origin=origin,
                        target=np.asarray(TARGETS[preset.camera_preset],
                                          np.float32),
                        fov_x_degrees=preset.fov_x_degrees,
                        width=w * ss, height=h * ss)
        prims = build_primitives(
            preset, camera,
            positions,
            velocities if with_vel else None,
            frame_index,
            history if with_history else None,
            rotations if with_rotations else None,
            droplet_lod=droplet_lod,
        )
        shading = raster_config.shading
        if shading.shadows or shading.ground_spec > 0.0 or shading.gi > 0.0:
            # Look passes beyond render()'s shade: area-emitter shadows
            # (shading/shadow.py), the GGX ground lobe
            # (shading/shade._ggx_specular), and the ground-bounce GI
            # fill (ShadingConfig.gi).  The CAMERA raster still runs
            # the configured backend for depth/index
            # and the per-frame certificate; only the rgb is RE-shaded
            # through shade_framebuffer (rgb-only by construction —
            # review r3: this branch used to hardcode a zero diag,
            # making the certificate vacuous under shadows).
            from pointcloud_render.shading.shade import (  # noqa: PLC0415
                shade_framebuffer,
            )

            fb0, diag = render(prims, camera, raster_config,
                               return_diag=True)
            depth, index = fb0.depth, fb0.index
            sf = None
            if shading.shadows:
                # Re-build the soup from the emitter's viewpoint and
                # raster its z-buffer.  The shadow map is a LOOK
                # approximation (its capped tiled raster can drop
                # occluders = missing shadow, never a wrong winner).
                from pointcloud_render.shading.shadow import (  # noqa: PLC0415
                    light_camera,
                    render_shadow_depth,
                    shadow_factor,
                )

                light_cam = light_camera(size=shading.shadow_size)
                prims_light = build_primitives(
                    preset, light_cam, positions,
                    velocities if with_vel else None, frame_index,
                    history if with_history else None,
                    rotations if with_rotations else None,
                    droplet_lod=droplet_lod)
                sdepth = render_shadow_depth(prims_light, light_cam)
                sf = shadow_factor(
                    camera, depth, index, light_cam, sdepth,
                    bias=shading.shadow_bias,
                    min_light=shading.shadow_min_light,
                    taps=shading.shadow_taps,
                    emitter_half=shading.shadow_emitter_half,
                    max_radius_px=shading.shadow_max_radius_px)
            rgb = shade_framebuffer(prims, camera, depth, index, shading,
                                    shadow=sf)
            fb = FrameBuffers(rgb=rgb, depth=depth, index=index)
        else:
            # Per-frame device-side exactness certificate:
            # the caller checks it on EVERY rendered frame — a later
            # frame's closer camera can overflow what a first-frame
            # probe certified.
            fb, diag = render(prims, camera, raster_config,
                              return_diag=True)
        if ss != 1:
            # Filtered RGB at target resolution; depth/index keep the
            # nearest supersample's winners (AA is a look feature — the
            # bit-exact contract is ss=1, shading/aa.py docstring).
            fb = FrameBuffers(rgb=aa.downsample(fb.rgb, ss),
                              depth=fb.depth[::ss, ::ss],
                              index=fb.index[::ss, ::ss])
        return fb, diag["overflow"]

    return step


_STEPS = {}


def _render_step(preset, raster_config, droplet_lod, with_vel, with_history,
                 with_rotations, film, *args):
    """Run the jitted frame step of this configuration (one per config)."""
    key = (preset, raster_config, droplet_lod, with_vel, with_history,
           with_rotations, film)
    step = _STEPS.get(key)
    if step is None:
        step = _STEPS[key] = jax.jit(_make_step(*key))
    return step(*args)


class FramePipeline:
    """Stateful host-side orchestrator for one preset."""

    def __init__(self, preset: ScenePreset,
                 raster_config: Optional[RasterConfig] = None,
                 droplet_lod: str = "capsule", width: Optional[int] = None,
                 height: Optional[int] = None):
        self.preset = preset
        self.raster_config = raster_config or RasterConfig()
        self.droplet_lod = droplet_lod
        self.film = (width, height) if width and height else None

    # -- state layer (host, reference-exact) -------------------------------
    def load_and_prepare(self, file_path: str):
        """load -> (N,3|6) -> standardize -> transform (reference order,
        traj_ball_renderer.py:369-374; 3-D stacks take frame 0,
        traj_ball_renderer.py:370-371)."""
        pcl = loaders.load_point_cloud(
            file_path, positions_only=self.preset.positions_only)
        if pcl.ndim == 3:
            pcl = pcl[0]
        return self._prepare(pcl)

    def _prepare(self, pcl):
        pcl = normalize.standardize_point_cloud(pcl)
        return normalize.transform_coordinates(pcl, flip_x=self.preset.flip_x)

    def load_stack(self, file_path: str):
        """All frames of a (possibly stacked) file, prepared — the
        example_renderer iterates every frame of 3-D stacks
        (example_renderer.py:165-169)."""
        pcl = loaders.load_point_cloud(
            file_path, positions_only=self.preset.positions_only)
        if pcl.ndim == 2:
            pcl = pcl[None]
        return [self._prepare(f) for f in pcl]

    # -- device layer -------------------------------------------------------
    def render_array(self, pcl: np.ndarray, frame_index: int,
                     history: Optional[np.ndarray] = None) -> FrameBuffers:
        """Render a prepared (N, 3|6) array; history is (H, N, 3) or None."""
        has_vel = pcl.shape[1] == 6
        positions = jnp.asarray(pcl[:, :3], jnp.float32)
        velocities = jnp.asarray(pcl[:, 3:6], jnp.float32) if has_vel else (
            jnp.zeros_like(positions))

        rotations = jnp.zeros((0, 4, 4), jnp.float32)
        with_rotations = False
        if self.preset.splat == "droplet" and not has_vel \
                and self.preset.trail == "history":
            # traj_renderer falls back to seeded random per-point rotations
            # (traj_renderer.py:566-568); inherently sequential host RNG.
            mats = np.stack([
                rotation_mod.random_rotation_matrix(i, pcl[i, :3])
                for i in range(pcl.shape[0])
            ]).reshape(-1, 4, 4).astype(np.float32)
            rotations = jnp.asarray(mats)
            with_rotations = True

        with_history = (self.preset.trail == "history" and history is not None
                        and len(history) > 0)
        if with_history:
            history = jnp.asarray(
                np.asarray(history, np.float32)[:, :, :3])
        else:
            history = jnp.zeros((0, positions.shape[0], 3), jnp.float32)

        import dataclasses as _dc

        for _attempt in range(5):
            fb, ovf = _render_step(
                self.preset, self.raster_config, self.droplet_lod,
                has_vel, with_history, with_rotations, self.film,
                positions, velocities, jnp.int32(frame_index), history,
                rotations)
            # Per-frame certificate: the device-side diag
            # rides the frame fetch — overflow/capacity violations fail
            # on the exact frame instead of a first-frame probe's guess.
            ovf = int(np.asarray(ovf))
            if ovf == 0:
                break
            # Self-heal instead of asking the user to turn the knob the
            # error names: quadruple the overflowing capacity (tiled's
            # per-tile table or the csr big list) and re-dispatch —
            # a recompile per doubling, only on scenes that outgrow the
            # default, and exactness is certified on the retry too.
            from pointcloud_render.raster.render import (  # noqa: PLC0415
                resolve_backend,
            )

            backend = resolve_backend(self.raster_config.backend)
            if backend == "tiled":
                new = self.raster_config.max_per_tile * 4
                self.raster_config = _dc.replace(self.raster_config,
                                                 max_per_tile=new)
                what = f"max_per_tile -> {new}"
            else:
                new = max(self.raster_config.max_big * 4,
                          self.raster_config.max_big + ovf)
                self.raster_config = _dc.replace(self.raster_config,
                                                 max_big=new)
                what = f"max_big -> {new}"
            print(f"Frame {frame_index}: overflow ({ovf} primitives); "
                  f"retrying with {what}")
        else:
            raise RuntimeError(
                f"overflow ({ovf} primitives) at frame {frame_index} "
                f"after capacity retries — the render dropped them. "
                f"Reduce primitive screen extents, or raise span if the "
                f"overflow is long trail segments.")
        return fb

    # -- full frame ----------------------------------------------------------
    def process(self, file_path: str, frame_index: int = 0,
                history: Optional[np.ndarray] = None,
                output_folder: Optional[str] = None,
                write_depth: bool = False) -> str:
        """Reference process() parity: returns the written PNG path.

        For iterate_stack presets every frame of a 3-D stack renders in
        sequence to the same output name, exactly like the reference
        (example_renderer.py:165-199 — the last frame's PNG survives).
        """
        if self.preset.iterate_stack:
            for pcl in self.load_stack(file_path):
                fb = self.render_array(pcl, frame_index, history)
        else:
            pcl = self.load_and_prepare(file_path)
            fb = self.render_array(pcl, frame_index, history)
        return self.save_outputs(
            fb, file_path, frame_index,
            output_folder or self.preset.output_folder, write_depth)

    def save_outputs(self, fb, file_path: str, frame_index: int,
                     folder: str, write_depth: bool = False) -> str:
        """Write the frame's PNG (+ optional depth dump) under the
        reference naming contract (preset.output_name: frame_{idx:04d}
        _b0 rename past 199, else the input stem).  The ONE place that
        computes output names — run_batch's manifest resume matches by
        this basename, so batch and pipeline must never diverge."""
        stem = os.path.splitext(os.path.basename(file_path))[0]
        name = self.preset.output_name(frame_index, stem)
        os.makedirs(folder, exist_ok=True)
        out_path = os.path.join(folder, f"{name}.png")
        png.write_png(out_path, np.asarray(fb.rgb))
        if write_depth:
            np.save(os.path.join(folder, f"{name}_depth.npy"),
                    np.asarray(fb.depth))
        return out_path
