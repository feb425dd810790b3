"""On-device trajectory rendering: the frame loop as a lax.scan.

The reference renders a 220-frame flythrough as 220 independent
script-level iterations, reloading and re-preparing the cloud each time
(traj_ball_renderer.py:460-467).  Here the whole loop runs on the device:
a lax.scan carries the (advected) cloud, evaluates the camera trajectory,
builds the frame's primitives and rasterizes — emitting sRGB uint8
frames, so a chunk of frames costs one dispatch and device->host moves
6 MB/frame instead of 24.

Static clouds use dt=0 (pure camera flythrough); dynamic clouds advect by
their velocities each frame (BASELINE.json config 4) with optional
motion coloring.

History-trail presets (traj) carry a rolling (window, N, 3) position
buffer in the scan state instead of the reference's preload-all-frames
pass (traj_renderer.py:718-742).  The buffer is prefilled with the
initial positions, so early frames' trails start degenerate (the
Catmull-Rom dedup collapses the duplicates — no trail) and grow
naturally as real history accumulates.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_render.configs import ScenePreset
from pointcloud_render.raster import csr
from pointcloud_render.raster.render import (
    RasterConfig,
    render,
    resolve_backend,
)
from pointcloud_render.run.pipeline import build_primitives
from pointcloud_render.scene import dynamics
from pointcloud_render.scene.camera import TARGETS, Camera, camera_origin_jax


def srgb_encode_u8(rgb):
    """Linear [0,1] float -> sRGB uint8, on device."""
    rgb = jnp.clip(rgb, 0.0, 1.0)
    srgb = jnp.where(rgb <= 0.0031308, rgb * 12.92,
                     1.055 * jnp.power(rgb, 1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(jnp.uint8)


class TrajectoryScanRenderer:
    """Renders frame chunks of a preset's trajectory in single dispatches."""

    def __init__(self, preset: ScenePreset,
                 raster_config: Optional[RasterConfig] = None,
                 dt: float = 0.0, motion_color: bool = False,
                 droplet_lod: str = "capsule", frames_per_chunk: int = 8):
        self.preset = preset
        self.raster_config = raster_config or RasterConfig()
        self.dt = float(dt)
        self.motion_color = motion_color
        self.droplet_lod = droplet_lod
        self.frames_per_chunk = int(frames_per_chunk)
        self._compiled = None

    def _make_chunk_fn(self):
        import dataclasses as _dc

        preset = self.preset
        config = self.raster_config
        if self._mesh_lod():
            # Mesh-LOD droplets: bin the small triangles so only the
            # ground rides the big list (run/pipeline._make_step does the
            # same).
            config = _dc.replace(config, bin_triangles=True)
        dt = self.dt
        motion = self.motion_color
        lod = self.droplet_lod
        with_history = preset.trail == "history"

        def chunk_fn(positions, velocities, frame_ids, real_mask, history):
            def step(carry, x):
                fi, real = x
                pos, vel, hist, ovf_max = carry
                origin = camera_origin_jax(preset.camera_preset, fi,
                                           preset.total_frames)
                camera = Camera(
                    origin=origin,
                    target=np.asarray(TARGETS[preset.camera_preset],
                                      np.float32),
                    fov_x_degrees=preset.fov_x_degrees)
                if motion:
                    prims, layout = build_primitives(
                        preset, camera, pos, vel, fi,
                        hist if with_history else None, None,
                        droplet_lod=lod, return_layout=True)
                    # Recolor the splats by speed: the first per-point
                    # block of the soup layout (head discs for droplet
                    # capsule LOD, discs for spheres) — NOT a hardcoded
                    # offset, which silently miscolors if the ground's
                    # near-clip row count ever changes.
                    off = 0
                    for count, per in layout:
                        if per == 1:
                            break
                        off += count
                    else:
                        raise ValueError(
                            "motion_color needs a per-point splat block "
                            f"(layout {layout}) — mesh LOD unsupported")
                    colors = dynamics.motion_colors(vel)
                    prims = _dc.replace(
                        prims,
                        color=jax.lax.dynamic_update_slice_in_dim(
                            prims.color, colors, off, axis=0))
                else:
                    prims = build_primitives(
                        preset, camera, pos, vel, fi,
                        hist if with_history else None, None,
                        droplet_lod=lod)
                # Device-side exactness certificate, carried as a running
                # max over EVERY frame of the chunk (not just probed
                # samples — closes the probe-gap silent-truncation hole;
                # the streaming.py pattern).  One scalar pair leaves the
                # device per chunk.
                fb, diag = render(prims, camera, config, return_diag=True)
                ovf2 = jnp.maximum(ovf_max, diag["overflow"])
                # Rolling history: push the CURRENT positions (the frame
                # just rendered used only prior frames, reference
                # traj_renderer.py:754-761 semantics).  Chunk-padding
                # steps (real == False) replay the last frame id with the
                # state FROZEN: advecting/pushing through them would hand
                # back positions and history over-advected by the pad
                # length.
                if with_history:
                    pushed = jnp.concatenate([hist[1:], pos[None]], axis=0)
                    new_hist = jnp.where(real, pushed, hist)
                else:
                    new_hist = hist
                if dt:
                    new_pos = jnp.where(real,
                                        dynamics.advect(pos, vel, dt), pos)
                else:
                    new_pos = pos
                return (new_pos, vel, new_hist, ovf2), srgb_encode_u8(fb.rgb)

            (pos_out, _, hist_out, ovf_max), frames = jax.lax.scan(
                step, (positions, velocities, history, jnp.int32(0)),
                (frame_ids, real_mask))
            return frames, pos_out, hist_out, ovf_max

        return chunk_fn

    def _mesh_lod(self):
        return self.preset.splat != "sphere" and self.droplet_lod == "mesh"

    def _probe_max_big(self, positions, velocities, frame_indices):
        """Size config.max_big from the measured big-list overflow at
        sampled trajectory frames (+50% margin).  The csr backend has no
        per-tile capacity (raster/csr.py) — the only truncation risk is
        the big list, which close-dolly trail frames can push past the
        1024 default.  The scan's per-frame overflow
        certificate still re-checks EVERY frame post hoc; this probe
        just avoids a wasted first render.  Advects the cloud to each
        sampled frame when dt != 0.
        """
        import dataclasses as _dc

        from pointcloud_render.run.pipeline import build_primitives
        from pointcloud_render.scene.camera import (
            IMAGE_HEIGHT,
            IMAGE_WIDTH,
        )

        from pointcloud_render.geometry.trails import HISTORY_WINDOW

        preset = self.preset
        ids = sorted(frame_indices)
        if not ids:
            return
        samples = {ids[0], ids[len(ids) // 4], ids[len(ids) // 2],
                   ids[3 * len(ids) // 4], ids[-1]}
        with_history = preset.trail == "history"
        dt = self.dt

        def probe(fi, p, v):
            camera = Camera(
                origin=camera_origin_jax(preset.camera_preset, fi,
                                         preset.total_frames),
                target=np.asarray(TARGETS[preset.camera_preset],
                                  np.float32),
                fov_x_degrees=preset.fov_x_degrees)
            hist = None
            if with_history:
                # The render's rolling buffer holds the previous WINDOW
                # frames; under linear advection frame j's positions are
                # exactly p - v*dt*(fi - j) (clamped at frame 0, where
                # the buffer is prefilled with the initial cloud), so
                # the probe sees the REAL trail capsules instead of a
                # trail-less soup that undersizes max_big.
                offs = jnp.arange(HISTORY_WINDOW, 0, -1, dtype=jnp.float32)
                j = jnp.maximum(fi.astype(jnp.float32) - offs, 0.0)
                back = (dt * (fi.astype(jnp.float32) - j))[:, None, None]
                hist = p[None] - v[None] * back
            prims = build_primitives(preset, camera, p, v, fi, hist,
                                     droplet_lod=self.droplet_lod)
            return csr.bin_diagnostics(
                prims, IMAGE_WIDTH, IMAGE_HEIGHT,
                max_big=self.raster_config.max_big,
                bin_triangles=self._mesh_lod(),
                span=self.raster_config.span)

        jp = jax.jit(probe)
        worst = 0
        for fi in sorted(samples):
            p = (dynamics.advect(positions, velocities, self.dt * fi)
                 if self.dt else positions)
            worst = max(worst, int(np.asarray(jp(jnp.int32(fi), p,
                                                 velocities))))
        if worst > 0:
            mb = self.raster_config.max_big + int(worst * 1.5)
            self.raster_config = _dc.replace(
                self.raster_config, max_big=((mb + 511) // 512) * 512)

    def render_frames(self, positions, velocities, frame_indices):
        """Render the given frame indices in chunks; returns a list of
        (H, W, 3) uint8 numpy frames and the final (advected) positions."""
        from pointcloud_render.geometry.trails import HISTORY_WINDOW

        positions = jnp.asarray(positions, jnp.float32)
        velocities = jnp.asarray(velocities, jnp.float32)
        if (self._compiled is None
                and resolve_backend(self.raster_config.backend) == "csr"):
            self._probe_max_big(positions, velocities,
                                list(frame_indices))
        history = jnp.broadcast_to(positions[None],
                                   (HISTORY_WINDOW,) + positions.shape) \
            if self.preset.trail == "history" else \
            jnp.zeros((0,) + positions.shape, jnp.float32)
        out = []
        fpc = self.frames_per_chunk
        ids = list(frame_indices)
        for lo in range(0, len(ids), fpc):
            chunk_ids = ids[lo:lo + fpc]
            pad = fpc - len(chunk_ids)
            fi = jnp.asarray(chunk_ids + [chunk_ids[-1]] * pad, jnp.int32)
            real = jnp.asarray([True] * len(chunk_ids) + [False] * pad)
            if self._compiled is None:
                self._compiled = jax.jit(self._make_chunk_fn())
            frames, positions, history, ovf_max = self._compiled(
                positions, velocities, fi, real, history)
            self._certify_chunk(int(np.asarray(ovf_max)), chunk_ids)
            frames = np.asarray(frames)
            out.extend(frames[: len(chunk_ids)])
        return out, positions

    def _certify_chunk(self, ovf_max: int, chunk_ids):
        """Post-hoc per-chunk exactness check: the scan carried the max
        capacity overflow over EVERY rendered frame; an overflow means
        dropped primitives, so fail LOUDLY instead of returning a
        silently truncated image."""
        if ovf_max > 0:
            raise RuntimeError(
                f"overflow ({ovf_max} primitives) in frames "
                f"{chunk_ids[0]}..{chunk_ids[-1]} — the render dropped "
                f"them. Raise max_big (csr big list) or max_per_tile "
                f"(tiled backend), or reduce primitive screen extents.")
