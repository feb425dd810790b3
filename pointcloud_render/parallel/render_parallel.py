"""Distributed rendering over a device mesh.

The reference is strictly serial (one frame at a time, one process,
SURVEY.md §2 "parallelism: NONE"); this module adds two scale axes:

* **frame data-parallelism** — a batch of frames sharded over the mesh's
  'frames' axis via shard_map; each device renders its frames end-to-end
  (the rendering analogue of batch DP);
* **point sharding** — one frame whose cloud is split over the 'points'
  axis; every device rasterizes its shard into a private z-buffer with
  GLOBAL primitive indices, and the buffers merge with a two-collective
  lexicographic reduction (collectives XLA hands to NCCL on GPUs):
      depth*  = pmin(depth)
      winner  = pmin(where(depth == depth*, global_id, INT_MAX))
  followed by a psum color resolve (each shard contributes the shaded
  color only where the winner is local).  This is the z-buffer analogue
  of a sequence-parallel all-reduce (SURVEY.md §5).

Both paths compose: a 2D ('frames', 'points') mesh renders F frames, each
point-sharded, in one jitted program.

Two levels of API:

* ``render_point_sharded`` / ``render_batch_sharded`` — disc-only
  building blocks (flat color), used by the streaming composition;
* ``render_scene_point_sharded`` / ``render_scene_batch_sharded`` — the
  FULL reference scene (ground triangles + sphere/droplet splats +
  velocity trails, Lambert-shaded), winner-exact vs the single-device
  ``FramePipeline`` frame.  Per-shard primitive ids are mapped to their
  ids in the full-cloud soup via the part layout returned by
  ``run.pipeline.build_primitives`` — the lexicographic merge is then
  shard-count invariant by construction.  Bit equality with
  ``FramePipeline`` also needs the same soup bits: pass the frame index
  as a traced value (a jit argument), as FramePipeline does — a constant
  one lets XLA fold the camera pose at compile time, which rounds
  differently from the runtime pose, and edge pixels can flip.

Capacity: every path rasterizes through ``raster.render.rasterize``
(``config.backend``), and every entry point returns the capacity
OVERFLOW count (psum over shards; 0 = every primitive rasterized
exactly — the csr big-list or the tiled per-tile drop count).  Callers
must treat overflow > 0 as a failed render — raise ``max_big`` /
``max_per_tile`` and rerun.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pointcloud_render.raster.primitives import discs_from_points
from pointcloud_render.raster.render import rasterize
from pointcloud_render.scene.camera import TARGETS, Camera, camera_origin_jax
from pointcloud_render.shading.shade import shade_framebuffer

IMAX = np.int32(2147483647)
INF = np.float32(np.inf)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedFrame:
    """Replicated render result of a sharded frame (or frame batch)."""

    rgb: jax.Array  # (..., H, W, 3) float32
    depth: jax.Array  # (..., H, W) float32, +inf empty
    index: jax.Array  # (..., H, W) int32 GLOBAL prim id, -1 empty
    overflow: jax.Array  # (...,) int32 — binned entries dropped; 0 = exact


def make_render_mesh(n_frames_axis: int, n_points_axis: int,
                     devices=None) -> Mesh:
    """A ('frames', 'points') mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    need = n_frames_axis * n_points_axis
    if devices.size < need:
        raise ValueError(f"need {need} devices, have {devices.size}")
    grid = devices[:need].reshape(n_frames_axis, n_points_axis)
    return Mesh(grid, axis_names=("frames", "points"))


def _merge_and_resolve(prims, camera, depth, index, gid, shading,
                       axis_name, overflow):
    """Collective lexicographic z-merge + local-winner shaded color psum.

    depth/index are the LOCAL rasterization buffers, gid the per-pixel
    GLOBAL id of the local winner (IMAX where empty).  Global ids must be
    unique across shards (replicated furniture is masked to one shard),
    so exactly one shard owns each hit pixel.
    """
    d = jnp.where(index >= 0, depth, INF)
    best_depth = jax.lax.pmin(d, axis_name)
    contender = jnp.where(d == best_depth, gid, IMAX)
    best_gid = jax.lax.pmin(contender, axis_name)

    local_win = (index >= 0) & (d == best_depth) & (gid == best_gid)
    shade_idx = jnp.where(local_win, index, -1)
    rgb_local = shade_framebuffer(prims, camera, best_depth, shade_idx,
                                  shading)
    rgb = jax.lax.psum(jnp.where(local_win[..., None], rgb_local, 0.0),
                       axis_name)

    hit = best_gid != IMAX
    bg = np.asarray(shading.background, np.float32)
    rgb = jnp.where(hit[..., None], rgb, bg)
    return ShardedFrame(
        rgb=rgb,
        depth=jnp.where(hit, best_depth, INF),
        index=jnp.where(hit, best_gid, -1),
        overflow=jax.lax.psum(overflow, axis_name),
    )


def _shard_frame(positions, radii, colors, camera, config, axis_name):
    """Per-device slice of one frame's disc-only point-sharded render.

    positions: (N_local, 3) on each device; primitive ids are globalized
    with the shard offset so the lexicographic tie-break is device-count
    invariant.  Flat colors, no furniture — the full-scene path is
    ``_scene_shard_frame``.
    """
    n_local = positions.shape[0]
    shard = jax.lax.axis_index(axis_name)
    offset = shard * n_local

    prims = discs_from_points(positions, camera, radii, colors)
    depth, index, diag = rasterize(prims, camera.width, camera.height,
                                   config, return_diag=True)
    overflow = diag["overflow"]
    gindex = jnp.where(index >= 0, index + offset, IMAX)
    depth = jnp.where(index >= 0, depth, INF)

    # Collective lexicographic merge.
    best_depth = jax.lax.pmin(depth, axis_name)
    contender = jnp.where(depth == best_depth, gindex, IMAX)
    best_gidx = jax.lax.pmin(contender, axis_name)

    # Color resolve: my shard contributes where the winner is mine.
    local = (best_gidx >= offset) & (best_gidx < offset + n_local)
    local_idx = jnp.clip(best_gidx - offset, 0, n_local - 1)
    rgb_local = jnp.where(local[..., None], prims.color[local_idx], 0.0)
    rgb = jax.lax.psum(rgb_local, axis_name)

    hit = best_gidx != IMAX
    rgb = jnp.where(hit[..., None], rgb, 1.0)  # white background
    return (rgb, jnp.where(hit, best_depth, INF),
            jnp.where(hit, best_gidx, -1),
            jax.lax.psum(overflow, axis_name))


def render_point_sharded(positions, radii, colors, camera,
                         config, mesh: Mesh, axis: str = "points"):
    """Rasterize one disc-only frame with the cloud sharded over `axis`.

    Returns replicated (H, W, 3) rgb, (H, W) depth, global index, and the
    total binning overflow count (0 = exact; >0 = raise max_per_tile).
    """
    n = positions.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"point count {n} not divisible by {n_dev}")

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(*[None] * 3), P(*[None] * 2), P(*[None] * 2), P()),
        check_vma=False,
    )
    def run(pos, rad, col):
        return _shard_frame(pos, rad, col, camera, config, axis)

    return run(positions, radii, colors)


def render_batch_sharded(positions, radii, colors, camera, config,
                         mesh: Mesh):
    """Frames x points 2D-sharded disc-only batch render in ONE shard_map.

    positions: (F, N, 3); F divides mesh['frames'], N divides
    mesh['points'].  Each device holds a (F/df, N/dp) block, renders its
    point shards for its frames, and the z-buffers merge over the
    'points' axis only.  Returns (F, H, W[, 3]) rgb/depth/index with the
    frame axis sharded over 'frames', plus the (F,) overflow counts.
    """
    f = positions.shape[0]
    if f % mesh.shape["frames"] or positions.shape[1] % mesh.shape["points"]:
        raise ValueError("batch/point axes must divide the mesh axes")

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("frames", "points"), P("frames", "points"),
                  P("frames", "points")),
        out_specs=(P("frames"), P("frames"), P("frames"), P("frames")),
        check_vma=False,
    )
    def run(pos, rad, col):
        def one(args):
            p, r, c = args
            return _shard_frame(p, r, c, camera, config, "points")

        return jax.vmap(one)((pos, rad, col))

    return run(positions, radii, colors)


# ---------------------------------------------------------------------------
# Full-scene sharded rendering (ground + splats + trails, shaded)
# ---------------------------------------------------------------------------


def _scene_shard_frame(preset, config, axis_name, n_shards, film,
                       droplet_lod, positions, velocities, frame_index,
                       history, rotations, with_vel, with_history,
                       with_rotations):
    """One device's slice of a full-scene point-sharded frame.

    Builds the same primitive soup as the single-device pipeline
    (run.pipeline.build_primitives) over the LOCAL point shard, then maps
    every local primitive row to the id it would have in the full-cloud
    soup using the soup's part layout: per-point parts are row-major in
    point index, so local row i of a part with c rows/point maps to
    ``global_part_start + shard * n_local * c + i_within_part``.  Fixed
    furniture (the ground) keeps its global ids but is masked valid on
    shard 0 only, keeping global ids unique across shards.
    """
    from pointcloud_render.run.pipeline import build_primitives

    n_local = positions.shape[0]
    shard = jax.lax.axis_index(axis_name)

    film_kw = dict(width=film[0], height=film[1]) if film else {}
    camera = Camera(
        origin=camera_origin_jax(preset.camera_preset, frame_index,
                                 preset.total_frames),
        target=np.asarray(TARGETS[preset.camera_preset], np.float32),
        fov_x_degrees=preset.fov_x_degrees, **film_kw)

    prims, layout = build_primitives(
        preset, camera, positions,
        velocities if with_vel else None,
        frame_index,
        history if with_history else None,
        rotations if with_rotations else None,
        droplet_lod=droplet_lod, return_layout=True)

    # Static layout walk: local row -> full-soup id constants.
    offs = np.zeros(prims.count, np.int32)  # global_start - local_start
    scale = np.zeros(prims.count, np.int32)  # n_local * rows_per_point
    fixed = np.zeros(prims.count, bool)
    loc = glob = 0
    for rows, c in layout:
        sl = slice(loc, loc + rows)
        offs[sl] = glob - loc
        if c == 0:
            fixed[sl] = True
            glob += rows
        else:
            scale[sl] = rows  # rows == n_local * c
            glob += rows * n_shards
        loc += rows

    # Replicated furniture is valid on shard 0 only -> unique global ids.
    valid = prims.valid & (jnp.asarray(~fixed) | (shard == 0))
    prims = dataclasses.replace(prims, valid=valid)

    depth, index, diag = rasterize(prims, camera.width, camera.height,
                                   config, return_diag=True)

    safe = jnp.maximum(index, 0)
    gid = jnp.where(
        index >= 0,
        index + jnp.asarray(offs)[safe] + shard * jnp.asarray(scale)[safe],
        IMAX)
    return _merge_and_resolve(prims, camera, depth, index, gid,
                              config.shading, axis_name, diag["overflow"])


def render_scene_point_sharded(preset, positions, config, mesh: Mesh,
                               velocities=None, frame_index=0,
                               history=None, rotations=None,
                               axis: str = "points", width=None, height=None,
                               droplet_lod: str = "capsule") -> ShardedFrame:
    """Full-scene render of ONE frame, point-sharded over `axis`.

    Scene scope matches the reference's generate_xml_content
    (/root/reference/traj_ball_renderer.py:309-333: ground + spheres +
    velocity trails; droplet presets add oriented droplets,
    /root/reference/traj_renderer.py:529-576), Lambert-shaded; the result
    is winner-exact vs the single-device FramePipeline frame (with a
    traced ``frame_index``; module docstring).

    positions (N, 3) and optional velocities (N, 3) / history (T, N, 3) /
    rotations (N, 4, 4) are sharded on their point axis; N must divide
    the mesh axis.  Returns a replicated ShardedFrame.
    """
    n = positions.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"point count {n} not divisible by {n_dev}")

    with_vel = velocities is not None
    with_history = history is not None and history.shape[0] > 0
    with_rotations = rotations is not None
    velocities = (jnp.zeros_like(positions) if velocities is None
                  else velocities)
    history = (jnp.zeros((0, n, 3), jnp.float32) if history is None
               else history)
    rotations = (jnp.zeros((n, 4, 4), jnp.float32) if rotations is None
                 else rotations)
    film = (width, height) if width and height else None

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(None, axis), P(axis)),
        out_specs=ShardedFrame(rgb=P(None, None, None), depth=P(None, None),
                               index=P(None, None), overflow=P()),
        check_vma=False,
    )
    def run(pos, vel, fi, hist, rot):
        return _scene_shard_frame(
            preset, config, axis, n_dev, film, droplet_lod,
            pos, vel, fi, hist, rot, with_vel, with_history, with_rotations)

    return run(positions, velocities, jnp.int32(frame_index), history,
               rotations)


def render_scene_batch_sharded(preset, positions, velocities, frame_indices,
                               config, mesh: Mesh, width=None, height=None,
                               droplet_lod: str = "capsule") -> ShardedFrame:
    """Frames x points 2D-sharded FULL-SCENE batch render.

    positions/velocities: (F, N, 3) with F dividing mesh['frames'] and N
    dividing mesh['points']; frame_indices: (F,) int32 per-frame camera
    time.  Velocity-trail presets only (history trails need the rolling
    buffer, see run.trajectory).  Returns a ShardedFrame with leading
    frame axis sharded over 'frames'.

    Each device renders its frames one after another (``lax.map``), so
    every frame runs the unbatched per-frame program: a vmapped soup
    build fuses, and so rounds, differently from FramePipeline's.
    """
    f, n = positions.shape[:2]
    if f % mesh.shape["frames"] or n % mesh.shape["points"]:
        raise ValueError("batch/point axes must divide the mesh axes")
    n_dev = mesh.shape["points"]
    film = (width, height) if width and height else None

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("frames", "points"), P("frames", "points"), P("frames")),
        out_specs=ShardedFrame(rgb=P("frames"), depth=P("frames"),
                               index=P("frames"), overflow=P("frames")),
        check_vma=False,
    )
    def run(pos, vel, fis):
        def one(args):
            p, v, fi = args
            hist = jnp.zeros((0, p.shape[0], 3), jnp.float32)
            rot = jnp.zeros((p.shape[0], 4, 4), jnp.float32)
            return _scene_shard_frame(
                preset, config, "points", n_dev, film, droplet_lod,
                p, v, fi, hist, rot, True, False, False)

        return jax.lax.map(one, (pos, vel, fis))

    return run(positions, velocities, jnp.asarray(frame_indices, jnp.int32))


def render_frames_dp(step_fn, frame_args, mesh: Mesh, axis: str = "frames"):
    """Map a single-frame render step over a frame batch, sharded on `axis`.

    Args:
      step_fn: callable(*per_frame_args) -> pytree (e.g. FrameBuffers).
      frame_args: tuple of arrays with a leading frame axis (F, ...).
      mesh: mesh containing `axis`; F must divide by its size.
    """
    in_specs = tuple(P(axis) for _ in frame_args)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(in_specs,),
        out_specs=P(axis), check_vma=False,
    )
    def run(args):
        return jax.vmap(lambda a: step_fn(*a))(args)

    return run(frame_args)
