"""Streaming rasterization for clouds larger than device memory.

A cloud larger than device memory streams through the device in
fixed-size chunks.  The device keeps only the running framebuffers plus
one chunk of points; chunks are dispatched asynchronously so host->device
transfer of chunk k+1 overlaps the rasterization of chunk k (XLA's async
dispatch pipelines the compiled step calls).

Primitive ids are globalized with the chunk offset, so the result is
IDENTICAL (winner-exact) to a hypothetical single-pass render of the
whole cloud — the merge is the same lexicographic (depth, id) min used
everywhere else.

Color/shading: the step carries winner ATTRIBUTE buffers (px, py, r_px,
rgb) through the merge alongside (depth, id) — one fused table gather per
chunk — and ``resolve_rgb`` shades the final buffers with the same
sphere-normal Lambert model as shading.shade (so a streamed frame matches
the monolithic render's look).

Scale composition: pass a ('points',)-meshed ``mesh`` and each chunk is
ALSO point-sharded across the mesh — every device rasterizes chunk_size /
n_devices points and the running buffers stay replicated, so 10M+ points
use every device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from pointcloud_render.raster.primitives import (
    KIND_DISC,
    KIND_TRIANGLE,
    discs_from_points,
)
from pointcloud_render.raster.render import RasterConfig, rasterize
from pointcloud_render.shading.shade import ShadingConfig, shade_winner_attrs

IMAX = np.int32(2147483647)
INF = np.float32(np.inf)


class StreamingRasterizer:
    """Chunked disc-splat rasterizer with persistent z/attribute buffers.

    Args:
      camera: the Camera.
      chunk_points: points per streamed chunk (static shape).
      radius_world: world-space splat radius.
      config: the RasterConfig each chunk rasterizes with (backend,
        big-list capacity, span; default RasterConfig()).
      color: (3,) default color, used when a chunk has no per-point colors.
      mesh: optional jax Mesh with a 'points' axis — each chunk is
        point-sharded across it (composes streaming with the device mesh).
      soup_fn: optional (positions, colors, *extras) -> ScreenPrimitives
        per-chunk builder for NON-disc streamed scenes (e.g. discs +
        velocity-trail capsules); defaults to disc splats.  Chunks in
        ``rasterize`` may then be (positions, colors, *extras) tuples.
        With a ``mesh``, soup_fn must return ``(prims, layout)`` where
        layout is the part layout ``[(rows, rows_per_point), ...]`` —
        exactly what ``run.pipeline.build_primitives(...,
        return_layout=True)`` returns — so each shard's primitive rows
        map to their ids in the full-chunk soup (the same static layout
        walk as parallel.render_parallel._scene_shard_frame).  Fixed
        furniture parts (rows_per_point == 0, e.g. the ground) are
        rendered by shard 0 of the FIRST chunk only, keeping ids unique.

    Exactness with soup_fn + mesh: a single-chunk stream is bit-exact
    (ids included) vs the monolithic render of the same soup.  Across
    multiple chunks the soup parts interleave per chunk, so equal-depth
    ties BETWEEN different parts resolve in (chunk, part, point) order
    instead of the monolithic (part, point) order — surfaces and depths
    are still exact; only the tie order of cross-part coincident
    primitives can differ.
    """

    def __init__(self, camera, chunk_points: int, radius_world: float,
                 config: Optional[RasterConfig] = None,
                 color=(0.3, 0.3, 0.3), mesh=None, soup_fn=None,
                 shading: ShadingConfig = ShadingConfig()):
        self.camera = camera
        self.chunk_points = int(chunk_points)
        self.radius = float(radius_world)
        self.config = config or RasterConfig()
        self.color = np.asarray(color, np.float32)
        self.mesh = mesh
        self.soup_fn = soup_fn
        self.shading = shading
        self._step = None

    # -- device step ---------------------------------------------------------

    def _build_soup(self, cam, chunk, colors, extras):
        """-> (prims, layout); layout is None for bare-prims soup_fns
        (single-device only — the mesh path needs the part layout)."""
        if self.soup_fn is not None:
            out = self.soup_fn(chunk, colors, *extras)
            if isinstance(out, tuple):
                return out
            return out, None
        prims = discs_from_points(
            chunk, cam, jnp.full((chunk.shape[0],), self.radius, jnp.float32),
            colors)
        return prims, [(chunk.shape[0], 1)]

    def _raster_local(self, cam, chunk, colors, extras, first=None):
        """One device's (or the whole chip's) rasterization of a chunk.

        ``first`` (traced bool): this caller renders the soup's fixed
        furniture parts (rows_per_point == 0).  Replicated furniture must
        win exactly once across chunks x shards, so every other caller
        masks it invalid — ids stay unique and the merged result matches
        the monolithic soup, where furniture appears once.
        """
        prims, layout = self._build_soup(cam, chunk, colors, extras)
        if first is not None and layout is not None:
            fixed = np.zeros(prims.count, bool)
            loc = 0
            for rows, c in layout:
                if (c[1] if isinstance(c, tuple) else c) == 0:
                    fixed[loc:loc + rows] = True
                loc += rows
            if fixed.any():
                prims = dataclasses.replace(
                    prims, valid=prims.valid & (jnp.asarray(~fixed) | first))
        d, i, diag = rasterize(prims, cam.width, cam.height, self.config,
                               return_diag=True)
        # Fused winner-attribute gather: (px, py, rflag, rgb) per hit
        # pixel; rflag = projected radius for discs, -1 for capsules
        # (shade_winner_attrs applies the trail boost there), 0 for
        # triangles whose face-normal Lambert is PRE-LIT into rgb here
        # (shade_framebuffer's exact formula — a soup_fn that streams
        # ground triangles shades identically to the monolithic render
        # instead of taking the capsule boost).
        m = cam.world_to_camera_matrix()
        l_cam = jnp.stack([m[0, 2], m[1, 2], m[2, 2]])
        ndotl_tri = (prims.normal[:, 0] * l_cam[0]
                     + prims.normal[:, 1] * l_cam[1]
                     + prims.normal[:, 2] * l_cam[2])
        lit_tri = (self.shading.ambient
                   + self.shading.diffuse * jnp.maximum(ndotl_tri, 0.0))
        is_tri = prims.kind == KIND_TRIANGLE
        rflag = jnp.where(prims.kind == KIND_DISC, prims.params[:, 3],
                          jnp.where(is_tri, 0.0, -1.0))
        if self.shading.mode == "flat":
            rgb = prims.color  # flat mode never lights anything
        else:
            rgb = jnp.where(is_tri[:, None],
                            prims.color * lit_tri[:, None], prims.color)
        table = jnp.concatenate([
            prims.params[:, 0:2], rflag[:, None], rgb], axis=1)
        attr = table[jnp.maximum(i, 0)]  # (H, W, 6)
        return d, i, attr, diag["overflow"], layout

    def _merge(self, d, gi, attr, depth, index, attrs):
        take = (d < depth) | ((d == depth) & (gi < index))
        return (jnp.where(take, d, depth),
                jnp.where(take, gi, index),
                jnp.where(take[..., None], attr, attrs))

    def _make_step(self):
        """The compiled chunk step.  The camera is an argument, not a
        closure constant: XLA would fold a constant pose at compile time,
        which rounds differently from the same pose computed at run time
        by a one-pass render."""
        def step_single(cam, chunk, colors, extras, offset, depth, index,
                        attrs):
            d, i, attr, ovf, _ = self._raster_local(
                cam, chunk, colors, extras, first=offset == 0)
            gi = jnp.where(i >= 0, i + offset, IMAX)
            d = jnp.where(i >= 0, d, INF)
            return self._merge(d, gi, attr, depth, index, attrs) + (ovf,)

        if self.mesh is None:
            return step_single

        mesh = self.mesh
        n_dev = mesh.shape["points"]
        if self.chunk_points % n_dev:
            raise ValueError(
                f"chunk_points {self.chunk_points} not divisible by "
                f"{n_dev} devices")

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), P("points"), P("points"), P("points"), P(),
                      P(None, None), P(None, None), P(None, None, None)),
            out_specs=(P(None, None), P(None, None), P(None, None, None),
                       P()),
            check_vma=False,
        )
        def step_sharded(cam, chunk, colors, extras, offset, depth, index,
                         attrs):
            shard = jax.lax.axis_index("points")
            d, i, attr, ovf, layout = self._raster_local(
                cam, chunk, colors, extras,
                first=(offset == 0) & (shard == 0))
            if layout is None:
                raise ValueError(
                    "mesh-sharded streaming of a multi-primitive soup "
                    "needs the soup's part layout: make soup_fn return "
                    "(prims, layout) — run.pipeline.build_primitives("
                    "..., return_layout=True) does exactly that")
            # Static layout walk (parallel.render_parallel.
            # _scene_shard_frame): local row -> full-CHUNK-soup id.
            # Per-point parts are row-major in point index, so local row
            # j of a part with rows_local rows on each of n_dev shards
            # sits at part_start + shard * rows_local + j_within_part;
            # fixed furniture keeps its chunk-0/shard-0 ids.
            n_prims = sum(r for r, _ in layout)
            offs = np.zeros(n_prims, np.int32)  # part_start - local_start
            scale = np.zeros(n_prims, np.int32)  # rows_local per shard
            loc = glob = 0
            for rows, c in layout:
                if isinstance(c, tuple):  # ("split2", f) mesh-LOD blocks
                    c = c[1]
                sl = slice(loc, loc + rows)
                offs[sl] = glob - loc
                if c == 0:
                    glob += rows
                else:
                    scale[sl] = rows
                    glob += rows * n_dev
                loc += rows
            safe = jnp.maximum(i, 0)
            gi = jnp.where(
                i >= 0,
                i + jnp.asarray(offs)[safe]
                + shard * jnp.asarray(scale)[safe] + offset,
                IMAX)
            d = jnp.where(i >= 0, d, INF)
            # Merge across the mesh first (lexicographic pmin), then fold
            # the replicated winner into the running buffers.
            best_d = jax.lax.pmin(d, "points")
            contender = jnp.where(d == best_d, gi, IMAX)
            best_gi = jax.lax.pmin(contender, "points")
            mine = (d == best_d) & (gi == best_gi) & (gi != IMAX)
            attr_sum = jax.lax.psum(
                jnp.where(mine[..., None], attr, 0.0), "points")
            return self._merge(best_d, best_gi, attr_sum, depth, index,
                               attrs) + (jax.lax.pmax(ovf, "points"),)

        return step_sharded

    def _compile(self, example_chunk, example_colors, example_extras,
                 depth, index, attrs):
        self._step = jax.jit(self._make_step()).lower(
            self.camera, example_chunk, example_colors, example_extras,
            jnp.int32(0), depth, index, attrs).compile()

    # -- host loop -------------------------------------------------------------

    def rasterize(self, chunks: Iterable, return_attrs: bool = False):
        """Consume an iterable of (C, 3) position chunks — or (positions,
        colors[, *extras]) tuples for per-point colors and ``soup_fn``
        companions; the last chunk may be short (padded with culled
        sentinels).  Returns (depth, index) with global PRIMITIVE indices
        (point indices for the default disc soup), plus the winner
        attribute buffer when ``return_attrs`` (``resolve_rgb`` shades
        it)."""
        cam = self.camera
        depth = jnp.full((cam.height, cam.width), jnp.inf, jnp.float32)
        index = jnp.full((cam.height, cam.width), IMAX, jnp.int32)
        attrs = jnp.zeros((cam.height, cam.width, 6), jnp.float32)
        ovf_max = jnp.int32(0)
        offset = 0
        prims_per_chunk = None
        for chunk in chunks:
            extras = ()
            if isinstance(chunk, tuple):
                chunk, colors, *extras = chunk
                colors = np.asarray(colors, np.float32)
                extras = tuple(jnp.asarray(np.asarray(e, np.float32))
                               for e in extras)
            else:
                colors = np.broadcast_to(self.color,
                                         (np.asarray(chunk).shape[0], 3))
            chunk = np.asarray(chunk, np.float32)
            n = chunk.shape[0]
            if n < self.chunk_points:
                pad = self.chunk_points - n
                chunk = np.concatenate(
                    [chunk, np.full((pad, 3), np.float32(1e30))])
                colors = np.concatenate(
                    [colors, np.zeros((pad, 3), np.float32)])
                extras = tuple(jnp.concatenate(
                    [e, jnp.zeros((pad,) + e.shape[1:], e.dtype)])
                    for e in extras)
            dev = jnp.asarray(chunk)
            col = jnp.asarray(colors)
            if prims_per_chunk is None:
                # Global ids advance by the chunk's PRIMITIVE count
                # (static: fixed chunk shape -> fixed soup size).
                prims_per_chunk = jax.eval_shape(
                    lambda c, k, e: self._build_soup(cam, c, k, e)[0].kind,
                    dev, col, extras).shape[0]
            if self._step is None:
                self._compile(dev, col, extras, depth, index, attrs)
            depth, index, attrs, ovf = self._step(
                cam, dev, col, extras, jnp.int32(offset), depth, index,
                attrs)
            # Device-side running max: ONE scalar fetch at the end keeps
            # the chunk dispatches asynchronous.
            ovf_max = jnp.maximum(ovf_max, ovf)
            offset += prims_per_chunk
        if offset:
            ovf_w = int(np.asarray(ovf_max))
            if ovf_w > 0:
                raise RuntimeError(
                    f"streaming overflow ({ovf_w} primitives) — the render "
                    f"dropped them; raise max_big (csr) or max_per_tile "
                    f"(tiled), or reduce primitive extents.")
        index = jnp.where(jnp.isinf(depth), -1, index)
        if return_attrs:
            return depth, index, attrs
        return depth, index

    def resolve_rgb(self, depth, index, attrs, shaded: bool = True):
        """Winner attributes -> final RGB image ((H, W, 3) float32).

        ONE shader for every path: shading.shade.shade_winner_attrs —
        the same sphere-Lambert as the monolithic render, with capsule
        winners (attr rflag < 0) taking the reference trail boost and
        triangle winners (rflag == 0) pre-lit at table build."""
        hit = index >= 0
        if not shaded:
            bg = np.ones(3, np.float32)
            return jnp.where(hit[..., None], attrs[..., 3:6], bg)
        return shade_winner_attrs(attrs[..., 0], attrs[..., 1],
                                  attrs[..., 2], attrs[..., 3:6], hit,
                                  self.camera, self.shading)
