"""High-level render entry: primitive soup -> framebuffers -> shaded RGB.

Backends (``RasterConfig.backend``):
  "csr"        — the exact CSR rasterizer (raster/csr.py): anchor-sorted
                 binning with no per-tile capacity, then a per-tile walk.
                 The walk is chosen here from the platform, once:
                 the Triton kernel on a GPU, the plain-XLA walk on the CPU;
  "tiled"      — binned XLA gather rasterizer (exact up to its per-tile
                 capacity ``max_per_tile``, whose overflow is reported);
  "bruteforce" — chunked all-prims x all-pixels XLA scan (exact, any size,
                 O(P*H*W); the correctness baseline);
  "cpu"        — NumPy oracle (host, slow; ground truth);
  "auto"       — "csr".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_render.raster import bruteforce, cpu_reference, csr, xla_tiled
from pointcloud_render.raster.primitives import (
    ScreenPrimitives,
    triangles_from_mesh,
)
from pointcloud_render.raster.tiles import tile_overflow
from pointcloud_render.shading.shade import (
    ShadingConfig,
    shade_framebuffer,
    shade_tones,
)

BACKENDS = ("csr", "tiled", "bruteforce", "cpu")


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Plain hashable config (NOT a pytree: it is passed through jit static
    arguments, and pytree-registered statics break pjit's fast path)."""

    backend: str = "auto"
    shading: ShadingConfig = dataclasses.field(default_factory=ShadingConfig)
    # bruteforce: primitives per scan step
    chunk: int = 8
    # tiled: tile shape and per-tile capacity
    tile_h: int = 8
    tile_w: int = 128
    max_per_tile: int = 512
    # csr: bin small triangles too (mesh-LOD droplet scenes); otherwise
    # triangles ride the big list with the ground.
    bin_triangles: bool = False
    # csr: big-list capacity (prims too wide to bin).  The walk's cost is
    # O(tiles x actual big count); overflow is reported per frame.
    max_big: int = csr.DEFAULT_MAX_BIG
    # csr: prims covering <= span x span tiles bin; wider ones ride the
    # big list.  2 suits splat soups; 4/8 serve long-segment trails that
    # would otherwise flood the big list.
    span: int = 2
    # Reconstruction-filter AA: rasterize at supersample x resolution and
    # collapse with the reference-matched gaussian rfilter (shading/aa.py).
    # 1 = bit-exact single-sample contract (default).
    supersample: int = 1
    # Per-kind-constant shade: (disc_rep, capsule_rep, tri_rep) prim ids,
    # or the four-tone 5-tuple (shading.shade.derive_three_tone /
    # derive_four_tone) — skips the O(P) shade table for trail/droplet
    # soups whose colors are constant per kind.
    three_tone: Optional[tuple] = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FrameBuffers:
    rgb: jax.Array  # (H, W, 3) float32
    depth: jax.Array  # (H, W) float32, +inf empty
    index: jax.Array  # (H, W) int32, -1 empty


def platform_walk() -> str:
    """The CSR walk for the platform JAX runs on: the one place the
    program branches on the device."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(
        f"no CSR raster walk for platform {platform!r} (gpu or cpu)")


def resolve_backend(name: str) -> str:
    name = "csr" if name == "auto" else name
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected 'auto' or "
                         f"one of {BACKENDS}")
    return name


def rasterize(prims: ScreenPrimitives, width: int, height: int,
              config: Optional[RasterConfig] = None,
              return_diag: bool = False):
    """Run the configured backend -> (depth, index) buffers.

    ``return_diag=True`` also returns ``{"overflow": () int32}``: the
    primitives a capacity dropped (csr: big-list overflow; tiled: per-
    tile overflow; 0 for the exact backends).  Carry it through a scan
    and check it once to certify every frame.
    """
    config = config or RasterConfig()
    backend = resolve_backend(config.backend)
    overflow = jnp.int32(0)
    if backend == "csr":
        depth, index, overflow = csr.rasterize_csr(
            prims, width, height, walk=platform_walk(),
            max_big=config.max_big, bin_triangles=config.bin_triangles,
            span=config.span)
    elif backend == "tiled":
        depth, index = xla_tiled.rasterize_tiled(
            prims, width, height,
            tile_h=config.tile_h, tile_w=config.tile_w,
            max_per_tile=config.max_per_tile)
        overflow = tile_overflow(
            prims, width, height, tile_h=config.tile_h,
            tile_w=config.tile_w, max_per_tile=config.max_per_tile)
    elif backend == "bruteforce":
        depth, index = bruteforce.rasterize_bruteforce(
            prims, width, height, chunk=config.chunk)
    else:
        host = jax.tree_util.tree_map(np.asarray, prims)
        d, i = cpu_reference.rasterize_reference(host, width, height)
        depth, index = jnp.asarray(d), jnp.asarray(i)
    if return_diag:
        return depth, index, dict(overflow=overflow)
    return depth, index


def render(prims: ScreenPrimitives, camera,
           config: Optional[RasterConfig] = None,
           return_diag: bool = False):
    """Rasterize + shade a primitive soup through a Camera -> FrameBuffers
    (plus rasterize's diag with ``return_diag``)."""
    config = config or RasterConfig()
    depth, index, diag = rasterize(prims, camera.width, camera.height,
                                   config, return_diag=True)
    if config.three_tone is not None and config.shading.mode != "flat":
        rgb = shade_tones(prims, camera, config.shading, depth, index,
                          config.three_tone)
    else:
        rgb = shade_framebuffer(prims, camera, depth, index, config.shading)
    fb = FrameBuffers(rgb=rgb, depth=depth, index=index)
    return (fb, diag) if return_diag else fb


# ---------------------------------------------------------------------------
# Stage geometry (the reference scene's fixed furniture)
# ---------------------------------------------------------------------------

GROUND_COLOR = (1.0, 1.0, 1.0)  # white roughplastic, traj_ball_renderer.py:30-35


def ground_plane(camera, half_extent: float, center=(0.0, 0.0, -0.5),
                 color=GROUND_COLOR) -> ScreenPrimitives:
    """The reference's ground rectangle as two triangles.

    Mitsuba's rectangle is the unit square [-1,1]^2 scaled then translated
    (reference: traj_ball_renderer.py:58-65 — scale 10 -> 20x20 extent at
    z=-0.5; example_renderer.py:55-61 z=-0.2; traj_b0.py:41-48 scale 20 at
    (10,10,-0.8)).
    """
    cx, cy, cz = center
    e = half_extent
    verts = np.array([
        [cx - e, cy - e, cz],
        [cx + e, cy - e, cz],
        [cx + e, cy + e, cz],
        [cx - e, cy + e, cz],
    ], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    # Shared plane normal: both faces carry bit-identical camera-space
    # normals (per-face cross products differ in the last ulp, which
    # fails the per-kind-constant shade certificate at some frames).
    return triangles_from_mesh(verts, faces, camera, np.asarray(color),
                               face_normal=(0.0, 0.0, 1.0))
