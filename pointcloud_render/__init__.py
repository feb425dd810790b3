"""pointcloud_render — a JAX point-cloud rendering engine.

A ground-up JAX / XLA / Pallas re-design of the capabilities of
EvaShenLu/PointCloud_Render (an offline Mitsuba-based point-cloud renderer):

* the scene/state layer (loaders, normalization, coordinate transforms,
  camera trajectories, trail/droplet geometry) replays the reference
  bit-compatibly (see ``scene/``, ``geometry/``, ``io/``);
* the render backend is a brand-new tiled splat rasterizer: a fused,
  vmapped per-point XLA stage (model-view transform, perspective
  projection, frustum cull) feeding a deterministic min-depth z-buffer
  resolve, with a Pallas (Triton) GPU kernel for the hot screen-space
  stage (``raster/``);
* scaling: frame data-parallelism and point sharding via
  ``jax.sharding`` + ``shard_map`` over device meshes (``parallel/``).

The reference delegates rendering to the external Mitsuba path tracer
(reference: traj_ball_renderer.py:342-363); this package owns the full
compute path on the accelerator instead.
"""

__version__ = "0.1.0"

from pointcloud_render.scene.pointcloud import PointCloud  # noqa: F401
from pointcloud_render.scene.camera import Camera  # noqa: F401
