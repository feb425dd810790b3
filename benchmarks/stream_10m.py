"""Stream a 10M+ point scene at 4K through one device.

The cloud never resides on-device in full: fixed-size chunks stream
through the StreamingRasterizer's persistent z-buffer on the csr
backend.  Prints chunk throughput and total wall time.

  * --scene disc   : 10M disc splats.
  * --scene trail  : discs + segments=4 velocity trails per chunk (5x
    prims per chunk), span=4.

Run: python benchmarks/stream_10m.py [--scene disc|trail]
     [--points 10000000] [--chunk 1000000]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from pointcloud_render.parallel.streaming import StreamingRasterizer
from pointcloud_render.raster.render import RasterConfig
from pointcloud_render.scene.camera import Camera
from pointcloud_render.utils.compile_cache import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="disc", choices=["disc", "trail"])
    ap.add_argument("--points", type=int, default=10_000_000)
    ap.add_argument("--chunk", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=3840)
    ap.add_argument("--height", type=int, default=2160)
    ap.add_argument("--segments", type=int, default=4,
                    help="trail lane: render segments per trail")
    ap.add_argument("--out", default=None,
                    help="shaded PNG path (default: "
                         "stream_10m_<scene>_rgb.png in the working "
                         "directory)")
    args = ap.parse_args()
    n_total, chunk = args.points, args.chunk
    width, height = args.width, args.height

    enable_compile_cache()
    cam = Camera(origin=jnp.asarray(np.array([2., 2., 2.], np.float32)),
                 target=jnp.asarray(np.array([0., 0., -0.05], np.float32)),
                 width=width, height=height)
    rng = np.random.default_rng(0)

    if args.scene == "disc":
        sr = StreamingRasterizer(cam, chunk_points=chunk,
                                 radius_world=0.0015)
        extras_of = None
    else:
        # Trail soup: discs + segments=4 velocity trails at span=4.
        # Velocities ride as a chunk extra; the soup matches run/pipeline's
        # traj_ball build minus the ground furniture (a streamed ground
        # would repeat per chunk).
        from pointcloud_render.geometry import trails as trails_mod
        from pointcloud_render.raster.primitives import (
            capsules_from_polylines,
            discs_from_points,
        )
        from pointcloud_render.raster.primitives import ScreenPrimitives

        sub = np.round(np.linspace(0, trails_mod.N_TRAIL_POINTS,
                                   args.segments + 1)).astype(np.int32)
        trail_color = np.array([0.2, 1.0, 0.4], np.float32)

        def trail_soup(pos, colors, vel):
            n = pos.shape[0]
            discs = discs_from_points(
                pos, cam, jnp.full((n,), 0.0015, jnp.float32), colors)
            ends, valid = trails_mod.velocity_trails_sampled(
                pos, vel, jnp.int32(120), sub, "ball")
            vv = jnp.broadcast_to(valid[:, None], ends.shape[:2])
            caps = capsules_from_polylines(ends, vv, cam, 0.0007,
                                           trail_color)
            return ScreenPrimitives.concatenate([discs, caps]), [
                (n, 1), (caps.count, args.segments)]

        sr = StreamingRasterizer(cam, chunk_points=chunk,
                                 radius_world=0.0015,
                                 config=RasterConfig(span=4, max_big=20480),
                                 soup_fn=trail_soup)

        def extras_of(pts):
            return (rng.normal(0, 2, pts.shape).astype(np.float32),)

    gray = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32),
                           (chunk, 3))

    def make_chunk():
        pts = rng.uniform(-0.5, 0.5, (chunk, 3)).astype(np.float32)
        if extras_of is None:
            return pts
        return (pts, gray) + extras_of(pts)

    def chunks():
        for _ in range(n_total // chunk):
            # Host-side generation stands in for disk/DCN feed.
            yield make_chunk()

    # Warm up compile + first-execution program upload on a dummy chunk.
    t0 = time.time()
    warm = make_chunk()
    d_w, _ = sr.rasterize([warm])
    float(jnp.isfinite(d_w).astype(jnp.float32).sum())  # force execution
    t1 = time.time()
    depth, index, attrs = sr.rasterize(chunks(), return_attrs=True)
    hit = float(jnp.mean((index >= 0).astype(jnp.float32)))
    t2 = time.time()
    n_chunks = n_total // chunk
    rgb = np.asarray(sr.resolve_rgb(depth, index, attrs))
    out_png = args.out or f"stream_10m_{args.scene}_rgb.png"
    from pointcloud_render.io import png as png_io
    png_io.write_png(out_png, rgb)
    # Device-side steady state: repeated steps on a RESIDENT chunk
    # (separates the device from the host feed in the number below).
    if extras_of is None:
        dev, extras = jnp.asarray(warm), ()
    else:
        dev, extras = jnp.asarray(warm[0]), tuple(
            jnp.asarray(e) for e in warm[2:])
    col = jnp.broadcast_to(jnp.asarray(sr.color), (chunk, 3))
    d0 = jnp.full((height, width), jnp.inf, jnp.float32)
    i0 = jnp.full((height, width), np.int32(2147483647), jnp.int32)
    a0 = jnp.zeros((height, width, 6), jnp.float32)
    out = sr._step(dev, col, extras, jnp.int32(0), d0, i0, a0)
    float(jnp.sum(jnp.where(jnp.isfinite(out[0]), out[0], 0.0)))
    t0d = time.time()
    reps = 10
    for _ in range(reps):
        out = sr._step(dev, col, extras, jnp.int32(0), d0, i0, a0)
    float(jnp.sum(jnp.where(jnp.isfinite(out[0]), out[0], 0.0)))
    dt_dev = (time.time() - t0d) / reps
    print(f"device-side step: {dt_dev * 1e3:.0f} ms/chunk = "
          f"{chunk / dt_dev / 1e6:.1f}M pts/s on the device", flush=True)

    print(f"warmup (compile + program load): {t1 - t0:.1f}s")
    print(f"scene={args.scene} streamed {n_total / 1e6:.0f}M points @ "
          f"{width}x{height}: "
          f"{t2 - t1:.1f}s steady-state = {(t2 - t1) / n_chunks:.2f}s/chunk "
          f"= {n_total / (t2 - t1) / 1e6:.1f}M pts/s (incl. host feed), "
          f"hit_frac={hit:.3f}, max_id={int(index.max())}")
    print(f"shaded RGB written: {out_png}")


if __name__ == "__main__":
    main()
