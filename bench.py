"""Benchmark harness: 1080p frames/sec at 1M points on one device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
vs_baseline is the ratio against a 500 FPS target (the reference
publishes no numbers of its own).

Lanes (all at 1920x1080 over a 1M-point uniform cloud, each one
``lax.scan`` over trajectory frames through ``raster.render.render``
with backend "auto" and the pipeline's defaults; per-frame camera
evaluation, soup build, binning, walk and shade all run inside the
scan):

* disc    — the traj_ball 220-frame dolly over ground + sphere splats;
* trail   — traj_ball spheres + velocity trails (run/pipeline soup);
* droplet — traj_vel capsule-LOD droplets + fading trails.

Before timing, the platform's raster walk is checked against the NumPy
oracle on a mixed 1080p validation scene (ground + 20k discs + trail
capsules).  Every lane carries the big-list overflow certificate
through its scan and fails when it is non-zero.  Any failure exits
non-zero.

Usage: python bench.py [--points N] [--frames F] [--verbose]
"""

import argparse
import json
import sys
import time

import numpy as np

TARGET_FPS = 500.0


def validation_scene():
    """The mixed 1080p validation scene: ground + 20k discs + 500 trail
    polylines of 4 capsules each.  Returns (soup, camera)."""
    import jax.numpy as jnp

    from pointcloud_render.raster.primitives import (
        ScreenPrimitives,
        capsules_from_polylines,
        discs_from_points,
    )
    from pointcloud_render.raster.render import ground_plane
    from pointcloud_render.scene.camera import Camera

    rng = np.random.default_rng(0)
    cam = Camera(origin=jnp.asarray(np.array([2., 2., 2.], np.float32)),
                 target=jnp.asarray(np.array([0., 0., -0.05], np.float32)))
    n = 20_000
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    base = rng.uniform(-0.4, 0.4, (500, 1, 3))
    steps = rng.normal(size=(500, 5, 3)) * 0.01
    pts = (base + np.cumsum(steps, axis=1)).astype(np.float32)
    soup = ScreenPrimitives.concatenate([
        ground_plane(cam, 10.0, (0., 0., -0.5)),
        discs_from_points(jnp.asarray(pos), cam, jnp.full((n,), 0.004),
                          np.array([0.3, 0.3, 0.3], np.float32)),
        capsules_from_polylines(jnp.asarray(pts), np.ones((500, 5), bool),
                                cam, 0.002,
                                np.array([0.2, 1.0, 0.4], np.float32)),
    ])
    return soup, cam


def edge_pixels(index):
    """Pixels whose 4-neighbourhood in the reference holds another winner:
    the coverage edges where an FMA-contracted coverage test may decide
    differently."""
    i = np.asarray(index)
    e = np.zeros(i.shape, bool)
    e[1:] |= i[1:] != i[:-1]
    e[:-1] |= i[:-1] != i[1:]
    e[:, 1:] |= i[:, 1:] != i[:, :-1]
    e[:, :-1] |= i[:, :-1] != i[:, 1:]
    return e


def agreement(d_ref, i_ref, d, i, kind):
    """Compare a render with a reference under the exactness tolerance:
    index equal on >= 1 - 1e-5 of pixels, every mismatch on a coverage
    edge of the reference image (or a depth tie within 1e-5), disc depth
    bit-equal wherever the index agrees.  Returns (ok, counts dict)."""
    from pointcloud_render.raster.primitives import KIND_DISC

    d_ref, i_ref, d, i = (np.asarray(a) for a in (d_ref, i_ref, d, i))
    kind = np.asarray(kind)
    mism = i != i_ref
    with np.errstate(invalid="ignore"):  # inf - inf at empty pixels
        tie = np.abs(d - d_ref) <= 1e-5 * np.abs(d_ref)
    at_edge = edge_pixels(i_ref) | tie
    agree_disc = ~mism & (i >= 0) & (kind[i.clip(0)] == KIND_DISC)
    counts = dict(
        pixels=int(mism.size), mismatches=int(mism.sum()),
        off_edge=int((mism & ~at_edge).sum()),
        disc_pixels=int(agree_disc.sum()),
        disc_depth_unequal=int((d[agree_disc] != d_ref[agree_disc]).sum()))
    ok = (counts["mismatches"] <= 1e-5 * counts["pixels"]
          and counts["off_edge"] == 0 and counts["disc_depth_unequal"] == 0)
    return ok, counts


def validate_on_device(verbose=False):
    """The platform's raster walk vs the NumPy oracle on the validation
    scene; raises outside the tolerance."""
    import jax

    from pointcloud_render.raster import cpu_reference
    from pointcloud_render.raster.render import rasterize

    soup, cam = validation_scene()
    host = jax.tree_util.tree_map(np.asarray, soup)
    d_o, i_o = cpu_reference.rasterize_reference(host, cam.width, cam.height)
    d, i, diag = jax.jit(lambda s: rasterize(
        s, cam.width, cam.height, return_diag=True))(soup)
    ok, counts = agreement(d_o, i_o, d, i, host.kind)
    if verbose:
        print(f"# oracle agreement: {counts}", file=sys.stderr)
    if not ok or int(diag["overflow"]):
        raise AssertionError(f"exactness outside tolerance on "
                             f"{jax.devices()[0].device_kind}: {counts}")


def _time_scan(episode, args, frames, rounds):
    """Compile, warm up, certify overflow 0, then median seconds/frame."""
    import jax

    compiled = jax.jit(episode).lower(*args).compile()
    out = compiled(*args)
    if int(np.asarray(out[1])) > 0:
        raise RuntimeError(f"big-list overflow {int(np.asarray(out[1]))}")
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = compiled(*args)
        float(np.asarray(out[0]))
        times.append((time.perf_counter() - t0) / frames)
    return float(np.median(times))


def bench_disc(args, positions):
    """The traj_ball 220-frame dolly over ground + sphere splats."""
    import jax
    import jax.numpy as jnp

    from pointcloud_render.raster.primitives import (
        ScreenPrimitives,
        discs_from_points,
    )
    from pointcloud_render.raster.render import ground_plane, render
    from pointcloud_render.scene.camera import (
        TARGETS,
        TOTAL_FRAMES,
        Camera,
        camera_origin_jax,
    )

    radii = jnp.full((positions.shape[0],), args.radius, jnp.float32)
    target = np.asarray(TARGETS["traj_ball"], np.float32)

    def episode(positions, radii):
        def body(acc, fi):
            camera = Camera(origin=camera_origin_jax("traj_ball", fi,
                                                     TOTAL_FRAMES),
                            target=target)
            soup = ScreenPrimitives.concatenate([
                ground_plane(camera, 10.0, (0.0, 0.0, -0.5)),
                discs_from_points(positions, camera, radii,
                                  np.array([0.3, 0.3, 0.3], np.float32)),
            ])
            fb, diag = render(soup, camera, return_diag=True)
            c = (jnp.sum(jnp.where(jnp.isfinite(fb.depth), fb.depth, 0.0))
                 + jnp.sum(fb.rgb[::8, ::8]))
            return (acc[0] + c, jnp.maximum(acc[1], diag["overflow"])), None

        acc, _ = jax.lax.scan(body, (jnp.float32(0.0), jnp.int32(0)),
                              jnp.arange(args.frames, dtype=jnp.int32))
        return acc

    return _time_scan(episode, (positions, radii), args.frames, args.rounds)


def bench_soup_scene(args, positions, preset_name, n_frames):
    """Scan ``n_frames`` frames of a full pipeline soup scene (ground +
    splats + trails) spread over the full-trail phase 20..219; the big
    list is sized from probed frames like run/trajectory does."""
    import jax
    import jax.numpy as jnp

    from pointcloud_render.configs import PRESETS
    from pointcloud_render.raster import csr
    from pointcloud_render.raster.render import RasterConfig, render
    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.scene.camera import (
        TARGETS,
        TOTAL_FRAMES,
        Camera,
        camera_origin_jax,
    )

    preset = PRESETS[preset_name]
    target = np.asarray(TARGETS[preset.camera_preset], np.float32)
    rng = np.random.default_rng(1)
    velocities = jnp.asarray(rng.normal(0, 2, positions.shape), jnp.float32)
    frames = np.linspace(20, 219, n_frames).astype(np.int32)

    def soup(fi, positions, velocities):
        camera = Camera(origin=camera_origin_jax(preset.camera_preset, fi,
                                                 TOTAL_FRAMES),
                        target=target)
        return build_primitives(preset, camera, positions, velocities,
                                fi), camera

    def probe(fi, positions, velocities):
        s, cam = soup(fi, positions, velocities)
        return csr.bin_diagnostics(s, cam.width, cam.height, max_big=0)

    pc = jax.jit(probe)
    bigs = [int(np.asarray(pc(jnp.int32(int(f)), positions, velocities)))
            for f in (frames[0], frames[len(frames) // 2], frames[-1])]
    max_big = max(csr.DEFAULT_MAX_BIG, -(-int(max(bigs) * 1.5) // 512) * 512)
    config = RasterConfig(max_big=max_big)
    if args.verbose:
        print(f"# {preset_name}: big counts {bigs} -> max_big {max_big}",
              file=sys.stderr)

    def episode(positions, velocities):
        def body(acc, fi):
            s, camera = soup(fi, positions, velocities)
            fb, diag = render(s, camera, config, return_diag=True)
            c = (jnp.sum(jnp.where(jnp.isfinite(fb.depth), fb.depth, 0.0))
                 + jnp.sum(fb.rgb[::8, ::8]))
            return (acc[0] + c, jnp.maximum(acc[1], diag["overflow"])), None

        acc, _ = jax.lax.scan(body, (jnp.float32(0.0), jnp.int32(0)),
                              jnp.asarray(frames))
        return acc

    return _time_scan(episode, (positions, velocities), len(frames),
                      args.rounds)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--radius", type=float, default=0.002)
    ap.add_argument("--frames", type=int, default=220,
                    help="disc-lane trajectory frames per scan dispatch")
    ap.add_argument("--rounds", type=int, default=3,
                    help="timing rounds (median taken)")
    ap.add_argument("--trail-frames", type=int, default=24,
                    help="frames for the trail lane (0 disables)")
    ap.add_argument("--droplet-frames", type=int, default=12,
                    help="frames for the droplet lane (0 disables)")
    ap.add_argument("--skip-validate", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pointcloud_render.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if not args.skip_validate:
        validate_on_device(args.verbose)
    n = args.points
    rng = np.random.default_rng(0)
    positions = jnp.asarray(rng.uniform(-0.5, 0.5, (n, 3)), jnp.float32)
    dt = bench_disc(args, positions)
    extra = {}
    if args.trail_frames > 0:
        extra[f"trail_fps_{n // 1000}k_points"] = round(
            1.0 / bench_soup_scene(args, positions, "traj_ball",
                                   args.trail_frames), 3)
    if args.droplet_frames > 0:
        extra[f"droplet_fps_{n // 1000}k_points"] = round(
            1.0 / bench_soup_scene(args, positions, "traj_vel",
                                   args.droplet_frames), 3)
    d = jax.devices()
    fps = 1.0 / dt
    print(json.dumps({
        "metric": f"1080p_fps_{n // 1000}k_points", "value": round(fps, 3),
        "unit": "frames/sec", "vs_baseline": round(fps / TARGET_FPS, 4),
        "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                   "count": len(d)},
        **extra}))


if __name__ == "__main__":
    main()
