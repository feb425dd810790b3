#!/usr/bin/env python3
"""Smoke test of the renderer's main path on one NVIDIA GPU, at full scale.

Run from the repository root on a machine with a card:

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --four-cards # four cards: the sharded path only

Phases (each prints its own line; any failure exits non-zero and the
final ``{"ok": true, ...}`` line is not printed):

  device     JAX must run on a GPU (else exit 1, nothing else runs)
  card       nvidia-smi name and power limit
  native     ``make -C native`` builds the C++ IO library
  compile    both CSR walks (plain XLA, Triton kernel) compiled at
             1920x1080 on the three 1M-point scenes; memory_analysis()
  walks      per scene: Triton vs XLA walk index agreement (>= 1 - 1e-5
             of pixels, every mismatch at a coverage edge, disc depth
             bit-equal where the index agrees) and both walks' frame
             times (median of 5 after warm-up; smoke timings, not
             benchmark metrics)
  oracle     both walks vs the NumPy oracle on bench.py's mixed
             validation scene (1080p, ground, 20k discs, trail capsules)
  trajectory TrajectoryScanRenderer, backend "auto", 1M points, frames
             spread over the 220-frame schedule: traj_ball (spheres +
             velocity trails), traj_vel (capsule-LOD droplets + trails),
             example (discs + ground); big-list overflow must be 0
  cli        three synthetic 1M-point binary PLY frames -> the batch CLI
             -> three 1920x1080 PNGs
  look       one frame of the reference look (shadows, GGX ground, GI,
             supersample 2)
  mesh_lod   --droplet-lod mesh at 13k points: 8.3M triangles, whose
             near-plane clip doubles the soup to 16.6M rows, just under
             the 2^24 rows that the float id encoding allows
  streaming  StreamingRasterizer over two 1M-point chunks vs the one-pass
             render of the same 2M points

``--four-cards`` runs only the multi-device path and what it is compared
with: render_scene_point_sharded (4-way 'points' axis) on the 1M-point
traj_ball frame, and render_scene_batch_sharded on a 2x2 mesh over 8
frames, each against the one-card FramePipeline render of the same
frame: index bit-equal and disc depth bit-equal (the device-count
invariance).

The last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
N_POINTS = 1_000_000
FRAME = 120  # a full-trail frame of the 220-frame schedules
SCENES = ("traj_ball", "traj_vel", "example")


def phase(name, t0, **fields):
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {extra} (smoke timing: {time.perf_counter() - t0:.1f}s "
          f"wall)", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cloud(n, seed=SEED):
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    return pos, vel


def scene_camera(preset, frame):
    import jax.numpy as jnp
    import numpy as np

    from pointcloud_render.scene.camera import (
        TARGETS,
        Camera,
        camera_origin_jax,
    )

    return Camera(
        origin=camera_origin_jax(preset.camera_preset, jnp.int32(frame),
                                 preset.total_frames),
        target=np.asarray(TARGETS[preset.camera_preset], np.float32),
        fov_x_degrees=preset.fov_x_degrees)


def frame_fn(preset, walk, max_big):
    """One full 1080p frame of ``preset`` — soup build, binning, the
    given walk and the shade — as a function of (positions, velocities,
    frame index)."""
    from pointcloud_render.raster import csr
    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.shading.shade import (
        ShadingConfig,
        shade_framebuffer,
    )

    def fn(pos, vel, fi):
        cam = scene_camera(preset, fi)
        with_vel = preset.trail == "velocity" or preset.splat == "droplet"
        soup = build_primitives(preset, cam, pos, vel if with_vel else None,
                                fi)
        depth, index, ovf = csr.rasterize_csr(
            soup, cam.width, cam.height, walk=walk, max_big=max_big)
        rgb = shade_framebuffer(soup, cam, depth, index, ShadingConfig())
        return rgb, depth, index, ovf, soup.kind

    return fn


def time_call(fn, *args, reps=5):
    import jax
    import numpy as np

    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts) * 1e3
    return out, float(np.median(ts)), float(ts.min()), float(ts.max())


def compare(name, d_ref, i_ref, d, i, kind):
    """bench.agreement's tolerance: index equal on >= 1 - 1e-5 of
    pixels, every mismatch at a coverage edge, disc depth bit-equal where
    the index agrees.  Prints the counts; raises outside it."""
    from bench import agreement

    ok, c = agreement(d_ref, i_ref, d, i, kind)
    print(f"[compare] {name}: mismatches={c['mismatches']} of "
          f"{c['pixels']} off_edge={c['off_edge']} disc_depth_unequal="
          f"{c['disc_depth_unequal']} of {c['disc_pixels']}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: outside the tolerance: {c}")
    return c["mismatches"]


def run_walks(results):
    """compile + walks phases on the three full scenes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pointcloud_render.configs import PRESETS

    pos, vel = (jnp.asarray(a) for a in cloud(N_POINTS))
    fi = jnp.int32(FRAME)
    compiled = {}
    t0 = time.perf_counter()
    for name in SCENES:
        for walk in ("xla", "triton"):
            tc = time.perf_counter()
            c = jax.jit(frame_fn(PRESETS[name], walk, 4096)).lower(
                pos, vel, fi).compile()
            compiled[name, walk] = c
            print(f"[compile] {name} {walk}: {time.perf_counter() - tc:.1f}s "
                  f"memory_analysis={c.memory_analysis()}", flush=True)
    phase("compile", t0)

    t0 = time.perf_counter()
    for name in SCENES:
        outs = {}
        for walk in ("xla", "triton"):
            outs[walk], med, lo, hi = time_call(compiled[name, walk],
                                                pos, vel, fi)
            results.setdefault("walk_ms", {})[f"{name}/{walk}"] = [med, lo,
                                                                   hi]
            print(f"[walks] {name} {walk}: median {med:.3f} ms/frame "
                  f"(min {lo:.3f}, max {hi:.3f}; 5 runs; smoke timing)",
                  flush=True)
        (rgb_a, d_a, i_a, o_a, kind), (rgb_b, d_b, i_b, o_b, _) = (
            outs["xla"], outs["triton"])
        assert int(o_a) == int(o_b) == 0, (name, int(o_a), int(o_b))
        assert np.isfinite(np.asarray(rgb_b)).all()
        assert rgb_b.shape == (1080, 1920, 3)
        assert (np.asarray(i_b) >= 0).mean() > 0.05, name
        results.setdefault("walk_mismatch", {})[name] = compare(
            f"{name} triton vs xla", d_a, i_a, d_b, i_b, kind)
    phase("walks", t0)


def run_oracle(results):
    import jax
    import numpy as np

    from bench import validation_scene
    from pointcloud_render.raster import cpu_reference, csr

    t0 = time.perf_counter()
    soup, cam = validation_scene()
    host = jax.tree_util.tree_map(np.asarray, soup)
    d_o, i_o = cpu_reference.rasterize_reference(host, cam.width,
                                                 cam.height)
    for walk in ("xla", "triton"):
        d, i, ovf = jax.jit(lambda s, w=walk: csr.rasterize_csr(
            s, cam.width, cam.height, walk=w))(soup)
        assert int(ovf) == 0
        results.setdefault("oracle_mismatch", {})[walk] = compare(
            f"oracle vs {walk}", d_o, i_o, d, i, host.kind)
    phase("oracle", t0, prims=soup.count)


def run_trajectories():
    import numpy as np

    from pointcloud_render.configs import PRESETS
    from pointcloud_render.raster.render import RasterConfig
    from pointcloud_render.run.trajectory import TrajectoryScanRenderer

    pos, vel = cloud(N_POINTS)
    frames = [int(f) for f in np.linspace(0, 219, 8)]
    for name in SCENES:
        t0 = time.perf_counter()
        tr = TrajectoryScanRenderer(PRESETS[name], RasterConfig(backend="auto"),
                                    frames_per_chunk=len(frames))
        # render_frames raises if any frame's big list overflowed.
        out, _ = tr.render_frames(pos, vel, frames)
        assert len(out) == len(frames)
        assert all(f.shape == (1080, 1920, 3) for f in out)
        assert all((f.min(axis=2) < 250).mean() > 0.01 for f in out), name
        phase("trajectory", t0, scene=name, frames=frames,
              max_big=tr.raster_config.max_big, overflow=0)


def run_cli(tmp):
    import numpy as np

    from pointcloud_render.cli import main as cli_main
    from pointcloud_render.configs import PRESETS
    from pointcloud_render.io import ply as plyio

    t0 = time.perf_counter()
    preset = PRESETS["traj_ball"]
    inp, out = os.path.join(tmp, "ply"), os.path.join(tmp, "png")
    os.makedirs(inp)
    pos, vel = cloud(N_POINTS)
    for fi in range(3):
        plyio.write_ply(os.path.join(inp, preset.frame_file(fi)),
                        pos + 0.01 * fi * vel, velocities=vel)
    cli_main.main(["--preset", "traj_ball", "--input-folder", inp,
                   "--output-folder", out, "--frames", "0:3"])
    pngs = sorted(p for p in os.listdir(out) if p.endswith(".png"))
    assert len(pngs) == 3, os.listdir(out)
    for p in pngs:
        with open(os.path.join(out, p), "rb") as f:
            head = f.read(24)
        w, h = int.from_bytes(head[16:20], "big"), int.from_bytes(
            head[20:24], "big")
        assert head[:8] == b"\x89PNG\r\n\x1a\n" and (w, h) == (1920, 1080)
    phase("cli", t0, pngs=",".join(pngs), size="1920x1080")
    return np.asarray(pos), np.asarray(vel)


def run_look_and_mesh(pos, vel):
    import numpy as np

    from pointcloud_render.configs import PRESETS
    from pointcloud_render.raster.render import RasterConfig
    from pointcloud_render.run.pipeline import FramePipeline
    from pointcloud_render.shading.shade import ShadingConfig

    t0 = time.perf_counter()
    look = RasterConfig(supersample=2, shading=ShadingConfig(
        shadows=True, ground_spec=0.3, gi=0.25))
    fb = FramePipeline(PRESETS["traj_ball"], look).render_array(
        np.concatenate([pos, vel], axis=1), FRAME)
    rgb = np.asarray(fb.rgb)
    assert rgb.shape == (1080, 1920, 3) and np.isfinite(rgb).all()
    phase("look", t0, shadows=True, ground_spec=0.3, gi=0.25,
          supersample=2)

    t0 = time.perf_counter()
    n = 13_000
    pipe = FramePipeline(PRESETS["traj_vel"], droplet_lod="mesh")
    fb = pipe.render_array(np.concatenate([pos[:n], vel[:n]], axis=1),
                           FRAME)
    idx = np.asarray(fb.index)
    assert idx.shape == (1080, 1920) and (idx >= 0).mean() > 0.01
    phase("mesh_lod", t0, points=n, triangles_per_point=640,
          max_big=pipe.raster_config.max_big)


def run_streaming():
    import jax.numpy as jnp
    import numpy as np

    from pointcloud_render.configs import PRESETS
    from pointcloud_render.parallel.streaming import StreamingRasterizer
    from pointcloud_render.raster.primitives import discs_from_points
    from pointcloud_render.raster.render import rasterize

    t0 = time.perf_counter()
    preset = PRESETS["traj_ball"]
    cam = scene_camera(preset, FRAME)
    pos, _ = cloud(2 * N_POINTS, seed=SEED + 1)
    sr = StreamingRasterizer(cam, chunk_points=N_POINTS,
                             radius_world=preset.point_radius)
    d_s, i_s = sr.rasterize([pos[:N_POINTS], pos[N_POINTS:]])
    prims = discs_from_points(
        jnp.asarray(pos), cam,
        jnp.full((2 * N_POINTS,), preset.point_radius, jnp.float32),
        np.asarray(sr.color))
    d_1, i_1 = rasterize(prims, cam.width, cam.height)
    n_mism = compare("streamed 2x1M vs one-pass 2M", d_1, i_1, d_s, i_s,
                     prims.kind)
    phase("streaming", t0, points=2 * N_POINTS, chunks=2, mismatches=n_mism)


def run_four_cards():
    """The sharded path on 4 cards against the one-card FramePipeline
    render of the same frames: the device-count invariance, index
    bit-equal and disc depth bit-equal."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pointcloud_render.configs import PRESETS
    from pointcloud_render.parallel.render_parallel import (
        make_render_mesh,
        render_scene_batch_sharded,
        render_scene_point_sharded,
    )
    from pointcloud_render.raster import csr
    from pointcloud_render.raster.render import RasterConfig
    from pointcloud_render.run.pipeline import FramePipeline, build_primitives

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees "
                         f"{len(jax.devices())}")
    preset = PRESETS["traj_ball"]
    pos, vel = cloud(N_POINTS)
    frames = np.linspace(20, 219, 8).astype(np.int32)

    def soup(fi):
        cam = scene_camera(preset, fi)
        return cam, build_primitives(preset, cam, jnp.asarray(pos),
                                     jnp.asarray(vel), fi)

    # Size the big list for the close-camera frames, as the trajectory
    # renderer's probe does: an overflowing big list would drop
    # different primitives on different meshes.
    probe = jax.jit(lambda fi: csr.bin_diagnostics(
        soup(fi)[1], 1920, 1080, max_big=0))
    worst = max(int(probe(np.int32(f))) for f in list(frames) + [FRAME])
    config = RasterConfig(max_big=max(csr.DEFAULT_MAX_BIG,
                                      -(-int(worst * 1.5) // 1024) * 1024))
    print(f"[four_cards] worst big list {worst} -> max_big "
          f"{config.max_big}", flush=True)
    # The soup's row layout (ground, discs, trails) is the same in
    # every frame.
    kind = np.asarray(jax.jit(lambda fi: soup(fi)[1].kind)(np.int32(FRAME)))
    one_card = FramePipeline(preset, config)
    pcl = np.concatenate([pos, vel], axis=1)

    def check(name, fi, index, depth, overflow):
        """Against the one-card render: index bit-equal, and compare()'s
        disc depth bit equality where it agrees."""
        assert int(np.asarray(overflow)) == 0, name
        fb = one_card.render_array(pcl, int(fi))
        n = compare(f"{name} frame {int(fi)} vs one-card FramePipeline",
                    fb.depth, fb.index, depth, index, kind)
        assert n == 0, f"{name}: {n} index pixels differ from one card"

    # Frame indices are jit arguments, as in FramePipeline (a constant
    # frame index lets XLA fold the camera pose at compile time).
    t0 = time.perf_counter()
    mesh = make_render_mesh(1, 4)
    out = jax.jit(lambda p, v, f: render_scene_point_sharded(
        preset, p, config, mesh, velocities=v, frame_index=f))(
            pos, vel, np.int32(FRAME))
    check("point_sharded 4-way", FRAME, out.index, out.depth, out.overflow)
    phase("four_cards_point_sharded", t0, points=N_POINTS, shards=4)

    t0 = time.perf_counter()
    pf = np.broadcast_to(pos, (8,) + pos.shape)
    vf = np.broadcast_to(vel, (8,) + vel.shape)
    out = jax.jit(lambda p, v, f: render_scene_batch_sharded(
        preset, p, v, f, config, make_render_mesh(2, 2)))(pf, vf, frames)
    for k, fi in enumerate(frames):
        check("batch_sharded 2x2", fi, out.index[k], out.depth[k],
              out.overflow[k])
    phase("four_cards_batch_sharded", t0, frames=list(map(int, frames)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path on 4 GPUs")
    args = ap.parse_args()

    t_start = time.perf_counter()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 1
    print(f"[device] {devices[0].device_kind} x{len(devices)} "
          f"jax {jax.__version__}", flush=True)
    print(f"[card] {card_line()}", flush=True)

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from pointcloud_render.utils.compile_cache import enable_compile_cache

    print(f"[cache] {enable_compile_cache()}", flush=True)

    if args.four_cards:
        run_four_cards()
    else:
        t0 = time.perf_counter()
        subprocess.run(["make", "-C", os.path.join(repo, "native")],
                       check=True, timeout=600)
        from pointcloud_render.io import native

        assert native.available(), "native library failed to load"
        phase("native", t0)
        results = {}
        run_walks(results)
        run_oracle(results)
        run_trajectories()
        with tempfile.TemporaryDirectory() as tmp:
            pos, vel = run_cli(tmp)
        run_look_and_mesh(pos, vel)
        run_streaming()
        print(f"[results] {json.dumps(results)}", flush=True)
    print(f"[card] {card_line()}", flush=True)
    print(f"[total] smoke wall time {time.perf_counter() - t_start:.1f}s",
          flush=True)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
