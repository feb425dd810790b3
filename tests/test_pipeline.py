"""End-to-end replay tests (SURVEY.md §4 item 4): each preset runs for a
few frames on synthetic clouds through the real batch driver; outputs,
naming, resume behavior and state-layer values must match the reference
semantics."""

import json
import os

import numpy as np
import pytest

from pointcloud_render.configs import PRESETS
from pointcloud_render.raster.render import RasterConfig
from pointcloud_render.run.batch import Manifest, run_batch
from pointcloud_render.run.metrics import MetricsSink
from pointcloud_render.run.pipeline import FramePipeline

from pointcloud_render.io import ply as plyio

RNG = np.random.default_rng(11)
N_POINTS = 60


def synth_trajectory(folder, pattern, frames, n=N_POINTS, with_velocity=True,
                     seed=0):
    """Write a synthetic drifting cloud as PLY frames."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    pos = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 2
    for fi in frames:
        p = pos + 0.01 * fi * vel
        path = os.path.join(folder, pattern.format(n=fi))
        plyio.write_ply(path, p, velocities=vel if with_velocity else None)
    return pos, vel


def small_pipeline(preset, droplet_lod="capsule", max_per_tile=256):
    # Tiny film for test speed; backend tiled (the production XLA path).
    # Mesh-LOD droplet tests need a real per-tile capacity: 640 tris per
    # droplet on a 192x108 film overflows 256/tile, and the per-frame
    # certificate (correctly) refuses to return the truncated image.
    import dataclasses

    from pointcloud_render.run import pipeline as pl

    return pl.FramePipeline(
        preset, RasterConfig(backend="tiled", max_per_tile=max_per_tile),
        droplet_lod=droplet_lod)


@pytest.fixture()
def small_camera(monkeypatch):
    """Shrink the film so CPU tests are fast."""
    import pointcloud_render.scene.camera as cam_mod

    class SmallCamera(cam_mod.Camera):
        pass

    orig = cam_mod.Camera.__init__

    def patched(self, *a, **kw):
        kw.setdefault("width", 192)
        kw.setdefault("height", 108)
        orig(self, *a, **kw)

    monkeypatch.setattr(cam_mod.Camera, "__init__", patched)
    yield


@pytest.mark.parametrize("preset_name", ["traj_ball", "traj_vel", "traj_b0",
                                         "traj_b1"])
def test_velocity_presets_end_to_end(tmp_path, small_camera, preset_name):
    preset = PRESETS[preset_name]
    frames = [0, 1, 199]
    inp = str(tmp_path / "in")
    out = str(tmp_path / "out")
    synth_trajectory(inp, preset.file_pattern, [0, 1, 199])
    sink = run_batch(preset, input_folder=inp, output_folder=out,
                     frames=frames, pipeline=small_pipeline(preset),
                     sink=MetricsSink(quiet=True))
    assert sink.summary()["frames_ok"] == 3
    stem0 = preset.file_pattern.format(n=0)[:-4]
    assert os.path.exists(os.path.join(out, f"{stem0}.png"))
    # manifest written and used for resume
    sink2 = run_batch(preset, input_folder=inp, output_folder=out,
                      frames=frames, pipeline=small_pipeline(preset),
                      sink=MetricsSink(quiet=True))
    assert sink2.summary()["frames_ok"] == 0  # all skipped...
    assert sink2.summary()["frames_failed"] == 0  # ...not all failed


def test_fade_frames_reuse_199_and_rename(tmp_path, small_camera):
    preset = PRESETS["traj_ball"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    synth_trajectory(inp, preset.file_pattern, [199])
    sink = run_batch(preset, input_folder=inp, output_folder=out,
                     frames=[205], pipeline=small_pipeline(preset),
                     sink=MetricsSink(quiet=True))
    assert sink.summary()["frames_ok"] == 1
    # frames > 199 load frame_0199 but are renamed (traj_ball_renderer.py:376)
    assert os.path.exists(os.path.join(out, "frame_0205_b0.png"))


def test_traj_history_preset(tmp_path, small_camera):
    preset = PRESETS["traj"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    frames = list(range(6))
    synth_trajectory(inp, preset.file_pattern, frames)
    sink = run_batch(preset, input_folder=inp, output_folder=out,
                     frames=frames, pipeline=small_pipeline(preset),
                     sink=MetricsSink(quiet=True))
    assert sink.summary()["frames_ok"] == 6
    assert os.path.exists(os.path.join(out, "frame_0003_b0.png"))


def test_example_preset_positions_only(tmp_path, small_camera):
    preset = PRESETS["example"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(inp)
    rng = np.random.default_rng(4)
    plyio.write_ply(os.path.join(inp, "pts_0.ply"),
                    rng.uniform(-1, 1, (50, 3)).astype(np.float32))
    sink = run_batch(preset, input_folder=inp, output_folder=out,
                     frames=[0], pipeline=small_pipeline(preset),
                     sink=MetricsSink(quiet=True))
    assert sink.summary()["frames_ok"] == 1
    assert os.path.exists(os.path.join(out, "pts_0.png"))


def test_traj_original_frames(tmp_path, small_camera):
    preset = PRESETS["traj_original"]
    assert tuple(preset.frames) == (139, 159, 179, 199)
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    synth_trajectory(inp, preset.file_pattern, [139])
    sink = run_batch(preset, input_folder=inp, output_folder=out,
                     frames=[139], pipeline=small_pipeline(preset),
                     sink=MetricsSink(quiet=True))
    assert sink.summary()["frames_ok"] == 1
    assert os.path.exists(os.path.join(out, "frame_0139_b0.png"))


def test_missing_files_warn_and_continue(tmp_path, small_camera, capsys):
    preset = PRESETS["traj_ball"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    synth_trajectory(inp, preset.file_pattern, [0])
    sink = run_batch(preset, input_folder=inp, output_folder=out,
                     frames=[0, 1], pipeline=small_pipeline(preset),
                     sink=MetricsSink(quiet=True))
    captured = capsys.readouterr()
    assert "File not found" in captured.out
    assert sink.summary()["frames_ok"] == 1


def test_droplet_mesh_lod(tmp_path, small_camera):
    preset = PRESETS["traj_vel"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    synth_trajectory(inp, preset.file_pattern, [50], n=20)
    sink = run_batch(preset, input_folder=inp, output_folder=out,
                     frames=[50],
                     pipeline=small_pipeline(preset, droplet_lod="mesh",
                                             max_per_tile=8192),
                     sink=MetricsSink(quiet=True))
    assert sink.summary()["frames_ok"] == 1


def test_droplet_capsule_lod_emits_splats(small_camera):
    """Regression: the default capsule LOD must emit the head disc +
    tapered tail capsule per point (a lost `else:` once put that block
    inside the mesh branch, making every droplet invisible), and mesh
    LOD must NOT additionally stack the capsule splats over the mesh."""
    import jax.numpy as jnp

    from pointcloud_render.raster.primitives import (
        KIND_CAPSULE,
        KIND_DISC,
    )
    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.scene.camera import Camera

    rng = np.random.default_rng(3)
    n = 30
    pos = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    preset = PRESETS["traj_vel"]
    cam = Camera(origin=jnp.asarray([2.0, 2.0, 2.0]),
                 target=jnp.asarray([0.0, 0.0, -0.05]))

    soup, layout = build_primitives(preset, cam, pos, vel, 50,
                                    droplet_lod="capsule",
                                    return_layout=True)
    # ground + head discs + tail capsules + velocity trails.
    assert [p[1] for p in layout] == [0, 1, 1, 8]
    g = layout[0][0]
    kind = np.asarray(soup.kind)
    assert (kind[g:g + n] == KIND_DISC).all()
    assert (kind[g + n:g + 2 * n] == KIND_CAPSULE).all()
    # ...and the splats are actually visible: some pixel's winner id
    # falls in the head-disc/tail-capsule range.
    from pointcloud_render.raster.render import RasterConfig, render

    fb = render(soup, cam, RasterConfig(backend="tiled",
                                        max_per_tile=256))
    idx = np.asarray(fb.index)
    assert ((idx >= g) & (idx < g + 2 * n)).any()

    mesh_soup, mesh_layout = build_primitives(preset, cam, pos, vel, 50,
                                              droplet_lod="mesh",
                                              return_layout=True)
    # ground + two near-clip triangle blocks + velocity trails; NO
    # capsule-splat parts stacked on top.
    assert len(mesh_layout) == 4
    assert [p[1] for p in mesh_layout[-1:]] == [8]
    # ...and the mesh droplets are VISIBLE too (the invisible-droplet
    # regression class must be pinned for both LODs).
    fb_m = render(mesh_soup, cam, RasterConfig(backend="tiled",
                                               max_per_tile=8192))
    gm = mesh_layout[0][0]
    tri_hi = gm + mesh_layout[1][0] + mesh_layout[2][0]
    idx_m = np.asarray(fb_m.index)
    assert ((idx_m >= gm) & (idx_m < tri_hi)).any()


def test_manifest_corruption_recovers(tmp_path):
    out = str(tmp_path)
    with open(os.path.join(out, "manifest.json"), "w") as f:
        f.write("{broken json")
    m = Manifest(out)
    assert m.done == {}
    m.mark(3, "x.png")
    assert json.load(open(m.path)) == {"3": "x.png"}


def test_state_layer_matches_oracle(tmp_path):
    """The pipeline's load->standardize->transform must equal the
    reference transliteration exactly (bit-level)."""
    import oracles

    preset = PRESETS["traj_ball"]
    inp = str(tmp_path)
    pos, vel = synth_trajectory(inp, preset.file_pattern, [0])
    pipeline = FramePipeline(preset)
    got = pipeline.load_and_prepare(
        os.path.join(inp, preset.file_pattern.format(n=0)))
    raw = np.column_stack([pos, vel])
    expect = oracles.ref_transform(oracles.ref_standardize(raw), flip=True)
    np.testing.assert_array_equal(got, expect)

    b0 = FramePipeline(PRESETS["traj_b0"])
    got0 = b0.load_and_prepare(
        os.path.join(inp, preset.file_pattern.format(n=0)))
    expect0 = oracles.ref_transform(oracles.ref_standardize(raw), flip=False)
    np.testing.assert_array_equal(got0, expect0)


def test_pipeline_shadows_branch(small_camera):
    """The FramePipeline shadow path (ShadingConfig.shadows): same
    winner buffers as the unshadowed frame, darker ground somewhere,
    and a second run is bit-identical (determinism)."""
    import dataclasses

    from pointcloud_render.run import pipeline as pl
    from pointcloud_render.shading.shade import ShadingConfig

    preset = PRESETS["traj_ball"]
    rng = np.random.default_rng(21)
    n = 96
    pcl = np.concatenate([
        rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
        (rng.normal(size=(n, 3)) * 2).astype(np.float32)], axis=1)
    pcl[:, 2] = np.abs(pcl[:, 2]) * 0.5  # keep splats above the ground

    def make(shadows):
        return pl.FramePipeline(
            preset, RasterConfig(
                backend="tiled", max_per_tile=256,
                shading=ShadingConfig(shadows=shadows, shadow_size=256)))

    fb0 = make(False).render_array(pcl, 120)
    fb1 = make(True).render_array(pcl, 120)
    fb2 = make(True).render_array(pcl, 120)
    np.testing.assert_array_equal(np.asarray(fb1.index),
                                  np.asarray(fb0.index))
    np.testing.assert_array_equal(np.asarray(fb1.depth),
                                  np.asarray(fb0.depth))
    np.testing.assert_array_equal(np.asarray(fb1.rgb), np.asarray(fb2.rgb))
    rgb0, rgb1 = np.asarray(fb0.rgb), np.asarray(fb1.rgb)
    darker = (rgb1 < rgb0 - 1e-3).any(axis=2)
    assert darker.sum() > 20, "no shadowed pixels in the pipeline frame"
    assert (rgb1 <= rgb0 + 1e-6).all(), "shadows may only darken"


def test_preset_constants_match_reference():
    """Pin every preset constant to the reference values (SURVEY.md §2
    exact-constant registry)."""
    P = PRESETS
    # spp provenance (traj_ball_renderer.py:21, example_renderer.py:24,
    # traj_renderer.py:28)
    assert P["example"].samples_per_pixel == 256
    assert P["traj"].samples_per_pixel == 256
    for n in ("traj_ball", "traj_vel", "traj_b0", "traj_b1", "traj_original"):
        assert P[n].samples_per_pixel == 128
    # flips (traj_b0.py:62-82 removes the flip)
    for n in ("example", "traj", "traj_ball", "traj_vel"):
        assert P[n].flip_x
    for n in ("traj_b0", "traj_b1", "traj_original"):
        assert not P[n].flip_x
    # grounds (traj_ball_renderer.py:58-65, example_renderer.py:55-61,
    # traj_b0.py:41-48)
    assert P["example"].ground_center == (0.0, 0.0, -0.2)
    assert P["traj_ball"].ground_center == (0.0, 0.0, -0.5)
    assert P["traj_b0"].ground_center == (10.0, 10.0, -0.8)
    assert P["traj_b0"].ground_half_extent == 20.0
    # splat kinds and trail modes
    assert P["traj"].splat == "droplet" and P["traj"].trail == "history"
    assert P["traj_vel"].splat == "droplet" and P["traj_vel"].trail == "velocity"
    assert P["traj_ball"].splat == "sphere"
    assert P["example"].trail is None and P["example"].positions_only
    # schedules (traj_ball_renderer.py:119-124, traj_vel_renderer.py:215-224,
    # traj_b0.py:127)
    assert P["traj_ball"].trail_schedule == "ball"
    assert P["traj_vel"].trail_schedule == "vel"
    for n in ("traj_b0", "traj_b1", "traj_original"):
        assert P[n].trail_schedule == "fixed"
    # constants registry
    for p in P.values():
        assert p.point_color == (0.3, 0.3, 0.3)
        assert p.point_radius == 0.01
        assert p.trail_color == (0.2, 1.0, 0.4)
        assert p.trail_radius == 0.0007
        assert p.history_window == 20
    # file patterns / frames
    assert P["traj_b1"].file_pattern == "frame_{n:04d}_b1.ply"
    assert P["example"].file_pattern == "pts_{n}.ply"
    assert P["traj_ball"].frame_file(205) == "frame_0199_b0.ply"
    assert P["example"].frame_file(7) == "pts_7.ply"


def test_example_stack_iteration(tmp_path, small_camera):
    """example_renderer iterates every frame of a 3-D npy stack, writing
    the same output name each time (example_renderer.py:165-199)."""
    import pointcloud_render.run.pipeline as pl

    preset = PRESETS["example"]
    rng = np.random.default_rng(9)
    stack = rng.uniform(-1, 1, (3, 40, 3)).astype(np.float32)
    path = str(tmp_path / "pts_0.npy")
    np.save(path, stack)
    pipe = small_pipeline(preset)
    calls = []
    real = pl.FramePipeline.render_array

    def spy(self, pcl, fi, history=None):
        calls.append(pcl.shape)
        return real(self, pcl, fi, history)

    import unittest.mock as mock
    with mock.patch.object(pl.FramePipeline, "render_array", spy):
        out = pipe.process(path, 0, output_folder=str(tmp_path / "out"))
    assert len(calls) == 3  # every stack frame rendered
    assert os.path.exists(out)


def test_droplet_without_velocity_uses_seeded_random_rotations(
        tmp_path, small_camera):
    """traj preset on a positions-only cloud: the reference falls back to
    per-index seeded random rotations (traj_renderer.py:566-568)."""
    preset = PRESETS["traj"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    synth_trajectory(inp, preset.file_pattern, [0], n=25, with_velocity=False)
    sink = run_batch(preset, input_folder=inp, output_folder=out, frames=[0],
                     pipeline=small_pipeline(preset, droplet_lod="mesh",
                                             max_per_tile=8192),
                     sink=MetricsSink(quiet=True))
    assert sink.summary()["frames_ok"] == 1
    assert os.path.exists(os.path.join(out, "frame_0000_b0.png"))


def test_profiler_trace_writes_files(tmp_path, small_camera):
    from pointcloud_render.run.metrics import profiler_trace

    preset = PRESETS["traj_ball"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    synth_trajectory(inp, preset.file_pattern, [0], n=20)
    trace_dir = str(tmp_path / "trace")
    with profiler_trace(trace_dir):
        run_batch(preset, input_folder=inp, output_folder=out, frames=[0],
                  pipeline=small_pipeline(preset), sink=MetricsSink(quiet=True))
    found = []
    for root, _, files in os.walk(trace_dir):
        found += files
    assert found  # a trace artifact was produced


def test_trail_segments_knob(small_camera):
    """build_primitives(trail_segments=K): K capsules per velocity trail
    whose vertices are a bit-exact subsample of the 21-point reference
    trail (trails.py velocity_trails); soup shrinks accordingly.  The
    knob is the bench's --trail-segments A/B lever."""
    import jax.numpy as jnp

    from pointcloud_render.geometry import trails as trails_mod
    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.scene.camera import TARGETS, Camera

    preset = PRESETS["traj_ball"]
    cam = Camera(origin=np.array([2.0, 2.0, 2.2], np.float32),
                 target=np.asarray(TARGETS["traj_ball"], np.float32))
    rng = np.random.default_rng(3)
    n = 50
    pos = jnp.asarray(rng.uniform(-0.4, 0.4, (n, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(0, 3, (n, 3)), jnp.float32)
    fi = jnp.int32(120)

    s8, layout8 = build_primitives(preset, cam, pos, vel, fi,
                                   return_layout=True)
    s4, layout4 = build_primitives(preset, cam, pos, vel, fi,
                                   return_layout=True, trail_segments=4)
    # ground rows identical; trails shrink 8 -> 4 capsules per point.
    assert layout8[-1] == (8 * n, 8)
    assert layout4[-1] == (4 * n, 4)
    assert s8.count - s4.count == 4 * n

    # The K=4 vertex set is a bit-exact subsample of the full trail.
    full, valid = trails_mod.velocity_trails(pos, vel, fi,
                                             preset.trail_schedule)
    sub = np.round(np.linspace(0, trails_mod.N_TRAIL_POINTS, 5)
                   ).astype(np.int32)
    ends, v4 = trails_mod.velocity_trails_sampled(pos, vel, fi, sub,
                                                  preset.trail_schedule)
    np.testing.assert_array_equal(np.asarray(ends),
                                  np.asarray(full[:, sub]))
    np.testing.assert_array_equal(np.asarray(v4), np.asarray(valid))

    for bad in (0, 21):
        with pytest.raises(ValueError):
            build_primitives(preset, cam, pos, vel, fi, trail_segments=bad)


def test_parse_frames_open_range():
    """'100:' means from 100 to the preset's last frame; '' the preset
    default; 'a,b' a list (review r3: an empty high bound crashed)."""
    from pointcloud_render.cli.main import parse_frames

    assert list(parse_frames("2:5", [0, 1])) == [2, 3, 4]
    assert list(parse_frames("198:", range(200))) == [198, 199]
    assert list(parse_frames(":3", [7])) == [0, 1, 2]
    assert parse_frames("", [7, 8]) == [7, 8]
    assert parse_frames("4,9", [0]) == [4, 9]


def test_frame_file_clamp_is_traj_family_only():
    """The fade-frame file reuse (>199 -> frame_0199) belongs to the
    traj family; the example preset renders pts_0..pts_661 each from
    its OWN file (reference example_renderer.py:209-211 — review r3: a
    total_frames>200 heuristic clamped 462 example frames to
    pts_199.ply)."""
    ex, tb = PRESETS["example"], PRESETS["traj_ball"]
    assert ex.frame_file(0) == "pts_0.ply"
    assert ex.frame_file(450) == "pts_450.ply"
    assert ex.frame_file(661) == "pts_661.ply"
    assert tb.frame_file(199) == "frame_0199_b0.ply"
    assert tb.frame_file(219) == "frame_0199_b0.ply"
    assert PRESETS["traj_b1"].frame_file(219) == "frame_0199_b1.ply"


def test_pipeline_self_heals_capacity_overflow(tmp_path, small_camera):
    """A default-config scene whose primitives overflow the tiled
    per-tile table must render exactly via automatic capacity retries —
    not fail (and certainly not silently truncate, the pre-r3 behavior
    the per-frame certificate now prevents)."""
    preset = PRESETS["traj_ball"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    synth_trajectory(inp, preset.file_pattern, [199], n=600)
    pipe = small_pipeline(preset, max_per_tile=64)  # guaranteed overflow
    sink = run_batch(preset, input_folder=inp, output_folder=out,
                     frames=[199], pipeline=pipe,
                     sink=MetricsSink(quiet=True))
    assert sink.summary()["frames_ok"] == 1
    assert pipe.raster_config.max_per_tile > 64  # capacity was raised


def test_pipeline_self_heals_big_list_overflow(tmp_path, small_camera):
    """The default csr backend: a frame whose wide primitives overflow a
    tiny big list re-renders with a larger max_big and comes out whole."""
    from pointcloud_render.run import pipeline as pl

    preset = PRESETS["traj_ball"]
    inp, out = str(tmp_path / "in"), str(tmp_path / "out")
    synth_trajectory(inp, preset.file_pattern, [199], n=300)
    pipe = pl.FramePipeline(preset, RasterConfig(max_big=1))
    sink = run_batch(preset, input_folder=inp, output_folder=out,
                     frames=[199], pipeline=pipe,
                     sink=MetricsSink(quiet=True))
    assert sink.summary()["frames_ok"] == 1
    assert pipe.raster_config.max_big > 1  # capacity was raised


def test_trail_segments_adaptive(small_camera):
    """trail_segments="adaptive": static TRAIL_ADAPTIVE_BUDGET rows per
    trail (same soup shapes/layout as fixed segments=4), each trail
    subdivided into its slot-optimal k in 1..4 — rows < k bit-identical
    to the fixed k-segment build, rows >= k invalid (they sort past
    every binned key and bin zero slots)."""
    import jax.numpy as jnp

    from pointcloud_render.geometry import trails as trails_mod
    from pointcloud_render.run.pipeline import (
        TRAIL_ADAPTIVE_BUDGET,
        _adaptive_trail_segment_counts,
        build_primitives,
    )
    from pointcloud_render.scene.camera import TARGETS, Camera

    preset = PRESETS["traj_ball"]
    cam = Camera(origin=np.array([2.0, 2.0, 2.2], np.float32),
                 target=np.asarray(TARGETS["traj_ball"], np.float32))
    rng = np.random.default_rng(3)
    n = 60
    pos = jnp.asarray(rng.uniform(-0.4, 0.4, (n, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(0, 3, (n, 3)), jnp.float32)
    fi = jnp.int32(120)

    B = TRAIL_ADAPTIVE_BUDGET
    sa, layout_a = build_primitives(preset, cam, pos, vel, fi,
                                    return_layout=True,
                                    trail_segments="adaptive")
    s4, layout_4 = build_primitives(preset, cam, pos, vel, fi,
                                    return_layout=True, trail_segments=B)
    assert sa.count == s4.count and layout_a == layout_4

    d, L, _ = trails_mod.velocity_trail_lengths(pos, vel, fi,
                                                preset.trail_schedule)
    k = np.asarray(_adaptive_trail_segment_counts(
        pos, d, L, cam, preset.trail_radius))
    assert ((1 <= k) & (k <= B)).all()
    assert (k < B).any(), "heuristic never adapts — test is vacuous"

    va = np.asarray(sa.valid)[-B * n:].reshape(n, B)
    pa = np.asarray(sa.params)[-B * n:].reshape(n, B, -1)
    rowj = np.arange(B)[None, :]
    assert not va[rowj >= k[:, None]].any()

    for kk in range(1, B + 1):
        idx = np.nonzero(k == kk)[0]
        if idx.size == 0:
            continue
        sk = build_primitives(preset, cam, pos, vel, fi,
                              trail_segments=int(kk))
        pk = np.asarray(sk.params)[-kk * n:].reshape(n, kk, -1)
        vk = np.asarray(sk.valid)[-kk * n:].reshape(n, kk)
        np.testing.assert_array_equal(va[idx][:, :kk], vk[idx])
        m = vk[idx]
        np.testing.assert_array_equal(pa[idx][:, :kk][m], pk[idx][m])

    # The adaptive soup renders winner-exact on the csr backend.
    import jax

    from pointcloud_render.raster import cpu_reference, csr

    host = jax.tree_util.tree_map(np.asarray, sa)
    W, H = cam.width, cam.height
    d_o, i_o = cpu_reference.rasterize_reference(host, W, H)
    assert (i_o >= 0).any()
    d_p, i_p, ovf = csr.rasterize_csr(sa, W, H, walk="xla", span=4,
                                      max_big=256)
    assert int(ovf) == 0
    np.testing.assert_array_equal(np.asarray(i_p), i_o)


def test_packed_capsule_build_bit_equal(small_camera):
    """The packed-column capsule build (r5 layout optimization:
    capsules_from_vertex_columns + velocity_trail_vertex_columns) is
    BIT-identical to the polyline-shaped build on every soup field —
    geometry, bbox, validity, colors, layout.  Covers the trail scene
    (fixed k in {1, 4, 8}) and the droplet capsule-LOD scene (head +
    tapered tail + fading trails)."""
    import jax.numpy as jnp

    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.scene.camera import TARGETS, Camera

    rng = np.random.default_rng(9)
    n = 120
    pos = jnp.asarray(rng.uniform(-0.4, 0.4, (n, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(0, 3, (n, 3)), jnp.float32)
    # A couple of degenerate rows: zero velocity (invalid trail) and a
    # non-finite position (invalidated by the finiteness clause).
    vel = vel.at[3].set(0.0)
    pos = pos.at[7, 1].set(np.float32(np.nan))

    cases = [("traj_ball", None, 1), ("traj_ball", None, 4),
             ("traj_ball", None, 8), ("traj_vel", "capsule", 4)]
    for preset_name, lod, segs in cases:
        preset = PRESETS[preset_name]
        cam = Camera(origin=np.array([2.0, 2.0, 2.2], np.float32),
                     target=np.asarray(TARGETS[preset.camera_preset],
                                       np.float32))
        for fi in (60, 219):  # hold + fade phases
            kw = dict(trail_segments=segs, return_layout=True)
            if lod:
                kw["droplet_lod"] = lod
            sp, lp = build_primitives(preset, cam, pos, vel,
                                      jnp.int32(fi), packed_build=True,
                                      **kw)
            so, lo = build_primitives(preset, cam, pos, vel,
                                      jnp.int32(fi), packed_build=False,
                                      **kw)
            assert lp == lo
            for field in ("params", "valid", "color", "kind", "normal"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(sp, field)),
                    np.asarray(getattr(so, field)),
                    err_msg=f"{preset_name} segs={segs} fi={fi} {field}")
            # bbox: conservative binning bound, allowed a rounding
            # error of drift across compilations (XLA fma contraction
            # of the radius multiply — capsules_from_vertex_columns
            # docstring; winner-safe while drift stays far under the
            # 0.5 px gap to the nearest pixel center of a dropped tile).
            bu = np.abs(np.asarray(sp.bbox) - np.asarray(so.bbox))
            vm = np.asarray(sp.valid & so.valid)[:, None]
            assert np.where(vm, bu, 0.0).max() < 0.01, (preset_name,
                                                        segs, fi)


@pytest.mark.parametrize("preset_name", ["traj_ball", "traj_vel", "traj_b0",
                                         "traj_b1", "traj_original", "traj",
                                         "example"])
def test_default_backend_matches_tiled_on_every_preset(small_camera,
                                                       preset_name):
    """Every reference preset renders through the default (csr) backend
    with the same winners as the capacity-raised tiled backend."""
    preset = PRESETS[preset_name]
    rng = np.random.default_rng(21)
    n = 120
    pos = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    pcl = pos if preset.positions_only else np.concatenate([pos, vel], 1)
    hist = (np.stack([pos - 0.01 * k * vel for k in range(4, 0, -1)])
            if preset.trail == "history" else None)
    out = {}
    for backend in ("auto", "tiled"):
        pipe = FramePipeline(preset, RasterConfig(backend=backend,
                                                  max_per_tile=4096))
        out[backend] = pipe.render_array(pcl, 120, hist)
    a, b = np.asarray(out["auto"].index), np.asarray(out["tiled"].index)
    assert (b >= 0).mean() > 0.01
    np.testing.assert_array_equal(a, b)


def test_supersampled_csr_matches_tiled(small_camera):
    """Supersampling scales the csr binning span with the film; winners
    stay those of the tiled backend."""
    preset = PRESETS["traj_ball"]
    rng = np.random.default_rng(22)
    pcl = np.concatenate([rng.uniform(-0.5, 0.5, (100, 3)),
                          rng.normal(size=(100, 3)) * 2], 1).astype(
                              np.float32)
    out = {}
    for backend in ("auto", "tiled"):
        pipe = FramePipeline(preset, RasterConfig(
            backend=backend, max_per_tile=4096, supersample=2))
        out[backend] = pipe.render_array(pcl, 200)
    np.testing.assert_array_equal(np.asarray(out["auto"].index),
                                  np.asarray(out["tiled"].index))
