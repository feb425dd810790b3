"""Distributed tests on the simulated 8-device CPU mesh (SURVEY.md §4.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointcloud_render.parallel import (
    make_render_mesh,
    render_frames_dp,
    render_point_sharded,
)
from pointcloud_render.parallel.render_parallel import render_batch_sharded
from pointcloud_render.raster import xla_tiled
from pointcloud_render.raster.primitives import discs_from_points
from pointcloud_render.raster.render import RasterConfig
from pointcloud_render.scene.camera import Camera

W, H = 256, 64


def make_camera():
    return Camera(origin=jnp.array([2.0, 2.0, 2.0], jnp.float32),
                  target=jnp.array([0.0, 0.0, -0.05], jnp.float32),
                  width=W, height=H)


def test_point_sharded_matches_single_device():
    cam = make_camera()
    rng = np.random.default_rng(0)
    n = 512
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    radii = np.full((n,), 0.03, np.float32)
    colors = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32), (n, 3))
    cfg = RasterConfig(backend="tiled", max_per_tile=256)

    mesh = make_render_mesh(1, 8)
    rgb, depth, idx, overflow = jax.jit(
        lambda p, r, c: render_point_sharded(p, r, c, cam, cfg, mesh)
    )(pos, radii, colors)
    assert int(overflow) == 0

    # Single-device truth.
    prims = discs_from_points(pos, cam, radii, colors)
    d1, i1 = xla_tiled.rasterize_tiled(prims, W, H, max_per_tile=256)

    # Winners must agree exactly; depth may differ by XLA FMA-contraction
    # choices between the two programs (<= 1 ulp).
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(i1))
    hit_px = np.asarray(i1) >= 0
    np.testing.assert_allclose(np.asarray(depth)[hit_px],
                               np.asarray(d1)[hit_px], rtol=5e-7)
    # Color resolve: every hit pixel shows the winner's color.
    hit = np.asarray(i1) >= 0
    assert hit.mean() > 0.02
    np.testing.assert_allclose(np.asarray(rgb)[hit], 0.3, atol=1e-6)
    assert np.all(np.asarray(rgb)[~hit] == 1.0)


def test_point_sharded_shard_count_invariance():
    cam = make_camera()
    rng = np.random.default_rng(1)
    n = 512
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    radii = np.full((n,), 0.03, np.float32)
    colors = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32), (n, 3))
    cfg = RasterConfig(backend="tiled", max_per_tile=256)

    outs = []
    for n_shards in (2, 4, 8):
        mesh = make_render_mesh(1, n_shards)
        rgb, depth, idx, _ = jax.jit(
            lambda p, r, c, m=mesh: render_point_sharded(p, r, c, cam, cfg, m)
        )(pos, radii, colors)
        outs.append((np.asarray(depth), np.asarray(idx)))
    for d, i in outs[1:]:
        np.testing.assert_array_equal(i, outs[0][1])
        hit_px = outs[0][1] >= 0
        np.testing.assert_allclose(d[hit_px], outs[0][0][hit_px], rtol=5e-7)


def test_frames_dp():
    cam = make_camera()
    rng = np.random.default_rng(2)
    f, n = 8, 128
    pos = rng.uniform(-0.5, 0.5, (f, n, 3)).astype(np.float32)
    cfg = RasterConfig(backend="tiled", max_per_tile=256)

    def step(p):
        prims = discs_from_points(
            p, cam, jnp.full((n,), 0.03), jnp.array([0.3, 0.3, 0.3]))
        d, i = xla_tiled.rasterize_tiled(prims, W, H, max_per_tile=256)
        return d

    mesh = make_render_mesh(8, 1)
    depths = jax.jit(
        lambda x: render_frames_dp(step, (x,), mesh)
    )(pos)
    assert depths.shape == (f, H, W)
    # Each frame must equal its single-device render.
    for k in range(f):
        dk = np.asarray(step(pos[k]))
        got = np.asarray(depths[k])
        assert ((got == dk) | (np.isclose(got, dk, rtol=5e-7))).all()


def test_2d_mesh_frames_by_points():
    cam = make_camera()
    rng = np.random.default_rng(3)
    f, n = 2, 256
    pos = rng.uniform(-0.5, 0.5, (f, n, 3)).astype(np.float32)
    radii = np.broadcast_to(np.float32(0.03), (f, n)).copy()
    colors = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32),
                             (f, n, 3)).copy()
    cfg = RasterConfig(backend="tiled", max_per_tile=256)
    mesh = make_render_mesh(2, 4)

    depths = jax.jit(
        lambda p, r, c: render_batch_sharded(p, r, c, cam, cfg, mesh)[1]
    )(pos, radii, colors)
    assert depths.shape == (f, H, W)
    for k in range(f):
        prims = discs_from_points(pos[k], cam, radii[k], colors[k])
        dk, _ = xla_tiled.rasterize_tiled(prims, W, H, max_per_tile=256)
        dk, got = np.asarray(dk), np.asarray(depths[k])
        assert ((got == dk) | (np.isclose(got, dk, rtol=5e-7))).all()


def test_scene_point_sharded_matches_pipeline():
    """Full traj_ball scene (ground + spheres + velocity trails, shaded),
    point-sharded 8 ways == the single-device FramePipeline frame,
    winner-exact (VERDICT r1 item 4; scene scope matches
    /root/reference/traj_ball_renderer.py:309-333)."""
    from pointcloud_render.configs import PRESETS
    from pointcloud_render.parallel.render_parallel import (
        render_scene_point_sharded,
    )
    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.raster.render import render
    from pointcloud_render.scene.camera import TARGETS, camera_origin_jax

    preset = PRESETS["traj_ball"]
    rng = np.random.default_rng(7)
    n = 256
    pos = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
    fi = 120
    # 1024 keeps the SINGLE-DEVICE truth overflow-free too (at 256 the
    # monolithic render drops 619 entries — exactly the silent-truncation
    # failure mode tile_overflow exists to catch).
    cfg = RasterConfig(backend="tiled", max_per_tile=1024)
    mesh = make_render_mesh(1, 8)

    out = jax.jit(lambda p, v: render_scene_point_sharded(
        preset, p, cfg, mesh, velocities=v, frame_index=fi,
        width=W, height=H))(pos, vel)
    assert int(out.overflow) == 0

    # Single-device truth through the same soup builder.
    cam = Camera(
        origin=camera_origin_jax(preset.camera_preset, jnp.int32(fi),
                                 preset.total_frames),
        target=jnp.asarray(TARGETS[preset.camera_preset], jnp.float32),
        fov_x_degrees=preset.fov_x_degrees, width=W, height=H)
    prims = build_primitives(preset, cam, jnp.asarray(pos),
                             jnp.asarray(vel), jnp.int32(fi))
    fb = render(prims, cam, cfg)

    np.testing.assert_array_equal(np.asarray(out.index), np.asarray(fb.index))
    hit = np.asarray(fb.index) >= 0
    assert hit.mean() > 0.05
    np.testing.assert_allclose(np.asarray(out.depth)[hit],
                               np.asarray(fb.depth)[hit], rtol=5e-7)
    # Shading tolerance: disc-rim sphere normals pass 1-ulp FMA-contraction
    # differences through sqrt(1 - u^2 - v^2) near zero, amplifying them to
    # ~1e-5 (geometry/winners above are exact; shading is the look layer).
    np.testing.assert_allclose(np.asarray(out.rgb)[hit],
                               np.asarray(fb.rgb)[hit], atol=5e-4)
    # Scene completeness: trails (capsules) and ground (triangle) both won
    # pixels somewhere in the sharded render.
    kinds = np.asarray(prims.kind)[np.asarray(out.index)[hit]]
    assert (kinds == 1).any(), "no trail capsule pixels"
    assert (kinds == 2).any(), "no ground triangle pixels"


def test_scene_point_sharded_csr_backend():
    """The sharded full-scene path on the csr backend — the production
    default — winner-exact vs the capacity-raised tiled truth, 8-way
    point-sharded."""
    from pointcloud_render.configs import PRESETS
    from pointcloud_render.parallel.render_parallel import (
        render_scene_point_sharded,
    )
    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.raster.render import render
    from pointcloud_render.scene.camera import TARGETS, camera_origin_jax

    preset = PRESETS["traj_ball"]
    rng = np.random.default_rng(7)
    n = 256
    pos = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
    fi = 120
    cfg = RasterConfig()
    mesh = make_render_mesh(1, 8)

    out = jax.jit(lambda p, v: render_scene_point_sharded(
        preset, p, cfg, mesh, velocities=v, frame_index=fi,
        width=W, height=H))(pos, vel)
    assert int(out.overflow) == 0

    cam = Camera(
        origin=camera_origin_jax(preset.camera_preset, jnp.int32(fi),
                                 preset.total_frames),
        target=jnp.asarray(TARGETS[preset.camera_preset], jnp.float32),
        fov_x_degrees=preset.fov_x_degrees, width=W, height=H)
    prims = build_primitives(preset, cam, jnp.asarray(pos),
                             jnp.asarray(vel), jnp.int32(fi))
    fb = render(prims, cam, RasterConfig(backend="tiled", max_per_tile=1024))

    np.testing.assert_array_equal(np.asarray(out.index), np.asarray(fb.index))
    hit = np.asarray(fb.index) >= 0
    # Coverage + kind guards: an empty or trail-less scene would make
    # the winner comparison vacuous for the production default path.
    assert hit.mean() > 0.05
    kinds = np.asarray(prims.kind)[np.asarray(fb.index)[hit]]
    assert (kinds == 0).any() and (kinds == 1).any()  # discs AND capsules
    np.testing.assert_allclose(np.asarray(out.depth)[hit],
                               np.asarray(fb.depth)[hit], rtol=2e-5)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_scene_point_sharded_csr_shard_count_invariance(n_shards):
    """The csr backend under 2- and 4-way point sharding gives the same
    index image as the one-device csr render of the same frame (the
    device-count invariance the four-card run checks)."""
    from pointcloud_render.configs import PRESETS
    from pointcloud_render.parallel.render_parallel import (
        render_scene_point_sharded,
    )
    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.raster.render import render
    from pointcloud_render.scene.camera import TARGETS, camera_origin_jax

    preset = PRESETS["traj_vel"]
    rng = np.random.default_rng(17)
    n = 128
    pos = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
    fi = 150
    mesh = make_render_mesh(1, n_shards)
    out = jax.jit(lambda p, v: render_scene_point_sharded(
        preset, p, RasterConfig(), mesh, velocities=v, frame_index=fi,
        width=W, height=H))(pos, vel)
    assert int(out.overflow) == 0

    cam = Camera(
        origin=camera_origin_jax(preset.camera_preset, jnp.int32(fi),
                                 preset.total_frames),
        target=jnp.asarray(TARGETS[preset.camera_preset], jnp.float32),
        fov_x_degrees=preset.fov_x_degrees, width=W, height=H)
    prims = build_primitives(preset, cam, jnp.asarray(pos),
                             jnp.asarray(vel), jnp.int32(fi))
    fb = render(prims, cam, RasterConfig())
    np.testing.assert_array_equal(np.asarray(out.index), np.asarray(fb.index))
    assert (np.asarray(fb.index) >= 0).mean() > 0.05


def test_scene_batch_sharded_2d_mesh():
    """(frames x points) 2D mesh full-scene batch == per-frame truth."""
    from pointcloud_render.configs import PRESETS
    from pointcloud_render.parallel.render_parallel import (
        render_scene_batch_sharded,
        render_scene_point_sharded,
    )

    preset = PRESETS["traj_ball"]
    rng = np.random.default_rng(8)
    f, n = 2, 128
    pos = rng.uniform(-0.4, 0.4, (f, n, 3)).astype(np.float32)
    vel = (rng.normal(size=(f, n, 3)) * 3).astype(np.float32)
    fis = np.array([40, 180], np.int32)
    cfg = RasterConfig(backend="tiled", max_per_tile=256)
    mesh = make_render_mesh(2, 4)

    out = jax.jit(lambda p, v, i: render_scene_batch_sharded(
        preset, p, v, i, cfg, mesh, width=W, height=H))(pos, vel, fis)
    assert out.rgb.shape == (f, H, W, 3)
    assert np.asarray(out.overflow).sum() == 0

    mesh1 = make_render_mesh(1, 4)
    for k in range(f):
        ref = jax.jit(lambda p, v, k=k: render_scene_point_sharded(
            preset, p, cfg, mesh1, velocities=v, frame_index=int(fis[k]),
            width=W, height=H))(pos[k], vel[k])
        np.testing.assert_array_equal(np.asarray(out.index[k]),
                                      np.asarray(ref.index))
        hit = np.asarray(ref.index) >= 0
        # Same disc-rim FMA tolerance as the point-sharded test above.
        np.testing.assert_allclose(np.asarray(out.rgb[k])[hit],
                                   np.asarray(ref.rgb)[hit], atol=5e-4)


@pytest.mark.parametrize("layout", ["points_1", "points_4", "batch_2x2"])
def test_scene_sharded_bit_equal_to_frame_pipeline(layout):
    """Sharded full-scene frames match the one-device FramePipeline
    frames of the same frames: index bit-equal, disc depth bit-equal,
    every other depth within an ulp (the exactness contract).  The
    device-count invariance holds against the production one-card
    program, not only against the sharded code on a smaller mesh."""
    from pointcloud_render.configs import PRESETS
    from pointcloud_render.parallel.render_parallel import (
        render_scene_batch_sharded,
        render_scene_point_sharded,
    )
    from pointcloud_render.run.pipeline import (
        FramePipeline,
        build_primitives,
    )
    from pointcloud_render.scene.camera import TARGETS

    preset = PRESETS["traj_ball"]
    w, h = 1920, 1080  # the full film: edge flips show at this size
    rng = np.random.default_rng(21)
    n = 4000
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    fis = np.array([60, 120], np.int32)
    cfg = RasterConfig(max_big=4096)
    if layout == "batch_2x2":
        out = jax.jit(lambda p, v, f: render_scene_batch_sharded(
            preset, p, v, f, cfg, make_render_mesh(2, 2), width=w,
            height=h))(np.stack([pos] * 2), np.stack([vel] * 2), fis)
        frames = [(int(f), out.index[k], out.depth[k])
                  for k, f in enumerate(fis)]
    else:
        mesh = make_render_mesh(1, int(layout.split("_")[1]))
        # The frame index is an argument, as in FramePipeline: a
        # constant one would let XLA fold the pose at compile time.
        out = jax.jit(lambda p, v, f: render_scene_point_sharded(
            preset, p, cfg, mesh, velocities=v, frame_index=f, width=w,
            height=h))(pos, vel, fis[1])
        frames = [(int(fis[1]), out.index, out.depth)]
    assert int(np.asarray(out.overflow).max()) == 0

    # Soup layout: the ground's rows, then one disc per point.
    cam = Camera(origin=jnp.zeros(3, jnp.float32),
                 target=np.asarray(TARGETS[preset.camera_preset]))
    ground = build_primitives(preset, cam, jnp.asarray(pos[:1]),
                              jnp.asarray(vel[:1]), 0,
                              return_layout=True)[1][0][0]
    pipe = FramePipeline(preset, cfg, width=w, height=h)
    for fi, index, depth in frames:
        fb = pipe.render_array(np.concatenate([pos, vel], axis=1), fi)
        ref_i, ref_d = np.asarray(fb.index), np.asarray(fb.depth)
        np.testing.assert_array_equal(np.asarray(index), ref_i)
        hit = ref_i >= 0
        disc = (ref_i >= ground) & (ref_i < ground + n)
        assert hit.mean() > 0.05 and disc.mean() > 0.01
        np.testing.assert_array_equal(np.asarray(depth)[disc], ref_d[disc])
        np.testing.assert_allclose(np.asarray(depth)[hit], ref_d[hit],
                                   rtol=1e-6)


@pytest.mark.parametrize("backend", ["auto", "tiled"])
def test_2d_mesh_frames_by_points_matches_one_device(backend):
    """The 2D (frames x points) batch render equals each frame's one-
    device render on the same backend (csr by default)."""
    from pointcloud_render.raster.render import rasterize

    cam = make_camera()
    rng = np.random.default_rng(13)
    f, n = 2, 256
    pos = rng.uniform(-0.5, 0.5, (f, n, 3)).astype(np.float32)
    radii = np.full((f, n), 0.03, np.float32)
    colors = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32),
                             (f, n, 3)).copy()
    cfg = RasterConfig(backend=backend, max_per_tile=256)
    out = jax.jit(lambda p, r, c: render_batch_sharded(
        p, r, c, cam, cfg, make_render_mesh(2, 4)))(pos, radii, colors)
    for k in range(f):
        prims = discs_from_points(pos[k], cam, radii[k], colors[k])
        _, ik = rasterize(prims, W, H, cfg)
        np.testing.assert_array_equal(np.asarray(out[2][k]), np.asarray(ik))


def test_sharded_overflow_is_reported():
    """Overflow density (tiny max_per_tile) must be COUNTED, not silent."""
    cam = make_camera()
    rng = np.random.default_rng(9)
    n = 2048
    # Everything lands in a few tiles -> guaranteed overflow at cap 32.
    pos = rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
    radii = np.full((n,), 0.01, np.float32)
    colors = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32), (n, 3))
    cfg = RasterConfig(backend="tiled", max_per_tile=32)
    mesh = make_render_mesh(1, 8)

    *_, overflow = jax.jit(
        lambda p, r, c: render_point_sharded(p, r, c, cam, cfg, mesh)
    )(pos, radii, colors)
    assert int(overflow) > 0


def test_pod_mesh_layout():
    """make_pod_mesh keeps the 'points' axis within one host's devices
    (simulated: all 8 CPU devices belong to this host)."""
    from pointcloud_render.parallel.multihost import make_pod_mesh

    mesh = make_pod_mesh(points_per_host_axis=4)
    assert mesh.axis_names == ("frames", "points")
    assert mesh.shape["points"] == 4
    assert mesh.shape["frames"] == 2

    import pytest

    with pytest.raises(ValueError):
        make_pod_mesh(points_per_host_axis=3)  # doesn't divide 8


def test_shard_dispatch_honors_max_big():
    """The sharded path must forward config.max_big — the documented
    overflow remedy is 'raise max_big and rerun'."""
    from pointcloud_render.parallel.render_parallel import (
        render_point_sharded,
    )

    cam = make_camera()
    rng = np.random.default_rng(11)
    n = 1024
    pos = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    # Huge discs: every one exceeds the 2x2-tile span -> all big-listed
    # (128 per shard on the 8-device mesh).
    radii = np.full((n,), 0.6, np.float32)
    colors = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32), (n, 3))
    mesh = make_render_mesh(1, 8)
    for max_big, overflows in ((64, True), (256, False)):
        *_, ovf = render_point_sharded(pos, radii, colors, cam,
                                       RasterConfig(max_big=max_big), mesh)
        assert (int(ovf) > 0) == overflows, max_big


def test_streamed_soup_mesh_sharded_matches_monolithic():
    """A mesh-sharded stream of the FULL trail soup (ground + discs +
    velocity trails via build_primitives' layout) == the monolithic
    single-device render — bit-exact ids for the single-chunk stream,
    winner-surface/depth-exact across two chunks (VERDICT r3 item 5:
    deletes the streaming.py soup_fn + mesh scope guard)."""
    from pointcloud_render.configs import PRESETS
    from pointcloud_render.parallel.streaming import StreamingRasterizer
    from pointcloud_render.run.pipeline import build_primitives

    preset = PRESETS["traj_ball"]
    cam = make_camera()
    rng = np.random.default_rng(7)
    n = 512
    pos = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 2).astype(np.float32)

    def soup_fn(p, colors, v):
        return build_primitives(preset, cam, p, v, jnp.int32(120),
                                return_layout=True)

    mesh = make_render_mesh(1, 8)
    kw = dict(chunk_points=n, radius_world=preset.point_radius,
              config=RasterConfig(backend="tiled", max_per_tile=4096),
              soup_fn=soup_fn, mesh=mesh)
    colors = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32), (n, 3))

    # Monolithic truth (same soup, one device, no mesh).
    soup, layout = soup_fn(jnp.asarray(pos), jnp.asarray(colors),
                           jnp.asarray(vel))
    d1, i1 = xla_tiled.rasterize_tiled(soup, W, H, max_per_tile=4096)
    i1 = np.where(np.isinf(np.asarray(d1)), -1, np.asarray(i1))

    # One chunk: ids must match the monolithic soup EXACTLY.
    sr = StreamingRasterizer(cam, **kw)
    d_s, i_s = sr.rasterize([(pos, colors, vel)])
    np.testing.assert_array_equal(np.asarray(i_s), i1)
    hit = i1 >= 0
    np.testing.assert_allclose(np.asarray(d_s)[hit], np.asarray(d1)[hit],
                               rtol=5e-7)
    # The scene must actually exercise all three parts.
    kinds = np.asarray(soup.kind)[i1[hit]]
    assert {0, 1, 2} <= set(np.unique(kinds).tolist())

    # Two chunks: same surfaces and depths (ids interleave per chunk).
    sr2 = StreamingRasterizer(cam, **dict(kw, chunk_points=n // 2))
    d_t, i_t = sr2.rasterize([(pos[:n // 2], colors[:n // 2], vel[:n // 2]),
                              (pos[n // 2:], colors[n // 2:], vel[n // 2:])])
    np.testing.assert_allclose(np.where(hit, np.asarray(d_t), 0.0),
                               np.where(hit, np.asarray(d1), 0.0),
                               rtol=5e-7)
    np.testing.assert_array_equal(np.asarray(i_t) >= 0, hit)


@pytest.mark.parametrize("span", [4, 8])
def test_streaming_config_reaches_the_backend(span):
    """StreamingRasterizer(config=...) forwards its RasterConfig: a wider
    binning span is exactness-neutral, so the streamed trail soup must
    be identical to the default-config stream."""
    from pointcloud_render.geometry import trails as trails_mod
    from pointcloud_render.parallel.streaming import StreamingRasterizer
    from pointcloud_render.raster.primitives import (
        ScreenPrimitives,
        capsules_from_polylines,
        discs_from_points,
    )

    cam = make_camera()
    rng = np.random.default_rng(11)
    n = 256
    pos = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    colors = np.broadcast_to(np.array([0.3, 0.3, 0.3], np.float32), (n, 3))
    sub = np.round(np.linspace(0, trails_mod.N_TRAIL_POINTS, 5)).astype(
        np.int32)

    def trail_soup(p, c, v):
        discs = discs_from_points(
            p, cam, jnp.full((p.shape[0],), 0.01, jnp.float32), c)
        ends, valid = trails_mod.velocity_trails_sampled(
            p, v, jnp.int32(120), sub, "ball")
        vv = jnp.broadcast_to(valid[:, None], ends.shape[:2])
        caps = capsules_from_polylines(
            ends, vv, cam, 0.0007, np.array([0.2, 1.0, 0.4], np.float32))
        return ScreenPrimitives.concatenate([discs, caps])

    def run(config):
        sr = StreamingRasterizer(cam, chunk_points=n, radius_world=0.01,
                                 soup_fn=trail_soup, config=config)
        d, i, a = sr.rasterize([(pos, colors, vel)], return_attrs=True)
        return np.asarray(d), np.asarray(i), np.asarray(a)

    d0, i0, a0 = run(RasterConfig(max_big=2048))
    assert (i0 >= 0).any()
    d1, i1, a1 = run(RasterConfig(max_big=2048, span=span))
    np.testing.assert_array_equal(i1, i0)
    hit = i0 >= 0
    np.testing.assert_allclose(d1[hit], d0[hit], rtol=2e-5)
