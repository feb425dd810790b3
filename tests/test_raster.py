"""Rasterizer contract tests: every backend must match the NumPy oracle.

The depth-exact-match metric (BASELINE.md) is defined against
cpu_reference.rasterize_reference; on CPU (conftest forces it) the XLA
backends are expected to be bit-exact for discs and capsules, and exact
up to winner identity for triangles (1-ulp division caveat, coverage.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointcloud_render.raster import bruteforce, cpu_reference, xla_tiled
from pointcloud_render.raster.primitives import (
    ScreenPrimitives,
    capsules_from_polylines,
    discs_from_points,
    triangles_from_mesh,
)
from pointcloud_render.raster.render import RasterConfig, ground_plane, render
from pointcloud_render.raster.tiles import bin_primitives
from pointcloud_render.scene.camera import Camera

RNG = np.random.default_rng(42)
W, H = 256, 160


def make_camera(width=W, height=H):
    return Camera(
        origin=jnp.array([2.0, 2.0, 2.0], jnp.float32),
        target=jnp.array([0.0, 0.0, -0.05], jnp.float32),
        width=width, height=height,
    )


def random_cloud_prims(camera, n=400, radius=0.02, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    return discs_from_points(pos, camera, jnp.full((n,), radius),
                             jnp.array([0.3, 0.3, 0.3]))


def to_host(prims):
    return jax.tree_util.tree_map(np.asarray, prims)


def assert_buffers_match(depth_a, index_a, depth_b, index_b, what,
                         exact_depth=True, depth_rtol=5e-7):
    """Contract: winners match everywhere; disc depth is bit-exact; capsule
    depth may differ by XLA FMA contraction (<= 2 ulp); triangle depth by
    ~1e-5 relative (edge-function cancellation near edges + FMA)."""
    index_a, index_b = np.asarray(index_a), np.asarray(index_b)
    depth_a, depth_b = np.asarray(depth_a), np.asarray(depth_b)
    # Two all-miss buffers match trivially — a comparison that compared
    # nothing must fail loudly, not certify a contract against nothing.
    assert (index_a >= 0).any(), f"{what}: empty render (no winners)"
    idx_match = index_a == index_b
    frac = idx_match.mean()
    assert frac == 1.0, f"{what}: winner mismatch on {(1 - frac) * 100:.4f}% px"
    if exact_depth:
        np.testing.assert_array_equal(depth_a, depth_b, err_msg=what)
    else:
        hit = index_a >= 0
        np.testing.assert_allclose(depth_a[hit], depth_b[hit], rtol=depth_rtol,
                                   err_msg=what)


class TestDiscsVsOracle:
    def test_bruteforce_exact(self):
        cam = make_camera()
        prims = random_cloud_prims(cam)
        d_o, i_o = cpu_reference.rasterize_reference(to_host(prims), W, H)
        d_b, i_b = bruteforce.rasterize_bruteforce(prims, W, H)
        assert (np.asarray(i_o) >= 0).mean() > 0.05  # scene actually draws
        assert_buffers_match(d_o, i_o, d_b, i_b, "bruteforce discs")

    def test_tiled_exact(self):
        cam = make_camera()
        prims = random_cloud_prims(cam)
        d_o, i_o = cpu_reference.rasterize_reference(to_host(prims), W, H)
        d_t, i_t = xla_tiled.rasterize_tiled(prims, W, H)
        assert_buffers_match(d_o, i_o, d_t, i_t, "tiled discs")

    def test_order_permutation_determinism(self):
        # Permuting point order changes indices but the depth image and the
        # set of winners (mapped back) must be identical — SURVEY §5.
        cam = make_camera()
        rng = np.random.default_rng(3)
        pos = rng.uniform(-0.5, 0.5, size=(300, 3)).astype(np.float32)
        perm = rng.permutation(300)
        a = discs_from_points(pos, cam, jnp.full((300,), 0.03),
                              jnp.array([0.3, 0.3, 0.3]))
        b = discs_from_points(pos[perm], cam, jnp.full((300,), 0.03),
                              jnp.array([0.3, 0.3, 0.3]))
        d_a, i_a = xla_tiled.rasterize_tiled(a, W, H)
        d_b, i_b = xla_tiled.rasterize_tiled(b, W, H)
        i_a, i_b = np.asarray(i_a), np.asarray(i_b)
        # identical depth everywhere except pixels where equal-depth ties
        # resolve to different points: with random data there are none.
        np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_b))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(300)
        hit = i_a >= 0
        np.testing.assert_array_equal(
            np.where(hit, perm[i_b.clip(0)], -1), np.where(hit, i_a, -1))

    def test_depth_values_are_camera_z(self):
        cam = make_camera()
        pos = np.array([[0.0, 0.0, -0.05]], np.float32)  # exactly at target
        prims = discs_from_points(pos, cam, jnp.full((1,), 0.05),
                                  jnp.array([1.0, 0, 0]))
        d, i = bruteforce.rasterize_bruteforce(prims, W, H)
        center = np.asarray(d)[H // 2, W // 2]
        expect = np.linalg.norm(np.array([2.0, 2.0, 2.05]))
        assert center == pytest.approx(expect, rel=1e-5)


class TestCapsulesVsOracle:
    def _trail_prims(self, cam, n=40, seed=1):
        rng = np.random.default_rng(seed)
        base = rng.uniform(-0.4, 0.4, size=(n, 1, 3))
        drift = rng.normal(size=(n, 1, 3)) * 0.02
        ts = np.linspace(0, 1, 8)[None, :, None]
        pts = (base + drift * ts * 8).astype(np.float32)  # (n, 8, 3)
        valid = np.ones((n, 8), bool)
        return capsules_from_polylines(
            jnp.asarray(pts), jnp.asarray(valid), cam, 0.004,
            jnp.array([0.2, 1.0, 0.4]))

    def test_bruteforce_exact(self):
        cam = make_camera()
        prims = self._trail_prims(cam)
        d_o, i_o = cpu_reference.rasterize_reference(to_host(prims), W, H)
        d_b, i_b = bruteforce.rasterize_bruteforce(prims, W, H)
        assert (np.asarray(i_o) >= 0).mean() > 0.01
        assert_buffers_match(d_o, i_o, d_b, i_b, "bruteforce capsules", exact_depth=False)

    def test_tiled_exact(self):
        cam = make_camera()
        prims = self._trail_prims(cam)
        d_o, i_o = cpu_reference.rasterize_reference(to_host(prims), W, H)
        d_t, i_t = xla_tiled.rasterize_tiled(prims, W, H)
        assert_buffers_match(d_o, i_o, d_t, i_t, "tiled capsules", exact_depth=False)


class TestTrianglesVsOracle:
    def test_ground_plane_matches(self):
        cam = make_camera()
        prims = ground_plane(cam, 10.0, (0, 0, -0.5))
        d_o, i_o = cpu_reference.rasterize_reference(to_host(prims), W, H)
        d_b, i_b = bruteforce.rasterize_bruteforce(prims, W, H)
        cov_o = np.asarray(i_o) >= 0
        assert cov_o.mean() > 0.3  # ground fills the lower frame
        assert_buffers_match(d_o, i_o, d_b, i_b, "bruteforce ground",
                             exact_depth=False, depth_rtol=2e-5)

    def test_tiled_big_prim_path(self):
        cam = make_camera()
        prims = ground_plane(cam, 10.0, (0, 0, -0.5))
        d_o, i_o = cpu_reference.rasterize_reference(to_host(prims), W, H)
        d_t, i_t = xla_tiled.rasterize_tiled(prims, W, H)
        assert_buffers_match(d_o, i_o, d_t, i_t, "tiled ground", exact_depth=False, depth_rtol=2e-5)

    def test_small_triangles(self):
        cam = make_camera()
        rng = np.random.default_rng(5)
        v0 = rng.uniform(-0.4, 0.4, size=(60, 3)).astype(np.float32)
        verts = np.concatenate([v0, v0 + rng.normal(size=(60, 3)) * 0.03,
                                v0 + rng.normal(size=(60, 3)) * 0.03]
                               ).astype(np.float32)
        faces = np.stack([np.arange(60), np.arange(60) + 60,
                          np.arange(60) + 120], axis=1).astype(np.int32)
        prims = triangles_from_mesh(jnp.asarray(verts), jnp.asarray(faces),
                                    cam, jnp.array([0.5, 0.5, 0.5]))
        d_o, i_o = cpu_reference.rasterize_reference(to_host(prims), W, H)
        d_t, i_t = xla_tiled.rasterize_tiled(prims, W, H)
        assert (np.asarray(i_o) >= 0).mean() > 0.005
        assert_buffers_match(d_o, i_o, d_t, i_t, "tiled small tris", exact_depth=False, depth_rtol=1e-4)


class TestMixedScene:
    def test_full_scene_all_kinds(self):
        cam = make_camera()
        discs = random_cloud_prims(cam, n=200, radius=0.025, seed=7)
        rng = np.random.default_rng(8)
        pts = rng.uniform(-0.4, 0.4, size=(30, 5, 3)).astype(np.float32)
        caps = capsules_from_polylines(
            jnp.asarray(pts), jnp.ones((30, 5), bool), cam, 0.003,
            jnp.array([0.2, 1.0, 0.4]))
        ground = ground_plane(cam, 10.0, (0, 0, -0.5))
        soup = ScreenPrimitives.concatenate([ground, discs, caps])
        d_o, i_o = cpu_reference.rasterize_reference(to_host(soup), W, H)
        d_b, i_b = bruteforce.rasterize_bruteforce(soup, W, H)
        d_t, i_t = xla_tiled.rasterize_tiled(soup, W, H)
        assert_buffers_match(d_o, i_o, d_b, i_b, "bruteforce mixed", exact_depth=False, depth_rtol=2e-5)
        assert_buffers_match(d_o, i_o, d_t, i_t, "tiled mixed", exact_depth=False, depth_rtol=2e-5)
        kinds_hit = set(np.asarray(soup.kind)[np.unique(np.asarray(i_o))
                                              [1:]].tolist())
        assert kinds_hit == {0, 1, 2}  # every primitive kind won somewhere


class TestBinning:
    def test_counts_and_overflow(self):
        cam = make_camera()
        prims = random_cloud_prims(cam, n=500, radius=0.02)
        bins = bin_primitives(prims, W, H, max_per_tile=4)
        assert int(bins.overflowed) > 0  # tiny cap must overflow
        bins2 = bin_primitives(prims, W, H, max_per_tile=512)
        assert int(bins2.overflowed) == 0

    def test_ground_goes_to_big_list(self):
        cam = make_camera()
        g = ground_plane(cam, 10.0, (0, 0, -0.5))
        # near-clipping may split the 2 ground faces into up to 4 screen
        # triangles; every valid one must land in the big list or the
        # tile table (no silent drops).
        valid_ids = set(np.nonzero(np.asarray(g.valid))[0].tolist())
        bins = bin_primitives(g, W, H)
        assert int(bins.big_count) >= 1  # the screen-spanning pieces
        listed = set(np.asarray(bins.big_list).tolist()) - {-1}
        tabled = set(np.unique(np.asarray(bins.table)).tolist()) - {-1}
        assert listed | tabled >= valid_ids
        assert listed <= valid_ids


class TestShadedRender:
    def test_render_smoke(self, tmp_path):
        cam = make_camera()
        soup = ScreenPrimitives.concatenate([
            ground_plane(cam, 10.0, (0, 0, -0.5)),
            random_cloud_prims(cam, n=300, radius=0.02, seed=9),
        ])
        fb = render(soup, cam, RasterConfig(backend="tiled"))
        rgb = np.asarray(fb.rgb)
        assert rgb.shape == (H, W, 3)
        assert rgb.min() >= 0 and rgb.max() <= 1
        assert rgb.std() > 0.01  # not a flat image
        from pointcloud_render.io import write_png
        write_png(str(tmp_path / "smoke.png"), rgb)


class TestShadingUnits:
    def test_sphere_normal_center_faces_camera(self):
        from pointcloud_render.raster.render import RasterConfig, render
        from pointcloud_render.shading.shade import ShadingConfig

        cam = make_camera()
        pos = np.array([[0.0, 0.0, -0.05]], np.float32)
        prims = discs_from_points(pos, cam, jnp.full((1,), 0.08),
                                  np.array([1.0, 1.0, 1.0], np.float32))
        fb = render(prims, cam, RasterConfig(
            backend="tiled", shading=ShadingConfig(background=(0, 0, 0))))
        rgb = np.asarray(fb.rgb)
        ys, xs = np.nonzero(np.asarray(fb.index) >= 0)
        cy, cx = int(ys.mean()), int(xs.mean())
        # Center of the ball is brighter than its lower rim (overhead key
        # light + sphere normals).
        rim_y = ys.max()
        assert rgb[cy, cx].mean() > rgb[rim_y, cx].mean()

    def test_flat_mode_passthrough(self):
        from pointcloud_render.raster.render import RasterConfig, render
        from pointcloud_render.shading.shade import ShadingConfig

        cam = make_camera()
        pos = np.array([[0.0, 0.0, -0.05]], np.float32)
        prims = discs_from_points(pos, cam, jnp.full((1,), 0.05),
                                  np.array([0.25, 0.5, 0.75], np.float32))
        fb = render(prims, cam, RasterConfig(
            backend="tiled",
            shading=ShadingConfig(mode="flat", background=(0, 0, 0))))
        rgb = np.asarray(fb.rgb)
        hit = np.asarray(fb.index) >= 0
        expect = np.broadcast_to(np.array([0.25, 0.5, 0.75], np.float32),
                                 rgb[hit].shape)
        np.testing.assert_allclose(rgb[hit], expect, atol=1e-6)


class TestCameraMatrix:
    def test_axes_orthonormal(self):
        from pointcloud_render.scene.camera import look_at_axes

        r, u, f = look_at_axes((2.0, 2.0, 2.0), (0.0, 0.0, -0.05))
        for a in (r, u, f):
            assert np.linalg.norm(np.asarray(a)) == pytest.approx(1.0, 1e-6)
        assert float(np.dot(np.asarray(r), np.asarray(u))) == pytest.approx(0, abs=1e-6)
        assert float(np.dot(np.asarray(r), np.asarray(f))) == pytest.approx(0, abs=1e-6)
        np.testing.assert_allclose(np.cross(np.asarray(r), np.asarray(u)),
                                   -np.asarray(f), atol=1e-6)

    def test_target_projects_to_center(self):
        from pointcloud_render.raster.project import project_points

        cam = make_camera()
        proj = project_points(np.array([[0.0, 0.0, -0.05]], np.float32), cam)
        assert float(proj["px"][0]) == pytest.approx(W / 2, abs=1e-3)
        assert float(proj["py"][0]) == pytest.approx(H / 2, abs=1e-3)

    def test_up_in_world_is_up_in_image(self):
        from pointcloud_render.raster.project import project_points

        cam = make_camera()
        proj = project_points(
            np.array([[0.0, 0.0, -0.05], [0.0, 0.0, 0.3]], np.float32), cam)
        # Higher world z -> smaller py (image up).
        assert float(proj["py"][1]) < float(proj["py"][0])


class TestTaperedCapsules:
    def test_per_vertex_radii(self):
        cam = make_camera()
        pts = np.array([[[0.0, 0.0, -0.05], [0.1, 0.0, -0.05]]], np.float32)
        radii = np.array([[0.05, 0.005]], np.float32)
        prims = capsules_from_polylines(
            jnp.asarray(pts), np.ones((1, 2), bool), cam, radii,
            np.array([1.0, 0, 0], np.float32))
        d_o, i_o = cpu_reference.rasterize_reference(to_host(prims), W, H)
        d_b, i_b = bruteforce.rasterize_bruteforce(prims, W, H)
        assert_buffers_match(d_o, i_o, d_b, i_b, "tapered capsule",
                             exact_depth=False)
        # One end is much wider than the other (tapered silhouette).
        i_o = np.asarray(i_o)
        cols = np.nonzero((i_o >= 0).any(axis=0))[0]
        left, right = cols.min(), cols.max()
        rows_left = (i_o[:, left + 2] >= 0).sum()
        rows_right = (i_o[:, right - 2] >= 0).sum()
        assert max(rows_left, rows_right) >= min(rows_left, rows_right) + 3


RENDER_MODULE = "pointcloud_render.raster.render"


class TestBackendDispatch:
    """One platform dispatch (raster/render.py): the csr walk follows the
    platform; every other platform is an error, never a fallback."""

    @pytest.mark.parametrize("platform,walk", [("gpu", "triton"),
                                               ("cpu", "xla")])
    def test_platform_walk(self, monkeypatch, platform, walk):
        render_mod = importlib.import_module(RENDER_MODULE)

        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert render_mod.platform_walk() == walk

    @pytest.mark.parametrize("platform", ["rocm", "METAL"])
    def test_other_platforms_are_an_error(self, monkeypatch, platform):
        render_mod = importlib.import_module(RENDER_MODULE)

        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        with pytest.raises(RuntimeError, match="no CSR raster walk"):
            render_mod.platform_walk()
        soup = random_cloud_prims(make_camera(), n=16)
        with pytest.raises(RuntimeError, match="no CSR raster walk"):
            render_mod.rasterize(soup, W, H, RasterConfig())

    def test_rasterize_runs_the_platform_walk(self, monkeypatch):
        """rasterize() hands the walk that platform_walk names to the csr
        module — and nothing else decides it."""
        from pointcloud_render.raster import csr

        render_mod = importlib.import_module(RENDER_MODULE)

        seen = []
        real = csr.rasterize_csr

        def spy(*a, **kw):
            seen.append(kw["walk"])
            return real(*a, **kw)

        monkeypatch.setattr(csr, "rasterize_csr", spy)
        soup = random_cloud_prims(make_camera(), n=32)
        render_mod.rasterize(soup, W, H, RasterConfig(backend="auto"))
        render_mod.rasterize(soup, W, H, RasterConfig(backend="csr"))
        assert seen == ["xla", "xla"]

    def test_auto_is_csr(self):
        from pointcloud_render.raster.render import resolve_backend

        assert resolve_backend("auto") == "csr"
        for name in ("csr", "tiled", "bruteforce", "cpu"):
            assert resolve_backend(name) == name

    @pytest.mark.parametrize("name", ["pallas", "pallas3", "pallas4",
                                      "pallas5", "pallas6"])
    def test_retired_backends_not_dispatchable(self, name):
        from pointcloud_render.raster.render import rasterize

        soup = random_cloud_prims(make_camera(), n=16)
        with pytest.raises(ValueError, match="unknown backend"):
            rasterize(soup, W, H, RasterConfig(backend=name))

    @pytest.mark.parametrize("backend", ["auto", "tiled", "bruteforce",
                                         "cpu"])
    def test_every_backend_matches_oracle(self, backend):
        cam = make_camera()
        soup = random_cloud_prims(cam, n=200, radius=0.03, seed=4)
        d_o, i_o = cpu_reference.rasterize_reference(to_host(soup), W, H)
        rasterize = importlib.import_module(RENDER_MODULE).rasterize
        d, i, diag = rasterize(soup, W, H, RasterConfig(backend=backend),
                               return_diag=True)
        assert int(diag["overflow"]) == 0
        assert_buffers_match(d_o, i_o, d, i, backend)


class TestGroundPlaneSharedNormal:
    def test_bit_identical_normals_across_faces_and_clip_blocks(self):
        """The ground quad's faces must carry BIT-identical camera-space
        normals at every trajectory frame — per-face cross products
        differ in the last ulp at some camera angles, which used to veto
        the per-kind-constant shade certificate (derive_three_tone) at
        frame 20 of the bench trajectory."""
        from pointcloud_render.scene.camera import (
            TOTAL_FRAMES,
            camera_origin_jax,
        )

        for fi in (0, 20, 120, 219):
            cam = Camera(
                origin=camera_origin_jax("traj_ball", jnp.int32(fi),
                                         TOTAL_FRAMES),
                target=jnp.array([0.0, 0.0, -0.05], jnp.float32),
                width=W, height=H)
            g = ground_plane(cam, 10.0, (0.0, 0.0, -0.5))
            nrm = np.asarray(g.normal)
            assert (nrm == nrm[0]).all(), (fi, nrm)
            # Still a unit normal facing the camera.
            assert abs(np.linalg.norm(nrm[0]) - 1.0) < 1e-6
