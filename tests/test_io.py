"""IO tests: PLY round-trips, velocity/normal detection, npy/npz dispatch."""

import numpy as np
import pytest

from pointcloud_render.io import loaders, ply, png
from pointcloud_render.scene.pointcloud import PointCloud

RNG = np.random.default_rng(1)


class TestPly:
    @pytest.mark.parametrize("binary", [True, False])
    def test_positions_roundtrip(self, tmp_path, binary):
        pos = RNG.normal(size=(100, 3)).astype(np.float32)
        path = str(tmp_path / "cloud.ply")
        ply.write_ply(path, pos, binary=binary)
        data = loaders.load_point_cloud(path)
        assert data.shape == (100, 3)
        if binary:  # bit-exact, not allclose's default rtol=1e-7 (>1 ulp)
            np.testing.assert_array_equal(data, pos)
        else:
            np.testing.assert_allclose(data, pos, atol=1e-6)

    @pytest.mark.parametrize("binary", [True, False])
    def test_velocity_detected(self, tmp_path, binary):
        pos = RNG.normal(size=(50, 3)).astype(np.float32)
        vel = RNG.normal(size=(50, 3)).astype(np.float32)
        path = str(tmp_path / "cloud.ply")
        ply.write_ply(path, pos, velocities=vel, binary=binary)
        data = loaders.load_point_cloud(path)
        assert data.shape == (50, 6)
        if binary:
            np.testing.assert_array_equal(data[:, 3:], vel)
        else:
            np.testing.assert_allclose(data[:, 3:], vel, atol=1e-6)

    def test_normals_used_as_velocity(self, tmp_path):
        # reference: traj_ball_renderer.py:264-273 — nx/ny/nz fall back as
        # velocity, NOT negated.
        pos = RNG.normal(size=(20, 3)).astype(np.float32)
        nrm = RNG.normal(size=(20, 3)).astype(np.float32)
        path = str(tmp_path / "cloud.ply")
        ply.write_ply(path, pos, normals=nrm)
        data = loaders.load_point_cloud(path)
        np.testing.assert_array_equal(data[:, 3:], nrm)

    def test_velocity_priority_over_normals(self, tmp_path):
        pos = RNG.normal(size=(20, 3)).astype(np.float32)
        vel = np.ones((20, 3), np.float32)
        nrm = -np.ones((20, 3), np.float32)
        path = str(tmp_path / "cloud.ply")
        ply.write_ply(path, pos, velocities=vel, normals=nrm)
        data = loaders.load_point_cloud(path)
        np.testing.assert_array_equal(data[:, 3:6], vel)

    def test_positions_only_flag(self, tmp_path):
        pos = RNG.normal(size=(20, 3)).astype(np.float32)
        vel = np.ones((20, 3), np.float32)
        path = str(tmp_path / "cloud.ply")
        ply.write_ply(path, pos, velocities=vel)
        data = loaders.load_point_cloud(path, positions_only=True)
        assert data.shape == (20, 3)

    def test_positions_only_trims_stacked_npy(self, tmp_path):
        """A stacked (F, N, 6) .npy must also drop velocity channels
        under positions_only (review r3: only 2-D arrays were trimmed,
        so the example preset gained velocities from stacks)."""
        arr = RNG.normal(size=(4, 20, 6)).astype(np.float32)
        path = str(tmp_path / "stack.npy")
        np.save(path, arr)
        data = loaders.load_point_cloud(path, positions_only=True)
        assert data.shape == (4, 20, 3)
        np.testing.assert_array_equal(data, arr[..., :3])


class TestNpyNpz:
    def test_npy(self, tmp_path):
        arr = RNG.normal(size=(30, 6)).astype(np.float32)
        path = str(tmp_path / "a.npy")
        np.save(path, arr)
        np.testing.assert_array_equal(loaders.load_point_cloud(path), arr)

    def test_npz_pred_key(self, tmp_path):
        # reference: traj_ball_renderer.py:234
        arr = RNG.normal(size=(2, 30, 3)).astype(np.float32)
        path = str(tmp_path / "a.npz")
        np.savez(path, pred=arr, other=np.zeros(3))
        np.testing.assert_array_equal(loaders.load_point_cloud(path), arr)

    def test_unsupported_extension(self, tmp_path):
        p = tmp_path / "a.xyz"
        p.write_text("0 0 0")
        with pytest.raises(ValueError):
            loaders.load_point_cloud(str(p))


class TestPointCloud:
    def test_from_array_roundtrip(self):
        arr = RNG.normal(size=(10, 6)).astype(np.float32)
        pc = PointCloud.from_array(arr)
        assert pc.has_velocity and pc.num_points == 10
        np.testing.assert_array_equal(pc.as_array(), arr)

    def test_pytree(self):
        import jax

        pc = PointCloud.from_array(np.zeros((4, 6), np.float32))
        leaves = jax.tree_util.tree_leaves(pc)
        assert len(leaves) == 2


class TestPng:
    def test_png_roundtrip(self, tmp_path):
        from PIL import Image

        img = RNG.uniform(size=(16, 24, 3)).astype(np.float32)
        path = str(tmp_path / "x.png")
        png.write_png(path, img)
        back = np.asarray(Image.open(path))
        assert back.shape == (16, 24, 3)
        np.testing.assert_array_equal(back, png.to_srgb_u8(img))

    def test_pure_python_writer_matches(self, tmp_path):
        from PIL import Image

        img = (RNG.uniform(size=(8, 8, 3)) * 255).astype(np.uint8)
        path = str(tmp_path / "y.png")
        png._write_png_pure(path, img)
        back = np.asarray(Image.open(path))
        np.testing.assert_array_equal(back, img)


class TestBigEndianPly:
    def test_big_endian_read(self, tmp_path):
        # Hand-build a binary_big_endian file; the parser must byte-swap.
        pos = np.array([[1.5, -2.25, 3.0], [0.5, 0.25, -1.0]], np.float32)
        header = (b"ply\nformat binary_big_endian 1.0\n"
                  b"element vertex 2\n"
                  b"property float x\nproperty float y\nproperty float z\n"
                  b"end_header\n")
        path = tmp_path / "be.ply"
        path.write_bytes(header + pos.astype(">f4").tobytes())
        data = loaders.load_point_cloud(str(path))
        np.testing.assert_array_equal(data, pos)


class TestNpzStack:
    def test_traj_pipeline_takes_frame0_of_stack(self, tmp_path):
        from pointcloud_render.configs import PRESETS
        from pointcloud_render.run.pipeline import FramePipeline

        rng = np.random.default_rng(3)
        stack = rng.uniform(-1, 1, (3, 30, 6)).astype(np.float32)
        path = str(tmp_path / "s.npz")
        np.savez(path, pred=stack)
        pipe = FramePipeline(PRESETS["traj_ball"])
        got = pipe.load_and_prepare(path)
        # reference: traj renderers take stack[0] (traj_ball_renderer.py:370)
        import oracles
        expect = oracles.ref_transform(oracles.ref_standardize(stack[0]))
        np.testing.assert_array_equal(got, expect)
