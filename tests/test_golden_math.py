"""Golden-math tests: pin the state layer to the reference semantics."""

import numpy as np
import pytest

import oracles
from pointcloud_render.geometry import droplet, rotation, trails
from pointcloud_render.scene import camera, normalize

RNG = np.random.default_rng(0)


class TestStandardize:
    def test_matches_reference_6col(self):
        pcl = RNG.normal(size=(500, 6)) * 5 + 2
        np.testing.assert_array_equal(
            normalize.standardize_point_cloud(pcl), oracles.ref_standardize(pcl))

    def test_matches_reference_3col(self):
        pcl = RNG.normal(size=(300, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            normalize.standardize_point_cloud(pcl), oracles.ref_standardize(pcl))

    def test_scale_is_global_not_per_axis(self):
        pcl = np.array([[0.0, 0.0, 0.0], [10.0, 1.0, 1.0]])
        out = normalize.standardize_point_cloud(pcl)
        # widest extent (x: 10) divides every axis
        np.testing.assert_allclose(out[1, 0] - out[0, 0], 1.0, rtol=1e-6)
        np.testing.assert_allclose(out[1, 1] - out[0, 1], 0.1, rtol=1e-6)

    def test_jax_version_close(self):
        pcl = RNG.normal(size=(200, 6)).astype(np.float32)
        ref = oracles.ref_standardize(pcl)
        pos, vel = normalize.standardize_point_cloud_jax(pcl[:, :3], pcl[:, 3:])
        np.testing.assert_allclose(np.asarray(pos), ref[:, :3], atol=1e-6)
        np.testing.assert_array_equal(np.asarray(vel), ref[:, 3:])


class TestTransformCoordinates:
    @pytest.mark.parametrize("cols", [3, 6])
    @pytest.mark.parametrize("flip", [True, False])
    def test_matches_reference(self, cols, flip):
        pcl = RNG.normal(size=(100, cols)).astype(np.float32)
        np.testing.assert_array_equal(
            normalize.transform_coordinates(pcl, flip_x=flip),
            oracles.ref_transform(pcl, flip=flip))

    def test_jax_version(self):
        pcl = RNG.normal(size=(64, 6)).astype(np.float32)
        ref = oracles.ref_transform(pcl)
        pos, vel = normalize.transform_coordinates_jax(pcl[:, :3], pcl[:, 3:])
        np.testing.assert_allclose(np.asarray(pos), ref[:, :3], atol=1e-7)
        np.testing.assert_allclose(np.asarray(vel), ref[:, 3:], atol=1e-7)


class TestCameraTrajectories:
    def test_traj_linear_dolly(self):
        for f in [0, 1, 57, 199, 219]:
            assert camera.camera_origin("traj", f, 220) == pytest.approx(
                oracles.ref_camera_traj(f, 220), abs=0)

    @pytest.mark.parametrize("preset,waypoints", [
        ("traj_ball", ((2.8, 2.8, 3.0), (1.8, 1.8, 1.8), (1.6, 1.6, 1.6))),
        ("traj_vel", ((2.8, 2.8, 3.0), (1.8, 1.8, 1.8), (1.6, 1.6, 1.6))),
        ("traj_b0", ((-2.2, -3.3, 2.0), (-1.3, -2.5, 0.8), (-1.0, -2.0, 0.7))),
        ("traj_b1", ((-3.5, -2.5, 2.8), (-2.3, -1.5, 1.2), (-2.0, -1.2, 1.0))),
    ])
    def test_two_phase(self, preset, waypoints):
        for f in [0, 19, 100, 199, 200, 210, 219]:
            expect = oracles.ref_camera_two_phase(f, *waypoints)
            assert camera.camera_origin(preset, f) == pytest.approx(expect, abs=0)

    def test_original_constant(self):
        for f in [139, 159, 179, 199]:
            assert camera.camera_origin("traj_original", f) == (-1.8, -1.8, 1.8)

    def test_example_static(self):
        assert camera.camera_origin("example", 0) == (2.2, 2.2, 4.2)

    def test_jax_matches_host(self):
        for preset in ["traj", "traj_ball", "traj_b0", "traj_b1",
                       "traj_original"]:
            for f in [0, 42, 199, 200, 219]:
                host = np.array(camera.camera_origin(preset, f, 220))
                traced = np.asarray(camera.camera_origin_jax(preset, f, 220))
                np.testing.assert_allclose(traced, host, atol=1e-5)


class TestRotation:
    def test_exact_match_random_velocities(self):
        for _ in range(50):
            v = RNG.normal(size=3) * RNG.choice([1e-8, 0.1, 1.0, 50.0])
            t = RNG.normal(size=3)
            np.testing.assert_array_equal(
                rotation.rotation_from_velocity(v, t),
                oracles.ref_rotation_from_velocity(v, t))

    @pytest.mark.parametrize("v", [
        (0.0, 0.0, 0.0),          # zero -> identity
        (0.0, 0.0, -1.0),         # parallel to tip axis -> identity
        (0.0, 0.0, 1.0),          # antiparallel -> pi rotation
        (1e-7, 0.0, 0.0),         # below epsilon
        (0.95, 0.0, 0.05),        # target_x >= 0.9 helper branch
    ])
    def test_edge_cases_exact(self, v):
        t = (0.5, -0.25, 1.0)
        np.testing.assert_array_equal(
            rotation.rotation_from_velocity(v, t),
            oracles.ref_rotation_from_velocity(v, t))

    def test_batch_matches_scalar(self):
        vels = np.concatenate([
            RNG.normal(size=(40, 3)),
            [[0, 0, 0], [0, 0, -2], [0, 0, 3], [0.95, 0, 0.0]],
        ]).astype(np.float32)
        pos = RNG.normal(size=(len(vels), 3)).astype(np.float32)
        batch = np.asarray(rotation.rotation_matrices_from_velocities(vels, pos))
        for i in range(len(vels)):
            expect = oracles.ref_rotation_from_velocity(
                vels[i], pos[i]).reshape(4, 4)
            np.testing.assert_allclose(batch[i], expect, atol=2e-6)

    def test_rotation_sends_tip_to_velocity(self):
        vels = RNG.normal(size=(20, 3)).astype(np.float32)
        pos = np.zeros((20, 3), np.float32)
        mats = np.asarray(rotation.rotation_matrices_from_velocities(vels, pos))
        tips = mats[:, :3, :3] @ np.array([0, 0, -1.0], np.float32)
        unit = vels / np.linalg.norm(vels, axis=1, keepdims=True)
        np.testing.assert_allclose(tips, unit, atol=1e-5)

    def test_random_rotation_matches_reference_rng(self):
        # reference: traj_renderer.py:398-418 seeds the global RNG per index
        for seed in [0, 1, 7]:
            np.random.seed(seed)
            axis = np.random.randn(3)
            axis = axis / np.linalg.norm(axis)
            angle = np.random.uniform(0, 2 * np.pi)
            got = rotation.random_rotation_matrix(seed, (1, 2, 3)).reshape(4, 4)
            ca, sa = np.cos(angle), np.sin(angle)
            k = np.array([[0, -axis[2], axis[1]],
                          [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            expect = np.eye(3) + sa * k + (1 - ca) * (k @ k)
            np.testing.assert_allclose(got[:3, :3], expect, atol=1e-12)


class TestTrailSchedules:
    @pytest.mark.parametrize("schedule", ["ball", "vel", "fixed"])
    def test_matches_reference(self, schedule):
        for f in range(0, 220):
            assert float(trails.trail_length_scale(schedule, f)) == pytest.approx(
                oracles.ref_trail_length_scale(schedule, f), abs=1e-7)

    def test_vel_fade_endpoints(self):
        # scale at 218 is 1-(218-199)/20 = 0.05; at 219 it reaches 0 and the
        # trail is skipped (scale <= 0, reference: traj_vel_renderer.py:226-228).
        assert float(trails.trail_length_scale("vel", 218)) == pytest.approx(0.05)
        assert float(trails.trail_length_scale("vel", 219)) == pytest.approx(0.0)


class TestVelocityTrails:
    def test_single_point_exact(self):
        pos = np.array([0.1, -0.2, 0.3])
        vel = np.array([1.5, -2.0, 0.7])
        got = trails.velocity_trail_points(pos, vel, 1.0)
        expect = oracles.ref_velocity_trail(pos, vel, 1.0)
        np.testing.assert_array_equal(got, expect)

    def test_batch_matches_scalar(self):
        pos = RNG.normal(size=(30, 3)).astype(np.float32)
        vel = (RNG.normal(size=(30, 3)) * 3).astype(np.float32)
        vel[5] = 0  # below epsilon -> invalid
        pts, valid = trails.velocity_trails(pos, vel, frame_index=50,
                                            schedule="ball")
        pts, valid = np.asarray(pts), np.asarray(valid)
        assert not valid[5] and valid[0]
        for i in [0, 1, 29]:
            expect = oracles.ref_velocity_trail(pos[i], vel[i], 1.0)
            np.testing.assert_allclose(pts[i], expect, atol=1e-5)

    def test_frame_zero_ball_invalid(self):
        pos = np.zeros((4, 3), np.float32)
        vel = np.ones((4, 3), np.float32)
        _, valid = trails.velocity_trails(pos, vel, 0, "ball")
        assert not np.any(np.asarray(valid))  # scale 0 -> skip

    def test_last_two_points_coincide(self):
        pos = RNG.normal(size=(3, 3)).astype(np.float32)
        vel = np.ones((3, 3), np.float32)
        pts, _ = trails.velocity_trails(pos, vel, 100, "ball")
        np.testing.assert_array_equal(np.asarray(pts)[:, -1], np.asarray(pts)[:, -2])

    def test_sampled_bit_equal_to_full_subsample(self):
        """velocity_trails_sampled (the render-layer fast path,
        run/pipeline.py) must be BIT-identical to gathering the full
        21-point build, validity included, for every schedule and
        phase."""
        pos = RNG.normal(size=(200, 3)).astype(np.float32)
        vel = (RNG.normal(size=(200, 3)) * 3).astype(np.float32)
        vel[7] = 0  # below epsilon -> invalid
        sub = np.round(np.linspace(0, trails.N_TRAIL_POINTS, 9)).astype(
            np.int32)
        for fi in (5, 40, 210):
            for sched in ("ball", "vel", "fixed"):
                full, vf = trails.velocity_trails(pos, vel, fi, sched)
                samp, vs = trails.velocity_trails_sampled(pos, vel, fi,
                                                          sub, sched)
                np.testing.assert_array_equal(np.asarray(full)[:, sub],
                                              np.asarray(samp))
                np.testing.assert_array_equal(np.asarray(vf),
                                              np.asarray(vs))


class TestDroplet:
    def test_mesh_matches_reference(self):
        verts, faces = droplet.droplet_mesh(dtype=np.float64)
        ref_v, ref_f = oracles.ref_droplet_mesh()
        np.testing.assert_allclose(verts, ref_v, atol=1e-12)
        np.testing.assert_array_equal(faces, ref_f)

    def test_obj_export_format(self, tmp_path):
        path = droplet.write_droplet_obj(str(tmp_path / "droplet.obj"))
        lines = open(path).read().splitlines()
        ref_v, ref_f = oracles.ref_droplet_mesh()
        v_lines = [l for l in lines if l.startswith("v ")]
        f_lines = [l for l in lines if l.startswith("f ")]
        assert len(v_lines) == len(ref_v) and len(f_lines) == len(ref_f)
        assert v_lines[0] == "v {:.6f} {:.6f} {:.6f}".format(*ref_v[0])
        assert f_lines[0] == "f {} {} {}".format(*(ref_f[0] + 1))


class TestCatmullRomTrails:
    @pytest.mark.parametrize("hist_len", [2, 3, 4, 5, 8, 12, 20])
    def test_matches_reference_polyline(self, hist_len):
        n = 6
        history = np.cumsum(
            RNG.normal(size=(hist_len, n, 3)).astype(np.float32) * 0.05, axis=0)
        current = history[-1] + RNG.normal(size=(n, 3)).astype(np.float32) * 0.05
        pts, valid, keep = trails.catmull_rom_trails(history, current)
        pts, valid, keep = np.asarray(pts), np.asarray(valid), np.asarray(keep)
        for i in range(n):
            expect = oracles.ref_catmull_rom_trail(
                [history[f, i] for f in range(hist_len)], current[i])
            assert expect is not None and valid[i]
            got = pts[i][keep[i]]
            np.testing.assert_allclose(got, np.array(expect), atol=2e-5)

    def test_empty_history_invalid(self):
        pts, valid, keep = trails.catmull_rom_trails(
            np.zeros((0, 4, 3), np.float32), np.zeros((4, 3), np.float32))
        assert not np.any(np.asarray(valid))

    def test_stationary_points_dedup(self):
        # A point that never moves: all trail samples coincide -> dedup
        # collapses to <2 vertices -> invalid (open-curve rule).
        history = np.zeros((10, 2, 3), np.float32)
        current = np.zeros((2, 3), np.float32)
        _, valid, _ = trails.catmull_rom_trails(history, current)
        ref = oracles.ref_catmull_rom_trail(
            [history[f, 0] for f in range(10)], current[0])
        assert ref is None
        assert not np.any(np.asarray(valid))

    def test_history_window_capped_at_20(self):
        history = np.cumsum(
            RNG.normal(size=(30, 3, 3)).astype(np.float32) * 0.05, axis=0)
        current = history[-1]
        pts, valid, keep = trails.catmull_rom_trails(history, current)
        expect = oracles.ref_catmull_rom_trail(
            [history[f, 0] for f in range(30)], current[0])
        got = np.asarray(pts)[0][np.asarray(keep)[0]]
        np.testing.assert_allclose(got, np.array(expect), atol=2e-5)
