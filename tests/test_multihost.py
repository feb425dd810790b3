"""Real 2-process multihost test (a two-host cluster simulated on CPU).

Spawns two child interpreters, each a jax.distributed process with 4
forced CPU devices (8 global).  The children build the pod mesh via
parallel.multihost (frames across processes, points within), run the
full-scene sharded batch render, and each process checks ITS frames
against a reference rendered by a plain single-process 4-device
point-sharded run.  This exercises multihost.initialize() + the
cross-host frame-DP layout end-to-end.
"""

import os
import socket
import subprocess
import sys

import numpy as np

_CHILD = r'''
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
import jax
jax.config.update("jax_platforms", "cpu")
from pointcloud_render.parallel import multihost
multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
import jax.numpy as jnp
import numpy as np
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
assert jax.local_device_count() == 4

from pointcloud_render.configs import PRESETS
from pointcloud_render.parallel.multihost import make_pod_mesh
from pointcloud_render.parallel.render_parallel import (
    make_render_mesh, render_scene_batch_sharded, render_scene_point_sharded)
from pointcloud_render.raster.render import RasterConfig

mesh = make_pod_mesh(points_per_host_axis=4)
assert dict(mesh.shape) == {"frames": 2, "points": 4}
# 'points' must stay within one process's local devices (one host).
for row in mesh.devices:
    assert len({d.process_index for d in row}) == 1, "points axis crosses hosts"

preset = PRESETS["traj_ball"]
rng = np.random.default_rng(11)
f, n = 2, 128
pos = rng.uniform(-0.4, 0.4, (f, n, 3)).astype(np.float32)
vel = (rng.normal(size=(f, n, 3)) * 3).astype(np.float32)
fis = np.array([30, 170], np.int32)
cfg = RasterConfig(backend="tiled", max_per_tile=512)

from jax.sharding import NamedSharding, PartitionSpec as P
# Every process holds the same full host copy (same seed); each serves
# the shards it addresses.
sh = NamedSharding(mesh, P("frames", "points"))
gpos = jax.make_array_from_callback(pos.shape, sh, lambda i: pos[i])
gvel = jax.make_array_from_callback(vel.shape, sh, lambda i: vel[i])
gfis = jax.make_array_from_callback(
    fis.shape, NamedSharding(mesh, P("frames")), lambda i: fis[i])

out = jax.jit(lambda p, v, i: render_scene_batch_sharded(
    preset, p, v, i, cfg, mesh, width=256, height=64))(gpos, gvel, gfis)

# Each process owns one frame row; compare it to a local single-process
# reference over its own 4 devices.
local_mesh = make_render_mesh(1, 4, devices=jax.local_devices())
k = pid  # frame k lives on process k (host-major layout)
ref = jax.jit(lambda p, v: render_scene_point_sharded(
    preset, p, cfg, local_mesh, velocities=v, frame_index=int(fis[k]),
    width=256, height=64))(pos[k], vel[k])
got_idx = np.asarray(out.index.addressable_data(0))[0]
np.testing.assert_array_equal(got_idx, np.asarray(ref.index))
assert int(np.asarray(out.overflow.addressable_data(0))[0]) == 0
print(f"proc {pid} OK: frame {k} winner-exact over the two-host mesh")
'''


def test_two_process_pod_mesh():
    port = _free_port()
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    flags = [f for f in flags.split() if "host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=4"])
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH", ""), repo) if p)

    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(i), str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-4000:]}"
        assert f"proc {i} OK" in out


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
