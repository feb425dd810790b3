"""Multi-host setup helpers.

Within one host the meshes of render_parallel.py need nothing more: the
GPUs of an H100 host are joined all to all by NVLink, and XLA hands the
z-merge collectives (pmin/psum under shard_map) to NCCL, so every mesh
layout inside a host costs the same.  For clusters spanning hosts, JAX's
distributed runtime must be initialized before any device use, and the
mesh should put the FRAMES axis across hosts (frames are embarrassingly
parallel — only PNG paths leave each host) and the POINTS axis within a
host so the z-merge collectives stay on NVLink instead of the slower
inter-host network (SURVEY.md §5).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed (no-op if already initialized or single
    process).  Arguments default to the JAX_* environment variables.

    MUST run before any device use — even jax.process_count() brings the
    backend up single-process and poisons the real initialize (found by
    tests/test_multihost.py), so the already-initialized probe goes
    through the distributed client state, not the device API."""
    state = getattr(jax._src.distributed, "global_state", None)
    if state is not None and getattr(state, "client", None) is not None:
        return  # already initialized
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except (RuntimeError, ValueError):
        # Single-process run without a coordinator: fine — callers
        # proceed with the local devices.
        pass


def make_pod_mesh(points_per_host_axis: Optional[int] = None) -> Mesh:
    """('frames', 'points') mesh with 'points' confined to each host.

    Devices are laid out host-major, so taking `local_device_count`
    contiguous devices per frames-row keeps every 'points' collective on
    one host's NVLink domain; the 'frames' axis (pure data parallelism,
    no collectives in the render path) is what crosses hosts.
    """
    per_host = jax.local_device_count()
    points_axis = points_per_host_axis or per_host
    if per_host % points_axis:
        raise ValueError(
            f"points axis {points_axis} must divide local devices {per_host}")
    devices = np.asarray(jax.devices())
    frames_axis = devices.size // points_axis
    grid = devices.reshape(frames_axis, points_axis)
    return Mesh(grid, axis_names=("frames", "points"))
