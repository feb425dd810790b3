"""Point-cloud loading with the reference's format/velocity detection.

Dispatch mirrors reference behavior exactly (traj_ball_renderer.py:223-279):

* ``.npy``  — raw array, returned as-is (may be (N,3), (N,6) or a (F,N,C)
  frame stack);
* ``.npz``  — the ``'pred'`` payload key (reference: traj_ball_renderer.py:234);
* ``.ply``  — x/y/z plus, in priority order, velocity columns (vx,vy,vz)
  or normal columns (nx,ny,nz) used as velocity (reference:
  traj_ball_renderer.py:253-273; the normals are used as-is, NOT negated,
  despite the reference's log message saying "inverted",
  traj_renderer.py:499-507);
* anything else raises ValueError (reference: traj_ball_renderer.py:279).

If a compiled native loader (native/pcr_native) is present it accelerates
binary-PLY parsing; the pure-NumPy path is always available.
"""

from __future__ import annotations

import os

import numpy as np

from pointcloud_render.io import ply as plyio

NPZ_PAYLOAD_KEY = "pred"


def load_point_cloud(file_path: str, positions_only: bool = False) -> np.ndarray:
    """Load a cloud as the raw (N, 3|6) / stacked (F, N, C) array layout.

    Args:
      file_path: path ending in .npy/.npz/.ply.
      positions_only: drop velocity/normal channels even when present
        (example_renderer semantics, reference: example_renderer.py:101-111).
    """
    ext = os.path.splitext(file_path)[1]
    if ext == ".npy":
        data = np.load(file_path, allow_pickle=True)
    elif ext == ".npz":
        data = np.load(file_path)[NPZ_PAYLOAD_KEY]
    elif ext == ".ply":
        data = _load_ply(file_path, positions_only=positions_only)
    else:
        raise ValueError("Unsupported file format.")
    if positions_only and data.ndim >= 2 and data.shape[-1] >= 3:
        # Trim the channel axis for flat (N, C) AND stacked (F, N, C)
        # layouts — a stacked example-preset .npy must not smuggle
        # velocity channels past the flag.
        return data[..., :3]
    return data


def _load_ply(file_path: str, positions_only: bool = False) -> np.ndarray:
    native = _native_ply_reader()
    if native is not None:
        try:
            return native(file_path, positions_only)
        except Exception:
            pass  # fall through to the NumPy parser
    elements = plyio.read_ply(file_path)
    vertex = elements["vertex"]
    base = [vertex["x"], vertex["y"], vertex["z"]]
    if not positions_only:
        if all(k in vertex for k in ("vx", "vy", "vz")):
            return np.column_stack(base + [vertex["vx"], vertex["vy"], vertex["vz"]])
        if all(k in vertex for k in ("nx", "ny", "nz")):
            return np.column_stack(base + [vertex["nx"], vertex["ny"], vertex["nz"]])
    return np.column_stack(base)


_NATIVE = None


def _native_ply_reader():
    global _NATIVE
    if _NATIVE is None:
        try:
            from pointcloud_render.io import native  # noqa: PLC0415

            _NATIVE = native.read_ply_array if native.available() else False
        except Exception:
            _NATIVE = False
    return _NATIVE or None
