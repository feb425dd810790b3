"""Native C++ IO runtime tests (skipped when the library isn't built)."""

import numpy as np
import pytest

from pointcloud_render.io import loaders, native, ply

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")

RNG = np.random.default_rng(2)


def test_binary_ply_matches_python(tmp_path):
    pos = RNG.normal(size=(5000, 3)).astype(np.float32)
    vel = RNG.normal(size=(5000, 3)).astype(np.float32)
    path = str(tmp_path / "c.ply")
    ply.write_ply(path, pos, velocities=vel)
    got = native.read_ply_array(path)
    expect = np.column_stack([pos, vel])
    np.testing.assert_array_equal(got, expect)


def test_normals_fallback_and_positions_only(tmp_path):
    pos = RNG.normal(size=(100, 3)).astype(np.float32)
    nrm = RNG.normal(size=(100, 3)).astype(np.float32)
    path = str(tmp_path / "n.ply")
    ply.write_ply(path, pos, normals=nrm)
    got = native.read_ply_array(path)
    np.testing.assert_array_equal(got[:, 3:], nrm)
    only = native.read_ply_array(path, positions_only=True)
    assert only.shape == (100, 3)


def test_ascii_ply(tmp_path):
    pos = RNG.normal(size=(50, 3)).astype(np.float32)
    path = str(tmp_path / "a.ply")
    ply.write_ply(path, pos, binary=False)
    got = native.read_ply_array(path)
    np.testing.assert_allclose(got, pos, atol=1e-5)


def test_png_roundtrip(tmp_path):
    from PIL import Image

    img = (RNG.uniform(size=(32, 64, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    assert native.write_png(path, img)
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, img)


def test_loader_dispatch_uses_native(tmp_path):
    pos = RNG.normal(size=(64, 3)).astype(np.float32)
    path = str(tmp_path / "d.ply")
    ply.write_ply(path, pos)
    got = loaders.load_point_cloud(path)
    np.testing.assert_array_equal(np.asarray(got, np.float32), pos)


def test_corrupt_file_fails_cleanly(tmp_path):
    path = str(tmp_path / "bad.ply")
    open(path, "wb").write(b"not a ply at all")
    with pytest.raises(IOError):
        native.read_ply_array(path)


def test_signed_int_properties_sign_extend(tmp_path):
    """Binary signed int/short/char coordinates must decode negatives
    (review r3: memcpy into a zero-initialized word read -1 as 2^32-1
    with rc=0, so loaders kept the garbage)."""
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex 3\n"
              b"property int x\nproperty short y\nproperty char z\n"
              b"end_header\n")
    rows = [(-1, -2, -3), (7, 8, 9), (-2147483648, -32768, -128)]
    body = b"".join(
        np.int32(x).tobytes() + np.int16(y).tobytes() + np.int8(z).tobytes()
        for x, y, z in rows)
    path = str(tmp_path / "s.ply")
    with open(path, "wb") as f:
        f.write(header + body)
    got = native.read_ply_array(path)
    np.testing.assert_array_equal(got, np.array(rows, np.float32))
    # ...and unsigned stays zero-extended.
    header_u = header.replace(b"property int x", b"property uint x")
    body_u = (np.uint32(4000000000).tobytes() + np.int16(1).tobytes()
              + np.int8(1).tobytes()) * 3
    path_u = str(tmp_path / "u.ply")
    with open(path_u, "wb") as f:
        f.write(header_u.replace(b"element vertex 3", b"element vertex 3")
                + body_u)
    got_u = native.read_ply_array(path_u)
    np.testing.assert_array_equal(got_u[:, 0],
                                  np.full(3, np.float32(4000000000.0)))


def test_ascii_element_before_vertex(tmp_path):
    """A spec-legal ascii PLY whose vertex element is NOT first must
    parse correctly (the old tokenizer read the preceding element's
    numbers as vertex rows)."""
    txt = ("ply\nformat ascii 1.0\n"
           "element commentish 2\nproperty float a\nproperty float b\n"
           "element vertex 2\n"
           "property float x\nproperty float y\nproperty float z\n"
           "end_header\n"
           "9 9\n8 8\n"
           "1 2 3\n4 5 6\n")
    path = str(tmp_path / "o.ply")
    with open(path, "w") as f:
        f.write(txt)
    got = native.read_ply_array(path)
    np.testing.assert_array_equal(
        got, np.array([[1, 2, 3], [4, 5, 6]], np.float32))
    # List property preceding vertex: counts skip their values.
    txt2 = ("ply\nformat ascii 1.0\n"
            "element face 2\nproperty list uchar int vertex_indices\n"
            "element vertex 1\n"
            "property float x\nproperty float y\nproperty float z\n"
            "end_header\n"
            "3 0 1 2\n2 0 1\n"
            "7 8 9\n")
    path2 = str(tmp_path / "o2.ply")
    with open(path2, "w") as f:
        f.write(txt2)
    got2 = native.read_ply_array(path2)
    np.testing.assert_array_equal(got2, np.array([[7, 8, 9]], np.float32))
