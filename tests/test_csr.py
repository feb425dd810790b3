"""The exact CSR rasterizer (raster/csr.py): both walks against the oracle.

Every scene runs through the plain-XLA walk and through the Triton kernel
in interpret mode, over the same binning front end.  The scenes stress
the range decomposition: spill-heavy radii, tile-boundary anchors, exact
ties across ranges, grid-edge tiles, invalid prims next to live ranges,
big-list prims, binned triangles, spans 2/4/8 and odd image sizes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointcloud_render.raster import cpu_reference, csr
from pointcloud_render.raster.primitives import (
    KIND_CAPSULE,
    KIND_DISC,
    ScreenPrimitives,
    capsules_from_polylines,
    discs_from_points,
    triangles_from_mesh,
)
from pointcloud_render.raster.render import ground_plane

from test_raster import (
    H,
    W,
    make_camera,
    random_cloud_prims,
    to_host,
)

WALKS = ("xla", "triton")


def run_walk(walk, soup, width=W, height=H, **kw):
    """rasterize_csr through one walk; the Triton kernel interprets."""
    extra = {"interpret": True} if walk == "triton" else {}
    return csr.rasterize_csr(soup, width, height, walk=walk, **kw, **extra)


def _screen_discs(px, py, z, r, valid=None):
    """Screen-space discs with exact pixel placement (no camera) — for
    scenes that need a prim in a specific tile/class at a chosen depth."""
    px, py, z, r = (np.asarray(a, np.float32) for a in (px, py, z, r))
    n = px.shape[0]
    params = np.zeros((n, 12), np.float32)
    params[:, 0], params[:, 1], params[:, 2], params[:, 3] = px, py, z, r
    bbox = np.stack([px - r, px + r, py - r, py + r], axis=1)
    return ScreenPrimitives(
        kind=jnp.full((n,), KIND_DISC, jnp.int32),
        params=jnp.asarray(params),
        color=jnp.full((n, 3), 0.3, jnp.float32),
        valid=jnp.ones((n,), bool) if valid is None else jnp.asarray(valid),
        bbox=jnp.asarray(bbox),
        normal=jnp.zeros((n, 3), jnp.float32),
    )


def _mixed_soup(cam, n=400, trails=30, seed=7, radius=0.025):
    rng = np.random.default_rng(seed)
    discs = random_cloud_prims(cam, n=n, radius=radius, seed=seed)
    pts = rng.uniform(-0.4, 0.4, size=(trails, 5, 3)).astype(np.float32)
    caps = capsules_from_polylines(
        jnp.asarray(pts), np.ones((trails, 5), bool), cam, 0.003,
        np.array([0.2, 1.0, 0.4], np.float32))
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), discs, caps])


def _tie_soup(cam, n=300, ties=40):
    rng = np.random.default_rng(3)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos[ties:2 * ties] = pos[:ties]  # duplicated discs -> exact ties
    discs = discs_from_points(jnp.asarray(pos), cam,
                              jnp.full((n,), 0.03, jnp.float32),
                              np.array([0.3, 0.3, 0.3], np.float32))
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), discs])


def _long_capsule_soup(cam):
    rng = np.random.default_rng(3)
    base = rng.uniform(-0.4, 0.4, (60, 1, 3))
    steps = rng.normal(size=(60, 3, 3)) * 0.25
    pts = (base + np.cumsum(steps, axis=1)).astype(np.float32)
    caps = capsules_from_polylines(
        jnp.asarray(pts), np.ones((60, 3), bool), cam, 0.004,
        np.array([0.2, 1.0, 0.4], np.float32))
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), caps])


def _very_long_capsule_soup(cam):
    rng = np.random.default_rng(5)
    a = rng.uniform(-0.35, 0.35, (40, 1, 3)).astype(np.float32)
    b = a + rng.normal(size=(40, 1, 3)).astype(np.float32) * 1.1
    caps = capsules_from_polylines(
        jnp.asarray(np.concatenate([a, b], axis=1)), np.ones((40, 2), bool),
        cam, 0.004, np.array([0.2, 1.0, 0.4], np.float32))
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), caps])


def _mesh_soup(cam):
    from pointcloud_render.geometry.droplet import droplet_mesh

    verts, faces = droplet_mesh()
    rng = np.random.default_rng(2)
    parts = [ground_plane(cam, 10.0, (0, 0, -0.5))]
    for _ in range(6):
        c = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        parts.append(triangles_from_mesh(
            np.asarray(verts) * 4.0 + c, np.asarray(faces), cam,
            np.array([0.2, 0.5, 0.9], np.float32)))
    return ScreenPrimitives.concatenate(parts)


def _wide_disc_soup(cam):
    rng = np.random.default_rng(9)
    pos = rng.uniform(-0.3, 0.3, (40, 3)).astype(np.float32)
    wide = discs_from_points(jnp.asarray(pos), cam,
                             jnp.full((40,), 0.5, jnp.float32),
                             np.array([0.8, 0.2, 0.2], np.float32))
    return ScreenPrimitives.concatenate(
        [ground_plane(cam, 10.0, (0, 0, -0.5)), wide])


def _dense_tile_soup(cam):
    rng = np.random.default_rng(4)
    pos = np.concatenate([
        rng.uniform(-0.02, 0.02, (500, 2)),
        rng.uniform(-0.5, 0.5, (500, 1)),
    ], axis=1).astype(np.float32)
    return discs_from_points(jnp.asarray(pos), cam,
                             jnp.full((500,), 0.01, jnp.float32),
                             np.array([0.3, 0.3, 0.3], np.float32))


def _sparse_tile_soup(cam):
    """Discs in a checkerboard of tiles; every other tile is empty."""
    rng = np.random.default_rng(8)
    pxs, pys = [], []
    for tyy in range(H // 32):
        for txx in range(W // 32):
            if (txx + tyy) % 2 == 0:
                continue
            pxs.append(rng.uniform(txx * 32 + 3, txx * 32 + 29, 40))
            pys.append(rng.uniform(tyy * 32 + 3, tyy * 32 + 29, 40))
    px, py = np.concatenate(pxs), np.concatenate(pys)
    n = px.shape[0]
    return _screen_discs(px, py, rng.uniform(1.0, 5.0, n), np.full(n, 2.0))


def _cross_class_soup(cam):
    """One anchor holds 300 far class-0 discs and one NEAR x-spill disc;
    a big-list disc at a middle depth covers them all."""
    rng = np.random.default_rng(0)
    mid = _screen_discs([128.0], [80.0], [1.0], [400.0])  # big list
    far = _screen_discs(rng.uniform(68, 92, 300), rng.uniform(68, 92, 300),
                        rng.uniform(5.0, 6.0, 300), np.full(300, 2.0))
    near = _screen_discs([95.5], [80.0], [0.5], [2.0])  # crosses x=96
    return ScreenPrimitives.concatenate([mid, far, near])


def _invalid_tail_soup(cam):
    """One valid disc anchored in the LAST tile + 64 closer INVALID discs
    over the same pixels: invalid prims sort right past the live ranges
    and must never be walked."""
    n = 65
    valid = np.zeros((n,), bool)
    valid[0] = True
    z = np.full(n, 2.0)
    z[0] = 5.0
    return _screen_discs(np.full(n, W - 12.0), np.full(n, H - 12.0), z,
                         np.full(n, 6.0), valid=valid)


def _edge_anchor_soup(cam):
    """Discs straddling every tile boundary (all four spill classes) and
    the image border."""
    xs = np.arange(0, W + 1, 32, dtype=np.float32)
    ys = np.arange(0, H + 1, 32, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    px, py = gx.ravel(), gy.ravel()
    n = px.shape[0]
    z = np.linspace(1.0, 3.0, n)
    return _screen_discs(px, py, z, np.full(n, 7.5))


def _ground_only_soup(cam):
    return ground_plane(cam, 10.0, (0, 0, -0.5))


# (name, soup builder, rasterize_csr kwargs, depth rtol vs the oracle,
#  image size).  Disc depth must be bit-exact; capsule and triangle depth
# may differ from the oracle by FMA contraction (coverage.py), and
# triangle-dense scenes by edge-function cancellation near edges.
SCENES = {
    "mixed": (_mixed_soup, {}, 2e-5, (W, H)),
    "spill_heavy": (lambda c: _mixed_soup(c, n=250, radius=0.08, seed=11),
                    {}, 2e-5, (W, H)),
    "ties": (_tie_soup, {}, 2e-5, (W, H)),
    "wide_discs_big_list": (_wide_disc_soup, {"max_big": 64}, 2e-5, (W, H)),
    "mesh_lod_binned": (_mesh_soup, {"bin_triangles": True}, 5e-5, (W, H)),
    "mesh_lod_big_list": (_mesh_soup, {"max_big": 8192}, 5e-5, (W, H)),
    "dense_tile": (_dense_tile_soup, {}, 2e-5, (W, H)),
    "sparse_tiles": (_sparse_tile_soup, {}, 2e-5, (W, H)),
    "cross_class": (_cross_class_soup, {}, 2e-5, (W, H)),
    "invalid_tail": (_invalid_tail_soup, {}, 2e-5, (W, H)),
    "edge_anchors": (_edge_anchor_soup, {}, 2e-5, (W, H)),
    "ground_only": (_ground_only_soup, {}, 2e-5, (W, H)),
    "span4_long_capsules": (_long_capsule_soup, {"span": 4}, 2e-5, (W, H)),
    "span4_spill_heavy": (
        lambda c: _mixed_soup(c, n=250, radius=0.08, seed=11),
        {"span": 4}, 2e-5, (W, H)),
    "span4_ties": (_tie_soup, {"span": 4}, 2e-5, (W, H)),
    "span8_long_capsules": (_very_long_capsule_soup,
                            {"span": 8, "max_big": 8}, 2e-5, (W, H)),
    "span8_mixed": (lambda c: _mixed_soup(c, n=200, radius=0.06, seed=13),
                    {"span": 8}, 2e-5, (W, H)),
    "odd_size": (lambda c: _mixed_soup(c, seed=19), {}, 2e-5, (250, 150)),
    "single_partial_tile": (lambda c: _mixed_soup(c, n=200, seed=23), {},
                            2e-5, (29, 21)),
    "tiles_16x64": (lambda c: _mixed_soup(c, n=150),
                    {"tile_h": 16, "tile_w": 64}, 2e-5, (W, H)),
    "tiles_64x16": (lambda c: _mixed_soup(c, n=150),
                    {"tile_h": 64, "tile_w": 16}, 2e-5, (W, H)),
    "tiles_8x128": (lambda c: _mixed_soup(c, n=150),
                    {"tile_h": 8, "tile_w": 128}, 2e-5, (W, H)),
}


def _scene(name):
    build, kw, rtol, (w, h) = SCENES[name]
    return build(make_camera(w, h)), kw, rtol, w, h


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_matches_oracle(scene, walk):
    soup, kw, rtol, w, h = _scene(scene)
    d_o, i_o = cpu_reference.rasterize_reference(to_host(soup), w, h)
    assert (i_o >= 0).any(), "empty render — the comparison is vacuous"
    d, i, ovf = run_walk(walk, soup, w, h, **kw)
    assert int(ovf) == 0
    np.testing.assert_array_equal(np.asarray(i), i_o)
    hit = i_o >= 0
    disc = hit & (np.asarray(soup.kind)[i_o.clip(0)] == KIND_DISC)
    np.testing.assert_array_equal(np.asarray(d)[disc], d_o[disc])
    np.testing.assert_allclose(np.asarray(d)[hit], d_o[hit], rtol=rtol)
    assert not np.isfinite(np.asarray(d)[~hit]).any()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_walks_agree(scene):
    """The two walks visit the same ranges and rows: same winners, and
    disc depth bit-equal (the comparison the chip run repeats)."""
    soup, kw, _, w, h = _scene(scene)
    d_a, i_a, o_a = run_walk("xla", soup, w, h, **kw)
    d_b, i_b, o_b = run_walk("triton", soup, w, h, **kw)
    np.testing.assert_array_equal(np.asarray(i_b), np.asarray(i_a))
    assert int(o_a) == int(o_b)
    i = np.asarray(i_a)
    disc = (i >= 0) & (np.asarray(soup.kind)[i.clip(0)] == KIND_DISC)
    np.testing.assert_array_equal(np.asarray(d_b)[disc],
                                  np.asarray(d_a)[disc])


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_chunk_sizes_bit_identical(walk, chunk):
    """Chunk boundaries fall at different places inside the ranges; the
    result must not move."""
    soup = _mixed_soup(make_camera(), seed=13, radius=0.05)
    d_ref, i_ref, _ = run_walk(walk, soup, chunk=4)
    d, i, _ = run_walk(walk, soup, chunk=chunk)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d_ref))


@pytest.mark.parametrize("walk", WALKS)
def test_order_permutation_invariance(walk):
    """Permuting primitive order changes ids but not the image (no exact
    duplicates here: under relabeling a tie legitimately picks another
    label of the same geometry)."""
    cam = make_camera()
    rng = np.random.default_rng(5)
    pos = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    perm = rng.permutation(200)
    col = np.array([0.3, 0.3, 0.3], np.float32)
    a = discs_from_points(jnp.asarray(pos), cam,
                          jnp.full((200,), 0.03, jnp.float32), col)
    b = discs_from_points(jnp.asarray(pos[perm]), cam,
                          jnp.full((200,), 0.03, jnp.float32), col)
    d_a, i_a, _ = run_walk(walk, a)
    d_b, i_b, _ = run_walk(walk, b)
    i_a, i_b = np.asarray(i_a), np.asarray(i_b)
    np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_b))
    hit = i_a >= 0
    np.testing.assert_array_equal(
        np.where(hit, perm[i_b.clip(0)], -1), np.where(hit, i_a, -1))


@pytest.mark.parametrize("walk", WALKS)
def test_span4_matches_span2_on_small_prims(walk):
    soup = _mixed_soup(make_camera(), seed=29)
    d2, i2, _ = run_walk(walk, soup, span=2)
    d4, i4, _ = run_walk(walk, soup, span=4)
    np.testing.assert_array_equal(np.asarray(i4), np.asarray(i2))
    hit = np.asarray(i2) >= 0
    np.testing.assert_allclose(np.asarray(d4)[hit], np.asarray(d2)[hit],
                               rtol=2e-5)


@pytest.mark.parametrize("walk", WALKS)
def test_big_list_overflow_is_reported(walk):
    """Past max_big the walk drops big prims; the count it returns and
    bin_diagnostics' must both say so."""
    soup = _wide_disc_soup(make_camera())  # every valid prim is big
    _, _, ovf = run_walk(walk, soup, max_big=8)
    diag = int(np.asarray(csr.bin_diagnostics(soup, W, H, max_big=8)))
    assert int(ovf) == diag == int(np.sum(np.asarray(soup.valid))) - 8


@pytest.mark.parametrize("span,want", [(2, True), (4, False)])
def test_bin_diagnostics_spans(span, want):
    """span=4 bins the long capsules that span=2 sends to the big list."""
    soup = _long_capsule_soup(make_camera())
    ovf = int(np.asarray(csr.bin_diagnostics(soup, W, H, max_big=16,
                                             span=span)))
    assert (ovf > 0) == want


def test_span8_bins_what_span4_overflows():
    soup = _very_long_capsule_soup(make_camera())
    ov4 = int(np.asarray(csr.bin_diagnostics(soup, W, H, max_big=8, span=4)))
    ov8 = int(np.asarray(csr.bin_diagnostics(soup, W, H, max_big=8, span=8)))
    assert ov4 > 0 and ov8 == 0


@pytest.mark.parametrize("span", [2, 4, 8])
def test_ranges_cover_exactly_the_binned_prims(span):
    """The range table's union for each tile is exactly the set of binned
    prims whose tile bbox touches it — each once — plus the big list."""
    soup = _mixed_soup(make_camera(), n=300, radius=0.06, seed=3)
    tiles_x, tiles_y = csr.tile_grid(W, H, 32, 32)
    keys, sp, n_small, big = csr._bin(soup, 32, 32, tiles_x, tiles_y,
                                      False, span)
    k2 = span * span
    bounds = np.arange(tiles_x * tiles_y * k2 + 1).astype(keys.dtype)
    starts = jnp.searchsorted(keys, bounds).astype(jnp.int32)
    rs, rn = csr._range_table(starts, tiles_x, tiles_y, span, n_small, big)
    rs, rn, sp = np.asarray(rs), np.asarray(rn), np.asarray(sp)
    bbox = np.asarray(soup.bbox)
    tx0 = np.clip(np.floor(bbox[:, 0] / 32), 0, tiles_x - 1).astype(int)
    tx1 = np.clip(np.floor(bbox[:, 1] / 32), 0, tiles_x - 1).astype(int)
    ty0 = np.clip(np.floor(bbox[:, 2] / 32), 0, tiles_y - 1).astype(int)
    ty1 = np.clip(np.floor(bbox[:, 3] / 32), 0, tiles_y - 1).astype(int)
    binned = set(sp[:int(n_small)].tolist())
    big_ids = sorted(sp[int(n_small):int(n_small) + int(big)].tolist())
    assert binned and big_ids
    for t in range(tiles_x * tiles_y):
        tx, ty = t % tiles_x, t // tiles_x
        walked = []
        for s, n in zip(rs[t, :-1], rn[t, :-1]):
            walked += sp[s:s + n].tolist()
        assert len(walked) == len(set(walked)), f"tile {t}: duplicates"
        want = {p for p in binned
                if tx0[p] <= tx <= tx1[p] and ty0[p] <= ty <= ty1[p]}
        assert set(walked) == want, f"tile {t}"
        s, n = rs[t, -1], rn[t, -1]
        assert sorted(sp[s:s + n].tolist()) == big_ids


@pytest.mark.parametrize("walk,num_prims,num_tiles,want", [
    ("xla", 10, 40, 4),
    ("xla", 600, 40, 16),
    ("xla", 9_000_000, 2040, 32),
    ("triton", 10, 40, 4),
    ("triton", 200, 40, 8),
    ("triton", 9_000_000, 2040, 8),
])
def test_pick_chunk(walk, num_prims, num_tiles, want):
    c = csr.pick_chunk(walk, num_prims, num_tiles)
    assert c == want and c & (c - 1) == 0


@pytest.mark.parametrize("kw,match", [
    ({"walk": "mosaic"}, "unknown walk"),
    ({"walk": "xla", "tile_h": 24}, "powers of two"),
    ({"walk": "xla", "chunk": 12}, "power of two"),
    ({"walk": "xla", "span": 0}, "span"),
])
def test_rejects_bad_arguments(kw, match):
    soup = random_cloud_prims(make_camera(), n=16)
    with pytest.raises(ValueError, match=match):
        csr.rasterize_csr(soup, W, H, **kw)


def test_huge_tile_grid_keys_fall_back_to_int32():
    """A grid with more ordinals than int16 holds sorts int32 keys, and
    the binned keys stay below the big-list sentinel."""
    tiles_x, tiles_y = 250, 160  # 40000 tiles
    px = np.array([tiles_x * 32 - 40.0, tiles_x * 32 - 400.0], np.float32)
    py = np.array([tiles_y * 32 - 40.0, tiles_y * 32 - 200.0], np.float32)
    soup = _screen_discs(px, py, np.array([1.0, 2.0]), np.array([5.0, 5.0]))
    keys, _, n_small, big = csr._bin(soup, 32, 32, tiles_x, tiles_y,
                                     False, 2)
    k = np.asarray(keys)
    assert k.dtype == np.int32
    assert (np.diff(k) >= 0).all()
    assert int(n_small) == 2 and int(big) == 0
    assert (k < tiles_x * tiles_y * 4).all() and (k >= 0).all()


class TestToneShade:
    """The per-kind-constant shade equals shade_framebuffer bit for bit
    whenever its certificate holds."""

    def test_three_tone_bit_equal(self):
        from pointcloud_render.shading.shade import (
            ShadingConfig,
            derive_three_tone,
            shade_framebuffer,
            shade_tones,
        )

        cam = make_camera()
        soup = _mixed_soup(cam, n=250, trails=35, seed=37)
        reps_d, ok = derive_three_tone(soup)
        assert bool(np.asarray(ok))
        reps = tuple(int(v) for v in np.asarray(reps_d))
        d, i, _ = run_walk("xla", soup)
        cfg = ShadingConfig()
        np.testing.assert_array_equal(
            np.asarray(shade_tones(soup, cam, cfg, d, i, reps)),
            np.asarray(shade_framebuffer(soup, cam, d, i, cfg)))

    def test_derive_three_tone_rejects_varied_colors(self):
        from pointcloud_render.shading.shade import derive_three_tone

        soup = _mixed_soup(make_camera(), n=50, trails=5)
        _, ok = derive_three_tone(soup)
        assert bool(np.asarray(ok))
        colors = np.asarray(soup.color).copy()
        kind = np.asarray(soup.kind)
        colors[int(np.where(kind == KIND_DISC)[0][-1])] = [0.9, 0.1, 0.1]
        varied = dataclasses.replace(soup, color=jnp.asarray(colors))
        _, ok2 = derive_three_tone(varied)
        assert not bool(np.asarray(ok2))

    def test_four_tone_bit_equal_on_droplet_soup(self):
        from pointcloud_render.configs import PRESETS
        from pointcloud_render.run.pipeline import build_primitives
        from pointcloud_render.shading.shade import (
            ShadingConfig,
            derive_four_tone,
            derive_three_tone,
            shade_framebuffer,
            shade_tones,
        )

        cam = make_camera()
        rng = np.random.default_rng(11)
        pos = jnp.asarray(rng.uniform(-0.4, 0.4, (120, 3)), jnp.float32)
        vel = jnp.asarray(rng.normal(size=(120, 3)) * 2, jnp.float32)
        soup = build_primitives(PRESETS["traj_vel"], cam, pos, vel,
                                jnp.int32(120))
        _, ok3 = derive_three_tone(soup)
        assert not bool(np.asarray(ok3))  # two capsule colors
        vals_d, ok4 = derive_four_tone(soup)
        assert bool(np.asarray(ok4))
        vals = tuple(int(v) for v in np.asarray(vals_d))
        d, i, _ = run_walk("xla", soup)
        cfg = ShadingConfig()
        np.testing.assert_array_equal(
            np.asarray(shade_tones(soup, cam, cfg, d, i, vals)),
            np.asarray(shade_framebuffer(soup, cam, d, i, cfg)))
        # Both capsule runs must win pixels for the equality to mean
        # anything.
        ids = np.asarray(i)
        kind = np.asarray(soup.kind)
        caps = ids[ids >= 0][kind[ids[ids >= 0]] == KIND_CAPSULE]
        assert (caps < vals[3]).any() and (caps >= vals[3]).any()

    def test_derive_four_tone_rejects_three_capsule_colors(self):
        from pointcloud_render.shading.shade import derive_four_tone

        soup = _mixed_soup(make_camera(), n=50, trails=8)
        _, ok = derive_four_tone(soup)
        assert bool(np.asarray(ok))  # one capsule color: degenerate ok
        colors = np.asarray(soup.color).copy()
        cap_ids = np.where(np.asarray(soup.kind) == KIND_CAPSULE)[0]
        colors[cap_ids[len(cap_ids) // 2]] = [0.9, 0.1, 0.1]
        colors[cap_ids[-1]] = [0.1, 0.1, 0.9]
        varied = dataclasses.replace(soup, color=jnp.asarray(colors))
        _, ok3 = derive_four_tone(varied)
        assert not bool(np.asarray(ok3))

    def test_render_config_three_tone(self):
        from pointcloud_render.raster.render import RasterConfig, render
        from pointcloud_render.shading.shade import derive_three_tone

        cam = make_camera()
        soup = _mixed_soup(cam, n=120, trails=10, seed=41)
        reps = tuple(int(v) for v in np.asarray(derive_three_tone(soup)[0]))
        fb_a = render(soup, cam, RasterConfig())
        fb_b = render(soup, cam, RasterConfig(three_tone=reps))
        np.testing.assert_array_equal(np.asarray(fb_b.rgb),
                                      np.asarray(fb_a.rgb))


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["mixed", "mesh_lod_binned", "span4_ties"])
def test_compiled_triton_kernel_matches_xla(scene, gpu):
    """On a GPU: the compiled Triton walk against the XLA walk."""
    soup, kw, _, w, h = _scene(scene)
    d_a, i_a, _ = csr.rasterize_csr(soup, w, h, walk="xla", **kw)
    d_b, i_b, _ = jax.jit(lambda s: csr.rasterize_csr(
        s, w, h, walk="triton", **kw))(soup)
    assert (np.asarray(i_a) == np.asarray(i_b)).mean() >= 1 - 1e-3


@pytest.mark.parametrize("bin_triangles", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_triton_kernel_lowers_for_cuda(chunk, bin_triangles):
    """The Pallas->Triton lowering runs without a card: a kernel that the
    Triton route cannot express fails here, not first on the GPU."""
    soup = _mixed_soup(make_camera(), n=64, trails=4)
    fn = jax.jit(lambda s: csr.rasterize_csr(
        s, W, H, walk="triton", chunk=chunk, bin_triangles=bin_triangles))
    text = fn.trace(soup).lower(lowering_platforms=("cuda",)).as_text()
    assert "csr_walk" in text


@pytest.mark.parametrize("max_big", [0, 16])
@pytest.mark.parametrize("span", [2, 4, 8])
def test_probe_agrees_with_the_render(span, max_big):
    """bin_diagnostics (the trajectory renderer's big-list probe) counts
    exactly the overflow that the render reports at the same settings."""
    soup = _long_capsule_soup(make_camera())
    _, _, ovf = run_walk("xla", soup, span=span, max_big=max_big)
    probe = csr.bin_diagnostics(soup, W, H, max_big=max_big, span=span)
    assert int(ovf) == int(probe)
    if max_big == 0:
        assert int(probe) >= 2  # at least the ground's two triangles


@pytest.mark.parametrize("walk", WALKS)
def test_walk_under_vmap(walk):
    """A frame batch (the frames-DP and 2D batch renderers vmap the
    render) gives each frame's own result."""
    cam = make_camera()
    soups = [_mixed_soup(cam, n=120, trails=6, seed=s) for s in (1, 2)]
    batched = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *soups)
    d_b, i_b, _ = jax.vmap(lambda s: run_walk(walk, s))(batched)
    for k, soup in enumerate(soups):
        d, i, _ = run_walk(walk, soup)
        i = np.asarray(i)
        np.testing.assert_array_equal(np.asarray(i_b[k]), i)
        # Disc depth is a copy of z; capsule/ground depth may round
        # differently in the batched program (FMA contraction).
        hit = i >= 0
        disc = hit & (np.asarray(soup.kind)[i.clip(0)] == KIND_DISC)
        np.testing.assert_array_equal(np.asarray(d_b[k])[disc],
                                      np.asarray(d)[disc])
        np.testing.assert_allclose(np.asarray(d_b[k])[hit],
                                   np.asarray(d)[hit], rtol=2e-5)


def test_batched_triton_kernel_lowers_for_cuda():
    cam = make_camera()
    soups = [_mixed_soup(cam, n=64, trails=4, seed=s) for s in (1, 2)]
    batched = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *soups)
    fn = jax.jit(jax.vmap(lambda s: csr.rasterize_csr(s, W, H,
                                                      walk="triton")))
    text = fn.trace(batched).lower(lowering_platforms=("cuda",)).as_text()
    assert "csr_walk" in text
