"""Screen-space primitive soup (SoA, static shapes).

Every scene element of the reference maps to one of three screen-space
primitive kinds after projection:

* DISC     — ball splats (reference sphere shapes, traj_ball_renderer.py:37-47);
* CAPSULE  — trail polyline segments (reference linearcurve shapes,
             traj_ball_renderer.py:48-57);
* TRIANGLE — ground/emitter rectangles and instanced droplet meshes
             (reference rectangle/obj shapes, traj_renderer.py:44-54,65-83).

All primitives live in one padded (P, 12) float32 parameter block plus a
kind code, color, validity mask and screen bbox — fixed shapes, mask-based
invalidation, so the soup flows straight through jit and the tiled kernel.

Parameter layout (unused slots zero).  Derived quantities (r^2, 1/len^2,
edge constants, 1/area) are precomputed HERE so the per-pixel inner loop of
every backend is pure mul/add/compare — IEEE-deterministic and therefore
reproducible between the NumPy oracle and every backend (up to FMA
contraction, see coverage.py):

  DISC:     [px, py, z, r_px, 0, 0, 0, 0, 0] — a DEGENERATE CAPSULE
            (zero axis: t evaluates to 0, radius to r, depth to z, so one
             evaluator serves both kinds with identical float semantics;
             the kind code remains DISC for shading)
  CAPSULE:  [x0, y0, z0, r0, dx, dy, dz, dr, inv_len2]
            (d* = end minus start; per pixel t = ((q-p0).d) * inv_len2,
             clamped to [0,1]; radius r0 + dr*t; depth z0 + dz*t)
  TRIANGLE: [ex0, ey0, c0, ex1, ey1, c1, ex2, ey2, c2, a0, a1, a2]
            (three edge functions e_i(q) = ex_i*qy - ey_i*qx + c_i,
             pre-oriented so coverage is e0>=0 & e1>=0 & e2>=0;
             interpolated inverse depth iz(q) = e0*a0 + e1*a1 + e2*a2,
             with a_i = (1/z_i) / |area| folded in; depth = 1/iz is the
             single division, applied in the resolve stage)

Depth rule (the shared contract):
  DISC     — constant z of the center (billboard);
  CAPSULE  — z linearly interpolated along the segment axis parameter;
  TRIANGLE — perspective-correct: 1 / (barycentric-interpolated 1/z).
Winner per pixel = lexicographic min of (depth, primitive row index).
Pixel centers sample at (col + 0.5, row + 0.5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_render.raster.project import apply_world_to_camera, project_points

KIND_DISC = 0
KIND_CAPSULE = 1
KIND_TRIANGLE = 2

PARAM_WIDTH = 12


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScreenPrimitives:
    kind: jax.Array  # (P,) int32
    params: jax.Array  # (P, 12) float32
    color: jax.Array  # (P, 3) float32
    valid: jax.Array  # (P,) bool
    bbox: jax.Array  # (P, 4) float32: xmin, xmax, ymin, ymax (pixels)
    normal: jax.Array  # (P, 3) float32 camera-space normal (triangles only)

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    @staticmethod
    def concatenate(parts):
        parts = [p for p in parts if p is not None and p.count > 0]
        if not parts:
            raise ValueError("no primitives")
        return ScreenPrimitives(
            kind=jnp.concatenate([p.kind for p in parts]),
            params=jnp.concatenate([p.params for p in parts]),
            color=jnp.concatenate([p.color for p in parts]),
            valid=jnp.concatenate([p.valid for p in parts]),
            bbox=jnp.concatenate([p.bbox for p in parts]),
            normal=jnp.concatenate([p.normal for p in parts]),
        )


def _pad_params(cols):
    """Stack (N,) columns into the padded (N, 12) parameter block.

    One stack + one pad — a zeros block with per-column .at[].set writes
    costs a full (N, 12) pass PER COLUMN (measured ~5 ms of the 1M-point
    frame's build stage)."""
    n = cols[0].shape[0]
    block = jnp.stack([jnp.asarray(c, jnp.float32) for c in cols], axis=1)
    if block.shape[1] < PARAM_WIDTH:
        block = jnp.pad(block, ((0, 0), (0, PARAM_WIDTH - block.shape[1])))
    return block


def _broadcast_color(colors, n):
    colors = jnp.asarray(colors, jnp.float32)
    return jnp.broadcast_to(colors, (n, 3)) if colors.ndim == 1 else colors


def discs_from_points(positions, camera, radii, colors) -> ScreenPrimitives:
    """Ball splats: project sphere centers, keep the projected radius."""
    proj = project_points(positions, camera, radii=radii)
    px, py, z, r = proj["px"], proj["py"], proj["z"], proj["r_px"]
    params = _pad_params([px, py, z, r])
    bbox = jnp.stack([px - r, px + r, py - r, py + r], axis=1)
    n = px.shape[0]
    return ScreenPrimitives(
        kind=jnp.full((n,), KIND_DISC, jnp.int32),
        params=params,
        color=_broadcast_color(colors, n),
        valid=proj["valid"],
        bbox=bbox,
        normal=jnp.zeros((n, 3), jnp.float32),
    )


def capsules_from_polylines(
    points, vertex_valid, camera, radius_world, colors
) -> ScreenPrimitives:
    """Trail polylines -> per-segment screen capsules.

    Args:
      points: (N, V, 3) polyline vertices (e.g. V=21 trail points).
      vertex_valid: (N, V) bool — per-vertex keep mask (trail validity and
        the Catmull-Rom dedup mask fold in here).  A segment (i, i+1) is
        emitted iff both endpoints are kept; zero-length segments (the
        reference's duplicated final trail vertex,
        traj_ball_renderer.py:148-150) are dropped as degenerate.
      radius_world: world-space curve radius — a scalar (constant 0.0007
        in the reference, traj_ball_renderer.py:160) or an (N, V) array of
        per-vertex radii (tapered capsules, e.g. droplet tails).
      colors: (3,) or (N, 3) trail color (per polyline).
    """
    n, v = points.shape[:2]
    flat = points.reshape(n * v, 3)
    radius_world = jnp.asarray(radius_world, jnp.float32)
    flat_r = (jnp.full((n * v,), radius_world) if radius_world.ndim == 0
              else radius_world.reshape(n * v))
    proj = project_points(flat, camera, radii=flat_r)
    px = proj["px"].reshape(n, v)
    py = proj["py"].reshape(n, v)
    z = proj["z"].reshape(n, v)
    r = proj["r_px"].reshape(n, v)
    # Depth cull per VERTEX (a near/far-crossing segment's projection is
    # unusable), but screen cull per SEGMENT bbox: a segment is kept
    # when any part of it may touch the film, so long segments (e.g. the
    # collapsed single-capsule velocity trails) don't vanish just
    # because one endpoint projects off-screen.
    zok = (z > camera.near) & (z < camera.far)
    pvalid = zok & vertex_valid

    x0, y0, z0, r0 = px[:, :-1], py[:, :-1], z[:, :-1], r[:, :-1]
    x1, y1, z1, r1 = px[:, 1:], py[:, 1:], z[:, 1:], r[:, 1:]
    dx, dy, dz, dr = x1 - x0, y1 - y0, z1 - z0, r1 - r0
    len2 = dx * dx + dy * dy
    seg_valid = pvalid[:, :-1] & pvalid[:, 1:] & (len2 > 0)
    inv_len2 = 1.0 / jnp.where(len2 > 0, len2, 1.0)

    cols = [c.reshape(-1) for c in (x0, y0, z0, r0, dx, dy, dz, dr, inv_len2)]
    params = _pad_params(cols)
    # NOTE on the bbox low bit: XLA may or may not contract the
    # projected radius's final multiply into these subs (fma) depending
    # on the surrounding graph, so bbox can differ by 1 ulp across
    # compilations (and between this builder and its packed-column twin
    # capsules_from_vertex_columns).  The winner-defining fields
    # (params/valid) are pinned by project_points' barrier; bbox is a
    # conservative binning bound whose +-1 ulp is harmless within any
    # one program — every consumer (binning, oracle) reads the SAME
    # soup's bbox.
    xmin = jnp.minimum(x0 - r0, x1 - r1).reshape(-1)
    xmax = jnp.maximum(x0 + r0, x1 + r1).reshape(-1)
    ymin = jnp.minimum(y0 - r0, y1 - r1).reshape(-1)
    ymax = jnp.maximum(y0 + r0, y1 + r1).reshape(-1)
    bbox = jnp.stack([xmin, xmax, ymin, ymax], axis=1)
    on_film = ((xmax >= 0) & (xmin <= camera.width)
               & (ymax >= 0) & (ymin <= camera.height))
    seg_valid = seg_valid & on_film.reshape(n, v - 1)
    m = n * (v - 1)
    colors = jnp.asarray(colors, jnp.float32)
    if colors.ndim == 1:
        color = jnp.broadcast_to(colors, (m, 3))
    else:
        color = jnp.repeat(colors, v - 1, axis=0)
    return ScreenPrimitives(
        kind=jnp.full((m,), KIND_CAPSULE, jnp.int32),
        params=params,
        color=color,
        valid=seg_valid.reshape(-1),
        bbox=bbox,
        normal=jnp.zeros((m, 3), jnp.float32),
    )


def capsules_from_vertex_columns(
    vertex_cols, valid_cols, camera, radius_world, colors
) -> ScreenPrimitives:
    """Packed-layout twin of :func:`capsules_from_polylines` for SMALL
    static vertex counts.

    Takes the polyline as V separate (N, 3) vertex COLUMNS instead of
    one (N, V, 3) array.  Numerically this evaluates exactly the same
    f32 expressions per element (projection, deltas, len2, bbox, culls).
    Equivalence contract (pinned by test_packed_capsule_build_bit_equal
    and build_probe's on-chip BITCHECK): params / valid / color / kind
    are BIT-identical (project_points pins them with an optimization
    barrier); bbox may drift by a float rounding error across
    compilations — XLA's fma contraction of the radius multiply into
    the bbox sub is a per-compilation choice the polyline path is
    equally subject to.  The drift is winner-safe: a winner could only
    change if a truly-covered pixel fell in a tile the drifted bbox
    dropped, and the nearest pixel center of a dropped tile sits
    >= (0.5 px - drift) beyond the exact extent while f32 coverage
    cannot exceed that extent by more than ~1e-4 px of eval rounding
    (the BITCHECK bounds drift at < 0.01 px).  Columns keep every
    intermediate a fully packed (N,) vector instead of a narrow (N, V)
    array; only the final point-major interleave (one stack+reshape per
    output column) touches the (N, V) layout.

    Args:
      vertex_cols: list of V (N, 3) vertex positions.
      valid_cols: list of V (N,) bool per-vertex keep masks.
      radius_world: scalar or (N, V) per-vertex radii.
      colors: (3,) or (N, 3) per-polyline color.
    """
    v = len(vertex_cols)
    n = vertex_cols[0].shape[0]
    radius_world = jnp.asarray(radius_world, jnp.float32)

    projs, pvalid = [], []
    for j in range(v):
        rj = (jnp.full((n,), radius_world) if radius_world.ndim == 0
              else radius_world[:, j])
        proj = project_points(vertex_cols[j], camera, radii=rj)
        projs.append(proj)
        zok = (proj["z"] > camera.near) & (proj["z"] < camera.far)
        pvalid.append(zok & valid_cols[j])

    names = ("x0", "y0", "z0", "r0", "dx", "dy", "dz", "dr", "il2")
    cols = {k: [] for k in names}
    bb = {k: [] for k in ("xmin", "xmax", "ymin", "ymax")}
    valids = []
    for s in range(v - 1):
        a, b = projs[s], projs[s + 1]
        x0, y0, z0, r0 = a["px"], a["py"], a["z"], a["r_px"]
        x1, y1, r1 = b["px"], b["py"], b["r_px"]
        dx, dy = x1 - x0, y1 - y0
        dz, dr = b["z"] - z0, r1 - r0
        len2 = dx * dx + dy * dy
        sv = pvalid[s] & pvalid[s + 1] & (len2 > 0)
        il2 = 1.0 / jnp.where(len2 > 0, len2, 1.0)
        # bbox low bit: see capsules_from_polylines' NOTE (fma
        # contraction makes it compilation-dependent; conservative
        # binning bound, harmless within one program).
        xmin = jnp.minimum(x0 - r0, x1 - r1)
        xmax = jnp.maximum(x0 + r0, x1 + r1)
        ymin = jnp.minimum(y0 - r0, y1 - r1)
        ymax = jnp.maximum(y0 + r0, y1 + r1)
        on_film = ((xmax >= 0) & (xmin <= camera.width)
                   & (ymax >= 0) & (ymin <= camera.height))
        sv = sv & on_film
        for k, val in zip(names, (x0, y0, z0, r0, dx, dy, dz, dr, il2)):
            cols[k].append(val)
        for k, val in zip(bb, (xmin, xmax, ymin, ymax)):
            bb[k].append(val)
        valids.append(sv)

    def interleave(cs):
        # S columns of (N,) -> point-major (N*S,): prim id stays
        # point * S + s, the layout contract of build_primitives.
        return jnp.stack(cs, axis=1).reshape(-1)

    params = _pad_params([interleave(cols[k]) for k in names])
    bbox = jnp.stack([interleave(bb[k]) for k in bb], axis=1)
    m = n * (v - 1)
    colors = jnp.asarray(colors, jnp.float32)
    if colors.ndim == 1:
        color = jnp.broadcast_to(colors, (m, 3))
    else:
        color = jnp.repeat(colors, v - 1, axis=0)
    return ScreenPrimitives(
        kind=jnp.full((m,), KIND_CAPSULE, jnp.int32),
        params=params,
        color=color,
        valid=interleave(valids),
        bbox=bbox,
        normal=jnp.zeros((m, 3), jnp.float32),
    )


def _near_clip_triangles(cam_verts, near):
    """Sutherland-Hodgman near-plane clip, static shapes.

    Args:
      cam_verts: (F, 3, 3) camera-space triangle vertices.
      near: clip depth (vertices at z <= near are outside).
    Returns:
      out_verts: (2F, 3, 3) clipped triangles (each input yields 0-2),
      out_valid: (2F,) bool,
      src: (2F,) int32 index of the source input triangle.
    """
    # Clip fractionally inside the near plane so every emitted vertex
    # strictly satisfies z > near.
    plane = near * (1.0 + 1e-5)
    z = cam_verts[..., 2]  # (F, 3)
    inside = z > plane
    n_in = jnp.sum(inside.astype(jnp.int32), axis=1)  # (F,)

    # Rotate vertex order so the canonical patterns hold:
    #   n_in == 1 -> vertex 0 is the inside one;
    #   n_in == 2 -> vertex 2 is the outside one.
    i0, i1, i2 = inside[:, 0], inside[:, 1], inside[:, 2]
    k_one = jnp.where(i0, 0, jnp.where(i1, 1, 2))
    k_two = jnp.where(~i0, 1, jnp.where(~i1, 2, 0))  # outside idx + 1 mod 3
    k = jnp.where(n_in == 1, k_one, jnp.where(n_in == 2, k_two, 0))

    f = cam_verts.shape[0]
    rows = np.arange(f)
    a = cam_verts[rows, k % 3]
    b = cam_verts[rows, (k + 1) % 3]
    c = cam_verts[rows, (k + 2) % 3]

    def isect(p, q):
        """Intersection of segment p->q with the clip plane."""
        t = (plane - p[:, 2]) / jnp.where(q[:, 2] == p[:, 2], 1.0,
                                          q[:, 2] - p[:, 2])
        t = jnp.clip(t, 0.0, 1.0)[:, None]
        return p + t * (q - p)

    i_ab = isect(a, b)
    i_bc = isect(b, c)
    i_ca = isect(c, a)

    # Candidate outputs per case.
    tri_all_1 = jnp.stack([a, b, c], axis=1)
    tri_one_1 = jnp.stack([a, i_ab, i_ca], axis=1)
    tri_two_1 = jnp.stack([a, b, i_bc], axis=1)
    tri_two_2 = jnp.stack([a, i_bc, i_ca], axis=1)

    out1 = jnp.where((n_in == 3)[:, None, None], tri_all_1,
                     jnp.where((n_in == 2)[:, None, None], tri_two_1,
                               tri_one_1))
    out2 = tri_two_2
    valid1 = n_in >= 1
    valid2 = n_in == 2
    out_verts = jnp.concatenate([out1, out2], axis=0)
    out_valid = jnp.concatenate([valid1, valid2], axis=0)
    src = jnp.concatenate([rows, rows]).astype(jnp.int32)
    return out_verts, out_valid, src


def triangles_from_mesh(vertices, faces, camera, colors,
                        face_normal=None) -> ScreenPrimitives:
    """World-space triangles -> oriented screen edge functions + 1/z.

    Triangles are clipped against the near plane (each input face emits up
    to two clipped triangles — the reference's huge ground rectangle,
    traj_ball_renderer.py:58-65, always wraps behind the camera), then
    culled against the far plane and the screen bbox.

    ``face_normal``: optional (3,) world-space unit normal shared by
    EVERY face (planar meshes: the ground quad).  Per-face cross
    products of separately-rounded camera-space vertices differ in the
    last ulp between coplanar faces, which breaks per-kind-constant
    shading certificates (shading.shade.derive_three_tone); the shared
    normal is transformed once, so all faces carry bit-identical
    normals.
    """
    wx, wy, wz = apply_world_to_camera(
        vertices, camera.world_to_camera_matrix())
    cam_pts = jnp.stack([wx, wy, wz], axis=1)  # (V, 3)
    f0 = jnp.asarray(faces, jnp.int32)
    cam_tris = cam_pts[f0]  # (F, 3, 3)

    clipped, cvalid, src = _near_clip_triangles(cam_tris, camera.near)

    x = clipped[..., 0]  # (2F, 3)
    y = clipped[..., 1]
    z = clipped[..., 2]
    focal = camera.width / (2.0 * camera.tan_half_fov_x)
    safe_z = jnp.where(z <= 0, 1.0, z)
    inv_z = 1.0 / safe_z
    px = camera.width * 0.5 + focal * x * inv_z
    py = camera.height * 0.5 - focal * y * inv_z
    vvalid = (z > 0) & (z < camera.far)

    vx = [px[:, k] for k in range(3)]
    vy = [py[:, k] for k in range(3)]
    viz = [inv_z[:, k] for k in range(3)]

    # Signed area (x2 the geometric one): cross(v1-v0, v2-v0).
    area = (vx[1] - vx[0]) * (vy[2] - vy[0]) - (vy[1] - vy[0]) * (vx[2] - vx[0])
    sign = jnp.where(area >= 0, 1.0, -1.0)
    abs_area = jnp.abs(area)
    degenerate = abs_area == 0
    inv_area = 1.0 / jnp.where(degenerate, 1.0, abs_area)

    # Edge i is opposite vertex i: e0 from (v1 -> v2), e1 from (v2 -> v0),
    # e2 from (v0 -> v1); orientation folded in so inside means e_i >= 0.
    cols = []
    order = [(1, 2), (2, 0), (0, 1)]
    for a, b in order:
        ex = sign * (vx[b] - vx[a])
        ey = sign * (vy[b] - vy[a])
        c = ey * vx[a] - ex * vy[a]
        cols += [ex, ey, c]
    cols += [viz[k] * inv_area for k in range(3)]
    params = _pad_params(cols)

    tvalid = cvalid & jnp.all(vvalid, axis=1) & ~degenerate
    xs = jnp.stack(vx, axis=1)
    ys = jnp.stack(vy, axis=1)
    bbox = jnp.stack(
        [xs.min(axis=1), xs.max(axis=1), ys.min(axis=1), ys.max(axis=1)], axis=1
    )
    tvalid &= (bbox[:, 1] >= 0) & (bbox[:, 0] <= camera.width)
    tvalid &= (bbox[:, 3] >= 0) & (bbox[:, 2] <= camera.height)
    m = src.shape[0]

    # Camera-space face normal of the SOURCE face, flipped toward the
    # camera (for shading); clipping does not change the plane.
    v0 = cam_tris[:, 0]
    if face_normal is not None:
        # One shared plane normal, rotated once -> bit-identical rows.
        wm = camera.world_to_camera_matrix()
        nw = jnp.asarray(face_normal, jnp.float32)
        ncam = jnp.stack([wm[0, 0] * nw[0] + wm[0, 1] * nw[1]
                          + wm[0, 2] * nw[2],
                          wm[1, 0] * nw[0] + wm[1, 1] * nw[1]
                          + wm[1, 2] * nw[2],
                          wm[2, 0] * nw[0] + wm[2, 1] * nw[1]
                          + wm[2, 2] * nw[2]])
        nrm = jnp.broadcast_to(ncam[None, :], (f0.shape[0], 3))
    else:
        v1, v2 = cam_tris[:, 1], cam_tris[:, 2]
        nrm = jnp.cross(v1 - v0, v2 - v0)
        nlen = jnp.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / jnp.where(nlen > 0, nlen, 1.0)
    # Camera looks along +z from the origin: flip so the normal opposes
    # the view ray to the face.  (Coplanar faces: dot(n, v0) is the
    # shared plane offset, so the sign — and with a shared face_normal
    # the whole row — is identical across faces.)
    flip = jnp.sign(jnp.sum(nrm * v0, axis=1, keepdims=True))
    nrm = -nrm * jnp.where(flip == 0, 1.0, flip)
    nrm = nrm[src]

    color = _broadcast_color(colors, f0.shape[0])[src]
    return ScreenPrimitives(
        kind=jnp.full((m,), KIND_TRIANGLE, jnp.int32),
        params=params,
        color=color,
        valid=tvalid,
        bbox=bbox,
        normal=nrm,
    )
