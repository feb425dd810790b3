"""Fidelity bounds for the GEOMETRY-changing trail knob.

``trail_segments`` is the one render knob that changes geometry:
rendering a velocity trail as fewer,
longer capsules keeps the union silhouette (straight, constant radius)
but interpolates depth/radius linearly in a coarser screen parameter, so
sub-pixel coverage and depth shift slightly vs the reference's 21-point
polyline (run/pipeline.build_primitives docstring; reference:
traj_ball_renderer.py:309-333 renders 20 segments).

This module MEASURES that shift as a winner-flip rate, so a segment
count is certified against a committed bound before production uses it
(benchmarks/fidelity_trail.py writes the certificate).  A "flip" is a pixel whose winning SURFACE changed — empty vs
ground vs (kind, owning point) — between the candidate segment count and
the full reference polyline.  Same-surface sub-pixel depth shifts are
not flips: they do not change the image (trail shading is flat color;
disc/ground parts are identical arrays in both renders).
"""

from __future__ import annotations

import numpy as np

#: A scene whose default-8 BASELINE already differs from the 21-point
#: polyline by more than the absolute bound (denser trails diverge more
#: at EVERY count) may take a segment count whose marginal flip rate over
#: the default is at most this; anything more is refused.
GEOMETRY_REL_MARGIN = 2e-3


def owner_map(layout, n_prims: int) -> np.ndarray:
    """(kind, owner) code per prim id from a build_primitives layout.

    Codes: furniture part k -> -(k + 1); per-point parts -> part_index *
    2**32 + point_index.  Codes are comparable across renders with
    DIFFERENT trail segment counts because part order is fixed (ground,
    splats, trails) and owners are row-major in point index.
    """
    codes = np.empty(n_prims, np.int64)
    row = 0
    for k, (rows, c) in enumerate(layout):
        if isinstance(c, tuple):  # ("split2", faces_per_point) mesh LOD
            c = c[1]
        if c == 0:
            codes[row:row + rows] = -(k + 1)
        else:
            codes[row:row + rows] = (np.int64(k) << 32) + (
                np.arange(rows, dtype=np.int64) // c)
        row += rows
    assert row == n_prims, f"layout covers {row} of {n_prims} prims"
    return codes


def surface_image(index_img: np.ndarray, layout) -> np.ndarray:
    """Map a winner-index image to a surface-code image (-1 = empty)."""
    n_prims = sum(rows for rows, _ in layout)
    codes = owner_map(layout, n_prims)
    out = np.full(index_img.shape, np.int64(-1))
    hit = index_img >= 0
    if codes.size:
        out[hit] = codes[index_img[hit]]
    return out


def part_image(index_img: np.ndarray, layout) -> np.ndarray:
    """Map a winner-index image to a PART-index image (-1 = empty).

    Unlike ``surface_image`` codes (where furniture part 0 and empty
    both map to -1 under the >> 32 fold), parts are distinct here:
    ground/furniture keep their layout index.  Used by the flip
    DECOMPOSITION to attribute a flipped pixel to the pair of winning
    parts it moved between.
    """
    bounds = np.cumsum([0] + [rows for rows, _ in layout])
    out = np.full(index_img.shape, -1, np.int32)
    hit = index_img >= 0
    out[hit] = (np.searchsorted(bounds, index_img[hit], side="right")
                .astype(np.int32) - 1)
    return out


def trail_flip_decomposition(segments, n_points: int = 1500,
                             frames=(60, 120, 199), width: int = 480,
                             height: int = 270,
                             preset_name: str = "traj_vel",
                             reference_segments: int = 20,
                             seed: int = 0) -> dict:
    """Attribute the winner-flip rate of ``segments`` vs the reference
    polyline to WINNING-PART transitions (VERDICT r4 weak #4: explain
    traj_vel's ~0.9% baseline discrepancy before leaning on the anchor
    relaxation).

    Returns ``{"parts": [names...], "denom": trail_pixels,
    "transitions": {"a->b": rate, ...}, "trail_owner_swap": rate,
    "trail_rate": total}`` where each rate is flips of that class /
    trail pixels (the same denominator as ``trail_segments_flip_rate``'s
    ``trail_rate``), maxed over frames jointly (the worst frame's whole
    decomposition).  ``trail_owner_swap`` is the trail->trail same-part
    subset — invisible in the flat-color render; the per-part
    transitions are the pixels a viewer could notice.
    """
    import jax.numpy as jnp

    from pointcloud_render.configs import PRESETS
    from pointcloud_render.raster.render import RasterConfig, rasterize
    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.scene.camera import (
        TARGETS,
        TOTAL_FRAMES,
        Camera,
        camera_origin_jax,
    )

    preset = PRESETS[preset_name]
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.uniform(-0.5, 0.5, (n_points, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(0, 2, (n_points, 3)), jnp.float32)
    config = RasterConfig(backend="tiled", max_per_tile=4096)

    if preset.splat == "droplet":
        names = ["ground", "head", "tail", "trail"]
    else:
        names = ["ground", "disc", "trail"]

    worst = None
    for fi in frames:
        cam = Camera(
            origin=camera_origin_jax(preset.camera_preset, jnp.int32(fi),
                                     TOTAL_FRAMES),
            target=np.asarray(TARGETS[preset.camera_preset], np.float32),
            width=width, height=height)
        surfs, part_imgs, trail_hits = [], [], []
        for segs in (segments, reference_segments):
            soup, layout = build_primitives(
                preset, cam, pos, vel, jnp.int32(fi),
                trail_segments=segs, return_layout=True)
            _, idx = rasterize(soup, width, height, config)
            idx = np.asarray(idx)
            surfs.append(surface_image(idx, layout))
            pimg = part_image(idx, layout)
            part_imgs.append(pimg)
            trail_hits.append(pimg == len(layout) - 1)
        flips = surfs[0] != surfs[1]
        denom = int((trail_hits[0] | trail_hits[1]).sum())
        if not denom:
            continue
        rec = {"frame": int(fi), "parts": names, "denom": denom,
               "trail_rate": float(flips.sum()) / denom,
               "transitions": {}, "trail_owner_swap": 0.0}
        pa, pb = part_imgs[0][flips], part_imgs[1][flips]
        for a in np.unique(pa):
            for b in np.unique(pb[pa == a]):
                cnt = int(((pa == a) & (pb == b)).sum())
                if not cnt:
                    continue
                an = names[a] if a >= 0 else "empty"
                bn = names[b] if b >= 0 else "empty"
                rate = cnt / denom
                if an == bn == "trail":
                    rec["trail_owner_swap"] = rate
                else:
                    rec["transitions"][f"{an}->{bn}"] = rate
        if worst is None or rec["trail_rate"] > worst["trail_rate"]:
            worst = rec
    return worst or {"parts": names, "denom": 0, "trail_rate": 0.0,
                     "transitions": {}, "trail_owner_swap": 0.0}


def trail_segments_flip_rate(segments: int, n_points: int = 1500,
                             frames=(60, 120, 199), width: int = 480,
                             height: int = 270, preset_name: str = "traj_ball",
                             reference_segments: int = 20,
                             seed: int = 0) -> dict:
    """Winner-flip rates of ``segments`` vs the full reference polyline.

    Renders the preset's trail scene at ``segments`` and at
    ``reference_segments`` (= the reference's 20,
    traj_ball_renderer.py:315) with the exact tiled backend and returns
    the max over ``frames`` of
      * ``frame_rate``  — flipped pixels / ALL pixels (density-bound:
        scales with how much of the film trails cover), and
      * ``trail_rate``  — flipped pixels / pixels a trail wins in either
        render (the per-trail-pixel flip probability; grows with trail
        OVERLAP density, so certify at a denser scene than CI runs), and
      * ``kind_rate``   — the VISIBLE subset of trail_rate: pixels whose
        winning PART changed (trail <-> disc/ground/empty).  Same-part
        owner swaps (trail A beats trail B) render the identical flat
        trail color, so they are invisible; kind flips are the pixels a
        viewer could in principle notice.
    A flip is a changed surface code (empty / ground / (kind, point));
    same-surface sub-pixel depth shifts are not flips.  Scene statistics
    (radius, trail schedule, dolly trajectory) are the production
    preset's; only the point count and film are scaled down so the
    measurement runs on CPU in CI time.
    """
    import jax.numpy as jnp

    from pointcloud_render.configs import PRESETS
    from pointcloud_render.raster.render import RasterConfig, rasterize
    from pointcloud_render.run.pipeline import build_primitives
    from pointcloud_render.scene.camera import (
        TARGETS,
        TOTAL_FRAMES,
        Camera,
        camera_origin_jax,
    )

    preset = PRESETS[preset_name]
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.uniform(-0.5, 0.5, (n_points, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(0, 2, (n_points, 3)), jnp.float32)
    config = RasterConfig(backend="tiled", max_per_tile=4096)

    worst_frame, worst_trail, worst_kind = 0.0, 0.0, 0.0
    for fi in frames:
        cam = Camera(
            origin=camera_origin_jax(preset.camera_preset, jnp.int32(fi),
                                     TOTAL_FRAMES),
            target=np.asarray(TARGETS[preset.camera_preset], np.float32),
            width=width, height=height)
        imgs, trail_hits = [], []
        for segs in (segments, reference_segments):
            soup, layout = build_primitives(
                preset, cam, pos, vel, jnp.int32(fi),
                trail_segments=segs, return_layout=True)
            _, idx = rasterize(soup, width, height, config)
            img = surface_image(np.asarray(idx), layout)
            imgs.append(img)
            # Trail parts come last in the layout (ground, splats,
            # trails) — their surface codes carry the highest part index.
            trail_part = len(layout) - 1
            trail_hits.append((img >> 32) == trail_part)
        flips = imgs[0] != imgs[1]
        # Part code: high 32 bits for per-point parts, the negative
        # furniture/empty code itself otherwise (>> 32 keeps them
        # distinct: arithmetic shift maps -(k+1) to -1 for small k, so
        # fold the sign in explicitly).
        parts = [np.where(img >= 0, img >> 32, img) for img in imgs]
        kind_flips = parts[0] != parts[1]
        denom = (trail_hits[0] | trail_hits[1]).sum()
        worst_frame = max(worst_frame, float(np.mean(flips)))
        if denom:
            worst_trail = max(worst_trail,
                              float(flips.sum()) / float(denom))
            worst_kind = max(worst_kind,
                             float(kind_flips.sum()) / float(denom))
    return {"segments": segments, "frame_rate": worst_frame,
            "trail_rate": worst_trail, "kind_rate": worst_kind}
