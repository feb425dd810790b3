"""Shadow-map look pass: one light-view depth raster + per-pixel test.

The reference's visual signature includes soft shadows cast by the
points/droplets onto the roughplastic ground from the 8x8 area emitter
at (0, 0, 15) (/root/reference/traj_ball_renderer.py:67-75 emitter;
:58-65 ground).  A rasterizer cannot path-trace them; this module adds
the rasterizer's approximation: render the SAME primitive soup from the
light's viewpoint (one extra raster through the existing backends —
cheap, fully on-device), then at shade time re-project every hit pixel
into the light view and darken the diffuse term where a nearer occluder
wins there.

OFF BY DEFAULT (ShadingConfig.shadows).  The ss=1 depth/index contract
is untouched — shadows only scale the rgb's diffuse term; determinism
is preserved (same two rasters, no sampling).

Coordinates: screen -> camera uses the projection inverse (px = W/2 +
focal*x/z, py = H/2 - focal*y/z — primitives.py conventions); camera ->
world is the transpose of the look_at rotation plus the origin
(scene/camera.py world_to_camera_matrix).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from pointcloud_render.scene.camera import Camera

# Reference emitter pose (traj_ball_renderer.py:67-75): an 8x8 rectangle
# at z = 15 pointing down.
LIGHT_POS = (0.0, 0.0, 15.0)
DEFAULT_SHADOW_SIZE = 1024
DEFAULT_BIAS = 0.05


def light_camera(extent: float = 2.5, size: int = DEFAULT_SHADOW_SIZE,
                 light_pos=LIGHT_POS) -> Camera:
    """A perspective camera at the emitter looking straight down,
    sized so the z=0 plane's +-extent square fills the film (the
    normalized clouds live in [-1, 1]^3; ground at z ~= -0.5)."""
    h = float(light_pos[2])
    fov = 2.0 * math.degrees(math.atan(extent / h))
    return Camera(
        origin=jnp.asarray(light_pos, jnp.float32),
        target=jnp.asarray([light_pos[0], light_pos[1], 0.0], jnp.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32),
        fov_x_degrees=fov, width=size, height=size)


# Deterministic 12-tap poisson disk (unit radius; a fixed table, no
# sampling at trace or run time — determinism tests pin identical rgb
# across calls).  Values: classic Vogel spiral, radius sqrt((k+0.5)/N).
_POISSON_12 = np.array(
    [[math.sqrt((k + 0.5) / 12.0) * math.cos(k * 2.399963),
      math.sqrt((k + 0.5) / 12.0) * math.sin(k * 2.399963)]
     for k in range(12)], np.float32)


def shadow_factor(camera, depth, index, light_cam, shadow_depth,
                  bias: float = DEFAULT_BIAS, min_light: float = 0.35,
                  taps: int = 12, emitter_half: float = 4.0,
                  max_radius_px: float = 24.0):
    """(H, W) diffuse scale in [min_light, 1].

    For every hit pixel: reconstruct the world position from the main
    camera's depth buffer, project it into the light view, and compare
    against the light-view z-buffer.

    ``taps > 0`` runs PCSS-lite penumbra (the 8x8 area emitter's soft
    shadows, traj_ball_renderer.py:67-75): a fixed poisson blocker
    search estimates the average occluder depth, the penumbra width
    w = emitter_half * (d_receiver - d_blocker) / d_blocker projects to
    light-view texels, and the SAME poisson disk scaled to that radius
    averages the depth test — contact shadows stay sharp, distant
    blockers go soft, all from one static tap table (deterministic, no
    sampling).  ``taps == 0`` keeps the legacy fixed 2x2 PCF.
    """
    h, w = depth.shape
    hit = index >= 0
    focal = w / (2.0 * camera.tan_half_fov_x)
    qx = (np.arange(w, dtype=np.float32) + 0.5)[None, :]
    qy = (np.arange(h, dtype=np.float32) + 0.5)[:, None]
    z = jnp.where(hit, depth, 1.0)
    cx = (qx - w * 0.5) * z / focal
    cy = -(qy - h * 0.5) * z / focal

    m = camera.world_to_camera_matrix()  # cam = R @ world + t
    rot = m[:, :3]
    t = m[:, 3]
    dxc = cx - t[0]
    dyc = cy - t[1]
    dzc = z - t[2]
    wx = rot[0, 0] * dxc + rot[1, 0] * dyc + rot[2, 0] * dzc
    wy = rot[0, 1] * dxc + rot[1, 1] * dyc + rot[2, 1] * dzc
    wz = rot[0, 2] * dxc + rot[1, 2] * dyc + rot[2, 2] * dzc

    ml = light_cam.world_to_camera_matrix()
    lx = ml[0, 0] * wx + ml[0, 1] * wy + ml[0, 2] * wz + ml[0, 3]
    ly = ml[1, 0] * wx + ml[1, 1] * wy + ml[1, 2] * wz + ml[1, 3]
    lz = ml[2, 0] * wx + ml[2, 1] * wy + ml[2, 2] * wz + ml[2, 3]

    sw, sh = light_cam.width, light_cam.height
    lfocal = sw / (2.0 * light_cam.tan_half_fov_x)
    safe_lz = jnp.where(lz > 0, lz, 1.0)
    lpx = sw * 0.5 + lfocal * lx / safe_lz
    lpy = sh * 0.5 - lfocal * ly / safe_lz
    inside = (lz > 0) & (lpx >= 0) & (lpx < sw) & (lpy >= 0) & (lpy < sh)

    sd = jnp.where(jnp.isfinite(shadow_depth), shadow_depth, jnp.inf)
    if taps <= 0:
        # Legacy 2x2 PCF: average the binary test over the texel
        # neighborhood.
        ix0 = jnp.clip(jnp.floor(lpx - 0.5).astype(jnp.int32), 0, sw - 1)
        iy0 = jnp.clip(jnp.floor(lpy - 0.5).astype(jnp.int32), 0, sh - 1)
        vis = jnp.zeros_like(z)
        for dy in (0, 1):
            for dx in (0, 1):
                ix = jnp.minimum(ix0 + dx, sw - 1)
                iy = jnp.minimum(iy0 + dy, sh - 1)
                occ = sd[iy, ix]
                vis = vis + jnp.where(lz <= occ + bias, 1.0, 0.0)
        vis = vis * 0.25
    else:
        disk = _POISSON_12[
            np.linspace(0, len(_POISSON_12) - 1, taps).astype(np.int32)]

        def gather(radius_tex, k):
            ix = jnp.clip((lpx + disk[k, 0] * radius_tex)
                          .astype(jnp.int32), 0, sw - 1)
            iy = jnp.clip((lpy + disk[k, 1] * radius_tex)
                          .astype(jnp.int32), 0, sh - 1)
            return sd[iy, ix]

        # Blocker search at the emitter's full projected footprint: the
        # average occluder depth among taps that actually occlude.
        search_r = np.float32(max_radius_px)
        safe = jnp.maximum(lz, 1e-3)
        occ_sum = jnp.zeros_like(z)
        occ_cnt = jnp.zeros_like(z)
        for k in range(taps):
            occ = gather(search_r, k)
            is_b = (occ + bias < lz).astype(jnp.float32)
            occ_sum = occ_sum + jnp.where(is_b > 0, occ, 0.0)
            occ_cnt = occ_cnt + is_b
        d_b = occ_sum / jnp.maximum(occ_cnt, 1.0)
        # Penumbra width in world units at the receiver, projected to
        # light-view texels; fully-lit pixels (no blockers) keep a
        # minimal radius and pass every tap anyway.
        pen = emitter_half * (safe - d_b) / jnp.maximum(d_b, 1e-3)
        radius = jnp.where(occ_cnt > 0,
                           jnp.clip(lfocal * pen / safe, 1.0,
                                    max_radius_px),
                           1.0)
        vis = jnp.zeros_like(z)
        for k in range(taps):
            occ = gather(radius, k)
            vis = vis + jnp.where(lz <= occ + bias, 1.0, 0.0)
        vis = vis / np.float32(taps)
    factor = min_light + (1.0 - min_light) * vis
    return jnp.where(hit & inside, factor, 1.0)


def render_shadow_depth(prims_light, light_cam, config=None):
    """Light-view z-buffer of the soup ((S, S) f32, +inf empty)."""
    from pointcloud_render.raster.render import RasterConfig, rasterize

    config = config or RasterConfig(backend="tiled", max_per_tile=1024)
    depth, _ = rasterize(prims_light, light_cam.width, light_cam.height,
                         config)
    return depth
