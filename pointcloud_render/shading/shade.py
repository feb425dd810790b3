"""Screen-space shading pass: id/depth buffers -> RGB.

The reference gets its look from a Mitsuba path tracer (area light at
(0, 0, 15) with radiance (4,4,4), white roughplastic ground, diffuse gray
points — reference: traj_ball_renderer.py:30-77).  A rasterizer cannot
reproduce global illumination; this pass approximates the look with:

* sphere-normal Lambert shading for disc splats (normals reconstructed
  from the pixel's offset inside the disc);
* face-normal Lambert for triangles (ground plane, droplet instances);
* unshaded emissive-style color for capsules (the bright green trails,
  reference trail color (0.2, 1.0, 0.4) with 1.5x specular boost,
  traj_ball_renderer.py:179-182);
* a single directional key light pointing down (-z world), matching the
  reference's overhead emitter, plus an ambient floor.

Geometry/depth stay exact; the shading is explicitly "look parity",
documented as such (SURVEY.md §6 scope note).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_render.raster.primitives import (
    KIND_CAPSULE,
    KIND_DISC,
    KIND_TRIANGLE,
)


@dataclasses.dataclass(frozen=True)
class ShadingConfig:
    """Plain hashable config (NOT a pytree: it is passed through jit static
    arguments, and pytree-registered statics break pjit's fast path)."""

    mode: str = "lambert"
    ambient: float = 0.3
    diffuse: float = 0.7
    # Reference trail specular: clip(1.5 * color, 0, 1)
    # (traj_ball_renderer.py:179-182); trail pixels show
    # clip(trail_boost * color) exactly (the final clip applies it).
    trail_boost: float = 1.5
    background: tuple = (1.0, 1.0, 1.0)
    # Shadow-map look pass (shading/shadow.py) — OFF by default; the
    # ss=1 depth/index contract is untouched (shadows only scale the
    # diffuse term).  Approximates the reference's area-emitter shadows
    # (traj_ball_renderer.py:67-75).
    shadows: bool = False
    shadow_size: int = 1024
    shadow_bias: float = 0.05
    shadow_min_light: float = 0.35
    # Penumbra (PCSS-lite, shading/shadow.py): poisson PCF whose tap
    # radius scales with the blocker gap and the reference's 8x8 area
    # emitter (half-extent 4 world units, traj_ball_renderer.py:67-75).
    # 0 taps = the legacy fixed 2x2 PCF.
    shadow_taps: int = 12
    shadow_emitter_half: float = 4.0
    shadow_max_radius_px: float = 24.0
    # GGX specular lobe on triangle winners — the reference ground is
    # WHITE ROUGHPLASTIC (alpha=0.1, IOR 1.46 -> F0 ~= 0.0349,
    # traj_ball_renderer.py:30-35,58-65).  ground_spec scales the lobe;
    # 0 (default) keeps the pure-Lambert look and the fused kernels'
    # bit-pinned output.  rgb-only: depth/index are never touched.
    ground_spec: float = 0.0
    ground_alpha: float = 0.1
    ground_f0: float = 0.0349
    # Indirect-illumination fill approximating the reference's
    # path-traced bounce light (path integrator, unlimited depth —
    # traj_ball_renderer.py:9-13): the WHITE ground under the cloud
    # re-radiates onto downward-facing splat surfaces, so reference
    # splat undersides are never black.  ``gi`` scales a ground-bounce
    # term gi * max(-n.up, 0) * ground_albedo added to the disc-winner
    # light (up == the overhead key direction, so -n.l is the
    # downward-facing cosine).  0 (default) keeps the bit-pinned
    # pure-Lambert look.  rgb-only: depth/index are never touched.
    gi: float = 0.0
    gi_albedo: tuple = (1.0, 1.0, 1.0)  # reference ground: white


def shade_winner_attrs(px, py, rflag, rgb, hit, camera,
                       config: ShadingConfig = ShadingConfig()):
    """Shade WINNER-ATTRIBUTE buffers (no primitive soup needed).

    The streamed/sharded paths carry per-pixel winner attributes through
    their merges instead of re-gathering from a soup; this is the same
    sphere-normal Lambert as :func:`shade_framebuffer`'s disc branch,
    evaluated from those buffers.  ``rflag``: projected disc radius in
    px (> 0); < 0 for capsule winners, which take the flat
    ``trail_boost`` (reference trail specular, traj_ball_renderer.py:
    179-182); == 0 for PRE-LIT winners (triangles: the caller bakes
    ``color * (ambient + diffuse*max(n.l, 0))`` into rgb at table
    build — same formula as shade_framebuffer's triangle branch, so
    the result stays bit-identical).  One shader for every path — keep
    formulas in lockstep with shade_framebuffer.
    """
    h, w = hit.shape
    if config.mode == "flat":
        out = rgb
    else:
        m = camera.world_to_camera_matrix()
        l_cam = jnp.stack([m[0, 2], m[1, 2], m[2, 2]])
        qx = (np.arange(w, dtype=np.float32) + 0.5)[None, :]
        qy = (np.arange(h, dtype=np.float32) + 0.5)[:, None]
        inv_r = 1.0 / jnp.maximum(rflag, 1e-6)
        u = (qx - px) * inv_r
        v = -(qy - py) * inv_r
        w2 = jnp.maximum(0.0, 1.0 - u * u - v * v)
        nz = -jnp.sqrt(w2)
        ndotl = u * l_cam[0] + v * l_cam[1] + nz * l_cam[2]
        lit = config.ambient + config.diffuse * jnp.maximum(ndotl, 0.0)
        lit = jnp.where(rflag > 0, lit,
                        jnp.where(rflag < 0, config.trail_boost, 1.0))
        out = rgb * lit[..., None]
        if config.gi > 0.0:
            # Ground-bounce fill on disc winners (rflag > 0) — lockstep
            # with shade_framebuffer's disc branch.
            bounce = config.gi * jnp.maximum(-ndotl, 0.0)
            bounce = jnp.where(rflag > 0, bounce, 0.0)
            albedo = np.asarray(config.gi_albedo, np.float32)
            out = out + rgb * bounce[..., None] * albedo
    bg = np.asarray(config.background, np.float32)
    return jnp.clip(jnp.where(hit[..., None], out, bg), 0.0, 1.0)


def _ggx_specular(qx, qy, w, h, camera, attr, l_cam, config):
    """Per-pixel GGX (Trowbridge-Reitz) specular for triangle winners.

    Cook-Torrance with Smith G and Schlick F at the reference ground's
    roughplastic parameters (alpha = config.ground_alpha, F0 =
    config.ground_f0).  View = the pixel's camera-space ray (depth-free:
    direction only), light = ``l_cam`` (the overhead key, unit), normal
    = the triangle's camera-space face normal (attr lanes 7:9).  Returns
    ``(spec, f_view)``: the scalar lobe and the view-angle Fresnel that
    scales the substrate's transmission (both * config.ground_spec);
    rgb-only — callers must not touch depth/index with them.
    """
    focal = w / (2.0 * camera.tan_half_fov_x)
    # Camera-space view direction: pixel ray is (x/z, y/z, 1) with
    # x/z = (qx - W/2)/focal, y/z = -(qy - H/2)/focal; V points from the
    # surface BACK to the eye = -normalize(ray).
    rx = (qx - w * 0.5) / focal
    ry = -(qy - h * 0.5) / focal
    inv_n = 1.0 / jnp.sqrt(rx * rx + ry * ry + 1.0)
    vx, vy, vz = -rx * inv_n, -ry * inv_n, -inv_n
    # Half vector between V and L (both unit).
    hx = vx + l_cam[0]
    hy = vy + l_cam[1]
    hz = vz + l_cam[2]
    inv_h = 1.0 / jnp.maximum(jnp.sqrt(hx * hx + hy * hy + hz * hz), 1e-6)
    hx, hy, hz = hx * inv_h, hy * inv_h, hz * inv_h
    nx, ny, nz = attr[..., 7], attr[..., 8], attr[..., 9]
    ndoth = jnp.maximum(nx * hx + ny * hy + nz * hz, 0.0)
    ndotv = jnp.maximum(nx * vx + ny * vy + nz * vz, 1e-4)
    ndotl = jnp.maximum(nx * l_cam[0] + ny * l_cam[1] + nz * l_cam[2], 0.0)
    vdoth = jnp.maximum(vx * hx + vy * hy + vz * hz, 0.0)
    a2 = config.ground_alpha * config.ground_alpha
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    d_ggx = a2 / (np.float32(np.pi) * denom * denom)
    # Smith height-correlated visibility (the G/(4 n.v n.l) quotient).
    lv = ndotl * jnp.sqrt(ndotv * ndotv * (1.0 - a2) + a2)
    ll = ndotv * jnp.sqrt(ndotl * ndotl * (1.0 - a2) + a2)
    vis = 0.5 / jnp.maximum(lv + ll, 1e-6)
    f = config.ground_f0 + (1.0 - config.ground_f0) * (1.0 - vdoth) ** 5
    spec = config.ground_spec * d_ggx * vis * f * ndotl
    # Energy split of the plastic coat: the diffuse substrate only sees
    # what the coat transmits (1 - F).  This is what makes the lobe
    # VISIBLE on the reference's white ground — a fully-lit Lambert
    # ground already clips at 1.0, so without the split the specular
    # would vanish into the clip; with it the ground gains the
    # path-traced look's grazing-angle falloff.  Fresnel at the VIEW
    # angle for the transmitted substrate light (Schlick).
    f_view = (config.ground_f0
              + (1.0 - config.ground_f0) * (1.0 - ndotv) ** 5)
    return spec, config.ground_spec * f_view


def shade_framebuffer(prims, camera, depth, index, config: ShadingConfig,
                      shadow=None):
    """Resolve winning primitives to shaded RGB.

    Args:
      prims: the ScreenPrimitives soup that was rasterized.
      camera: the Camera (for the light direction in camera space).
      depth: (H, W) float32; index: (H, W) int32 (-1 = empty).
      shadow: optional (H, W) diffuse scale in [0, 1]
        (shading.shadow.shadow_factor) — scales ONLY the diffuse term.
    Returns:
      rgb: (H, W, 3) float32 in [0, 1].
    """
    h, w = depth.shape
    hit = index >= 0
    safe_idx = jnp.maximum(index, 0)

    if config.mode == "flat":
        rgb = prims.color[safe_idx]
    else:
        # ONE combined per-pixel gather of a (P, 10) attribute table
        # instead of four separate 2M-pixel gathers.
        table = jnp.concatenate([
            prims.kind.astype(jnp.float32)[:, None],  # 0: kind
            prims.params[:, 0:2],  # 1,2: px, py
            jnp.maximum(prims.params[:, 3:4], 1e-6),  # 3: r
            prims.color,  # 4,5,6
            prims.normal,  # 7,8,9
        ], axis=1)
        attr = table[safe_idx]  # (H, W, 10)
        kind = attr[..., 0]
        color = attr[..., 4:7]

        # Key light: straight down in world (surface -> light is +z world),
        # expressed in camera space.
        m = camera.world_to_camera_matrix()
        l_cam = jnp.stack([m[0, 2], m[1, 2], m[2, 2]])  # R @ (0,0,1)

        qx = (np.arange(w, dtype=np.float32) + 0.5)[None, :]
        qy = (np.arange(h, dtype=np.float32) + 0.5)[:, None]

        # Disc sphere normals from in-disc offset (camera space, +y up in
        # camera corresponds to -py direction on screen).
        inv_r = 1.0 / attr[..., 3]
        u = (qx - attr[..., 1]) * inv_r
        v = -(qy - attr[..., 2]) * inv_r
        w2 = jnp.maximum(0.0, 1.0 - u * u - v * v)
        nz = -jnp.sqrt(w2)
        ndotl_disc = u * l_cam[0] + v * l_cam[1] + nz * l_cam[2]

        # Triangle face normals were stored in camera space at build time.
        ndotl_tri = (attr[..., 7] * l_cam[0] + attr[..., 8] * l_cam[1]
                     + attr[..., 9] * l_cam[2])

        ndotl = jnp.where(kind == KIND_DISC, ndotl_disc, ndotl_tri)
        diff = config.diffuse * jnp.maximum(ndotl, 0.0)
        if shadow is not None:
            diff = diff * shadow
        lit = config.ambient + diff
        lit = jnp.where(kind == KIND_CAPSULE, config.trail_boost, lit)
        rgb = color * lit[..., None]
        if config.gi > 0.0:
            # Ground-bounce fill on disc winners: downward-facing
            # surface area sees the white ground's re-radiated light
            # (keep in lockstep with shade_winner_attrs).
            bounce = config.gi * jnp.maximum(-ndotl, 0.0)
            bounce = jnp.where(kind == KIND_DISC, bounce, 0.0)
            albedo = np.asarray(config.gi_albedo, np.float32)
            rgb = rgb + color * bounce[..., None] * albedo
        if config.ground_spec > 0.0:
            # GGX specular lobe on triangle winners — the reference's
            # WHITE ROUGHPLASTIC ground (alpha=0.1, IOR 1.46,
            # traj_ball_renderer.py:30-35,58-65).  View vector from the
            # pixel ray, light = the same overhead key as the diffuse
            # term; white lobe added, substrate scaled by the coat's
            # transmission (see _ggx_specular).
            spec, f_view = _ggx_specular(qx, qy, w, h, camera, attr,
                                         l_cam, config)
            is_tri = kind == KIND_TRIANGLE
            spec = jnp.where(is_tri, spec, 0.0)
            if shadow is not None:
                spec = spec * shadow
            trans = jnp.where(is_tri, 1.0 - f_view, 1.0)
            rgb = rgb * trans[..., None] + spec[..., None]

    bg = np.asarray(config.background, np.float32)
    rgb = jnp.where(hit[..., None], rgb, bg)
    return jnp.clip(rgb, 0.0, 1.0)


def derive_three_tone(prims):
    """Representative prim ids per kind + the exactness certificate for
    :func:`shade_tones`.

    Returns ``(reps, ok)`` — ``reps`` int32[3] = (disc, capsule,
    triangle) representative ids (argmax over each kind mask; 0 and
    inert when a kind is absent) and ``ok`` a scalar bool that is True
    iff every valid prim of a kind shares its representative's color AND
    every triangle shares its representative's normal — exactly the
    precondition under which the tone shade reproduces
    :func:`shade_framebuffer` bit for bit.  Callers fall back to
    shade_framebuffer when ``ok`` is False.
    """
    reps = []
    ok = jnp.bool_(True)
    for k in (KIND_DISC, KIND_CAPSULE, KIND_TRIANGLE):
        # VALID prims only: invalid rows never render, and their color /
        # normal lanes are whatever the build left there.
        mask = (prims.kind == k) & prims.valid
        rep = jnp.argmax(mask)
        reps.append(rep)
        same = prims.color == prims.color[rep]
        ok = ok & jnp.all(jnp.where(mask[:, None], same, True))
    tri = (prims.kind == KIND_TRIANGLE) & prims.valid
    same_n = prims.normal == prims.normal[reps[2]]
    ok = ok & jnp.all(jnp.where(tri[:, None], same_n, True))
    return jnp.stack(reps).astype(jnp.int32), ok


def derive_four_tone(prims):
    """Like :func:`derive_three_tone`, for soups whose capsules carry
    TWO colors in two contiguous id runs — the droplet presets (tail
    capsules in the point color, then velocity trails in the trail
    color; run/pipeline.build_primitives emits parts in that order).

    Returns ``(vals, ok)`` — ``vals`` int32[5] = (disc_rep, capA_rep,
    capB_rep, cap_split, tri_rep) where capsules with id < cap_split
    shade from capA_rep and the rest from capB_rep.  A single-color
    capsule soup degenerates to capB == capA with the split past the
    last capsule.
    """
    n = prims.count
    ok = jnp.bool_(True)
    reps = {}
    for k in (KIND_DISC, KIND_TRIANGLE):
        mask = (prims.kind == k) & prims.valid
        rep = jnp.argmax(mask)
        reps[k] = rep
        same = prims.color == prims.color[rep]
        ok = ok & jnp.all(jnp.where(mask[:, None], same, True))
    tri = (prims.kind == KIND_TRIANGLE) & prims.valid
    same_n = prims.normal == prims.normal[reps[KIND_TRIANGLE]]
    ok = ok & jnp.all(jnp.where(tri[:, None], same_n, True))

    cap = (prims.kind == KIND_CAPSULE) & prims.valid
    cap_a = jnp.argmax(cap)  # first valid capsule (0 if none)
    c0 = prims.color[cap_a]
    differs = cap & jnp.any(prims.color != c0[None, :], axis=1)
    has_b = jnp.any(differs)
    split = jnp.where(has_b, jnp.argmax(differs), n).astype(jnp.int32)
    cap_b = jnp.where(has_b, jnp.argmax(differs), cap_a)
    ids = jnp.arange(n)
    # Run A: capsules below split share c0 (by construction of split);
    # run B: capsules at/after split must share color[cap_b].
    same_b = prims.color == prims.color[cap_b]
    ok = ok & jnp.all(jnp.where((cap & (ids >= split))[:, None],
                                same_b, True))
    return (jnp.stack([reps[KIND_DISC], cap_a, cap_b, split,
                       reps[KIND_TRIANGLE]]).astype(jnp.int32), ok)


def shade_tones(prims, camera, config: ShadingConfig, depth, index, tones):
    """Per-kind-constant shade -> (H, W, 3) rgb, lambert mode only.

    ``tones``: (disc_rep, capsule_rep, tri_rep) or the four-tone
    (disc_rep, capA_rep, capB_rep, cap_split, tri_rep) from
    derive_three_tone / derive_four_tone.  The tones are computed from
    the representative prims by shade_framebuffer's formulas, and the
    per-pixel gather narrows to 4 floats [px, py, flag, is_capsule], so
    the result equals shade_framebuffer's bit for bit whenever the
    derive certificate holds.
    """
    h, w = depth.shape
    hit = index >= 0
    safe = jnp.where(hit, index, prims.count)  # pad row: zeros
    cap_split = None
    if len(tones) == 5:
        d_rep, c_rep, c_rep2, cap_split, t_rep = (int(r) for r in tones)
    else:
        d_rep, c_rep, t_rep = (int(r) for r in tones)
    m = camera.world_to_camera_matrix()
    l_cam = jnp.stack([m[0, 2], m[1, 2], m[2, 2]])
    uc = prims.color[d_rep]  # raw disc color; lit applied per pixel
    ut = jnp.clip(prims.color[c_rep] * jnp.float32(config.trail_boost),
                  0.0, 1.0)
    ndotl_g = (prims.normal[t_rep, 0] * l_cam[0]
               + prims.normal[t_rep, 1] * l_cam[1]
               + prims.normal[t_rep, 2] * l_cam[2])
    lit_g = config.ambient + config.diffuse * jnp.maximum(ndotl_g, 0.0)
    ug = jnp.clip(prims.color[t_rep] * lit_g, 0.0, 1.0)
    # flag: 1/max(r, 1e-6) for discs (shade_framebuffer's inv_r), -1
    # for the preshaded kinds.
    is_disc = prims.kind == KIND_DISC
    inv_r = 1.0 / jnp.maximum(prims.params[:, 3], 1e-6)
    flag = jnp.where(is_disc, inv_r, -1.0)
    is_cap = (prims.kind == KIND_CAPSULE).astype(jnp.float32)
    table4 = jnp.pad(jnp.concatenate([
        prims.params[:, 0:2], flag[:, None], is_cap[:, None],
    ], axis=1), ((0, 1), (0, 0)))
    a = table4[safe]  # (H, W, 4)
    qx = (np.arange(w, dtype=np.float32) + 0.5)[None, :]
    qy = (np.arange(h, dtype=np.float32) + 0.5)[:, None]
    u = (qx - a[..., 0]) * a[..., 2]
    v = -(qy - a[..., 1]) * a[..., 2]
    w2 = jnp.maximum(0.0, 1.0 - u * u - v * v)
    nz = -jnp.sqrt(w2)
    ndotl = u * l_cam[0] + v * l_cam[1] + nz * l_cam[2]
    lit = config.ambient + config.diffuse * jnp.maximum(ndotl, 0.0)
    cap_rgb = ut
    if cap_split is not None:
        ut2 = jnp.clip(prims.color[c_rep2] * jnp.float32(config.trail_boost),
                       0.0, 1.0)
        cap_rgb = jnp.where((index < cap_split)[..., None], ut, ut2)
    rgb = jnp.where((a[..., 2] > 0)[..., None], uc * lit[..., None],
                    jnp.where((a[..., 3] > 0)[..., None], cap_rgb, ug))
    bg = np.asarray(config.background, np.float32)
    return jnp.clip(jnp.where(hit[..., None], rgb, bg), 0.0, 1.0)
