"""Trail geometry: velocity-extrapolated and Catmull-Rom history-fit trails.

The reference emits per-point trail polylines as Mitsuba linearcurve files,
one temp file per point per frame (reference: traj_ball_renderer.py:98-188;
traj_renderer.py:204-396).  Here the same polylines are produced as dense
(N, P, 3) arrays plus validity masks — fixed shapes, no files — so the
whole cloud's trails evaluate as one XLA program and feed straight into
the capsule rasterizer.

Three length-scale schedules exist across the reference scripts:

* ``"ball"``  — ramp f/19 for frames 0-19, then hold 1.0
  (reference: traj_ball_renderer.py:119-124);
* ``"vel"``   — ramp 0-19, hold 20-199, fade 1-(f-199)/20 for 200-219
  (reference: traj_vel_renderer.py:215-224);
* ``"fixed"`` — constant 1.0 (reference: traj_b0.py:127).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

import jax

VELOCITY_EPS = 1e-6  # reference: traj_ball_renderer.py:112
BASE_TRAIL_LENGTH = 0.07  # reference: traj_ball_renderer.py:132
MAX_TRAIL_LENGTH = 0.3  # reference: traj_ball_renderer.py:133
VEL_NORMALIZER = 10.0  # reference: traj_ball_renderer.py:134
N_TRAIL_POINTS = 20  # samples before the appended current position
TRAIL_DEDUP_EPS = 1e-5  # reference: traj_renderer.py:359
HISTORY_WINDOW = 20  # reference: traj_renderer.py:218
LAST_MOTION_FRAME = 199
FADE_FRAMES = 20

SCHEDULES = ("ball", "vel", "fixed")


def trail_length_scale(schedule: str, frame_index):
    """Length-scale factor for a frame; works on ints and traced values."""
    xp = jnp if isinstance(frame_index, jax.Array) else np
    f = xp.asarray(frame_index, xp.float32)
    if schedule == "fixed":
        return xp.ones_like(f)
    ramp = f / 19.0
    if schedule == "ball":
        return xp.where(f <= 19, ramp, 1.0)
    if schedule == "vel":
        fade = 1.0 - (f - LAST_MOTION_FRAME) / FADE_FRAMES
        return xp.where(f <= 19, ramp, xp.where(f <= LAST_MOTION_FRAME, 1.0, fade))
    raise ValueError(f"unknown schedule {schedule!r}")


def velocity_trail_points(position, velocity, length_scale) -> np.ndarray:
    """Exact host-side single-point replay -> (21, 3) float64 polyline.

    Point i sits at position + (-v/|v|) * L * t_i with t_i = (19-i)/19,
    i.e. from the far end toward the position; the position itself is then
    appended (so the last two points coincide,
    reference: traj_ball_renderer.py:141-150).
    """
    velocity = np.array(velocity, dtype=np.float64)
    vel_norm = np.linalg.norm(velocity)
    vel_normalized = min(vel_norm / VEL_NORMALIZER, 1.0)
    trail_length = (BASE_TRAIL_LENGTH
                    + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * vel_normalized
                    ) * length_scale
    direction = -velocity / vel_norm
    ts = (N_TRAIL_POINTS - 1 - np.arange(N_TRAIL_POINTS)) / (N_TRAIL_POINTS - 1)
    pts = np.asarray(position)[None, :] + direction[None, :] * trail_length * ts[:, None]
    return np.concatenate([pts, np.asarray(position, np.float64)[None, :]], axis=0)


def velocity_trails(positions, velocities, frame_index, schedule: str = "ball"):
    """Vectorized trails for a whole cloud.

    Returns:
      points: (N, 21, 3) float32 polylines (garbage where invalid).
      valid: (N,) bool — velocity above epsilon AND length scale > 0
        (reference: traj_ball_renderer.py:112,127).
    """
    p = jnp.asarray(positions, jnp.float32)
    v = jnp.asarray(velocities, jnp.float32)
    scale = trail_length_scale(schedule, jnp.asarray(frame_index))

    vel_norm = jnp.linalg.norm(v, axis=1)
    valid = (vel_norm >= VELOCITY_EPS) & (scale > 0)

    vel_normalized = jnp.minimum(vel_norm / VEL_NORMALIZER, 1.0)
    trail_length = (BASE_TRAIL_LENGTH
                    + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * vel_normalized
                    ) * scale
    safe = jnp.where(vel_norm < VELOCITY_EPS, 1.0, vel_norm)
    direction = -v / safe[:, None]

    ts = (N_TRAIL_POINTS - 1 - np.arange(N_TRAIL_POINTS, dtype=np.float32)) / (
        N_TRAIL_POINTS - 1)
    offsets = direction[:, None, :] * (trail_length[:, None] * ts[None, :])[..., None]
    pts = p[:, None, :] + offsets  # (N, 20, 3)
    pts = jnp.concatenate([pts, p[:, None, :]], axis=1)  # (N, 21, 3)
    valid = valid & jnp.all(jnp.isfinite(pts.reshape(pts.shape[0], -1)), axis=1)
    return pts, valid


def velocity_trails_sampled(positions, velocities, frame_index, indices,
                            schedule: str = "ball"):
    """``velocity_trails`` evaluated ONLY at vertex ``indices`` (static).

    Bit-identical to ``velocity_trails(...)[0][:, indices]`` — the same
    f32 expression (direction * (L * t)) at the same t values, with
    index 20 mapping to the appended position — but materializes
    (N, K, 3) instead of (N, 21, 3): at 1M points the render layer
    samples 9 of 21 vertices (run/pipeline.py), so the full trail
    build + gather is ~60% wasted work.  The validity mask keeps the
    FULL 21-point finiteness semantics (any non-finite vertex of the
    complete trail invalidates it, matching velocity_trails exactly;
    non-finite values can only arise from non-finite inputs, which
    poison every vertex, so checking the sampled vertices is
    equivalent — asserted against the full build in tests).
    """
    idx = np.asarray(indices, np.int64)
    p = jnp.asarray(positions, jnp.float32)
    v = jnp.asarray(velocities, jnp.float32)
    scale = trail_length_scale(schedule, jnp.asarray(frame_index))

    vel_norm = jnp.linalg.norm(v, axis=1)
    valid = (vel_norm >= VELOCITY_EPS) & (scale > 0)

    vel_normalized = jnp.minimum(vel_norm / VEL_NORMALIZER, 1.0)
    trail_length = (BASE_TRAIL_LENGTH
                    + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * vel_normalized
                    ) * scale
    safe = jnp.where(vel_norm < VELOCITY_EPS, 1.0, vel_norm)
    direction = -v / safe[:, None]

    ts_full = (N_TRAIL_POINTS - 1
               - np.arange(N_TRAIL_POINTS, dtype=np.float32)) / (
        N_TRAIL_POINTS - 1)
    ts = ts_full[np.minimum(idx, N_TRAIL_POINTS - 1)]
    ts[idx >= N_TRAIL_POINTS] = 0.0  # index 20: the position itself
    offsets = direction[:, None, :] * (
        trail_length[:, None] * jnp.asarray(ts)[None, :])[..., None]
    pts = p[:, None, :] + offsets  # (N, K, 3)
    is_pos = jnp.asarray(idx >= N_TRAIL_POINTS)
    pts = jnp.where(is_pos[None, :, None],
                    jnp.broadcast_to(p[:, None, :], pts.shape), pts)
    valid = valid & jnp.all(jnp.isfinite(pts.reshape(pts.shape[0], -1)),
                            axis=1)
    return pts, valid


def velocity_trail_vertex_columns(positions, velocities, frame_index,
                                  indices, schedule: str = "ball"):
    """``velocity_trails_sampled`` as PACKED per-vertex columns.

    Returns ``(cols, valid)`` where ``cols[j]`` is the (N, 3) position
    of sampled vertex ``indices[j]`` and ``valid`` the (N,) trail mask —
    bit-identical to ``velocity_trails_sampled``'s ``pts[:, j]`` /
    ``valid`` (same f32 expression per element; the finiteness clause
    ANDs per-column instead of over the (N, K*3) reshape, an identical
    reduction).  The column form exists for layout, not semantics:
    every intermediate stays a packed (N,) vector (see
    raster.primitives.capsules_from_vertex_columns).
    """
    idx = np.asarray(indices, np.int64)
    p = jnp.asarray(positions, jnp.float32)
    v = jnp.asarray(velocities, jnp.float32)
    scale = trail_length_scale(schedule, jnp.asarray(frame_index))

    vel_norm = jnp.linalg.norm(v, axis=1)
    valid = (vel_norm >= VELOCITY_EPS) & (scale > 0)

    vel_normalized = jnp.minimum(vel_norm / VEL_NORMALIZER, 1.0)
    trail_length = (BASE_TRAIL_LENGTH
                    + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * vel_normalized
                    ) * scale
    safe = jnp.where(vel_norm < VELOCITY_EPS, 1.0, vel_norm)
    direction = -v / safe[:, None]

    ts_full = (N_TRAIL_POINTS - 1
               - np.arange(N_TRAIL_POINTS, dtype=np.float32)) / (
        N_TRAIL_POINTS - 1)
    cols = []
    for j in idx:
        if j >= N_TRAIL_POINTS:
            pt = p  # index 20: the position itself, exactly
        else:
            t = np.float32(ts_full[j])
            pt = p + direction * (trail_length * t)[:, None]
        cols.append(pt)
        valid = valid & jnp.all(jnp.isfinite(pt), axis=1)
    return cols, valid


def sampled_ts_table(budget: int) -> np.ndarray:
    """Row ``k-1`` = the k-segment build's sampled t values, padded with
    0 (the position) past vertex k.  The index rounding is IDENTICAL to
    run/pipeline's fixed-k ``sub = round(linspace(0, 20, k+1))``, so a
    trail rendered at k segments by the adaptive build is bit-identical
    to ``velocity_trails_sampled`` at that k."""
    ttab = np.zeros((budget, budget + 1), np.float32)
    ts_full = (N_TRAIL_POINTS - 1
               - np.arange(N_TRAIL_POINTS, dtype=np.float32)) / (
        N_TRAIL_POINTS - 1)
    for kk in range(1, budget + 1):
        idx = np.round(np.linspace(0, N_TRAIL_POINTS,
                                   kk + 1)).astype(np.int64)
        tr = ts_full[np.minimum(idx, N_TRAIL_POINTS - 1)]
        tr[idx >= N_TRAIL_POINTS] = 0.0
        ttab[kk - 1, :kk + 1] = tr
    return ttab


def velocity_trail_lengths(positions, velocities, frame_index,
                           schedule: str = "ball"):
    """(direction (N, 3), trail_length (N,), valid (N,)) — the shared
    straight-trail core of ``velocity_trails*`` (same f32 expressions),
    exposed so the render layer can project trail ENDPOINTS for its
    per-trail segment-count heuristic without building any vertices."""
    p = jnp.asarray(positions, jnp.float32)
    v = jnp.asarray(velocities, jnp.float32)
    scale = trail_length_scale(schedule, jnp.asarray(frame_index))
    vel_norm = jnp.linalg.norm(v, axis=1)
    valid = (vel_norm >= VELOCITY_EPS) & (scale > 0)
    vel_normalized = jnp.minimum(vel_norm / VEL_NORMALIZER, 1.0)
    trail_length = (BASE_TRAIL_LENGTH
                    + (MAX_TRAIL_LENGTH - BASE_TRAIL_LENGTH) * vel_normalized
                    ) * scale
    safe = jnp.where(vel_norm < VELOCITY_EPS, 1.0, vel_norm)
    direction = -v / safe[:, None]
    del p
    return direction, trail_length, valid


def velocity_trails_adaptive(positions, velocities, frame_index, k,
                             budget: int = 4, schedule: str = "ball"):
    """Per-trail ADAPTIVE subdivision of the straight velocity trail.

    ``k``: (N,) int32 in 1..budget — trail i is rendered as k[i]
    capsules whose vertices are the k[i]-segment sampled build's
    (``sampled_ts_table``): the same ``direction * (trail_length * t)``
    f32 expressions at the same t values, with the position vertex
    forced exactly as ``velocity_trails_sampled`` does.  Vertices past
    k[i] duplicate the position and are reported invalid, so capsule
    emission drops those rows (degenerate + masked) — the soup keeps a
    STATIC budget+1 vertices per trail while the binned slot count
    follows the per-trail choice.

    Returns (pts (N, budget+1, 3), vertex_valid (N, budget+1)).
    """
    p = jnp.asarray(positions, jnp.float32)
    direction, trail_length, valid = velocity_trail_lengths(
        positions, velocities, frame_index, schedule)
    ttab = sampled_ts_table(budget)
    k = jnp.clip(jnp.asarray(k, jnp.int32), 1, budget)
    tsel = jnp.take(jnp.asarray(ttab), k - 1, axis=0)  # (N, budget+1)
    offsets = direction[:, None, :] * (
        trail_length[:, None] * tsel)[..., None]
    pts = p[:, None, :] + offsets
    j = jnp.arange(budget + 1, dtype=jnp.int32)[None, :]
    is_pos = j >= k[:, None]
    pts = jnp.where(is_pos[..., None],
                    jnp.broadcast_to(p[:, None, :], pts.shape), pts)
    valid = valid & jnp.all(jnp.isfinite(pts.reshape(pts.shape[0], -1)),
                            axis=1)
    vertex_valid = valid[:, None] & (j <= k[:, None])
    return pts, vertex_valid


# --------------------------------------------------------------------------
# Catmull-Rom history-fit trails (traj_renderer)
# --------------------------------------------------------------------------

def _catmull_rom(p0, p1, p2, p3, t):
    """Reference spline segment (traj_renderer.py:239-252); t in [0, 1]."""
    t2 = t * t
    t3 = t2 * t
    return 0.5 * ((2 * p1)
                  + (-p0 + p2) * t
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)


def _history_sample_plan(m: int):
    """Static sampling plan for m history points -> list of (ctrl idx, reflect
    mode, ts) per segment + final subsample indices / pad count.

    Mirrors traj_renderer.py:266-311: samples_per_segment =
    max(2, 20 // (m-1)); first/last segments reflect a virtual endpoint;
    oversampled lists are decimated with linspace indices, undersampled
    ones repeat the last sample.
    """
    n_seg = m - 1
    sps = max(2, N_TRAIL_POINTS // n_seg)
    total = n_seg * sps
    if total > N_TRAIL_POINTS:
        sub = np.linspace(0, total - 1, N_TRAIL_POINTS).astype(int)
    else:
        sub = np.concatenate([
            np.arange(total),
            np.full(N_TRAIL_POINTS - total, total - 1, dtype=int),
        ])
    return n_seg, sps, sub


def catmull_rom_trails(history, positions):
    """Vectorized history-fit trails.

    Args:
      history: (H, N, 3) positions for the last H frames (oldest -> newest);
        the caller passes at most the last HISTORY_WINDOW frames.  The
        reference matches particles by index across frames
        (traj_renderer.py:546-552) — same contract here.
      positions: (N, 3) current positions (appended as the final vertex).

    Returns:
      points: (N, 21, 3) float32; valid: (N,) bool; keep: (N, 21) bool
        per-vertex mask replaying the reference's finite filter, 1e-5
        dedup and open-curve trimming (traj_renderer.py:340-375).
    """
    positions = jnp.asarray(positions, jnp.float32)
    n = positions.shape[0]
    history = jnp.asarray(history, jnp.float32)
    h = int(history.shape[0])
    m = min(HISTORY_WINDOW, h)
    if m < 2:
        pts = jnp.zeros((n, N_TRAIL_POINTS + 1, 3), jnp.float32)
        return pts, jnp.zeros((n,), bool), jnp.zeros((n, N_TRAIL_POINTS + 1), bool)
    hist = history[-m:]  # (m, N, 3)

    if m == 2:
        ts = np.arange(N_TRAIL_POINTS, dtype=np.float32) / (N_TRAIL_POINTS - 1)
        smooth = ((1 - ts)[None, :, None] * hist[0][:, None, :]
                  + ts[None, :, None] * hist[1][:, None, :])
    else:
        n_seg, sps, sub = _history_sample_plan(m)
        ts = (np.arange(sps, dtype=np.float32) / (sps - 1)) if sps > 1 else (
            np.zeros((1,), np.float32))
        chunks = []
        for seg in range(n_seg):
            if seg == 0:
                p0 = hist[0] - (hist[1] - hist[0])
                p1, p2, p3 = hist[0], hist[1], hist[min(2, m - 1)]
            elif seg == n_seg - 1:
                p0 = hist[max(seg - 1, 0)]
                p1, p2 = hist[seg], hist[seg + 1]
                p3 = hist[seg + 1] + (hist[seg + 1] - hist[seg])
            else:
                p0, p1, p2 = hist[seg - 1], hist[seg], hist[seg + 1]
                p3 = hist[min(seg + 2, m - 1)]
            # (N, sps, 3) via broadcasting over the static ts.
            chunk = _catmull_rom(p0[:, None, :], p1[:, None, :],
                                 p2[:, None, :], p3[:, None, :],
                                 ts[None, :, None])
            chunks.append(chunk)
        dense = jnp.concatenate(chunks, axis=1)  # (N, n_seg*sps, 3)
        smooth = dense[:, sub, :]  # (N, 20, 3)

    pts = jnp.concatenate([smooth, positions[:, None, :]], axis=1)  # (N, 21, 3)

    finite = jnp.all(jnp.isfinite(pts), axis=2)  # (N, 21)

    # Sequential dedup: keep a vertex only if it is > 1e-5 from the last
    # KEPT vertex (a scan over the 21 vertices; state = last kept point).
    def dedup_step(carry, x):
        last, any_kept = carry
        point, is_finite = x
        dist = jnp.linalg.norm(point - last, axis=-1)
        keep = is_finite & (~any_kept | (dist > TRAIL_DEDUP_EPS))
        new_last = jnp.where(keep[:, None], point, last)
        return (new_last, any_kept | keep), keep

    (_, _), keep = jax.lax.scan(
        dedup_step,
        (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n,), bool)),
        (jnp.swapaxes(pts, 0, 1), jnp.swapaxes(finite, 0, 1)),
    )
    keep = jnp.swapaxes(keep, 0, 1)  # (N, 21)

    # Open-curve trimming: if the first and last kept vertices coincide
    # within 1e-5, drop the last kept vertex (traj_renderer.py:366-372).
    idx = np.arange(N_TRAIL_POINTS + 1)
    big = N_TRAIL_POINTS + 2
    first_idx = jnp.min(jnp.where(keep, idx[None, :], big), axis=1)
    last_idx = jnp.max(jnp.where(keep, idx[None, :], -1), axis=1)
    first_pt = jnp.take_along_axis(
        pts, jnp.clip(first_idx, 0, N_TRAIL_POINTS)[:, None, None].repeat(3, 2), 1
    )[:, 0]
    last_pt = jnp.take_along_axis(
        pts, jnp.clip(last_idx, 0, N_TRAIL_POINTS)[:, None, None].repeat(3, 2), 1
    )[:, 0]
    closed = jnp.linalg.norm(first_pt - last_pt, axis=1) < TRAIL_DEDUP_EPS
    n_kept = jnp.sum(keep, axis=1)
    drop_last = closed & (n_kept >= 2)
    keep = keep & ~(drop_last[:, None] & (idx[None, :] == last_idx[:, None]))

    valid = jnp.sum(keep, axis=1) >= 2
    return pts, valid, keep
