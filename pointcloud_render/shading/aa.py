"""Reconstruction-filter antialiasing via supersampled rasterization.

The reference's film uses a gaussian reconstruction filter over multiple
samples per pixel (Mitsuba hdrfilm default rfilter, stddev 0.5 px,
radius 2 px — reference: traj_ball_renderer.py:20-27 '<sampler ...
sampleCount=128>' + hdrfilm).  A single-sample rasterizer shows hard
1-pixel stair-steps on the 0.0007-radius trail curves; this module adds
the rasterizer's equivalent: rasterize at ``ss``x resolution and collapse
with the reference-matched offset-truncated gaussian (stddev 0.5 TARGET
px = 0.5*ss supersampled px, radius 4*stddev = 2 target px, per-axis
offset so the weight is exactly 0 at the radius — Mitsuba's gaussian
rfilter formula).

The filter runs as one depthwise stride-``ss`` convolution at pinned
(HIGHEST) precision.

Exactness scope: AA is a LOOK feature.  ss=1 keeps the bit-exact
single-sample contract; ss>=2 produces filtered RGB whose depth/index
buffers remain the ss-resolution winners (callers that need the exact
1-sample center winners keep ss=1 — the tests pin both behaviors).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def gaussian_kernel(ss: int, stddev_px: float = 0.5, radius_px: float = 2.0):
    """(K, K) float32 filter over supersampled texels for one target pixel.

    stddev/radius are in TARGET pixels and default to the reference
    rfilter's exact parameterization — Mitsuba's gaussian has stddev 0.5
    and radius 4*stddev = 2 px, evaluated separably per axis as the
    OFFSET-truncated form max(0, exp(-x^2/2s^2) - exp(-r^2/2s^2)) so the
    weight reaches zero exactly at the radius
    (/root/reference/traj_ball_renderer.py:20-27 hdrfilm gaussian).
    K = 2*radius*ss texels; normalized to sum 1.
    """
    k = int(2 * radius_px * ss)
    # Texel centers relative to the target pixel center, in target px.
    coords = (np.arange(k) - (k - 1) / 2.0) / ss
    offset = np.exp(-0.5 * (radius_px / stddev_px) ** 2)
    g = np.maximum(0.0, np.exp(-0.5 * (coords / stddev_px) ** 2) - offset)
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


def downsample(rgb, ss: int, stddev_px: float = 0.5,
               radius_px: float = 2.0):
    """(H*ss, W*ss, 3) -> (H, W, 3) gaussian-filtered RGB."""
    if ss == 1:
        return rgb
    k = gaussian_kernel(ss, stddev_px, radius_px)
    ksz = k.shape[0]
    lo = (ksz - ss) // 2
    hi = ksz - ss - lo
    x = jnp.transpose(rgb, (2, 0, 1))[:, None]  # (3, 1, Hs, Ws)
    kern = jnp.asarray(k)[None, None]  # (1, 1, K, K)
    y = jax.lax.conv_general_dilated(
        x, kern, window_strides=(ss, ss), padding=((lo, hi), (lo, hi)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    return jnp.clip(jnp.transpose(y[:, 0], (1, 2, 0)), 0.0, 1.0)


def downsample_reference(rgb, ss: int, stddev_px: float = 0.5,
                         radius_px: float = 2.0):
    """NumPy oracle for :func:`downsample` (tests)."""
    rgb = np.asarray(rgb, np.float32)
    k = gaussian_kernel(ss, stddev_px, radius_px)
    ksz = k.shape[0]
    lo = (ksz - ss) // 2
    hi = ksz - ss - lo
    hs, ws, _ = rgb.shape
    h, w = hs // ss, ws // ss
    padded = np.pad(rgb, ((lo, hi), (lo, hi), (0, 0)))
    out = np.zeros((h, w, 3), np.float32)
    for y in range(h):
        for x in range(w):
            block = padded[y * ss:y * ss + ksz, x * ss:x * ss + ksz]
            out[y, x] = np.tensordot(k, block, axes=([0, 1], [0, 1]))
    return np.clip(out, 0.0, 1.0)
