"""Differentiable rendering demo: optimize point positions to an image.

The alpha-compositing path (raster/alpha.py) is pure commutative sums —
differentiable end-to-end — so a point cloud can be FIT to a target
image with plain gradient descent.  (The reference's Mitsuba path is an
external black box; inverse rendering is a new capability.)

Run: python examples/fit_cloud.py   (writes examples/fit_before/after.png)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_render.io import write_png
from pointcloud_render.raster import alpha
from pointcloud_render.scene.camera import Camera

W, H = 256, 144


def render(positions, cam, n, radius=0.04):
    splats = alpha.splat_gaussians(
        positions, cam, jnp.full((n,), radius),
        np.array([1.0, 1.0, 1.0], np.float32), jnp.full((n,), 0.8))
    return alpha.composite_bruteforce(splats, W, H, background=(0, 0, 0))


def main(n=400, steps=300, lr=2e-3):
    cam = Camera(origin=jnp.asarray(np.array([2., 2., 2.], np.float32)),
                 target=jnp.asarray(np.array([0., 0., 0.], np.float32)),
                 width=W, height=H)
    rng = np.random.default_rng(0)

    # Target: a ring of points.
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    target_pos = np.stack([0.35 * np.cos(t), 0.35 * np.sin(t),
                           np.zeros_like(t)], 1).astype(np.float32)
    target_img = render(jnp.asarray(target_pos), cam, n)

    # Init: a random blob.
    pos = jnp.asarray(rng.normal(size=(n, 3)) * 0.15, jnp.float32)
    write_png(os.path.join(os.path.dirname(__file__), "fit_before.png"),
              np.asarray(render(pos, cam, n)))

    # Coarse-to-fine: start with fat splats (wide gradient basins), then
    # anneal toward the target radius.
    @jax.jit
    def loss_fn(p, radius):
        return jnp.mean((render(p, cam, n, radius) - target_img) ** 2)

    grad_fn = jax.jit(jax.grad(loss_fn, argnums=0))
    for i in range(steps):
        radius = jnp.float32(0.12 * (0.04 / 0.12) ** (i / (steps - 1)))
        g = grad_fn(pos, radius)
        pos = pos - lr * g / (jnp.linalg.norm(g) + 1e-8) * np.sqrt(n)
        if i % 50 == 0:
            print(f"step {i:4d}  r={float(radius):.3f}  "
                  f"loss {float(loss_fn(pos, jnp.float32(0.04))):.6f}",
                  flush=True)

    write_png(os.path.join(os.path.dirname(__file__), "fit_after.png"),
              np.asarray(render(pos, cam, n)))
    print(f"final loss {float(loss_fn(pos, jnp.float32(0.04))):.6f} — "
          f"wrote fit_before/after.png")


if __name__ == "__main__":
    main()
