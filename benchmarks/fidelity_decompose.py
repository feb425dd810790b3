"""Decompose the trail-segments winner-flip rate by winning-part pair.

traj_vel's PRODUCTION DEFAULT (segments=8) already flips ~0.9% of
trail pixels vs the 21-point reference polyline — 4x the traj_ball
rate — and the certificate's default-anchored margin
(utils.fidelity.GEOMETRY_REL_MARGIN) leans on that baseline.  This tool
attributes them: trail->trail owner swaps (invisible — flat trail
color), trail<->tail/head (the capsule-LOD droplet body z-fighting the
trail along their overlap), trail<->ground/empty (silhouette shifts).

Run (CPU, ~minutes):
  python benchmarks/fidelity_decompose.py [--preset traj_vel]
      [--segments 8,4] [--points 6000]

Reference workloads: /root/reference/traj_vel_renderer.py:409-439
(droplet + trails), traj_ball_renderer.py:309-333.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="traj_vel")
    ap.add_argument("--segments", default="8,4")
    ap.add_argument("--points", type=int, default=6000)
    ap.add_argument("--frames", default="60,120,199")
    ap.add_argument("--out", default=None,
                    help="optional JSON output path")
    args = ap.parse_args()

    import jax

    # Exactness work: runs on the CPU.
    jax.config.update("jax_platforms", "cpu")

    from pointcloud_render.utils.fidelity import trail_flip_decomposition

    frames = tuple(int(f) for f in args.frames.split(","))
    out = {}
    for segs in (s if s == "adaptive" else int(s)
                 for s in args.segments.split(",")):
        rec = trail_flip_decomposition(segs, n_points=args.points,
                                       frames=frames,
                                       preset_name=args.preset)
        out[str(segs)] = rec
        print(f"{args.preset} segments={segs} worst frame={rec.get('frame')} "
              f"trail_rate={rec['trail_rate']:.3e} "
              f"(denom {rec['denom']} trail px)", flush=True)
        print(f"  trail->trail owner swap (invisible): "
              f"{rec['trail_owner_swap']:.3e}")
        for pair, rate in sorted(rec["transitions"].items(),
                                 key=lambda kv: -kv[1]):
            print(f"  {pair:18s} {rate:.3e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
