"""Unified CLI: render any preset with overridable folders/frames/backend.

Usage:
  python -m pointcloud_render.cli.main --preset traj_ball \
      [--input-folder trajectory_ply] [--output-folder render] \
      [--frames 0:220] [--backend auto] [--droplet-lod capsule|mesh] \
      [--no-resume] [--metrics-jsonl path]

The seven per-script entry points (cli.traj_ball_renderer etc.) are thin
wrappers with the reference's hardcoded defaults.
"""

from __future__ import annotations

import argparse

from pointcloud_render.configs import PRESETS
from pointcloud_render.raster.render import BACKENDS, RasterConfig
from pointcloud_render.run.batch import run_batch
from pointcloud_render.run.metrics import MetricsSink
from pointcloud_render.run.pipeline import FramePipeline
from pointcloud_render.utils.compile_cache import enable_compile_cache


def parse_frames(spec: str, default):
    """'': the preset's frames; 'lo:hi' a range with either bound
    optional ('100:' = from 100 to the preset's last frame); 'a,b,c'
    an explicit list."""
    if not spec:
        return default
    if ":" in spec:
        lo, hi = spec.split(":")
        end = int(hi) if hi else max(default) + 1
        return range(int(lo or 0), end)
    return [int(x) for x in spec.split(",")]


def build_parser(preset_name=None):
    p = argparse.ArgumentParser(description=__doc__)
    if preset_name is None:
        p.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p.add_argument("--input-folder", default=None)
    p.add_argument("--output-folder", default=None)
    p.add_argument("--frames", default="")
    p.add_argument("--backend", default="auto",
                   choices=("auto",) + BACKENDS)
    p.add_argument("--droplet-lod", default="capsule",
                   choices=["capsule", "mesh"])
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--write-depth", action="store_true",
                   help="also save per-frame depth buffers as .npy")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--supersample", type=int, default=1,
                   help="rfilter AA factor (1 = bit-exact single sample)")
    p.add_argument("--shadows", action="store_true",
                   help="shadow-map look pass (shading/shadow.py): "
                        "PCSS penumbra approximating the reference's "
                        "8x8 area-emitter shadows")
    p.add_argument("--ground-spec", type=float, default=0.0,
                   help="GGX specular strength on triangle winners "
                        "(the reference's roughplastic ground, "
                        "alpha=0.1 IOR 1.46; 0 = pure Lambert)")
    p.add_argument("--gi", type=float, default=0.0,
                   help="ground-bounce fill on splat undersides, "
                        "approximating the reference's path-traced "
                        "indirect light (0 = off, bit-pinned look; "
                        "try 0.25)")
    return p


def run(args, preset_name=None):
    from pointcloud_render.shading.shade import ShadingConfig

    preset = PRESETS[preset_name or args.preset]
    pipeline = FramePipeline(
        preset,
        raster_config=RasterConfig(
            backend=args.backend,
            supersample=args.supersample,
            shading=ShadingConfig(shadows=bool(args.shadows),
                                  ground_spec=float(args.ground_spec),
                                  gi=float(args.gi))),
        droplet_lod=args.droplet_lod,
        width=args.width, height=args.height,
    )
    sink = MetricsSink(jsonl_path=args.metrics_jsonl)
    run_batch(
        preset,
        input_folder=args.input_folder,
        output_folder=args.output_folder,
        frames=parse_frames(args.frames, preset.frames),
        pipeline=pipeline,
        resume=not args.no_resume,
        sink=sink,
        write_depth=args.write_depth,
    )
    return sink


def main(argv=None, preset_name=None):
    args = build_parser(preset_name).parse_args(argv)
    enable_compile_cache()
    run(args, preset_name)


if __name__ == "__main__":
    main()
