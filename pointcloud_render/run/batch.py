"""Batch driver: frame-file discovery, history preload, resume manifest.

Replaces the reference main() loops (traj_ball_renderer.py:419-477):
same frame-file synthesis (frames 200-219 reuse frame 199), same
missing-file warnings and per-frame error-containment, plus what the
reference lacks (SURVEY.md §5): a manifest of completed frames so an
interrupted batch resumes at the first unrendered frame, and structured
metrics.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Optional

import numpy as np

from pointcloud_render.configs import ScenePreset
from pointcloud_render.run.metrics import FrameRecord, MetricsSink, stage
from pointcloud_render.run.pipeline import FramePipeline

MANIFEST_NAME = "manifest.json"


class Manifest:
    """Frame-completion journal (JSON: {frame_index: png_name})."""

    def __init__(self, folder: str):
        self.path = os.path.join(folder, MANIFEST_NAME)
        self.done = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self.done = {int(k): v for k, v in json.load(f).items()}
            except (json.JSONDecodeError, ValueError):
                self.done = {}

    def is_done(self, frame_index: int, out_folder: str) -> bool:
        name = self.done.get(frame_index)
        return bool(name) and os.path.exists(os.path.join(out_folder, name))

    def mark(self, frame_index: int, png_path: str):
        self.done[frame_index] = os.path.basename(png_path)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self.done.items()}, f)
        os.replace(tmp, self.path)


def run_batch(preset: ScenePreset, input_folder: Optional[str] = None,
              output_folder: Optional[str] = None, frames=None,
              pipeline: Optional[FramePipeline] = None, resume: bool = True,
              sink: Optional[MetricsSink] = None,
              write_depth: bool = False) -> MetricsSink:
    """Render a preset's whole frame schedule.  Returns the metrics sink."""
    input_folder = input_folder or preset.input_folder
    output_folder = output_folder or preset.output_folder
    frames = list(frames if frames is not None else preset.frames)
    pipeline = pipeline or FramePipeline(preset)
    sink = sink or MetricsSink()
    os.makedirs(output_folder, exist_ok=True)
    manifest = Manifest(output_folder)

    # Resolve frame files, warn on missing (reference behavior:
    # traj_ball_renderer.py:444-449).
    plan = []
    for fi in frames:
        path = os.path.join(input_folder, preset.frame_file(fi))
        if os.path.isfile(path):
            plan.append((fi, path))
        else:
            print(f"Warning: File not found: {path}")
    if not plan:
        print(f"No target files found in folder: {input_folder}")
        return sink

    # History preload for history-fit trails (traj_renderer.py:718-742):
    # load+standardize+transform every frame once, slide a window over it.
    all_frames = None
    if preset.trail == "history":
        all_frames = {}
        for fi, path in plan:
            try:
                all_frames[fi] = pipeline.load_and_prepare(path)
            except Exception as e:  # noqa: BLE001 — reference continues
                print(f"Warning: Failed to load {os.path.basename(path)}: {e}")
                all_frames[fi] = None

    t_start = time.perf_counter()
    for fi, path in plan:
        if resume and manifest.is_done(fi, output_folder):
            continue
        rec = FrameRecord(frame_index=fi, file=os.path.basename(path))
        try:
            history = None
            if all_frames is not None and fi > 0:
                lo = max(0, fi - preset.history_window)
                hs = [all_frames.get(h) for h in range(lo, fi)]
                hs = [h for h in hs if h is not None]
                if hs:
                    history = np.stack([h[:, :3] for h in hs])
            with stage(rec, "load"):
                # History presets already loaded+prepared every frame in
                # the preload pass — reuse it instead of paying the disk
                # IO and float64 standardize twice per frame.
                pcl = (all_frames.get(fi)
                       if all_frames is not None else None)
                if pcl is None:
                    pcl = pipeline.load_and_prepare(path)
            rec.points = int(pcl.shape[0])
            with stage(rec, "render"):
                fb = pipeline.render_array(pcl, fi, history)
                # Block the whole pytree: awaiting a single leaf of an
                # AOT-executed result does not await the program.
                import jax as _jax

                _jax.block_until_ready((fb.rgb, fb.depth, fb.index))
            with stage(rec, "save"):
                out_path = pipeline.save_outputs(fb, path, fi,
                                                 output_folder,
                                                 write_depth)
            manifest.mark(fi, out_path)
        except Exception as e:  # noqa: BLE001 — reference: print and continue
            rec.status = "error"
            rec.error = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        sink.emit(rec)

    total = time.perf_counter() - t_start
    s = sink.summary()
    s["wall_s"] = total
    print(f"Batch done: {s}")
    return sink
