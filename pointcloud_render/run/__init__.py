from pointcloud_render.run.pipeline import FramePipeline  # noqa: F401
from pointcloud_render.run.batch import run_batch  # noqa: F401
from pointcloud_render.run.trajectory import TrajectoryScanRenderer  # noqa: F401
from pointcloud_render.run.video import write_gif, write_frame_sequence  # noqa: F401
