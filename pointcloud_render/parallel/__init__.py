from pointcloud_render.parallel.render_parallel import (  # noqa: F401
    make_render_mesh,
    render_frames_dp,
    render_point_sharded,
)
