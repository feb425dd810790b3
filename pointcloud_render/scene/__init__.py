from pointcloud_render.scene.pointcloud import PointCloud  # noqa: F401
from pointcloud_render.scene.normalize import (  # noqa: F401
    standardize_point_cloud,
    transform_coordinates,
)
from pointcloud_render.scene.camera import (  # noqa: F401
    Camera,
    camera_origin,
    look_at_axes,
)
from pointcloud_render.scene.camera_path import CameraPath, REFERENCE_PATHS  # noqa: F401
from pointcloud_render.scene.dynamics import advect, motion_colors  # noqa: F401
