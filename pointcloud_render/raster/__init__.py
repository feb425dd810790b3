from pointcloud_render.raster.primitives import (  # noqa: F401
    ScreenPrimitives,
    KIND_DISC,
    KIND_CAPSULE,
    KIND_TRIANGLE,
)
from pointcloud_render.raster.project import project_points  # noqa: F401
from pointcloud_render.raster.render import render, RasterConfig  # noqa: F401
