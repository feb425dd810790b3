from pointcloud_render.io.loaders import load_point_cloud  # noqa: F401
from pointcloud_render.io.ply import read_ply, write_ply  # noqa: F401
from pointcloud_render.io.png import write_png  # noqa: F401
from pointcloud_render.io.obj import read_obj, write_obj  # noqa: F401
