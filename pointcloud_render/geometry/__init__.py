from pointcloud_render.geometry.rotation import (  # noqa: F401
    rotation_from_velocity,
    rotation_matrices_from_velocities,
    random_rotation_matrix,
)
from pointcloud_render.geometry.droplet import droplet_mesh, write_droplet_obj  # noqa: F401
from pointcloud_render.geometry.trails import (  # noqa: F401
    trail_length_scale,
    velocity_trail_points,
    velocity_trails,
    catmull_rom_trails,
)
