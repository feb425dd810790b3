from pointcloud_render.shading.shade import shade_framebuffer, ShadingConfig  # noqa: F401
