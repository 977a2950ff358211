from c_raytracer_tpu_torch.textures.textures import texture_color_soa  # noqa: F401
