from c_raytracer_tpu_torch.image.tiff import (  # noqa: F401
    quantize_rgb8, read_tiff, write_tiff_raw, write_tiff_rgb8)
