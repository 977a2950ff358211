from c_raytracer_tpu_torch.geometry.primitives import (  # noqa: F401
    DeviceScene, closest_hit_soa, device_scene)
