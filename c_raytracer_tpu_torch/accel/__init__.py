from c_raytracer_tpu_torch.accel.intersect import (  # noqa: F401
    Intersector, make_intersector)
