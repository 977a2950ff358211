from c_raytracer_tpu_torch.core import (  # noqa: F401
    cmath, noise, remat, rng, v3)
