from c_raytracer_tpu_torch.core import cmath, noise, rng, v3  # noqa: F401
