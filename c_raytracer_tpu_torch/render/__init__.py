from c_raytracer_tpu_torch.render.api import make_renderer  # noqa: F401
from c_raytracer_tpu_torch.render.config import RenderConfig  # noqa: F401
