from c_raytracer_tpu_torch.render.api import (  # noqa: F401
    make_host_tiled_renderer, make_host_tiled_value_and_grad, make_renderer,
    render)
from c_raytracer_tpu_torch.render.config import RenderConfig  # noqa: F401
from c_raytracer_tpu_torch.render.progressive import (  # noqa: F401
    render_progressive, render_spp_chunked)
