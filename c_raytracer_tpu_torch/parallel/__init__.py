from c_raytracer_tpu_torch.parallel.launch import launch  # noqa: F401
from c_raytracer_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from c_raytracer_tpu_torch.parallel.render_sharded import (  # noqa: F401
    make_sharded_renderer)
from c_raytracer_tpu_torch.parallel.train import (  # noqa: F401
    loss_and_grad_fn, make_train_step)
