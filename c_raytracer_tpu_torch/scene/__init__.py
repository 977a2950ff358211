from c_raytracer_tpu_torch.scene.convert import (  # noqa: F401
    grads_to_numpy, named_leaves, params_to_torch)
from c_raytracer_tpu_torch.scene.loader import load_scene  # noqa: F401
from c_raytracer_tpu_torch.scene.types import (  # noqa: F401
    Camera, Materials, Scene, SceneParams, SceneStatic, make_scene)
