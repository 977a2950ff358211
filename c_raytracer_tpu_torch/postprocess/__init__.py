from c_raytracer_tpu_torch.postprocess.ops import (  # noqa: F401
    brighten, depth_of_field, dof_camera_params, mist)
