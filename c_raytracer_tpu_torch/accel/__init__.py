from c_raytracer_tpu_torch.accel.build import (  # noqa: F401
    morton_order, reorder_scene)
from c_raytracer_tpu_torch.accel.intersect import (  # noqa: F401
    Intersector, make_intersector)
from c_raytracer_tpu_torch.accel.traverse import (  # noqa: F401
    ClusterSet, pack_clusters)
