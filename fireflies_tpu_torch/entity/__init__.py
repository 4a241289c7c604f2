from fireflies_tpu_torch.entity.mesh import Mesh
from fireflies_tpu_torch.entity.transformable import Transformable

__all__ = ["Transformable", "Mesh"]
