from fireflies_tpu_torch.entity.mesh import Mesh
from fireflies_tpu_torch.entity.shape_model import FlameShapeModel, ShapeModel
from fireflies_tpu_torch.entity.transformable import Curve, Transformable

__all__ = ["Transformable", "Mesh", "Curve", "ShapeModel", "FlameShapeModel"]
