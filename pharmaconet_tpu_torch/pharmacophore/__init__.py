from .density_map import DensityMapGraph, extract_components
from .model import ModelEdge, ModelNode, ModelNodeCluster, PharmacophoreModel

__all__ = [
    "DensityMapGraph",
    "extract_components",
    "ModelEdge",
    "ModelNode",
    "ModelNodeCluster",
    "PharmacophoreModel",
]
