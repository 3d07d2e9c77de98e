from .featurizer import (
    get_box_area_host,
    get_protein_pointcloud,
    get_token_and_filter,
    get_token_informations,
)

__all__ = [
    "get_box_area_host",
    "get_protein_pointcloud",
    "get_token_and_filter",
    "get_token_informations",
]
