"""PharmacoNet network (torch): SwinV2-3D backbone, FPN, and the cavity,
token and mask heads, with the upstream checkpoint's module names."""

from .model import PharmacoNetModel, build_model

__all__ = ["PharmacoNetModel", "build_model"]
