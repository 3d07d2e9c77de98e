"""PharmacoNet on PyTorch and CUDA: the port of `pharmaconet_tpu` to one
NVIDIA Hopper GPU.

The package imports torch and never jax, and keeps its own copy of every
module it needs. Pocket modeling (protein + centre -> `.pm`, `module.py`)
and screening (`.pm` + ligand library -> ranked CSV) run on the card
through hand-written CUDA kernels (`csrc/voxelize.cu`,
`csrc/screen_fused.cu`); entry points take an explicit `device` and use
the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from .pharmacophore.model import PharmacophoreModel

_LAZY = {
    "PharmacoNet": ("pharmaconet_tpu_torch.module", "PharmacoNet"),
    "BatchScreener": ("pharmaconet_tpu_torch.scoring.batch_screen", "BatchScreener"),
    "Ligand": ("pharmaconet_tpu_torch.scoring.ligand", "Ligand"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target[0]), target[1])


__all__ = ["PharmacophoreModel", "__version__", *sorted(_LAZY)]
