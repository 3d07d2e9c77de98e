"""PharmacoNet on PyTorch and CUDA: the port of `pharmaconet_tpu` to one
NVIDIA Hopper GPU.

The package imports torch and never jax, and keeps its own copy of every
module it needs. Pocket modeling (protein + centre -> `.pm`, `module.py`)
and screening (`.pm` + ligand library -> ranked CSV) run on the card
through hand-written CUDA kernels (`csrc/voxelize.cu`,
`csrc/screen_fused.cu`); the trunk also serves as a pocket encoder
(`api.get_pmnet_dev`, feature extraction) for the docking proxies
(`proxy/`). Entry points take an explicit `device` and use the card unless
the caller asks for the CPU. Importing the package sets up the CPU's
vector math once (`device.set_up_cpu_vector_math`), so that a screen's
scores do not depend on the process that computes them.
"""

__version__ = "0.1.0"

from .device import set_up_cpu_vector_math
from .ops.launch_log import install_from_env
from .pharmacophore.model import PharmacophoreModel

set_up_cpu_vector_math()  # before any module of the port computes
install_from_env()  # launch counts at exit, where PMNET_TORCH_LAUNCH_LOG asks

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
