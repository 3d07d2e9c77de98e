"""Training kit: the detector's train step and the proxy-head developer
trainer (`pharmaconet_tpu/training`), in torch."""

from .affinity_model import DevAffinityModel
from .config import Config
from .train_step import make_dummy_batch, make_optimizer, make_train_step

__all__ = [
    "DevAffinityModel",
    "Config",
    "Trainer",
    "make_dummy_batch",
    "make_optimizer",
    "make_train_step",
]


def __getattr__(name):
    # lazy: Trainer pulls the data pipeline (dataset, prefetch thread)
    if name == "Trainer":
        from .trainer import Trainer

        return Trainer
    raise AttributeError(name)
