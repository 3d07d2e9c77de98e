"""Training configuration tree (developer/src/config.py:6-72 equivalent).

The dataclass tree of `pharmaconet_tpu/training/config.py` and its YAML
round trip (pyyaml), so a config written by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path

MISSING = "???"


@dataclass
class ModelConfig:
    hidden_dim: int = 128
    ligand_num_convs: int = 4


@dataclass
class DataConfig:
    protein_info_path: str = MISSING
    train_protein_code_path: str = MISSING
    protein_dir: str = MISSING
    ligand_path: str = MISSING


@dataclass
class LrSchedulerConfig:
    scheduler: str = "lambdalr"
    lr_decay: int = 50_000


@dataclass
class OptimizerConfig:
    opt: str = "adam"
    lr: float = 1e-3
    eps: float = 1e-8
    betas: tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.05
    clip_grad: float = 1.0


@dataclass
class TrainConfig:
    val_every: int = 2_000
    log_every: int = 10
    print_every: int = 100
    save_every: int = 1_000
    max_iterations: int = 300_000
    batch_size: int = 4
    num_workers: int = 4
    opt: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LrSchedulerConfig = field(default_factory=LrSchedulerConfig)
    split_ratio: float = 0.9
    # 'pickle' = atomic synchronous full-state saves; 'orbax' = async
    # (device->host snapshot now, disk write off the train loop)
    checkpoint_backend: str = "pickle"
    center_noise: float = 3.0


@dataclass
class Config:
    log_dir: str = MISSING
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        import yaml

        with open(path, "w") as w:
            yaml.safe_dump(self.to_dict(), w, sort_keys=False)

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        config = cls()
        _update(config, data)
        return config

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))


def _update(node, data: dict) -> None:
    """Set the fields of the dataclass `node` that `data` names, into nested
    dataclasses; keys that name no field are ignored."""
    for f in dataclasses.fields(node):
        if f.name not in data:
            continue
        current = getattr(node, f.name)
        if dataclasses.is_dataclass(current) and isinstance(data[f.name], dict):
            _update(current, data[f.name])
        else:
            setattr(node, f.name, data[f.name])
