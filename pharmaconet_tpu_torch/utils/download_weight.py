"""Local lookup of the pretrained checkpoint.

The JAX package's `utils/download_weight.py` with the same environment
variables and paths, in this order:

  1. an explicit `weight_path` (it must exist);
  2. the `PMNET_TPU_WEIGHT` environment variable (a converted `.npz` or the
     upstream `model.tar`; a missing file raises `FileNotFoundError`);
  3. `$PMNET_TPU_HOME/model.npz`, then `model.tar` (default home
     `~/.pharmaconet_tpu`).

Where the JAX package would then download the upstream artifact with gdown,
this package downloads nothing: it raises `RuntimeError` naming
`GDRIVE_URL`, and `PharmacoNet` falls back to random parameters on it, as
the JAX package does when the download is not possible.
"""

from __future__ import annotations

import os
from pathlib import Path

GDRIVE_URL = "https://drive.google.com/uc?id=1gzjdM7bD3jPm23LBcDXtkSk18nETL04p"


def default_weight_dir() -> Path:
    return Path(os.environ.get("PMNET_TPU_HOME", Path.home() / ".pharmaconet_tpu"))


def resolve_weight_path(weight_path: str | Path | None = None) -> Path:
    if weight_path is not None:
        path = Path(weight_path)
        if not path.exists():
            raise FileNotFoundError(f"weight file not found: {path}")
        return path
    env = os.environ.get("PMNET_TPU_WEIGHT")
    if env:
        path = Path(env)
        if path.exists():
            return path
        raise FileNotFoundError(f"PMNET_TPU_WEIGHT points to a missing file: {env}")
    for candidate in (default_weight_dir() / "model.npz", default_weight_dir() / "model.tar"):
        if candidate.exists():
            return candidate
    raise RuntimeError(
        "Pretrained weights are not available locally and this package downloads "
        "nothing. Provide the checkpoint via PMNET_TPU_WEIGHT or place it at "
        f"{default_weight_dir() / 'model.tar'} (reference artifact: {GDRIVE_URL})."
    )
