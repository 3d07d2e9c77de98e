"""Lookup and download of the pretrained checkpoint.

The JAX package's `utils/download_weight.py` with the same environment
variables and paths, in this order:

  1. an explicit `weight_path` (it must exist);
  2. the `PMNET_TPU_WEIGHT` environment variable (a converted `.npz` or the
     upstream `model.tar`; a missing file raises `FileNotFoundError`);
  3. `$PMNET_TPU_HOME/model.npz`, then `model.tar` (default home
     `~/.pharmaconet_tpu`);
  4. `download_pretrained_model` into `$PMNET_TPU_HOME/model.tar`: the
     upstream artifact (`GDRIVE_URL`) through gdown, imported when needed.
     Without gdown it raises `RuntimeError` naming `GDRIVE_URL`, and
     `PharmacoNet` falls back to random parameters on it, as the JAX
     package does when the download is not possible.
"""

from __future__ import annotations

import os
from pathlib import Path

GDRIVE_URL = "https://drive.google.com/uc?id=1gzjdM7bD3jPm23LBcDXtkSk18nETL04p"


def default_weight_dir() -> Path:
    return Path(os.environ.get("PMNET_TPU_HOME", Path.home() / ".pharmaconet_tpu"))


def resolve_weight_path(weight_path: str | Path | None = None, verbose: bool = True) -> Path:
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
    return download_pretrained_model(default_weight_dir() / "model.tar", verbose)


def download_pretrained_model(weight_path: str | Path, verbose: bool = True) -> Path:
    """The upstream checkpoint at `weight_path`, downloaded with gdown unless
    the file is there. The directory is made only once gdown is found."""
    weight_path = Path(weight_path)
    if weight_path.exists():
        return weight_path
    try:
        import gdown  # type: ignore[import-not-found]
    except ImportError as e:
        raise RuntimeError(
            "Pretrained weights are not available locally and gdown is not "
            "installed. Provide the checkpoint via PMNET_TPU_WEIGHT or "
            f"place it at {weight_path} (reference artifact: {GDRIVE_URL})."
        ) from e
    weight_path.parent.mkdir(parents=True, exist_ok=True)
    if verbose:
        print(f"Downloading pretrained model to {weight_path} ...")
    gdown.download(GDRIVE_URL, str(weight_path), quiet=not verbose)
    return weight_path
