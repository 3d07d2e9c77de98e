#!/usr/bin/env python
"""Feature extraction entry point of the PyTorch/CUDA port (see
pharmaconet_tpu_torch/cli/feature_extraction.py)."""

from pharmaconet_tpu_torch.cli.feature_extraction import entrypoint

if __name__ == "__main__":
    raise SystemExit(entrypoint())
