#!/usr/bin/env python
"""Virtual screening entry point of the PyTorch/CUDA port (see
pharmaconet_tpu_torch/cli/screening.py)."""

from pharmaconet_tpu_torch.cli.screening import entrypoint

if __name__ == "__main__":
    raise SystemExit(entrypoint())
