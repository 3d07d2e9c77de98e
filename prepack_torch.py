#!/usr/bin/env python
"""Library prepacking entry point of the PyTorch/CUDA port (see
pharmaconet_tpu_torch/cli/prepack.py)."""

from pharmaconet_tpu_torch.cli.prepack import entrypoint

if __name__ == "__main__":
    raise SystemExit(entrypoint())
