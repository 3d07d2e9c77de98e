#!/usr/bin/env python
"""Pharmacophore modeling entry point of the PyTorch/CUDA port (see
pharmaconet_tpu_torch/cli/modeling.py)."""

from pharmaconet_tpu_torch.cli.modeling import entrypoint

if __name__ == "__main__":
    raise SystemExit(entrypoint())
