"""Weight conversion CLI: an upstream torch `model.tar` -> the `.npz`
checkpoint of the JAX package (`pharmaconet_tpu/cli/convert_weights.py`).

    python -m pharmaconet_tpu_torch.cli.convert_weights model.tar model.npz

The `.npz` holds the flax parameter tree and the per-type score
distributions; both packages' `PharmacoNet(weight_path="model.npz")` load
it. The conversion runs on the CPU and needs no card.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "convert reference PharmacoNet weights to the native npz format"
    )
    parser.add_argument("src", help="reference torch checkpoint (model.tar)")
    parser.add_argument("dst", help="output path (.npz)")
    return parser


def _leaves(tree: dict):
    for value in tree.values():
        yield from _leaves(value) if isinstance(value, dict) else (value,)


def main(args) -> int:
    from pharmaconet_tpu_torch.network.convert import (
        _meta_model,
        flax_state_from_torch,
        load_torch_checkpoint,
        save_npz_checkpoint,
    )

    state, distributions, _ = load_torch_checkpoint(args.src)
    params = flax_state_from_torch(_meta_model({}), state)
    save_npz_checkpoint(args.dst, {"params": params}, distributions)
    n_params = sum(int(v.size) for v in _leaves(params))
    print(f"wrote {args.dst}: {n_params:,} parameters, "
          f"{len(distributions)} score distributions")
    return 0


def entrypoint() -> int:
    return main(build_parser().parse_args())


if __name__ == "__main__":
    raise SystemExit(entrypoint())
