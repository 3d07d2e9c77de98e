"""Checkpoints for the torch network: upstream torch tars, the JAX
package's .npz files and parameter trees, and synthesized weights.

The port's module names are the upstream checkpoint's, so an upstream
state dict (`model.tar`, keys 'config', 'model', 'score_distributions')
loads with `load_state_dict(strict=True)` as it is. The JAX package keeps
the same weights as a flax tree in channel-last layout; `flax_layout`
gives, for each key of the port's state dict, the flax path and layout
rule of the same tensor:

  * Linear weight [out, in]        <-> Dense kernel [in, out] (transpose)
  * Conv3d weight [o, i, kd,kh,kw] <-> Conv kernel [kd,kh,kw, i, o]
  * LayerNorm weight               <-> scale
  * BatchNorm weight/running_mean/running_var <-> scale/mean/var
  * Embedding weight               <-> embedding

`state_dict_from_flax` carries a flax tree (as numpy) into the port, for
any `build_model` configuration, and `random_state_dict` draws the same
parameters as the JAX package's `PharmacoNet._random_params`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from .layers import FrozenBatchNorm
from .model import build_model
from .swin3d import WindowAttention

DEPTHS = (2, 6, 2, 2)
NUM_STAGES = 4
EMBED_DIM = 96
NUM_HEADS = (3, 6, 12, 24)
IN_CHANNELS = 33
TOKEN_DIM = 192
NUM_LEVELS = 5
FPN_NUM_CONVS = (1, 2, 2, 2, 2)
EMBED_FPN_CHANNELS = (33, 96, 192, 384, 768)
MASK_FPN_CHANNELS = (96,) * 5

# upstream buffers that are no parameters of the network (the port rebuilds
# its constant tables; BatchNorm's step counter is unused at inference)
NON_PARAMETER_KEYS = re.compile(
    r"(relative_coords_table|relative_position_index|attn_mask|num_batches_tracked)$")

_MODULE_RULES = (
    (r"^embedding\.", ""),
    (r"patch_embed\.(proj|norm)", r"patch_embed_\1"),
    (r"layers\.(\d+)", r"layers_\1"),
    (r"blocks\.(\d+)", r"blocks_\1"),
    (r"lateral_conv_list\.(\d+)", r"lateral_\1"),
    (r"fpn_convs_list\.(\d+)\.(\d+)", r"fpn_\1_\2"),
    (r"(short|long)_head\.0", r"\1_conv"),
    (r"(short|long)_head\.1", r"\1_logit"),
    (r"(^|\.)_conv$", r"\1conv"),
    (r"(^|\.)_norm$", r"\1norm"),
    (r"cpb_mlp\.0", "cpb_fc1"),
    (r"cpb_mlp\.2", "cpb_fc2"),
    (r"(feature|score)_mlp\.(\d+)", lambda m: f"{m[1]}_mlp_{int(m[2]) // 2}"),
    (r"(background|point)_mlp_list\.(\d+)", r"\1_mlp_\2"),
)

_LEAF_NAMES = {
    nn.LayerNorm: {"weight": "scale", "bias": "bias"},
    FrozenBatchNorm: {"weight": "scale", "bias": "bias", "running_mean": "mean",
                      "running_var": "var"},
    nn.Embedding: {"weight": "embedding"},
    WindowAttention: {"logit_scale": "logit_scale", "q_bias": "q_bias", "v_bias": "v_bias"},
}


def _flax_module_path(name: str) -> tuple[str, ...]:
    for pattern, repl in _MODULE_RULES:
        name = re.sub(pattern, repl, name)
    return tuple(p for p in name.split(".") if p)


def flax_layout(model: nn.Module) -> dict[str, tuple[tuple[str, ...], str]]:
    """{state-dict key: (flax path, rule)} with rule 'dense', 'conv' or
    'same', for the whole network or any of its modules (paths relative to
    the flax module of the same name)."""
    out: dict[str, tuple[tuple[str, ...], str]] = {}
    for mname, module in model.named_modules():
        local = list(module.named_parameters(recurse=False)) + [
            (n, b) for n, b in module.named_buffers(recurse=False)
            if n not in module._non_persistent_buffers_set
        ]
        for pname, _ in local:
            key = f"{mname}.{pname}" if mname else pname
            path = _flax_module_path(mname)
            if isinstance(module, (nn.Linear, nn.Conv3d)):
                rule = "same" if pname == "bias" else ("dense" if isinstance(module, nn.Linear)
                                                         else "conv")
                leaf = "bias" if pname == "bias" else "kernel"
                if path[-1] == "qkv":  # WindowAttention keeps its qkv kernel as a leaf
                    path, leaf = path[:-1], "qkv_kernel"
                out[key] = ((*path, leaf), rule)
            else:
                out[key] = ((*path, _LEAF_NAMES[type(module)][pname]), "same")
    return out


def flax_shape(shape: tuple[int, ...], rule: str) -> tuple[int, ...]:
    if rule == "dense":
        return shape[::-1]
    if rule == "conv":
        o, i, *k = shape
        return (*k, i, o)
    return shape


def from_flax(value: np.ndarray, rule: str) -> np.ndarray:
    """Flax layout -> torch layout of one tensor."""
    value = np.asarray(value, dtype=np.float32)
    if rule == "dense":
        return np.ascontiguousarray(value.T)
    if rule == "conv":
        return np.ascontiguousarray(np.transpose(value, (4, 3, 0, 1, 2)))
    return value


def _meta_model(config: dict) -> nn.Module:
    with torch.device("meta"):
        return build_model(**config)


def torch_state_from_flax(module: nn.Module, tree: dict) -> dict[str, torch.Tensor]:
    """The state dict of `module` from the flax tree of its counterpart
    (numpy leaves). Raises when a tensor is missing, has another shape, or
    a flax leaf is left over."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out: dict[str, torch.Tensor] = {}
    for key, (path, rule) in flax_layout(module).items():
        node: Any = tree
        for part in path:
            node = node[part]
        value = from_flax(node, rule)
        if value.shape != shapes[key]:
            raise ValueError(f"{'/'.join(path)}: shape {value.shape} does not fit {key} "
                             f"{shapes[key]}")
        out[key] = torch.from_numpy(value)
    leaves = _count_leaves(tree)
    if len(out) != leaves:
        raise ValueError(f"{leaves - len(out)} flax leaves have no place in the torch module")
    return out


def state_dict_from_flax(params: dict, config: dict | None = None) -> dict[str, torch.Tensor]:
    """The port's state dict from the JAX package's parameter tree (numpy
    leaves, with or without the top-level 'params'), for the network
    `build_model(**config)` builds."""
    return torch_state_from_flax(_meta_model(config or {}), params.get("params", params))


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def random_state_dict(config: dict, seed: int) -> dict[str, torch.Tensor]:
    """The parameters the JAX package draws for `weight_path=None`: its
    flax leaves in sorted path order, ones for names holding 'var' or
    'scale', normal(0, 0.05) from numpy's default_rng(seed) otherwise."""
    model = _meta_model(config)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    out: dict[str, torch.Tensor] = {}
    for key, (path, rule) in sorted(flax_layout(model).items(), key=lambda kv: kv[1][0]):
        shape = flax_shape(shapes[key], rule)
        if "var" in path[-1] or "scale" in path[-1]:
            value = np.ones(shape, dtype=np.float32)
        else:
            value = rng.normal(0.0, 0.05, size=shape).astype(np.float32)
        out[key] = torch.from_numpy(from_flax(value, rule))
    return out


def random_distributions() -> dict[str, np.ndarray]:
    """The sorted uniform score distributions of the JAX package's random init."""
    from ..constants import INTERACTION_LIST

    rng = np.random.default_rng(0)
    return {t: np.sort(rng.uniform(0, 1, size=1000).astype(np.float32))
            for t in INTERACTION_LIST}


# --------------------------------------------------------------------------
# Synthetic torch-format state dict (shape-exact) for runs without weights
# --------------------------------------------------------------------------
def synthesize_torch_state_dict(
    seed: int = 0, weight_scale: float = 1.0
) -> dict[str, np.ndarray]:
    """A random state dict of the published architecture, in the upstream
    checkpoint's keys and layout. weight_scale multiplies every learned
    weight's init std (base 0.05). At 1.0 activations grow ~4x per conv and
    sigmoids saturate; at 0.5 logits collapse towards 0; around 0.7-0.8
    token logits spread over a few units."""
    rng = np.random.default_rng(seed)
    state: dict[str, np.ndarray] = {}

    def add(name: str, *shape: int, scale: float = 0.05) -> None:
        state[name] = rng.normal(0.0, scale * weight_scale, size=shape).astype(
            np.float32
        )

    def add_linear(prefix: str, din: int, dout: int, bias: bool = True) -> None:
        add(f"{prefix}.weight", dout, din)
        if bias:
            add(f"{prefix}.bias", dout)

    def add_conv(prefix: str, cin: int, cout: int, k: int, bias: bool) -> None:
        add(f"{prefix}.weight", cout, cin, k, k, k)
        if bias:
            add(f"{prefix}.bias", cout)

    def add_ln(prefix: str, dim: int) -> None:
        state[f"{prefix}.weight"] = np.ones(dim, dtype=np.float32)
        add(f"{prefix}.bias", dim)

    def add_bn(prefix: str, dim: int) -> None:
        state[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, dim).astype(np.float32)
        add(f"{prefix}.bias", dim)
        add(f"{prefix}.running_mean", dim)
        state[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, dim).astype(np.float32)

    def add_base_conv(prefix: str, cin: int, cout: int, k: int, norm: bool) -> None:
        add_conv(f"{prefix}._conv", cin, cout, k, bias=not norm)
        if norm:
            add_bn(f"{prefix}._norm", cout)

    def add_fpn(prefix: str, channels: tuple[int, ...]) -> None:
        for level in range(NUM_LEVELS - 1):
            add_base_conv(f"{prefix}.lateral_conv_list.{level}", channels[level], 96, 1, True)
        for level in range(NUM_LEVELS):
            cin = channels[level] if level == NUM_LEVELS - 1 else 96
            for j in range(FPN_NUM_CONVS[level]):
                add_base_conv(
                    f"{prefix}.fpn_convs_list.{level}.{j}", cin if j == 0 else 96, 96, 3, True
                )

    # backbone
    add_conv("embedding.backbone.patch_embed.proj", IN_CHANNELS, EMBED_DIM, 2, bias=True)
    add_ln("embedding.backbone.patch_embed.norm", EMBED_DIM)
    for i in range(NUM_STAGES):
        dim = EMBED_DIM * 2**i
        for j in range(DEPTHS[i]):
            p = f"embedding.backbone.layers.{i}.blocks.{j}"
            add_ln(f"{p}.norm1", dim)
            add_ln(f"{p}.norm2", dim)
            state[f"{p}.attn.logit_scale"] = np.full(
                (NUM_HEADS[i], 1, 1), np.log(10.0), dtype=np.float32
            )
            add_linear(f"{p}.attn.qkv", dim, 3 * dim, bias=False)
            add(f"{p}.attn.q_bias", dim)
            add(f"{p}.attn.v_bias", dim)
            add_linear(f"{p}.attn.cpb_mlp.0", 3, 512)
            add_linear(f"{p}.attn.cpb_mlp.2", 512, NUM_HEADS[i], bias=False)
            add_linear(f"{p}.attn.proj", dim, dim)
            add_linear(f"{p}.mlp.fc1", dim, 4 * dim)
            add_linear(f"{p}.mlp.fc2", 4 * dim, dim)
        if i < NUM_STAGES - 1:
            add_linear(f"embedding.backbone.layers.{i}.downsample.reduction", 8 * dim, 2 * dim, bias=False)
            add_ln(f"embedding.backbone.layers.{i}.downsample.norm", 2 * dim)
        add_ln(f"embedding.backbone.norm{i}", EMBED_DIM * 2**i)

    add_fpn("embedding.decoder", EMBED_FPN_CHANNELS)

    add_base_conv("cavity_head.short_head.0", 96, 96, 3, True)
    add_base_conv("cavity_head.short_head.1", 96, 1, 1, False)
    add_base_conv("cavity_head.long_head.0", 96, 96, 3, True)
    add_base_conv("cavity_head.long_head.1", 96, 1, 1, False)

    add("token_head.interaction_embedding.weight", 10, EMBED_DIM, scale=0.5)
    for i in range(3):
        add_linear(f"token_head.feature_mlp.{2 * i}", 192 if i == 0 else TOKEN_DIM, TOKEN_DIM)
        add_linear(
            f"token_head.score_mlp.{2 * i}", TOKEN_DIM, TOKEN_DIM if i < 2 else 1
        )

    add_fpn("mask_head.decoder", MASK_FPN_CHANNELS)
    add_conv("mask_head.conv_logits", 96, 1, 1, bias=True)
    for level in range(NUM_LEVELS):
        add_linear(f"mask_head.background_mlp_list.{level}", TOKEN_DIM, 96)
        add_linear(f"mask_head.point_mlp_list.{level}", TOKEN_DIM, 96)

    return state


# --------------------------------------------------------------------------
# Checkpoint IO
# --------------------------------------------------------------------------
def load_torch_checkpoint(path: str | Path) -> tuple[dict[str, torch.Tensor],
                                                      dict[str, np.ndarray], Any]:
    """An upstream torch tar -> (state dict, score distributions, config).
    Buffers that are no network parameters are dropped; the rest must load
    strictly."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=False)
    state = {k: torch.as_tensor(np.asarray(v, dtype=np.float32))
             for k, v in checkpoint["model"].items() if not NON_PARAMETER_KEYS.search(k)}
    distributions = {
        typ: np.asarray(dist["focus"], dtype=np.float32)
        for typ, dist in checkpoint["score_distributions"].items()
    }
    return state, distributions, checkpoint.get("config")


def save_torch_checkpoint(path: str | Path, state: dict[str, np.ndarray],
                          distributions: dict[str, np.ndarray], config: Any = None) -> None:
    """A torch tar in the upstream layout ('config', 'model',
    'score_distributions' with a 'focus' array per interaction type)."""
    torch.save({
        "config": config,
        "model": {k: torch.from_numpy(np.asarray(v, dtype=np.float32)) for k, v in state.items()},
        "score_distributions": {t: {"focus": np.asarray(d, dtype=np.float32)}
                                for t, d in distributions.items()},
    }, path)


def load_npz_checkpoint(path: str | Path) -> tuple[dict, dict[str, np.ndarray]]:
    """The JAX package's .npz checkpoint -> (flax tree, score distributions)."""
    data = np.load(path)
    params: dict[str, Any] = {}
    score_distributions: dict[str, np.ndarray] = {}
    for key in data.files:
        if key.startswith("D:"):
            score_distributions[key[2:]] = data[key]
            continue
        parts = key[2:].split("/")
        node = params
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = data[key]
    return params, score_distributions
