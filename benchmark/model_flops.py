"""The detector's model operations, counted from the configuration's
shapes: every multiply-add of its matrix products and convolutions, as
two f32 operations, and nothing of how the program lays the work out.

  * trunk, once a pocket: patch embed; per Swin block the qkv, projection
    and MLP products, attention's two products over each window, and the
    position-bias MLP over its table; patch merging; every convolution of
    the embedding FPN;
  * heads, once a pocket: the cavity head's convolutions at full
    resolution, the token MLPs over the pocket's tokens (not the padding
    a program adds);
  * the mask head, once a kept hotspot (as the reference keeps them, not
    the chunk padding): its embedding MLPs, its FPN and the logit
    convolution.

Element-wise work (norms, softmax, activations, smoothing) and the
voxelizer are not model operations and are not counted.

`record_pass` keeps what the route's check counted of the run's passes
(how many, the items they modelled, the operations of one), and
`window_ops` and `modeled_items` hand it to the metrics' readers: the
harness's records of an untraced run carry no `work`, and a reader finds
the run's own count by its passes and items. A run of another route
records nothing here, and these readers read None in it.
"""

from __future__ import annotations

from detector_reference import widths

_RECORD: dict[str, int] = {}


def _linear(n: int, din: int, dout: int) -> int:
    return 2 * n * din * dout


def _conv(out_voxels: int, cin: int, cout: int, k: int) -> int:
    return 2 * out_voxels * cin * cout * k ** 3


def fpn_ops(channels: tuple, resolutions: tuple, fpn: int, convs: tuple) -> int:
    n, ops = len(channels), 0
    for level in range(n):
        vox = resolutions[level] ** 3
        if level < n - 1:
            ops += _conv(vox, channels[level], fpn, 1)
        for j in range(convs[level]):
            ops += _conv(vox, channels[level] if (level == n - 1 and j == 0) else fpn, fpn, 3)
    return ops


def trunk_ops(cfg: dict) -> int:
    W = widths(cfg)
    res = W["grid"] // 2
    ops = _conv(res ** 3, W["cin"], W["dim"], 2)
    dims, resolutions = [], [W["grid"]]
    for i, depth in enumerate(W["depths"]):
        dim, length = W["dim"] * 2 ** i, res ** 3
        window = min(W["window"], res)
        n, table = window ** 3, (2 * window - 1) ** 3
        block = (_linear(length, dim, 3 * dim) + _linear(length, dim, dim)
                 + _linear(length, dim, 4 * dim) + _linear(length, 4 * dim, dim)
                 + 4 * length * n * dim
                 + _linear(table, 3, 512) + _linear(table, 512, W["heads"][i]))
        ops += depth * block
        dims.append(dim)
        resolutions.append(res)
        if i < len(W["depths"]) - 1:
            ops += _linear(length // 8, 8 * dim, 2 * dim)
            res //= 2
    return ops + fpn_ops((W["cin"], *dims), tuple(resolutions), W["fpn"], W["convs"])


def heads_ops(cfg: dict, tokens: int) -> int:
    W = widths(cfg)
    vox = W["grid"] ** 3
    cavity = 2 * (_conv(vox, W["fpn"], W["fpn"], 3) + _conv(vox, W["fpn"], 1, 1))
    tok = (_linear(tokens, 2 * W["fpn"], W["tok"]) + 2 * _linear(tokens, W["tok"], W["tok"])
           + 2 * _linear(tokens, W["tok"], W["tok"]) + _linear(tokens, W["tok"], 1))
    if 2 * W["fpn"] != W["tok"]:
        tok += _linear(tokens, 2 * W["fpn"], W["tok"])
    return cavity + tok


def hotspot_ops(cfg: dict) -> int:
    W = widths(cfg)
    resolutions = tuple(W["grid"] // 2 ** level for level in range(W["levels"]))
    return (2 * W["levels"] * _linear(1, W["tok"], W["fpn"])
            + fpn_ops((W["fpn"],) * W["levels"], resolutions, W["fpn"], W["convs"])
            + _conv(W["grid"] ** 3, W["fpn"], 1, 1))


def pocket_ops(cfg: dict, tokens: int, kept: int) -> int:
    """One pocket's model operations: trunk, heads over `tokens` tokens,
    and the mask head over `kept` hotspots."""
    return trunk_ops(cfg) + heads_ops(cfg, tokens) + kept * hotspot_ops(cfg)


def record_pass(passes: int, items: int, ops: int) -> None:
    """The run's passes and items, and one pass's model operations."""
    _RECORD.clear()
    _RECORD.update(passes=int(passes), items=int(items), ops=int(ops))


def _recorded(records) -> bool:
    return bool(_RECORD) and (_RECORD["passes"], _RECORD["items"]) == (
        records["passes"], records["items"])


def window_ops(records) -> int | None:
    """The window's model operations, where this run's check counted them."""
    return _RECORD["ops"] * records["passes"] if _recorded(records) else None


def modeled_items(records) -> int | None:
    """The items the window's passes modelled, where this run's check
    counted them."""
    return records["items"] if _recorded(records) else None
