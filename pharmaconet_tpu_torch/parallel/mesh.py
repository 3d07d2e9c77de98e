"""Device lists: the port's counterpart of the JAX package's 1-D ('data',)
mesh (`pharmaconet_tpu/parallel/mesh.py`).

The network is small and replicated; the scale axis is the batch of
molecules, pockets or training items. A "mesh" is an explicit list of
`torch.device`; each holds one replica and takes a contiguous share of the
batch. The same device may appear several times (the tests pass
`[torch.device("cpu")] * n` to run the sharding logic on the host).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..device import resolve_device


def data_mesh(devices=None) -> list[torch.device]:
    """The devices to shard over: every visible CUDA device by default (none
    visible raises), else `devices`, each resolved as an entry point's."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh() found no CUDA device; pass devices=[...] "
                               "(e.g. [torch.device('cpu')]) to run on the host")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def same_device(a: torch.device, b: torch.device) -> bool:
    """`a` and `b` name one device ('cuda' is the current CUDA device)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


def on_device(obj, device: torch.device):
    """`obj` itself if it lives on `device` (its `.device`), else a shallow
    copy whose modules are deep copies moved to `device` and whose tensor
    attributes are moved there; its `device` is set. A replica shares the
    host state (caches, settings) with `obj`."""
    if obj is None or same_device(obj.device, device):
        return obj
    twin = copy.copy(obj)
    for name, value in vars(obj).items():
        if isinstance(value, torch.nn.Module):
            setattr(twin, name, copy.deepcopy(value).to(device))
        elif isinstance(value, torch.Tensor):
            setattr(twin, name, value.to(device))
    twin.device = device
    return twin


def contiguous_shares(n: int, parts: int) -> list[tuple[int, int]]:
    """[start, stop) bounds of `parts` contiguous shares of n items, the JAX
    package's `np.linspace` split."""
    bounds = np.linspace(0, n, parts + 1).astype(int)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(parts)]


def module_replicas(module: torch.nn.Module, mesh=None) -> list:
    """(replica, device) for each device of `mesh` (None: `module`'s own):
    `module` itself where it already lives, a deep copy moved there
    elsewhere. `sync_replicas` refreshes the copies' tensors."""
    home = next(module.parameters()).device
    mesh = [home] if mesh is None else data_mesh(mesh)
    return [(module if same_device(d, home) else copy.deepcopy(module).to(d), d) for d in mesh]


@torch.no_grad()
def sync_replicas(replicas: list, params: dict[str, torch.Tensor]) -> None:
    """Copy `params` (name -> tensor of the home module) into every replica
    that is a copy."""
    for replica, _ in replicas:
        for name, p in replica.named_parameters():
            if p is not params[name]:
                p.copy_(params[name])


def average_onto(results: list, params: dict[str, torch.Tensor]):
    """(loss, {name: grad}) of each replica's equal share -> their mean loss
    and mean gradients on the devices of `params`; a gradient that is None
    on every replica stays None."""
    home = next(iter(params.values())).device
    loss = torch.stack([r[0].to(home) for r in results]).mean()
    grads = {}
    for name, p in params.items():
        parts = [r[1][name].to(p.device) for r in results if r[1][name] is not None]
        grads[name] = torch.stack(parts).sum(0) / len(results) if parts else None
    return loss, grads
