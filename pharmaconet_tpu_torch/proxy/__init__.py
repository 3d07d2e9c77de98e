"""Docking proxies: downstream heads on frozen PharmacoNet features.

Upstream pmnet_appl (the proxy registry, the TacoGFN and SBDDReward
proxies, the target-cache protocol) on one torch device, held against
`pharmaconet_tpu.proxy`.
"""

from .base import BaseProxy, load_cache_keys
from .data import batch_graphs, mol_to_graph, smi2graph
from .proxies import SBDDReward_Proxy, TacoGFN_Proxy, get_docking_proxy

__all__ = [
    "BaseProxy",
    "load_cache_keys",
    "batch_graphs",
    "mol_to_graph",
    "smi2graph",
    "SBDDReward_Proxy",
    "TacoGFN_Proxy",
    "get_docking_proxy",
]
