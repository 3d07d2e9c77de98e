"""TacoGFN docking-score proxy head (torch).

Upstream tacogfn_reward/proxy.py:39-334, as `pharmaconet_tpu`'s
`proxy/tacogfn.py` computes it: per-scale SiLU + Conv3d(3, no padding)
mean-pools and a token MLP give a pocket cache; a GINE ligand encoder and
an atom x hotspot interaction map with gated pair energies plus a
graph-level bias give affinities. The pyramid arrives channel-last
([1, d, d, d, C], as `PharmacoNet.run_extraction` returns it) and is
permuted once per level for `nn.Conv3d` (a channels-last view, no copy).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .convert import state_dict_from_upstream
from .data import GraphBatch
from .gnn import GraphEncoder, sorted_segment_sum

HIDDEN = 256
TOKEN_DIM = 192
FEATURE_DIM = 96
NUM_SCALES = 5


def pool_levels(convs: nn.ModuleList, levels) -> torch.Tensor:
    """Each SiLU + Conv3d of `convs` on its channel-last level, mean-pooled
    over space: [num_levels * out_channels]."""
    return torch.cat([conv(f.permute(0, 4, 1, 2, 3)).mean((2, 3, 4))[0]
                      for conv, f in zip(convs, levels)], dim=-1)


def pocket_convs(feature_dim: int, hidden_dim: int, num_scales: int) -> nn.ModuleList:
    """Upstream's `pocket_mlp_list`: SiLU + Conv3d(3, no padding) per level."""
    return nn.ModuleList(nn.Sequential(nn.SiLU(), nn.Conv3d(feature_dim, hidden_dim, 3))
                         for _ in range(num_scales))


class TacoAffinityHead(nn.Module):
    """Pocket conditioning + ligand scoring (tacogfn proxy.py:108-274).
    forward is `calculate_affinity`. token_dim, feature_dim and num_scales
    follow the PharmacoNet configuration (published: 192, 96, 5)."""

    def __init__(self, hidden_dim: int = HIDDEN, token_dim: int = TOKEN_DIM,
                 feature_dim: int = FEATURE_DIM, num_scales: int = NUM_SCALES):
        super().__init__()
        h = hidden_dim
        self.hidden_dim = h
        self.token_mlp = nn.Sequential(nn.SiLU(), nn.Linear(token_dim, h))
        self.pocket_mlp_list = pocket_convs(feature_dim, h, num_scales)
        self.pocket_mlp = nn.Sequential(nn.SiLU(), nn.Linear(num_scales * h, h))
        self.concat_layer = nn.Linear(3 * h, h)
        self.concat_gate = nn.Sequential(nn.Linear(3 * h, h), nn.Sigmoid())
        self.ligand_encoder = GraphEncoder(hidden_dim=128, out_dim=256, num_convs=4,
                                           categorical=True)
        self.ligand_layer_atom = nn.Linear(256, h) if h != 256 else None
        self.ligand_layer_graph = nn.Linear(256, h) if h != 256 else None
        self.energy_bias_mlp = nn.Sequential(nn.Linear(2 * h, h), nn.LeakyReLU(0.01),
                                             nn.Linear(h, 1))
        self.interaction_mlp = nn.Sequential(nn.Linear(h, h), nn.LeakyReLU(0.01))
        self.pair_energy_layer = nn.Linear(h, 1)
        self.pair_energy_gate = nn.Sequential(nn.Linear(h, 1), nn.Sigmoid())

    def _pocket(self, multi_scale_features) -> torch.Tensor:
        # top-down pyramid in, the convs take it bottom-up (tacogfn.py:59)
        return self.pocket_mlp(pool_levels(self.pocket_mlp_list, multi_scale_features[::-1]))

    def _condition(self, pocket, token_summary):
        concat = torch.cat([pocket, token_summary], dim=-1)  # [3*hidden]
        return self.concat_layer(concat) * self.concat_gate(concat)

    def ready_to_calculate(self, multi_scale_features, hotspot_features):
        """multi_scale_features: top-down [[1, d, h, w, C] x5] channel-last;
        hotspot_features: [K, token_dim].

        Returns (pocket_features [hidden], hotspot_features [K, hidden])."""
        pocket = self._pocket(multi_scale_features)
        token = self.token_mlp(hotspot_features)  # [K, hidden]
        if token.shape[0] == 0:
            summary = pocket.new_zeros(2 * self.hidden_dim)
        else:
            summary = torch.cat([token.sum(0), token.mean(0)])
        return self._condition(pocket, summary), token

    def ready_to_calculate_masked(self, multi_scale_features, hotspot_features, valid):
        """`ready_to_calculate` on a padded hotspot axis: `valid` [T] marks
        the kept rows of hotspot_features [T, token_dim]; the token summary
        sums and means over them only (no kept row: zeros, the K = 0
        branch). Callers select the kept token rows on the host."""
        pocket = self._pocket(multi_scale_features)
        token = self.token_mlp(hotspot_features)  # [T, hidden]
        w = valid.to(token.dtype)[:, None]
        total = (token * w).sum(0)
        summary = torch.cat([total, total / torch.clamp(w.sum(), min=1.0)])
        return self._condition(pocket, summary), token

    def forward(self, pocket_features, hotspot_features, batch):
        return self.calculate_affinity(pocket_features, hotspot_features, batch)

    def calculate_affinity(self, pocket_features, hotspot_features, batch):
        """pocket_features [hidden]; hotspot_features [K, hidden]; batch =
        graph_batch_to_arrays(...). Returns affinity [N]."""
        x_atoms, z_graphs = self.ligand_encoder(batch)
        return self.affinity_from_encodings(pocket_features, hotspot_features, x_atoms,
                                            z_graphs, batch[1], batch[2], batch[7])

    def affinity_from_encodings(self, pocket_features, hotspot_features, x_atoms, z_graphs,
                                atom_graph, atom_valid, num_graphs):
        """Post-encoder affinity math (proxy.py:256-274)."""
        if self.ligand_layer_atom is not None:
            x_atoms = self.ligand_layer_atom(x_atoms)
            z_graphs = self.ligand_layer_graph(z_graphs)
        # atom x hotspot interaction map: einsum("ik,jk->ijk")
        interaction = self.interaction_mlp(x_atoms[:, None, :] * hotspot_features[None])
        pair = self.pair_energy_layer(interaction) * self.pair_energy_gate(interaction)
        pair = torch.where(atom_valid[:, None, None], pair, 0.0)  # [V, K, 1]
        pair_energy = sorted_segment_sum(pair.sum((1, 2)), atom_graph, num_graphs)
        pocket_rep = pocket_features[None].expand(z_graphs.shape[0], -1)
        bias = self.energy_bias_mlp(torch.cat([pocket_rep, z_graphs], dim=-1))
        return pair_energy + bias[:, 0]


def graph_batch_to_arrays(batch: GraphBatch, categorical: bool = True,
                          device: str | torch.device = "cpu") -> tuple:
    """The encoder's input tuple on `device`: (atom inputs, atom_graph,
    atom_valid, edge_src, edge_dst, edge inputs, edge_valid, num_graphs);
    indices as int64, features as float32."""
    atom_in = batch.atom_class if categorical else batch.atom_features
    edge_in = batch.edge_class if categorical else batch.edge_features

    def dev(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype)

    index = torch.int64
    return (
        dev(atom_in, index if categorical else None),
        dev(batch.atom_graph, index),
        dev(batch.atom_valid),
        dev(batch.edge_src, index),
        dev(batch.edge_dst, index),
        dev(edge_in, index if categorical else None),
        dev(batch.edge_valid),
        batch.num_graphs,
    )


def convert_tacogfn_checkpoint(state: dict) -> dict[str, torch.Tensor]:
    """The port's `TacoAffinityHead` state dict from the upstream
    AffinityHead's (the published `.pth`'s 'model' entry)."""
    with torch.device("meta"):
        model = TacoAffinityHead()
    return state_dict_from_upstream(model, state)
