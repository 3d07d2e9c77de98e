"""Graph neural network blocks of the docking proxies on segment ops.

The torch-geometric GINEConv stacks of both upstream proxies
(tacogfn_reward/proxy.py:277-334, sbddreward/network/ligand_encoder.py:10-84),
as `pharmaconet_tpu`'s `proxy/gnn.py` computes them: message passing on
the flat padded arrays of `data.batch_graphs`, no torch-geometric.

GINEConv (pyg semantics): x_i' = nn((1+eps)*x_i + sum_{j->i} relu(x_j + lin(e_ji)))
with the single-direction edges of `data.py` and nn = Linear + LeakyReLU.
Module names are upstream's (`conv_list.{i}.nn.0`, `.lin`, `.eps`,
`head.0`, ...), so a published state dict loads as it is.

Two reductions:
  * the edge aggregation at `edge_dst` is `index_add_`: on CUDA its order
    of addition is not fixed (atomics), which moves a sum by an ulp at
    most; padding edges carry zero messages;
  * the per-graph readouts (`sorted_segment_sum`) use that `atom_graph` is
    sorted by construction: `torch.segment_reduce` over the contiguous
    segments adds each graph's atoms in atom order, so a graph's sum is the
    same in every batch and on every run, and the padding atoms (segment
    `num_graphs`, last) never enter one. (A float64 prefix sum differenced
    at the bounds, the first design, took 15 ms of a 2048-molecule forward
    on an H100: torch scans the outer dimension of [V, F] one column per
    thread.)
"""

from __future__ import annotations

import torch
from torch import nn

from .data import NUM_ATOM_CLASSES, NUM_ATOM_FEATURES, NUM_BOND_CLASSES, NUM_BOND_FEATURES


def sorted_segment_sum(x: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Rows of `x` summed per segment for ascending `segment_ids`; ids at or
    above `num_segments` (the padding sentinel) are dropped. Deterministic:
    each segment's rows are added in order (`torch.segment_reduce`)."""
    bounds = torch.searchsorted(
        segment_ids, torch.arange(num_segments + 1, device=x.device, dtype=segment_ids.dtype))
    lengths = torch.diff(bounds, append=bounds.new_full((1,), x.shape[0]))
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0)[:num_segments]


class GINEConv(nn.Module):
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.nn = nn.Sequential(nn.Linear(hidden_dim, hidden_dim), nn.LeakyReLU(0.01))
        self.lin = nn.Linear(hidden_dim, hidden_dim)  # pyg's internal edge projection
        self.register_buffer("eps", torch.zeros(1))

    def forward(self, x, edge_src, edge_dst, edge_attr, edge_valid):
        messages = torch.relu(x[edge_src] + self.lin(edge_attr))  # [E, F]
        messages = torch.where(edge_valid[:, None], messages, 0.0)
        agg = torch.zeros_like(x).index_add_(0, edge_dst, messages)
        return self.nn((1.0 + self.eps) * x + agg)


class GraphEncoder(nn.Module):
    """Shared GINE encoder: categorical (TacoGFN, `nn.Embedding`) or dense
    (SBDDReward, `nn.Linear`) inputs.

    forward(batch) takes `tacogfn.graph_batch_to_arrays`' tuple and returns
    (X [V, out_dim] atom features, Z [N, out_dim] graph features) with the
    gated sum/mean readout (ligand_encoder.py:74-84)."""

    def __init__(self, hidden_dim: int = 128, out_dim: int = 256, num_convs: int = 4,
                 categorical: bool = True):
        super().__init__()
        if categorical:
            self.node_layer = nn.Embedding(NUM_ATOM_CLASSES, hidden_dim)
            self.edge_layer = nn.Embedding(NUM_BOND_CLASSES, hidden_dim)
        else:
            self.node_layer = nn.Linear(NUM_ATOM_FEATURES, hidden_dim)
            self.edge_layer = nn.Linear(NUM_BOND_FEATURES, hidden_dim)
        self.conv_list = nn.ModuleList(GINEConv(hidden_dim) for _ in range(num_convs))
        self.head = nn.Sequential(nn.Linear(hidden_dim, out_dim), nn.LayerNorm(out_dim, eps=1e-5))
        self.readout_layer = nn.Linear(2 * hidden_dim, out_dim)
        self.readout_gate = nn.Linear(2 * hidden_dim, out_dim)

    def forward(self, batch):
        (atom_in, atom_graph, atom_valid, edge_src, edge_dst, edge_in, edge_valid,
         num_graphs) = batch
        valid = atom_valid[:, None]
        x = torch.where(valid, self.node_layer(atom_in), 0.0)
        e = self.edge_layer(edge_in)

        skip = x
        for conv in self.conv_list:
            x = torch.where(valid, conv(x, edge_src, edge_dst, e, edge_valid), 0.0)
        x = skip + x
        atom_out = self.head(x)

        z_sum = sorted_segment_sum(x, atom_graph, num_graphs)
        counts = sorted_segment_sum(atom_valid.to(x.dtype)[:, None], atom_graph, num_graphs)
        z = torch.cat([z_sum, z_sum / torch.clamp(counts, min=1.0)], dim=-1)
        return atom_out, self.readout_gate(z) * self.readout_layer(z)
