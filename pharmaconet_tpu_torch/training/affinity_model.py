"""Trainable affinity model on frozen PharmacoNet features (torch).

Upstream developer/src/model.py:15-61 + developer/src/network/, as
`pharmaconet_tpu/training/affinity_model.py` computes it: the frozen
trunk's pyramid and hotspot features feed a trainable PharmacophoreEncoder
+ GraphEncoder (dense atom features) + an interaction-sum head; the loss
is a per-pocket MSE over the ligand batch against capped affinities.

Every tensor of the state dict is trained, as every leaf of the flax tree
is, GINE's `eps` included (a buffer of `proxy.gnn.GINEConv`, so the
trainer updates state-dict tensors through `torch.func.functional_call`,
not `parameters()`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..proxy.gnn import GraphEncoder, sorted_segment_sum
from ..proxy.sbddreward import PharmacophoreEncoder
from ..proxy.tacogfn import FEATURE_DIM, NUM_SCALES, TOKEN_DIM


class DevAffinityHead(nn.Module):
    """Interaction-sum head (developer/src/network/head.py:6-43) on the
    flat atom batch [V, K, h]: padded atoms sit in the sentinel segment of
    `atom_graph` and are dropped by the per-graph segment sum; pairs with a
    padded hotspot (`hotspot_valid` False) are left out of each atom's sum.

    The JAX head sums every hotspot column: a padded one has a zero protein
    row, but its pair energy is the MLP of zero, fc2(leaky(fc1(leaky(b)))),
    which is 0 only while the biases are (flax's init) and so enters the
    predictions once a step has moved them."""

    def __init__(self, hidden_dim: int = 128):
        super().__init__()
        self.interaction_fc = nn.Linear(hidden_dim, hidden_dim)
        self.affinity_fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.affinity_fc2 = nn.Linear(hidden_dim, 1)

    def forward(self, x_protein, x_ligand, atom_graph, atom_valid, num_graphs,
                hotspot_valid=None):
        z = x_ligand[:, None, :] * x_protein[None]  # einsum("ik,jk->ijk"): [V, K, h]
        z = F.leaky_relu(self.interaction_fc(z), 0.01)
        z = F.leaky_relu(self.affinity_fc1(z), 0.01)
        pair = self.affinity_fc2(z)[..., 0]  # [V, K]
        mask = atom_valid[:, None]
        if hotspot_valid is not None:
            mask = mask & hotspot_valid[None, :]
        per_atom = (pair * mask.to(pair.dtype)).sum(-1)  # [V]
        return sorted_segment_sum(per_atom, atom_graph, num_graphs)


class DevAffinityModel(nn.Module):
    """The trainable modules; PharmacoNet features arrive precomputed.
    token_dim, feature_dim and num_scales follow the PharmacoNet
    configuration (published: 192, 96, 5)."""

    def __init__(self, hidden_dim: int = 128, ligand_num_convs: int = 4,
                 token_dim: int = TOKEN_DIM, feature_dim: int = FEATURE_DIM,
                 num_scales: int = NUM_SCALES):
        super().__init__()
        self.pharmacophore_encoder = PharmacophoreEncoder(hidden_dim, token_dim, feature_dim,
                                                          num_scales)
        self.ligand_encoder = GraphEncoder(hidden_dim=hidden_dim, out_dim=hidden_dim,
                                           num_convs=ligand_num_convs, categorical=False)
        self.head = DevAffinityHead(hidden_dim)

    def forward(self, multi_scale_features, hotspot_features, hotspot_positions, batch_arrays,
                hotspot_valid=None):
        """Predicted affinities [num_graphs]. hotspot_valid ([K] bool) masks
        padded hotspot rows exactly: their protein rows are zeroed, as in
        the JAX model, and the head leaves their pairs out of its sum, so
        the prediction does not depend on the hotspot bucket.

        Of the pharmacophore encoder only the hotspot rows reach the
        prediction: its pocket vector (the convolutions over
        `multi_scale_features`) is not computed, as XLA drops it from the
        JAX model's jitted step; `hotspot_positions` is unused there too."""
        x_protein = self.pharmacophore_encoder.hotspot_mlp(hotspot_features)
        if hotspot_valid is not None:
            x_protein = torch.where(hotspot_valid[:, None], x_protein, 0.0)
        x_ligand, _ = self.ligand_encoder(batch_arrays)
        return self.head(x_protein, x_ligand, batch_arrays[1], batch_arrays[2], batch_arrays[7],
                         hotspot_valid)

    def loss(self, multi_scale_features, hotspot_features, hotspot_positions, batch_arrays,
             affinities, ligand_valid, hotspot_valid=None):
        """sum(err * ligand_valid) / max(sum(ligand_valid), 1), err the
        squared error of each graph's prediction."""
        pred = self(multi_scale_features, hotspot_features, hotspot_positions, batch_arrays,
                    hotspot_valid)
        err = (pred - affinities) ** 2
        return (err * ligand_valid).sum() / torch.clamp(ligand_valid.sum(), min=1.0)
