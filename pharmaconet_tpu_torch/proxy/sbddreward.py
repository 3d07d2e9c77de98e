"""SBDDReward docking proxy (torch): pharmacophore encoder + ComplexFormer.

Upstream sbddreward/{proxy.py,network/}, as `pharmaconet_tpu`'s
`proxy/sbddreward.py` computes it:
  * PharmacophoreEncoder: hotspot MLP (192 -> 128) + per-scale SiLU +
    Conv3d(3) mean-pools -> pocket vector (pharmacophore_encoder.py:9-53)
  * GraphEncoder: dense-featurized GINE (ligand_encoder.py:10-84)
  * AffinityHead ("ComplexFormer"): ligand-atom x hotspot product -> the
    complex tensor; hotspot pairwise-distance one-hot (0-30 A, 16 bins)
    embedding; 3 blocks of triangular multiplicative update + gated
    triangle attention + pair transition; gated sigma sum + bias; per-pocket
    mu in [-15, 0] and std in [0, 5] (head.py:11-97, block.py, layers/).

The complex tensor is the FLAT atom layout [V, K, C] (every real atom of
the batch, not upstream's dense [N, Amax, K, C]): every block op is
independent per atom row, and the per-graph reduction is one segment sum
at the end. All dropout is inference-mode (identity).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .convert import state_dict_from_upstream
from .gnn import GraphEncoder, sorted_segment_sum
from .tacogfn import FEATURE_DIM, NUM_SCALES, TOKEN_DIM, pocket_convs, pool_levels

HIDDEN = 128
PDIST_BINS = 16
PDIST_MAX = 30.0


def one_hot_distance(x: torch.Tensor, bin_min=0.0, bin_max=PDIST_MAX,
                     num_classes=PDIST_BINS) -> torch.Tensor:
    """Binned one-hot (one_hot.py:7-27): bin_size 2, clipped to bin_max + 1;
    in x's dtype."""
    bin_size = int((bin_max - bin_min) / (num_classes - 1))
    x = torch.clamp(x, bin_min, bin_max + bin_size / 2)
    idx = torch.clamp(torch.floor((x - bin_min) / bin_size).long(), 0, num_classes - 1)
    return nn.functional.one_hot(idx, num_classes).to(x.dtype)


def _gated(din: int, dout: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(din, dout), nn.Sigmoid())


def _mlp(din: int, hidden: int, *tail: nn.Module) -> nn.Sequential:
    return nn.Sequential(nn.Linear(din, hidden), nn.LeakyReLU(0.01), nn.Linear(hidden, 1), *tail)


class PharmacophoreEncoder(nn.Module):
    def __init__(self, hidden_dim: int = HIDDEN, token_dim: int = TOKEN_DIM,
                 feature_dim: int = FEATURE_DIM, num_scales: int = NUM_SCALES):
        super().__init__()
        h = hidden_dim
        self.hotspot_mlp = nn.Sequential(nn.SiLU(), nn.Linear(token_dim, h))
        self.pocket_mlp_list = pocket_convs(feature_dim, h, num_scales)
        self.pocket_layer = nn.Sequential(nn.SiLU(), nn.Linear(num_scales * h, h), nn.SiLU(),
                                          nn.Linear(h, h))

    def forward(self, multi_scale_features, hotspot_features, hotspot_positions):
        """multi_scale_features: top-down [[1,d,h,w,C] x5] channel-last (the
        convs take it in that order); hotspot_features [K, token_dim];
        hotspot_positions [K, 3]. Returns (X [K,h], pos [K,3], Z [h])."""
        z = self.pocket_layer(pool_levels(self.pocket_mlp_list, multi_scale_features))
        return self.hotspot_mlp(hotspot_features), hotspot_positions, z


class TriangleMultiplicativeUpdate(nn.Module):
    """Direct triangular update (triangular_multiplicative_update.py:7-34),
    flat-atom layout: the contraction runs over the hotspot axis of each
    atom row."""

    def __init__(self, hidden_dim: int = HIDDEN):
        super().__init__()
        h = hidden_dim
        self.linear_b = nn.Linear(h, h)
        self.linear_b_g = _gated(h, h)
        self.layernorm_z = nn.LayerNorm(h, eps=1e-5)
        self.linear_z = nn.Linear(h, h)
        self.linear_z_g = _gated(h, h)
        self.linear_o = nn.Linear(h, h)
        self.linear_o_g = _gated(h, h)

    def forward(self, z, b, z_mask):
        # z: [V, K, C] flat complex rows; b: [K, K, C]; z_mask: [V]
        bb = self.linear_b(b) * self.linear_b_g(b)
        z = self.layernorm_z(z)
        gated = self.linear_z(z) * self.linear_z_g(z) * z_mask[:, None, None]
        message = torch.einsum("vkc,jkc->vjc", gated, bb)
        return self.linear_o_g(z) * self.linear_o(message) * z_mask[:, None, None]


class _MultiHeadProjections(nn.Module):
    """Upstream's `mha` submodule: the projections of TriangleAttention."""

    def __init__(self, hidden_dim: int, num_heads: int, head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.linear_q = nn.Linear(hidden_dim, inner, bias=False)
        self.linear_k = nn.Linear(hidden_dim, inner, bias=False)
        self.linear_v = nn.Linear(hidden_dim, inner, bias=False)
        self.linear_o = nn.Linear(inner, hidden_dim)
        self.linear_g = nn.Linear(hidden_dim, inner)


class TriangleAttention(nn.Module):
    """Gated multi-head attention over the hotspot axis of each atom row
    (triangular_attention.py:10-188), written as the JAX package's explicit
    einsum, softmax and einsum. Every hotspot is valid, so no key mask."""

    def __init__(self, hidden_dim: int = HIDDEN, num_heads: int = 4):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, hidden_dim // num_heads
        self.layer_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.mha = _MultiHeadProjections(hidden_dim, num_heads, self.head_dim)

    def forward(self, z, mask):
        # z: [V, K, C]; mask: [V] (unused: rows are independent, padding
        # rows are zeroed by the surrounding block)
        x = self.layer_norm(z)
        v_rows, b, _ = x.shape
        nh, hd = self.num_heads, self.head_dim

        def heads(linear):
            return linear(x).reshape(v_rows, b, nh, hd)

        q = heads(self.mha.linear_q) / math.sqrt(hd)
        attn = torch.softmax(torch.einsum("vbhd,vchd->vhbc", q, heads(self.mha.linear_k)), -1)
        out = torch.einsum("vhbc,vchd->vbhd", attn, heads(self.mha.linear_v))
        gate = torch.sigmoid(heads(self.mha.linear_g))
        return self.mha.linear_o((out * gate).reshape(v_rows, b, nh * hd))


class PairTransition(nn.Module):
    def __init__(self, hidden_dim: int = HIDDEN, expand: int = 4):
        super().__init__()
        self.layer_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.linear_1 = nn.Linear(hidden_dim, hidden_dim * expand)
        self.linear_2 = nn.Linear(hidden_dim * expand, hidden_dim)

    def forward(self, z, mask):
        z = self.linear_2(torch.relu(self.linear_1(self.layer_norm(z))))
        return z * mask[:, None, None]


class ComplexFormerBlock(nn.Module):
    def __init__(self, hidden_dim: int = HIDDEN):
        super().__init__()
        self.tri_mul_update = TriangleMultiplicativeUpdate(hidden_dim)
        self.tri_attention = TriangleAttention(hidden_dim)
        self.transition = PairTransition(hidden_dim)

    def forward(self, z, zpair, mask):
        z = z + self.tri_mul_update(z, zpair, mask)
        z = z + self.tri_attention(z, mask)
        return self.transition(z, mask)


class SBDDAffinityHead(nn.Module):
    def __init__(self, hidden_dim: int = HIDDEN, n_blocks: int = 3):
        super().__init__()
        h = hidden_dim
        self.interaction_mlp = nn.Sequential(nn.Linear(h, h), nn.LeakyReLU(0.01))
        self.protein_pair_embedding = nn.Linear(PDIST_BINS, h)
        self.blocks = nn.ModuleList(ComplexFormerBlock(h) for _ in range(n_blocks))
        self.mlp_mu = _mlp(h, h, nn.Sigmoid())
        self.mlp_std = _mlp(h, h, nn.Sigmoid())
        self.mlp_sigma_bias = _mlp(2 * h, h)
        self.mlp_sigma = nn.Linear(h, 1)
        self.gate_sigma = _gated(h, 1)

    def cal_mu(self, z_protein):
        return self.mlp_mu(z_protein).reshape(()) * -15.0

    def cal_std(self, z_protein):
        return self.mlp_std(z_protein).reshape(()) * 5.0

    def cal_sigma(self, x_protein, pos_protein, z_protein, x_ligand, z_ligand,
                  atom_graph, atom_valid, num_graphs):
        """x_protein [K,h], pos_protein [K,3], z_protein [h], x_ligand [V,h],
        z_ligand [N,h]. Returns sigma [N]: the ComplexFormer on the flat
        atom batch [V, K, h], then one segment sum per graph (padding atoms
        sit in the dropped sentinel segment)."""
        mask = atom_valid.to(x_ligand.dtype)  # [V]
        z_complex = self.interaction_mlp(x_ligand[:, None, :] * x_protein[None])
        z_complex = z_complex * mask[:, None, None]

        if x_protein.shape[0] > 0:
            pdist = torch.linalg.vector_norm(pos_protein[:, None, :] - pos_protein[None], dim=-1)
            zpair = self.protein_pair_embedding(one_hot_distance(pdist))  # [K, K, h]
            z0 = z_complex
            for block in self.blocks:
                z_complex = block(z_complex, zpair, mask)
            z_complex = z0 + z_complex

        z_sigma = self.mlp_sigma(z_complex) * self.gate_sigma(z_complex)
        per_atom = (z_sigma[..., 0] * mask[:, None]).sum(-1)  # [V]
        sigma = sorted_segment_sum(per_atom, atom_graph, num_graphs)
        pocket_rep = z_protein[None].expand(z_ligand.shape[0], -1)
        bias = self.mlp_sigma_bias(torch.cat([pocket_rep, z_ligand], -1))
        return sigma + bias[:, 0]


class SBDDRewardNetwork(nn.Module):
    """Pharmacophore encoder + ligand encoder + head (upstream
    _RewardNetwork). forward is `scoring`. token_dim, feature_dim and
    num_scales follow the PharmacoNet configuration (published: 192, 96, 5)."""

    def __init__(self, hidden_dim: int = HIDDEN, token_dim: int = TOKEN_DIM,
                 feature_dim: int = FEATURE_DIM, num_scales: int = NUM_SCALES):
        super().__init__()
        self.pharmacophore_encoder = PharmacophoreEncoder(hidden_dim, token_dim, feature_dim,
                                                          num_scales)
        self.ligand_encoder = GraphEncoder(hidden_dim=hidden_dim, out_dim=hidden_dim,
                                           num_convs=4, categorical=False)
        self.head = SBDDAffinityHead(hidden_dim)

    def get_cache(self, multi_scale_features, hotspot_features, hotspot_positions):
        x, pos, z = self.pharmacophore_encoder(multi_scale_features, hotspot_features,
                                               hotspot_positions)
        return x, pos, z, self.head.cal_mu(z), self.head.cal_std(z)

    def forward(self, cache, batch, return_sigma: bool = False):
        return self.scoring(cache, batch, return_sigma)

    def scoring(self, cache, batch, return_sigma: bool = False):
        x_protein, pos_protein, z_protein, mu, std = cache
        x_ligand, z_ligand = self.ligand_encoder(batch)
        sigma = self.head.cal_sigma(x_protein, pos_protein, z_protein, x_ligand, z_ligand,
                                    batch[1], batch[2], batch[7])
        return sigma if return_sigma else sigma * std + mu


def convert_sbddreward_checkpoint(state: dict) -> dict[str, torch.Tensor]:
    """The port's `SBDDRewardNetwork` state dict from the upstream
    _RewardNetwork's (the published `.pth`)."""
    with torch.device("meta"):
        model = SBDDRewardNetwork()
    return state_dict_from_upstream(model, state)
