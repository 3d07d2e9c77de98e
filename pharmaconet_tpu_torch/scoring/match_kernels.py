"""Pair-scoring kernels: Gaussian likelihood over conformer distances.

Vectorized numpy implementation with the semantics of the reference's
production numba kernels (upstream PharmacoNet src/pmnet/scoring/
match_utils_numba.py:12-151) — chosen over the numpy fallback's subtly
different thresholds (match_utils.py:22,57) and documented here:

  * per (m, n) match: sigma_sq = ((d - mu)/std)^2; pass iff sigma_sq < 4.0
  * a (ligand-node-pair) block fails a conformer iff
        num_pass < (M*N + 1) // 2
  * a cluster pair returns -1 for a conformer iff
        num_fails > L1 * L2 * 0.5
  * score contribution per block: sum_mn w1_m w2_n / std exp(-sigma_sq/2)
        normalized by (W1*W2) and scaled by (W1*W2)/(M*N)  (net: 1/(M*N))

The batched device screening (batch_screen.py, ops/) evaluates the same math
on flat tensors; these functions are the ground truth it is tested against.
"""

from __future__ import annotations

import itertools

import numpy as np

SIGMA_SQ_PASS = 4.0


def _pair_mean_stds(model_node_list1, model_node_list2) -> np.ndarray:
    """[M, N, 2] edge (mean, std) table from the model graph."""
    out = np.empty((len(model_node_list1), len(model_node_list2), 2), dtype=np.float32)
    for i, n1 in enumerate(model_node_list1):
        for j, n2 in enumerate(model_node_list2):
            edge = n1.neighbor_edge_dict[n2]
            out[i, j, 0] = edge.distance_mean
            out[i, j, 1] = edge.distance_std
    return out


def _block_score(
    distances: np.ndarray,  # [C]
    mean_stds: np.ndarray,  # [M, N, 2]
    weights1: np.ndarray,  # [M]
    weights2: np.ndarray,  # [N]
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (scores [C], passed [C] bool) for one ligand-node-pair block."""
    mu = mean_stds[..., 0][None]  # [1, M, N]
    std = mean_stds[..., 1][None]
    d = distances[:, None, None]  # [C, 1, 1]
    sigma_sq = ((d - mu) / std) ** 2  # [C, M, N]
    w = (weights1[:, None] * weights2[None, :])[None]  # [1, M, N]
    likelihood = np.sum(w / std * np.exp(-0.5 * sigma_sq), axis=(1, 2))  # [C]
    num_match = mean_stds.shape[0] * mean_stds.shape[1]
    scores = likelihood / num_match  # normalize_coeff * score_coeff net effect
    num_pass = np.sum(sigma_sq < SIGMA_SQ_PASS, axis=(1, 2))
    passed = num_pass >= (num_match + 1) // 2
    return scores.astype(np.float32), passed


def scoring_matching_pair(
    cluster_node_match_list1,
    cluster_node_match_list2,
    num_conformers: int,
) -> tuple[float, ...]:
    """Score a (ligand cluster, ligand cluster) x (model cluster, model
    cluster) assignment over all conformers; -1 marks failed conformers.

    Each element of a match list is (ligand_node, model_node_list, weights).
    """
    match_threshold = (
        len(cluster_node_match_list1) * len(cluster_node_match_list2) * 0.5
    )
    scores = np.zeros(num_conformers, dtype=np.float32)
    fails = np.zeros(num_conformers, dtype=np.int32)
    for lnode1, mnodes1, w1 in cluster_node_match_list1:
        for lnode2, mnodes2, w2 in cluster_node_match_list2:
            distances = lnode1.neighbor_edge_dict[lnode2].distances
            mean_stds = _pair_mean_stds(mnodes1, mnodes2)
            block_scores, passed = _block_score(distances, mean_stds, w1, w2)
            scores += block_scores
            fails += ~passed
            if fails.min() > match_threshold:
                return (-1.0,) * num_conformers
    return tuple(
        float(s) if f <= match_threshold else -1.0 for s, f in zip(scores, fails)
    )


def scoring_matching_self(
    cluster_node_match_list,
    num_conformers: int,
) -> tuple[float, ...]:
    """Intra-cluster score: pairs of distinct ligand nodes, no fail counting."""
    scores = np.zeros(num_conformers, dtype=np.float32)
    for match1, match2 in itertools.combinations(cluster_node_match_list, 2):
        lnode1, mnodes1, w1 = match1
        lnode2, mnodes2, w2 = match2
        distances = lnode1.neighbor_edge_dict[lnode2].distances
        mean_stds = _pair_mean_stds(mnodes1, mnodes2)
        block_scores, _ = _block_score(distances, mean_stds, w1, w2)
        scores += block_scores
    return tuple(float(s) for s in scores)
