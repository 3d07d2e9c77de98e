"""Graph matcher: ligand pharmacophore graph vs model graph.

Rebuilds upstream PharmacoNet src/pmnet/scoring/graph_match.py:43-279:
cluster-level candidate matching by type overlap, priority-sorted ligand
clusters capped at 20, precomputed pairwise score tables, DFS assignment
tree, final score = mean over conformers of the best leaf.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from ..constants import DEFAULT_WEIGHTS, MAX_MATCH_DEPTH
from .ligand import Ligand, LigandNodeCluster
from .match_kernels import scoring_matching_pair, scoring_matching_self
from .tree import ClusterMatchTreeRoot


def priority_fn(cluster: LigandNodeCluster):
    """Sort key for ligand clusters (graph_match.py:43-60)."""
    size_priority = -len(cluster.nodes)
    atom_index = min(cluster.nodes[0].atom_indices)
    ctype = cluster.type
    if ctype.startswith("Aromatic"):
        return (0, size_priority, 0, atom_index)
    if ctype.startswith("Cation"):
        return (0, size_priority, 1, atom_index)
    if ctype.startswith("Anion"):
        return (0, size_priority, 2, atom_index)
    if ctype.startswith("HBond"):
        return (1, size_priority, 0, atom_index)
    if ctype.startswith("Halogen"):
        return (1, size_priority, 1, atom_index)
    if ctype.startswith("Hydrophobic"):
        return (1, size_priority, 2, atom_index)
    raise NotImplementedError(ctype)


class GraphMatcher:
    def __init__(self, model, ligand: Ligand, weights: dict[str, float] | None = None):
        self.model_graph = model
        self.ligand_graph = ligand.graph
        self.num_conformers = self.ligand_graph.num_conformers
        self.weights = dict(DEFAULT_WEIGHTS)
        if weights is not None:
            self.weights.update(weights)

    # ------------------------------------------------------------------
    def run(self) -> float:
        if len(self.ligand_graph.node_clusters) == 0:
            return 0.0
        self.setup()
        if len(self.ligand_cluster_list) == 0:
            return 0.0
        root = self.run_tree()
        scores = np.zeros(self.num_conformers)
        for leaf in root.iteration_leaf():
            for conf, score in leaf.pair_scores.items():
                if score > scores[conf]:
                    scores[conf] = score
        return float(np.mean(scores))

    def setup(self) -> None:
        self.cluster_match_dict = self._get_cluster_match_dict()
        self.ligand_cluster_list = sorted(self.cluster_match_dict.keys(), key=priority_fn)
        self.ligand_cluster_list = self.ligand_cluster_list[:MAX_MATCH_DEPTH]
        self.node_match_dict = self._get_node_match_dict()
        self.matching_pair_scores_dict = self._get_pair_scores()

    def run_tree(self) -> ClusterMatchTreeRoot:
        root = ClusterMatchTreeRoot(
            self.ligand_cluster_list,
            self.cluster_match_dict,
            self.matching_pair_scores_dict,
            self.num_conformers,
        )
        root.run()
        return root

    # ------------------------------------------------------------------
    def _get_cluster_match_dict(self):
        out = {}
        for ligand_cluster in self.ligand_graph.node_clusters:
            matches = [
                model_cluster
                for model_cluster in self.model_graph.node_clusters
                if ligand_cluster.node_types & model_cluster.node_types
            ]
            if matches:
                out[ligand_cluster] = matches
        return out

    def _get_node_match_dict(self):
        """(ligand cluster, model cluster) -> [(ligand node, model nodes,
        weights)] with un-matchable ligand nodes dropped."""
        out = {}
        for ligand_cluster, model_clusters in self.cluster_match_dict.items():
            for model_cluster in model_clusters:
                matches = []
                for ligand_node in ligand_cluster.nodes:
                    model_nodes = [
                        node for node in model_cluster.nodes if node.type in ligand_node.types
                    ]
                    if model_nodes:
                        weights = np.array(
                            [self.weights[node.type] for node in model_nodes],
                            dtype=np.float32,
                        )
                        matches.append((ligand_node, model_nodes, weights))
                out[(ligand_cluster, model_cluster)] = matches
        return out

    def _get_pair_scores(self):
        """Precompute all (ligand pair) x (model pair) score tuples."""
        no_match = (-1.0,) * self.num_conformers
        table = {}
        for lc1, lc2 in itertools.combinations_with_replacement(self.ligand_cluster_list, 2):
            inner = {}
            if lc1 is lc2:
                for mc in self.cluster_match_dict[lc1]:
                    inner[(mc, mc)] = scoring_matching_self(
                        self.node_match_dict[(lc1, mc)], self.num_conformers
                    )
            else:
                lig_dist = np.linalg.norm(lc1.center - lc2.center, axis=-1)  # [C]
                lig_size = lc1.size + lc2.size  # [C]
                for mc1, mc2 in itertools.product(
                    self.cluster_match_dict[lc1], self.cluster_match_dict[lc2]
                ):
                    (x1, y1, z1), (x2, y2, z2) = mc1.center, mc2.center
                    model_dist = math.sqrt(
                        (x1 - x2) ** 2 + (y1 - y2) ** 2 + (z1 - z2) ** 2
                    )
                    model_size = mc1.size + mc2.size
                    # geometric feasibility prune (graph_match.py:267)
                    if np.min(np.abs(lig_dist - model_dist) - lig_size) > model_size:
                        inner[(mc1, mc2)] = no_match
                    else:
                        inner[(mc1, mc2)] = scoring_matching_pair(
                            self.node_match_dict[(lc1, mc1)],
                            self.node_match_dict[(lc2, mc2)],
                            self.num_conformers,
                        )
            table[(lc1, lc2)] = inner
        return table
