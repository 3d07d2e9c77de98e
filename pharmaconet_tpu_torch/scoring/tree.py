"""DFS assignment tree over (ligand cluster → model cluster) matches.

Rebuilds upstream PharmacoNet src/pmnet/scoring/tree.py:15-227. The tree assigns
each ligand cluster (in priority order) to a candidate model cluster or to
None, accumulating per-conformer scores:

  * each level keeps only conformers whose pairwise score with EVERY chosen
    ancestor is > 0 (pruning, tree.py:78-84)
  * a node's accumulated score adds the candidate's self-pair score plus its
    cross-pair scores against all ancestors
  * the None branch is taken when no candidate survives or when the best
    completable match count would stay below 5 (tree.py:98-101)
"""

from __future__ import annotations

from typing import Iterator

from ..constants import MIN_MATCHES_FOR_SKIP


class ClusterMatchTree:
    def __init__(self, model_cluster, pair_scores: dict[int, float] | None, parent):
        self.level: int = parent.level + 1
        self.num_matches: int = parent.num_matches + (model_cluster is not None)
        self.parent = parent
        self.root: "ClusterMatchTreeRoot" = parent.root
        self.children: list["ClusterMatchTree"] = []
        self.ligand_cluster = self.root.ligand_cluster_list[self.level]
        self.model_cluster = model_cluster

        if model_cluster is not None:
            assert pair_scores is not None
            self_scores = self.root.matching_pair_scores_dict[
                (self.ligand_cluster, self.ligand_cluster)
            ][(model_cluster, model_cluster)]
            self.pair_scores = {
                conf: parent.pair_scores[conf] + self_scores[conf] + score
                for conf, score in pair_scores.items()
            }
        else:
            self.pair_scores = parent.pair_scores

    @property
    def max_score(self) -> float:
        if self.num_matches == 0:
            return 0.0
        return max(self.pair_scores.values())

    def dfs_run(self, match_dict) -> int:
        """match_dict: {ligand_cluster: {model_cluster: {conf: accum_score}}}
        holding cross-pair accumulations against all chosen ancestors."""
        if self.model_cluster is not None:
            upd: dict = {}
            for ligand_cluster, model_cluster_dict in match_dict.items():
                pair_table = self.root.matching_pair_scores_dict[
                    (self.ligand_cluster, ligand_cluster)
                ]
                upd_mc = {}
                for model_cluster, conf_scores in model_cluster_dict.items():
                    pair_scores = pair_table[(self.model_cluster, model_cluster)]
                    kept = {
                        conf: total + pair_scores[conf]
                        for conf, total in conf_scores.items()
                        if conf in self.pair_scores and pair_scores[conf] > 0
                    }
                    if kept:
                        upd_mc[model_cluster] = kept
                upd[ligand_cluster] = upd_mc
            match_dict = upd
        else:
            match_dict = dict(match_dict)

        if self.level < len(self.root.ligand_cluster_list) - 1:
            child_cluster = self.root.ligand_cluster_list[self.level + 1]
            model_cluster_dict = match_dict.pop(child_cluster)
            max_matches = 0
            for model_cluster, conf_scores in model_cluster_dict.items():
                child = self._add_child(model_cluster, conf_scores)
                max_matches = max(child.dfs_run(match_dict), max_matches)
            if not model_cluster_dict or (self.num_matches + max_matches) < MIN_MATCHES_FOR_SKIP:
                child = self._add_child(None, None)
                max_matches = max(child.dfs_run(match_dict), max_matches)
            return max_matches + int(self.model_cluster is not None)
        return int(self.model_cluster is not None)

    def _add_child(self, model_cluster, pair_scores):
        child = ClusterMatchTree(model_cluster, pair_scores, self)
        self.children.append(child)
        return child

    def iteration_leaf(self) -> Iterator["ClusterMatchTree"]:
        if self.children:
            for child in self.children:
                yield from child.iteration_leaf()
        else:
            yield self

    @property
    def item(self) -> dict:
        """Assignment {ligand_cluster: model_cluster|None} along this path."""
        node, out = self, {}
        while node is not self.root:
            out[node.ligand_cluster] = node.model_cluster
            node = node.parent
        return out


class ClusterMatchTreeRoot(ClusterMatchTree):
    def __init__(
        self,
        ligand_cluster_list,
        cluster_match_dict,
        matching_pair_scores_dict,
        num_conformers: int,
    ):
        self.root = self
        self.level = -1
        self.num_matches = 0
        self.num_conformers = num_conformers
        self.children = []
        self.ligand_cluster_list = ligand_cluster_list
        self.cluster_match_dict = cluster_match_dict
        self.matching_pair_scores_dict = matching_pair_scores_dict
        self.model_cluster = None
        self.ligand_cluster = None
        self.pair_scores = {conf: 0.0 for conf in range(num_conformers)}

    def run(self) -> None:
        match_dict = {
            ligand_cluster: {
                model_cluster: {conf: 0.0 for conf in range(self.num_conformers)}
                for model_cluster in self.cluster_match_dict[ligand_cluster]
            }
            for ligand_cluster in self.ligand_cluster_list
        }
        self.dfs_run(match_dict)
