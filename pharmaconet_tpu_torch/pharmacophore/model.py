"""Serializable pharmacophore model (.pm pickle / .json).

Rebuilds upstream PharmacoNet src/pmnet/pharmacophore_model.py:51-365 with the
IDENTICAL state schema, so `.pm`/`.json` files written by either
implementation load in the other:

    state = {
        "pdbblock": str,
        "nodes": [{index, type, interaction_type, hotspot_position, score,
                   center, radius, neighbor_edge_dict, overlapped_nodes}],
        "edges": [{index, node_indices, edge_type, distance_mean,
                   distance_std}],
        "node_cluster_dict": {type: [{cluster_type, node_indices, node_types,
                                      center, size}]},
        "node_dict": {interaction_type: [node indices]},
    }
"""

from __future__ import annotations

import json
import os
import pickle
from pathlib import Path
from typing import TYPE_CHECKING, Any, Iterable

import numpy as np

from ..constants import (
    GRID_DIM,
    GRID_RESOLUTION,
    INTERACTION_TO_PHARMACOPHORE,
)
from .density_map import DensityMapGraph

if TYPE_CHECKING:
    from ..chem.smallmol import Molecule


class ModelNode:
    def __init__(
        self,
        graph: "PharmacophoreModel",
        index: int,
        type: str,
        interaction_type: str,
        hotspot_position: tuple[float, float, float],
        score: float,
        center: tuple[float, float, float],
        radius: float,
        neighbor_edge_dict: dict[int, int],
        overlapped_nodes: list[int],
    ):
        self.graph = graph
        self.index = index
        self.type = type
        self.interaction_type = interaction_type
        self.hotspot_position = tuple(hotspot_position)
        self.score = score
        self.center = tuple(center)
        self.radius = radius
        self._neighbor_edge_dict = neighbor_edge_dict
        self._overlapped_nodes = overlapped_nodes
        self.neighbor_edge_dict: dict["ModelNode", "ModelEdge"] = {}
        self.overlapped_nodes: list["ModelNode"] = []

    def setup(self) -> None:
        self.neighbor_edge_dict = {
            self.graph.nodes[int(node_index)]: self.graph.edges[int(edge_index)]
            for node_index, edge_index in self._neighbor_edge_dict.items()
        }
        self.overlapped_nodes = [self.graph.nodes[int(i)] for i in self._overlapped_nodes]

    def get_kwargs(self) -> dict[str, Any]:
        return dict(
            index=self.index,
            type=self.type,
            interaction_type=self.interaction_type,
            hotspot_position=self.hotspot_position,
            score=self.score,
            center=self.center,
            radius=self.radius,
            neighbor_edge_dict=self._neighbor_edge_dict,
            overlapped_nodes=self._overlapped_nodes,
        )

    def __hash__(self):
        return self.index

    def __repr__(self):
        return f"ModelNode({self.index})[{self.type}]"


class ModelEdge:
    def __init__(
        self,
        graph: "PharmacophoreModel",
        index: int,
        node_indices: tuple[int, int],
        edge_type: tuple[str, str],
        distance_mean: float,
        distance_std: float,
    ):
        self.graph = graph
        self.index = index
        self.node_indices = tuple(node_indices)
        self.nodes = (graph.nodes[self.node_indices[0]], graph.nodes[self.node_indices[1]])
        self.type = tuple(edge_type)
        self.distance_mean = distance_mean
        self.distance_std = distance_std

    def get_kwargs(self) -> dict[str, Any]:
        return dict(
            index=self.index,
            node_indices=self.node_indices,
            edge_type=self.type,
            distance_mean=self.distance_mean,
            distance_std=self.distance_std,
        )

    def __hash__(self):
        return self.index


class ModelNodeCluster:
    def __init__(
        self,
        graph: "PharmacophoreModel",
        cluster_type: str,
        node_indices: Iterable[int],
        node_types: Iterable[str],
        center: tuple[float, float, float],
        size: float,
    ):
        self.type = cluster_type
        self.node_indices = set(int(i) for i in node_indices)
        self.nodes = {graph.nodes[i] for i in self.node_indices}
        self.node_types = set(node_types)
        self.center = tuple(center)
        self.size = size

    def get_kwargs(self) -> dict[str, Any]:
        return dict(
            cluster_type=self.type,
            node_indices=tuple(self.node_indices),
            node_types=tuple(self.node_types),
            center=self.center,
            size=self.size,
        )

    def __repr__(self):
        return f"ModelCluster({self.type})[{sorted(self.node_indices)}]"


class PharmacophoreModel:
    """Pickle/JSON-friendly pharmacophore graph with scoring entry points."""

    def __init__(self):
        self.pdbblock: str = ""
        self.nodes: list[ModelNode] = []
        self.edges: list[ModelEdge] = []
        self.node_dict: dict[str, list[ModelNode]] = {}
        self.node_cluster_dict: dict[str, list[ModelNodeCluster]] = {}
        self.node_clusters: list[ModelNodeCluster] = []

    # ------------------------------------------------------------------
    @classmethod
    def create(
        cls,
        pdbblock: str,
        center: tuple[float, float, float] | np.ndarray,
        hotspot_infos: list[dict],
        resolution: float = GRID_RESOLUTION,
        size: int = GRID_DIM,
    ) -> "PharmacophoreModel":
        if not isinstance(center, tuple):
            center = tuple(float(v) for v in np.asarray(center).reshape(3).tolist())
        graph = DensityMapGraph(center, resolution, size)
        for info in hotspot_infos:
            pos = info["hotspot_position"]
            pos = tuple(float(v) for v in np.asarray(pos).reshape(3).tolist())
            graph.add_node(info["nci_type"], pos, float(info["hotspot_score"]), info["point_map"])
        graph.setup()

        model = cls()
        model.pdbblock = pdbblock
        model.nodes = [
            ModelNode(
                model,
                node.index,
                INTERACTION_TO_PHARMACOPHORE[node.type],
                node.type,
                node.hotspot_position,
                node.score,
                tuple(float(v) for v in node.center.tolist()),
                node.radius,
                dict(
                    (neighbor_index, edge.index)
                    for neighbor_index, edge in node.neighbor_edge_dict.items()
                ),
                list(node.overlapped_nodes),
            )
            for node in graph.nodes
        ]
        model.edges = [
            ModelEdge(model, e.index, e.node_indices, e.type, e.distance_mean, e.distance_std)
            for e in graph.edges
        ]
        for node in model.nodes:
            node.setup()
        model.node_dict = {
            typ: [model.nodes[node.index] for node in node_list]
            for typ, node_list in graph.node_dict.items()
        }
        model.node_cluster_dict = {
            typ: [
                ModelNodeCluster(
                    model,
                    cluster.type,
                    cluster.node_indices,
                    {INTERACTION_TO_PHARMACOPHORE[graph.nodes[i].type] for i in cluster.node_indices},
                    cluster.center,
                    cluster.size,
                )
                for cluster in cluster_list
            ]
            for typ, cluster_list in graph.node_cluster_dict.items()
        }
        model.node_clusters = []
        for cluster_list in model.node_cluster_dict.values():
            model.node_clusters.extend(cluster_list)
        return model

    # ------------------------------------------------------------------
    def save(self, save_path: str | Path) -> None:
        extension = os.path.splitext(save_path)[-1]
        state = self.__getstate__()
        if extension == ".pm":
            with open(save_path, "wb") as w:
                pickle.dump(state, w)
        elif extension == ".json":
            with open(save_path, "w") as w:
                json.dump(state, w, indent=2)
        else:
            raise NotImplementedError(f"unsupported extension: {extension}")

    @classmethod
    def load(cls, save_path: str | Path) -> "PharmacophoreModel":
        extension = os.path.splitext(save_path)[-1]
        if extension == ".pm":
            with open(save_path, "rb") as f:
                state = pickle.load(f)
        elif extension == ".json":
            with open(save_path) as f:
                state = json.load(f)
        else:
            raise NotImplementedError(f"unsupported extension: {extension}")
        model = cls()
        model.__setstate__(state)
        return model

    def __getstate__(self) -> dict[str, Any]:
        return dict(
            pdbblock=self.pdbblock,
            nodes=[node.get_kwargs() for node in self.nodes],
            edges=[edge.get_kwargs() for edge in self.edges],
            node_cluster_dict={
                typ: [cluster.get_kwargs() for cluster in cluster_list]
                for typ, cluster_list in self.node_cluster_dict.items()
            },
            node_dict={typ: [node.index for node in nodes] for typ, nodes in self.node_dict.items()},
        )

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.pdbblock = state.get("pdbblock", "")
        self.nodes = [ModelNode(self, **kwargs) for kwargs in state["nodes"]]
        self.edges = [ModelEdge(self, **kwargs) for kwargs in state["edges"]]
        for node in self.nodes:
            node.setup()
        self.node_dict = {
            typ: [self.nodes[int(i)] for i in indices] for typ, indices in state["node_dict"].items()
        }
        self.node_cluster_dict = {
            typ: [ModelNodeCluster(self, **kwargs) for kwargs in cluster_list]
            for typ, cluster_list in state["node_cluster_dict"].items()
        }
        self.node_clusters = []
        for cluster_list in self.node_cluster_dict.values():
            self.node_clusters.extend(cluster_list)

    # ------------------------------------------------------------------
    # Scoring entry points (pharmacophore_model.py:60-106)
    # ------------------------------------------------------------------
    def scoring_mol(
        self,
        mol: "Molecule",
        atom_positions: np.ndarray | list[np.ndarray] | None = None,
        conformer_axis: int | None = None,
        weights: dict[str, float] | None = None,
    ) -> float:
        from ..scoring.ligand import Ligand

        ligand = Ligand(mol, atom_positions, conformer_axis)
        return self._scoring(ligand, weights)

    def scoring_file(
        self,
        ligand_file: str | Path,
        weights: dict[str, float] | None = None,
        num_conformers: int | None = None,
    ) -> float:
        from ..scoring.ligand import Ligand

        ligand = Ligand.load_from_file(ligand_file, num_conformers)
        return self._scoring(ligand, weights)

    def scoring_smiles(
        self,
        ligand_smiles: str,
        num_conformers: int,
        weights: dict[str, float] | None = None,
        conformer_engine: str = "auto",
    ) -> float:
        """Score a SMILES string (upstream pharmacophore_model.py:92-99).

        conformer_engine: "rdkit" (upstream's ETKDG path), "dg"
        (in-house distance geometry, no RDKit needed), or "auto".
        """
        from ..scoring.ligand import Ligand

        ligand = Ligand.load_from_smiles(
            ligand_smiles, num_conformers, engine=conformer_engine
        )
        return self._scoring(ligand, weights)

    def _scoring(self, ligand, weights: dict[str, float] | None = None) -> float:
        from ..scoring.graph_match import GraphMatcher

        return GraphMatcher(self, ligand, weights).run()
