"""Ligand pharmacophore graph for scoring.

Rebuilds upstream PharmacoNet src/pmnet/scoring/ligand.py:16-473 on the
dependency-free Molecule model:

  * nodes = perceived pharmacophore features, deduplicated by atom-index set
    (a node may carry several types, e.g. donor+acceptor oxygen)
  * multi-conformer node positions [N_conf, 3] and fully-connected edges with
    per-conformer distances
  * functional-group grouping (nodes hanging off the same neighbor atom,
    connected hydrophobic patches)
  * dependence rules: hydrophobic ⊂ aromatic ring; HBond ⊂ charged group
  * clustering with priority (high: Aromatic/Cation/Anion/Halogen; low:
    Hydrophobic/HBond_*), dependent nodes joining their anchor's cluster
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from ..chem.ligand_perception import get_pharmacophore_nodes
from ..chem.smallmol import Molecule, load_molecules


class Ligand:
    def __init__(
        self,
        mol: Molecule,
        atom_positions: np.ndarray | list[np.ndarray] | None = None,
        conformer_axis: int | None = None,
    ):
        """mol: H-stripped or raw Molecule (H will be stripped).

        atom_positions:
          * None — use mol.coords as the single conformer
          * list of [N_atoms, 3] arrays — one per conformer
          * ndarray [N_conf, N_atoms, 3] (conformer_axis in (0, None))
            or [N_atoms, N_conf, 3] (conformer_axis == 1)
        """
        self.mol = mol.strip_hydrogens() if any(a.atomic_num == 1 for a in mol.atoms) else mol
        self.num_atoms = self.mol.num_atoms
        self.num_rotatable_bonds = self.mol.num_rotatable_bonds()

        if atom_positions is None:
            assert self.mol.coords is not None, "molecule has no coordinates"
            positions = self.mol.coords[:, None, :]
        elif isinstance(atom_positions, list):
            positions = np.stack(atom_positions, axis=1).astype(np.float32)
        else:
            positions = np.asarray(atom_positions, dtype=np.float32)
            if conformer_axis in (0, None):
                positions = np.ascontiguousarray(np.moveaxis(positions, 0, 1))
        assert positions.shape[0] == self.num_atoms
        self.atom_positions = positions  # [N_atoms, N_conf, 3]
        self.num_conformers = positions.shape[1]

        self.pharmacophore_nodes = get_pharmacophore_nodes(self.mol)
        self.pharmacophore_list = [
            (typ, node)
            for typ, node_list in self.pharmacophore_nodes.items()
            for node in node_list
        ]
        self.graph = LigandGraph(self)

    @classmethod
    def load_from_file(cls, filename: str | Path, num_conformers: int | None = None) -> "Ligand":
        """Successive molecules in the file are conformers (ligand.py:63-84)."""
        mols = load_molecules(filename, max_mols=num_conformers)
        assert mols, f"no molecules parsed from {filename}"
        stripped = [m.strip_hydrogens() for m in mols]
        base = stripped[0]
        positions = []
        for m in stripped:
            assert m.num_atoms == base.num_atoms, "conformer atom-count mismatch"
            positions.append(m.coords)
        return cls(base, positions)

    @classmethod
    def load_from_smiles(
        cls, smiles: str, num_conformers: int, engine: str = "auto"
    ) -> "Ligand":
        """Embed conformers from SMILES (upstream ligand.py:87-107).

        engine:
          * "rdkit" — RDKit srETKDGv3, exactly upstream's path
            (raises ImportError if RDKit is absent);
          * "dg" — the in-house distance-geometry embedder
            (chem/embed.py; no external dependency);
          * "auto" — RDKit when importable, otherwise "dg".
        """
        if engine not in ("auto", "rdkit", "dg"):
            raise ValueError(f"unknown conformer engine {engine!r}")
        if engine != "dg":
            try:
                return cls._load_from_smiles_rdkit(smiles, num_conformers)
            except ImportError:
                if engine == "rdkit":
                    raise
        return cls.from_smiles_dg(smiles, num_conformers)

    @classmethod
    def from_smiles_dg(
        cls, smiles: str, num_conformers: int, seed: int = 2025
    ) -> "Ligand":
        """In-house distance-geometry path (chem/embed.py), no RDKit.

        Strips explicit [H] atoms BEFORE embedding: the embedder only
        places heavy atoms, so the coords must be assigned to the
        stripped molecule or the conformer array misaligns."""
        from ..chem.embed import embed_conformers
        from ..chem.smiles import parse_smiles

        mol = parse_smiles(smiles)
        if any(a.atomic_num == 1 for a in mol.atoms):
            mol = mol.strip_hydrogens()
        confs = embed_conformers(mol, num_conformers, seed=seed)  # [C, N, 3]
        mol.coords = confs[0]
        return cls(mol, confs, conformer_axis=0)

    @classmethod
    def _load_from_smiles_rdkit(cls, smiles: str, num_conformers: int) -> "Ligand":
        from rdkit import Chem
        from rdkit.Chem import rdDistGeom

        import tempfile, os  # noqa: E401

        rdmol = Chem.MolFromSmiles(smiles)
        rdmol = Chem.AddHs(rdmol)
        rdDistGeom.EmbedMultipleConfs(rdmol, num_conformers, params=rdDistGeom.srETKDGv3())
        fd, fn = tempfile.mkstemp(suffix=".sdf")
        os.close(fd)
        try:
            with Chem.SDWriter(fn) as w:
                for i in range(rdmol.GetNumConformers()):
                    w.write(rdmol, confId=i)
            out = cls.load_from_file(fn)
        finally:
            os.unlink(fn)
        return out


class LigandNode:
    def __init__(
        self,
        graph: "LigandGraph",
        index: int,
        atom_indices: int | Sequence[int],
        center_indices: int | Sequence[int],
        node_type: str,
    ):
        self.graph = graph
        self.index = index
        self.types: list[str] = [node_type]
        self.atom_indices: set[int] = (
            {atom_indices} if isinstance(atom_indices, int) else set(atom_indices)
        )
        self.center_indices = center_indices
        self.neighbor_edge_dict: dict["LigandNode", "LigandEdge"] = {}
        self.group_nodes: set["LigandNode"] = set()
        self.dependence_nodes: set["LigandNode"] = set()
        self.positions: np.ndarray | None = None  # [N_conf, 3]

    def set_positions(self) -> None:
        pos = self.graph.atom_positions  # [N_atoms, N_conf, 3]
        if isinstance(self.center_indices, int):
            self.positions = np.asarray(pos[self.center_indices], dtype=np.float32)
        else:
            self.positions = np.mean(
                pos[list(self.center_indices), :], axis=0, dtype=np.float32
            )

    def add_neighbors(self, neighbor: "LigandNode") -> "LigandEdge":
        edge = self.neighbor_edge_dict.get(neighbor)
        if edge is not None:
            return edge
        edge = LigandEdge(self.graph, self, neighbor)
        self.neighbor_edge_dict[neighbor] = edge
        neighbor.neighbor_edge_dict[self] = edge

        def has(types, *keys):
            return any(t.startswith(keys) for t in types)

        # dependence rules (ligand.py:317-328)
        if has(self.types, "Hydrophobic") and has(neighbor.types, "Aromatic"):
            if self.atom_indices.issubset(neighbor.atom_indices):
                self.dependence_nodes.add(neighbor)
        elif has(self.types, "Aromatic") and has(neighbor.types, "Hydrophobic"):
            if neighbor.atom_indices.issubset(self.atom_indices):
                neighbor.dependence_nodes.add(self)
        elif has(self.types, "HBond") and has(neighbor.types, "Cation", "Anion"):
            if self.atom_indices.issubset(neighbor.atom_indices):
                self.dependence_nodes.add(neighbor)
        elif has(self.types, "Cation", "Anion") and has(neighbor.types, "HBond"):
            if neighbor.atom_indices.issubset(self.atom_indices):
                neighbor.dependence_nodes.add(self)
        return edge

    def __lt__(self, other):
        return self.index < other.index

    def __repr__(self):
        return f"LigandNode({self.index}){self.types}"


class LigandEdge:
    def __init__(self, graph: "LigandGraph", node1: LigandNode, node2: LigandNode):
        self.graph = graph
        self.index = len(graph.edges)
        if node2.index < node1.index:
            node1, node2 = node2, node1
        self.indices = (node1.index, node2.index)
        self.nodes = (node1, node2)
        self.distances: np.ndarray | None = None  # [N_conf]

    def set_distances(self) -> None:
        node1, node2 = self.nodes
        self.distances = np.linalg.norm(node1.positions - node2.positions, axis=-1).astype(
            np.float32
        )


class LigandNodeCluster:
    """Typed node cluster with a center node and satellite nodes."""

    def __init__(self, cluster_type: str):
        self.type = cluster_type
        self._high_priority_node: LigandNode | None = None
        self._low_priority_nodes: list[LigandNode] = []

    def add_new_node(self, node: LigandNode, priority: str) -> None:
        if priority == "high":
            self._high_priority_node = node
        else:
            self._low_priority_nodes.append(node)

    def __iter__(self) -> Iterator[LigandNode]:
        if self._high_priority_node is not None:
            yield self._high_priority_node
        yield from self._low_priority_nodes

    @property
    def nodes(self) -> list[LigandNode]:
        return list(iter(self))

    @property
    def node_types(self) -> set[str]:
        types: set[str] = set()
        for node in self:
            types.update(node.types)
        return types

    @property
    def positions(self) -> np.ndarray:  # [N_conf, N_node, 3]
        return np.stack([node.positions for node in self.nodes], axis=1)

    @property
    def center(self) -> np.ndarray:  # [N_conf, 3]
        return np.mean(self.positions, axis=1)

    @property
    def size(self) -> np.ndarray:  # [N_conf]
        return np.max(
            np.linalg.norm(self.positions - self.center.reshape(-1, 1, 3), axis=-1), axis=-1
        )

    def __repr__(self):
        return f"LigandNodeCluster({self.type})[{self.nodes}]"


class LigandGraph:
    def __init__(self, ligand: Ligand):
        self.nodes: list[LigandNode] = []
        self.edges: list[LigandEdge] = []
        self.node_dict: dict[str, list[LigandNode]] = {}
        self.node_clusters: list[LigandNodeCluster] = []
        self.node_cluster_dict: dict[str, list[LigandNodeCluster]] = dict(
            Cation=[], Anion=[], HBond=[], Aromatic=[], Hydrophobic=[], Halogen=[]
        )
        self._add_nodes(ligand)
        self._setup_conformers(ligand)
        self._group_nodes(ligand)
        self._setup_clusters()

    # ------------------------------------------------------------------
    def _add_nodes(self, ligand: Ligand) -> None:
        by_atoms: dict[int | tuple, LigandNode] = {}
        for ptype, pnode in ligand.pharmacophore_list:
            existing = by_atoms.get(pnode.atom_indices)
            if existing is not None:
                existing.types.append(ptype)
                self.node_dict.setdefault(ptype, []).append(existing)
                continue
            node = LigandNode(
                self, len(self.nodes), pnode.atom_indices, pnode.center_indices, ptype
            )
            self.nodes.append(node)
            self.node_dict.setdefault(ptype, []).append(node)
            for other in self.nodes[:-1]:
                edge = other.add_neighbors(node)
                self.edges.append(edge)
            by_atoms[pnode.atom_indices] = node

    def _setup_conformers(self, ligand: Ligand) -> None:
        assert ligand.num_conformers > 0
        self.atom_positions = ligand.atom_positions
        self.num_conformers = ligand.num_conformers
        for node in self.nodes:
            node.set_positions()
        for edge in self.edges:
            edge.set_distances()

    # ------------------------------------------------------------------
    def _group_nodes(self, ligand: Ligand) -> None:
        """Group nodes of the same functional group (ligand.py:158-213)."""
        mol = ligand.mol
        hbond_groups: dict[int, list[LigandNode]] = {}
        hydrop_groups: dict[int, list[LigandNode]] = {}
        for node in self.nodes:
            if "HBond_acceptor" in node.types or "HBond_donor" in node.types:
                if len(node.atom_indices) != 1:
                    continue
                atom = next(iter(node.atom_indices))
                neighbors = mol.neighbors(atom)
                if len(neighbors) == 1:
                    group = hbond_groups.setdefault(neighbors[0], [])
                    for other in group:
                        node.group_nodes.add(other)
                        other.group_nodes.add(node)
                    group.append(node)
            elif "Hydrophobic" in node.types:
                atom = next(iter(node.atom_indices))
                neighbors = mol.neighbors(atom)
                if len(neighbors) == 1:
                    group = hydrop_groups.setdefault(neighbors[0], [])
                    for other in group:
                        node.group_nodes.add(other)
                        other.group_nodes.add(node)
                    group.append(node)

        # merge connected hydrophobic carbons into one group (ligand.py:194-213)
        hydrophobic_nodes = self.node_dict.get("Hydrophobic", [])
        index_to_node = {next(iter(n.atom_indices)): n for n in hydrophobic_nodes}
        while index_to_node:
            atom_index, node = index_to_node.popitem()
            group_nodes = [node] + list(node.group_nodes)
            frontier = [next(iter(n.atom_indices)) for n in group_nodes if len(n.atom_indices) == 1]
            for atom in frontier:
                for neighbor in mol.neighbors(atom):
                    if mol.atoms[neighbor].atomic_num != 6:
                        continue
                    neighbor_node = index_to_node.pop(neighbor, None)
                    if neighbor_node is None:
                        continue
                    frontier.append(neighbor)
                    for member in group_nodes:
                        member.group_nodes.add(neighbor_node)
                        neighbor_node.group_nodes.add(member)
                    group_nodes.append(neighbor_node)

    # ------------------------------------------------------------------
    def _setup_clusters(self) -> None:
        """Priority clustering (ligand.py:215-259)."""
        in_cluster: set[LigandNode] = set()
        node_cluster_dict: dict[LigandNode, LigandNodeCluster] = {}
        for ptype in ["Aromatic", "Cation", "Anion", "Halogen"]:
            for node in self.node_dict.get(ptype, []):
                if node in in_cluster:
                    continue
                in_cluster.add(node)
                cluster = LigandNodeCluster(ptype)
                cluster.add_new_node(node, "high")
                node_cluster_dict[node] = cluster

        for ptype in ["Hydrophobic", "HBond_donor", "HBond_acceptor"]:
            for node in self.node_dict.get(ptype, []):
                if node in in_cluster:
                    continue
                in_cluster.add(node)
                placed = False
                if node.dependence_nodes:
                    anchor = min(node.dependence_nodes)
                    cluster = node_cluster_dict.get(anchor)
                    if cluster is not None:
                        cluster.add_new_node(node, "low")
                        placed = True
                if not placed and node.group_nodes:
                    for group_node in node.group_nodes:
                        cluster = node_cluster_dict.get(group_node)
                        if cluster is not None:
                            cluster.add_new_node(node, "low")
                            placed = True
                            break
                if not placed:
                    cluster = LigandNodeCluster("HBond" if ptype.startswith("HBond") else "Hydrophobic")
                    cluster.add_new_node(node, "low")
                    node_cluster_dict[node] = cluster

        self.node_clusters = list(node_cluster_dict.values())
        for cluster in self.node_clusters:
            self.node_cluster_dict[cluster.type].append(cluster)
