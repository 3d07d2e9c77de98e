"""Density-map → pharmacophore graph construction (host side).

Rebuilds upstream PharmacoNet src/pmnet/utils/density_map.py:28-278. Hotspot
density maps (64^3, thresholded) are clustered into nodes via 26-connected
components (scipy.ndimage.label — same membership as the reference's BFS,
with deterministic ordering by smallest flat voxel index), then grouped into
typed clusters.

Geometry conventions (must match the reference bit-for-bit):
  * node position origin = center - res*(size-1)/2   (density_map.py:16-25)
  * node center = grid-score-weighted voxel mean     (density_map.py:224)
  * node radius = (n_voxels * 3/(4*pi))^(1/3) * res  (density_map.py:229)
  * edge distance_std = sqrt(r1^2 + r2^2)            (density_map.py:277)
  * components with < 8 voxels are dropped           (density_map.py:60)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
from scipy import ndimage

from ..constants import (
    CLUSTER_DISTANCE,
    GRID_DIM,
    GRID_RESOLUTION,
    INTERACTION_LIST,
    MIN_NODE_VOXELS,
    OVERLAP_DISTANCE,
)

_STRUCTURE_26 = np.ones((3, 3, 3), dtype=bool)


def coords_to_position(
    coords: np.ndarray | tuple[float, float, float],
    center: tuple[float, float, float],
    resolution: float,
    size: int,
) -> tuple[float, float, float]:
    origin = np.asarray(center, dtype=np.float64) - resolution * (size - 1) / 2
    pos = origin + np.asarray(coords, dtype=np.float64) * resolution
    return (float(pos[0]), float(pos[1]), float(pos[2]))


@dataclass
class DensityMapNode:
    index: int
    type: str  # interaction type string
    hotspot_position: tuple[float, float, float]
    score: float
    center: np.ndarray  # float32 [3] — world position
    radius: float
    neighbor_edge_dict: dict[int, "DensityMapEdge"] = field(default_factory=dict)
    overlapped_nodes: list[int] = field(default_factory=list)

    def __hash__(self):
        return self.index


@dataclass
class DensityMapEdge:
    index: int
    node_indices: tuple[int, int]
    type: tuple[str, str]
    distance_mean: float
    distance_std: float
    overlapped: bool


@dataclass
class DensityMapNodeCluster:
    type: str
    node_indices: tuple[int, ...]
    center: tuple[float, float, float]
    size: float


class DensityMapGraph:
    """Accumulates hotspot density maps into a typed pharmacophore graph."""

    def __init__(
        self,
        center: tuple[float, float, float],
        resolution: float = GRID_RESOLUTION,
        size: int = GRID_DIM,
    ):
        self.center = center
        self.resolution = resolution
        self.size = size
        self.nodes: list[DensityMapNode] = []
        self.edges: list[DensityMapEdge] = []
        self.node_dict: dict[str, list[DensityMapNode]] = {t: [] for t in INTERACTION_LIST}
        self.node_clusters: list[DensityMapNodeCluster] = []
        self.node_cluster_dict: dict[str, list[DensityMapNodeCluster]] = dict(
            Cation=[], Anion=[], HBond=[], Aromatic=[], Hydrophobic=[], Halogen=[]
        )

    # ------------------------------------------------------------------
    def add_node(
        self,
        node_type: str,
        hotspot_position: tuple[float, float, float],
        score: float,
        density_map: np.ndarray,
    ) -> list[DensityMapNode]:
        new_nodes = []
        for grids, grid_scores in extract_components(density_map):
            if len(grids) < MIN_NODE_VOXELS:
                continue
            center_coords = np.average(grids, axis=0, weights=grid_scores)
            center = np.array(
                coords_to_position(center_coords, self.center, self.resolution, self.size),
                dtype=np.float32,
            )
            radius = (grids.shape[0] / (4 * math.pi / 3)) ** (1 / 3) * self.resolution
            node = DensityMapNode(
                index=len(self.nodes),
                type=node_type,
                hotspot_position=hotspot_position,
                score=score,
                center=center,
                radius=radius,
            )
            self.nodes.append(node)
            self.node_dict[node_type].append(node)
            new_nodes.append(node)
            # fully-connected edges to every node (including a self loop,
            # matching density_map.py:66-72)
            for other in self.nodes:
                edge = DensityMapEdge(
                    index=len(self.edges),
                    node_indices=(min(other.index, node.index), max(other.index, node.index)),
                    type=(min(other.type, node.type), max(other.type, node.type)),
                    distance_mean=float(np.linalg.norm(other.center - node.center)),
                    distance_std=math.sqrt(other.radius**2 + node.radius**2),
                    overlapped=float(np.linalg.norm(other.center - node.center)) < OVERLAP_DISTANCE,
                )
                self.edges.append(edge)
                node.neighbor_edge_dict[other.index] = edge
                other.neighbor_edge_dict[node.index] = edge
                if edge.overlapped and other.index != node.index:
                    node.overlapped_nodes.append(other.index)
                    other.overlapped_nodes.append(node.index)
        return new_nodes

    # ------------------------------------------------------------------
    def setup(self) -> None:
        """Cluster nodes (density_map.py:112-181)."""

        def close(i: int, j: int) -> bool:
            return self.nodes[i].neighbor_edge_dict[j].distance_mean < CLUSTER_DISTANCE

        group_configs = [
            ("Cation", ("SaltBridge_pneg", "PiCation_pring"), "HBond"),
            ("Anion", ("SaltBridge_lneg",), "HBond"),
            ("Aromatic", ("PiStacking", "PiCation_lring"), "Hydrophobic"),
        ]
        used: set[int] = set()
        for node in self.nodes:
            if node.index in used:
                continue
            for name, major, minor in group_configs:
                if node.type.startswith(major):
                    members = {node.index}
                    members.update(
                        j for j in node.overlapped_nodes if self.nodes[j].type.startswith(major)
                    )
                    # minor-type nodes close to any member (may already be
                    # used by another cluster — reference allows reuse)
                    members.update(
                        other.index
                        for other in self.nodes
                        if other.type.startswith(minor)
                        and any(close(other.index, m) for m in members)
                    )
                    used.update(members)
                    self.node_cluster_dict[name].append(self._make_cluster(name, members))
                    break

        single_configs = [("HBond", "HBond"), ("Hydrophobic", "Hydrophobic"), ("Halogen", "XBond")]
        for node in self.nodes:
            if node.index in used:
                continue
            for name, type_prefix in single_configs:
                if node.type.startswith(type_prefix):
                    members = {
                        other.index
                        for other in self.nodes
                        if other.type.startswith(type_prefix) and close(node.index, other.index)
                    }
                    members.add(node.index)
                    used.update(members)
                    self.node_cluster_dict[name].append(self._make_cluster(name, members))
                    break

        for clusters in self.node_cluster_dict.values():
            self.node_clusters.extend(clusters)

    def _make_cluster(self, name: str, members: set[int]) -> DensityMapNodeCluster:
        indices = tuple(sorted(members))
        positions = np.array([self.nodes[i].center for i in indices])
        radii = np.array([self.nodes[i].radius * 2 for i in indices])
        center = np.mean(positions, axis=0)
        distances = np.linalg.norm(positions - center.reshape(1, 3), axis=-1) + radii
        return DensityMapNodeCluster(
            type=name,
            node_indices=indices,
            center=(float(center[0]), float(center[1]), float(center[2])),
            size=float(np.max(distances)),
        )


def extract_components(density_map: np.ndarray):
    """Yield (voxel_coords [n,3] int, scores [n] float) per 26-connected
    component of ``density_map > 0``, ordered by smallest flat voxel index.

    The reference's BFS over a Python set (density_map.py:78-110) yields the
    same components in nondeterministic order; this ordering is canonical.
    """
    labeled, num = ndimage.label(density_map > 0.0, structure=_STRUCTURE_26)
    if num == 0:
        return
    flat = labeled.reshape(-1)
    nz_pos = np.nonzero(flat)[0]  # ascending flat index
    labs = flat[nz_pos]
    # component order = by smallest flat voxel index (canonical); within a
    # component, voxels in ascending flat index (== np.argwhere's C order)
    uniq, first_pos = np.unique(labs, return_index=True)
    order = uniq[np.argsort(first_pos, kind="stable")]
    group = np.argsort(labs, kind="stable")  # grouped by label, pos-ascending
    grouped_pos = nz_pos[group]
    starts = np.searchsorted(labs[group], uniq, side="left")
    ends = np.searchsorted(labs[group], uniq, side="right")
    bounds = {int(u): (int(s), int(e)) for u, s, e in zip(uniq, starts, ends)}
    for lab in order:
        s, e = bounds[int(lab)]
        coords = np.stack(
            np.unravel_index(grouped_pos[s:e], labeled.shape), axis=1
        )
        scores = density_map[coords[:, 0], coords[:, 1], coords[:, 2]].astype(np.float64)
        yield coords, scores
