"""Traffic of the screening cells, made from the seed.

`model_state` is `pharmaconet_tpu_torch.synthetic.make_synthetic_model`
copied: the pocket's nodes, clusters and edges as plain Python data (the
state dict of a `.pm` file), which the route hands to the program and the
reference reads itself. `fragment_ligands` makes real chemistry: molecules
of the fragment-enumerated SMILES space embedded and perceived by the
benchmark's frozen copy of the program's host chemistry (`ligchem/`). Both
are copies so that a change to the program cannot move the traffic its
benchmark runs.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from ligchem.library import TYPE_INDEX, TYPES  # noqa: F401 - the program's type order


def seed_sequence(seed: int, *stream: int) -> np.random.SeedSequence:
    """Any whole number, negative or above 64 bits included, as a seed."""
    return np.random.SeedSequence([seed % 2**64, *stream])


def model_state(num_clusters: int, seed: int) -> dict:
    """The pocket model's state dict (`PharmacophoreModel.__getstate__`'s
    schema), drawn as `make_synthetic_model(num_clusters, seed)` draws it."""
    rng = np.random.default_rng(seed)
    type_choices = [
        ("Hydrophobic", "Hydrophobic"),
        ("Aromatic", "PiStacking_P"),
        ("HBond_donor", "HBond_ldon"),
        ("HBond_acceptor", "HBond_pdon"),
        ("Anion", "SaltBridge_lneg"),
        ("Cation", "PiCation_pring"),
        ("Halogen", "XBond"),
    ]
    cluster_type_of = {
        "Hydrophobic": "Hydrophobic", "Aromatic": "Aromatic", "HBond_donor": "HBond",
        "HBond_acceptor": "HBond", "Anion": "Anion", "Cation": "Cation",
        "Halogen": "Halogen",
    }
    nodes = []
    clusters = []
    for _ in range(num_clusters):
        ptype, itype = type_choices[rng.integers(len(type_choices))]
        center = rng.uniform(-8, 8, 3)
        n_nodes = int(rng.integers(1, 4))
        idxs = []
        for _ in range(n_nodes):
            pos = center + rng.normal(0, 1.0, 3)
            radius = float(rng.uniform(0.6, 1.6))
            idxs.append(len(nodes))
            nodes.append((ptype, itype, tuple(pos.tolist()), radius))
        clusters.append((cluster_type_of[ptype], idxs))

    n = len(nodes)
    edges = []
    edge_index = {}
    for i in range(n):
        for j in range(i, n):
            ci, cj = np.array(nodes[i][2]), np.array(nodes[j][2])
            edge_index[(i, j)] = edge_index[(j, i)] = len(edges)
            edges.append(dict(
                index=len(edges), node_indices=(i, j),
                edge_type=(nodes[i][0], nodes[j][0]),
                distance_mean=float(np.linalg.norm(ci - cj)),
                distance_std=math.sqrt(nodes[i][3] ** 2 + nodes[j][3] ** 2),
            ))
    node_dicts = [
        dict(index=i, type=p, interaction_type=it, hotspot_position=(0.0, 0.0, 0.0),
             score=1.0, center=c, radius=r,
             neighbor_edge_dict={j: edge_index[(i, j)] for j in range(n)},
             overlapped_nodes=[])
        for i, (p, it, c, r) in enumerate(nodes)
    ]
    cluster_dict = {k: [] for k in ["Cation", "Anion", "HBond", "Aromatic",
                                    "Hydrophobic", "Halogen"]}
    for ctype, idxs in clusters:
        centers = np.array([nodes[i][2] for i in idxs])
        center = centers.mean(axis=0)
        radii = np.array([nodes[i][3] * 2 for i in idxs])
        size = float(np.max(np.linalg.norm(centers - center, axis=-1) + radii))
        cluster_dict[ctype].append(dict(
            cluster_type=ctype, node_indices=tuple(idxs),
            node_types=tuple({nodes[i][0] for i in idxs}),
            center=tuple(center.tolist()), size=size))
    node_dict = {}
    for i, (_, it, _, _) in enumerate(nodes):
        node_dict.setdefault(it, []).append(i)
    return dict(pdbblock="", nodes=node_dicts, edges=edges,
                node_cluster_dict=cluster_dict, node_dict=node_dict)


@dataclass
class Ligands:
    """A library as flat arrays: ligand i owns nodes [node_start[i],
    node_start[i+1]) and clusters [cluster_start[i], cluster_start[i+1]);
    the fields of one ligand are the program's PackedLigand fields."""

    node_pos: np.ndarray  # [N, C, 3] f32
    node_mask: np.ndarray  # [N] i32 type bitmask
    node_cluster: np.ndarray  # [N] i32 ligand-local cluster of each node
    node_start: np.ndarray  # [n + 1] i64
    cluster_mask: np.ndarray  # [K] i32
    cluster_center: np.ndarray  # [K, C, 3] f32
    cluster_size: np.ndarray  # [K, C] f32
    cluster_start: np.ndarray  # [n + 1] i64
    num_conformers: int

    def __len__(self) -> int:
        return len(self.node_start) - 1

    def ligand(self, i: int) -> dict:
        """Ligand i's PackedLigand fields (clusters in the library's order,
        which the program takes as the priority order)."""
        n0, n1 = int(self.node_start[i]), int(self.node_start[i + 1])
        k0, k1 = int(self.cluster_start[i]), int(self.cluster_start[i + 1])
        local = self.node_cluster[n0:n1]
        clusters = [[] for _ in range(k1 - k0)]
        for u, k in enumerate(local.tolist()):
            clusters[k].append(u)
        return dict(
            node_pos=self.node_pos[n0:n1], node_mask=self.node_mask[n0:n1],
            clusters=clusters, cluster_mask=self.cluster_mask[k0:k1],
            cluster_center=self.cluster_center[k0:k1],
            cluster_size=self.cluster_size[k0:k1],
            num_conformers=self.num_conformers,
        )


def fragment_ligands(n: int, num_conformers: int, seed: int) -> Ligands:
    """n drug-like molecules of the fragment space (`ligchem/fragments.py`),
    drawn from `seed`, each embedded at `num_conformers` conformers from a
    seed of its own and packed as `prepack --smiles` packs it. A few more
    are drawn than needed; the first n that embed are kept, in draw order.
    Up to 8 processes embed, one per core; the result does not depend on
    how many."""
    from ligchem.fragments import enumerate_fragment_smiles
    from ligchem.library import embed_chunk

    spare = n // 50 + 8
    smiles = [smi for _, smi in enumerate_fragment_smiles(n + spare, seed=seed % 2**64)]
    seeds = np.random.SeedSequence([seed % 2**64, 2]).generate_state(len(smiles), np.uint64)
    entries = [(i, smi, int(s)) for i, (smi, s) in enumerate(zip(smiles, seeds))]
    jobs = [(entries[c0:c0 + 64], num_conformers) for c0 in range(0, len(entries), 64)]
    workers = min(os.cpu_count() or 1, len(jobs), 8)
    if workers > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            done = pool.map(embed_chunk, jobs, chunksize=1)
            pool.close()
            pool.join()
    else:
        done = [embed_chunk(job) for job in jobs]
    packed = [lig for chunk in done for _, lig in chunk if lig is not None][:n]
    if len(packed) < n:
        raise RuntimeError(f"only {len(packed)} of {len(smiles)} molecules embedded; need {n}")
    return pack_ligands(packed)


def pack_ligands(packed: list[dict]) -> Ligands:
    """Packed ligands (each cluster's nodes consecutive) as one Ligands."""
    n = len(packed)
    nodes = np.array([len(p["node_mask"]) for p in packed], np.int64)
    ks = np.array([len(p["clusters"]) for p in packed], np.int64)
    node_start = np.concatenate([[0], np.cumsum(nodes)])
    cluster_start = np.concatenate([[0], np.cumsum(ks)])
    node_cluster = np.concatenate(
        [np.repeat(np.arange(len(p["clusters"])), [len(c) for c in p["clusters"]])
         for p in packed] + [np.zeros(0, np.int64)]).astype(np.int32)
    c = packed[0]["num_conformers"] if n else 1

    def cat(key, shape):
        parts = [p[key] for p in packed]
        return np.concatenate(parts) if parts else np.zeros(shape, np.float32)

    return Ligands(
        node_pos=cat("node_pos", (0, c, 3)).astype(np.float32),
        node_mask=cat("node_mask", (0,)).astype(np.int32),
        node_cluster=node_cluster, node_start=node_start,
        cluster_mask=cat("cluster_mask", (0,)).astype(np.int32),
        cluster_center=cat("cluster_center", (0, c, 3)).astype(np.float32),
        cluster_size=cat("cluster_size", (0, c)).astype(np.float32),
        cluster_start=cluster_start, num_conformers=c,
    )
