"""SMILES to packed ligands, as `prepack --smiles` makes them: parse, embed
conformers (each molecule from its own seed), perceive the pharmacophore
graph, and pack its nodes and clusters (clusters in upstream GraphMatcher's
priority order, `graph_match.py:43-60`). Molecules that fail to embed are
skipped, as the program skips them.
"""

from __future__ import annotations

import numpy as np

# the program's type order (scoring/batch_screen.py PHARMACOPHORE_TYPES)
TYPES = ("Hydrophobic", "Aromatic", "Cation", "Anion", "HBond_donor",
         "HBond_acceptor", "Halogen")
TYPE_INDEX = {t: i for i, t in enumerate(TYPES)}


def type_mask(types) -> int:
    mask = 0
    for t in types:
        mask |= 1 << TYPE_INDEX[t]
    return mask


def priority(cluster):
    """Sort key of a ligand cluster (upstream graph_match.py:43-60)."""
    size = -len(cluster.nodes)
    atom = min(cluster.nodes[0].atom_indices)
    order = {"Aromatic": (0, 0), "Cation": (0, 1), "Anion": (0, 2),
             "HBond": (1, 0), "Halogen": (1, 1), "Hydrophobic": (1, 2)}
    for prefix, (group, rank) in order.items():
        if cluster.type.startswith(prefix):
            return (group, size, rank, atom)
    raise NotImplementedError(cluster.type)


def pack(graph) -> dict:
    """A ligand graph as the program's PackedLigand fields. Nodes are
    renumbered cluster by cluster, so that each cluster's nodes are
    consecutive (the order of the pairs the match sums is unchanged)."""
    c = max(graph.num_conformers, 1)
    clusters = sorted(graph.node_clusters, key=priority) if graph.nodes else []
    nodes = [n for cl in clusters for n in cl.nodes]
    if sorted(n.index for n in nodes) != list(range(len(graph.nodes))):
        raise ValueError("ligand clusters do not partition its nodes")
    at, groups = 0, []
    for cl in clusters:
        groups.append(list(range(at, at + len(cl.nodes))))
        at += len(cl.nodes)
    return dict(
        node_pos=np.stack([n.positions for n in nodes]).astype(np.float32)
        if nodes else np.zeros((0, c, 3), np.float32),
        node_mask=np.array([type_mask(n.types) for n in nodes], np.int32),
        clusters=groups,
        cluster_mask=np.array([type_mask(cl.node_types) for cl in clusters], np.int32),
        cluster_center=np.stack([cl.center for cl in clusters]).astype(np.float32)
        if clusters else np.zeros((0, c, 3), np.float32),
        cluster_size=np.stack([cl.size for cl in clusters]).astype(np.float32)
        if clusters else np.zeros((0, c), np.float32),
        num_conformers=c,
    )


def embed_chunk(job) -> list[tuple[int, dict | None]]:
    """(index, packed fields or None where the molecule failed) for one
    chunk of (index, smiles, seed) entries at `num_conformers`."""
    entries, num_conformers = job
    from .embed import embed_conformers_many
    from .ligand import Ligand
    from .smiles import parse_smiles

    mols, keep, out = [], [], []
    for i, smi, _ in entries:
        try:
            mol = parse_smiles(smi)
            if any(a.atomic_num == 1 for a in mol.atoms):
                mol = mol.strip_hydrogens()
            mols.append(mol)
            keep.append(i)
        except Exception:  # noqa: BLE001 - a molecule that fails is skipped
            out.append((i, None))
    seeds = {i: s for i, _, s in entries}
    confs = embed_conformers_many(mols, num_conformers, seeds=[seeds[i] for i in keep])
    for i, mol, conf in zip(keep, mols, confs):
        if isinstance(conf, Exception):
            out.append((i, None))
            continue
        mol.coords = conf[0]
        try:
            out.append((i, pack(Ligand(mol, conf, conformer_axis=0).graph)))
        except Exception:  # noqa: BLE001
            out.append((i, None))
    return sorted(out, key=lambda x: x[0])
