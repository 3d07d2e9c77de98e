"""Synthetic screening and modeling inputs made from numpy seeds.

`make_synthetic_model` and `make_synthetic_ligands` build the headline
screening workload of the repo's benchmark (bench.py): a 20-cluster pocket
model (~40 nodes, realistic radii) and drug-like packed ligands (5-10
clusters of 1-2 nodes, 4 conformers); `SMILES_POOL` is the SMILES list
its proxy mode scores. `write_random_library` writes
random small molecules as .sdf/.mol2 files for the `-d` route. The same
seeds give the same inputs as the JAX package's generators.
`write_synthetic_pocket` writes a protein PDB around an empty cavity for
pocket modeling, `write_synthetic_site` the same with a ligand at its
centre and that ligand's own file, for runs that take a reference ligand.
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path

import numpy as np

from .chem.templates import RESIDUE_TEMPLATES
from .pharmacophore.model import PharmacophoreModel
from .scoring.batch_screen import TYPE_INDEX, PackedLigand


def make_synthetic_model(num_clusters: int = 20, seed: int = 0):
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

    # build the state dict (same schema as PharmacophoreModel.__getstate__)
    n = len(nodes)
    edges = []
    edge_index = {}
    for i in range(n):
        for j in range(i, n):
            ci, cj = np.array(nodes[i][2]), np.array(nodes[j][2])
            edge_index[(i, j)] = edge_index[(j, i)] = len(edges)
            edges.append(
                dict(
                    index=len(edges), node_indices=(i, j),
                    edge_type=(nodes[i][0], nodes[j][0]),
                    distance_mean=float(np.linalg.norm(ci - cj)),
                    distance_std=math.sqrt(nodes[i][3] ** 2 + nodes[j][3] ** 2),
                )
            )
    node_dicts = [
        dict(
            index=i, type=p, interaction_type=it, hotspot_position=(0.0, 0.0, 0.0),
            score=1.0, center=c, radius=r,
            neighbor_edge_dict={j: edge_index[(i, j)] for j in range(n)},
            overlapped_nodes=[],
        )
        for i, (p, it, c, r) in enumerate(nodes)
    ]
    cluster_dict = {k: [] for k in ["Cation", "Anion", "HBond", "Aromatic", "Hydrophobic", "Halogen"]}
    for ctype, idxs in clusters:
        centers = np.array([nodes[i][2] for i in idxs])
        center = centers.mean(axis=0)
        radii = np.array([nodes[i][3] * 2 for i in idxs])
        size = float(np.max(np.linalg.norm(centers - center, axis=-1) + radii))
        cluster_dict[ctype].append(
            dict(cluster_type=ctype, node_indices=tuple(idxs),
                 node_types=tuple({nodes[i][0] for i in idxs}),
                 center=tuple(center.tolist()), size=size)
        )
    node_dict = {}
    for i, (_, it, _, _) in enumerate(nodes):
        node_dict.setdefault(it, []).append(i)
    model = PharmacophoreModel()
    model.__setstate__(
        dict(pdbblock="", nodes=node_dicts, edges=edges,
             node_cluster_dict=cluster_dict, node_dict=node_dict)
    )
    return model


def make_synthetic_ligands(n: int, num_conformers: int = 4, seed: int = 1):
    """Synthetic packed ligands with drug-like pharmacophore statistics."""
    rng = np.random.default_rng(seed)
    type_names = list(TYPE_INDEX)
    out = []
    for _ in range(n):
        num_clusters = int(rng.integers(5, 11))
        nodes_mask = []
        clusters = []
        cluster_masks = []
        node_positions = []
        base = rng.uniform(-6, 6, 3)
        for _ in range(num_clusters):
            c_nodes = int(rng.integers(1, 3))
            t = type_names[rng.integers(len(type_names))]
            mask = 1 << TYPE_INDEX[t]
            center = base + rng.normal(0, 4.0, 3)
            idxs = []
            for _ in range(c_nodes):
                idxs.append(len(nodes_mask))
                nodes_mask.append(mask)
                node_positions.append(center + rng.normal(0, 0.8, 3))
            clusters.append(idxs)
            cluster_masks.append(mask)
        pos0 = np.array(node_positions, dtype=np.float32)  # [Ln, 3]
        confs = [pos0]
        for _ in range(num_conformers - 1):
            confs.append(pos0 + rng.normal(0, 0.5, pos0.shape).astype(np.float32))
        node_pos = np.stack(confs, axis=1)  # [Ln, C, 3]
        cluster_center = np.stack(
            [node_pos[idxs].mean(axis=0) for idxs in clusters], axis=0
        )  # [L, C, 3]
        cluster_size = np.stack(
            [
                np.linalg.norm(node_pos[idxs] - node_pos[idxs].mean(axis=0, keepdims=True), axis=-1).max(axis=0)
                for idxs in clusters
            ],
            axis=0,
        ).astype(np.float32)
        out.append(
            PackedLigand(
                node_pos=node_pos.astype(np.float32),
                node_mask=np.array(nodes_mask, dtype=np.int32),
                clusters=clusters,
                cluster_mask=np.array(cluster_masks, dtype=np.int32),
                cluster_center=cluster_center.astype(np.float32),
                cluster_size=cluster_size,
                num_conformers=num_conformers,
            )
        )
    return out


# the drug-like SMILES that the proxy benchmark cycles through (bench.py's pool)
SMILES_POOL = [
    "c1ccccc1", "c1ccncc1", "c1ccc2ccccc2c1", "CC(=O)Nc1ccc(O)cc1",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CCO", "CC(=O)OC", "CCN(CC)CC",
    "c1ccc(cc1)C(=O)O", "CC(C)(C)c1ccccc1O", "COc1ccc(cc1)CCN",
    "Clc1ccc(cc1)C(=O)N", "Fc1ccc(cc1)S(=O)(=O)N", "CC1CCCCC1",
    "O=C1CCCCC1", "c1ccc(cc1)Cc1ccccc1", "CC(N)C(=O)O",
    "c1ccc(cc1)NC(=O)C", "CCOC(=O)c1ccccc1", "Cc1cccc(C)c1NC(=O)C",
]


_ELEMENTS = ["C", "C", "C", "N", "O", "S", "F", "Cl"]


def _random_molecule(rng) -> tuple[list[str], list[tuple[float, float, float]], list[tuple[int, int, int]]]:
    """A random chain (single bonds) plus an optional benzene ring.

    Returns (elements, coords, bonds) with bonds as (a, b, order) 0-based;
    order 4 = aromatic.
    """
    n_chain = int(rng.integers(4, 10))
    elements = [str(rng.choice(_ELEMENTS)) for _ in range(n_chain)]
    elements[0] = "C"  # anchor
    coords = [tuple(rng.uniform(-7, 7, 3).tolist())]
    for i in range(1, n_chain):
        prev = np.array(coords[i - 1])
        coords.append(tuple((prev + rng.normal(0, 1.4, 3)).tolist()))
    bonds = [(i - 1, i, 1) for i in range(1, n_chain)]
    if rng.random() < 0.6:  # fused benzene ring on the chain end
        base = len(elements)
        center = np.array(coords[-1]) + rng.normal(0, 1.5, 3)
        for k in range(6):
            ang = k * np.pi / 3
            pos = center + 1.39 * np.array([np.cos(ang), np.sin(ang), 0.0])
            elements.append("C")
            coords.append(tuple(pos.tolist()))
        for k in range(6):
            bonds.append((base + k, base + (k + 1) % 6, 4))
        bonds.append((n_chain - 1, base, 1))
    return elements, coords, bonds


def _to_sdf(name, elements, coords, bonds) -> str:
    lines = [name, "  generated", "", f"{len(elements):3d}{len(bonds):3d}  0  0  0  0  0  0  0  0999 V2000"]
    for el, (x, y, z) in zip(elements, coords):
        lines.append(f"{x:10.4f}{y:10.4f}{z:10.4f} {el:<3s} 0  0  0  0  0  0  0  0  0  0  0  0")
    for a, b, order in bonds:
        lines.append(f"{a + 1:3d}{b + 1:3d}{order:3d}  0")
    lines += ["M  END", "$$$$", ""]
    return "\n".join(lines)


_MOL2_ORDER = {1: "1", 2: "2", 3: "3", 4: "ar"}


def _to_mol2(name, elements, coords, bonds) -> str:
    aromatic_atoms = {a for a, b, o in bonds if o == 4} | {b for a, b, o in bonds if o == 4}
    lines = [
        "@<TRIPOS>MOLECULE", name,
        f"{len(elements)} {len(bonds)} 0 0 0", "SMALL", "NO_CHARGES", "",
        "@<TRIPOS>ATOM",
    ]
    for i, (el, (x, y, z)) in enumerate(zip(elements, coords)):
        sybyl = f"{el}.ar" if i in aromatic_atoms and el == "C" else el
        lines.append(f"{i + 1} {el}{i + 1} {x:.4f} {y:.4f} {z:.4f} {sybyl} 1 LIG 0.0")
    lines.append("@<TRIPOS>BOND")
    for j, (a, b, order) in enumerate(bonds):
        lines.append(f"{j + 1} {a + 1} {b + 1} {_MOL2_ORDER[order]}")
    lines.append("")
    return "\n".join(lines)


def write_random_library(directory: str | Path, n: int, seed: int) -> list[Path]:
    """Write `n` random molecules into `directory`, alternating .mol2 and
    .sdf; returns the paths in order."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        elements, coords, bonds = _random_molecule(rng)
        name = f"l{i:04d}"
        if i % 2:
            path = directory / f"{name}.sdf"
            path.write_text(_to_sdf(name, elements, coords, bonds))
        else:
            path = directory / f"{name}.mol2"
            path.write_text(_to_mol2(name, elements, coords, bonds))
        paths.append(path)
    return paths


# --------------------------------------------------------------------------
# Synthetic protein pocket for modeling
# --------------------------------------------------------------------------
STANDARD_RESIDUES = ("GLY", "ALA", "VAL", "LEU", "ILE", "PRO", "PHE", "TYR", "TRP", "SER",
                     "THR", "CYS", "MET", "ASN", "GLN", "ASP", "GLU", "LYS", "ARG", "HIS")
RESIDUE_CLASH = 2.8  # least distance between atoms of two residues (no peptide or S-S links)


@lru_cache(maxsize=None)
def residue_geometry(name: str) -> tuple[tuple[str, ...], np.ndarray]:
    """(atom names, [n, 3] coordinates) of one heavy-atom residue conformer,
    relaxed from its template's bond graph: bonds 1.5 A (1.4 A in aromatic
    rings), 1-3 pairs 2.45 A (2.42 A), para pairs of 6-rings 2.8 A, all
    other pairs at least 3.0 A. Deterministic per residue name."""
    template = RESIDUE_TEMPLATES[name]
    bonds = [b for b in template.bonds if "OXT" not in b]
    names: list[str] = []
    for a, b in bonds:
        names += [n for n in (a, b) if n not in names]
    index = {n: i for i, n in enumerate(names)}
    n = len(names)
    ring_atoms = {a for ring in template.rings for a in ring}
    adj = [set() for _ in range(n)]
    for a, b in bonds:
        adj[index[a]].add(index[b])
        adj[index[b]].add(index[a])
    target = np.full((n, n), 3.0)
    exact = np.zeros((n, n), dtype=bool)
    for i in range(n):
        for j in adj[i]:
            aromatic = names[i] in ring_atoms and names[j] in ring_atoms
            target[i, j], exact[i, j] = (1.4 if aromatic else 1.5), True
            for k in adj[j]:
                if k != i and not exact[i, k]:
                    target[i, k] = target[k, i] = 2.42 if aromatic else 2.45
                    exact[i, k] = exact[k, i] = True
    for ring in template.rings:
        if len(ring) == 6:  # para pairs: a planar hexagon
            members = {index[a] for a in ring}
            cyc = [index[ring[0]]]
            while len(cyc) < 6:
                cyc.append(min(j for j in adj[cyc[-1]] if j in members and j not in cyc))
            for p in range(3):
                i, j = cyc[p], cyc[p + 3]
                target[i, j] = target[j, i] = 2.8
                exact[i, j] = exact[j, i] = True
    np.fill_diagonal(exact, False)
    off = ~np.eye(n, dtype=bool)
    best, best_err = None, np.inf
    for attempt in range(8):
        rng = np.random.default_rng(STANDARD_RESIDUES.index(name) * 100 + attempt)
        x = rng.normal(0.0, 1.5, size=(n, 3))
        for _ in range(1500):
            d = x[:, None] - x[None]
            dist = np.maximum(np.linalg.norm(d, axis=-1), 1e-6)
            r = np.where(exact, dist - target, np.minimum(dist - target, 0.0)) * off
            x -= 0.05 * ((r / dist)[..., None] * d).sum(axis=1)
        dist = np.linalg.norm(x[:, None] - x[None], axis=-1)
        err = np.max(np.abs(np.where(exact, dist - target, np.minimum(dist - target, 0.0)) * off))
        if err < best_err:
            best, best_err = x - x.mean(axis=0), err
        if err < 0.05:
            break
    return tuple(names), best


def _random_rotations(rng, n: int) -> np.ndarray:
    """[n, 3, 3] uniformly random rotation matrices (unit quaternions)."""
    q = rng.normal(size=(n, 4))
    a, b, c, d = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)], -1),
        np.stack([2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)], -1),
        np.stack([2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d], -1),
    ], 1)


def write_synthetic_pocket(
    path: str | Path,
    seed: int = 0,
    center: tuple[float, float, float] = (10.0, -5.0, 3.0),
    num_atoms: int = 3000,
    cavity_radius: float = 5.5,
    outer_radius: float = 32.0,
) -> dict:
    """Write a PDB of standard residues (template atom names, chain A)
    packed at random around an empty spherical cavity at `center`: about
    `num_atoms` heavy atoms between `cavity_radius` and `outer_radius`,
    no two atoms of different residues closer than RESIDUE_CLASH (so no
    peptide or disulfide bonds form), from numpy's default_rng(seed).
    Candidates come in batches, are checked against the placed atoms
    through a cell grid, and are accepted in order.
    Returns {"center", "num_atoms", "num_residues"}."""
    rng = np.random.default_rng(seed)
    c = np.asarray(center, dtype=np.float64)
    geoms = [residue_geometry(n) for n in STANDARD_RESIDUES]
    width = max(len(names) for names, _ in geoms)
    shapes = np.zeros((len(geoms), width, 3))
    masks = np.zeros((len(geoms), width), dtype=bool)
    for i, (names, g) in enumerate(geoms):
        shapes[i, : len(names)], masks[i, : len(names)] = g, True

    cell, slots = RESIDUE_CLASH, 12
    g = int(np.ceil(2 * (outer_radius + 8.0) / cell)) + 2
    origin = c - cell * g / 2
    grid = np.full((g, g, g, slots, 3), 1e6)
    fill = np.zeros((g, g, g), dtype=np.int64)
    offsets = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"), -1).reshape(-1, 3)
    lines, serial, resseq = [], 0, 0
    for _ in range(400):  # a jammed packing stops short of num_atoms
        if serial >= num_atoms:
            break
        b = 256
        kinds = rng.integers(len(geoms), size=b)
        direction = rng.normal(size=(b, 3))
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        radius = rng.uniform(cavity_radius**3, outer_radius**3, size=b) ** (1.0 / 3.0)
        xyz = (c + direction * radius[:, None])[:, None] + np.einsum(
            "bij,baj->bai", _random_rotations(rng, b), shapes[kinds])  # [b, width, 3]
        mask = masks[kinds]
        cells = np.floor((xyz - origin) / cell).astype(np.int64)
        near = cells[:, :, None] + offsets[None, None]  # [b, width, 27, 3]
        near = np.clip(near, 0, g - 1)
        others = grid[near[..., 0], near[..., 1], near[..., 2]]  # [b, width, 27, slots, 3]
        gap = np.linalg.norm(others - xyz[:, :, None, None], axis=-1).min(axis=(2, 3))
        center_gap = np.linalg.norm(xyz - c, axis=-1)
        ok = (np.where(mask, gap, np.inf).min(1) >= RESIDUE_CLASH) & (
            np.where(mask, center_gap, np.inf).min(1) >= cavity_radius)
        batch: list[np.ndarray] = []
        for i in np.nonzero(ok)[0]:
            atoms = xyz[i][mask[i]]
            if batch and np.min(np.linalg.norm(
                    np.concatenate(batch)[:, None] - atoms[None], axis=-1)) < RESIDUE_CLASH:
                continue
            k = cells[i][mask[i]]
            if (fill[k[:, 0], k[:, 1], k[:, 2]] + len(atoms) > slots).any():
                continue
            batch.append(atoms)
            resseq += 1
            name = STANDARD_RESIDUES[kinds[i]]
            for atom_name, p, (x, y, z) in zip(geoms[kinds[i]][0], atoms, k):
                grid[x, y, z, fill[x, y, z]] = p
                fill[x, y, z] += 1
                serial += 1
                lines.append(
                    f"ATOM  {serial:5d}  {atom_name:<3s} {name:>3s} A{resseq:4d}    "
                    f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}  1.00  0.00           {atom_name[0]}"
                )
            if serial >= num_atoms:
                break
    lines.append("END")
    Path(path).write_text("\n".join(lines) + "\n")
    return {"center": tuple(float(v) for v in c), "num_atoms": serial, "num_residues": resseq}


def append_het_ligands(
    path: str | Path,
    ligands: list[tuple[str, str, int, tuple[float, float, float]]],
    names: dict[str, str] | None = None,
) -> None:
    """Adds HET ligands to a PDB written by `write_synthetic_pocket`, for
    ligand detection (`utils.rcsb.parse_pdb`): each (het id, chain, residue
    number, centre) gets a HET record (and a HETNAM record from `names`) in
    the header and HETATM records before END: 'HOH' one oxygen at the
    centre, any other id a planar ring of five carbons and one oxygen,
    1.25 A around it."""
    header, atoms = [], []
    serial = sum(1 for line in Path(path).read_text().splitlines() if line.startswith("ATOM"))
    for het_id, chain, resseq, center in ligands:
        if het_id == "HOH":
            elements, coords = ["O"], [center]
        else:
            elements = ["C"] * 5 + ["O"]
            coords = [(center[0] + 1.25 * np.cos(a), center[1] + 1.25 * np.sin(a), center[2])
                      for a in np.arange(6) * np.pi / 3]
        header.append(f"HET    {het_id:>3s}  {chain}{resseq:4d}  {len(elements):5d}")
        for i, (element, (x, y, z)) in enumerate(zip(elements, coords)):
            serial += 1
            atoms.append(f"HETATM{serial:5d} {element + str(i + 1):<4s}{het_id:>4s} {chain}"
                         f"{resseq:4d}    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          "
                         f"{element:>2s}")
    header += [f"HETNAM     {k:>3s} {v}" for k, v in (names or {}).items()]
    body = [line for line in Path(path).read_text().splitlines() if line != "END"]
    Path(path).write_text("\n".join(header + body + atoms + ["END"]) + "\n")


def write_synthetic_site(directory: str | Path, seed: int = 0, **pocket) -> tuple[Path, Path]:
    """A protein and its reference ligand for runs without real structures:
    `write_synthetic_pocket(seed, **pocket)` with one HET ligand ('LIG',
    chain A, residue 901) at the cavity's centre, as
    `<directory>/pocket.pdb`, and the ligand's HETATM records alone as
    `<directory>/ligand.pdb`. Returns (protein path, ligand path)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    protein, ligand = directory / "pocket.pdb", directory / "ligand.pdb"
    info = write_synthetic_pocket(protein, seed=seed, **pocket)
    append_het_ligands(protein, [("LIG", "A", 901, info["center"])], {"LIG": "SYNTHETIC LIGAND"})
    het = [line for line in protein.read_text().splitlines() if line.startswith("HETATM")]
    ligand.write_text("\n".join(het + ["END"]) + "\n")
    return protein, ligand
