"""The modeling cells' pockets, written from the seed.

`write_synthetic_pocket`, `residue_geometry` and their helpers are the
program's `synthetic.py` copied, so that a change to the program cannot
move the inputs its benchmark runs: a PDB of standard residues (template
atom names, chain A) packed at random around an empty spherical cavity.
`write_pockets` draws a traffic mix's pockets: each its own packing seed
and a centre of its own, so that no two pockets of a pass are alike and
no program cache keyed by path or content can serve one pocket twice.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

from residue_templates import RESIDUE_TEMPLATES


def seed_sequence(seed: int, *stream: int) -> np.random.SeedSequence:
    """Any whole number, negative or above 64 bits included, as a seed."""
    return np.random.SeedSequence([seed % 2**64, *stream])


def write_pockets(directory: str | Path, seed: int, traffic: dict) -> list[dict]:
    """The mix's `pockets` pockets as `<directory>/pocket_<i>.pdb`, each
    with `atoms_per_pocket` heavy atoms between `cavity_radius` and
    `outer_radius` of a centre drawn uniformly within `center_range`
    angstrom of the origin on each axis (not on the 0.001 A lattice of
    the PDB's coordinates, so no atom lies exactly on a voxel's radius).
    Returns [{"path", "center", "num_atoms", "num_residues"}]."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed_sequence(seed, 0))
    lim = float(traffic["center_range"])
    centers = rng.uniform(-lim, lim, size=(int(traffic["pockets"]), 3))
    seeds = rng.integers(2**63, size=len(centers))
    out = []
    for i, (center, pocket_seed) in enumerate(zip(centers, seeds)):
        path = directory / f"pocket_{i}.pdb"
        info = write_synthetic_pocket(
            path, seed=int(pocket_seed), center=tuple(float(v) for v in center),
            num_atoms=int(traffic["atoms_per_pocket"]),
            cavity_radius=float(traffic["cavity_radius"]),
            outer_radius=float(traffic["outer_radius"]))
        out.append(dict(info, path=str(path)))
    return out


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
