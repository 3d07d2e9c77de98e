"""Packed ligand libraries: parse/perceive once, screen many times.

At million-ligand scale, file parsing and graph perception dominate once
scoring runs on the device. This module serializes PackedLigand batches
into a single flat-array .npz so screening runs skip the chemistry
pipeline entirely (the packed format is model-independent — one library
serves every pocket and weight setting). The format is the one
`pharmaconet_tpu` writes; libraries move between the packages unchanged.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np

from .batch_screen import PackedLigand


def pack_library(ligands: list[PackedLigand], names: list[str] | None = None) -> dict:
    """Flatten PackedLigands into contiguous arrays (ragged via offsets)."""
    num = len(ligands)
    node_offsets = np.zeros(num + 1, dtype=np.int64)
    cluster_offsets = np.zeros(num + 1, dtype=np.int64)
    member_offsets: list[int] = [0]
    members: list[np.ndarray] = []
    conformer_offsets = np.zeros(num + 1, dtype=np.int64)

    for i, lig in enumerate(ligands):
        node_offsets[i + 1] = node_offsets[i] + lig.node_pos.shape[0]
        cluster_offsets[i + 1] = cluster_offsets[i] + len(lig.clusters)
        for nodes in lig.clusters:
            members.append(np.asarray(nodes, dtype=np.int32))
            member_offsets.append(member_offsets[-1] + len(nodes))
        conformer_offsets[i + 1] = conformer_offsets[i] + lig.num_conformers

    # node positions are ragged in both nodes and conformers: store flat
    # [sum_i (Ln_i * C_i), 3] with per-ligand (Ln, C) to reshape on load
    node_pos_flat = np.concatenate(
        [lig.node_pos.reshape(-1, 3) for lig in ligands]
    ) if ligands else np.zeros((0, 3), np.float32)
    cluster_center_flat = np.concatenate(
        [lig.cluster_center.reshape(-1, 3) for lig in ligands]
    ) if ligands else np.zeros((0, 3), np.float32)
    cluster_size_flat = np.concatenate(
        [lig.cluster_size.reshape(-1) for lig in ligands]
    ) if ligands else np.zeros(0, np.float32)

    return dict(
        version=np.asarray(1),
        node_offsets=node_offsets,
        cluster_offsets=cluster_offsets,
        member_offsets=np.asarray(member_offsets, dtype=np.int64),
        members=np.concatenate(members) if members else np.zeros(0, np.int32),
        conformers=np.asarray([lig.num_conformers for lig in ligands], dtype=np.int32),
        node_mask=np.concatenate([lig.node_mask for lig in ligands])
        if ligands else np.zeros(0, np.int32),
        cluster_mask=np.concatenate([lig.cluster_mask for lig in ligands])
        if ligands else np.zeros(0, np.int32),
        node_pos=node_pos_flat.astype(np.float32),
        cluster_center=cluster_center_flat.astype(np.float32),
        cluster_size=cluster_size_flat.astype(np.float32),
        names=np.asarray(names if names is not None else [""] * num),
    )


def unpack_library(data: dict) -> tuple[list[PackedLigand], list[str]]:
    num = len(data["conformers"])
    out: list[PackedLigand] = []
    pos_cursor = 0
    center_cursor = 0
    for i in range(num):
        n0, n1 = int(data["node_offsets"][i]), int(data["node_offsets"][i + 1])
        c0, c1 = int(data["cluster_offsets"][i]), int(data["cluster_offsets"][i + 1])
        ln = n1 - n0
        nc = int(data["conformers"][i])
        node_pos = data["node_pos"][pos_cursor : pos_cursor + ln * nc].reshape(ln, nc, 3)
        pos_cursor += ln * nc
        num_clusters = c1 - c0
        cluster_center = data["cluster_center"][
            center_cursor : center_cursor + num_clusters * nc
        ].reshape(num_clusters, nc, 3)
        cluster_size = data["cluster_size"][
            center_cursor : center_cursor + num_clusters * nc
        ].reshape(num_clusters, nc)
        center_cursor += num_clusters * nc
        clusters = []
        for ci in range(c0, c1):
            m0, m1 = int(data["member_offsets"][ci]), int(data["member_offsets"][ci + 1])
            clusters.append([int(v) for v in data["members"][m0:m1]])
        out.append(
            PackedLigand(
                node_pos=np.ascontiguousarray(node_pos),
                node_mask=np.ascontiguousarray(data["node_mask"][n0:n1]),
                clusters=clusters,
                cluster_mask=np.ascontiguousarray(data["cluster_mask"][c0:c1]),
                cluster_center=np.ascontiguousarray(cluster_center),
                cluster_size=np.ascontiguousarray(cluster_size),
                num_conformers=nc,
            )
        )
    names = [str(n) for n in data["names"]]
    return out, names


def save_library(path: str | Path, ligands: list[PackedLigand], names: list[str] | None = None) -> None:
    buffer = io.BytesIO()
    np.savez_compressed(buffer, **pack_library(ligands, names))
    Path(path).write_bytes(buffer.getvalue())


def load_library(path: str | Path) -> tuple[list[PackedLigand], list[str]]:
    data = np.load(path, allow_pickle=False)
    return unpack_library({k: data[k] for k in data.files})


def build_library_from_files(
    files: list[str | Path], num_conformers: int | None = None, cpus: int = 1
) -> tuple[list[PackedLigand], list[str]]:
    """Parse + perceive + pack a list of ligand files (skips failures).

    cpus > 1 parses in a process pool (scoring/parse_pool.py)."""
    from .parse_pool import iter_parsed

    packed: list[PackedLigand] = []
    names: list[str] = []
    for path_str, ligand in iter_parsed(files, cpus=cpus, num_conformers=num_conformers):
        try:
            packed.append(PackedLigand.from_ligand(ligand))
        except Exception:  # noqa: BLE001 - tolerant library building
            continue
        names.append(path_str)
    return packed, names


def read_smiles_file(path: str | Path) -> list[tuple[str, str]]:
    """Read a .smi/.txt SMILES library: one 'SMILES [name]' per line.

    Whitespace- or comma-separated; lines starting with '#' are comments
    ('#' inside the first field is the SMILES triple bond, never a
    comment); a missing name defaults to the 0-based position mol<idx>."""
    entries: list[tuple[str, str]] = []
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        fields = line.replace(",", " ").split()
        smi = fields[0]
        # anything from a '#'-led token onward is a trailing comment
        name = None
        for tok in fields[1:]:
            if tok.startswith("#"):
                break
            name = tok
            break
        entries.append((name or f"mol{len(entries)}", smi))
    return entries


def build_library_from_smiles(
    path: str | Path,
    num_conformers: int = 8,
    cpus: int = 1,
    seed: int = 2025,
    embed_backend: str = "auto",
    device: str = "cuda",
) -> tuple[list[PackedLigand], list[str]]:
    """Parse + embed + perceive + pack a SMILES library (skips failures).

    Upstream's scoring_smiles embeds one molecule per call with RDKit
    (pharmacophore_model.py:92-99); here a whole .smi file prepacks
    through chem/embed.py (see cli/prepack.py for the persisted form that
    composes with tile stores and resume).

    embed_backend "auto" embeds with the torch backend on `device` when
    that is a CUDA device and no worker pool was requested (cpus <= 1), and
    with numpy otherwise; "numpy"/"torch" force one. Unless the backend is
    "numpy", `device` cuda without a card raises."""
    from ..device import resolve_device
    from .parse_pool import iter_embedded

    if embed_backend != "numpy":
        device = resolve_device(device)
    if embed_backend == "auto":
        embed_backend = "torch" if cpus <= 1 and device.type == "cuda" else "numpy"

    entries = read_smiles_file(path)
    packed: list[PackedLigand] = []
    names: list[str] = []
    for name, ligand in iter_embedded(
        entries, cpus=cpus, num_conformers=num_conformers, seed=seed,
        backend=embed_backend, device=device,
    ):
        try:
            packed.append(PackedLigand.from_ligand(ligand))
        except Exception:  # noqa: BLE001 - tolerant library building
            continue
        names.append(name)
    return packed, names
