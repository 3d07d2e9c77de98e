"""The detector's plain reference: PharmacoNet's pocket modeling in plain
torch float32, from a pocket's PDB file and the weights the benchmark
drew, to each kept hotspot's density map and the graph's nodes.

Written from upstream PharmacoNet (https://github.com/SeonghwanSeo/PharmacoNet,
src/pmnet: data/token_inference.py, data/pointcloud.py, network/,
module.py, utils/density_map.py). Imports torch, numpy and the
benchmark's frozen residue table, nothing of the program and no kernel.
Matrix products and convolutions run in float32 with TF32 off
(`float32_scope`). Stages, each a function of its own:

  * `perceive`: pocket residues within 16*sqrt(3)+5 A of the centre,
    heavy atoms; interaction tokens (hydrophobic carbons, rings three
    times, cations twice, acceptors, donors, anions, X-bond acceptors, in
    upstream's order) quantized to the grid; 33-channel atom features.
  * `voxelize`: per voxel the atoms within 1.5 A, exp(-d^2 / (2 (r/3)^2))
    times their features, and occupancy within 1.0 A. Voxel centres and
    d^2 = (dx*dx + dy*dy) + dz*dz are taken in f32 in that order, as the
    published arithmetic states, so an atom near a radius falls on the
    same side as in any f32 implementation of it.
  * `trunk`: SwinV2-3D (patch embed, cosine window attention with a
    continuous position bias, res-post-norm blocks, patch merging) and the
    FPN over the input and the four scales.
  * `heads`: cavity logits, token scores and features, relative scores
    against the score distributions, and the keep gate.
  * `segment`: the mask head per hotspot (each conditions the whole
    pyramid with its own embeddings), then mask, Gaussian smoothing and
    the box threshold.
  * `graph_nodes`: 26-connected components of a map with at least 8
    voxels, as the graph's nodes: centre, radius, in upstream's order.

Upstream quirks kept, as the published checkpoint was trained with them:
the shifted blocks roll only the first two spatial axes while their
attention mask is built for three; the position-bias table divides only
its first three W-offset slices by (window - 1); a stage whose resolution
is not above the window runs one unshifted window of its whole size.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from residue_templates import (
    BACKBONE_ACCEPTORS,
    BACKBONE_DONOR,
    POCKET_AMINO_ACIDS,
    RESIDUE_TEMPLATES,
    RING_RESIDUES,
)

# upstream data/constant.py and module.py
INTERACTIONS = ("Hydrophobic", "PiStacking_P", "PiStacking_T", "PiCation_lring",
                "PiCation_pring", "HBond_ldon", "HBond_pdon", "SaltBridge_lneg",
                "SaltBridge_pneg", "XBond")
INTERACTION_DIST = (4.5, 6.0, 6.0, 6.5, 6.5, 4.5, 4.5, 6.0, 6.0, 4.5)
LONG_INTERACTIONS = (1, 2, 3, 4, 7, 8)  # gate on the wide cavity
SCORE_THRESHOLD = (0.85, 0.7, 0.7, 0.7, 0.7, 0.85, 0.85, 0.7, 0.7, 0.85)
PHARMACOPHORE_SIZE = 1.0
POCKET_CUTOFF = 16.0 * math.sqrt(3.0) + 5.0
FEATURE_RADIUS, MASK_RADIUS, VOXEL_SIGMA = 1.5, 1.0, 1.0 / 3.0
FOCUS_THRESHOLD = BOX_THRESHOLD = 0.5
MIN_NODE_VOXELS = 8
LN_EPS = BN_EPS = 1e-5
ATOM_Z = (6, 7, 8, 16)  # channels 0-3; anything else is channel 4
AMINO_ACIDS = ("GLY", "ALA", "VAL", "LEU", "ILE", "PRO", "PHE", "TYR", "TRP", "SER", "THR",
               "CYS", "MET", "ASN", "GLN", "ASP", "GLU", "LYS", "ARG", "HIS")  # then UNK
ELEMENT_Z = {"H": 1, "C": 6, "N": 7, "O": 8, "S": 16, "SE": 34}


@contextlib.contextmanager
def float32_scope():
    """Matrix products and cuDNN convolutions in float32, TF32 off; the
    previous flags come back after the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


# --------------------------------------------------------------------------
# Weights: names and shapes of the upstream checkpoint
# --------------------------------------------------------------------------
def widths(cfg: dict) -> dict:
    depths = tuple(cfg["depths"])
    return dict(cin=int(cfg["in_channels"]), dim=int(cfg["embed_dim"]), depths=depths,
                heads=tuple(cfg["num_heads"]), window=int(cfg["window"]),
                fpn=int(cfg["fpn_channels"]), tok=int(cfg["token_feature_dim"]),
                ninter=int(cfg["num_interactions"]), levels=len(depths) + 1,
                convs=(1,) + (2,) * len(depths), grid=int(cfg["grid_dim"]))


def param_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the upstream checkpoint's
    state dict, in its order. Kinds: 'w' a weight (fan-in from the shape),
    'b' a bias, 'ln_w'/'ln_b', 'bn_w'/'bn_b'/'bn_mean'/'bn_var',
    'logit_scale', 'embed'."""
    W = widths(cfg)
    out: list[tuple[str, tuple[int, ...], str]] = []

    def add(name, shape, kind):
        out.append((name, tuple(int(s) for s in shape), kind))

    def linear(p, din, dout, bias=True):
        add(f"{p}.weight", (dout, din), "w")
        if bias:
            add(f"{p}.bias", (dout,), "b")

    def ln(p, d):
        add(f"{p}.weight", (d,), "ln_w")
        add(f"{p}.bias", (d,), "ln_b")

    def base_conv(p, cin, cout, k, norm=True):
        add(f"{p}._conv.weight", (cout, cin, k, k, k), "w")
        if norm:
            for part, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                               ("running_mean", "bn_mean"), ("running_var", "bn_var")):
                add(f"{p}._norm.{part}", (cout,), kind)
        else:
            add(f"{p}._conv.bias", (cout,), "b")

    def fpn(p, channels):
        n = len(channels)
        for level in range(n - 1):
            base_conv(f"{p}.lateral_conv_list.{level}", channels[level], W["fpn"], 1)
        for level in range(n):
            for j in range(W["convs"][level]):
                cin = channels[level] if (level == n - 1 and j == 0) else W["fpn"]
                base_conv(f"{p}.fpn_convs_list.{level}.{j}", cin, W["fpn"], 3)

    b = "embedding.backbone"
    add(f"{b}.patch_embed.proj.weight", (W["dim"], W["cin"], 2, 2, 2), "w")
    add(f"{b}.patch_embed.proj.bias", (W["dim"],), "b")
    ln(f"{b}.patch_embed.norm", W["dim"])
    n = len(W["depths"])
    for i in range(n):
        dim, nh = W["dim"] * 2**i, W["heads"][i]
        for j in range(W["depths"][i]):
            p = f"{b}.layers.{i}.blocks.{j}"
            add(f"{p}.attn.logit_scale", (nh, 1, 1), "logit_scale")
            add(f"{p}.attn.q_bias", (dim,), "b")
            add(f"{p}.attn.v_bias", (dim,), "b")
            linear(f"{p}.attn.qkv", dim, 3 * dim, bias=False)
            linear(f"{p}.attn.cpb_mlp.0", 3, 512)
            linear(f"{p}.attn.cpb_mlp.2", 512, nh, bias=False)
            linear(f"{p}.attn.proj", dim, dim)
            ln(f"{p}.norm1", dim)
            linear(f"{p}.mlp.fc1", dim, 4 * dim)
            linear(f"{p}.mlp.fc2", 4 * dim, dim)
            ln(f"{p}.norm2", dim)
        if i < n - 1:
            linear(f"{b}.layers.{i}.downsample.reduction", 8 * dim, 2 * dim, bias=False)
            ln(f"{b}.layers.{i}.downsample.norm", 2 * dim)
    for i in range(n):
        ln(f"{b}.norm{i}", W["dim"] * 2**i)
    fpn("embedding.decoder", (W["cin"],) + tuple(W["dim"] * 2**i for i in range(n)))
    for head in ("short_head", "long_head"):
        base_conv(f"cavity_head.{head}.0", W["fpn"], W["fpn"], 3)
        base_conv(f"cavity_head.{head}.1", W["fpn"], 1, 1, norm=False)
    add("token_head.interaction_embedding.weight", (W["ninter"], W["fpn"]), "embed")
    for i in range(3):
        linear(f"token_head.feature_mlp.{2 * i}", 2 * W["fpn"] if i == 0 else W["tok"], W["tok"])
    for i in range(3):
        linear(f"token_head.score_mlp.{2 * i}", W["tok"], W["tok"] if i < 2 else 1)
    if 2 * W["fpn"] != W["tok"]:
        linear("token_head.skip", 2 * W["fpn"], W["tok"])
    for level in range(W["levels"]):
        linear(f"mask_head.background_mlp_list.{level}", W["tok"], W["fpn"])
        linear(f"mask_head.point_mlp_list.{level}", W["tok"], W["fpn"])
    fpn("mask_head.decoder", (W["fpn"],) * W["levels"])
    add("mask_head.conv_logits.weight", (1, W["fpn"], 1, 1, 1), "w")
    add("mask_head.conv_logits.bias", (1,), "b")
    return out


def draw_weights(cfg: dict, seed: int, device, init: dict) -> dict[str, torch.Tensor]:
    """Every tensor of the checkpoint from the seed, on `device` in
    float32: one normal draw of all of them from a generator on the
    device, then scaled by kind. Weights get std `init['gain']` /
    sqrt(fan-in) (He's sqrt(2) for the convolutions, which a ReLU
    follows); norms sit near identity; `init['bias']` names the biases of
    the few outputs whose offset sets how much of a map passes a
    threshold (cavity and mask logits)."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in shapes:
        z = flat[at: at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        if kind == "w":
            fan_in = math.prod(shape[1:])
            gain = math.sqrt(2.0) if len(shape) == 5 else float(init["gain"])
            v = z * (gain / math.sqrt(fan_in))
        elif kind == "b":
            v = z * float(init["bias_std"])
        elif kind == "ln_w":
            v = 1.0 + 0.1 * z
        elif kind == "ln_b" or kind == "bn_b" or kind == "bn_mean":
            v = 0.1 * z
        elif kind == "bn_w" or kind == "bn_var":
            v = 1.0 + 0.1 * z.abs()
        elif kind == "logit_scale":
            v = torch.full(shape, math.log(10.0), device=device)
        else:  # embed
            v = z
        out[name] = v
    for name, value in init["bias"].items():
        out[name] = out[name] + float(value)
    return out


# --------------------------------------------------------------------------
# Pocket perception (host, numpy)
# --------------------------------------------------------------------------
@dataclass
class Pocket:
    center: np.ndarray  # [3] f32
    tokens: np.ndarray  # [T, 4] int64: voxel x, y, z and interaction type
    token_positions: np.ndarray  # [T, 3] f32
    atom_positions: np.ndarray  # [A, 3] f32
    atom_features: np.ndarray  # [A, 33] f32


def read_pdb(path: str | Path) -> list[tuple[str, str, list[tuple[str, int, tuple]]]]:
    """Residues of the first model in file order: (name, chain, atoms),
    each atom (name, atomic number, (x, y, z)); the first alternate
    location of an atom only."""
    residues, index, seen = [], {}, set()
    for line in Path(path).read_text().splitlines():
        if line.startswith("ENDMDL"):
            break
        if not line.startswith(("ATOM  ", "HETATM")) or len(line) < 54:
            continue
        name, altloc, resname = line[12:16].strip(), line[16], line[17:20].strip()
        chain, key = line[21], (line[21], line[22:27], line[17:20])
        if altloc.strip() and (key, name) in seen:
            continue
        seen.add((key, name))
        element = line[76:78].strip().upper()
        xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
        if key not in index:
            index[key] = len(residues)
            residues.append((resname, chain, []))
        residues[index[key]][2].append((name, ELEMENT_Z.get(element, 0), xyz))
    return residues


def perceive(pdb_path: str | Path, center, grid: int, resolution: float) -> Pocket:
    """The pocket's tokens and atom features (upstream token_inference.py
    and pointcloud.py, OpenBabel's perception read from residue templates)."""
    center = np.asarray(center, dtype=np.float32)
    c64 = center.astype(np.float64)
    residues = []
    for name, chain, atoms in read_pdb(pdb_path):
        if name not in POCKET_AMINO_ACIDS:
            continue
        heavy = [a for a in atoms if "H" not in a[0]]
        if not heavy or np.min(np.linalg.norm(np.array([a[2] for a in heavy]) - c64,
                                              axis=-1)) >= POCKET_CUTOFF:
            continue
        kept = [a for a in atoms if a[1] not in (0, 1)]
        if kept:
            if name not in RESIDUE_TEMPLATES:
                raise NotImplementedError(f"no template for residue {name}")
            residues.append((name, chain, kept))
    atoms = [(res_i, *a) for res_i, (_, _, ats) in enumerate(residues) for a in ats]
    z = np.array([a[2] for a in atoms], dtype=np.int64)
    xyz = np.array([a[3] for a in atoms], dtype=np.float64)
    by_name = [{} for _ in residues]
    for i, a in enumerate(atoms):
        by_name[a[0]][a[1]] = i

    adj = [set() for _ in atoms]

    def bond(i, j):
        adj[i].add(j)
        adj[j].add(i)

    for r, (name, _, _) in enumerate(residues):
        for a, b in RESIDUE_TEMPLATES[name].bonds:
            if a in by_name[r] and b in by_name[r]:
                bond(by_name[r][a], by_name[r][b])
    for r in range(1, len(residues)):  # peptide links of consecutive residues
        c, n = by_name[r - 1].get("C"), by_name[r].get("N")
        if residues[r - 1][1] == residues[r][1] and c is not None and n is not None \
                and np.linalg.norm(xyz[c] - xyz[n]) < 1.8:
            bond(c, n)
    sg = [by_name[r]["SG"] for r, res in enumerate(residues)
          if res[0] in ("CYS", "CYX") and "SG" in by_name[r]]
    for k, i in enumerate(sg):  # disulfide links
        for j in sg[k + 1:]:
            if np.linalg.norm(xyz[i] - xyz[j]) < 2.5:
                bond(i, j)

    polar = np.isin(z, ATOM_Z)  # not water: no HOH passes the residue filter
    hydrophobic = [i for i in range(len(atoms))
                   if z[i] == 6 and polar[i] and all(z[j] == 6 for j in adj[i])]

    def group(names, r):
        members = [by_name[r][n] for n in names if n in by_name[r]]
        return members

    rings, cations, anions = [], [], []
    for r, (name, _, _) in enumerate(residues):
        t = RESIDUE_TEMPLATES[name]
        if name in RING_RESIDUES:
            for ring in t.rings:
                if all(n in by_name[r] for n in ring):
                    rings.append([by_name[r][n] for n in ring])
        if group(t.pos_charged, r):
            cations.append(group(t.pos_charged, r))
        if group(t.neg_charged, r):
            anions.append(group(t.neg_charged, r))
    donors, acceptors = [], []
    for i, a in enumerate(atoms):
        name, t = residues[a[0]][0], RESIDUE_TEMPLATES[residues[a[0]][0]]
        if not polar[i]:
            continue
        if (a[1] == BACKBONE_DONOR and name != "PRO") or a[1] in t.donors:
            donors.append(i)
        if a[1] in BACKBONE_ACCEPTORS or a[1] in t.acceptors:
            acceptors.append(i)
    xbond = []
    for i in range(len(atoms)):
        if polar[i] and z[i] in (7, 8, 16):
            ys = [j for j in sorted(adj[i]) if z[j] in (6, 7, 16)]
            if len(ys) == 1:
                xbond.append((i, ys[0]))

    def mean(idx):
        return tuple(np.mean([tuple(xyz[i]) for i in idx], axis=0).tolist())

    emitted = ([(tuple(xyz[i]), 0) for i in hydrophobic]
               + [(mean(g), 1) for g in rings] + [(mean(g), 2) for g in rings]
               + [(mean(g), 3) for g in cations] + [(mean(g), 4) for g in rings]
               + [(tuple(xyz[i]), 5) for i in acceptors] + [(tuple(xyz[i]), 6) for i in donors]
               + [(mean(g), 7) for g in cations] + [(mean(g), 8) for g in anions]
               + [(tuple(xyz[i]), 9) for i, _ in xbond])
    pos = np.array([p for p, _ in emitted], dtype=np.float32).reshape(-1, 3)
    cls = np.array([c for _, c in emitted], dtype=np.int64)
    start = c64 - (grid / 2) * resolution
    vox = np.floor((pos.astype(np.float64) - start) / resolution).astype(np.int64)
    inside = np.all((vox >= 0) & (vox < grid), axis=1)
    tokens = np.concatenate([vox[inside], cls[inside, None]], axis=1)

    feats = np.zeros((len(atoms), 33), dtype=np.float32)
    for i, a in enumerate(atoms):
        feats[i, ATOM_Z.index(z[i]) if z[i] in ATOM_Z else 4] = 1.0
        name = residues[a[0]][0]
        feats[i, 5 + (AMINO_ACIDS.index(name) if name in AMINO_ACIDS else 20)] = 1.0
    feats[hydrophobic, 26] = 1.0
    for g in rings:
        feats[g, 27] = 1.0
    feats[donors, 28] = 1.0
    feats[acceptors, 29] = 1.0
    for g in cations:
        feats[g, 30] = 1.0
    for g in anions:
        feats[g, 31] = 1.0
    for i, j in xbond:
        feats[[i, j], 32] = 1.0
    return Pocket(center, tokens, pos[inside], xyz.astype(np.float32), feats)


# --------------------------------------------------------------------------
# Voxelization
# --------------------------------------------------------------------------
def voxelize(pocket: Pocket, grid: int, resolution: float, device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """([C, D, H, W] image, [D, H, W] occupancy) of the pocket's atoms,
    one x slab at a time."""
    f32 = torch.float32
    pos = torch.as_tensor(pocket.atom_positions, dtype=f32, device=device)
    feats = torch.as_tensor(pocket.atom_features, dtype=f32, device=device)
    center = torch.as_tensor(pocket.center, dtype=f32, device=device)
    half = torch.tensor(resolution * (grid - 1) / 2, dtype=f32, device=device)
    res = torch.tensor(resolution, dtype=f32, device=device)
    idx = torch.arange(grid, dtype=f32, device=device)
    axes = (center - half)[:, None] + idx[None, :] * res  # [3, grid]
    inv = 1.0 / (2.0 * (VOXEL_SIGMA * FEATURE_RADIUS) ** 2)
    image = torch.empty((grid, grid, grid, feats.shape[1]), dtype=f32, device=device)
    occupied = torch.empty((grid, grid, grid), dtype=torch.bool, device=device)
    dy = axes[1][:, None, None] - pos[None, None, :, 1]  # [grid, 1, A]
    dz = axes[2][None, :, None] - pos[None, None, :, 2]  # [1, grid, A]
    dyz = dy * dy
    dzz = dz * dz
    for ix in range(grid):
        dx = axes[0][ix] - pos[:, 0]
        d2 = (dx * dx)[None, None, :] + dyz
        d2 = d2 + dzz  # [grid, grid, A]
        rbf = torch.where(d2 <= FEATURE_RADIUS ** 2, torch.exp(-d2 * inv), 0.0)
        image[ix] = (rbf.reshape(grid * grid, -1) @ feats).reshape(grid, grid, -1)
        occupied[ix] = (d2 <= MASK_RADIUS ** 2).any(dim=-1)
    return image.permute(3, 0, 1, 2), occupied


# --------------------------------------------------------------------------
# The network
# --------------------------------------------------------------------------
def _linear(x, w, p, bias=True):
    return F.linear(x, w[f"{p}.weight"], w[f"{p}.bias"] if bias else None)


def _ln(x, w, p):
    return F.layer_norm(x, x.shape[-1:], w[f"{p}.weight"], w[f"{p}.bias"], LN_EPS)


def _conv(x, w, p, k, norm=True, act=True):
    """Conv3d (bias only without a norm), inference BatchNorm, ReLU."""
    x = F.conv3d(x, w[f"{p}._conv.weight"], None if norm else w[f"{p}._conv.bias"],
                 padding=(k - 1) // 2)
    if norm:
        inv = w[f"{p}._norm.weight"] * torch.rsqrt(w[f"{p}._norm.running_var"] + BN_EPS)
        shift = w[f"{p}._norm.bias"] - w[f"{p}._norm.running_mean"] * inv
        x = x * inv.view(1, -1, 1, 1, 1) + shift.view(1, -1, 1, 1, 1)
    return F.relu(x) if act else x


def cpb_table(window: int) -> np.ndarray:
    """Log-spaced relative coordinates [(2w-1)^3, 3]; upstream divides only
    the first three W-offset slices by (w - 1) (quirk kept)."""
    r = np.arange(-(window - 1), window, dtype=np.float32)
    t = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    t[:, :, : min(3, t.shape[2]), :] /= np.float32(max(window - 1, 1))
    t *= np.float32(8.0)
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.float32(3.0)
    return t.reshape(-1, 3).astype(np.float32)


def relative_index(window: int) -> np.ndarray:
    c = np.stack(np.meshgrid(*[np.arange(window)] * 3, indexing="ij")).reshape(3, -1)
    rel = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (window - 1)
    span = 2 * window - 1
    return (rel[..., 0] * span * span + rel[..., 1] * span + rel[..., 2]).reshape(-1)


def _windows(x, w):
    """[B, D, H, W, C] -> [B * windows, w^3, C], windows in (d, h, w) order."""
    b, d, h, ww, c = x.shape
    x = x.reshape(b, d // w, w, h // w, w, ww // w, w, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, w ** 3, c)


def _unwindows(x, w, b, d, h, ww):
    c = x.shape[-1]
    x = x.reshape(b, d // w, h // w, ww // w, w, w, w, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, ww, c)


def shift_mask(res: int, window: int, shift: int) -> np.ndarray:
    """[windows, w^3, w^3] of 0 and -100: the regions of the three-axis
    cyclic shift (quirk kept: the roll itself moves two axes)."""
    img = np.zeros((1, res, res, res, 1), dtype=np.float32)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    n = 0
    for a in cuts:
        for b in cuts:
            for c in cuts:
                img[:, a, b, c, :] = n
                n += 1
    lab = _windows(torch.from_numpy(img), window)[..., 0].numpy()
    return np.where(lab[:, None, :] != lab[:, :, None], -100.0, 0.0).astype(np.float32)


def _block(x, w, p, res, heads, window, shift):
    b, length, c = x.shape
    hd = c // heads
    dev = x.device
    y = x.reshape(b, res, res, res, c)
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    win = _windows(y, window)  # [bw, n, c]
    bw, n, _ = win.shape
    bias = torch.cat([w[f"{p}.attn.q_bias"], torch.zeros_like(w[f"{p}.attn.q_bias"]),
                      w[f"{p}.attn.v_bias"]])
    qkv = F.linear(win, w[f"{p}.attn.qkv.weight"], bias)
    q, k, v = qkv.reshape(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    k = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = torch.exp(torch.clamp(w[f"{p}.attn.logit_scale"], max=math.log(100.0)))
    attn = torch.matmul(q, k.transpose(-2, -1)) * scale
    table = torch.from_numpy(cpb_table(window)).to(dev)
    table = _linear(F.relu(_linear(table, w, f"{p}.attn.cpb_mlp.0")), w,
                    f"{p}.attn.cpb_mlp.2", bias=False)
    rel = table[torch.from_numpy(relative_index(window)).to(dev)].reshape(n, n, heads)
    attn = attn + 16.0 * torch.sigmoid(rel.permute(2, 0, 1))[None]
    if shift:
        mask = torch.from_numpy(shift_mask(res, window, shift)).to(dev)
        attn = (attn.reshape(bw // mask.shape[0], mask.shape[0], heads, n, n)
                + mask[None, :, None]).reshape(bw, heads, n, n)
    out = torch.matmul(torch.softmax(attn, dim=-1), v).transpose(1, 2).reshape(bw, n, c)
    out = _linear(out, w, f"{p}.attn.proj")
    y = _unwindows(out, window, b, res, res, res)
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    x = x + _ln(y.reshape(b, length, c), w, f"{p}.norm1")
    mlp = _linear(F.gelu(_linear(x, w, f"{p}.mlp.fc1")), w, f"{p}.mlp.fc2")
    return x + _ln(mlp, w, f"{p}.norm2")


PARITY = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def backbone(image: torch.Tensor, w: dict, cfg: dict) -> list[torch.Tensor]:
    """SwinV2-3D: [1, C, D, H, W] -> four scales [1, C_i, d_i, d_i, d_i]."""
    W = widths(cfg)
    b = "embedding.backbone"
    x = F.conv3d(image, w[f"{b}.patch_embed.proj.weight"], w[f"{b}.patch_embed.proj.bias"],
                 stride=2)
    res = x.shape[-1]
    x = _ln(x.flatten(2).transpose(1, 2), w, f"{b}.patch_embed.norm")
    outs = []
    for i, depth in enumerate(W["depths"]):
        window = min(W["window"], res)
        for j in range(depth):
            shift = W["window"] // 2 if (j % 2 and res > W["window"]) else 0
            x = _block(x, w, f"{b}.layers.{i}.blocks.{j}", res, W["heads"][i], window, shift)
        dim = x.shape[-1]
        outs.append(_ln(x, w, f"{b}.norm{i}").reshape(1, res, res, res, dim)
                    .permute(0, 4, 1, 2, 3))
        if i < len(W["depths"]) - 1:
            y = x.reshape(1, res, res, res, dim)
            y = torch.cat([y[:, a::2, c::2, e::2, :] for a, c, e in PARITY], dim=-1)
            y = F.linear(y.reshape(1, -1, 8 * dim), w[f"{b}.layers.{i}.downsample.reduction.weight"])
            x = _ln(y, w, f"{b}.layers.{i}.downsample.norm")
            res //= 2
    return outs


def fpn(features: list[torch.Tensor], w: dict, p: str, convs: tuple) -> list[torch.Tensor]:
    """Top-down FPN over bottom-up features (highest resolution first);
    returns the levels lowest resolution first."""
    n, outs, x = len(features), [], None
    for level in range(n - 1, -1, -1):
        if level == n - 1:
            x = features[level]
        else:
            up = F.interpolate(x, scale_factor=2, mode="nearest")
            x = _conv(features[level], w, f"{p}.lateral_conv_list.{level}", 1) + up
        for j in range(convs[level]):
            x = _conv(x, w, f"{p}.fpn_convs_list.{level}.{j}", 3)
        outs.append(x)
    return outs


def trunk(image: torch.Tensor, w: dict, cfg: dict) -> list[torch.Tensor]:
    """The embedding: [C, D, H, W] image -> the pyramid, lowest resolution
    first, each [1, 96, d, d, d]."""
    x = image[None]
    return fpn([x, *backbone(x, w, cfg)], w, "embedding.decoder", widths(cfg)["convs"])


@dataclass
class Heads:
    cavity_narrow: torch.Tensor  # [D, H, W] probabilities
    cavity_wide: torch.Tensor
    abs_scores: torch.Tensor  # [T]
    rel_scores: torch.Tensor  # [T]
    token_cavity: torch.Tensor  # [T] the gating cavity's probability at the token
    keep: torch.Tensor  # [T] bool
    token_features: torch.Tensor  # [T, 192]


def heads(top: torch.Tensor, tokens: torch.Tensor, w: dict,
          distributions: list[torch.Tensor]) -> Heads:
    """Cavity and token heads on the highest-resolution level [1, 96, D, H, W],
    the relative scores (the share of the type's distribution below the
    score) and the keep gate: in the type's cavity and at or above the
    type's threshold."""
    narrow = torch.sigmoid(_conv(_conv(top, w, "cavity_head.short_head.0", 3), w,
                                 "cavity_head.short_head.1", 1, norm=False, act=False))[0, 0]
    wide = torch.sigmoid(_conv(_conv(top, w, "cavity_head.long_head.0", 3), w,
                               "cavity_head.long_head.1", 1, norm=False, act=False))[0, 0]
    t = tokens.long()
    vox = top[0][:, t[:, 0], t[:, 1], t[:, 2]].T
    x = torch.cat([vox, w["token_head.interaction_embedding.weight"][t[:, 3]]], dim=-1)
    h = x
    for i in range(3):
        h = F.silu(_linear(h, w, f"token_head.feature_mlp.{2 * i}"))
    skip = _linear(x, w, "token_head.skip") if "token_head.skip.weight" in w else x
    feats = skip + h
    s = F.relu(_linear(feats, w, "token_head.score_mlp.0"))
    s = F.relu(_linear(s, w, "token_head.score_mlp.2"))
    abs_scores = torch.sigmoid(_linear(s, w, "token_head.score_mlp.4")[:, 0])
    rel = torch.zeros_like(abs_scores)
    for c, dist in enumerate(distributions):
        of = t[:, 3] == c
        below = torch.searchsorted(dist, abs_scores[of], right=False).float()
        # a true f32 division (a scalar divisor may run as a product with
        # its reciprocal on a card, one rounding more)
        rel[of] = below / torch.full_like(below, len(dist))
    is_long = torch.isin(t[:, 3], torch.tensor(LONG_INTERACTIONS, device=t.device))
    cav = torch.where(is_long, wide[t[:, 0], t[:, 1], t[:, 2]], narrow[t[:, 0], t[:, 1], t[:, 2]])
    thresholds = torch.tensor(SCORE_THRESHOLD, device=t.device)[t[:, 3]]
    keep = (cav > FOCUS_THRESHOLD) & (rel >= thresholds)
    return Heads(narrow, wide, abs_scores, rel, cav, keep, feats)


def mask_logits(pyramid: list[torch.Tensor], tokens: torch.Tensor, feats: torch.Tensor,
                w: dict, cfg: dict) -> torch.Tensor:
    """The mask head for K hotspots: [K, D, H, W] logits. Each hotspot adds
    its background embedding to every voxel of each level and its point
    embedding at its own voxel, then runs the head's FPN."""
    levels = pyramid[::-1]  # highest resolution first
    full = levels[0].shape[-1]
    t = tokens.long()
    k = len(t)
    conditioned = []
    for level, x in enumerate(levels):
        scale = full // x.shape[-1]
        bg = _linear(feats, w, f"mask_head.background_mlp_list.{level}")
        pt = _linear(feats, w, f"mask_head.point_mlp_list.{level}")
        y = x.expand(k, -1, -1, -1, -1) + bg[:, :, None, None, None]
        y[torch.arange(k), :, t[:, 0] // scale, t[:, 1] // scale, t[:, 2] // scale] += pt
        conditioned.append(y)
    top = fpn(conditioned, w, "mask_head.decoder", widths(cfg)["convs"])[-1]
    return F.conv3d(top, w["mask_head.conv_logits.weight"], w["mask_head.conv_logits.bias"])[:, 0]


def gaussian_smooth(maps: torch.Tensor) -> torch.Tensor:
    """5-tap Gaussian (sigma 0.5) along each spatial axis, zero padding."""
    x = np.arange(5, dtype=np.float64) - 2.0
    g = np.exp(-(x / 0.5) ** 2 / 2)
    g = torch.tensor(g / g.sum(), dtype=torch.float32, device=maps.device)
    y = maps[:, None]
    for shape in ((5, 1, 1), (1, 5, 1), (1, 1, 5)):
        y = F.conv3d(y, g.view(1, 1, *shape), padding=tuple(s // 2 for s in shape))
    return y[:, 0]


def box_mask(tokens: torch.Tensor, grid: int, resolution: float) -> torch.Tensor:
    """[K, D, H, W]: voxels nearer each token than ceil((interaction
    distance + 1 A) / resolution) voxels."""
    t = tokens.long()
    radii = torch.tensor([math.ceil((d + PHARMACOPHORE_SIZE) / resolution)
                          for d in INTERACTION_DIST], dtype=torch.float32, device=t.device)
    ax = torch.arange(grid, dtype=torch.float32, device=t.device)
    tf = t.float()
    d2 = ((ax[None] - tf[:, 0:1]) ** 2)[:, :, None, None] + \
        ((ax[None] - tf[:, 1:2]) ** 2)[:, None, :, None] + \
        ((ax[None] - tf[:, 2:3]) ** 2)[:, None, None, :]
    return d2 < (radii[t[:, 3]] ** 2)[:, None, None, None]


def density_maps(logits: torch.Tensor, tokens: torch.Tensor, empty: torch.Tensor,
                 cavity_narrow: torch.Tensor, resolution: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(maps, smoothed): a hotspot's map is its sigmoid inside its box, in
    empty space and in the narrow cavity, Gaussian-smoothed, masked again
    and cut below the box threshold; `smoothed` is the same before the cut."""
    ok = box_mask(tokens, logits.shape[-1], resolution) & \
        (empty & (cavity_narrow > FOCUS_THRESHOLD))[None]
    smooth = torch.where(ok, gaussian_smooth(torch.where(ok, torch.sigmoid(logits), 0.0)), 0.0)
    return torch.where(smooth >= BOX_THRESHOLD, smooth, 0.0), smooth


# --------------------------------------------------------------------------
# Graph nodes
# --------------------------------------------------------------------------
def components(maps: torch.Tensor) -> torch.Tensor:
    """26-connected components of each map's nonzero voxels: [K, D, H, W]
    int64, 0 outside, else (voxels of a map) - (the component's smallest
    flat index), so a larger label is a component that starts earlier."""
    k = maps.shape[0]
    n = maps[0].numel()
    on = maps > 0
    flat = torch.arange(n, device=maps.device, dtype=torch.float64).view(maps.shape[1:])
    lab = torch.where(on, (n - flat)[None], 0.0)
    while True:
        grown = torch.where(on, F.max_pool3d(lab[:, None], 3, 1, 1)[:, 0], 0.0)
        if torch.equal(grown, lab):
            return lab.long()
        lab = grown


def graph_nodes(maps: torch.Tensor, center: np.ndarray, resolution: float
                ) -> list[list[tuple[tuple[float, float, float], float]]]:
    """Each map's nodes in upstream's order: components of at least 8
    voxels by their smallest flat index; a node's centre is the
    density-weighted mean of its voxels (float64, then the grid's origin
    center - res (size - 1) / 2, to float32) and its radius that of a
    sphere of its voxels' volume. Returns per map [(centre, radius)]."""
    size = maps.shape[-1]
    lab = components(maps)
    origin = np.asarray(center, dtype=np.float64) - resolution * (size - 1) / 2
    coords = torch.stack(torch.meshgrid(*[torch.arange(size, device=maps.device,
                                                       dtype=torch.float64)] * 3,
                                        indexing="ij"), -1).reshape(-1, 3)
    out = []
    for m in range(maps.shape[0]):
        flat = lab[m].reshape(-1)
        idx = torch.nonzero(flat).flatten()
        if not len(idx):
            out.append([])
            continue
        labels, inverse, counts = torch.unique(flat[idx], return_inverse=True,
                                               return_counts=True)
        v = maps[m].reshape(-1)[idx].double()
        num = torch.zeros((len(labels), 3), dtype=torch.float64, device=maps.device)
        num.index_add_(0, inverse, coords[idx] * v[:, None])
        den = torch.zeros(len(labels), dtype=torch.float64, device=maps.device)
        den.index_add_(0, inverse, v)
        centers = (num / den[:, None]).cpu().numpy()
        nodes = []
        for j in torch.argsort(labels, descending=True).tolist():
            count = int(counts[j])
            if count < MIN_NODE_VOXELS:
                continue
            pos = (origin + centers[j] * resolution).astype(np.float32)
            radius = (count / (4 * math.pi / 3)) ** (1 / 3) * resolution
            nodes.append((tuple(float(p) for p in pos), radius))
        out.append(nodes)
    return out


# --------------------------------------------------------------------------
# A whole pocket
# --------------------------------------------------------------------------
@dataclass
class Modelled:
    pocket: Pocket
    heads: Heads  # on the host
    kept: np.ndarray  # token indices kept, in order
    maps: dict[int, np.ndarray]  # token index -> density map (kept tokens)
    smoothed: dict[int, np.ndarray]  # token index -> the map before the cut


def score_tokens(pocket: Pocket, w: dict, distributions: list[torch.Tensor], cfg: dict,
                 device) -> tuple[list[torch.Tensor], torch.Tensor, Heads]:
    """(pyramid, occupancy, heads) of a perceived pocket, on `device`."""
    grid, res = int(cfg["grid_dim"]), float(cfg["resolution"])
    with torch.no_grad(), float32_scope():
        image, occupied = voxelize(pocket, grid, res, device)
        pyramid = trunk(image, w, cfg)
        h = heads(pyramid[-1], torch.as_tensor(pocket.tokens, device=device), w, distributions)
    return pyramid, occupied, h


def model_pocket(pocket: Pocket, w: dict, distributions: list[torch.Tensor], cfg: dict,
                 device, chunk: int) -> Modelled:
    """The reference's whole path for one perceived pocket: the mask head
    runs over the kept hotspots `chunk` at a time, so that it fits."""
    res = float(cfg["resolution"])
    pyramid, occupied, h = score_tokens(pocket, w, distributions, cfg, device)
    tokens = torch.as_tensor(pocket.tokens, device=device)
    kept = torch.nonzero(h.keep).flatten()
    maps, smoothed = {}, {}
    with torch.no_grad(), float32_scope():
        for s in range(0, len(kept), chunk):
            part = kept[s: s + chunk]
            logits = mask_logits(pyramid, tokens[part], h.token_features[part], w, cfg)
            dmap, smooth = density_maps(logits, tokens[part], ~occupied, h.cavity_narrow, res)
            for j, i in enumerate(part.tolist()):
                maps[i], smoothed[i] = dmap[j].cpu().numpy(), smooth[j].cpu().numpy()
    host = Heads(*(getattr(h, f).cpu() for f in Heads.__dataclass_fields__))
    return Modelled(pocket, host, kept.cpu().numpy(), maps, smoothed)
