"""RDKit-free 3D conformer generation by classical distance geometry, on
the host: a frozen copy of the numpy backend of
`pharmaconet_tpu_torch/chem/embed.py` (the torch backend left out), so that
the benchmark's ligands do not move when the program's embedder changes.

  1. bounds matrix from the connection table (bond lengths from covalent
     radii x bond-order factors, 1-3 distances from hybridization and
     small-ring angles, regular-polygon distance sets inside aromatic
     rings, van der Waals lower bounds elsewhere);
  2. triangle-inequality smoothing (Floyd-Warshall on both bounds);
  3. per-conformer random metric sampling + classical MDS into 3-D;
  4. violation-driven gradient refinement against the raw bounds.

Each molecule draws from its own numpy PCG stream, so its conformers do
not depend on which other molecules share its batch.
"""

from __future__ import annotations

import numpy as np

from .periodic import COVALENT_RADIUS
from .smallmol import Molecule

# van der Waals radii (Bondi) for non-bonded lower bounds
VDW_RADIUS: dict[int, float] = {
    1: 1.20, 5: 1.92, 6: 1.70, 7: 1.55, 8: 1.52, 9: 1.47, 14: 2.10,
    15: 1.80, 16: 1.80, 17: 1.75, 35: 1.85, 53: 1.98,
}
_DEFAULT_VDW = 1.8
_DEFAULT_COV = 0.77

# bond-length contraction per bond order (single=covalent-radius sum)
_ORDER_FACTOR = {1: 1.0, 2: 0.87, 3: 0.78, 4: 0.90, 5: 0.90}

_BIG = 1.0e6
# a refined conformer whose worst bound violation exceeds this is rejected
_FAIL_VIOLATION = 0.5


def _bond_length(mol: Molecule, a: int, b: int, order: int) -> float:
    ra = COVALENT_RADIUS.get(mol.atoms[a].atomic_num, _DEFAULT_COV)
    rb = COVALENT_RADIUS.get(mol.atoms[b].atomic_num, _DEFAULT_COV)
    return (ra + rb) * _ORDER_FACTOR.get(order, 1.0)


def _hybrid_angle(mol: Molecule, i: int) -> float:
    """Ideal bond angle (radians) at atom i from its bond orders.

    Hypervalent centers (sulfonamide S, phosphate P: >= 4 heavy
    neighbors) are tetrahedral no matter their double bonds — four
    neighbors at pairwise 120 deg is geometrically impossible and would
    frustrate the bounds matrix.
    """
    if mol.heavy_degree(i) >= 4:
        return np.deg2rad(109.47)
    orders = [b.order for b in mol.bonds_of(i)]
    n_double = sum(1 for o in orders if o == 2)
    if any(o == 3 for o in orders) or (n_double >= 2 and mol.heavy_degree(i) <= 2):
        return np.pi  # sp
    if mol.atoms[i].aromatic or n_double >= 1 or any(o in (4, 5) for o in orders):
        return 2.0 * np.pi / 3.0  # sp2
    return np.deg2rad(109.47)  # sp3


def _ring_angle(size: int, aromatic: bool) -> float:
    """Internal angle forced by a small ring."""
    if aromatic:
        return np.deg2rad(180.0 * (size - 2) / size)
    return np.deg2rad({3: 60.0, 4: 88.0, 5: 103.0}.get(size, 109.47))


def _bounds(mol: Molecule) -> tuple[np.ndarray, np.ndarray]:
    """Raw lower/upper distance-bound matrices [N, N] (diagonal 0)."""
    n = mol.num_atoms
    lower = np.zeros((n, n))
    upper = np.full((n, n), _BIG)
    np.fill_diagonal(upper, 0.0)

    # default non-bonded lower bound: scaled vdW contact
    vdw = np.array(
        [VDW_RADIUS.get(a.atomic_num, _DEFAULT_VDW) for a in mol.atoms]
    )
    lower[:] = 0.8 * (vdw[:, None] + vdw[None, :])
    np.fill_diagonal(lower, 0.0)

    def pin(a: int, b: int, dist: float, tol: float) -> None:
        lower[a, b] = lower[b, a] = max(dist - tol, 0.0)
        upper[a, b] = upper[b, a] = dist + tol

    # 1-2: bond lengths
    blen: dict[tuple[int, int], float] = {}
    for bond in mol.bonds:
        d = _bond_length(mol, bond.a, bond.b, bond.order)
        blen[(bond.a, bond.b)] = blen[(bond.b, bond.a)] = d
        pin(bond.a, bond.b, d, 0.01)

    # smallest ring containing each (j, i, k) angle triple
    ring_of: dict[tuple[int, int, int], tuple[int, bool]] = {}
    for ring in mol.rings():
        rs = set(ring)
        arom = all(mol.atoms[i].aromatic for i in ring)
        for i in ring:
            nbrs = [v for v in mol.neighbors(i) if v in rs]
            for a in nbrs:
                for b in nbrs:
                    if a < b:
                        key = (a, i, b)
                        if key not in ring_of or len(ring) < ring_of[key][0]:
                            ring_of[key] = (len(ring), arom)

    # 1-3: law of cosines with hybridization / ring angles
    for i in range(n):
        nbrs = mol.neighbors(i)
        theta_default = _hybrid_angle(mol, i)
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                j, k = nbrs[x], nbrs[y]
                key = (min(j, k), i, max(j, k))
                if key in ring_of:
                    size, arom = ring_of[key]
                    theta = _ring_angle(size, arom)
                else:
                    theta = theta_default
                dij, dik = blen[(i, j)], blen[(i, k)]
                d = np.sqrt(
                    dij * dij + dik * dik - 2.0 * dij * dik * np.cos(theta)
                )
                if upper[j, k] >= _BIG:  # don't override a ring-bond pin
                    pin(j, k, d, 0.06)

    # aromatic rings: exact regular-polygon distance sets (rigid => planar)
    for ring in mol.aromatic_rings():
        m = len(ring)
        ring_l = [blen.get((ring[x], ring[(x + 1) % m])) for x in range(m)]
        ring_l = [d for d in ring_l if d is not None]
        if not ring_l:
            continue
        side = float(np.mean(ring_l))
        circum = side / (2.0 * np.sin(np.pi / m))
        for x in range(m):
            for y in range(x + 2, m):
                sep = min(y - x, m - (y - x))
                if sep < 2:
                    continue
                d = 2.0 * circum * np.sin(np.pi * sep / m)
                pin(ring[x], ring[y], d, 0.02)

    return lower, upper


def _smooth(lower: np.ndarray, upper: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Triangle-inequality smoothing (Floyd-Warshall over both bounds)."""
    up = upper.copy()
    lo = lower.copy()
    n = up.shape[0]
    for k in range(n):
        up = np.minimum(up, up[:, k, None] + up[None, k, :])
    for k in range(n):
        lo = np.maximum(lo, lo[:, k, None] - up[None, k, :])
        lo = np.maximum(lo, lo[None, k, :] - up[:, k, None])
    # disconnected fragments: keep them embeddable at a finite offset
    finite = up[up < _BIG]
    cap = (finite.max() if finite.size else 10.0) + 10.0
    up = np.minimum(up, cap)
    lo = np.minimum(lo, up)
    return lo, up


# --------------------------------------------------------------------------
# Batched multi-molecule embedding (library prepack hot path)
# --------------------------------------------------------------------------
# Molecules pad to the nearest bucket so each refine chunk runs one shape;
# a conformer's trajectory depends only on its own rows, so the result for
# a molecule is independent of which other molecules share its chunk.
_BUCKETS = (4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 128)
# refine chunks cap at this many conformer rows (memory + cache bound)
_CHUNK_ROWS = 2048


def _bucket_n(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 63) // 64) * 64


def _mds_masked(dist: np.ndarray, nreal: np.ndarray) -> np.ndarray:
    """Masked classical MDS: [B, NB, NB] padded distance matrices (padding
    entries 0) -> [B, NB, 3] coordinates; padding rows come out ~0.

    Double-centers over the REAL atoms only — padded entries contribute 0
    to the sums, and the padded Gram rows/cols are zeroed so the spectrum
    is the real block's plus exact zeros."""
    nb = dist.shape[1]
    d2 = (dist * dist).astype(np.float32)
    cnt = nreal.astype(np.float32)[:, None, None]
    row = d2.sum(axis=2, keepdims=True) / cnt
    col = d2.sum(axis=1, keepdims=True) / cnt
    tot = d2.sum(axis=(1, 2), keepdims=True) / (cnt * cnt)
    gram = -0.5 * (d2 - row - col + tot)
    mask = (np.arange(nb)[None, :] < nreal[:, None]).astype(np.float32)
    gram *= mask[:, :, None] * mask[:, None, :]
    w, v = np.linalg.eigh(gram)
    w3 = np.sqrt(np.clip(w[:, -3:], 0.0, None))
    return (v[:, :, -3:] * w3[:, None, :]).astype(np.float32)


def _refine_batch(
    x: np.ndarray,
    lo: np.ndarray,
    up: np.ndarray,
    iters: int = 600,
    tol: float = 0.05,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row-bounds variant of :func:`_refine`: x [B, N, 3] with lo/up
    [B, N, N] (one bounds matrix per conformer row). Same dropout dynamics;
    f32 throughout — the bound tolerances are 1e-2-ε A, five orders above
    f32 resolution."""
    n = x.shape[1]
    if n < 2 or x.shape[0] == 0:
        return x, np.zeros(x.shape[0], np.float32)
    eye = np.eye(n, dtype=bool)
    lr = 0.12
    max_step = 0.25
    out = x.copy()
    final_worst = np.zeros(x.shape[0], np.float32)
    idx = np.arange(x.shape[0])
    for t in range(iters):
        diff = x[:, :, None, :] - x[:, None, :, :]
        d = np.sqrt((diff * diff).sum(-1))
        d[:, eye] = 1.0
        over = np.maximum(d - up, 0.0)
        under = np.maximum(lo - d, 0.0)
        viol = over - under
        viol[:, eye] = 0.0
        worst = np.abs(viol).max(axis=(1, 2))
        final_worst[idx] = worst
        live = worst >= tol
        if not live.all():
            out[idx[~live]] = x[~live]
            idx, x = idx[live], x[live]
            if idx.size == 0:
                return out, final_worst
            lo, up, diff, viol, d = (
                lo[live], up[live], diff[live], viol[live], d[live]
            )
        coef = viol / np.maximum(d, 0.05)
        grad = 4.0 * (coef[:, :, :, None] * diff).sum(axis=2)
        step = (lr / (1.0 + t / 150.0)) * grad
        norms = np.sqrt((step * step).sum(-1, keepdims=True))
        step *= np.minimum(1.0, max_step / np.maximum(norms, 1e-12))
        x = x - step
    out[idx] = x
    return out, final_worst


def embed_conformers_many(
    mols: list[Molecule], num_conformers: int, seeds: list[int]
) -> list[np.ndarray | Exception]:
    """Conformers of a list of heavy-atom molecules.

    Returns one entry per molecule: the [num_conformers, N_heavy, 3] f32
    array, or the Exception that molecule raised (callers skip failures
    without losing the batch). Molecule i draws from its own rng stream,
    seeded by seeds[i], so its result is independent of batch composition,
    order, and chunking.
    """
    if num_conformers < 1:
        raise ValueError("num_conformers must be >= 1")
    if len(seeds) != len(mols):
        raise ValueError("seeds length must match mols")

    out: list[np.ndarray | Exception | None] = [None] * len(mols)
    prepared: dict[int, list[tuple]] = {}  # bucket -> [(mi, mol, seed, lo, up)]
    for mi, mol in enumerate(mols):
        try:
            if any(a.atomic_num == 1 for a in mol.atoms):
                mol = mol.strip_hydrogens()
            n = mol.num_atoms
            if n == 0:
                raise ValueError("cannot embed an empty molecule")
            if n == 1:
                out[mi] = np.zeros((num_conformers, 1, 3), np.float32)
                continue
            raw_lo, raw_up = _bounds(mol)
            prepared.setdefault(_bucket_n(n), []).append(
                (mi, mol, seeds[mi], raw_lo, raw_up)
            )
        except Exception as e:  # noqa: BLE001 - per-molecule tolerance
            out[mi] = e

    for nb, group in prepared.items():
        per_chunk = max(1, _CHUNK_ROWS // num_conformers)
        for c0 in range(0, len(group), per_chunk):
            chunk = group[c0 : c0 + per_chunk]
            _embed_chunk(chunk, nb, num_conformers, out)
    return out  # type: ignore[return-value]



def _pad_bounds(lo, up, nb):
    """Pad a molecule's [n, n] bounds to [nb, nb]: padding pairs get
    lo=0 / up=_BIG (never violated, zero gradient)."""
    n = lo.shape[0]
    lo_p = np.zeros((nb, nb), np.float32)
    up_p = np.full((nb, nb), _BIG, np.float32)
    lo_p[:n, :n] = lo
    up_p[:n, :n] = up
    return lo_p, up_p


def _embed_chunk(chunk, nb, count, out) -> None:
    """numpy-backend chunk embed: one stacked MDS + refine batch, then the
    per-molecule retry/gate loop (retries batched across molecules).
    chunk entries: (mi, mol, seed, raw_lo, raw_up)."""
    mols_n = [m.num_atoms for _, m, *_ in chunk]
    rngs = [np.random.default_rng(seed) for _mi, _mol, seed, *_ in chunk]
    smoothed = [_smooth(rlo, rup) for _mi, _m, _s, rlo, rup in chunk]

    def sample(entries):
        """entries: [(slot, count)] -> stacked padded dists drawn from
        each slot's own rng stream."""
        dists = []
        for k, cnt in entries:
            n, (lo, up) = mols_n[k], smoothed[k]
            u = rngs[k].random((cnt, n, n))
            u = np.triu(u, 1)
            u = u + np.swapaxes(u, 1, 2)
            dist = (lo[None] + u * (up - lo)[None]).astype(np.float32)
            pad = np.zeros((cnt, nb, nb), np.float32)
            pad[:, :n, :n] = dist
            dists.append(pad)
        return np.concatenate(dists)

    dist = sample([(k, count) for k in range(len(chunk))])
    nreal = np.repeat(np.asarray(mols_n, np.int32), count)
    x = _mds_masked(dist, nreal)
    padded = [
        _pad_bounds(rlo, rup, nb) for _mi, _m, _s, rlo, rup in chunk
    ]
    lo_b = np.stack([p[0] for p in padded])
    up_b = np.stack([p[1] for p in padded])
    rep = np.repeat(np.arange(len(chunk)), count)
    x, worst = _refine_batch(x, lo_b[rep], up_b[rep])

    coords = x.reshape(len(chunk), count, nb, 3)
    worst = worst.reshape(len(chunk), count)

    for _round in range(2):
        retry = [
            (k, bad)
            for k in range(len(chunk))
            if len(bad := np.where(worst[k] > _FAIL_VIOLATION)[0])
        ]
        if not retry:
            break
        dist = sample([(k, len(bad)) for k, bad in retry])
        nreal_r = np.concatenate([
            np.full(len(bad), mols_n[k], np.int32) for k, bad in retry
        ])
        xr = _mds_masked(dist, nreal_r)
        rep_r = np.concatenate([
            np.full(len(bad), k, np.int64) for k, bad in retry
        ])
        xr, wr = _refine_batch(xr, lo_b[rep_r], up_b[rep_r])
        at = 0
        for k, bad in retry:
            cnt = len(bad)
            better = wr[at : at + cnt] < worst[k][bad]
            coords[k][bad[better]] = xr[at : at + cnt][better]
            worst[k][bad[better]] = wr[at : at + cnt][better]
            at += cnt

    _finalize_chunk(chunk, mols_n, coords, worst, out)


def _finalize_chunk(chunk, mols_n, coords, worst, out) -> None:
    for k, (mi, mol, *_rest) in enumerate(chunk):
        if (worst[k] > _FAIL_VIOLATION).any():
            out[mi] = ValueError(
                f"distance-geometry embedding failed for "
                f"{mol.title or 'molecule'}: worst bound violation "
                f"{worst[k].max():.2f} A after retries"
            )
        else:
            out[mi] = np.ascontiguousarray(
                coords[k][:, : mols_n[k]], np.float32
            )
