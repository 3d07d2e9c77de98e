"""RDKit-free 3D conformer generation via classical distance geometry.

Upstream PharmacoNet's ``Ligand.load_from_smiles`` embeds conformers with
RDKit's srETKDGv3 (src/pmnet/scoring/ligand.py:87-107) and then strips
hydrogens, so only heavy-atom geometry ever reaches the scorer. RDKit is
an optional dependency; when it is absent this module supplies a
self-contained fallback so ``scoring_smiles`` keeps working:

  1. bounds matrix from the connection table — bond lengths from covalent
     radii x bond-order factors, 1-3 distances from hybridization (and
     small-ring) angles, exact regular-polygon distance sets inside
     aromatic rings (which also makes them rigid, hence planar), van der
     Waals lower bounds elsewhere;
  2. triangle-inequality smoothing (Floyd-Warshall on both bounds);
  3. per-conformer random metric sampling + classical MDS embedding into
     3-D (eigendecomposition of the Gram matrix);
  4. violation-driven gradient refinement against the *raw* (unsmoothed)
     bounds.

Fidelity notes (documented deviation — see PARITY.md):

* Pharmacophore scores consume only pairwise feature distances, so they
  are invariant under reflection: tetrahedral chirality cannot change a
  score, and ignoring @/@@ here is exact, not an approximation.
* E/Z double-bond stereo is not enforced (the SMILES parser reads / and
  \\ as plain single bonds); both geometries may be sampled, which for
  scoring acts as extra conformer diversity.
* Ensembles are lower quality than ETKDG (no experimental-torsion terms);
  bond lengths/angles are near-ideal, torsions are sampled broadly. The
  match kernels bin distances at sigma >= 1 A, which this easily meets.

Two backends, as in `pharmaconet_tpu`'s copy of this module. "numpy" (a
copy of that package's: the same PCG streams, so the same coordinates
bit for bit) runs on the host and in worker processes. "torch" (that
package's "jax") runs the whole pipeline of a chunk on one torch device
(`embed_program`): the bounds go up, the coordinates come down, and the
N^2 work of every step stays on the card. Its draws come from one
torch.Generator per molecule (`draw_uniform`), not from threefry or PCG,
so it answers to the same geometry gates, not to the same coordinates.
"""

from __future__ import annotations

import contextlib
import time

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


def embed_conformers(
    mol: Molecule, num_conformers: int, seed: int = 2025
) -> np.ndarray:
    """Generate [num_conformers, N_heavy, 3] float32 coordinates.

    Deterministic for a given (molecule, num_conformers, seed). The
    molecule must be heavy-atom-only (``parse_smiles`` output qualifies);
    hydrogens are never embedded because the scorer strips them anyway
    (upstream ligand.py:80-84).

    Delegates to :func:`embed_conformers_many` with a batch of one — the
    batched path is the implementation, so single-molecule and library
    prepack embeddings are identical for the same (molecule, seed).
    """
    out = embed_conformers_many([mol], num_conformers, seeds=[seed])[0]
    if isinstance(out, Exception):
        raise out
    return out


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


# --------------------------------------------------------------------------
# torch backend: the whole pipeline as torch ops on one device. torch is
# imported inside its functions, so the numpy backend's worker processes
# never load it.
# --------------------------------------------------------------------------
# Refinement steps between two host checks of "every row converged"
CHECK_EVERY = 25
# Counters of the torch backend since the last reset_stats(): chunks,
# dispatches (one per chunk and retry round), retry rounds run, refinement
# steps taken, the ms of each stage summed over dispatches (CUDA events on
# the card, the host clock on the CPU), and the host's wall seconds inside
# the chunk embeds (results back included). chip_smoke.py reads them.
STATS: dict = {}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(chunks=0, dispatches=0, rounds=0, steps=0, wall_s=0.0,
                 ms=dict(draw=0.0, smooth=0.0, sample=0.0, mds=0.0, refine=0.0))


reset_stats()


@contextlib.contextmanager
def _full_f32():
    """float32 matrix products in full float32 inside the block (never
    TF32, whatever the process set); the previous flags come back after."""
    import torch

    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]


class _StageClock:
    """ms of the program's stages: CUDA events on the card (read once the
    results are back, so no stage waits for the host), the host clock on
    the CPU, where every op has finished when it returns."""

    def __init__(self, device, enabled: bool):
        import torch

        self.cuda, self.enabled = device.type == "cuda", enabled
        self.marks: list = []
        self._event = torch.cuda.Event if self.cuda else None
        self.mark("start")

    def mark(self, name: str) -> None:
        if not self.enabled:
            return
        if self.cuda:
            ev = self._event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> dict[str, float]:
        if self.cuda:
            self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


def _generator_seed(seed: int, rnd: int) -> int:
    """One torch.Generator seed per (molecule seed, retry round)."""
    return ((int(seed) % (1 << 56)) << 8) | rnd


def draw_uniform(seeds, rnd: int, count: int, nb: int, device):
    """[M, count, nb, nb] float32 uniform draws in [0, 1) on `device`,
    molecule i's from its own torch.Generator seeded from (seeds[i], rnd),
    so a molecule's draws depend on that molecule alone, never on its
    chunk. They are not the JAX package's threefry draws: embed_program
    takes the draws as an input, so a test can hand it those."""
    import torch

    device = torch.device(device)
    u = torch.empty((len(seeds), count, nb, nb), dtype=torch.float32, device=device)
    for i, seed in enumerate(seeds):
        gen = torch.Generator(device=device)
        gen.manual_seed(_generator_seed(seed, rnd))
        torch.rand((count, nb, nb), generator=gen, out=u[i])
    return u


def smooth_bounds(raw_lo, raw_up):
    """Triangle smoothing of [M, NB, NB] padded bounds (Floyd-Warshall over
    the NB pivots, as the JAX program's fori_loops), then the cap that keeps
    disconnected fragments at a finite distance."""
    import torch

    nb = raw_lo.shape[1]
    up = raw_up.clone()
    for k in range(nb):  # the candidate is complete before the in-place min
        torch.minimum(up, up[:, :, k, None] + up[:, None, k, :], out=up)
    lo = raw_lo.clone()
    for k in range(nb):
        torch.maximum(lo, lo[:, :, k, None] - up[:, None, k, :], out=lo)
        torch.maximum(lo, lo[:, None, k, :] - up[:, :, k, None], out=lo)
    finite_max = torch.where(up < _BIG, up, 0.0).amax(dim=(1, 2))
    cap = torch.where(finite_max > 0, finite_max, 10.0) + 10.0
    up = torch.minimum(up, cap[:, None, None])
    lo = torch.minimum(lo, up)
    return lo, up


def _pair_mask(nreal, count: int, nb: int):
    """[M * count, NB, NB] 1 on pairs of real atoms, 0 on padding."""
    import torch

    real = torch.arange(nb, device=nreal.device)[None, :] < nreal.repeat_interleave(count)[:, None]
    mask = real.to(torch.float32)
    return mask[:, :, None] * mask[:, None, :]


def sample_distances(lo, up, u, pair_mask):
    """[M * count, NB, NB] symmetric distances drawn inside the smoothed
    bounds from the upper triangle of `u` [M, count, NB, NB], padded pairs
    zeroed by `pair_mask` (their smoothed bounds are the finite cap, and
    the masked MDS needs padding to contribute 0)."""
    import torch

    u = torch.triu(u, 1)
    u = u + u.transpose(2, 3)
    dist = lo[:, None] + u * (up - lo)[:, None]
    return dist.reshape(pair_mask.shape) * pair_mask


def thin_qr(a):
    """Q of the thin QR factorisation of a batch [B, N, K] (K small), by K
    Householder reflections in torch ops, with LAPACK's conventions (geqr2
    + org2r): the same column signs as the JAX program's `jnp.linalg.qr`,
    and a column whose part below the diagonal is zero gets no reflection.
    torch.linalg.qr would call the solver library once per matrix of the
    batch on CUDA to form Q."""
    import torch

    b, n, k = a.shape
    rows = torch.arange(n, device=a.device)[None, :]
    r, reflectors = a, []
    for j in range(k):
        x = r[:, :, j]
        alpha = x[:, j]
        below = rows > j
        xnorm = torch.linalg.vector_norm(torch.where(below, x, 0.0), dim=1)
        beta = -torch.copysign(torch.hypot(alpha, xnorm), alpha)
        reflect = xnorm > 0
        tau = torch.where(reflect, (beta - alpha) / beta, 0.0)
        scale = torch.where(reflect, 1.0 / torch.where(reflect, alpha - beta, 1.0), 0.0)
        v = torch.where(below, x * scale[:, None], (rows == j).to(a.dtype))
        if j + 1 < k:
            r = r - (tau[:, None, None] * v[:, :, None]) * (v[:, :, None] * r).sum(1, keepdim=True)
        reflectors.append((v, tau))
    q = torch.eye(n, k, dtype=a.dtype, device=a.device).expand(b, n, k)
    for v, tau in reversed(reflectors):
        q = q - (tau[:, None, None] * v[:, :, None]) * (v[:, :, None] * q).sum(1, keepdim=True)
    return q


def mds_subspace(dist, pair_mask, nreal, count: int, rounds: int = 25):
    """Masked classical MDS of [B, NB, NB] distances into [B, NB, 3]:
    double-centring over the real atoms, then the top three eigenpairs of
    the Gram matrix by Gershgorin-shifted subspace iteration (`rounds`
    rounds of Q <- qr((G + cI) Q)), Rayleigh quotients for the unshifted
    eigenvalues, ordered ascending as eigh orders them. Products in full
    float32 (the caller's _full_f32 scope)."""
    import torch

    nb = dist.shape[1]
    d2 = dist * dist
    cnt = nreal.repeat_interleave(count).to(torch.float32)[:, None, None]
    row = d2.sum(dim=2, keepdim=True) / cnt
    col = d2.sum(dim=1, keepdim=True) / cnt
    tot = d2.sum(dim=(1, 2), keepdim=True) / (cnt * cnt)
    gram = -0.5 * (d2 - row - col + tot)
    gram = gram * pair_mask
    shift = gram.abs().sum(dim=2).amax(dim=1)  # Gershgorin bound of |lambda|
    gs = gram + shift[:, None, None] * torch.eye(nb, device=dist.device)[None]
    q = thin_qr(gram[:, :, :3])  # deterministic start with generic overlap
    for _ in range(rounds):
        q = thin_qr(torch.bmm(gs, q))
    lam = (q * torch.bmm(gram, q)).sum(dim=1)
    order = torch.argsort(lam, dim=1, stable=True)
    lam = torch.take_along_dim(lam, order, dim=1)
    q = torch.take_along_dim(q, order[:, None, :], dim=2)
    return q * torch.sqrt(torch.clamp(lam, min=0.0))[:, None, :]


def refine(x, lo, up, iters: int = 600, tol: float = 0.05, check_every: int = CHECK_EVERY):
    """Violation-driven refinement of x [B, NB, 3] against per-row raw
    bounds lo/up [B, NB, NB] (the JAX program's while_loop). Returns
    (x, worst, steps taken).

    The loop runs on the device: the host asks whether every row has
    converged once every `check_every` steps, never at every step, and
    stops at `iters`. A row freezes both x and its recorded worst
    violation at the step it converges, so the steps run after the last
    row converged change no bit: the result equals a check at every step
    (tests/test_torch_embed.py shows it)."""
    import torch

    b, nb = x.shape[0], x.shape[1]
    eye = torch.eye(nb, dtype=torch.bool, device=x.device)[None]
    lr, max_step = np.float32(0.12), 0.25
    done = torch.zeros(b, dtype=torch.bool, device=x.device)
    worst_rec = torch.zeros(b, dtype=torch.float32, device=x.device)
    t = 0
    while t < iters:
        diff = x[:, :, None, :] - x[:, None, :, :]
        d = torch.sqrt((diff * diff).sum(-1))
        d = torch.where(eye, 1.0, d)
        viol = torch.clamp(d - up, min=0.0) - torch.clamp(lo - d, min=0.0)
        viol = torch.where(eye, 0.0, viol)
        worst = viol.abs().amax(dim=(1, 2))
        worst_rec = torch.where(done, worst_rec, worst)
        done = done | (worst < tol)
        coef = viol / torch.clamp(d, min=0.05)
        grad = 4.0 * (coef[:, :, :, None] * diff).sum(dim=2)
        # the step size in float32 as the JAX program computes it
        step = float(lr / (np.float32(1.0) + np.float32(t) / np.float32(150.0))) * grad
        norms = torch.sqrt((step * step).sum(-1, keepdim=True))
        step = step * torch.clamp(max_step / torch.clamp(norms, min=1e-12), max=1.0)
        x = torch.where(done[:, None, None], x, x - step)
        t += 1
        if t % check_every == 0 and bool(done.all()):
            break
    return x, worst_rec, t


def embed_program(raw_lo, raw_up, nreal, u, count: int, iters: int = 600, tol: float = 0.05,
                  check_every: int = CHECK_EVERY, stages: dict | None = None):
    """One chunk through the four stages of the JAX package's device
    program on `u`'s device: triangle smoothing, the metric sample from
    `u` [M, count, NB, NB] (draw_uniform's or any other draws), masked
    classical MDS, and the refinement against the raw bounds.

    raw_lo/raw_up [M, NB, NB] float32 padded bounds (_pad_bounds), nreal
    [M] real atom counts. Returns x [M * count, NB, 3] and the worst bound
    violation of each row [M * count]. Everything is float32, matrix
    products in full float32. `stages`, if given, receives each stage's ms
    and the refinement's steps."""
    import torch

    clock = _StageClock(u.device, enabled=stages is not None)
    with _full_f32(), torch.no_grad():
        lo, up = smooth_bounds(raw_lo, raw_up)
        clock.mark("smooth")
        pair_mask = _pair_mask(nreal, count, raw_lo.shape[1])
        dist = sample_distances(lo, up, u, pair_mask)
        clock.mark("sample")
        x = mds_subspace(dist, pair_mask, nreal, count)
        clock.mark("mds")
        x, worst, steps = refine(x, raw_lo.repeat_interleave(count, 0),
                                 raw_up.repeat_interleave(count, 0), iters, tol, check_every)
        clock.mark("refine")
    if stages is not None:
        stages.update(clock.ms(), steps=steps)
    return x, worst


def _embed_chunk_torch(chunk, nb, count, out, device) -> None:
    """torch-backend chunk embed: the whole pipeline on `device` in one
    embed_program per retry round. A short (tail) chunk is padded to the
    full chunk width by repeating its last entry, so every dispatch of a
    bucket has one shape and a molecule's result does not depend on its
    chunk (solo and batched embeds are bit-identical); the repeats'
    outputs are dropped. Retries rerun the chunk with the round folded into
    the draws and replace only the conformers that beat their previous
    worst violation."""
    import torch

    t0 = time.perf_counter()
    m = len(chunk)
    mols_n = [mol.num_atoms for _mi, mol, *_ in chunk]
    per_chunk = max(1, _CHUNK_ROWS // count)
    full = list(chunk) + [chunk[-1]] * (per_chunk - m)
    padded = [_pad_bounds(rlo, rup, nb) for _mi, _m, _s, rlo, rup in full]
    raw_lo = torch.from_numpy(np.stack([p[0] for p in padded])).to(device)
    raw_up = torch.from_numpy(np.stack([p[1] for p in padded])).to(device)
    nreal = torch.tensor([mol.num_atoms for _mi, mol, *_ in full], dtype=torch.int64,
                         device=device)
    seeds = [seed for _mi, _m, seed, *_ in full]
    coords = worst = None
    STATS["chunks"] += 1
    for rnd in range(3):  # initial + 2 retry rounds
        stages: dict = {}
        draw_clock = _StageClock(torch.device(device), enabled=True)
        u = draw_uniform(seeds, rnd, count, nb, device)
        draw_clock.mark("draw")
        xr, wr = embed_program(raw_lo, raw_up, nreal, u, count, stages=stages)
        xr = xr.cpu().numpy().reshape(len(full), count, nb, 3)[:m]
        wr = wr.cpu().numpy().reshape(len(full), count)[:m]
        stages.update(draw_clock.ms())
        STATS["dispatches"] += 1
        STATS["steps"] += stages.pop("steps")
        for k, v in stages.items():
            STATS["ms"][k] += v
        if coords is None:
            coords, worst = xr, wr
        else:
            better = (worst > _FAIL_VIOLATION) & (wr < worst)
            coords = np.where(better[:, :, None, None], xr, coords)
            worst = np.where(better, wr, worst)
        if not (worst > _FAIL_VIOLATION).any():
            break
    STATS["rounds"] += rnd + 1
    STATS["wall_s"] += time.perf_counter() - t0

    _finalize_chunk(chunk, mols_n, coords, worst, out)


BACKENDS = ("numpy", "torch")


def _resolve_backend(backend: str) -> str:
    if backend in BACKENDS:
        return backend
    if backend != "auto":
        raise ValueError(f"unknown embed backend {backend!r}")
    import os

    env = os.environ.get("PMNET_EMBED_BACKEND")
    if env in BACKENDS:
        return env
    return "numpy"


def embed_conformers_many(
    mols: list[Molecule],
    num_conformers: int,
    seed: int = 2025,
    seeds: list[int] | None = None,
    backend: str = "auto",
    device="cuda",
) -> list[np.ndarray | Exception]:
    """Batched :func:`embed_conformers` over a molecule list.

    Returns one entry per molecule: the [num_conformers, N_heavy, 3] f32
    array, or the Exception that molecule raised (callers skip failures
    without losing the batch). seeds[i] defaults to seed + i; each
    molecule draws from its OWN rng stream, so its result is independent
    of batch composition, order, and chunking.

    backend: "numpy" (default; multiprocessing-friendly), "torch" (one
    embed_program per refine chunk and retry round on `device`: the card's
    path for library prepack; `device` cuda without a card raises), or
    "auto" (PMNET_EMBED_BACKEND env, else numpy).
    """
    if num_conformers < 1:
        raise ValueError("num_conformers must be >= 1")
    backend = _resolve_backend(backend)
    if backend == "torch":
        from ..device import resolve_device

        device = resolve_device(device)
    if seeds is None:
        seeds = [seed + i for i in range(len(mols))]
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
            if backend == "torch":
                _embed_chunk_torch(chunk, nb, num_conformers, out, device)
            else:
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
