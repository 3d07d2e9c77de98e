"""The port's distance-geometry embedder (chem/embed.py) against the JAX
package's.

(a) The numpy backend is a copy of the JAX package's: the same PCG streams,
    so the same coordinates bit for bit.
(b) The torch backend's program, `embed_program`, given the JAX program's
    own threefry draws (drawn here exactly as `_device_embed_program`
    draws them), against `_device_embed_program()` on the CPU: pairwise
    distance matrices and the worst bound violations. Tolerances, measured
    over the drug-like panel and 64 fragment molecules at 4 conformers and
    over one full chunk (256 fragment molecules of bucket 20 x 8
    conformers; Householder QR in torch ops against LAPACK's, sums in
    other orders): smoothing + MDS alone (iters=0) within 1.4e-5 A, held
    at 1e-4 A; after the 600-step refinement distances within 1.3e-3 A and
    the worst violations within 2.2e-4 A (the full chunk; 2.9e-4 and
    9.2e-6 A on the small groups), held at 5e-3 A and 1e-3 A: a tenth and
    a fiftieth of the refinement's 0.05 A convergence tolerance. Except on
    a row whose stop (worst violation < 0.05 A) fired at another step: its
    worst sat at the threshold, and a rounding moved the stop by a step or
    more (2 of the chunk's 2048 rows; distances 0.061 and 0.080 A apart).
    Such a row must have converged in both, differ by at most 0.25 A (the
    refinement's cap on one atom's move in one step), and such rows be at
    most 1% of the rows.
(c) The torch backend end to end on the CPU: the JAX backend's geometry
    gates (bonds within 0.12 A, aromatic rings planar within 0.35),
    determinism per seed, solo = batched bit for bit, invariance under a
    small `_CHUNK_ROWS`, one bad molecule not sinking its chunk.
(d) The refinement's host check every 25 steps gives the same bits as a
    check at every step.
(e) On the card (marked `gpu`, skipped without one): embed_program on
    CUDA against the CPU on the same draws, within (b)'s tolerances, and
    solo = batched bit for bit at the full chunk width. Run them there
    with `python -m pytest --noconftest -p no:cacheprovider -m gpu
    tests/test_torch_embed.py` (the JAX-program tests skip without jax).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pharmaconet_tpu.chem import embed as JE
from pharmaconet_tpu.chem.fragments import enumerate_fragment_smiles
from pharmaconet_tpu.chem.smiles import parse_smiles as j_parse
from pharmaconet_tpu_torch.chem import embed as TE
from pharmaconet_tpu_torch.chem.fragments import enumerate_fragment_smiles as t_enumerate
from pharmaconet_tpu_torch.chem.smallmol import Molecule
from pharmaconet_tpu_torch.chem.smiles import parse_smiles
from test_embed import PANEL

MDS_TOL = 1e-4  # A, distances after smoothing + MDS (measured max 1.4e-5)
REFINED_TOL = 5e-3  # A, distances after 600 refinement steps (measured max 1.3e-3)
WORST_TOL = 1e-3  # A, worst bound violation after 600 steps (measured max 2.2e-4)
STOP_TOL, FLIP_TOL, FLIP_SHARE = 0.05, 0.25, 0.01  # a row whose stop moved by rounding


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The embedder's CPU path is thousands of small torch ops; with one
    OpenMP thread per op they run as fast alone and do not crawl when the
    suite's workers share the cores (8 threads a worker took minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of 8 conformer rows: cheap CPU programs."""
    monkeypatch.setattr(TE, "_CHUNK_ROWS", 8)


def _bond_and_ring_gates(mol, confs, bond_tol=0.12, ring_tol=0.35):
    for bond in mol.bonds:
        d = np.linalg.norm(confs[:, bond.a] - confs[:, bond.b], axis=-1)
        target = TE._bond_length(mol, bond.a, bond.b, bond.order)
        assert np.abs(d - target).max() < bond_tol, (bond.a, bond.b)
    for ring in mol.aromatic_rings():
        for c in range(confs.shape[0]):
            pts = confs[c, list(ring)].astype(np.float64)
            pts -= pts.mean(0)
            rms = np.linalg.svd(pts, compute_uv=False)[-1] / np.sqrt(len(ring))
            assert rms < ring_tol


# --- (a) numpy backend ------------------------------------------------------


def test_numpy_backend_equals_jax_package():
    """The panel and seeds of test_batch_equals_single_and_chunk_invariance."""
    names = sorted(PANEL)
    seeds = list(range(100, 100 + len(names)))
    got = TE.embed_conformers_many([parse_smiles(PANEL[k]) for k in names], 3, seeds=seeds,
                                   backend="numpy")
    want = JE.embed_conformers_many([j_parse(PANEL[k]) for k in names], 3, seeds=seeds,
                                    backend="numpy")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    one = TE.embed_conformers(parse_smiles(PANEL["aspirin"]), 3, seed=5)
    np.testing.assert_array_equal(one, JE.embed_conformers(j_parse(PANEL["aspirin"]), 3, seed=5))


# --- (b) embed_program against _device_embed_program --------------------------


def _bucket_groups():
    """(smiles, conformers) per case: the panel and 64 fragment molecules
    grouped by bucket at 4 conformers, and one full chunk of bucket 20."""
    mols = [PANEL[k] for k in sorted(PANEL)]
    mols += [s for _, s in enumerate_fragment_smiles(64, seed=11)]
    groups: dict[str, tuple[list[str], int]] = {}
    for smi in mols:
        groups.setdefault(f"bucket{JE._bucket_n(j_parse(smi).num_atoms)}", ([], 4))[0].append(smi)
    chunk = [s for _, s in enumerate_fragment_smiles(2048, seed=11)
             if JE._bucket_n(j_parse(s).num_atoms) == 20][: JE._CHUNK_ROWS // 8]
    groups["chunk20x8"] = (chunk, 8)
    return groups


GROUPS = _bucket_groups()


def _jax_draws(seeds, rnd, count, nb):
    """u exactly as _device_embed_program's `draw` makes it."""
    import jax
    import jax.numpy as jnp

    def draw(seed):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
        return jax.random.uniform(k, (count, nb, nb), jnp.float32)

    return np.array(jax.vmap(draw)(jnp.asarray(np.asarray(seeds, np.uint32))))


def _pdist(x):
    return np.linalg.norm(x[:, :, None] - x[:, None, :], axis=-1)


def assert_rows_agree(xa, wa, xb, wb, tol=REFINED_TOL):
    """Two refined results of the same draws: every row's distance matrix
    within `tol` and worst violation within WORST_TOL, but for rows whose
    stop moved by rounding (see the module's docstring)."""
    dd = np.abs(_pdist(xa) - _pdist(xb)).max(axis=(1, 2))
    close = (dd <= tol) & (np.abs(wa - wb) <= WORST_TOL)
    moved = ~close
    assert (wa[moved] < STOP_TOL).all() and (wb[moved] < STOP_TOL).all(), (dd[moved], wa[moved], wb[moved])
    assert (dd[moved] <= FLIP_TOL).all(), dd[moved]
    assert moved.sum() <= FLIP_SHARE * len(dd), moved.sum()


def _chunk_inputs(case):
    smiles, count = GROUPS[case]
    mols = [j_parse(s) for s in smiles]
    nb = JE._bucket_n(max(m.num_atoms for m in mols))
    padded = [JE._pad_bounds(*JE._bounds(m), nb) for m in mols]
    raw_lo = np.stack([p[0] for p in padded])
    raw_up = np.stack([p[1] for p in padded])
    nreal = np.asarray([m.num_atoms for m in mols], np.int32)
    return mols, count, nb, raw_lo, raw_up, nreal


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_embed_program_matches_jax_program(case):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    mols, count, nb, raw_lo, raw_up, nreal = _chunk_inputs(case)
    seeds = list(range(7, 7 + len(mols)))
    rnd = 1
    u = _jax_draws(seeds, rnd, count, nb)
    run = JE._device_embed_program()
    for iters in (0, 600):
        xj, wj = run(jnp.asarray(raw_lo), jnp.asarray(raw_up), jnp.asarray(nreal),
                     jnp.asarray(np.asarray(seeds, np.uint32)), rnd, count, iters=iters)
        xj, wj = np.asarray(xj), np.asarray(wj)
        xt, wt = TE.embed_program(torch.from_numpy(raw_lo), torch.from_numpy(raw_up),
                                  torch.from_numpy(nreal).long(), torch.from_numpy(u), count,
                                  iters=iters)
        xt, wt = xt.numpy(), wt.numpy()
        assert xt.shape == xj.shape == (len(mols) * count, nb, 3) and np.isfinite(xt).all()
        if iters:
            assert_rows_agree(xt, wt, xj, wj)
        else:
            np.testing.assert_allclose(_pdist(xt), _pdist(xj), rtol=0, atol=MDS_TOL)
            assert not wt.any() and not wj.any()
        rows_n = np.repeat(nreal, count)
        for r, n in enumerate(rows_n):
            assert not xt[r, n:].any()  # padding rows stay at the origin
    # both refined results pass the gates of a finished embed
    for k, mol in enumerate(mols):
        for x, w in ((xt, wt), (xj, wj)):
            rows = slice(k * count, (k + 1) * count)
            if (w[rows] <= TE._FAIL_VIOLATION).all():
                _bond_and_ring_gates(mol, x[rows, : mol.num_atoms])


# --- (c) the torch backend end to end ---------------------------------------------


def test_torch_backend_gates_and_determinism(small_chunks):
    mols = [parse_smiles(PANEL[k]) for k in ("benzene", "aspirin", "caffeine", "sildenafil")]
    TE.reset_stats()
    a = TE.embed_conformers_many(mols, 2, seed=7, backend="torch", device="cpu")
    stats = TE.STATS  # buckets 8, 16 (aspirin, caffeine) and 40: 3 chunks
    assert stats["chunks"] == 3 and stats["rounds"] == stats["dispatches"] >= 3
    assert 0 < stats["steps"] <= 600 * stats["dispatches"] and stats["wall_s"] > 0
    assert set(stats["ms"]) == {"draw", "smooth", "sample", "mds", "refine"}
    b = TE.embed_conformers_many(mols, 2, seed=7, backend="torch", device="cpu")
    c = TE.embed_conformers_many(mols, 2, seed=8, backend="torch", device="cpu")
    for mol, x1, x2, x3 in zip(mols, a, b, c):
        assert not isinstance(x1, Exception), x1
        assert x1.shape == (2, mol.num_atoms, 3) and x1.dtype == np.float32
        np.testing.assert_array_equal(x1, x2)
        assert np.abs(x1 - x3).max() > 1e-3
        _bond_and_ring_gates(mol, x1)


def test_torch_backend_solo_equals_batched(small_chunks, monkeypatch):
    """C4 on the CPU: each molecule's conformers from a batched embed are
    bit-identical to its solo embed, and the same with chunks of another
    size."""
    names = sorted(PANEL)
    mols = [parse_smiles(PANEL[k]) for k in names]
    seeds = list(range(100, 100 + len(mols)))
    batch = TE.embed_conformers_many(mols, 3, seeds=seeds, backend="torch", device="cpu")
    for name, mol, seed, got in zip(names, mols, seeds, batch):
        solo = TE.embed_conformers_many([mol], 3, seeds=[seed], backend="torch", device="cpu")
        np.testing.assert_array_equal(got, solo[0], err_msg=name)
    monkeypatch.setattr(TE, "_CHUNK_ROWS", 6)
    rechunked = TE.embed_conformers_many(mols, 3, seeds=seeds, backend="torch", device="cpu")
    for name, a, b in zip(names, batch, rechunked):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_torch_backend_tolerates_a_bad_molecule(small_chunks):
    good = parse_smiles(PANEL["aspirin"])
    out = TE.embed_conformers_many([good, Molecule(), good], 2, seed=3, backend="torch",
                                   device="cpu")
    assert isinstance(out[1], Exception)
    assert out[0].shape == out[2].shape == (2, good.num_atoms, 3)
    edge = TE.embed_conformers_many([parse_smiles("C"), parse_smiles("C=O"), parse_smiles("CC.O")],
                                    2, seed=1, backend="torch", device="cpu")
    assert edge[0].shape == (2, 1, 3)
    d = np.linalg.norm(edge[1][:, 0] - edge[1][:, 1], axis=-1)
    assert np.all(np.abs(d - 1.27) < 0.1)
    frag = edge[2][0]
    assert min(np.linalg.norm(frag[2] - frag[0]), np.linalg.norm(frag[2] - frag[1])) > 2.0


def test_backend_names_and_device(monkeypatch):
    monkeypatch.delenv("PMNET_EMBED_BACKEND", raising=False)
    assert TE._resolve_backend("auto") == "numpy"
    monkeypatch.setenv("PMNET_EMBED_BACKEND", "torch")
    assert TE._resolve_backend("auto") == "torch"
    with pytest.raises(ValueError):
        TE._resolve_backend("jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.embed_conformers_many([parse_smiles("CCO")], 2, backend="torch")


def test_draws_depend_on_the_molecule_alone():
    u = TE.draw_uniform([5, 6, 5], 0, 2, 8, "cpu")
    assert u.shape == (3, 2, 8, 8) and u.dtype == torch.float32
    assert torch.equal(u[0], u[2]) and not torch.equal(u[0], u[1])
    assert torch.equal(TE.draw_uniform([6], 0, 2, 8, "cpu")[0], u[1])
    assert not torch.equal(TE.draw_uniform([5], 1, 2, 8, "cpu")[0], u[0])
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_thin_qr_matches_lapack_signs():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 10, 3)).astype(np.float32)
    a[1, :, 2] = 0.0  # a zero column: no reflection, as LAPACK
    q = TE.thin_qr(torch.from_numpy(a)).numpy()
    want = np.linalg.qr(a.astype(np.float64))[0]
    np.testing.assert_allclose(q[[0, 2, 3, 4, 5]], want[[0, 2, 3, 4, 5]], atol=1e-5)
    np.testing.assert_allclose(q[1, :, :2], want[1, :, :2], atol=1e-5)
    np.testing.assert_allclose(np.einsum("bni,bnj->bij", q, q), np.broadcast_to(np.eye(3), (6, 3, 3)),
                               atol=1e-5)


# --- (d) host check every K steps ----------------------------------------------------


def test_refine_check_every_25_equals_every_step():
    """Converged rows freeze x and their worst violation, so the steps
    after the last row converged change no bit."""
    mols = [parse_smiles(s) for _, s in enumerate_fragment_smiles(8, seed=3)]
    nb = max(TE._bucket_n(m.num_atoms) for m in mols)
    padded = [TE._pad_bounds(*TE._bounds(m), nb) for m in mols]
    raw_lo = torch.from_numpy(np.stack([p[0] for p in padded]))
    raw_up = torch.from_numpy(np.stack([p[1] for p in padded]))
    nreal = torch.tensor([m.num_atoms for m in mols])
    u = TE.draw_uniform(list(range(len(mols))), 0, 2, nb, "cpu")
    runs = {}
    for k in (1, 25):
        stages: dict = {}
        runs[k] = (*TE.embed_program(raw_lo, raw_up, nreal, u, 2, check_every=k, stages=stages),
                   stages["steps"])
    (x1, w1, s1), (x25, w25, s25) = runs[1], runs[25]
    assert torch.equal(x1, x25) and torch.equal(w1, w25)
    assert s1 <= s25 < 600 and s25 % 25 == 0 and s25 - s1 < 25
    assert set(stages) == {"smooth", "sample", "mds", "refine", "steps"}


# --- (e) on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_embed_program_card_matches_cpu(cuda, case):
    mols, count, nb, raw_lo, raw_up, nreal = _chunk_inputs(case)
    u = TE.draw_uniform(list(range(3, 3 + len(mols))), 0, count, nb, "cpu")
    args = [torch.from_numpy(raw_lo), torch.from_numpy(raw_up), torch.from_numpy(nreal).long(), u]
    for iters in (0, 600):
        xc, wc = (t.numpy() for t in TE.embed_program(*args, count, iters=iters))
        xg, wg = (t.cpu().numpy() for t in TE.embed_program(*(a.to(cuda) for a in args), count,
                                                           iters=iters))
        if iters:
            assert_rows_agree(xg, wg, xc, wc)
        else:
            np.testing.assert_allclose(_pdist(xg), _pdist(xc), rtol=0, atol=MDS_TOL)


@pytest.mark.gpu
def test_torch_backend_solo_equals_batched_on_card(cuda):
    """C4 on the card at the full chunk width (2048 conformer rows)."""
    entries = t_enumerate(16, seed=23)
    mols = [parse_smiles(s) for _, s in entries]
    seeds = [77 + i for i in range(len(mols))]
    batch = TE.embed_conformers_many(mols, 8, seeds=seeds, backend="torch", device=cuda)
    for k in (0, 7, 15):
        solo = TE.embed_conformers_many([mols[k]], 8, seeds=[seeds[k]], backend="torch",
                                        device=cuda)[0]
        np.testing.assert_array_equal(batch[k], solo)
    for mol, x in zip(mols, batch):
        if not isinstance(x, Exception):
            _bond_and_ring_gates(mol, x)
