"""The plain reference against the program's CPU screen on a tiny
library (a test of the reference, not the gate), its control, the
benchmark's copy of the host chemistry against the program's, and the
work count against a shape worked by hand."""

import numpy as np
import pytest

import roofline
import screen_reference as ref
from ligand_traffic import TYPE_INDEX, fragment_ligands, model_state

WEIGHTS = {"Cation": 8.0, "Anion": 8.0, "Aromatic": 4.0, "HBond_donor": 4.0,
           "HBond_acceptor": 4.0, "Halogen": 4.0, "Hydrophobic": 1.0}


@pytest.mark.parametrize("clusters,conformers", [(20, 4), (40, 8)])
def test_reference_agrees_with_the_programs_cpu_screen(clusters, conformers):
    from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
    from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener, PackedLigand

    state = model_state(clusters, 0)
    lib = fragment_ligands(48, conformers, 2024)
    program = PharmacophoreModel()
    program.__setstate__(state)
    got = BatchScreener(program, WEIGHTS, engine="reference", device="cpu").score_packed(
        [PackedLigand(**lib.ligand(i)) for i in range(len(lib))])
    model = ref.Model(state, WEIGHTS)
    want = [ref.ligand_score(model, lib.ligand(i)) for i in range(len(lib))]
    shares = [ref.tolerance_share(g, w, 2e-5, 1e-4) for g, w in zip(got, want)]
    assert max(shares) < 0.05
    assert sum(w > 0 for w in want) > len(want) // 2
    control = [ref.ligand_score(model, lib.ligand(i), "bfloat16") for i in range(len(lib))]
    assert max(ref.tolerance_share(g, w, 2e-5, 1e-4) for g, w in zip(control, want)) > 100


def test_the_copied_chemistry_packs_as_the_program_does():
    """ligchem's SMILES -> conformers -> packed ligand equals the program's
    prepack --smiles path (numpy embedder) on the same molecules and seeds,
    cluster by cluster (the copy numbers nodes cluster by cluster)."""
    from ligchem.fragments import enumerate_fragment_smiles
    from ligchem.library import embed_chunk
    from pharmaconet_tpu_torch.scoring.batch_screen import PackedLigand
    from pharmaconet_tpu_torch.scoring.parse_pool import _embed_chunk_job

    smiles = [smi for _, smi in enumerate_fragment_smiles(24, seed=77)]
    seeds = [2**40 + 3 * i for i in range(len(smiles))]
    ours = embed_chunk(([(i, smi, s) for i, (smi, s) in enumerate(zip(smiles, seeds))], 4))
    theirs = dict(_embed_chunk_job(
        ([(str(i), smi, s) for i, (smi, s) in enumerate(zip(smiles, seeds))], 4, "numpy", "cpu")))
    assert sum(m is not None for _, m in ours) == len(theirs) >= 20
    for i, m in ours:
        if m is None:
            assert str(i) not in theirs
            continue
        p = PackedLigand.from_ligand(theirs[str(i)])
        np.testing.assert_array_equal(m["cluster_mask"], p.cluster_mask)
        np.testing.assert_array_equal(m["cluster_center"], p.cluster_center)
        np.testing.assert_array_equal(m["cluster_size"], p.cluster_size)
        assert [len(c) for c in m["clusters"]] == [len(c) for c in p.clusters]
        for a, b in zip(m["clusters"], p.clusters):
            np.testing.assert_array_equal(m["node_pos"][a], p.node_pos[b])
            np.testing.assert_array_equal(m["node_mask"][a], p.node_mask[b])


def test_bf16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, -3.0e-3, 65504.0], np.float32)
    # 1 + 2^-8 ties to even (1.0); 1 + 1.5 * 2^-8 rounds up to 1 + 2^-7
    np.testing.assert_array_equal(
        ref._bf16(x), np.array([1.0, 1.0, 1.0078125, -0.0030059814453125, 65536.0], np.float32))


def test_f32_ops_and_bound_by_hand():
    # 2 conformers, 3 distance rows, 5 entries: 9*2*5 + 9*2*3 = 144
    assert roofline.f32_ops(2, 3, 5, True, ()) == 144
    assert roofline.f32_ops(2, 3, 5, False, (1, 2)) == 90 + 3 * (2 * 2 * 3 + 3 * 2)
    t, by = roofline.least_seconds(67e12, 1e9)
    assert (t, by) == (1.0, "f32")
    t, by = roofline.least_seconds(1.0, 3.35e12)
    assert (t, by) == (1.0, "hbm")


def _hand_model():
    """Two model clusters: 0 = two Hydrophobic nodes, 1 = one Aromatic node
    placed far away (the prune drops every pair that needs it)."""
    nodes = [("Hydrophobic", (0.0, 0.0, 0.0), 1.0), ("Hydrophobic", (1.0, 0.0, 0.0), 1.0),
             ("Aromatic", (50.0, 0.0, 0.0), 1.0)]
    state = dict(
        nodes=[dict(index=i, type=t, center=c, radius=r) for i, (t, c, r) in enumerate(nodes)],
        edges=[dict(node_indices=(i, j), distance_mean=abs(nodes[i][1][0] - nodes[j][1][0]),
                    distance_std=1.0) for i in range(3) for j in range(i, 3)],
        node_cluster_dict={
            "Hydrophobic": [dict(node_indices=(0, 1), node_types=("Hydrophobic",),
                                 center=(0.5, 0.0, 0.0), size=1.0)],
            "Aromatic": [dict(node_indices=(2,), node_types=("Aromatic",),
                              center=(50.0, 0.0, 0.0), size=1.0)]},
    )
    return ref.Model(state, WEIGHTS)


def test_work_of_a_ligand_worked_by_hand():
    model = _hand_model()
    h, a = 1 << TYPE_INDEX["Hydrophobic"], 1 << TYPE_INDEX["Aromatic"]
    # clusters: [u0, u1] Hydrophobic, [u2] Hydrophobic, [u3] Aromatic
    pos = np.array([[0, 0, 0], [1, 0, 0], [3, 0, 0], [2, 0, 0]], np.float32)[:, None, :]
    lig = dict(node_pos=pos, node_mask=np.array([h, h, h, a], np.int32),
               clusters=[[0, 1], [2], [3]], cluster_mask=np.array([h, h, a], np.int32),
               cluster_center=np.array([[[0.5, 0, 0]], [[3, 0, 0]], [[2, 0, 0]]], np.float32),
               cluster_size=np.array([[0.5], [0.0], [0.0]], np.float32), num_conformers=1)
    # self pair (u0, u1) x model cluster 0: 2 x 2 = 4 entries, 1 row;
    # cross (c0, c1) x (0, 0): (u0, u2) and (u1, u2), 2 x 2 each = 8, 2 rows;
    # (c0, c2) and (c1, c2) need model cluster 1, 48.5 A off: pruned
    entries, rows = roofline.ligand_work(model, lig, roofline.type_counts(model))
    assert (entries, rows) == (12, 3)


@pytest.mark.parametrize("clusters,conformers", [(20, 8), (40, 4)])
def test_library_work_is_the_sum_of_its_ligands(clusters, conformers):
    model = ref.Model(model_state(clusters, 3), WEIGHTS)
    lib = fragment_ligands(120, conformers, 5)
    counts = roofline.type_counts(model)
    entries = rows = 0
    for i in range(len(lib)):
        e, r = roofline.ligand_work(model, lib.ligand(i), counts)
        entries += e
        rows += r
    ops, nbytes = roofline.screening_work(model, lib, chunk=97)
    assert ops == roofline.f32_ops(conformers, rows, entries, True, ())
    assert nbytes == 120 * 4 + sum(
        len(lib.ligand(i)["node_mask"]) * (12 * conformers + 4) + 4 * len(lib.ligand(i)["clusters"])
        for i in range(len(lib)))
