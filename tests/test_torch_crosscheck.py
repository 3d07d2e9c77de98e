"""`pharmaconet_tpu_torch.utils.crosscheck` against the JAX package's
`utils/crosscheck.py`.

Both packages model one synthetic pocket at a small configuration (embed 8,
depths (2, 2), grid 32; the JAX package's random parameters with the mask
logits' bias at 1.0, as `test_torch_modeling.py`), then both packages'
report functions run on the same inputs: the two packages' maps and
graphs as they are, and with one hotspot dropped, one voxel flipped and one
node shifted. The reports must be equal, dict for dict. The upstream
reference checkout is absent here: its loaders raise `FileNotFoundError`
naming the path, and the verifier reports its stages as skipped.
"""

from __future__ import annotations

import copy
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from pharmaconet_tpu.module import PharmacoNet as JaxPharmacoNet
from pharmaconet_tpu.network.convert import save_npz_checkpoint
from pharmaconet_tpu.network.model import build_model as jax_build_model
from pharmaconet_tpu.pharmacophore.model import PharmacophoreModel as JaxPharmacophoreModel
from pharmaconet_tpu.utils import crosscheck as jcc
from pharmaconet_tpu_torch.module import PharmacoNet
from pharmaconet_tpu_torch.network.convert import random_distributions
from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
from pharmaconet_tpu_torch.synthetic import write_synthetic_site
from pharmaconet_tpu_torch.utils import crosscheck as cc

SMALL = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window=2, token_feature_dim=16)
GRID = 32
KW = dict(verbose=False, max_hotspots=8, segmentation_chunk=4, grid_dim=GRID,
          model_kwargs=SMALL, score_threshold=0.5)
SMALL_SITE = dict(cavity_radius=3.0, num_atoms=1500, outer_radius=24.0)


def small_checkpoint(path) -> None:
    """The small network's .npz: the JAX package's random parameters
    (seed 3) with the mask logits' bias at 1.0, so maps are not empty."""
    holder = SimpleNamespace(grid_dim=GRID, model=jax_build_model(GRID, **SMALL))
    params = jax.tree.map(np.asarray, JaxPharmacoNet._random_params(holder, 3))
    params["params"]["mask_head"]["conv_logits"]["bias"][:] = 1.0
    save_npz_checkpoint(path, params, random_distributions())


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("crosscheck")
    small_checkpoint(tmp / "small.npz")
    protein, ligand = write_synthetic_site(tmp / "site", **SMALL_SITE)
    jax_net = JaxPharmacoNet(weight_path=tmp / "small.npz", **KW)
    jax_net.focus_threshold = 0.0
    data = jax_net.parse(protein, ligand)
    port = PharmacoNet(weight_path=tmp / "small.npz", device="cpu", **KW)
    port.focus_threshold = 0.0
    ours, theirs = port.create_density_maps(data), jax_net.create_density_maps(data)
    assert len(ours) >= 4
    return SimpleNamespace(
        data=data, ours=ours, theirs=theirs,
        graph=PharmacophoreModel.create(data.pdbblock, data.center, ours, size=GRID),
        jax_graph=JaxPharmacophoreModel.create(data.pdbblock, data.center, theirs, size=GRID))


def _flip_one_voxel(infos: list[dict]) -> list[dict]:
    """A copy with the first on-voxel of hotspot 0 switched off."""
    out = [dict(h) for h in infos]
    m = out[0]["point_map"].copy()
    m[np.unravel_index(np.flatnonzero(m > 0)[0], m.shape)] = 0.0
    out[0]["point_map"] = m
    return out


PERTURB = {
    "as_is": lambda infos: infos,
    "dropped": lambda infos: infos[:-1],
    "flipped": _flip_one_voxel,
    "all": lambda infos: _flip_one_voxel(infos)[:-1],
}


@pytest.mark.parametrize("budget", [0, 1])
@pytest.mark.parametrize("perturb", list(PERTURB))
def test_hotspot_reports_equal_jax(case, perturb, budget):
    theirs = PERTURB[perturb](case.theirs)
    got = cc.compare_hotspot_infos(case.ours, theirs, raise_on_fail=False,
                                   max_flip_voxels=budget)
    want = jcc.compare_hotspot_infos(case.ours, theirs, raise_on_fail=False,
                                     max_flip_voxels=budget)
    assert got == want
    if perturb == "as_is":
        assert got["mismatches"] == [] and got["support_flip_voxels"] == 0
        assert got["max_point_map_diff"] <= 1e-5  # the two packages' f32 maps
    if perturb in ("dropped", "all"):
        assert f"hotspot count {len(case.ours)} vs {len(case.ours) - 1}" in got["mismatches"]
    if perturb == "flipped":
        assert got["support_flip_voxels"] == 1
        over = "1 support-flip voxels total (budget 0)"
        assert (over in got["mismatches"]) == (budget == 0)
        # within the budget the flip's halo leaves the value check
        assert bool(got["mismatches"]) == (budget == 0)


def test_hotspot_report_raises_on_mismatch(case):
    for mod in (cc, jcc):
        with pytest.raises(AssertionError, match="hotspot count"):
            mod.compare_hotspot_infos(case.ours, case.theirs[:-1])


def _shift_node(graph, by: float = 0.01):
    out = copy.deepcopy(graph)
    node = out.nodes[0]
    node.center = tuple(float(v) + by for v in node.center)
    return out


@pytest.mark.parametrize("shift", [0.0, 0.01, 1e-4])
def test_graph_reports_equal_jax(case, shift):
    theirs = _shift_node(case.jax_graph, shift) if shift else case.jax_graph
    got = cc.compare_graphs(case.graph, theirs, raise_on_fail=False)
    want = jcc.compare_graphs(case.graph, theirs, raise_on_fail=False)
    assert got == want
    assert got["nodes"][0] == len(case.graph.nodes) >= 4
    if shift > cc.GEOM_ATOL:
        assert any("center" in m for m in got["mismatches"])
    else:
        assert got["mismatches"] == []
    if shift > cc.GEOM_ATOL:
        for mod in (cc, jcc):
            with pytest.raises(AssertionError):
                mod.compare_graphs(case.graph, theirs)


def test_reference_protein_data_equals_jax(case):
    """The upstream input tuple: the port voxelizes with its own voxelizer
    (the plain version on CPU tensors) and matches the JAX function's."""
    got = cc.reference_protein_data(case.data)
    want = jcc.reference_protein_data(case.data)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5, rtol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_loaders_without_a_reference_checkout(tmp_path):
    """The JAX package's checkout path is absent here: the port's loaders
    name it and raise FileNotFoundError; so do an empty path and an unset
    one."""
    for src in (jcc.REF_SRC, str(tmp_path / "absent"), ""):
        assert not cc.reference_available(src)
        with pytest.raises(FileNotFoundError, match="PMNET_REFERENCE_SRC"):
            cc.import_reference_module(src)
        with pytest.raises(FileNotFoundError, match="PMNET_REFERENCE_SRC"):
            cc.load_reference_network({}, src)
    assert cc.reference_available(str(tmp_path))


def test_reference_stubs_are_idempotent(monkeypatch):
    """The stubs upgrade a narrower openbabel stub in place, answer no
    dunder, and leave a real package alone."""
    for name in ("openbabel", "openbabel.pybel", "omegaconf", "molvoxel", "Bio", "Bio.PDB",
                 "Bio.PDB.PDBIO"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    narrow = type(sys)("openbabel")
    monkeypatch.setitem(sys.modules, "openbabel", narrow)
    cc.install_reference_stubs()
    cc.install_reference_stubs()
    ob = sys.modules["openbabel"]
    assert ob is narrow and ob.pybel.ob.anything.at.all() is cc._ANY
    with pytest.raises(AttributeError):
        ob.pybel.__wrapped__  # noqa: B018
    assert issubclass(type("S", (sys.modules["Bio.PDB.PDBIO"].Select,), {}), object)
    real = type(sys)("openbabel")
    real.__file__ = "/x/openbabel/__init__.py"
    monkeypatch.setitem(sys.modules, "openbabel", real)
    cc.install_openbabel_stub()
    assert sys.modules["openbabel"] is real and not hasattr(real, "pybel")
