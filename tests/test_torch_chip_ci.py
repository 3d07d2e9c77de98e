"""The port's on-chip battery (`pharmaconet_tpu_torch.probes.chip_ci`) on
the CPU, and the mask decoder's precision it guards.

`--device cpu --fast` runs C1-C5 at their sizes with the kernels' plain
versions; every check must pass, C5's screens in fresh processes giving
one CSV of 256 rows. C3 must trip on a TF32 product in the
leaf chain. C6/C7 run on a small network (embed 8, depths (2, 2), grid 32;
random parameters with the mask logits' bias at 1.0 so maps are not
empty): TF32 does not exist on the CPU, so C6 sees no deviation, one TF32
pass none either, and C7's host scatter of the sparse wire equals the
dense maps bit for bit. On a card (`gpu` marker) the decoder's default
'tensorfloat32' gives float32's logits bit for bit. No JAX import: the `gpu` tests run on the card.
"""

from __future__ import annotations

import json

import pytest
import torch

from pharmaconet_tpu_torch.module import PharmacoNet
from pharmaconet_tpu_torch.network.convert import (
    random_distributions,
    random_state_dict,
    save_torch_checkpoint,
)
from pharmaconet_tpu_torch.network.model import build_model
from pharmaconet_tpu_torch.probes import chip_ci
from pharmaconet_tpu_torch.synthetic import write_synthetic_site

SMALL = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window=2, token_feature_dim=16)
GRID = 32


@pytest.fixture
def two_threads():
    """Two CPU threads: the embeds of C1 and C4 are many small ops, which
    every core of a machine shared with other test workers slows rather
    than speeds."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_battery_fast_on_cpu(capsys, two_threads):
    """C1-C5 on the CPU, each ok, C5 with one CSV of 256 rows from its
    fresh processes; the last line is the JSON summary."""
    assert chip_ci.main(["--device", "cpu", "--fast"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["fast"] and summary["n_fail"] == 0
    checks = summary["checks"]
    assert list(checks) == ["C1_kernel_vs_matcher", "C2_leaf_store_vs_dfs",
                            "C3_leaf_einsum_f32", "C4_embed_determinism", "C5_csv_roundtrip"]
    assert all(c["ok"] for c in checks.values())
    assert "skipped" not in checks["C5_csv_roundtrip"]
    assert checks["C5_csv_roundtrip"]["rows"] == 256
    assert checks["C5_csv_roundtrip"]["runs"] == chip_ci.C5_RUNS
    assert checks["C1_kernel_vs_matcher"]["n"] >= 56
    assert checks["C2_leaf_store_vs_dfs"]["n"] == 256
    assert checks["C3_leaf_einsum_f32"]["max_rel"] < chip_ci.C3_REL
    assert not any(summary["launches"].values())  # plain versions only


def test_c3_trips_on_a_tf32_product(tmp_path, monkeypatch):
    """C3 fails when matrix products may run in TF32."""
    model = chip_ci.battery_model()
    cpu = torch.device("cpu")
    chip_ci.write_battery_store(tmp_path / "tiles", model, cpu)
    assert chip_ci.leaf_einsum_f32(tmp_path / "tiles", model, cpu)["max_rel"] < chip_ci.C3_REL
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="full-f32"):
        chip_ci.leaf_einsum_f32(tmp_path / "tiles", model, cpu)


def small_net(path, device) -> PharmacoNet:
    net = PharmacoNet(weight_path=path, device=device, verbose=False, max_hotspots=8,
                      segmentation_chunk=4, grid_dim=GRID, model_kwargs=SMALL)
    net.focus_threshold = 0.0  # random weights: open the cavity gate
    return net


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("small")
    state = random_state_dict(build_model(image_size=GRID, **SMALL).config, 3)
    state["mask_head.conv_logits.bias"][:] = 1.0
    save_torch_checkpoint(tmp / "small.tar", {k: v.numpy() for k, v in state.items()},
                          random_distributions())
    net = small_net(tmp / "small.tar", "cpu")
    protein, ligand = write_synthetic_site(tmp / "site", cavity_radius=3.0, num_atoms=1500,
                                           outer_radius=24.0)
    return net, net.parse(protein, ligand), tmp / "small.tar"


def test_c6_c7_on_a_small_chunk(small):
    net, data, _ = small
    detail, state = chip_ci.seg_precision(net, data)
    assert detail["on_voxels"] > 0 and detail["voxel_flips"] == 0 and detail["max_rel"] == 0.0
    assert detail["one_pass_voxel_flips"] == 0 and detail["one_pass_max_rel"] == 0.0
    wire = chip_ci.sparse_density_wire(state)
    assert wire["maps"] == net.segmentation_chunk and 0 < wire["max_count"] <= wire["cap"]

    vals, idxs, counts = state["sparse"]
    bad = vals.clone()
    bad[int(torch.argmax(counts)), 0] += 1.0
    with pytest.raises(AssertionError, match="sparse reconstruction differs"):
        chip_ci.sparse_density_wire({"dense": state["dense"], "sparse": (bad, idxs, counts)})
    over = counts.clone()
    over[0] = vals.shape[1] + 1
    with pytest.raises(AssertionError, match="cap"):
        chip_ci.sparse_density_wire({"dense": state["dense"], "sparse": (vals, idxs, over)})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_decoder_default_is_f32(small, cuda):
    """On the card the decoder's default 'tensorfloat32' gives float32's
    logits bit for bit on a chunk."""
    _, data, path = small
    net = small_net(path, cuda)
    out, hot, feats, _ = chip_ci.seg_chunk(net, data)
    logits = {}
    for precision in ("tensorfloat32", "float32"):
        net.segmentation_precision = precision
        logits[precision] = net.segment_logits(out, hot, feats)
    assert torch.equal(logits["tensorfloat32"], logits["float32"])
