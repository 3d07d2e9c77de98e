"""`pharmaconet_tpu_torch.cli.verify_checkpoint` against the JAX package's
`cli/verify_checkpoint.py`.

The port-against-JAX comparison of a checkpoint lives here, not in the
port's CLI (the port never imports the JAX package): both CLIs run on the
same synthesized upstream tar (`--skip_modeling`, as
`tests/test_checkpoint.py`) and must report the same stages, ok flags and
counts; a drifted tar gives rc 1 in both; stage 5 converts a synthesized
upstream `.pth` of either proxy with the same parameter count. Stages 3-4
are functions of a built PharmacoNet: at the small configuration of
`test_torch_crosscheck.py` on the CPU they find the JAX package's hotspots
and nodes, and TF32 (absent on the CPU) flips no voxel.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from pharmaconet_tpu.cli import verify_checkpoint as jvc
from pharmaconet_tpu.module import PharmacoNet as JaxPharmacoNet
from pharmaconet_tpu.network.convert import synthesize_torch_state_dict
from pharmaconet_tpu.pharmacophore.model import PharmacophoreModel as JaxPharmacophoreModel
from pharmaconet_tpu_torch.cli import verify_checkpoint as vc
from pharmaconet_tpu_torch.module import PharmacoNet
from pharmaconet_tpu_torch.synthetic import write_synthetic_site
from test_proxy_convert import _synth_sbdd_state, _synth_tacogfn_state
from test_torch_crosscheck import GRID, KW, SMALL_SITE, small_checkpoint

TYPES = ["Hydrophobic", "PiStacking_P", "PiStacking_T", "PiCation_lring", "PiCation_pring",
         "HBond_ldon", "HBond_pdon", "SaltBridge_lneg", "SaltBridge_pneg", "XBond"]


@pytest.fixture(scope="module")
def tar(tmp_path_factory):
    """tests/test_checkpoint.py's synthesized tar (seed 3)."""
    rng = np.random.default_rng(3)
    state = synthesize_torch_state_dict(seed=3)
    path = tmp_path_factory.mktemp("ckpt") / "model.tar"
    torch.save({
        "config": {"MODEL": {"EMBED_DIM": 96}},
        "model": {k: torch.from_numpy(v) for k, v in state.items()},
        "score_distributions": {t: {"focus": rng.uniform(0, 1, 500).tolist()} for t in TYPES},
    }, path)
    return path


def _both(tmp_path, *argv: str) -> tuple[tuple[int, dict], tuple[int, dict]]:
    """(rc, report) of the port's CLI (on the CPU) and of the JAX CLI."""
    out = []
    for name, mod, extra in (("port", vc, ["--device", "cpu"]), ("jax", jvc, [])):
        report = tmp_path / f"{name}.json"
        rc = mod.main(mod.build_parser().parse_args([*argv, "--out", str(report), *extra]))
        out.append((rc, json.loads(report.read_text())))
    return out[0], out[1]


def _summary(report: dict) -> list[tuple]:
    return [(s["stage"], s["ok"], {k: v for k, v in s.items() if k not in ("stage", "ok")})
            for s in report["stages"]]


def test_reports_equal_jax(tar, tmp_path):
    (rc, got), (jrc, want) = _both(tmp_path, "--checkpoint", str(tar), "--skip_modeling")
    assert rc == jrc == 0 and got["ok"] is want["ok"] is True
    assert _summary(got) == _summary(want)
    assert [s["stage"] for s in got["stages"]] == ["load_convert", "activation_parity"]
    assert got["stages"][0]["distributions"] == 10
    assert got["stages"][0]["params"] == sum(v.size for v in synthesize_torch_state_dict(3).values())
    assert got["stages"][1]["skipped"] == "reference src absent"


def test_schema_drift_gives_rc_1(tar, tmp_path):
    """A tar missing a learned tensor and holding an unknown one fails the
    coverage stage in both CLIs with the same report, before any load."""
    checkpoint = torch.load(tar, map_location="cpu", weights_only=False)
    del checkpoint["model"]["token_head.feature_mlp.0.weight"]
    checkpoint["model"]["bogus.extra.weight"] = torch.zeros(3)
    bad = tmp_path / "bad.tar"
    torch.save(checkpoint, bad)
    (rc, got), (jrc, want) = _both(tmp_path, "--checkpoint", str(bad), "--skip_modeling")
    assert rc == jrc == 1 and got == want
    assert got["stages"] == [{"stage": "load_convert", "ok": False,
                              "missing": ["token_head.feature_mlp.0.weight"],
                              "unexpected": ["bogus.extra.weight"]}]


@pytest.mark.parametrize("proxy_type", ["tacogfn", "sbddreward"])
def test_proxy_convert_stage(tar, tmp_path, proxy_type):
    """Stage 5 on a synthesized upstream .pth of each proxy: ok, with the
    JAX CLI's parameter count; a broken one fails the stage, not the CLI."""
    rng = np.random.default_rng(7)
    if proxy_type == "tacogfn":
        state = _synth_tacogfn_state(rng)
        ckpt = {"model": {k: torch.from_numpy(v) for k, v in state.items()}}
    else:
        state = _synth_sbdd_state(rng)
        ckpt = {k: torch.from_numpy(v) for k, v in state.items()}
    torch.save(ckpt, tmp_path / "proxy.pth")
    argv = ("--checkpoint", str(tar), "--skip_modeling", "--proxy", str(tmp_path / "proxy.pth"),
            "--proxy_type", proxy_type)
    (rc, got), (jrc, want) = _both(tmp_path, *argv)
    assert rc == jrc == 0 and _summary(got) == _summary(want)
    stage = got["stages"][-1]
    assert stage["stage"] == "proxy_convert" and stage["ok"] and stage["params"] > 10**5

    torch.save({"model": {"bogus": torch.zeros(2)}}, tmp_path / "broken.pth")
    argv = ("--checkpoint", str(tar), "--skip_modeling", "--proxy",
            str(tmp_path / "broken.pth"), "--proxy_type", proxy_type, "--device", "cpu")
    assert vc.main(vc.build_parser().parse_args(argv)) == 1


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("small")
    small_checkpoint(tmp / "small.npz")
    protein, ligand = write_synthetic_site(tmp / "site", **SMALL_SITE)
    port = PharmacoNet(weight_path=tmp / "small.npz", device="cpu", **KW)
    jax_net = JaxPharmacoNet(weight_path=tmp / "small.npz", **KW)
    port.focus_threshold = jax_net.focus_threshold = 0.0
    return port, jax_net, port.parse(protein, ligand)


def test_modeling_stages_match_jax(small):
    """Stages 3-4 on a built PharmacoNet: our_modeling finds the JAX
    package's hotspots and nodes; tf32_probe passes with no flip."""
    port, jax_net, data = small
    report = vc.Report()
    infos, model = vc.modeling_stage(port, data, report)
    jax_infos = jax_net.create_density_maps(data)
    jax_model = JaxPharmacophoreModel.create(data.pdbblock, data.center, jax_infos, size=GRID)
    assert len(infos) == len(jax_infos) >= 4
    assert len(model.nodes) == len(jax_model.nodes)
    assert [(h["nci_type"], h["hotspot_position"]) for h in infos] == [
        (h["nci_type"], h["hotspot_position"]) for h in jax_infos]
    probe = vc.tf32_probe(port, data, report)
    assert probe == {"flips": 0, "max_delta": 0.0, "hotspots": len(infos)}
    assert [(s["stage"], s["ok"]) for s in report.stages] == [
        ("our_modeling", True), ("tf32_probe", True)]
    assert report.ok and port.segmentation_precision == "tensorfloat32"


def test_tf32_probe_counts_flips(small, monkeypatch):
    """A segmentation that differs between the precisions fails the probe
    with the count of voxels that crossed the threshold."""
    port, _, data = small
    real = PharmacoNet.segment_logits

    def shifted(self, out, hot_tokens, hot_features):
        logits = real(self, out, hot_tokens, hot_features)
        return logits - 50.0 if self.segmentation_precision == "tensorfloat32" else logits

    monkeypatch.setattr(PharmacoNet, "segment_logits", shifted)
    report = vc.Report()
    probe = vc.tf32_probe(port, data, report)
    assert not report.ok and report.stages[0]["stage"] == "tf32_probe"
    assert probe["flips"] == -1 or probe["flips"] > 0
