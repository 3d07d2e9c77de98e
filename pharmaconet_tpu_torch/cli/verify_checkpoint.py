"""One-command verification of a PharmacoNet checkpoint in the port.

    python -m pharmaconet_tpu_torch.cli.verify_checkpoint --checkpoint model.tar \
        [--protein pocket.pdb --ref_ligand ligand.pdb] [--device cuda]

The counterpart of the JAX package's `cli/verify_checkpoint.py`, with the
same flags (plus `--device`), stage names and JSON report:

  1. load_convert       upstream tar -> the port's state dict; key coverage
                        against the published architecture
                        (`network.convert.synthesize_torch_state_dict`),
                        checked before anything loads: a drifted checkpoint
                        gives rc 1 and a report, not a crash
  2. activation_parity  the upstream torch network built from the same
                        weights, every stage (backbone pyramid, cavity and
                        token heads, segmentation) against the port's
                        network at 64^3 (atol 1e-4 + rtol 2e-5); skipped as
                        ok without an upstream checkout (`--reference_src`,
                        default `$PMNET_REFERENCE_SRC`)
  3. our_modeling       the port's PharmacoNet on the pocket (default: a
                        synthetic pocket with a ligand at its centre,
                        `synthetic.write_synthetic_site`); with an upstream
                        checkout also modeling_parity and graph_parity
                        (`utils/crosscheck.py`) against upstream's
                        create_density_maps on the same voxelized tensors
  4. tf32_probe         the mask decoder at tensorfloat32 against float32
                        on the kept hotspots: no map may gain or lose a
                        voxel at the threshold (cuDNN and cuBLAS TF32 are
                        what this guards on a card; on the CPU TF32 does
                        not exist and the two agree)
  5. proxy_convert      optional --proxy .pth/.pt through the port's
                        tacogfn/sbddreward converters

Exit code 0 if and only if every stage that can run passes; the report
also goes to --out as JSON. Stages 3-4 are functions of a built
`PharmacoNet` (`modeling_stage`, `tf32_probe`), so they run at any
configuration; the CLI builds the published architecture from the tar.
"""

from __future__ import annotations

import argparse
import copy
import json
import tempfile

import numpy as np
import torch

from ..utils.crosscheck import REF_SRC

BUFFER_SUFFIXES = ("relative_coords_table", "relative_position_index", "attn_mask")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "verify_checkpoint", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    p.add_argument("--checkpoint", required=True, help="upstream model.tar")
    p.add_argument("--protein", default=None,
                   help="pocket PDB (default: a synthetic pocket with a ligand at its centre)")
    p.add_argument("--ref_ligand", default=None,
                   help="reference ligand (default: the synthetic pocket's ligand)")
    p.add_argument("--reference_src", default=REF_SRC,
                   help="upstream checkout (stages 2-3's parity skipped if absent)")
    p.add_argument("--out", default=None, help="JSON report path")
    p.add_argument("--proxy", default=None, help="optional proxy .pth/.pt")
    p.add_argument("--proxy_type", default="sbddreward", choices=["sbddreward", "tacogfn"])
    p.add_argument("--skip_modeling", action="store_true",
                   help="skip the (slow) full-pocket modeling stages")
    p.add_argument("--device", default="cuda", help="torch device of the network")
    return p


def _close(a, b, what, report, atol=1e-4, rtol=2e-5):
    a, b = np.asarray(a), np.asarray(b)
    diff = float(np.max(np.abs(a - b))) if a.size else 0.0
    bound = atol + rtol * float(np.max(np.abs(a))) if a.size else atol
    ok = a.shape == b.shape and diff <= bound
    report.append({"check": what, "ok": ok, "max_diff": diff, "bound": bound})
    return ok


class Report:
    """Stage results in order; `ok` while every stage passed."""

    def __init__(self):
        self.stages: list[dict] = []
        self.ok = True

    def stage(self, name: str, ok: bool, **info) -> None:
        self.ok = self.ok and bool(ok)
        self.stages.append({"stage": name, "ok": bool(ok), **info})
        print(f"[{'ok' if ok else 'FAIL'}] {name}: "
              + " ".join(f"{k}={v}" for k, v in info.items()), flush=True)

    def write(self, path) -> dict:
        report = {"ok": self.ok, "stages": self.stages}
        if path:
            with open(path, "w") as w:
                json.dump(report, w, indent=1)
        return report


def schema_drift(state: dict) -> tuple[list[str], list[str]]:
    """(missing, unexpected) keys of an upstream state dict against the
    published architecture; recomputed buffers are not unexpected."""
    from ..network.convert import synthesize_torch_state_dict

    template = set(synthesize_torch_state_dict(seed=0))
    missing = sorted(template - set(state))
    unexpected = sorted(k for k in set(state) - template if not k.endswith(BUFFER_SUFFIXES))
    return missing, unexpected


def activation_parity(net, ref_net, report: Report) -> None:
    """Stage 2: upstream's network against the port's on one random 64^3
    image and 8 tokens, stage by stage."""
    rng = np.random.default_rng(42)
    image = rng.normal(0, 1, (1, 33, 64, 64, 64)).astype(np.float32)
    tokens = np.concatenate(
        [rng.integers(0, 64, (8, 3)), rng.integers(0, 10, (8, 1))], axis=1).astype(np.int32)
    checks: list[dict] = []
    with torch.no_grad():
        image_t, tokens_t = torch.from_numpy(image), torch.from_numpy(tokens)
        feats = ref_net.forward_feature(image_t)
        narrow, wide = ref_net.forward_cavity_extraction(feats[-1])
        scores_list, tf_list = ref_net.forward_token_prediction(feats[-1], [tokens_t])
        per_box = [ref_net.forward_segmentation(
            feats, [tokens_t[i : i + 1]], [tf_list[0][i : i + 1]])[0][0].numpy()
            for i in range(len(tokens))]

    def to_ndhwc(x):
        a = x.detach().cpu().numpy()
        return np.transpose(a, (0, 2, 3, 4, 1)) if a.ndim == 5 else a

    from ..module import precision_scope

    model, dev = net.model, net.device
    with torch.no_grad(), precision_scope("float32", dev):
        image_d = torch.from_numpy(np.ascontiguousarray(np.transpose(image, (0, 2, 3, 4, 1))))
        pyramid = model.forward_feature(image_d.to(dev))
        narrow_p, wide_p = model.forward_cavity_extraction(pyramid[-1])
        tokens_d = torch.from_numpy(tokens).to(dev)
        logits_p, tf_p = model.forward_token_prediction(pyramid[-1], tokens_d)
        masks_p = model.forward_segmentation(pyramid, tokens_d, tf_p)
    ok = True
    for i, (r, o) in enumerate(zip(feats, pyramid)):
        ok &= _close(to_ndhwc(r), o.cpu().numpy(), f"pyramid[{i}]", checks)
    ok &= _close(to_ndhwc(narrow), narrow_p.cpu().numpy(), "cavity_narrow", checks)
    ok &= _close(to_ndhwc(wide), wide_p.cpu().numpy(), "cavity_wide", checks)
    ok &= _close(scores_list[0].numpy(), logits_p.cpu().numpy(), "token_logits", checks)
    ok &= _close(tf_list[0].numpy(), tf_p.cpu().numpy(), "token_features", checks)
    ok &= _close(np.concatenate(per_box, axis=0), masks_p.cpu().numpy(), "segmentation", checks)
    worst = max(checks, key=lambda c: c["max_diff"] / max(c["bound"], 1e-12))
    report.stage("activation_parity", ok, checks=len(checks),
                 worst=f"{worst['check']}:{worst['max_diff']:.2e}")


def modeling_stage(net, data, report: Report):
    """Stage 3 (our_modeling): the port's maps and graph of the pocket.
    Returns (hotspot infos, PharmacophoreModel)."""
    from ..pharmacophore.model import PharmacophoreModel

    infos = net.create_density_maps(data)
    model = PharmacophoreModel.create(data.pdbblock, data.center, infos, size=net.grid_dim)
    report.stage("our_modeling", len(infos) > 0, hotspots=len(infos), nodes=len(model.nodes))
    return infos, model


def modeling_parity(net, data, infos, model, state, distributions, ref_src, report) -> None:
    """Stage 3's parity stages against upstream on the same voxelized tensors."""
    from ..utils.crosscheck import (
        compare_graphs,
        compare_hotspot_infos,
        import_reference_module,
        load_reference_network,
        make_reference_pharmaconet,
        reference_protein_data,
    )

    ref_module, ref_pm_mod = import_reference_module(ref_src)
    ref = make_reference_pharmaconet(ref_module, load_reference_network(state, ref_src),
                                     distributions, net.score_threshold)
    ref_infos = ref.create_density_maps(reference_protein_data(data, net.device))
    rep = compare_hotspot_infos(infos, ref_infos, raise_on_fail=False)
    report.stage("modeling_parity", not rep["mismatches"], ours=rep["ours"],
                 theirs=rep["theirs"], max_map_diff=f"{rep['max_point_map_diff']:.2e}",
                 mismatches=rep["mismatches"][:5])
    center = tuple(float(v) for v in data.center)
    ref_model = ref_pm_mod.PharmacophoreModel.create(data.pdbblock, center, ref_infos)
    grep = compare_graphs(model, ref_model, raise_on_fail=False)
    node_edge = [m for m in grep["mismatches"] if not m.startswith("cluster")]
    report.stage("graph_parity", not node_edge, nodes=grep["nodes"], edges=grep["edges"],
                 issues=node_edge[:5])


def tf32_probe(net, data, report: Report) -> dict:
    """Stage 4: the mask decoder at tensorfloat32 against float32 on the
    pocket's kept hotspots, from one trunk run. Passes with zero
    thresholded-voxel flips. Returns {"flips", "max_delta", "hotspots"}
    (flips -1 where the hotspot lists differ)."""
    out = net.run_trunk(data)
    keep_idx = np.nonzero(out["keep"].cpu().numpy())[0]
    infos = {}
    for precision in ("tensorfloat32", "float32"):
        variant = copy.copy(net)  # shares the network and its tensors
        variant.segmentation_precision = precision
        infos[precision] = variant._segment_kept(data, out, keep_idx)
    infos_a, infos_b = infos["tensorfloat32"], infos["float32"]
    flips = -1
    if len(infos_a) == len(infos_b):
        flips = sum(int(np.sum((a["point_map"] > 0) != (b["point_map"] > 0)))
                    for a, b in zip(infos_a, infos_b))
    max_delta = max((float(np.abs(a["point_map"] - b["point_map"]).max())
                     for a, b in zip(infos_a, infos_b)), default=0.0)
    report.stage("tf32_probe", flips == 0, thresholded_voxel_flips=flips,
                 max_density_delta=f"{max_delta:.2e}")
    return {"flips": flips, "max_delta": max_delta, "hotspots": len(infos_a)}


def proxy_convert(path, proxy_type: str, report: Report) -> None:
    """Stage 5: an upstream proxy checkpoint through the port's converter."""
    try:
        state = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
        state = {k: np.asarray(v) for k, v in state.items()}
        if proxy_type == "sbddreward":
            from ..proxy.sbddreward import convert_sbddreward_checkpoint as convert
        else:
            from ..proxy.tacogfn import convert_tacogfn_checkpoint as convert
        n = sum(int(v.numel()) for v in convert(state).values())
        report.stage("proxy_convert", n > 0, params=n, type=proxy_type)
    except Exception as e:  # noqa: BLE001 - report, don't crash
        report.stage("proxy_convert", False, error=str(e)[:200])


def main(args) -> int:
    from ..network.convert import load_torch_checkpoint
    from ..utils.crosscheck import reference_available

    report = Report()

    # stage 1: load + convert; schema coverage before anything loads
    raw = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    state = {k: v.numpy() for k, v in raw["model"].items()}
    missing, unexpected = schema_drift(state)
    if missing or unexpected:
        report.stage("load_convert", False, missing=missing[:5], unexpected=unexpected[:5])
        report.write(args.out)
        print("verify_checkpoint: FAIL (checkpoint schema drift)")
        return 1
    _, distributions, _ = load_torch_checkpoint(args.checkpoint)
    report.stage("load_convert", True, params=sum(np.asarray(v).size for v in state.values()),
                 distributions=len(distributions))

    ref_available = reference_available(args.reference_src)
    net = None
    if ref_available or not args.skip_modeling:
        from ..module import PharmacoNet

        net = PharmacoNet(weight_path=args.checkpoint, verbose=False, device=args.device)

    # stage 2: per-stage activation parity
    if ref_available:
        from ..utils.crosscheck import load_reference_network

        activation_parity(net, load_reference_network(state, args.reference_src), report)
    else:
        report.stage("activation_parity", True, skipped="reference src absent")

    # stages 3-4: pocket modeling, parity, TF32 probe
    if not args.skip_modeling:
        with tempfile.TemporaryDirectory() as tmp:
            protein, ligand = args.protein, args.ref_ligand
            if protein is None:
                from ..synthetic import write_synthetic_site

                protein, site_ligand = write_synthetic_site(tmp)
                ligand = ligand or site_ligand
            data = net.parse(protein, ref_ligand_path=ligand)
        infos, model = modeling_stage(net, data, report)
        if ref_available:
            modeling_parity(net, data, infos, model, state, distributions,
                            args.reference_src, report)
        tf32_probe(net, data, report)

    # stage 5: proxy checkpoint
    if args.proxy:
        proxy_convert(args.proxy, args.proxy_type, report)

    report.write(args.out)
    print(f"verify_checkpoint: {'PASS' if report.ok else 'FAIL'}")
    return 0 if report.ok else 1


def entrypoint() -> int:
    return main(build_parser().parse_args())


if __name__ == "__main__":
    raise SystemExit(entrypoint())
