"""The detector's plain reference against the port, stage by stage and
whole, on seeded random weights at a small size on the CPU (grid 16,
embed 24, depths (2, 2, 2, 2), heads (1, 2, 4, 8), window 4, two
pockets), at the cell's tolerances; its model operations against torch's
own count; and it loads nothing of the program or of JAX."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import detector_reference as ref
import model_flops
import pocketgen
from conftest import BENCH_DIR, ROOT
from detector_cells import small_config, small_traffic
from routes.modeling import calibrate_distributions

from pharmaconet_tpu_torch.module import PharmacoNet
from pharmaconet_tpu_torch.network.convert import save_torch_checkpoint
from pharmaconet_tpu_torch.network.model import build_model
from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel

SEED = 2**31 + 19


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small configuration's weights, distributions, pockets and the
    program built from the checkpoint they make."""
    tmp = tmp_path_factory.mktemp("detector")
    cfg = small_config()
    w = ref.draw_weights(cfg, SEED, "cpu", cfg["init"])
    pockets = pocketgen.write_pockets(tmp / "pockets", SEED, small_traffic())
    perceived = [ref.perceive(p["path"], p["center"], cfg["grid_dim"], cfg["resolution"])
                 for p in pockets]
    flat = [torch.linspace(0, 1, 8)] * len(ref.INTERACTIONS)
    scores = []
    for pocket in perceived:
        h = ref.score_tokens(pocket, w, flat, cfg, "cpu")[2]
        gated = (h.token_cavity > 0.5).numpy()
        scores.append((h.abs_scores.numpy()[gated], pocket.tokens[gated, 3]))
    dists = calibrate_distributions(scores, cfg["hotspots_per_pocket"])
    save_torch_checkpoint(tmp / "model.tar", {k: v.numpy() for k, v in w.items()},
                          dict(zip(ref.INTERACTIONS, dists)))
    net = PharmacoNet(
        weight_path=tmp / "model.tar", grid_dim=cfg["grid_dim"],
        segmentation_chunk=cfg["segmentation_chunk"],
        model_kwargs=dict(embed_dim=cfg["embed_dim"], depths=tuple(cfg["depths"]),
                          num_heads=tuple(cfg["num_heads"]), window=cfg["window"],
                          token_feature_dim=cfg["token_feature_dim"]),
        device="cpu", verbose=False)
    return dict(cfg=cfg, w=w, dists=[torch.as_tensor(d) for d in dists], pockets=pockets,
                perceived=perceived, net=net)


def _share(got, want, atol, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max(initial=0.0))


def test_weight_names_and_shapes_are_the_checkpoint_s():
    full = json.loads((BENCH_DIR / "configs" / "pmnet-detector.json").read_text())
    for cfg in (small_config(), full):
        kw = dict(in_channels=cfg["in_channels"], embed_dim=cfg["embed_dim"],
                  depths=tuple(cfg["depths"]), num_heads=tuple(cfg["num_heads"]),
                  window=cfg["window"], token_feature_dim=cfg["token_feature_dim"],
                  num_interactions=cfg["num_interactions"])
        with torch.device("meta"):
            model = build_model(image_size=cfg["grid_dim"], **kw)
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {name: shape for name, shape, _ in ref.param_shapes(cfg)}
        assert got == want


def test_perception_and_voxels_match_the_program(small):
    cfg, net = small["cfg"], small["net"]
    for p, pocket in zip(small["pockets"], small["perceived"]):
        data = net.parse(p["path"], center=p["center"])
        nt, na = int(data.token_valid.sum()), int(data.atom_valid.sum())
        assert nt > 5
        np.testing.assert_array_equal(data.tokens[:nt].astype(np.int64), pocket.tokens)
        np.testing.assert_array_equal(data.token_positions, pocket.token_positions)
        np.testing.assert_array_equal(data.atom_positions[:na], pocket.atom_positions)
        np.testing.assert_array_equal(data.atom_features[:na], pocket.atom_features)
        image, occupied = net.voxelize(data)
        want_image, want_occupied = ref.voxelize(pocket, cfg["grid_dim"], cfg["resolution"], "cpu")
        assert torch.equal(occupied, want_occupied)
        assert _share(image.permute(3, 0, 1, 2), want_image, 1e-5, 1e-5) <= 1


def test_trunk_heads_and_decoder_match_the_program(small):
    cfg, net, w = small["cfg"], small["net"], small["w"]
    sa, sr, da, dr = (cfg[k] for k in ("score_atol", "score_rtol", "density_atol", "density_rtol"))
    for p, pocket in zip(small["pockets"], small["perceived"]):
        data = net.parse(p["path"], center=p["center"])
        nt = len(pocket.tokens)
        out = net.run_trunk(data)
        pyramid, occupied, h = ref.score_tokens(pocket, w, small["dists"], cfg, "cpu")
        for got, want in zip(out["pyramid"], pyramid):
            assert _share(got[0].permute(3, 0, 1, 2), want[0], 1e-5, 1e-5) <= 1
        assert _share(out["abs_scores"][:nt], h.abs_scores, sa, sr) <= 1
        assert torch.equal(out["keep"][:nt], h.keep)
        assert torch.equal(out["rel_scores"][:nt], h.rel_scores)
        kept = torch.nonzero(h.keep).flatten()[:cfg["segmentation_chunk"]]
        assert len(kept) > 0
        tokens = torch.as_tensor(pocket.tokens)
        logits = net.segment_logits(out, tokens[kept].int(), out["token_features"][kept])
        with ref.float32_scope():
            want_logits = ref.mask_logits(pyramid, tokens[kept], h.token_features[kept], w, cfg)
        assert _share(logits, want_logits, 1e-5, 1e-5) <= 1
        density, _ = net.postprocess(out, tokens[kept].int(), logits, np.ones(len(kept), bool))
        want_density, _ = ref.density_maps(want_logits, tokens[kept], ~occupied,
                                           h.cavity_narrow, cfg["resolution"])
        assert _share(density, want_density, da, dr) <= 1


def test_the_whole_path_matches_the_program(small):
    """create_density_maps and PharmacophoreModel.create against the
    reference's maps and its graph rule."""
    cfg, net = small["cfg"], small["net"]
    nodes_seen = 0
    for p, pocket in zip(small["pockets"], small["perceived"]):
        data = net.parse(p["path"], center=p["center"])
        infos = net.create_density_maps(data)
        want = ref.model_pocket(pocket, small["w"], small["dists"], cfg, "cpu",
                                cfg["segmentation_chunk"])
        nonempty = [j for j in want.kept if (want.maps[j] >= 1e-6).any()]
        assert len(infos) == len(nonempty) > 0
        for info, j in zip(infos, nonempty):
            assert info["nci_type"] == ref.INTERACTIONS[int(pocket.tokens[j, 3])]
            assert info["hotspot_position"] == tuple(float(v) for v in pocket.token_positions[j])
            assert _share(info["point_map"], want.maps[j], cfg["density_atol"],
                          cfg["density_rtol"]) <= 1
        model = PharmacophoreModel.create(data.pdbblock, data.center, infos,
                                          size=cfg["grid_dim"])
        found = ref.graph_nodes(torch.as_tensor(np.stack([i["point_map"] for i in infos])),
                                pocket.center, cfg["resolution"])
        flat = [(info, c, r) for info, nodes in zip(infos, found) for c, r in nodes]
        assert len(model.nodes) == len(flat)
        for node, (info, c, r) in zip(model.nodes, flat):
            assert node.interaction_type == info["nci_type"]
            assert np.allclose(node.center, c, atol=cfg["node_atol"], rtol=0)
            assert node.radius == pytest.approx(r, rel=1e-9)
        nodes_seen += len(flat)
    assert nodes_seen > 0


def test_model_operations_match_torch_s_count(small):
    """model_flops against FlopCounterMode over the reference's network
    (trunk, heads, mask head) at the small size: every product and
    convolution counted, nothing else."""
    cfg, w, pocket = small["cfg"], small["w"], small["perceived"][0]
    image, _ = ref.voxelize(pocket, cfg["grid_dim"], cfg["resolution"], "cpu")
    tokens = torch.as_tensor(pocket.tokens)
    k = 3
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        pyramid = ref.trunk(image, w, cfg)
        h = ref.heads(pyramid[-1], tokens, w, small["dists"])
        ref.mask_logits(pyramid, tokens[:k], h.token_features[:k], w, cfg)
    assert counter.get_total_flops() == model_flops.pocket_ops(cfg, len(tokens), k)


def test_full_size_operations_by_stage():
    """At the published widths: the embedding FPN about 170 GFLOP, the Swin
    backbone about 45, the heads about 260, a hotspot's mask head about 175."""
    cfg = json.loads((BENCH_DIR / "configs" / "pmnet-detector.json").read_text())
    g = 1e9
    fpn = model_flops.fpn_ops((33, 96, 192, 384, 768), (64, 32, 16, 8, 4), 96, (1, 2, 2, 2, 2))
    assert 150 * g < fpn < 190 * g
    assert 40 * g < model_flops.trunk_ops(cfg) - fpn < 55 * g  # the Swin backbone
    assert 240 * g < model_flops.heads_ops(cfg, 800) < 280 * g  # the cavity head's share
    assert 150 * g < model_flops.hotspot_ops(cfg) < 200 * g


def test_the_reference_loads_nothing_of_the_program_or_jax(tmp_path):
    code = (
        "import sys, json; "
        "[sys.modules.__setitem__(m, None) for m in "
        "('jax', 'jaxlib', 'flax', 'pharmaconet_tpu', 'pharmaconet_tpu_torch')]; "
        f"sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT / 'benchmark' / 'tests')!r}]; "
        "import torch, detector_reference as ref, pocketgen, model_flops; "
        "from detector_cells import small_config, small_traffic; "
        "cfg = small_config(); "
        "w = ref.draw_weights(cfg, 3, 'cpu', cfg['init']); "
        f"p = pocketgen.write_pockets({str(tmp_path)!r}, 3, dict(small_traffic(), pockets=1))[0]; "
        "pk = ref.perceive(p['path'], p['center'], cfg['grid_dim'], cfg['resolution']); "
        "d = [torch.linspace(0, 1, 100)] * 10; "
        "m = ref.model_pocket(pk, w, d, cfg, 'cpu', 4); "
        "model_flops.pocket_ops(cfg, len(pk.tokens), len(m.kept)); "
        "print(json.dumps(sorted({x.split('.')[0] for x in sys.modules if sys.modules[x]})))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not {n for n in names if n.startswith(("pharmaconet", "jax", "flax"))}
