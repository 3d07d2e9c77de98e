"""The modeling route: pockets modelled one after another through
`PharmacoNet.run`, each model written to a `.pm`, as the modeling CLI's
`--protein X --center ...` runs a pocket.

Set-up writes the mix's pockets from the seed (`pocketgen.py`) and draws
the network's weights on the device (`detector_reference.draw_weights`)
from the configuration's `weights_seed`: one checkpoint for every seed, as
a deployment serves one. Its score distributions and the offset of its
mask logits are placed on the run's pockets, which the reference scores:
each type's distribution so that about `hotspots_per_pocket` tokens a
pocket pass the type's threshold, and the offset so that `map_share` of
the voxels a map may cover pass the box threshold (the published
distributions come with the published weights, which the repo does not
hold). The checkpoint goes to the run's work
directory in the upstream layout, and the program loads it as an operator
does, `PharmacoNet(weight_path=...)`, built at the configuration's widths
and precision. Set-up then models every pocket once, which warms every
shape and chunk count the window meets.

A pass models every pocket from its file, closed loop, one at a time:
`run(pdb, center=...)`, then `PharmacophoreModel.save`. The route keeps
what the last pass produced: the tokens and their absolute and relative
scores and keep set (`run_trunk`'s outputs), the hotspots and their
density maps (`create_density_maps`'s return) and the `.pm` written.

`correct`: after the window, the plain reference (detector_reference.py)
models every pocket from its file and the same weights and holds the last
pass to it: every token's score and keep decision, every kept hotspot's
map voxel by voxel, and the `.pm`'s nodes against the reference's graph
rule applied to the program's maps. A keep decision or a voxel that lies
within the tolerance of its threshold may fall either way: such tokens
are counted apart, and such voxels are `flip_voxels`, held to a budget.
"""

from __future__ import annotations

import contextlib
import math
import pickle
import sys
import time
from pathlib import Path

import numpy as np

import detector_reference as ref
import device_trace
import model_flops
import pocketgen

# what the main thread is in during the card's idle gaps
device_trace.GAP_LABELS.update({
    "bench.parse": "parse (PDB, tokens, atom features)",
    "bench.trunk": "trunk (voxelizer, SwinV2-3D, FPN, heads, gating)",
    "bench.segment": "segment (mask decoder chunks, post-processing, density wire)",
    "bench.graph": "graph build",
    "bench.save": ".pm write",
})
CHECK_KEYS = ("abs_scores", "rel_scores", "keep")


def calibrate_distributions(scores: list[tuple[np.ndarray, np.ndarray]], per_pocket: float,
                            n: int = 1000) -> list[np.ndarray]:
    """Per interaction type a sorted distribution of `n` scores such that
    about `per_pocket` gated tokens a pocket reach their type's threshold.
    `scores`: per pocket (absolute scores, types) of the tokens in their
    type's cavity. A type's distribution maps its threshold onto the
    (1 - f) quantile of its own tokens' scores, f the share of all gated
    tokens to keep, and lies at midpoints between neighbouring scores, so
    that no token's score equals a value of it."""
    by_type = [np.sort(np.concatenate([a[t == c] for a, t in scores]))
               for c in range(len(ref.INTERACTIONS))]
    total = sum(len(a) for a in by_type)
    f = min(1.0, per_pocket * len(scores) / max(total, 1))
    u = (np.arange(n) + 0.5) / n
    out = []
    for c, a in enumerate(by_type):
        theta = ref.SCORE_THRESHOLD[c]
        if len(a) < 2:
            out.append(u.astype(np.float32))
            continue
        g = np.where(u <= theta, u * (1 - f) / theta, (1 - f) + (u - theta) * f / (1 - theta))
        k = np.clip(np.floor(g * (len(a) - 1)).astype(np.int64), 0, len(a) - 2)
        out.append(np.sort((0.5 * (a[k].astype(np.float64) + a[k + 1])).astype(np.float32)))
    return out


def calibrate_mask_bias(pockets: list, weights: dict, distributions: list, cfg: dict, device,
                        share: float) -> float:
    """The offset of the mask logits' bias at which about `share` of the
    voxels the maps may cover (each hotspot's box, in empty space and in
    the narrow cavity) pass the box threshold, over the first chunk of
    kept hotspots of every pocket, found by bisection. Without it the
    maps' fill swings tenfold from seed to seed, and the host's work on
    the maps with it."""
    import torch

    res, chunk = float(cfg["resolution"]), int(cfg["segmentation_chunk"])
    parts, room = [], 0
    with torch.no_grad(), ref.float32_scope():
        for pocket in pockets:
            pyramid, occupied, h = ref.score_tokens(pocket, weights, distributions, cfg, device)
            kept = torch.nonzero(h.keep).flatten()[:chunk]
            tokens = torch.as_tensor(pocket.tokens, device=device)[kept]
            logits = ref.mask_logits(pyramid, tokens, h.token_features[kept], weights, cfg)
            room += int((ref.box_mask(tokens, logits.shape[-1], res)
                         & (~occupied & (h.cavity_narrow > ref.FOCUS_THRESHOLD))[None]).sum())
            parts.append((logits, tokens, ~occupied, h.cavity_narrow))
            del pyramid
        lo, hi = -30.0, 30.0
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            passed = sum(int((ref.density_maps(logits + mid, tokens, empty, cavity, res)[0] > 0)
                             .sum()) for logits, tokens, empty, cavity in parts)
            if passed > share * max(room, 1):
                hi = mid
            else:
                lo = mid
    return 0.5 * (lo + hi)


class Route:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        self.work_dir = Path(ctx.work_dir)
        self.precision = getattr(ctx, "precision", None) or self.config["precision"]
        self.net = None
        self.pockets: list[dict] = []
        self.setup_split: dict[str, float] = {}
        self.rec = None
        self.last: list[dict] = []  # the last pass's outputs, by pocket
        self.readings: dict[str, float] = {}  # the check's raw readings

    @property
    def items_per_pass(self) -> int:
        return int(self.traffic["pockets"])

    def _span(self, name: str):
        return self.rec.span(name) if self.rec is not None else contextlib.nullcontext()

    def setup(self) -> None:
        import torch

        from pharmaconet_tpu_torch.module import PharmacoNet
        from pharmaconet_tpu_torch.network.convert import save_torch_checkpoint

        cfg, device = self.config, self.ctx.device
        torch.set_num_threads(int(cfg["host_threads"]))
        t0 = time.perf_counter()
        self.pockets = pocketgen.write_pockets(self.work_dir / "pockets", self.ctx.seed,
                                               self.traffic)
        self.setup_split["pockets_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.weights = ref.draw_weights(cfg, int(cfg["weights_seed"]), device, cfg["init"])
        self.perceived = [ref.perceive(p["path"], p["center"], int(cfg["grid_dim"]),
                                       float(cfg["resolution"])) for p in self.pockets]
        flat = [torch.linspace(0, 1, 8, device=device)] * len(ref.INTERACTIONS)
        scores = []
        for pocket in self.perceived:
            h = ref.score_tokens(pocket, self.weights, flat, cfg, device)[2]
            gated = (h.token_cavity > ref.FOCUS_THRESHOLD).cpu().numpy()
            scores.append((h.abs_scores.cpu().numpy()[gated], pocket.tokens[gated, 3]))
        dists = calibrate_distributions(scores, float(cfg["hotspots_per_pocket"]))
        self.distributions = [torch.as_tensor(d) for d in dists]
        self.weights["mask_head.conv_logits.bias"] += calibrate_mask_bias(
            self.perceived, self.weights, [d.to(device) for d in self.distributions], cfg,
            device, float(cfg["map_share"]))
        checkpoint = self.work_dir / "model.tar"
        # the benchmark's copy waits on the host, out of the window's memory
        self.weights = {k: v.cpu() for k, v in self.weights.items()}
        save_torch_checkpoint(checkpoint, {k: v.numpy() for k, v in self.weights.items()},
                              dict(zip(ref.INTERACTIONS, dists)))
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        self.setup_split["weights_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.net = PharmacoNet(
            weight_path=checkpoint, grid_dim=int(cfg["grid_dim"]),
            max_hotspots=int(cfg["max_hotspots"]),
            segmentation_chunk=int(cfg["segmentation_chunk"]),
            model_kwargs=dict(in_channels=int(cfg["in_channels"]),
                              embed_dim=int(cfg["embed_dim"]), depths=tuple(cfg["depths"]),
                              num_heads=tuple(cfg["num_heads"]), window=int(cfg["window"]),
                              token_feature_dim=int(cfg["token_feature_dim"]),
                              num_interactions=int(cfg["num_interactions"])),
            matmul_precision=self.precision, device=device, verbose=False)
        self._capture()
        self.setup_split["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.run_pass()  # warm-up: every pocket once, as the window runs them
        self.setup_split["warm_pass_s"] = time.perf_counter() - t0

    def _capture(self) -> None:
        """Keeps what each pocket's modeling produced, for the check: the
        parsed tokens, `run_trunk`'s scores and keep set (references to
        the tensors, no copy) and `create_density_maps`'s hotspots."""
        net = self.net
        parse, run_trunk, maps = net.parse, net.run_trunk, net.create_density_maps

        def parse_c(*a, **k):
            data = parse(*a, **k)
            self._cur["tokens"] = data.tokens[data.token_valid]
            return data

        def run_trunk_c(data):
            out = run_trunk(data)
            self._cur.update({key: out[key] for key in CHECK_KEYS})
            return out

        def maps_c(data):
            infos = maps(data)
            self._cur["infos"] = infos
            return infos

        net.parse, net.run_trunk, net.create_density_maps = parse_c, run_trunk_c, maps_c

    def run_pass(self) -> int:
        """Models every pocket once; returns how many came back as a model
        written to its `.pm`."""
        done, last = 0, []
        for i, p in enumerate(self.pockets):
            self._cur = {}
            model = self.net.run(p["path"], center=p["center"])
            path = self.work_dir / f"pocket_{i}.pm"
            with self._span("bench.save"):
                model.save(str(path))
            done += 1
            last.append(dict(self._cur, pm=path))
        self.last = last
        return done

    @contextlib.contextmanager
    def instrument(self, rec):
        """Spans around the program's stages, for the traced window:
        parse; the trunk up to its keep set on the host (the span waits
        for the card, which the program's copy of the keep set does next);
        the mask decoder and post-processing; the graph build and the
        `.pm` write."""
        import torch

        from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel

        net = self.net
        parse, run_trunk, segment = net.parse, net.run_trunk, net._segment_kept
        create = PharmacophoreModel.__dict__["create"]
        cuda = self.ctx.device.startswith("cuda")

        def parse_w(*a, **k):
            with rec.span("bench.parse"):
                return parse(*a, **k)

        def run_trunk_w(data):
            with rec.span("bench.trunk"):
                out = run_trunk(data)
                if cuda:
                    torch.cuda.synchronize()
                return out

        def segment_w(*a, **k):
            with rec.span("bench.segment"):
                return segment(*a, **k)

        def create_w(cls, *a, **k):
            with rec.span("bench.graph"):
                return create.__func__(cls, *a, **k)

        net.parse, net.run_trunk, net._segment_kept = parse_w, run_trunk_w, segment_w
        PharmacophoreModel.create = classmethod(create_w)
        self.rec = rec
        try:
            yield
        finally:
            self.rec = None
            net.parse, net.run_trunk = parse, run_trunk
            del net._segment_kept
            PharmacophoreModel.create = create

    def store_bytes(self) -> int:
        """Bytes of the pockets' PDB files."""
        return sum(Path(p["path"]).stat().st_size for p in self.pockets)

    def free(self) -> None:
        """The program's state goes; its outputs of the last pass stay, on
        the host."""
        for cur in self.last:
            for key in CHECK_KEYS:
                if key in cur:
                    cur[key] = cur[key].cpu()
        self.net = None

    def work(self) -> tuple[int, int]:
        """(model operations, bytes) of one pass: the operations as the
        check counted them (model_flops.py); no byte count."""
        return self.pass_ops, 0

    # ------------------------------------------------------------------
    # correct
    # ------------------------------------------------------------------
    def check(self, passes: list[int]):
        """(numbers compared, attempted, failed): each number is (name,
        value, limit), correct where value <= limit."""
        cfg, device = self.config, self.ctx.device
        sa, sr = float(cfg["score_atol"]), float(cfg["score_rtol"])
        da, dr = float(cfg["density_atol"]), float(cfg["density_rtol"])
        n = self.items_per_pass
        missing = sum(n - done for done in passes)
        weights = {k: v.to(device) for k, v in self.weights.items()}
        dists = [d.to(device) for d in self.distributions]
        tokens_bad = keep_bad = nodes_bad = flips = borderline = 0
        score_share = density_share = score_abs = density_abs = 0.0
        failed = ops = 0
        kept_counts, sizes = [], []
        for i, pocket in enumerate(self.perceived):
            want = ref.model_pocket(pocket, weights, dists, cfg, device,
                                    int(cfg["segmentation_chunk"]))
            ops += model_flops.pocket_ops(cfg, len(pocket.tokens), len(want.kept))
            kept_counts.append(len(want.kept))
            got = self.last[i] if i < len(self.last) else {}
            if "keep" not in got or "tokens" not in got:
                missing += 1
                continue
            toks = got["tokens"].astype(np.int64)
            if toks.shape != pocket.tokens.shape or (toks != pocket.tokens).any():
                tokens_bad += (abs(len(toks) - len(pocket.tokens)) if len(toks) != len(pocket.tokens)
                               else int((toks != pocket.tokens).any(1).sum()))
                failed += 1
                continue
            h, nt, types = want.heads, len(toks), toks[:, 3]
            a_got = got["abs_scores"][:nt].double().numpy()
            a_want = h.abs_scores.double().numpy()
            err = np.where(np.isfinite(a_got), np.abs(a_got - a_want), np.inf)
            share_here = float((err / (sa + sr * np.abs(a_want))).max(initial=0.0))
            score_abs = max(score_abs, float(err.max(initial=0.0)))
            # keep decisions and relative scores: a token whose decision can
            # move within the score tolerance is borderline
            near = np.abs(h.token_cavity.double().numpy() - ref.FOCUS_THRESHOLD) \
                <= sa + sr * ref.FOCUS_THRESHOLD
            for c, dist in enumerate(self.distributions):
                d, of = dist.double().numpy(), types == c
                tol = sa + sr * np.abs(a_want[of])
                near[of] |= (np.searchsorted(d, a_want[of] - tol, "left")
                             != np.searchsorted(d, a_want[of] + tol, "left"))
            keep_got = got["keep"][:nt].numpy()
            rel_got = got["rel_scores"][:nt].numpy()
            differ = (keep_got != h.keep.numpy()) | (rel_got != h.rel_scores.numpy())
            borderline += int((differ & near).sum())
            keep_here = int((differ & ~near).sum())
            # hotspots: the map of every token both sides kept, found by its key
            key = {(ref.INTERACTIONS[int(types[j])],
                    tuple(float(v) for v in pocket.token_positions[j])): j for j in range(nt)}
            infos = got.get("infos") or []
            by_token = {}
            for info in infos:
                j = key.get((info["nci_type"], tuple(info["hotspot_position"])))
                if j is None or not keep_got[j] or j in by_token \
                        or info["hotspot_score"] != float(rel_got[j]):
                    keep_here += 1
                    continue
                by_token[j] = info
            dshare_here = 0.0
            for j in want.kept:
                if not keep_got[j]:
                    continue
                r = want.maps[j].astype(np.float64)
                s = want.smoothed[j].astype(np.float64)
                g = (by_token[j]["point_map"].astype(np.float64) if j in by_token
                     else np.zeros_like(r))
                band = np.abs(s - ref.BOX_THRESHOLD) <= da + dr * ref.BOX_THRESHOLD
                flip = band & ((g > 0) != (r > 0))
                flips += int(flip.sum())
                e = np.where(np.isfinite(g), np.abs(g - r), np.inf)
                e[flip] = 0.0
                density_abs = max(density_abs, float(e.max()))
                dshare_here = max(dshare_here, float((e / (da + dr * np.abs(r))).max()))
            # the .pm's nodes: the reference's graph rule on the program's maps
            nodes_here = self._nodes_mismatch(got, infos, pocket.center)
            sizes.append((nt, len(infos), sum(int((i["point_map"] > 0).sum()) for i in infos),
                          self._node_count(got)))
            keep_bad += keep_here
            nodes_bad += nodes_here
            score_share = max(score_share, share_here)
            density_share = max(density_share, dshare_here)
            failed += bool(keep_here or nodes_here or share_here > 1 or dshare_here > 1)
        model_flops.record_pass(len(passes), len(passes) * n, ops)
        self.pass_ops = ops
        self.readings = dict(score_abs_max=score_abs, density_abs_max=density_abs,
                             keep_borderline=borderline, kept=kept_counts,
                             tokens_hotspots_voxels=sizes)
        print(f"note hotspots kept per pocket (reference) {kept_counts}; keep_borderline "
              f"{borderline} (tokens whose keep decision or relative score may move within "
              f"the score tolerance; not compared); score_abs_max {score_abs}; "
              f"density_abs_max {density_abs}; per pocket (tokens, hotspots with a map, "
              f"voxels, nodes) {sizes}", file=sys.stderr)
        checks = [
            ("pockets_missing", missing, 0),
            ("tokens_mismatch", tokens_bad, 0),
            ("token_score_share", score_share, 1.0),
            ("keep_mismatch", keep_bad, 0),
            ("density_tol_share", density_share, 1.0),
            ("flip_voxels", flips, int(cfg["flip_budget"])),
            ("nodes_mismatch", nodes_bad, 0),
        ]
        return checks, len(passes) * n, failed + missing

    @staticmethod
    def _node_count(got: dict) -> int:
        try:
            with open(got["pm"], "rb") as f:
                return len(pickle.load(f)["nodes"])
        except (OSError, KeyError, pickle.UnpicklingError, EOFError):
            return -1

    def _nodes_mismatch(self, got: dict, infos: list[dict], center) -> int:
        """Nodes of the `.pm` written that differ from the reference's graph
        rule applied to the program's own maps (count, interaction type,
        hotspot position and score exactly; centre within node_atol A,
        radius to rounding)."""
        import torch

        try:
            with open(got["pm"], "rb") as f:
                nodes = pickle.load(f)["nodes"]
        except (OSError, KeyError, pickle.UnpicklingError, EOFError):
            return max(1, len(infos))
        want = []
        if infos:
            maps = torch.as_tensor(np.stack([info["point_map"] for info in infos]),
                                   device=self.ctx.device)
            for info, found in zip(infos, ref.graph_nodes(maps, center,
                                                          float(self.config["resolution"]))):
                want += [(info, c, r) for c, r in found]
        atol = float(self.config["node_atol"])
        bad = abs(len(nodes) - len(want))
        for node, (info, c, r) in zip(nodes, want):
            same = (node["interaction_type"] == info["nci_type"]
                    and tuple(node["hotspot_position"]) == tuple(info["hotspot_position"])
                    and node["score"] == info["hotspot_score"]
                    and all(abs(a - b) <= atol for a, b in zip(node["center"], c))
                    and math.isclose(node["radius"], r, rel_tol=1e-9))
            bad += not same
        return bad
