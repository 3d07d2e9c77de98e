"""The data-parallel trainer killed and resumed, and a proxy's cache
database built over many pockets.

    python -m pharmaconet_tpu_torch.probes.demo_train_scale [--n 64] \\
        [--work_dir DIR] [--report PATH] [--keep] [--device cuda]

Phase A: the affinity-head `training.Trainer` on `mesh=[device, device]`
(its `fit` runs `dp_step`) over --pockets synthetic pockets
(`synthetic.write_synthetic_pocket(seed=i)`) x --ligands fragment SMILES,
at --arch full (the published trunk with the synthesized checkpoint
`synthesize_torch_state_dict(23, 0.8)`, head hidden 128 with 4
convolutions) or micro (a small trunk and head, for the CPU). Three worker
processes (this module with --worker): one makes a hard os._exit(77)
right after its checkpoint at step --kill_step; one resumes from that
`resume.ckpt` and must take exactly --steps - --kill_step steps; one runs
uninterrupted with the same seeds (centre noise 3 A, as phase 11's). The
resumed run's final parameters must equal the uninterrupted run's within
1e-6 (chip_smoke's STEP_PARAM_TOL).

Phase B: `parallel.proxy.ShardedCacheBuilder` for an SBDDReward proxy
(`_init_random(8)`) on a mesh that names --device once, over --n synthetic
pockets (after one warm-up pocket; the training pockets are the first of
them), and the serial `get_cache_database` on min(--n, 8) of them:
pockets/hour of each, and every shared key's cache equal. K6 launches once per pocket and per trainer item on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

from . import scale
from .scale import DemoError, log

CKPT_SEED, CKPT_SCALE = 23, 0.8  # chip_smoke phase 7's synthesized checkpoint
TRAIN_SEED = 5  # chip_smoke phase 11's ligand and noise seed
PROXY_SEED = 8
CENTER_NOISE = 3.0  # chip_smoke phase 11's
SERIAL_POCKETS = 8  # pockets of the serial cache build (at most --n)
POCKETS_PER_WRITER = 8  # pockets that pay for one more writer process (~5 s to start)
PARAM_TOL = 1e-6  # chip_smoke phase 11's STEP_PARAM_TOL
MICRO = dict(embed_dim=8, depths=(1, 1), num_heads=(1, 2), window=2, token_feature_dim=16)
MICRO_NET = dict(max_hotspots=8, segmentation_chunk=4, grid_dim=16, model_kwargs=MICRO,
                 score_threshold=0.0)
MICRO_POCKET = dict(cavity_radius=3.0, num_atoms=800, outer_radius=24.0)  # tokens in a 16^3 grid


def build_parser():
    parser = scale.common_parser(__doc__.splitlines()[0], 64)
    parser.add_argument("--arch", default="full", choices=("full", "micro"))
    parser.add_argument("--pockets", type=int, default=32, help="training pockets")
    parser.add_argument("--ligands", type=int, default=8, help="SMILES per training pocket")
    parser.add_argument("--steps", type=int, default=40, help="max_iterations")
    parser.add_argument("--kill_step", type=int, default=None,
                        help="the step whose checkpoint the killed worker exits after "
                             "(default steps // 2)")
    parser.add_argument("--batch_size", type=int, default=8, help="items per DP step")
    parser.add_argument("--worker", default=None, choices=("killed", "resumed", "uninterrupted"),
                        help=argparse.SUPPRESS)
    return parser


def _write_pocket(job) -> tuple[float, float, float]:
    from ..synthetic import write_synthetic_pocket

    path, seed, kw = job
    return write_synthetic_pocket(path, seed=seed, **kw)["center"]


def write_pockets(root: Path, count: int, args) -> dict[str, tuple[Path, tuple]]:
    """{f"pocket{seed}": (pdb, centre)} for seeds 0..count-1, written by
    one process per POCKETS_PER_WRITER pockets up to one per core (here
    when that is one)."""
    root.mkdir(parents=True, exist_ok=True)
    kw = MICRO_POCKET if args.arch == "micro" else {}
    jobs = [(root / f"pocket{s}.pdb", s, kw) for s in range(count)]
    writers = min(os.cpu_count() or 1, count // POCKETS_PER_WRITER)
    if writers > 1:
        with ProcessPoolExecutor(writers, get_context("spawn")) as pool:
            centers = list(pool.map(_write_pocket, jobs))
    else:
        centers = [_write_pocket(job) for job in jobs]
    return {f"pocket{s}": (job[0], c) for s, (job, c) in enumerate(zip(jobs, centers))}


def load_pmnet(args, work: Path):
    from ..api import get_pmnet_dev

    if args.arch == "micro":
        net = get_pmnet_dev(device=args.device, weight_path=work / "ckpt.tar", **MICRO_NET)
        net.focus_threshold = 0.0
        return net
    return get_pmnet_dev(device=args.device, weight_path=work / "ckpt.tar")


def write_checkpoint(args, work: Path) -> None:
    from ..network.convert import (
        random_distributions,
        random_state_dict,
        save_torch_checkpoint,
        synthesize_torch_state_dict,
    )
    from ..network.model import build_model

    if args.arch == "micro":
        config = build_model(image_size=MICRO_NET["grid_dim"], **MICRO).config
        state = {k: v.numpy() for k, v in random_state_dict(config, 3).items()}
    else:
        state = synthesize_torch_state_dict(CKPT_SEED, CKPT_SCALE)
    save_torch_checkpoint(work / "ckpt.tar", state, random_distributions())


def write_train_data(args, work: Path, pockets: dict) -> None:
    """The trainer's data files over `pockets` (as phase 11's): --ligands
    fragment SMILES each with seeded affinities in [-12, 0]."""
    from ..chem.fragments import enumerate_fragment_smiles

    root = work / "train"
    root.mkdir()
    rng = np.random.default_rng(TRAIN_SEED)
    frags = [s for _, s in enumerate_fragment_smiles(args.pockets * args.ligands,
                                                      seed=TRAIN_SEED)]
    ligands = {code: [(f"l{j}", frags[i * args.ligands + j], float(rng.uniform(-12, 0)))
                      for j in range(args.ligands)] for i, code in enumerate(pockets)}
    (root / "info.csv").write_text("\n".join(",".join([code, *map(str, c)])
                                             for code, (_, c) in pockets.items()))
    (root / "codes.txt").write_text("\n".join(pockets))
    with open(root / "ligands.pkl", "wb") as f:
        pickle.dump(ligands, f)


def train_config(args, work: Path, mode: str):
    from ..training import Config

    root = work / "train"
    config = Config()
    config.log_dir = str(work / f"log_{mode}")
    config.data.protein_info_path = str(root / "info.csv")
    config.data.train_protein_code_path = str(root / "codes.txt")
    config.data.protein_dir = str(work / "pockets")
    config.data.ligand_path = str(root / "ligands.pkl")
    config.model.hidden_dim, config.model.ligand_num_convs = (
        (16, 2) if args.arch == "micro" else (128, 4))
    t = config.train
    t.batch_size, t.split_ratio, t.center_noise = args.batch_size, 1.0, CENTER_NOISE
    t.max_iterations, t.save_every = args.steps, args.kill_step
    t.val_every = t.print_every = 10**9
    t.log_every = 1
    return config


def worker(args, work: Path) -> int:
    """One training run (--worker killed | resumed | uninterrupted); its
    last line a JSON record; its final parameters in params_<mode>.npz."""
    from ..ops import launch_log, voxelize_cuda
    from ..training import Trainer

    mode = args.worker
    net = load_pmnet(args, work)
    np.random.seed(TRAIN_SEED)  # the centre-noise draws
    trainer = Trainer(train_config(args, work, mode), pmnet=net,
                      mesh=[args.device, args.device])
    steps: list[float] = []
    dp_step = trainer.dp_step

    def counted(items):
        t0 = time.perf_counter()
        loss = dp_step(items)
        steps.append(time.perf_counter() - t0)
        return loss

    trainer.dp_step = counted
    t0 = time.perf_counter()

    def record() -> dict:
        timings = trainer.train_dataset.timings
        return dict(mode=mode, wall_s=time.perf_counter() - t0, steps=len(steps),
                    step_s_median=statistics.median(steps) if steps else None,
                    items=len(timings),
                    item_s_median={k: statistics.median(t[k] for t in timings)
                                   for k in timings[0]} if timings else {},
                    optimizer_count=int(trainer.opt_state["count"]),
                    k6_launches=voxelize_cuda.LAUNCHES["voxelize_pallas"])

    if mode == "killed":
        save_state = trainer.save_state

        def save_then_exit(filename, it, epoch, **kw):
            save_state(filename, it, epoch, **kw)
            if filename == "resume.ckpt" and it == args.kill_step:
                trainer.wait_for_checkpoints()
                print(json.dumps(record()), flush=True)
                launch_log.append()
                os._exit(77)  # a hard crash right after the checkpoint

        trainer.save_state = save_then_exit
        trainer.fit()
        raise DemoError("the killed worker ran to its end")
    trainer.fit(resume_from=work / "log_killed" / "save" / "resume.ckpt"
                if mode == "resumed" else None)
    np.savez(work / f"params_{mode}.npz",
             **{k: v.detach().cpu().numpy() for k, v in trainer.params.items()})
    out = record()
    trainer.close()
    print(json.dumps(out), flush=True)
    return 0


def run_worker(args, work: Path, mode: str) -> tuple[dict, dict]:
    cmd = [sys.executable, "-m", "pharmaconet_tpu_torch.probes.demo_train_scale",
           "--worker", mode, "--work_dir", work, "--device", args.device, "--arch", args.arch,
           "--pockets", args.pockets, "--ligands", args.ligands, "--steps", args.steps,
           "--kill_step", args.kill_step, "--batch_size", args.batch_size]
    stage = scale.run_stage(f"trainer {mode}", [str(c) for c in cmd], work,
                            expect_rc=77 if mode == "killed" else 0)
    result = json.loads(stage["lines"][-1][1])
    return result, scale.stage_record(stage)


def to_numpy(value):
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, (tuple, list)):
        return [to_numpy(v) for v in value]
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    return np.asarray(value)


def same_cache(a, b) -> bool:
    a, b = to_numpy(a), to_numpy(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_cache(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_cache(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and bool(np.array_equal(a, b))


def phase_a(args, work: Path, report: dict, pockets: dict) -> None:
    write_train_data(args, work, {k: pockets[k] for k in list(pockets)[:args.pockets]})
    runs, stages = {}, {}
    for mode in ("killed", "resumed", "uninterrupted"):
        runs[mode], stages[mode] = run_worker(args, work, mode)
    killed, resumed, full = runs["killed"], runs["resumed"], runs["uninterrupted"]
    if killed["steps"] != args.kill_step:
        raise DemoError(f"the killed worker took {killed['steps']} steps, not {args.kill_step}")
    if resumed["steps"] != args.steps - args.kill_step or resumed["optimizer_count"] != args.steps:
        raise DemoError(f"the resumed worker took {resumed['steps']} steps (optimizer count "
                        f"{resumed['optimizer_count']}), not {args.steps - args.kill_step}")
    if full["steps"] != args.steps:
        raise DemoError(f"the uninterrupted worker took {full['steps']} steps, not {args.steps}")
    got, want = np.load(work / "params_resumed.npz"), np.load(work / "params_uninterrupted.npz")
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in want.files)
    # the killed worker's prefetch thread may be inside an item when it
    # exits: its K6 count is reported, and held for the two runs that ended
    items = resumed["items"] + full["items"]
    k6 = resumed["k6_launches"] + full["k6_launches"]
    report["train"] = dict(runs=runs, stages=stages, resumed_vs_uninterrupted_max_diff=diff,
                           items=items, k6_launches=k6 + killed["k6_launches"],
                           s_per_step=full["wall_s"] / args.steps)
    log(f"trainer: killed after step {args.kill_step}, resumed {resumed['steps']} steps; final "
        f"parameters {diff:.3g} from the uninterrupted run's; {full['wall_s'] / args.steps:.3f} s "
        f"per step uninterrupted")
    if diff > PARAM_TOL:
        raise DemoError(f"resumed parameters {diff:.3g} from the uninterrupted run's "
                        f"(tolerance {PARAM_TOL})")
    if str(args.device).startswith("cuda") and k6 != items:
        raise DemoError(f"K6 launched {k6} times for {items} trainer items")


def phase_b(args, work: Path, report: dict, pockets: dict) -> None:
    from ..ops import voxelize_cuda
    from ..parallel.proxy import ShardedCacheBuilder
    from ..proxy.proxies import SBDDReward_Proxy

    info = {k: pockets[k] for k in list(pockets)[:args.n]}
    warm = {"warm": pockets[f"pocket{args.n}"]}
    widths = dict(token_dim=16, feature_dim=8, num_scales=3) if args.arch == "micro" else None
    proxy = SBDDReward_Proxy(device=args.device, model_kwargs=widths)
    proxy._init_random(PROXY_SEED)
    proxy.pmnet = load_pmnet(args, work)
    builder = ShardedCacheBuilder(proxy, mesh=[args.device])
    builder.get_cache_database(warm, verbose=False)

    def timed(fn):
        voxelize_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        if str(args.device).startswith("cuda"):
            import torch

            torch.cuda.synchronize()
        return out, time.perf_counter() - t0, voxelize_cuda.LAUNCHES["voxelize_pallas"]

    sharded, t_sharded, k6_sharded = timed(
        lambda: builder.get_cache_database(dict(info), verbose=False))
    sample = dict(list(info.items())[:SERIAL_POCKETS])
    serial, t_serial, k6_serial = timed(lambda: proxy.get_cache_database(sample, verbose=False))
    if sorted(sharded) != sorted(info) or sorted(serial) != sorted(sample):
        raise DemoError(f"cache keys: sharded {len(sharded)} of {len(info)}, serial "
                        f"{len(serial)} of {len(sample)}")
    differ = [k for k in serial if not same_cache(sharded[k], serial[k])]
    report["cache_build"] = dict(
        pockets=len(info), sharded_s=t_sharded, sharded_pockets_per_hour=len(info) / t_sharded
        * 3600, serial_pockets=len(sample), serial_s=t_serial,
        serial_pockets_per_hour=len(sample) / t_serial * 3600, shared_keys_equal=not differ,
        k6_launches=dict(sharded=k6_sharded, serial=k6_serial), mesh=[str(args.device)])
    log(f"cache build: sharded {len(info)} pockets in {t_sharded:.2f} s "
        f"({report['cache_build']['sharded_pockets_per_hour']:.0f}/h), serial {len(sample)} in "
        f"{t_serial:.2f} s ({report['cache_build']['serial_pockets_per_hour']:.0f}/h)")
    if differ:
        raise DemoError(f"sharded caches differ from the serial ones: {differ}")
    if str(args.device).startswith("cuda") and (k6_sharded, k6_serial) != (len(info),
                                                                              len(sample)):
        raise DemoError(f"K6 launched {k6_sharded} and {k6_serial} times for {len(info)} and "
                        f"{len(sample)} pockets")


def body(args, work: Path, report: dict) -> None:
    report.update(arch=args.arch, pockets=args.pockets, ligands=args.ligands, steps=args.steps,
                  kill_step=args.kill_step, batch_size=args.batch_size,
                  center_noise=CENTER_NOISE, mesh=[str(args.device)] * 2)
    t0 = time.perf_counter()
    pockets = write_pockets(work / "pockets", max(args.pockets, args.n + 1), args)
    report["pockets_s"] = time.perf_counter() - t0
    write_checkpoint(args, work)
    phase_a(args, work, report, pockets)
    phase_b(args, work, report, pockets)
    report["launches"] = {"voxelize_pallas": report["train"]["k6_launches"] + sum(
        report["cache_build"]["k6_launches"].values())}


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.kill_step is None:
        args.kill_step = args.steps // 2
    if not 0 < args.kill_step < args.steps:
        raise ValueError(f"--kill_step {args.kill_step} must lie within (0, --steps)")
    if args.worker is not None:
        return worker(args, Path(args.work_dir))
    return scale.run_demo("demo_train_scale", args, body)


if __name__ == "__main__":
    sys.exit(main())
