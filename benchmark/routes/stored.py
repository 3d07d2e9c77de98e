"""The stored v3 route: a library prepacked into a tile store once, then
screened pass after pass through the screening CLI's own loop.

Set-up makes the cell's pocket model (`.pm`) and its distinct ligands
(`.npz`, real chemistry: `ligand_traffic.fragment_ligands`) from the seed
in the run's work directory, and runs `prepack --library lib.npz -p
model.pm --tiles_out tiles` in a process of its own with its defaults (v3
store, buckets layout, sparse wire, leaves baked on the device). The
screened library is the configuration's `library_ligands`: a store whose
batch i is the prepacked batch i mod (distinct batches), linked, not
copied, with names of its own. Set-up then builds the screener as the
screening CLI does for one card and screens the whole library once, as
the window does, which warms every shape. A pass is `cli.screening.screen_tiles` over the
whole library: the prefetch thread's loads, batch i+1 dispatched before
batch i's host tail, the partial CSV.

`correct`: after the window, a sample of the library's positions drawn
from the seed is scored by the plain reference (screen_reference.py) from
the generated model and ligand arrays, and every pass's score at each is
held to the configuration's tolerance. Every score the program returned
is compared, NaN and infinity included; a name missing from a pass's
results, or repeated in it, is counted apart.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import roofline
import screen_reference
from ligand_traffic import fragment_ligands, model_state, seed_sequence

# the screening CLI's weight flags, by pharmacophore type
WEIGHT_FLAGS = {
    "Hydrophobic": "--hydrophobic", "Aromatic": "--aromatic",
    "HBond_acceptor": "--hba", "HBond_donor": "--hbd", "Halogen": "--halogen",
    "Anion": "--anion", "Cation": "--cation",
}


class Route:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        cfg = self.config
        self.work_dir = Path(ctx.work_dir)
        self.tiles = str(self.work_dir / "tiles")  # the distinct ligands, prepacked
        self.store = str(self.work_dir / "library")  # the screened library
        self.out = str(self.work_dir / "scores.csv")
        self.screener = None
        self.setup_split: dict[str, float] = {}  # seconds of set-up's slow steps
        self.distinct = int(cfg["distinct_ligands"])
        self.n = int(cfg["library_ligands"])
        if self.distinct % cfg["batch_size"] or self.n % self.distinct:
            raise ValueError("distinct_ligands has to be whole batches, and "
                             "library_ligands whole copies of them")
        self.state = model_state(cfg["num_clusters"], cfg["model_seed"])
        self.names = [f"lig{i:07d}" for i in range(self.n)]
        self.sampled = self.sample()

    @functools.cached_property
    def library(self):
        """The distinct ligands, from the seed."""
        return fragment_ligands(self.distinct, self.traffic["conformers"], self.ctx.seed)

    @property
    def items_per_pass(self) -> int:
        return self.n

    def setup(self) -> None:
        import torch

        from pharmaconet_tpu_torch.pharmacophore.model import PharmacophoreModel
        from pharmaconet_tpu_torch.scoring.batch_screen import BatchScreener, PackedLigand
        from pharmaconet_tpu_torch.scoring.library import save_library

        cfg = self.config
        torch.set_num_threads(int(cfg["host_threads"]))
        t0 = time.perf_counter()
        library = self.library
        self.setup_split["embed_s"] = time.perf_counter() - t0
        model = PharmacophoreModel()
        model.__setstate__(self.state)
        pm_path = str(self.work_dir / "model.pm")
        model.save(pm_path)
        lib_path = str(self.work_dir / "library.npz")
        save_library(lib_path, [PackedLigand(**library.ligand(i))
                                for i in range(len(library))],
                     self.names[:self.distinct])
        # prepack in a process of its own, as the CLI is run: the screening
        # process starts from what a screen of a prepacked store finds
        t0 = time.perf_counter()
        argv = [sys.executable, "-m", "pharmaconet_tpu_torch.cli.prepack",
                "--library", lib_path, "-p", pm_path, "--tiles_out", self.tiles,
                "--batch_size", str(cfg["batch_size"]), "--device", self.ctx.device]
        for t, flag in WEIGHT_FLAGS.items():
            argv += [flag, str(cfg["weights"][t])]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(self.ctx.root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        done = subprocess.run(argv, cwd=str(self.ctx.root), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        print(done.stdout[-4000:], file=sys.stderr)
        if done.returncode != 0:
            raise RuntimeError(f"prepack failed with exit code {done.returncode}")
        self.setup_split["prepack_s"] = time.perf_counter() - t0
        self.link_library()
        # the screening CLI's screener on one card (cli/screening.py main),
        # with its --pack_threads
        self.screener = BatchScreener(
            PharmacophoreModel.load(pm_path), dict(cfg["weights"]),
            pack_threads=int(cfg["host_threads"]), device=self.ctx.device)
        # the store's pages written out, so that no writeback runs under
        # the window: a library is prepacked long before it is screened
        for p in Path(self.tiles).rglob("*"):
            if p.is_file():
                fd = os.open(p, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
        # warm-up: one whole pass, as the window runs them (every shape, and
        # whatever the loop grows into over a pass)
        t0 = time.perf_counter()
        self.screen(self.store)
        self.setup_split["warm_pass_s"] = time.perf_counter() - t0

    def link_library(self) -> None:
        """The library's store: batch i is a link to the prepacked batch
        i mod (distinct batches); names and counts of its own."""
        tiles, store = Path(self.tiles), Path(self.store)
        meta = json.loads((tiles / "meta.json").read_text())
        if meta["n_ligands"] != self.distinct:
            raise RuntimeError(f"prepack stored {meta['n_ligands']} of {self.distinct} ligands")
        (store / "batches").mkdir(parents=True)
        n_batches = self.n // meta["batch_size"]
        for b in range(n_batches):
            (store / "batches" / f"{b:05d}").symlink_to(
                tiles / "batches" / f"{b % meta['n_batches']:05d}", target_is_directory=True)
        np.save(store / "names.npy", np.asarray(self.names))
        meta.update(n_ligands=self.n, n_batches=n_batches)
        (store / "meta.json").write_text(json.dumps(meta, indent=1))

    def screen(self, store: str) -> list[tuple[str, float]]:
        from pharmaconet_tpu_torch.cli.screening import screen_tiles

        # screen_tiles prints one line per pass; keep the result line last
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            return screen_tiles(self.screener, store, self.out)

    def run_pass(self) -> tuple[int, np.ndarray, np.ndarray]:
        """One screen of the whole library. Returns (names missing from or
        repeated in the results, the sampled positions' scores, which of
        them are missing), so that no pass's results stay alive for the
        interpreter's collector to walk."""
        results = self.screen(self.store)
        if [n for n, _ in results] == self.names:  # library order
            got = np.array([results[i][1] for i in self.sampled], np.float64)
            return 0, got, np.zeros(len(got), bool)
        scores = dict(results)
        missing = len(set(self.names) - scores.keys()) + len(results) - len(scores)
        absent = np.array([self.names[i] not in scores for i in self.sampled])
        got = np.array([scores.get(self.names[i], np.nan) for i in self.sampled], np.float64)
        return missing, got, absent

    @contextlib.contextmanager
    def instrument(self, rec):
        """Spans around the program's calls, for the traced window: the
        prefetch thread's store load and page-in, the main thread's wait
        for it, the dispatch and the host tail."""
        from pharmaconet_tpu_torch.scoring import tiled_store

        store_cls = tiled_store.TiledStore
        load, page_in, iter_loaded = store_cls.load, tiled_store._page_in, store_cls.iter_loaded
        dispatch, tail = self.screener.dispatch_stored, self.screener.postprocess_stored
        to_device = self.screener._to_device

        def load_w(self_, *a, **k):
            with rec.span("bench.load"):
                return load(self_, *a, **k)

        def page_in_w(*a, **k):
            with rec.span("bench.page_in"):
                return page_in(*a, **k)

        def iter_loaded_w(self_, *a, **k):
            gen = iter_loaded(self_, *a, **k)
            try:
                while True:
                    with rec.span("bench.wait"):
                        try:
                            item = next(gen)
                        except StopIteration:
                            return
                    yield item
            finally:
                gen.close()

        def dispatch_w(*a, **k):
            with rec.span("bench.dispatch"):
                return dispatch(*a, **k)

        def tail_w(*a, **k):
            with rec.span("bench.tail"):
                return tail(*a, **k)

        def to_device_w(a, *args, **k):
            rec.count("copy_bytes", np.asarray(a).nbytes)
            return to_device(a, *args, **k)

        store_cls.load, tiled_store._page_in, store_cls.iter_loaded = load_w, page_in_w, iter_loaded_w
        scr = self.screener
        scr.dispatch_stored, scr.postprocess_stored, scr._to_device = dispatch_w, tail_w, to_device_w
        try:
            yield
        finally:
            store_cls.load, tiled_store._page_in, store_cls.iter_loaded = load, page_in, iter_loaded
            del scr.dispatch_stored, scr.postprocess_stored, scr._to_device

    def store_bytes(self) -> int:
        """Bytes of the prepacked store (the library's links add none)."""
        return sum(p.stat().st_size for p in Path(self.tiles).rglob("*") if p.is_file())

    def free(self) -> None:
        self.screener = None

    def work(self) -> tuple[int, int]:
        """(f32 operations, bytes) one pass needs (roofline.py)."""
        model = screen_reference.Model(self.state, self.config["weights"])
        ops, nbytes = roofline.screening_work(model, self.library)
        copies = self.n // self.distinct
        return ops * copies, nbytes * copies

    def sample(self) -> np.ndarray:
        """The library positions the check compares, drawn from the seed."""
        rng = np.random.default_rng(seed_sequence(self.ctx.seed, 1))
        k = min(int(self.traffic["check_sample"]), self.n)
        return np.sort(rng.choice(self.n, size=k, replace=False))

    def reference(self, precision: str = "float32") -> np.ndarray:
        """The reference's score at each sampled position (position i holds
        distinct ligand i mod distinct_ligands)."""
        model = screen_reference.Model(self.state, self.config["weights"])
        src = self.sampled % self.distinct
        scores = {int(i): screen_reference.ligand_score(model, self.library.ligand(int(i)),
                                                        precision) for i in np.unique(src)}
        return np.array([scores[int(i)] for i in src])

    def control(self) -> float:
        """score_tol_share of the reference in bfloat16 (the precision below
        the configuration's float32), put in the program's place, on the
        run's sample."""
        got = self.reference("bfloat16")
        return self._worst(self.reference(), [(got, np.zeros(len(got), bool))])[0]

    def _worst(self, want: np.ndarray, passes) -> tuple[float, int]:
        """(the largest score_tol_share, the answers beyond the tolerance)
        over every score returned; absent names are counted elsewhere."""
        worst, beyond = 0.0, 0
        for got, absent in passes:
            for g, w, a in zip(got, want, absent):
                if a:
                    continue
                share = screen_reference.tolerance_share(
                    float(g), float(w), self.config["score_rtol"], self.config["score_atol"])
                worst = max(worst, share)
                beyond += share > 1.0
        return worst, beyond

    def check(self, passes: list[tuple[int, np.ndarray, np.ndarray]]):
        """(numbers compared, attempted, failed): each number is
        (name, value, limit), correct where value <= limit."""
        want = self.reference()
        missing = sum(m for m, _, _ in passes)
        worst, beyond = self._worst(want, [(got, absent) for _, got, absent in passes])
        checks = [("score_tol_share", worst, 1.0), ("answers_missing", missing, 0)]
        return checks, len(passes) * self.n, missing + beyond
