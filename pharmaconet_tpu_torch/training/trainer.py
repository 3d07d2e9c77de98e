"""Proxy-head trainer on frozen PharmacoNet features (torch).

Upstream developer/src/trainer.py:25-209, as
`pharmaconet_tpu/training/trainer.py` runs it:
  * global-norm clip, Adam, then lr * 2^(-step/decay) from step 0
    (`train_step.Optimizer`; no weight decay, as the JAX chain has none)
  * periodic print/log/save/validate with best/last checkpoints (the JAX
    package's flax `.npz`, readable by either trainer) and JSONL metrics
    (and wandb, when the caller has started a run)
  * the frozen trunk runs per item; a worker thread prepares the next
    batch (parse, K6, trunk, featurization) while the step runs
  * full-state resume (params, optimizer state, iteration, epoch, and the
    data order: the batches and noise draws the run would have taken)

Host randomness is the JAX trainer's: `random.seed(0); random.shuffle`
splits the codes, `random.shuffle` orders each epoch and the parse draws
its centre noise with `np.random.rand`. The init is a `torch.Generator(0)`
draw (flax's `PRNGKey(0)` cannot be reproduced), and the port fetches no
example item for it, so with centre noise on its noise draws run one item
ahead of the JAX trainer's. Training runs in full f32 (TF32 off for
products and convolutions); the trunk's `matmul_precision` must be float32
too, because the worker thread shares torch's global precision flags.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import pickle
import queue
import random
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..module import precision_scope
from ..parallel.mesh import average_onto, data_mesh, module_replicas, sync_replicas
from ..proxy.convert import random_state_dict
from .affinity_model import DevAffinityModel
from .config import Config
from .convert import save_checkpoint
from .dataset import PocketLigandDataset, collate_identity, repad_items
from .train_step import Optimizer, all_tensors_trainable, apply_updates

logger = logging.getLogger("pharmaconet_tpu_torch.trainer")


class _Prefetcher:
    """Batches prepared on a worker thread (upstream uses DataLoader worker
    processes). On CUDA the worker runs the trunk on its own stream; the
    consumer's stream waits for an event recorded after each batch, and
    the batch's device tensors are recorded on the consumer's stream so
    their memory is not reused while its kernels read them."""

    def __init__(self, dataset, batch_size: int, device: torch.device):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = device
        # one stream for every epoch: the caching allocator pools blocks per
        # stream, so a new stream each epoch would allocate afresh
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def epoch(self, skip: int = 0):
        """One epoch's batches, in `random.shuffle` order; the first `skip`
        batches are passed over, their items' draws made all the same
        (`PocketLigandDataset.skip`), as a resumed run needs."""
        order = list(range(len(self.dataset)))
        random.shuffle(order)
        starts = list(range(0, len(order) - self.batch_size + 1, self.batch_size))
        for start in starts[:skip]:
            for i in order[start:start + self.batch_size]:
                self.dataset.skip(i)
        starts = starts[skip:]
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()
        stream = self.stream
        cuda = stream is not None

        def worker():
            try:
                for start in starts:
                    if stop.is_set():
                        return
                    with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
                        items = [self.dataset[i] for i in order[start:start + self.batch_size]]
                        event = torch.cuda.Event() if cuda else None
                        if cuda:
                            event.record(stream)
                    q.put((collate_identity(items), event))
            except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
                q.put(e)
            finally:
                q.put(None)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while (got := q.get()) is not None:
                if isinstance(got, BaseException):
                    raise got
                items, event = got
                if cuda:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for item in items:
                        for f in item.multi_scale_features:
                            f.record_stream(current)
                yield items
        finally:
            stop.set()
            while thread.is_alive():  # unblock a worker waiting to put
                with contextlib.suppress(queue.Empty):
                    q.get(timeout=0.1)
            thread.join()


class Trainer:
    """Trains a DevAffinityModel on `pmnet`'s frozen features.

    device: where the model trains (the card by default; asking for CUDA
    without one raises). pmnet: a PharmacoNet (`api.get_pmnet_dev(device=
    device)` by default). mesh: an optional device list, whose first device
    then trains the model in place of `device`; `fit` runs `dp_step`: the
    batch's items re-padded to common buckets (`dataset.repad_items`), a
    contiguous share per device on a replica, gradients averaged onto the
    first device before the update."""

    def __init__(self, config: Config, pmnet=None, mesh=None, device: str | torch.device = "cuda"):
        self.mesh = data_mesh(mesh) if mesh is not None else None
        self.device = self.mesh[0] if self.mesh is not None else resolve_device(device)
        self.config = config
        self.log_dir = Path(config.log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.save_dir = self.log_dir / "save"
        self.save_dir.mkdir(parents=True, exist_ok=True)
        config.save(self.log_dir / "config.yaml")
        self._handlers = [logging.FileHandler(self.log_dir / "train.log"),
                          logging.StreamHandler(sys.stdout)]
        for h in self._handlers:
            h.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
            logger.addHandler(h)
        logger.setLevel(logging.INFO)
        self._saving: threading.Thread | None = None
        self._restored_data: dict | None = None

        if pmnet is None:
            from ..api import get_pmnet_dev

            pmnet = get_pmnet_dev(device=self.device)
        self.pmnet = pmnet
        net = pmnet.model.config
        self.model = all_tensors_trainable(DevAffinityModel(
            hidden_dim=config.model.hidden_dim, ligand_num_convs=config.model.ligand_num_convs,
            token_dim=net["token_feature_dim"], feature_dim=net["embed_dim"],
            num_scales=len(net["depths"]) + 1))
        self.model.load_state_dict(random_state_dict(self.model, 0))
        self.model.to(self.device)
        self.setup_data()
        self.setup_train()

    def close(self) -> None:
        """Detach this trainer's log handlers and wait for pending saves."""
        self.wait_for_checkpoints()
        for h in self._handlers:
            logger.removeHandler(h)
            h.close()

    # ------------------------------------------------------------------
    def setup_data(self):
        config = self.config
        protein_info = {}
        with open(config.data.protein_info_path) as f:
            for line in f:
                code, x, y, z = line.strip().split(",")
                protein_info[code] = (float(x), float(y), float(z))
        with open(config.data.train_protein_code_path) as f:
            codes = [ln.strip() for ln in f if ln.strip()]
        random.seed(0)
        random.shuffle(codes)
        split = int(len(codes) * config.train.split_ratio)
        self.train_dataset = PocketLigandDataset(
            codes[:split], protein_info, config.data.protein_dir,
            config.data.ligand_path, self.pmnet, config.train.center_noise,
        )
        self.val_dataset = PocketLigandDataset(
            codes[split:], protein_info, config.data.protein_dir,
            config.data.ligand_path, self.pmnet,
        )
        logger.info(f"train set: {len(self.train_dataset)}")
        logger.info(f"valid set: {len(self.val_dataset)}")

    def setup_train(self):
        opt = self.config.train.opt
        lr, decay = np.float32(opt.lr), np.float32(self.config.train.lr_scheduler.lr_decay)
        self.optimizer = Optimizer(
            lambda step: lr * np.float32(2.0) ** (np.float32(-step) / decay),
            clip=opt.clip_grad, b1=opt.betas[0], b2=opt.betas[1], eps=opt.eps)
        self.params = dict(self.model.named_parameters())
        self.opt_state = self.optimizer.init(self.params)
        self._replicas = module_replicas(self.model, self.mesh)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def _loss_and_grads(self, items, model=None, device=None):
        """Mean of the items' per-pocket losses (developer model.py:51-56)
        and its gradient for every tensor of `model` (None where the loss
        does not reach one), in full f32 on `device`."""
        model = self.model if model is None else model
        device = self.device if device is None else device
        params = dict(model.named_parameters())
        with precision_scope("float32", device):
            loss = torch.stack([model.loss(*item.loss_args(device)) for item in items]).mean()
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return loss.detach(), dict(zip(params, grads))

    def _apply(self, grads) -> None:
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state)
        apply_updates(self.params, updates)

    def _train_step(self, items) -> torch.Tensor:
        """One optimizer step on a batch of PocketItems; returns the loss."""
        loss, grads = self._loss_and_grads(items)
        self._apply(grads)
        return loss

    def dp_step(self, items) -> torch.Tensor:
        """One data-parallel step over the mesh; returns the loss."""
        n_dev = len(self._replicas)
        if len(items) % n_dev:
            raise ValueError(f"mesh size {n_dev} must divide the DP batch size {len(items)}")
        items = repad_items(items)
        share = len(items) // n_dev
        sync_replicas(self._replicas, self.params)
        results = [self._loss_and_grads(items[i * share:(i + 1) * share], rep, dev)
                   for i, (rep, dev) in enumerate(self._replicas)]
        loss, grads = average_onto(results, self.params)
        self._apply(grads)
        return loss

    # ------------------------------------------------------------------
    def fit(self, resume_from: str | Path | None = None):
        """Train to `max_iterations`. A resumed run starts at the iteration
        after the saved one (the JAX trainer repeats the saved one) and, from
        a checkpoint this trainer wrote, takes the batches and centre-noise
        draws the uninterrupted run would have taken: the checkpoint holds
        the host generators' states at the start of its epoch and the
        batches done in it (the JAX trainer starts a new shuffle)."""
        cfg = self.config.train
        it, epoch, skip = 1, 0, 0
        if resume_from is not None:
            it, epoch = self.restore_state(resume_from)
            it += 1
            if self._restored_data is not None:
                random.setstate(self._restored_data["random"])
                np.random.set_state(self._restored_data["np_random"])
                skip = self._restored_data["batches_done"]
            logger.info(f"resumed from {resume_from} at iteration {it}")
        best_loss = float("inf")
        prefetcher = _Prefetcher(self.train_dataset, cfg.batch_size, self.pmnet.device)
        # the worker's trunk shares the global precision flags: hold them
        # at float32 for the whole run
        with precision_scope("float32", self.device):
            while it <= cfg.max_iterations:
                data = {"random": random.getstate(), "np_random": np.random.get_state(),
                        "batches_done": skip}
                for items in prefetcher.epoch(skip):
                    if it > cfg.max_iterations:
                        break
                    tick = time.time()
                    step = self.dp_step if self.mesh is not None else self._train_step
                    info = {"loss": float(step(items)), "time": time.time() - tick}
                    data["batches_done"] += 1
                    if it % cfg.print_every == 0:
                        logger.info(f"epoch {epoch} iteration {it} train : "
                                    + " ".join(f"{k}:{v:.2f}" for k, v in info.items()))
                    if it % cfg.log_every == 0:
                        self.log(info, it, epoch, "train")
                    if it % cfg.save_every == 0:
                        self.save_checkpoint(f"epoch-{epoch}-it-{it}.npz")
                        self.save_state("resume.ckpt", it, epoch,
                                        backend=getattr(cfg, "checkpoint_backend", "pickle"),
                                        data=data)
                    if it % cfg.val_every == 0:
                        val_info = self.evaluate()
                        self.log(val_info, it, epoch, "valid")
                        logger.info(f"epoch {epoch} iteration {it} valid : "
                                    + " ".join(f"{k}:{v:.2f}" for k, v in val_info.items()))
                        if val_info["loss"] < best_loss:
                            self.save_checkpoint("best.npz")
                            best_loss = val_info["loss"]
                    it += 1
                skip = 0
                epoch += 1
        self.save_checkpoint("last.npz")
        self.wait_for_checkpoints()

    @torch.no_grad()
    def evaluate(self) -> dict[str, float]:
        losses = []
        with precision_scope("float32", self.device):
            for i in range(len(self.val_dataset)):
                item = self.val_dataset[i]
                losses.append(float(self.model.loss(*item.loss_args(self.device))))
        return {"loss": float(np.mean(losses)) if losses else float("nan")}

    # ------------------------------------------------------------------
    def log(self, info: dict, index: int, epoch: int, key: str):
        record = {f"{key}/{k}": v for k, v in info.items()}
        record.update({"step": index, "epoch": epoch})
        with open(self.log_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(record) + "\n")
        # a wandb run exists only if the caller imported wandb and started one;
        # importing it here (seconds where installed) would stall the loop
        wandb = sys.modules.get("wandb")
        if wandb is not None and wandb.run is not None:
            wandb.log(record, step=index)

    def save_checkpoint(self, filename: str):
        """The model as the JAX trainer's `.npz` (training/convert.py)."""
        save_checkpoint(self.save_dir / filename, self.model)

    # ------------------------------------------------------------------
    # Full-state checkpoints (params + optimizer + progress). Upstream saves
    # weights only and cannot resume (developer/src/trainer.py:177-182).
    # ------------------------------------------------------------------
    def save_state(self, filename: str, it: int, epoch: int, backend: str = "pickle",
                   data: dict | None = None) -> None:
        """backend='pickle' writes atomically (tmp + os.replace: a crash
        mid-save leaves the previous checkpoint whole). backend='orbax', as
        a JAX config may name it, writes the same file off the train loop:
        the state is copied to the host now, and a thread writes it
        (`wait_for_checkpoints` joins it). The port has no orbax. data:
        the data order `fit` resumes ({"random", "np_random": the host
        generators' states at the start of the epoch, "batches_done"})."""
        if backend not in ("pickle", "orbax"):
            raise ValueError(f"unknown checkpoint backend {backend!r}")

        def host(tensors: dict) -> dict:
            return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}

        state = {
            "params": host(self.params),
            "opt_state": {"count": self.opt_state["count"], "mu": host(self.opt_state["mu"]),
                          "nu": host(self.opt_state["nu"])},
            "iteration": it,
            "epoch": epoch,
        }
        if data is not None:
            state["data"] = dict(data)
        path = self.save_dir / filename
        self.wait_for_checkpoints()
        if backend == "pickle":
            _write_atomic(path, state)
            return
        self._saving = threading.Thread(target=_write_atomic, args=(path, state))
        self._saving.start()

    def wait_for_checkpoints(self) -> None:
        """Block until an in-flight asynchronous save has committed."""
        if self._saving is not None:
            self._saving.join()
            self._saving = None

    def restore_state(self, path) -> tuple[int, int]:
        """Load a full-state checkpoint of either backend; returns
        (iteration, epoch) as saved. Its data order, where it holds one,
        waits in `_restored_data` for `fit`."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        self._restored_data = state.get("data")

        def device(arrays: dict) -> dict:
            return {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}

        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(torch.from_numpy(state["params"][k]))
        opt = state["opt_state"]
        self.opt_state = {"count": int(opt["count"]), "mu": device(opt["mu"]),
                          "nu": device(opt["nu"])}
        return int(state["iteration"]), int(state["epoch"])


def _write_atomic(path: Path, state: dict) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as w:
        pickle.dump(state, w)
    os.replace(tmp, path)
