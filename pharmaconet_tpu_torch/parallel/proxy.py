"""Docking-proxy inference over a device list: molecules and pockets shard
over the mesh (`pharmaconet_tpu/parallel/proxy.py`).

Upstream scores proxy batches on one GPU, one `scoring_list` per RL step,
and builds its cache databases one pocket at a time. At serving scale the
molecule batch is the axis that grows and scoring is a map over molecules:
each device takes a contiguous share of the SMILES batch, padded as the
proxy pads a batch (`_score_graphs`: graphs to `half_octave`, atoms and
edges to a multiple of 128), and runs the proxy's scoring forward on it
with its own replica of the network. The JAX package pads every share to
the largest share's half-octave atom and edge buckets, so that one
compiled program serves them all; eager torch compiles nothing, and those
buckets would pad the 38,783 atoms of 2048 fragment SMILES to 49,152 rows
(27% more work in every per-atom layer). Host featurization of the next batch runs on a
worker thread while the card scores the current one (`scoring_iter`).

Threads: the worker does host work only (the C++ featurizer and numpy
padding, or PDB parsing); every device launch and copy stays on the
calling thread, on the current stream.
"""

from __future__ import annotations

import inspect
import itertools
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..proxy.data import batch_graphs, half_octave, smi2graph_list
from ..proxy.tacogfn import graph_batch_to_arrays
from .mesh import contiguous_shares, data_mesh, on_device


class ShardedProxyScorer:
    """Fan a proxy's scoring batch over a device list.

    Wraps `TacoGFN_Proxy` or `SBDDReward_Proxy` (their `_score_graphs`,
    `_forward_inputs` and `_forward` hooks), keeping its invalid-SMILES
    contract: SBDDReward scores an invalid SMILES 0.0, TacoGFN raises
    `ValueError`; `return_sigma` on a proxy without a sigma head raises
    `TypeError`. A batch of fewer than 2 graphs per device goes to the
    proxy's single-device `_score_graphs`. mesh: a device list
    (`data_mesh`), every visible CUDA device by default; the replicas on
    devices other than the proxy's are copied here, so build the scorer
    after the proxy's parameters are loaded."""

    def __init__(self, proxy, mesh=None):
        self.proxy = proxy
        self.mesh = data_mesh(mesh)
        self._replicas = [on_device(proxy, d) for d in self.mesh]
        # TacoGFN's forward has no sigma head: detect, don't special-case
        self._has_sigma = "return_sigma" in inspect.signature(proxy._forward_inputs).parameters

    def scoring_list(self, target: str, smiles_list, return_sigma: bool = False) -> np.ndarray:
        return self._scoring_list(self.proxy._cache[target], smiles_list, return_sigma)

    def scoring_iter(self, target: str, smiles_iter, batch_size: int = 2048,
                     return_sigma: bool = False):
        """Scores of a long SMILES sequence in batches of `batch_size`, one
        np.ndarray per batch. The host featurizes batch i+1 on a worker
        thread while batch i runs on the devices."""
        self._check_sigma(return_sigma)
        cache = self.proxy._cache[target]
        it = iter(smiles_iter)

        def take():
            return list(itertools.islice(it, batch_size)) or None

        with ThreadPoolExecutor(max_workers=1) as pool:
            batch = take()
            if batch is None:
                return
            fut = pool.submit(self._prepare, batch)
            while True:
                nxt = take()
                nxt_fut = pool.submit(self._prepare, nxt) if nxt is not None else None
                yield self._finish(cache, batch, fut.result(), return_sigma)
                if nxt_fut is None:
                    return
                batch, fut = nxt, nxt_fut

    def _scoring_list(self, cache, smiles_list, return_sigma: bool = False) -> np.ndarray:
        self._check_sigma(return_sigma)
        smiles_list = list(smiles_list)
        return self._finish(cache, smiles_list, self._prepare(smiles_list), return_sigma)

    def _check_sigma(self, return_sigma: bool) -> None:
        if return_sigma and not self._has_sigma:
            raise TypeError(f"{type(self.proxy).__name__} has no sigma head")

    def _prepare(self, smiles_list: list) -> dict:
        """Host phase: featurize, split into contiguous shares, pad each.
        No device work, so it runs on the worker thread. Returns what
        `_finish` needs."""
        n_dev = len(self.mesh)
        maybe = smi2graph_list(smiles_list)
        graphs = [g for g in maybe if g is not None]
        flags = [g is not None for g in maybe]
        if len(graphs) != len(smiles_list) and self.proxy.invalid_smiles == "raise":
            bad = next(i for i, g in enumerate(maybe) if g is None)
            raise ValueError(f"unparseable SMILES: {smiles_list[bad]!r}")
        if not any(flags):
            return {"zeros": True}
        if len(graphs) < 2 * n_dev:
            # too few molecules to shard: the proxy's single-device path
            # takes the graphs already featurized
            return {"fallback": True, "graphs": graphs, "flags": flags}
        shards = [graphs[a:b] for a, b in contiguous_shares(len(graphs), n_dev)]
        batches = [batch_graphs(s, num_graphs_pad=half_octave(len(s))) for s in shards]
        return {"batches": batches, "shard_lens": [len(s) for s in shards], "flags": flags}

    def _finish(self, cache, smiles_list, prep: dict, return_sigma: bool) -> np.ndarray:
        """Device phase: each share's forward on its device (all launched
        before any result is read back), then the scores in input order."""
        kw = {"return_sigma": return_sigma} if self._has_sigma else {}
        if prep.get("zeros"):
            return np.zeros(len(smiles_list), dtype=np.float32)
        if prep.get("fallback"):
            return self.proxy._score_graphs(cache, prep["graphs"], prep["flags"], **kw)
        outs = []
        for rep, batch in zip(self._replicas, prep["batches"]):
            arrays = graph_batch_to_arrays(batch, rep.categorical, device=rep.device)
            outs.append(rep._forward(*rep._forward_inputs(cache, arrays, **kw)))
        scores = np.concatenate([o.cpu().numpy()[:n] for o, n in zip(outs, prep["shard_lens"])])
        scores = scores.astype(np.float32)
        flags = prep["flags"]
        if all(flags):
            return scores
        result = np.zeros(len(smiles_list), dtype=np.float32)
        result[np.asarray(flags)] = scores
        return result


class ShardedCacheBuilder:
    """A proxy's cache database with pockets fanned over a device list.

    Upstream builds its 15,201-pocket CrossDocked2020 database one pocket
    at a time (parse, PharmacoNet forward, encoder). Here chunks of one
    pocket per device are parsed on a worker thread while the current chunk
    runs; each pocket runs the trunk (K6, SwinV2-3D + FPN, heads) and the
    proxy's pocket encoder on its device, so the ~100 MB pyramid never
    leaves it and only the cache comes back to the host. A pocket whose
    parse fails is printed and skipped, as upstream does.

    Token selection: the kept token rows are gathered on the device and the
    pocket encoder runs on them (`BaseProxy._cache_from_trunk`, the path of
    the port's fused `get_cache`), so each cache equals the serial
    `get_cache_database`'s element by element. The JAX builder instead runs
    the encoder on the padded token axis with a masked token summary
    (`TacoAffinityHead.ready_to_calculate_masked`), which moved TacoGFN
    pocket vectors near 1e4 by 9.8e-4 on the H100 in the port's tests of
    the fused cache."""

    def __init__(self, proxy, mesh=None):
        self.proxy = proxy
        self.mesh = data_mesh(mesh)

    def _replicas(self) -> list:
        self.proxy.setup_pmnet()
        reps = []
        for d in self.mesh:
            rep = on_device(self.proxy, d)
            if rep is not self.proxy:
                rep.pmnet = on_device(self.proxy.pmnet, d)
            reps.append(rep)
        return reps

    def _parsed_chunks(self, pocket_info: dict, n_dev: int):
        """(keys, parsed pockets) chunks of up to n_dev, lazily: the host
        holds one chunk of parsed pockets at a time."""
        pmnet = self.proxy.pmnet
        keys, datas = [], []
        for key, (pdb_path, pocket_center) in pocket_info.items():
            try:
                if isinstance(pocket_center, (str, Path)):
                    data = pmnet.parse(pdb_path, ref_ligand_path=pocket_center)
                else:
                    data = pmnet.parse(pdb_path, center=pocket_center)
            except Exception as e:  # noqa: BLE001 - tolerant batch building
                print(key, e)
                continue
            keys.append(key)
            datas.append(data)
            if len(datas) == n_dev:
                yield keys, datas
                keys, datas = [], []
        if datas:
            yield keys, datas

    def get_cache_database(self, pocket_info: dict, save_path=None,
                           verbose: bool = True) -> dict:
        """`BaseProxy.get_cache_database`'s contract ({key: (protein pdb,
        centre or ligand path)}), pockets sharded over the mesh; the next
        chunk is parsed on a worker thread while the current one runs."""
        import tqdm

        reps = self._replicas()
        cache_dict: dict = {}
        chunks = self._parsed_chunks(pocket_info, len(reps))
        with tqdm.tqdm(total=len(pocket_info), disable=not verbose) as progress, \
                ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(next, chunks, None)
            while (item := fut.result()) is not None:
                fut = pool.submit(next, chunks, None)
                keys, datas = item
                outs = [rep.pmnet.run_trunk(d) for rep, d in zip(reps, datas)]
                for rep, key, data, out in zip(reps, keys, datas, outs):
                    cache_dict[key] = rep._cache_from_trunk(data, out)
                progress.update(len(keys))
        if save_path is not None:
            self.proxy._save_cache_file(cache_dict, save_path)
        return cache_dict
