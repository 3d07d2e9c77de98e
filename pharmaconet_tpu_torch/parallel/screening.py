"""Batch screening with ligands sharded over a device list
(`pharmaconet_tpu/parallel/screening.py`).

Each device of the mesh holds a screener of its own (its device, its
stream, its pack buffers) and takes a contiguous share of the batch's
ligands. Every share is packed and launched before any result is read
back, so a share's kernels run while the host packs the next; the host
tails (pair compaction, prune, DFS) then run in mesh order. No share
waits for another and nothing crosses devices but the scores.

The JAX package pads every shard to common shapes (`pad_tiled`, a repack
pinned to the widest shard, common row widths and scan depths) because
`shard_map` stacks the shards into one array. Eager torch launches each
share at its own shapes and scan depths, so none of that padding is
ported; only the conformer slot count is common to the shares, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses

from ..scoring.batch_screen import BatchScreener, PackedLigand
from .mesh import contiguous_shares, data_mesh


class ShardedScreener(BatchScreener):
    """BatchScreener that fans ligand shares over a device list.

    mesh: a device list (`data_mesh`), every visible CUDA device by default
    (none visible raises); the same device may appear several times. The
    home device, `mesh[0]`, runs what is not sharded: a batch with fewer
    live ligands than devices and single stored batches.

    What runs on each share, as the JAX sharded screener maps its engines:
      "tiled", fused and native_pack: the one-pass C++ pack, then K1;
      "tiled" otherwise: build_batch, then K5 and the torch scans (also
        with fused=True, where the single-device path runs K4);
      "v3": the v3 layout, then K2 (the JAX sharded screener has no v3
        branch and runs its plain device function there);
      "reference": build_batch, then score_blocks_device.
    """

    def __init__(self, model, weights: dict[str, float] | None = None, mesh=None,
                 engine: str = "tiled", fused: bool = True, native_pack: bool = True,
                 pack_threads: int = 1):
        self.mesh = data_mesh(mesh)
        super().__init__(model, weights, engine=engine, fused=fused, native_pack=native_pack,
                         pack_threads=pack_threads, device=self.mesh[0])
        share_fused = fused and native_pack  # off the one-pass pack a share runs K5
        self._shares = [
            BatchScreener(self.packed_model, engine=engine, fused=share_fused,
                          native_pack=native_pack, pack_threads=pack_threads, device=d)
            for d in self.mesh
        ]

    def score_packed(self, packed: list[PackedLigand]) -> list[float]:
        live = [(i, p) for i, p in enumerate(packed) if p.clusters]
        out = [0.0] * len(packed)
        if not live:
            return out
        if len(live) < len(self.mesh):
            return super().score_packed(packed)  # too few ligands to shard
        ligands = [p for _, p in live]
        cmax = max(p.num_conformers for p in ligands)  # conformer slots line up
        tails = [
            share.dispatch_live(ligands[a:b], cmax=cmax)
            for share, (a, b) in zip(self._shares, contiguous_shares(len(ligands), len(self.mesh)))
        ]
        scores = [s for tail in tails for s in tail()]
        for (i, _), s in zip(live, scores):
            out[i] = s
        return out

    def score_stored_group(self, sbs: list) -> list[list[float]]:
        """One non-empty tile-store batch per mesh device, each dispatched
        on its own device; every batch is launched before any result is
        read back, then the host tails run in mesh order. Returns per-batch
        score lists.

        The variant is chosen for the whole group, as the JAX package's one
        program is: v3 batches run the bucketed or single-window leaf chain
        only when every batch of the group has those leaves, and compact
        pairs on the device only when every batch has `ends_padded`; the
        others of a mixed group run K2 alone with the pair compaction on
        the host. A v2 batch runs K3, a v1 batch K1."""
        if len(sbs) != len(self.mesh):
            raise ValueError(f"{len(sbs)} stored batches for a mesh of {len(self.mesh)}")
        if any(sb.empty for sb in sbs):
            raise ValueError("score_stored_group takes non-empty batches only")
        if getattr(sbs[0], "gid", None) is not None:  # v3 store
            use_leaves = (all(sb.leaf_buckets is not None for sb in sbs)
                          or all(sb.leaf2_ps is not None for sb in sbs))
            if not use_leaves:
                strip = dict(leaf2_ps=None, leaf_buckets=None)
                if not all(sb.ends_padded is not None for sb in sbs):
                    strip["ends_padded"] = None
                sbs = [dataclasses.replace(sb, **strip) for sb in sbs]
        results = [share.dispatch_stored(sb) for share, sb in zip(self._shares, sbs)]
        return [share.postprocess_stored(sb, r)
                for share, sb, r in zip(self._shares, sbs, results)]
