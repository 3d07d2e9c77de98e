"""Cross-implementation checks against the upstream reference, run directly.

The counterpart of the JAX package's `utils/crosscheck.py`, used by the
port's checkpoint verifier (`cli/verify_checkpoint.py`): import the
upstream package from an untouched checkout with its unavailable native
dependencies stubbed (openbabel/molvoxel/Bio/omegaconf; none of the stubbed
code executes), build an upstream `PharmacoNet` around a given torch
network and score distributions, feed it the same parsed and voxelized
pocket tensors the port consumes, and diff every stage.

The checkout's location is `PMNET_REFERENCE_SRC` (or an explicit path);
without one, or where the directory is absent, `reference_available` is
False and the loaders raise `FileNotFoundError` naming it.

Upstream anchors: module.py:215-309 (create_density_maps),
pharmacophore_model.py:108-130 (graph build), parser.py:70-106 (the
protein_data tuple contract).
"""

from __future__ import annotations

import os
import sys
import types

import numpy as np

REF_SRC = os.environ.get("PMNET_REFERENCE_SRC", "")


def reference_available(ref_src: str | None = REF_SRC) -> bool:
    return bool(ref_src) and os.path.isdir(ref_src)


def _require_reference(ref_src: str | None) -> None:
    if not reference_available(ref_src):
        raise FileNotFoundError(
            f"no upstream reference checkout at {ref_src!r} (set PMNET_REFERENCE_SRC)")


# --------------------------------------------------------------------------
# Import the upstream module graph with its native dependencies stubbed
# --------------------------------------------------------------------------
class _Anything:
    """Absorbs chained attribute access and calls (stub leaf object)."""

    def __getattr__(self, name):
        if name.startswith("__"):  # never answer dunder protocol probes
            raise AttributeError(name)
        return self

    def __call__(self, *args, **kwargs):
        return self


_ANY = _Anything()


def _stub_module_getattr(name):
    # PEP 562 module-level catch-all. It must raise on dunders: answering
    # __file__/__path__ with a non-string breaks inspect.getmodule for every
    # module in the process.
    if name.startswith("__"):
        raise AttributeError(name)
    return _ANY


def install_openbabel_stub() -> None:
    """Install (or upgrade) the process-wide openbabel stub.

    Idempotent and order-independent: a stub already registered by another
    importer is upgraded in place to the full catch-all contract rather
    than trusted. A real openbabel install (one with a string __file__) is
    left alone."""
    existing = sys.modules.get("openbabel")
    if existing is not None and isinstance(existing.__dict__.get("__file__"), str):
        return

    if existing is not None:
        openbabel = existing
        pybel = getattr(existing, "pybel", None) or types.ModuleType("openbabel.pybel")
        ob = getattr(pybel, "ob", None) or types.ModuleType("openbabel.pybel.ob")
    else:
        openbabel = types.ModuleType("openbabel")
        pybel = types.ModuleType("openbabel.pybel")
        ob = types.ModuleType("openbabel.pybel.ob")

    ob.OBAtomAtomIter = lambda atom: iter(atom.neighbors)
    ob.__getattr__ = _stub_module_getattr
    pybel.ob = ob
    pybel.__getattr__ = _stub_module_getattr
    openbabel.pybel = pybel
    openbabel.__getattr__ = _stub_module_getattr
    sys.modules["openbabel"] = openbabel
    sys.modules["openbabel.pybel"] = pybel


def install_reference_stubs() -> None:
    install_openbabel_stub()
    if "omegaconf" not in sys.modules:
        m = types.ModuleType("omegaconf")
        m.OmegaConf = object
        sys.modules["omegaconf"] = m
    if "molvoxel" not in sys.modules:
        m = types.ModuleType("molvoxel")
        m.Voxelizer = object
        m.create_voxelizer = lambda *a, **k: None
        sys.modules["molvoxel"] = m
    if "Bio" not in sys.modules:
        bio = types.ModuleType("Bio")
        pdb = types.ModuleType("Bio.PDB")
        pdbio = types.ModuleType("Bio.PDB.PDBIO")

        class _Select:  # subclassed at import time by extract_pocket.py
            pass

        pdbio.Select = _Select
        pdb.PDBIO = object
        pdb.PDBParser = object
        bio.PDB = pdb
        sys.modules["Bio"] = bio
        sys.modules["Bio.PDB"] = pdb
        sys.modules["Bio.PDB.PDBIO"] = pdbio
    # no gdown stub: upstream imports it lazily, and a fake module would leak
    # into the port's own weight download (utils/download_weight.py)


def _register_package(ref_src: str) -> None:
    _require_reference(ref_src)
    install_reference_stubs()
    if "pmnet" not in sys.modules:
        pkg = types.ModuleType("pmnet")
        pkg.__path__ = [os.path.join(ref_src, "pmnet")]
        sys.modules["pmnet"] = pkg


def import_reference_module(ref_src: str = REF_SRC):
    """Returns (pmnet.module, pmnet.pharmacophore_model)."""
    _register_package(ref_src)
    import pmnet.module as ref_module  # noqa: PLC0415
    import pmnet.pharmacophore_model as ref_pm_mod  # noqa: PLC0415

    return ref_module, ref_pm_mod


def load_reference_network(state: dict[str, np.ndarray], ref_src: str = REF_SRC):
    """Build the upstream torch network and load a (numpy) state dict.

    Returns the eval-mode torch module; raises if any learned parameter is
    missing (deterministic buffers recomputed at construction are allowed)."""
    import torch

    _register_package(ref_src)
    import pmnet.network.builder as ref_builder  # noqa: PLC0415

    model = ref_builder.build_model({})
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, strict=False)
    buffer_suffixes = ("relative_coords_table", "relative_position_index", "attn_mask")
    bad = [k for k in missing if not k.endswith(buffer_suffixes)]
    if unexpected or bad:
        raise ValueError(f"state dict mismatch: unexpected={unexpected[:3]} missing={bad[:3]}")
    model.eval()
    return model


def make_reference_pharmaconet(
    ref_module, torch_model, distributions: dict[str, np.ndarray],
    score_threshold=None, force_step1: bool = True,
):
    """Upstream PharmacoNet without its __init__ (which downloads and loads
    model.tar): exactly the attributes create_density_maps reads (upstream
    module.py:82-110).

    force_step1: upstream's segmentation micro-batch choice
    `if self.device == "cpu": step = 1` (module.py:261-264) compares a
    torch.device with a str, which is False on every torch version
    upstream supports, so production runs always take the step=4 batched
    path, which adds each box's point feature at every box's position of
    the chunk (mask_head.py:193-195). force_step1=True runs upstream through
    a subclass whose `device` is the string "cpu": the per-hotspot path,
    the semantics both packages implement. False gives upstream's actual
    production behaviour."""
    from pmnet.utils.smoothing import GaussianSmoothing  # noqa: PLC0415

    cls = ref_module.PharmacoNet
    if force_step1:

        class _Step1PharmacoNet(cls):  # type: ignore[misc,valid-type]
            @property
            def device(self):
                return "cpu"

        cls = _Step1PharmacoNet
    ref = cls.__new__(cls)
    ref.model = torch_model
    ref.smoothing = GaussianSmoothing(kernel_size=5, sigma=0.5)
    ref.score_distributions = {t: np.asarray(d) for t, d in distributions.items()}
    ref.focus_threshold = 0.5
    ref.box_threshold = 0.5
    if score_threshold is None:
        ref.score_threshold = dict(ref_module.DEFAULT_SCORE_THRESHOLD)
    elif isinstance(score_threshold, dict):
        ref.score_threshold = score_threshold
    else:
        ref.score_threshold = {t: float(score_threshold) for t in ref.score_distributions}
    ref.logger = None
    return ref


def reference_protein_data(pocket, device="cpu"):
    """The port's parsed ProteinData -> upstream's (image, mask, token_pos,
    tokens) tuple on the CPU, voxelized by the port's voxelizer on `device`
    (K6 on a card, its plain version on the CPU) so both sides consume the
    same tensors (parser.py:101-106 contract)."""
    import torch

    from ..ops.voxelize_cuda import voxelize_pallas

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        pocket.atom_positions, pocket.atom_features, pocket.atom_valid, pocket.center)]
    image, occupancy = (t.cpu() for t in voxelize_pallas(*args))
    ntok = int(pocket.token_valid.sum())
    image_t = image.permute(3, 0, 1, 2).contiguous()
    mask_t = (~occupancy)[None]
    token_pos = torch.from_numpy(np.asarray(pocket.token_positions, dtype=np.float32))
    tokens = torch.from_numpy(pocket.tokens[:ntok].astype(np.int64))
    return (image_t, mask_t, token_pos, tokens)


# --------------------------------------------------------------------------
# Stage diffs (return report dicts; raise_on_fail turns them into asserts)
# --------------------------------------------------------------------------
def _np(x):
    return np.asarray(x.cpu().numpy() if hasattr(x, "cpu") else x)


def compare_hotspot_infos(
    ours: list[dict], theirs: list[dict], map_atol: float = 1e-4,
    raise_on_fail: bool = True, max_flip_voxels: int = 0,
) -> dict:
    """max_flip_voxels: budget (across all maps) for voxels present in only
    one side's thresholded map. With real (non-integer) weights a handful
    of voxels sit within f32 cross-backend noise of the 0.5 gate, and a
    flipped voxel reports its full density value as the diff. Values are
    still held at map_atol on the common support; the default budget of 0
    keeps integer-weight comparisons exact."""
    report: dict = {"ours": len(ours), "theirs": len(theirs), "mismatches": []}
    if len(ours) != len(theirs):
        report["mismatches"].append(f"hotspot count {len(ours)} vs {len(theirs)}")
    max_map = max_pos = 0.0
    flip_total = 0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        for key in ("nci_type", "hotspot_type", "point_type"):
            if a[key] != b[key]:
                report["mismatches"].append(f"hotspot {i} {key}")
        pos_d = float(np.abs(
            np.asarray(a["hotspot_position"], np.float64)
            - _np(b["hotspot_position"]).astype(np.float64)).max())
        max_pos = max(max_pos, pos_d)
        if pos_d > 1e-4:
            report["mismatches"].append(f"hotspot {i} position diff {pos_d:.2e}")
        if abs(a["hotspot_score"] - float(b["hotspot_score"])) > 1e-6:
            report["mismatches"].append(f"hotspot {i} rel score")
        am, bm = _np(a["point_map"]), _np(b["point_map"])
        support_a, support_b = am > 0, bm > 0
        flip_mask = support_a != support_b
        flips = int(flip_mask.sum())
        flip_total += flips
        common = support_a & support_b
        if flips and max_flip_voxels:
            # a flipped voxel was zeroed before smoothing on one side only,
            # shifting its 5^3 Gaussian neighbourhood: the halo leaves the
            # value check (the flip itself is budgeted above)
            from scipy import ndimage  # noqa: PLC0415

            halo = ndimage.binary_dilation(flip_mask, structure=np.ones((5, 5, 5), bool))
            common = common & ~halo
        map_d = float(np.abs(am - bm)[common].max()) if common.any() else 0.0
        max_map = max(max_map, map_d)
        if map_d > map_atol:
            report["mismatches"].append(
                f"hotspot {i} point_map diff {map_d:.2e} ({flips} support flips)")
    if flip_total > max_flip_voxels:
        report["mismatches"].append(
            f"{flip_total} support-flip voxels total (budget {max_flip_voxels})")
    report["max_point_map_diff"] = max_map
    report["max_position_diff"] = max_pos
    report["support_flip_voxels"] = flip_total
    if raise_on_fail and report["mismatches"]:
        raise AssertionError("; ".join(report["mismatches"][:10]))
    return report


GEOM_ATOL = 1e-3  # cross-side f32 summation-order jitter bound


def _node_sort_key(n):
    return (n.type, float(n.center[0]), float(n.center[1]), float(n.center[2]))


def compare_graphs(ours, theirs, raise_on_fail: bool = True) -> dict:
    """Node, edge and cluster comparison up to the canonical component
    order: both sides sorted by unrounded geometry (cross-side jitter ~1e-5
    is far below the spacing of nodes), paired numbers held to GEOM_ATOL."""
    report: dict = {
        "nodes": (len(ours.nodes), len(theirs.nodes)),
        "edges": (len(ours.edges), len(theirs.edges)),
        "clusters": (len(ours.node_clusters), len(theirs.node_clusters)),
        "mismatches": [],
    }

    def fail(msg):
        report["mismatches"].append(msg)

    a_nodes = sorted(ours.nodes, key=_node_sort_key)
    b_nodes = sorted(theirs.nodes, key=_node_sort_key)
    if len(a_nodes) != len(b_nodes):
        fail(f"node count {len(a_nodes)} vs {len(b_nodes)}")
    for i, (a, b) in enumerate(zip(a_nodes, b_nodes)):
        if a.type != b.type or a.interaction_type != b.interaction_type:
            fail(f"node {i} type")
            continue
        if np.abs(np.asarray(a.center, float) - np.asarray(b.center, float)).max() > GEOM_ATOL:
            fail(f"node {i} center")
        if abs(float(a.radius) - float(b.radius)) > GEOM_ATOL:
            fail(f"node {i} radius")
        if abs(float(a.score) - float(b.score)) > 1e-5:
            fail(f"node {i} score")

    def edge_records(model):
        recs = []
        for e in model.edges:
            i1, i2 = e.node_indices
            k1 = _node_sort_key(model.nodes[i1])
            k2 = _node_sort_key(model.nodes[i2])
            lo, hi = (k1, k2) if k1 <= k2 else (k2, k1)
            recs.append((lo, hi, float(e.distance_mean), float(e.distance_std)))
        return sorted(recs)

    a_edges, b_edges = edge_records(ours), edge_records(theirs)
    if len(a_edges) != len(b_edges):
        fail(f"edge count {len(a_edges)} vs {len(b_edges)}")
    for i, (a, b) in enumerate(zip(a_edges, b_edges)):
        ok = a[0][0] == b[0][0] and a[1][0] == b[1][0]
        ok = ok and np.abs(np.asarray(a[0][1:]) - np.asarray(b[0][1:])).max() <= GEOM_ATOL
        ok = ok and np.abs(np.asarray(a[1][1:]) - np.asarray(b[1][1:])).max() <= GEOM_ATOL
        ok = ok and abs(a[2] - b[2]) <= GEOM_ATOL and abs(a[3] - b[3]) <= GEOM_ATOL
        if not ok:
            fail(f"edge {i}")

    def cluster_records(model):
        return sorted(
            (
                c.type,
                tuple(sorted(_node_sort_key(model.nodes[i]) for i in c.node_indices)),
                tuple(float(v) for v in c.center),
                float(c.size),
            )
            for c in model.node_clusters
        )

    a_cl, b_cl = cluster_records(ours), cluster_records(theirs)
    if len(a_cl) != len(b_cl):
        fail(f"cluster count {len(a_cl)} vs {len(b_cl)}")
    for i, (a, b) in enumerate(zip(a_cl, b_cl)):
        ok = a[0] == b[0] and len(a[1]) == len(b[1])
        for ka, kb in zip(a[1], b[1]):
            ok = ok and ka[0] == kb[0]
            ok = ok and np.abs(np.asarray(ka[1:]) - np.asarray(kb[1:])).max() <= GEOM_ATOL
        ok = ok and np.abs(np.asarray(a[2]) - np.asarray(b[2])).max() <= GEOM_ATOL
        ok = ok and abs(a[3] - b[3]) <= GEOM_ATOL
        if not ok:
            fail(f"cluster {i}")

    if raise_on_fail and report["mismatches"]:
        raise AssertionError("; ".join(report["mismatches"][:10]))
    return report
