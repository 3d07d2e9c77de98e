"""The probe kernels P1-P4 of pharmaconet_tpu_torch against the repo's
probe scripts.

Each plain torch twin (ops/screen_ref.py, reached through the wrappers of
ops/screen_cuda.py on CPU tensors) is held against the probe's own Pallas
body, run in interpret mode: the needed function definitions are parsed
out of probes/probe_pallas_screen.py, probes/probe_fused_split.py and
probes/probe_kernel_r3.py with `ast` and executed in a namespace that
supplies the globals they close over (their module-level set-up, which
drives a TPU, never runs). Inputs come from numpy seeds through the port's
probe prep (24 ligands). Pass counts and -1 masks must be equal, scores
within rtol 2e-5 / atol 1e-4. The CUDA kernels are held against these
twins on the card in tests/test_torch_kernels.py, which imports no JAX.
"""

from __future__ import annotations

import ast
import functools
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pharmaconet_tpu.ops import screen_pallas as jsp
from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
from pharmaconet_tpu_torch.probes import prep
from pharmaconet_tpu_torch.scoring.screen_tiles import NODE_CAP, TILE, tile_distances

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 1e-4
N_LIGANDS = 24
PL_INTERPRET = types.SimpleNamespace(
    pallas_call=functools.partial(pl.pallas_call, interpret=True),
    GridSpec=pl.GridSpec, BlockSpec=pl.BlockSpec,
)


def probe_namespace(script: str, names: tuple[str, ...], **closure) -> dict:
    """Execute only the named function definitions of probes/<script> in a
    namespace holding the globals they close over; pallas_call interprets."""
    path = REPO / "probes" / script
    tree = ast.parse(path.read_text())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(d.name for d in defs) == sorted(names)
    ns = dict(jax=jax, jnp=jnp, pl=PL_INTERPRET, pltpu=pltpu, **closure)
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(path), "exec"), ns)
    return ns


def assert_scores_close(got, want, c: int | None = None) -> None:
    """-1 masks equal, scores within the repo tolerance; with `c`, rows
    [c, 2c) are pass counts and must be equal."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == -1.0, want == -1.0)
    if c is not None:
        np.testing.assert_array_equal(got[c:], want[c:])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(c: int):
    """The probes' untiled row inputs: the headline workload's generators
    at 24 ligands with `c` conformers."""
    rb = prep.row_batch(*prep.headline_inputs(N_LIGANDS, num_conformers=c))
    return rb, prep.gather_inputs(rb), prep.local_tables(rb)


@pytest.fixture(scope="module")
def rows4():
    return _rows(4)


@pytest.fixture(scope="module")
def tiled4():
    pm, ligands = prep.headline_inputs(N_LIGANDS)
    return prep.tiled_inputs(pm, ligands)


def _tables(rb):
    return [_t(rb.muT), _t(rb.invT), _t(rb.winvT)]


# --------------------------------------------------------------------------
# prep
# --------------------------------------------------------------------------
@pytest.mark.parametrize("c", [2, 4, 8])
def test_prep_tables_index_back(c, rows4):
    """Each tile's node table is sorted and unique, u_loc/v_loc index back
    to the rows' global nodes, pos_blocks holds those nodes' positions, and
    d_table[slot] is each row's distance."""
    rb, gi, lt = rows4 if c == 4 else _rows(c)
    assert lt.overflow == 0 and 0 < lt.max_union <= NODE_CAP  # no table cut
    t_count = rb.ns_t // TILE
    assert lt.pos_blocks.shape == (t_count, 3 * c, NODE_CAP)
    assert lt.uv_loc.shape == (2, rb.ns_t) and lt.uv_loc.dtype == np.int32
    assert gi.slots.shape == (rb.ns_t,) and gi.slots.dtype == np.int32
    u, v = lt.uv_loc.reshape(2, t_count, TILE)
    for t in range(t_count):
        sl = slice(t * TILE, (t + 1) * TILE)
        used = np.unique(np.concatenate([lt.gu[sl], lt.gv[sl]]))
        np.testing.assert_array_equal(lt.tile_nodes[t, : len(used)], used)
        np.testing.assert_array_equal(lt.tile_nodes[t][u[t]], lt.gu[sl])
        np.testing.assert_array_equal(lt.tile_nodes[t][v[t]], lt.gv[sl])
    pos = rb.batch.node_pos.reshape(-1, c, 3)
    np.testing.assert_array_equal(
        lt.pos_blocks[1, :, 3], pos[lt.tile_nodes[1, 3]].reshape(3 * c))
    real = rb.ns_real
    want = np.linalg.norm(pos[lt.gu[:real]] - pos[lt.gv[:real]], axis=-1)
    np.testing.assert_array_equal(gi.d_table[gi.slots[:real]], want.astype(np.float32))


# --------------------------------------------------------------------------
# P1 and P2 (probe_pallas_screen.py)
# --------------------------------------------------------------------------
def _screen_probe(rb) -> dict:
    return probe_namespace(
        "probe_pallas_screen.py",
        ("gather_kernel", "make_gather_fn", "onehot_kernel", "make_onehot_fn"),
        T=rb.ns_t // TILE, TILE=TILE, ns_t=rb.ns_t, BLOCK_P=8, NODE_CAP=NODE_CAP,
    )


def _sublanes(*rows) -> np.ndarray:
    """The probe's [8, ns_t] i32 index rows (rows past the given ones 0)."""
    out = np.zeros((8, len(rows[0])), np.int32)
    for i, r in enumerate(rows):
        out[i] = r
    return out


def test_p1_gather_matches_probe_body(rows4):
    rb, gi, _ = rows4
    f = _screen_probe(rb)["make_gather_fn"]()
    want = f(jnp.asarray(gi.d_table), jnp.asarray(_sublanes(gi.slots)),
             jnp.asarray(rb.muT), jnp.asarray(rb.invT), jnp.asarray(rb.winvT))
    got = screen_cuda.gaussian_phase_gather(_t(gi.d_table), _t(gi.slots), *_tables(rb))
    assert got.shape == (8, rb.ns_t)
    assert_scores_close(got, want, c=4)
    assert (got[:4] > 0).any() and (got[4:] > 0).any()


def test_p2_local_matches_probe_body(rows4):
    rb, _, lt = rows4
    f = _screen_probe(rb)["make_onehot_fn"]()
    want = f(jnp.asarray(lt.pos_blocks), jnp.asarray(_sublanes(*lt.uv_loc)),
             jnp.asarray(rb.muT), jnp.asarray(rb.invT), jnp.asarray(rb.winvT))
    uv = _t(lt.uv_loc)
    got = screen_cuda.gaussian_phase_local(_t(lt.pos_blocks), uv[0], uv[1], *_tables(rb))
    assert_scores_close(got, want, c=4)


@pytest.mark.parametrize("c", [2, 8])
def test_p1_p2_match_k5_at_other_conformer_counts(c):
    """At conformer counts the probe bodies cannot take (they hard-code 4),
    P1 and P2 equal K5's plain version on the same untiled rows (K5 reads
    the same node tables through packed u * NODE_CAP + v)."""
    rb, gi, lt = _rows(c)
    tables = _tables(rb)
    uv = _t(lt.uv_loc)
    want = screen_ref.gaussian_phase(
        _t(lt.pos_blocks), (uv[0] * NODE_CAP + uv[1])[None], *tables)
    assert want.shape == (2 * c, rb.ns_t)
    assert_scores_close(
        screen_cuda.gaussian_phase_local(_t(lt.pos_blocks), uv[0], uv[1], *tables), want, c=c)
    assert_scores_close(
        screen_cuda.gaussian_phase_gather(_t(gi.d_table), _t(gi.slots), *tables), want, c=c)


# --------------------------------------------------------------------------
# P3 (probe_fused_split.py) and P4 (probe_kernel_r3.py)
# --------------------------------------------------------------------------
def _fused_probe(script: str, ti) -> dict:
    t, threec, cap = ti.pos_blocks.shape
    return probe_namespace(
        script, ("make_kernel",), T=t, THREEC=threec, CAP=cap, C=threec // 3, TILE=TILE,
        D1=ti.depth1, D2=ti.depth2, BLOCK_P=jsp.BLOCK_P, sp=jsp,
    )


def _probe_rows(script: str, ti, mode: str) -> np.ndarray:
    """The probe kernel's [C, T*TILE] output as [T*TILE, C] rows."""
    kernel = _fused_probe(script, ti)["make_kernel"](mode)
    t = ti.pos_blocks.shape[0]
    out = kernel(jnp.asarray(ti.pos_blocks), jnp.asarray(ti.uv.reshape(t, 1, TILE)),
                 jnp.asarray(ti.gtab), jnp.asarray(ti.aux))
    return np.asarray(out).T


@pytest.mark.parametrize("mode", screen_ref.ABLATIONS)
def test_p3_ablation_matches_probe_body(tiled4, mode):
    want = _probe_rows("probe_fused_split.py", tiled4, mode)
    x = [_t(a) for a in tiled4.arrays]
    got = screen_cuda.score_tiles_fused_ablation(*x, tiled4.depth1, tiled4.depth2, mode)
    assert got.shape == (x[0].shape[0] * TILE, 4)
    assert_scores_close(got, want)
    if mode == "full":
        assert (want == -1.0).any() and (want > 0).any()
        k1 = jsp.score_tiles_fused_rows(*(jnp.asarray(a) for a in tiled4.arrays),
                                        depth1=tiled4.depth1, depth2=tiled4.depth2,
                                        interpret=True)
        np.testing.assert_array_equal(want, np.asarray(k1))  # the probe's full is K1


@pytest.mark.parametrize("mode", screen_ref.VARIANTS)
def test_p4_variant_matches_probe_body(tiled4, mode):
    want = _probe_rows("probe_kernel_r3.py", tiled4, mode)
    x = [_t(a) for a in tiled4.arrays]
    d = (tiled4.depth1, tiled4.depth2)
    assert_scores_close(screen_cuda.score_tiles_fused_variant(*x, *d, mode), want)
    assert_scores_close(screen_ref.score_tiles_fused_rows(*x, *d), want)


def test_p4_distances_match_the_store_distances(tiled4):
    """ohbf16's distances (plain version on the CPU) are the prepack-time
    distances of the same tiles, to the ulp: torch's vectorised CPU sqrt is
    not correctly rounded, numpy's and the kernel's are (the card's test
    below holds the kernel to bit-equality)."""
    x = [_t(a) for a in tiled4.arrays]
    _, dist = screen_cuda.score_tiles_fused_variant(
        *x, tiled4.depth1, tiled4.depth2, "ohbf16", return_distances=True)
    want = tile_distances(tiled4.pos_blocks, tiled4.uv, native=False)
    assert dist.shape == want.shape
    np.testing.assert_allclose(dist.numpy(), want, rtol=1.2e-7, atol=0)


def test_probe_wrappers_refuse_bad_arguments(tiled4):
    x = [_t(a) for a in tiled4.arrays]
    with pytest.raises(ValueError, match="unknown ablation"):
        screen_cuda.score_tiles_fused_ablation(*x, 1, 3, "noselect")
    with pytest.raises(ValueError, match="unknown variant"):
        screen_cuda.score_tiles_fused_variant(*x, 1, 3, "ohf32")
    with pytest.raises(ValueError, match="only the ohbf16"):
        screen_cuda.score_tiles_fused_variant(*x, 1, 3, "full", return_distances=True)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["probe_pallas_screen", "probe_fused_split",
                                  "probe_kernel_r3"])
def test_probe_entry_point_on_cpu(name, capsys, monkeypatch):
    """Each probe runs end to end on the CPU (plain versions, host clock)
    and ends with its JSON line of launch counts (none on the CPU) and of
    its kernels' times, by chip_smoke's kernel names."""
    import importlib

    from pharmaconet_tpu_torch.probes import timing

    monkeypatch.setattr(timing, "REPS", 1)
    monkeypatch.setattr(timing, "ROUNDS", 1)
    probe = importlib.import_module(f"pharmaconet_tpu_torch.probes.{name}")
    assert probe.main(["--device", "cpu", "--ligands", str(N_LIGANDS)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device: cpu")
    last = json.loads(lines[-1])
    assert last["probe"] == name and last["device"] == "cpu"
    assert set(last["launches"]) == set(probe.KERNELS)
    assert not any(last["launches"].values()) and not any(last["mode_launches"].values())
    timed = set(last["mode_launches"]) or set(probe.KERNELS)
    assert set(last["times"]) == timed
    for t in last["times"].values():
        assert t["ms"] > 0
        assert t["stream_ms"] is None and t["enqueue_ms"] is None and t["gapless"] is None
    assert any("ms/batch (host clock)" in line for line in lines)


def test_probe_entry_point_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from pharmaconet_tpu_torch.probes import probe_fused_split

    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_fused_split.main(["--ligands", "4"])


def test_probe_voxelize_needs_a_card(capsys):
    """K6's split probe has nothing to split on the CPU: it exits 2 and
    says so; its pocket is the modeling path's (the 4096 atom bucket)."""
    from pharmaconet_tpu_torch.probes import probe_voxelize

    assert probe_voxelize.main(["--device", "cpu"]) == 2
    assert "needs a card" in capsys.readouterr().err
    pos, feats, valid, center = probe_voxelize.pocket_atoms(torch.device("cpu"))
    assert pos.shape == (4096, 3) and feats.shape == (4096, 33) and int(valid.sum()) == 3005
    assert center.shape == (3,)


# --------------------------------------------------------------------------
# sass_compare: the parsers (the builds need the CUDA toolkit)
# --------------------------------------------------------------------------
NEW_K1 = ("_ZN48_GLOBAL__N__2f4b057d_15_screen_fused_cu_450262dd"
          "18screen_tile_kernelILi4ELi1ELi0EEEvNS_8TileArgsE")
OLD_K1 = "_ZN48_GLOBAL__N__0a1b2c3d_15_screen_fused_cu_9e8f7a6b18screen_tile_kernelILi4ELi1EEEvNS_8TileArgsE"
SASS = """
\tcode for sm_90a
\t\tFunction : {name}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/              @!P0 BRA 0x{target} ;                /* 0x0000000000007919 */
"""
PTXAS = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    16 bytes stack frame, 20 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes cumulative stack size
"""


@pytest.mark.parametrize("mangled,key", [
    (NEW_K1, "screen_tile_kernel<4, 1, 0>"),
    (OLD_K1, "screen_tile_kernel<4, 1, 0>"),  # before the FLAGS parameter
    ("_ZN48_GLOBAL__N__2f4b057d_15_screen_fused_cu_450262dd14v3_tile_kernelILi8EEEvNS_6V3ArgsE",
     "v3_tile_kernel<8>"),
    ("_Z15voxelize_kernelPKfS0_PKbPfPh", "voxelize_kernel"),
    ("_Z6helperv", None),
])
def test_sass_compare_kernel_key(mangled, key):
    from pharmaconet_tpu_torch.probes.sass_compare import kernel_key

    assert kernel_key(mangled) == key


def test_sass_compare_parses_and_compares():
    from pharmaconet_tpu_torch.probes.sass_compare import compare, parse_ptxas, parse_sass

    old, new, moved = {}, {}, {}
    for kernels, name, target in ((old, OLD_K1, "190"), (new, NEW_K1, "190"),
                                  (moved, NEW_K1, "1a0")):
        parse_ptxas(PTXAS.format(name=name), kernels)
        parse_sass(SASS.format(name=name, target=target), kernels)
    k = new["screen_tile_kernel<4, 1, 0>"]
    assert k.instructions == ["LDC R1, c[0x0][0x28]", "@!P0 BRA 0x190"]
    assert (k.registers, k.spill_stores, k.spill_loads) == (64, 20, 12)
    same = compare(old, new)
    assert (same["kernels"], same["same"], same["differ"], same["missing"]) == (1, 1, [], [])
    assert "same code (2 -> 2 instructions), registers 64 -> 64" in same["rows"][0]
    assert compare(old, moved)["differ"] == ["screen_tile_kernel<4, 1, 0>"]
    assert compare(old, {})["missing"] == ["screen_tile_kernel<4, 1, 0>"]
