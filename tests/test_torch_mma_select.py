"""P4 ohbf16's node selection on the tensor cores, modelled in torch.

The kernels (csrc/screen_fused.cu: the first design's mma.sync and the
second's wgmma) select each row's node positions as a product: the exact
three-way bf16 split of the tile's node table (hi, mid, lo, truncating),
the unsigned one-hot of the row's slot times each part, summed
(hi + mid) + lo. `screen_ref.split_bf16` / `mma_select_positions` /
`mma_row_distances` model that arithmetic in f32 on the CPU. Here the model
is held, bit for bit, to direct indexing of the node table on the headline
tiles (2048 ligands x 4 conformers) and on the inputs that
tests/test_torch_probes.py runs the JAX probe body on (24 ligands), and the
rows scored from its distances to that probe body's ohbf16 rows (repo
tolerance). The split reconstructs every value of its domain exactly
(hypothesis): ±0 and finite |x| >= 2^-110 (-0 comes back +0, the same
value, which no distance tells apart). Below 2^-110 the lowest part
can fall under bf16's subnormals and lose bits; every f32 subnormal (such
as 1e-40) is there. The packers write Å coordinates and zero padding
(native/pack_tiled.cpp), far inside the domain. The card's tests
(tests/test_torch_kernels.py, `gpu`) hold the kernels to K1 bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pharmaconet_tpu_torch.ops import screen_cuda, screen_ref
from pharmaconet_tpu_torch.probes import prep
from pharmaconet_tpu_torch.scoring.screen_tiles import NODE_CAP, TILE, tile_distances

CHUNK = 64  # tiles per one-hot product (a [64, 1024, 64] f32 one-hot is 16 MiB)
SPLIT_MIN = 2.0**-110  # the smallest magnitude whose split is exact for every value


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small products: one OpenMP thread each, so the suite's workers
    do not crowd the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def headline_tiles():
    return prep.tiled_inputs(*prep.headline_inputs(), threads=4)


@pytest.fixture(scope="module")
def tiled4():
    """tests/test_torch_probes.py's `tiled4`: the JAX probe body's inputs."""
    return prep.tiled_inputs(*prep.headline_inputs(24))


def _assert_selection_is_indexing(pos_blocks: np.ndarray, uv: np.ndarray) -> None:
    """Both nodes' positions, by the model and by direct indexing, equal
    bit for bit (compared as int32), tile chunk by tile chunk."""
    for t0 in range(0, pos_blocks.shape[0], CHUNK):
        pos = torch.from_numpy(pos_blocks[t0 : t0 + CHUNK])
        uvl = torch.from_numpy(uv[t0 : t0 + CHUNK]).long()
        for slots in (uvl // NODE_CAP, uvl % NODE_CAP):
            got = screen_ref.mma_select_positions(pos, slots)
            want = torch.gather(pos, 2, slots[:, None, :].expand(-1, pos.shape[1], -1))
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_model_selects_exactly_on_the_headline_tiles(headline_tiles):
    ti = headline_tiles
    assert ti.pos_blocks.shape[0] > 1000 and ti.pos_blocks.shape[1] == 12
    _assert_selection_is_indexing(ti.pos_blocks, ti.uv)


def test_model_distances_on_the_headline_tiles(headline_tiles):
    """The model's distances are the plain version's bit for bit (the same
    positions through the same torch ops), and the prepack-time distances
    (numpy, correctly rounded) to the ulp: torch's vectorised CPU sqrt is
    not correctly rounded, the kernels' is."""
    ti = headline_tiles
    for t0 in range(0, ti.pos_blocks.shape[0], 4 * CHUNK):
        pos = torch.from_numpy(ti.pos_blocks[t0 : t0 + 4 * CHUNK])
        uv = torch.from_numpy(ti.uv[t0 : t0 + 4 * CHUNK])
        got = screen_ref.mma_row_distances(pos, uv)
        assert torch.equal(got, screen_ref.packed_row_distances(pos, uv))
        want = tile_distances(pos.numpy(), uv.numpy(), native=False)
        np.testing.assert_allclose(got.numpy(), want, rtol=1.2e-7, atol=0)


def test_model_selects_exactly_on_the_probe_inputs(tiled4):
    _assert_selection_is_indexing(tiled4.pos_blocks, tiled4.uv)


@pytest.mark.parametrize("c", [1, 3, 8])
def test_model_selects_exactly_at_other_conformer_counts(c):
    ti = prep.tiled_inputs(*prep.headline_inputs(24, num_conformers=c))
    assert ti.pos_blocks.shape[1] == 3 * c
    _assert_selection_is_indexing(ti.pos_blocks, ti.uv)


def test_model_rows_match_the_jax_probe_body(tiled4):
    """K1's rows scored from the model's distances (K3's plain version takes
    the distances as given) against the JAX probe body's `ohbf16` rows
    (interpret mode), within the repo tolerance: the probe's signed one-hot
    rounds inside its MMA, so not bit for bit."""
    from test_torch_probes import _probe_rows, assert_scores_close

    want = _probe_rows("probe_kernel_r3.py", tiled4, "ohbf16")
    x = [torch.from_numpy(a) for a in tiled4.arrays]
    dist = screen_ref.mma_row_distances(x[0], x[1])
    got = screen_ref.score_tiles_fused_dt_rows(dist, x[2], x[3], tiled4.depth1, tiled4.depth2)
    assert_scores_close(got, want)
    assert (want == -1.0).any() and (want > 0).any()


def test_padded_slots_never_contribute():
    """A node table zero-padded above its real slots: a real slot's
    selection over all 64 slots equals its selection over the real slots
    alone, bit for bit, and a padded slot selects 0."""
    rng = np.random.default_rng(5)
    real = 40
    pos = np.zeros((3, 12, NODE_CAP), dtype=np.float32)
    pos[:, :, :real] = rng.normal(scale=6.0, size=(3, 12, real))
    slots = torch.from_numpy(rng.integers(0, NODE_CAP, size=(3, TILE)))
    full = screen_ref.mma_select_positions(torch.from_numpy(pos), slots)
    inside = slots < real
    cut = screen_ref.mma_select_positions(torch.from_numpy(pos[:, :, :real].copy()),
                                          torch.where(inside, slots, 0), cap=real)
    mask = inside[:, None, :].expand_as(full)
    assert inside.any() and (~inside).any()
    assert torch.equal(full[mask].view(torch.int32), cut[mask].view(torch.int32))
    assert torch.equal(full[~mask], torch.zeros(int((~mask).sum())))


def _split_domain():
    """±0 and finite f32 of magnitude >= 2^-110 (see the module docstring)."""
    return st.floats(width=32, allow_nan=False, allow_infinity=False).filter(
        lambda v: v == 0.0 or abs(v) >= SPLIT_MIN)


@settings(max_examples=300, deadline=None)
@given(st.lists(_split_domain(), min_size=1, max_size=64))
def test_split_reconstructs_exactly(values):
    x = torch.tensor(values, dtype=torch.float32)
    hi, mid, lo = screen_ref.split_bf16(x)
    for part in (hi, mid, lo):  # each part is a bf16 value
        assert not bool((part.view(torch.int32) & 0xFFFF).any())
    got = (hi + mid) + lo
    assert torch.equal(got, x)  # -0 comes back +0: equal as a value, not in its bits
    nz = x != 0
    assert torch.equal(got[nz].view(torch.int32), x[nz].view(torch.int32))


def test_split_domain_edge():
    """At the domain's edge: 2^-110 with its lowest bit set splits exactly,
    a value just below loses its lowest bit, and so does a subnormal."""
    x = torch.tensor([SPLIT_MIN], dtype=torch.float32)
    edge = (x.view(torch.int32) | 1).view(torch.float32)
    below = (torch.tensor([SPLIT_MIN / 2], dtype=torch.float32).view(torch.int32) | 1).view(
        torch.float32)
    for v, exact in ((edge, True), (below, False),
                     (torch.tensor([1e-40], dtype=torch.float32), False)):
        hi, mid, lo = screen_ref.split_bf16(v)
        assert torch.equal((hi + mid) + lo, v) == exact, float(v)


@pytest.mark.parametrize("c", range(1, 9))
def test_stage_slots_fit_the_warps_scan_rows(c):
    """The second design stages a 16-row half's 3C differences per row in
    the warp's own rows of scan1 (csrc stage_slot): 2C + 1 chunks of 32
    floats. Every (row, column) gets its own float inside them, an
    accumulator store (lanes g, q at fixed n8 tile and element) hits 32
    banks, and the 16 lanes that read one column hit 16."""
    def slot(rho: int, col: int) -> int:
        chunk = col >> 1
        return chunk * TILE + ((((col & 1) << 4) + rho + 8 * (chunk & 3)) & 31)

    k3 = 3 * c
    slots = {slot(rho, col) for rho in range(16) for col in range(k3)}
    assert len(slots) == 16 * k3
    assert max(s // TILE for s in slots) < 2 * c + 1 and all(s % TILE < 32 for s in slots)
    for nt in range(-(-k3 // 8)):
        for e in range(4):
            banks = [slot(g + 8 * (e >> 1), 8 * nt + 2 * q + (e & 1)) % 32
                     for g in range(8) for q in range(4)]
            assert len(set(banks)) == 32
    for col in range(k3):
        assert len({slot(rho, col) % 32 for rho in range(16)}) == 16


def test_ohbf16_baseline_wrapper_on_cpu(tiled4):
    """The first design's wrapper takes the plain version on CPU tensors
    (K1's rows, the plain distances) and counts no launch; both designs
    have resource ids."""
    x = [torch.from_numpy(a) for a in tiled4.arrays]
    d = (tiled4.depth1, tiled4.depth2)
    screen_cuda.reset_launch_counts()
    rows, dist = screen_cuda.score_tiles_ohbf16_baseline(*x, *d, return_distances=True)
    assert torch.equal(rows, screen_ref.score_tiles_fused_rows(*x, *d))
    assert torch.equal(dist, screen_ref.packed_row_distances(x[0], x[1]))
    assert torch.equal(screen_cuda.score_tiles_ohbf16_baseline(*x, *d), rows)
    assert not any(screen_cuda.LAUNCHES.values())
    assert {"score_tiles_fused_variant[ohbf16]", "score_tiles_ohbf16_baseline"} <= \
        set(screen_cuda.RESOURCE_IDS)
