"""The windowed form of the bounded segmented scan that the CUDA kernels K1
and K2 run inside each warp (csrc/screen_fused.cu `scan_rows`).

`screen_ref.scan_bounded_windows` scans each 32-row window from its own
rows and the 2^depth - 1 rows before it. It must equal the tile-wide
`scan_bounded_tile` bit for bit, and the JAX package's bounded scan, on
pair-aligned segment layouts as the packers make them: every tile starts a
segment, no segment crosses a tile, segments cross the 32-row windows, and
none is longer than 2^depth rows.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pharmaconet_tpu.scoring import batch_screen as jbs
from pharmaconet_tpu_torch.ops import screen_ref

TILE = 1024
WARP = 32


def segment_starts(rng: np.random.Generator, tiles: int, depth: int) -> np.ndarray:
    """[tiles * TILE] bool: segment starts, one at every tile start, the
    segments 1..2^depth rows long and cut at the tile's end."""
    starts = np.zeros(tiles * TILE, dtype=bool)
    for first in range(0, tiles * TILE, TILE):
        pos = first
        while pos < first + TILE:
            starts[pos] = True
            pos += int(rng.integers(1, (1 << depth) + 1))
    return starts


def window_crossings(starts: np.ndarray) -> int:
    """Segments that run over a 32-row window boundary."""
    inner = np.arange(WARP, starts.size, WARP)
    return int((~starts[inner]).sum())


def scans(seed: int, tiles: int, rows: int, depth: int):
    """(windowed, tile-wide, values, starts) on one random layout."""
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(tiles, rows, TILE)).astype(np.float32)
    starts = segment_starts(rng, tiles, depth)
    v = torch.from_numpy(val)
    s = torch.from_numpy(starts.astype(np.float32)).reshape(tiles, TILE)
    return (screen_ref.scan_bounded_windows(v, s, depth),
            screen_ref.scan_bounded_tile(v, s, depth), val, starts)


@pytest.mark.parametrize("depth", range(8))
def test_windows_equal_the_tile_scan(depth):
    """Every depth the packers give, including those whose window exceeds
    a warp (the kernels scan those block-wide; the decomposition holds with
    the longer halo all the same)."""
    got, want, _, starts = scans(depth, 2, 8, depth)
    assert depth == 0 or window_crossings(starts) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("depth", range(1, 6))
def test_windows_equal_the_jax_scan(depth):
    """The JAX package's whole-row bounded scan over the tiles laid end to
    end (each tile starts a segment) on the same numpy inputs."""
    got, _, val, starts = scans(100 + depth, 2, 4, depth)
    t, r, _ = val.shape
    want = jbs._bounded_segmented_scan(
        jnp.asarray(val.transpose(1, 0, 2).reshape(r, t * TILE)), jnp.asarray(starts), depth)
    rows = got.permute(1, 0, 2).reshape(r, t * TILE).numpy()
    np.testing.assert_array_equal(rows, np.asarray(want))


@settings(max_examples=40, deadline=None)
@given(depth=st.integers(1, 5), c=st.integers(1, 8), seed=st.integers(0, 2**32 - 1))
def test_windows_equal_the_tile_scan_on_random_layouts(depth, c, seed):
    """The depths the kernels scan inside a warp, over the 2C stacked rows
    of C = 1..8 conformers."""
    got, want, _, starts = scans(seed, 1, 2 * c, depth)
    assert window_crossings(starts) > 0
    assert torch.equal(got, want)



@pytest.mark.parametrize("depth", range(1, 6))
def test_windows_reach_back_a_whole_segment(depth):
    """Segments of 2^depth rows that start one row after a tile start: the
    row at every window boundary adds the 2^depth - 1 rows before it, the
    whole halo (a halo one row shorter gives other sums here)."""
    rng = np.random.default_rng(depth)
    val = torch.from_numpy(rng.normal(size=(2, 8, TILE)).astype(np.float32))
    seen = torch.zeros(2, TILE)
    seen[:, 0] = 1.0
    seen[:, 1::1 << depth] = 1.0
    assert torch.equal(screen_ref.scan_bounded_windows(val, seen, depth),
                       screen_ref.scan_bounded_tile(val, seen, depth))
