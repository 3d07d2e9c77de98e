"""The port's voxelizer (K6's plain version, its wrapper and the CPU
emulation of the kernel's binning) against the JAX package's `voxelize` and
`voxelize_pallas` (interpret mode), and, on the card, K6 against its first
design and its plain version.

Tolerances: occupancy must be equal (it decides the protein mask, so the
same f32 distance arithmetic must give the same decisions); the image
within atol/rtol 1e-5, the bound the JAX package holds its Pallas kernel
to, since the sum over atoms runs in another order. On the card the
kernel's image must be bit-equal to its first design's (both add each
voxel's contributions in ascending atom order with the same roundings).
The machine with the card has no JAX: run the `gpu` tests there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_voxelize.py
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from pharmaconet_tpu_torch import constants as C
from pharmaconet_tpu_torch.ops import voxelize_cuda
from pharmaconet_tpu_torch.ops.voxelize import (
    STAGE_ENTRIES,
    bin_atoms_reference,
    grid_coordinates,
    tile_candidates_reference,
    tile_layout,
    voxelize,
    voxelize_binned,
    voxelize_numpy,
)

try:  # the JAX package (absent on the machine with the card)
    import jax.numpy as jnp

    from pharmaconet_tpu.ops.voxelize import voxelize as jax_voxelize
    from pharmaconet_tpu.ops.voxelize_pallas import voxelize_pallas as jax_voxelize_pallas
except ImportError:
    jnp = jax_voxelize = jax_voxelize_pallas = None

TOL = dict(atol=1e-5, rtol=1e-5)


def _system(seed: int, num_atoms: int, total: int, spread: float):
    """`num_atoms` random atoms (binary features, 33 channels) padded to
    `total` with invalid atoms at random positions."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-20, 20, 3).astype(np.float32)
    pos = (center + rng.uniform(-spread, spread, size=(total, 3))).astype(np.float32)
    feat = rng.integers(0, 2, size=(total, 33)).astype(np.float32)
    valid = np.zeros(total, dtype=bool)
    valid[:num_atoms] = True
    return pos, feat, valid, center


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dim,num_atoms,total,spread", [(16, 60, 512, 5.0), (32, 300, 1024, 9.0)])
def test_plain_matches_jax_voxelize(dim, num_atoms, total, spread):
    pos, feat, valid, center = _system(dim, num_atoms, total, spread)
    want_img, want_occ = jax_voxelize(*map(jnp.asarray, (pos, feat, valid, center)), dim=dim)
    img, occ = voxelize(*_torch(pos, feat, valid, center), dim=dim)
    assert img.shape == (dim, dim, dim, 33) and occ.dtype == torch.bool
    assert occ.any() and not occ.all()
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), **TOL)


def test_plain_matches_pallas_interpret():
    pos, feat, valid, center = _system(3, 40, 512, 4.0)
    want_img, want_occ = jax_voxelize_pallas(*map(jnp.asarray, (pos, feat, valid, center)),
                                             dim=16, interpret=True)
    img, occ = voxelize(*_torch(pos, feat, valid, center), dim=16)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), **TOL)


def test_plain_matches_numpy_loop():
    """Against the direct per-atom loop in f64 (atol/rtol 1e-4, the JAX
    package's bound for the same comparison); padded atoms reach nothing."""
    pos, feat, valid, center = _system(5, 50, 256, 6.0)
    want_img, want_occ = voxelize_numpy(pos[valid], feat[valid], center, dim=24)
    img, occ = voxelize(*_torch(pos, feat, valid, center), dim=24)
    np.testing.assert_array_equal(occ.numpy(), want_occ)
    np.testing.assert_allclose(img.numpy(), want_img, atol=1e-4, rtol=1e-4)


def test_grid_coordinates_match_jax():
    from pharmaconet_tpu.ops.voxelize import grid_coordinates as jax_grid

    center = np.array([1.25, -7.5, 30.125], np.float32)
    np.testing.assert_array_equal(grid_coordinates(torch.from_numpy(center), dim=8).numpy(),
                                  np.asarray(jax_grid(jnp.asarray(center), dim=8)))


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    pos, feat, valid, center = _system(7, 100, 512, 6.0)
    args = _torch(pos, feat, valid, center)
    voxelize_cuda.reset_launch_counts()
    img, occ = voxelize_cuda.voxelize_pallas(*args, dim=16)
    want_img, want_occ = voxelize(*args, dim=16)
    assert torch.equal(img, want_img) and torch.equal(occ, want_occ)
    assert voxelize_cuda.LAUNCHES["voxelize_pallas"] == 0  # no kernel launched


def test_wrapper_refuses_other_devices():
    meta = [torch.empty(s, device="meta") for s in ((512, 3), (512, 33))]
    meta += [torch.empty(512, dtype=torch.bool, device="meta"), torch.empty(3, device="meta")]
    with pytest.raises(ValueError, match="cuda or cpu"):
        voxelize_cuda.voxelize_pallas(*meta, dim=16)
    with pytest.raises(ValueError, match="several devices"):
        voxelize_cuda.voxelize_pallas(torch.empty(512, 3), *meta[1:], dim=16)


# --------------------------------------------------------------------------
# The kernel's binning (emulated on the CPU) and K6 on the card
# --------------------------------------------------------------------------
def _case(name: str):
    """(positions, features, valid, center) of one binning case."""
    if name == "random":  # atoms inside and outside the box, padding
        return _system(11, 300, 1024, 14.0)
    if name == "outside":  # every valid atom beyond the box's reach
        pos, feat, valid, center = _system(12, 200, 512, 3.0)
        return (pos + np.float32(40.0)), feat, valid, center
    if name == "no-valid":
        pos, feat, valid, center = _system(13, 0, 512, 6.0)
        return pos, feat, valid, center
    if name == "dense":  # 1500 atoms in a 1.4 A cube: column lists overflow the stage
        pos, feat, valid, center = _system(14, 1500, 1600, 0.7)
        return pos, feat, valid, center
    raise ValueError(name)


BINNING = [("random", 16), ("random", 40), ("random", 64), ("outside", 16), ("no-valid", 16),
           ("dense", 16), ("dense", 40)]
SEGMENTS = 32  # a tile size below the grid's width: z rows cut into segments


@pytest.mark.parametrize("tile_voxels", [voxelize_cuda.TILE_VOXELS, SEGMENTS],
                         ids=["kernel-tiles", "z-segments"])
@pytest.mark.parametrize("name,dim", BINNING, ids=[f"{n}-{d}" for n, d in BINNING])
def test_binning_is_an_ascending_superset(name, dim, tile_voxels):
    """Every column list ascends and holds valid atoms only; every voxel's
    warp candidates hold every valid atom within the larger radius of the
    voxel (the plain version's f32 distances); the tiles cover the grid.
    The dense cluster takes more than one staged round."""
    pos, _, valid, center = (torch.from_numpy(a) for a in _case(name))
    columns = bin_atoms_reference(pos, valid, center, dim=dim)
    reach2 = max(C.FEATURE_RADII, C.MASK_RADII) ** 2
    voxels = grid_coordinates(center, C.GRID_RESOLUTION, dim).reshape(dim, dim * dim, 3)
    rows, tiles_y, zlen, tiles_z = tile_layout(dim, tile_voxels)
    most_rounds, candidates, covered = 0, 0, 0
    for ix, column in enumerate(columns):
        assert bool((column[1:] > column[:-1]).all()) and bool(valid[column].all())
        for iy0, iz0 in itertools.product(range(0, tiles_y * rows, rows),
                                          range(0, tiles_z * zlen, zlen)):
            cand, rounds = tile_candidates_reference(column, pos, center, iy0, iz0, dim=dim,
                                                     tile_voxels=tile_voxels)
            assert rounds == -(-len(column) // STAGE_ENTRIES)
            most_rounds = max(most_rounds, rounds)
            flat0 = iy0 * dim + iz0  # the tile's voxels: one contiguous span
            v = voxels[ix, flat0 : flat0 + cand.shape[0]]
            assert cand.shape[0] == min(rows, dim - iy0) * min(zlen, dim - iz0)
            covered += cand.shape[0]
            d = v[:, None, :] - pos[None, :, :]
            d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            within = (d2 <= reach2) & valid[None, :]
            full = torch.zeros_like(within)
            full[:, column] = cand
            assert not bool((within & ~full).any()), (ix, iy0)
            candidates += int(cand.sum())
    assert covered == dim**3
    if name in ("outside", "no-valid"):
        assert candidates == 0
    else:
        assert candidates > 0
    assert (most_rounds > 1) == (name == "dense")


@pytest.mark.parametrize("dim", [16, 64])
def test_binned_voxelizer_matches_jax(dim):
    """Summing over the binned candidates alone gives JAX `voxelize`'s
    occupancy exactly and its image within 1e-5 (also with the dense
    cluster's multi-round lists at dim 16)."""
    for name in (("random", "dense") if dim == 16 else ("random",)):
        pos, feat, valid, center = _case(name)
        want_img, want_occ = jax_voxelize(*map(jnp.asarray, (pos, feat, valid, center)), dim=dim)
        img, occ = voxelize_binned(*_torch(pos, feat, valid, center), dim=dim)
        assert occ.any() and not occ.all()
        np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
        np.testing.assert_allclose(img.numpy(), np.asarray(want_img), **TOL)


@pytest.mark.parametrize("name", ["random", "dense", "no-valid"])
def test_binned_voxelizer_at_dim_40(name):
    """dim 40 (not a multiple of the tiles; the JAX `voxelize` takes no such
    grid): against the port's plain version and the f64 per-atom loop."""
    pos, feat, valid, center = _case(name)
    img, occ = voxelize_binned(*_torch(pos, feat, valid, center), dim=40)
    want_img, want_occ = voxelize(*_torch(pos, feat, valid, center), dim=40)
    assert torch.equal(occ, want_occ) and occ.any() == (name != "no-valid")
    torch.testing.assert_close(img, want_img, **TOL)
    np_img, np_occ = voxelize_numpy(pos[valid], feat[valid], center, dim=40)
    np.testing.assert_array_equal(occ.numpy(), np_occ)
    np.testing.assert_allclose(img.numpy(), np_img, atol=1e-4, rtol=1e-4)


def test_tile_layout():
    """Tiles of at most TILE_VOXELS voxels, each one contiguous span of a
    slab, cover it: whole z rows up to TILE_VOXELS, z segments beyond."""
    for dim in (1, 16, 40, 64, 100, 256, 300, 512):
        rows, tiles_y, zlen, tiles_z = tile_layout(dim)
        assert rows * zlen <= voxelize_cuda.TILE_VOXELS
        assert (tiles_y - 1) * rows < dim <= tiles_y * rows
        assert (tiles_z - 1) * zlen < dim <= tiles_z * zlen
        assert zlen == dim or rows == 1
    rows, tiles_y, zlen, tiles_z = tile_layout(64)
    assert rows * zlen == voxelize_cuda.TILE_VOXELS and zlen == 64 and tiles_z == 1


def test_binned_voxelizer_with_z_segments():
    """Tiles narrower than the grid (z rows cut into segments) against the
    plain version."""
    pos, feat, valid, center = _case("random")
    img, occ = voxelize_binned(*_torch(pos, feat, valid, center), dim=40, tile_voxels=SEGMENTS)
    want_img, want_occ = voxelize(*_torch(pos, feat, valid, center), dim=40)
    assert torch.equal(occ, want_occ) and occ.any()
    torch.testing.assert_close(img, want_img, **TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


GPU_CASES = BINNING + [("random", 1), ("dense", 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,dim", GPU_CASES, ids=[f"{n}-{d}" for n, d in GPU_CASES])
def test_cuda_k6_bit_equal_to_its_first_design(cuda, name, dim):
    """K6 against its first design (image and occupancy bit for bit) and
    the plain version (occupancy equal, image within 1e-5), one launch
    each, on every binning case: staged-list overflow, dim 40, no atoms."""
    args = [torch.from_numpy(a).to(cuda) for a in _case(name)]
    voxelize_cuda.reset_launch_counts()
    img, occ = voxelize_cuda.voxelize_pallas(*args, dim=dim)
    base_img, base_occ = voxelize_cuda.voxelize_pallas_baseline(*args, dim=dim)
    torch.cuda.synchronize()
    assert voxelize_cuda.LAUNCHES == {"voxelize_pallas": 1, "voxelize_pallas_baseline": 1}
    assert torch.equal(img, base_img) and torch.equal(occ, base_occ)
    want_img, want_occ = voxelize(*args, dim=dim)
    assert torch.equal(occ, want_occ)
    torch.testing.assert_close(img, want_img, **TOL)


@pytest.mark.gpu
def test_cuda_k6_zero_atoms_and_wide_grids(cuda):
    """An empty atom array gives zeros; a grid wider than a tile (z rows in
    segments) is bit-equal to the first design."""
    args = [torch.zeros((0, 3), device=cuda), torch.zeros((0, 33), device=cuda),
            torch.zeros(0, dtype=torch.bool, device=cuda), torch.zeros(3, device=cuda)]
    img, occ = voxelize_cuda.voxelize_pallas(*args, dim=16)
    assert not img.any() and not occ.any()
    args = [torch.from_numpy(a).to(cuda) for a in _system(15, 40, 64, 1.0)]
    dim = voxelize_cuda.TILE_VOXELS + 8
    img, occ = voxelize_cuda.voxelize_pallas(*args, dim=dim)
    base_img, base_occ = voxelize_cuda.voxelize_pallas_baseline(*args, dim=dim)
    assert occ.any() and torch.equal(occ, base_occ) and torch.equal(img, base_img)


@pytest.mark.gpu
def test_cuda_k6_resources(cuda):
    """Registers, shared memory and blocks per SM of both designs: the tile
    kernel does not spill, and its staged image fits with more than one
    block in flight per SM."""
    res = {k: voxelize_cuda.kernel_resources(k) for k in voxelize_cuda.RESOURCE_IDS}
    for name, r in res.items():
        assert r["blocks_per_sm"] >= 1 and r["registers"] <= 64, (name, r)
    tile = res["voxelize_pallas[tile]"]
    assert tile["local_bytes"] == 0  # no spills in the tile kernel
    assert tile["shared_bytes"] >= voxelize_cuda.TILE_VOXELS * 33 * 4
    assert tile["blocks_per_sm"] >= 2
