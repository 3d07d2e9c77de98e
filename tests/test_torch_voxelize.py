"""The port's voxelizer (K6's plain version and its wrapper) against the
JAX package's `voxelize` and `voxelize_pallas` (interpret mode).

Tolerances: occupancy must be equal (it decides the protein mask, so the
same f32 distance arithmetic must give the same decisions); the image
within atol/rtol 1e-5, the bound the JAX package holds its Pallas kernel
to, since the sum over atoms runs in another order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pharmaconet_tpu.ops.voxelize import voxelize as jax_voxelize
from pharmaconet_tpu.ops.voxelize_pallas import voxelize_pallas as jax_voxelize_pallas
from pharmaconet_tpu_torch.ops import voxelize_cuda
from pharmaconet_tpu_torch.ops.voxelize import grid_coordinates, voxelize, voxelize_numpy

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
