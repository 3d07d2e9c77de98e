"""The port's network modules against the JAX package's flax modules.

Each module is held against flax `apply` on the same numpy inputs, with
the flax parameters carried into the port by the checkpoint mapping
(`network.convert.torch_state_from_flax`, the rule `state_dict_from_flax`
applies to the whole network). The config exercises the shifted windows:
embed 8, depths (2, 2), heads (1, 2), window 2, token features 16, grid 16.

Tolerance: atol/rtol 1e-4 on f32 outputs. Both sides compute in full f32
on the CPU; they differ only in summation order inside matrix products,
convolutions and norms (relative differences of ~1e-6 per layer). The
deep backbone under random weights is held at 1e-3: flax's LayerNorm uses
the fast variance E[x^2] - E[x]^2, and the flax side itself lands ~5e-4
from a float64 evaluation there, while the port stays within 1e-4 of it
(checked in the test).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pharmaconet_tpu.network import fpn as jfpn
from pharmaconet_tpu.network import heads as jheads
from pharmaconet_tpu.network import layers as jlayers
from pharmaconet_tpu.network import swin3d as jswin
from pharmaconet_tpu.network.convert import convert_torch_state_dict
from pharmaconet_tpu.network.model import build_model as jax_build_model
from pharmaconet_tpu_torch.network import fpn, heads, layers, swin3d
from pharmaconet_tpu_torch.network.convert import (
    state_dict_from_flax,
    synthesize_torch_state_dict,
    torch_state_from_flax,
)
from pharmaconet_tpu_torch.network.model import build_model

SMALL = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window=2, token_feature_dim=16)
GRID = 16
TOL = dict(atol=1e-4, rtol=1e-4)


def _random_leaves(tree, rng):
    """A random value for every leaf of a flax parameter shape tree, so
    that a misplaced tensor shows: kernels ~ N(0, 1/fan_in), norm scales
    and variances in [0.5, 1.5], biases and means ~ N(0, 0.05)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_leaves(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "logit_scale":  # some heads above the log(100) clamp
            out[k] = (np.log(10.0) + rng.uniform(-1, 2.5, v.shape)).astype(np.float32)
        elif k in ("bias", "q_bias", "v_bias", "mean"):
            out[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
        else:
            fan_in = int(np.prod(v.shape[:-1])) if k != "embedding" else 1
            out[k] = rng.normal(0, fan_in**-0.5, v.shape).astype(np.float32)
    return out


def _init(flax_module, *inputs, seed=0):
    shapes = jax.eval_shape(flax_module.init, jax.random.PRNGKey(seed), *inputs)["params"]
    return {"params": _random_leaves(shapes, np.random.default_rng(seed))}


def _load(torch_module, params):
    torch_module.load_state_dict(torch_state_from_flax(torch_module, params["params"]),
                                 strict=True)
    return torch_module.eval()


def _ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_base_conv3d_and_fpn_match_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 6, 6, 5)).astype(np.float32)
    for kw in (dict(kernel_size=3), dict(kernel_size=1, use_norm=False, use_act=False)):
        jm = jlayers.BaseConv3d(features=7, **kw)
        params = _init(jm, x)
        tm = _load(layers.BaseConv3d(5, 7, **kw), params)
        _close(tm(_ncdhw(x)).permute(0, 2, 3, 4, 1), jm.apply(params, x))

    feats = [rng.normal(size=(1, s, s, s, c)).astype(np.float32)
             for s, c in ((8, 5), (4, 8), (2, 16))]
    jm = jfpn.FPNDecoder(feature_channels=(5, 8, 16), num_convs=(1, 2, 2), channels=8)
    params = _init(jm, feats)
    tm = _load(fpn.FPNDecoder((5, 8, 16), (1, 2, 2), 8), params)
    for got, want in zip(tm([_ncdhw(f) for f in feats]), jm.apply(params, feats)):
        _close(got.permute(0, 2, 3, 4, 1), want)


def test_window_attention_with_shift_mask_matches_flax():
    rng = np.random.default_rng(1)
    mask = swin3d.make_shift_attn_mask((4, 4, 4), 2, 1)
    np.testing.assert_array_equal(mask, jswin.make_shift_attn_mask((4, 4, 4), 2, 1))
    np.testing.assert_array_equal(swin3d.make_cpb_table(4), jswin.make_cpb_table(4))
    np.testing.assert_array_equal(swin3d.make_relative_position_index(4),
                                  jswin.make_relative_position_index(4))
    x = rng.normal(size=(2 * mask.shape[0], 8, 8)).astype(np.float32)
    jm = jswin.WindowAttention(dim=8, window=2, num_heads=2)
    params = _init(jm, x, jnp.asarray(mask))
    tm = _load(swin3d.WindowAttention(8, 2, 2), params)
    for m in (mask, None):
        _close(tm(torch.from_numpy(x), None if m is None else torch.from_numpy(m)),
               jm.apply(params, x, None if m is None else jnp.asarray(m)))


@pytest.mark.parametrize("resolution,shift", [((4, 4, 4), 1), ((4, 4, 4), 0), ((2, 2, 2), 1)],
                         ids=["shifted", "plain", "clamped"])
def test_swin_block_matches_flax(resolution, shift):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, int(np.prod(resolution)), 8)).astype(np.float32)
    jm = jswin.SwinBlock(dim=8, resolution=resolution, num_heads=2, window=2, shift=shift)
    params = _init(jm, x)
    tm = _load(swin3d.SwinBlock(8, resolution, 2, 2, shift), params)
    _close(tm(torch.from_numpy(x)), jm.apply(params, x))


def test_patch_merging_matches_flax():
    x = np.random.default_rng(3).normal(size=(2, 64, 8)).astype(np.float32)
    jm = jswin.PatchMerging(dim=8, resolution=(4, 4, 4))
    params = _init(jm, x)
    tm = _load(swin3d.PatchMerging(8, (4, 4, 4)), params)
    _close(tm(torch.from_numpy(x)), jm.apply(params, x))


def test_backbone_matches_flax():
    x = np.random.default_rng(4).normal(size=(1, GRID, GRID, GRID, 33)).astype(np.float32)
    kw = dict(image_size=GRID, embed_dim=8, depths=(2, 2), num_heads=(1, 2), window=2)
    jm = jswin.SwinTransformerV2_3D(**kw)
    params = _init(jm, x)
    tm = _load(swin3d.SwinTransformerV2_3D(**kw), params)
    exact = [o.permute(0, 2, 3, 4, 1).detach() for o in tm.double()(_ncdhw(x).double())]
    for got, want, ref in zip(tm.float()(_ncdhw(x)), jm.apply(params, x), exact):
        _close(got.permute(0, 2, 3, 4, 1), want, atol=1e-3, rtol=1e-3)
        _close(got.permute(0, 2, 3, 4, 1).double(), ref, atol=1e-4, rtol=1e-4)


def test_heads_match_flax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(1, 8, 8, 8, 8)).astype(np.float32)
    jm = jheads.CavityHead(feature_dim=8, hidden_dim=8)
    params = _init(jm, feats)
    tm = _load(heads.CavityHead(8, 8), params)
    for got, want in zip(tm(_ncdhw(feats)), jm.apply(params, feats)):
        _close(got.permute(0, 2, 3, 4, 1), want)

    tokens = np.concatenate([rng.integers(0, 8, size=(12, 3)), rng.integers(0, 10, size=(12, 1))],
                            axis=1).astype(np.int32)
    for token_dim in (16, 24):  # 2F == token_dim: identity skip; else a Linear skip
        jm = jheads.TokenHead(feature_dim=8, token_feature_dim=token_dim)
        params = _init(jm, feats[0], tokens)
        tm = _load(heads.TokenHead(8, 10, token_dim), params)
        for got, want in zip(tm(_ncdhw(feats)[0], torch.from_numpy(tokens)),
                             jm.apply(params, feats[0], tokens)):
            _close(got, want)

    pyramid = [rng.normal(size=(1, s, s, s, 8)).astype(np.float32) for s in (2, 4, 8)]
    hot = tokens[:5].copy()
    hot[1, :3] = hot[0, :3]  # two hotspots on one voxel: no contamination
    token_feats = rng.normal(size=(5, 16)).astype(np.float32)
    jm = jheads.MaskHead(token_feature_dim=16, channels=8, num_levels=3, num_convs=(1, 2, 2))
    params = _init(jm, pyramid, hot, token_feats)
    tm = _load(heads.MaskHead(16, 8, 3, (1, 2, 2)), params)
    got = tm([_ncdhw(p) for p in pyramid], torch.from_numpy(hot), torch.from_numpy(token_feats))
    assert got.shape == (5, 8, 8, 8)
    _close(got, jm.apply(params, pyramid, hot, token_feats))


def test_model_forward_passes_match_flax():
    """The four forward passes of the whole small network, carried by
    state_dict_from_flax, in the JAX layout."""
    rng = np.random.default_rng(6)
    image = rng.uniform(0, 1, size=(1, GRID, GRID, GRID, 33)).astype(np.float32)
    tokens = np.concatenate([rng.integers(0, GRID, size=(10, 3)),
                             rng.integers(0, 10, size=(10, 1))], axis=1).astype(np.int32)
    jm = jax_build_model(GRID, **SMALL)
    params = _init(jm, image, tokens)
    tm = build_model(GRID, **SMALL).eval()
    tm.load_state_dict(state_dict_from_flax(params, dict(image_size=GRID, **SMALL)), strict=True)

    with torch.no_grad():
        pyr = tm.forward_feature(torch.from_numpy(image))
        want_pyr = jm.apply(params, image, method="forward_feature")
        assert [tuple(p.shape) for p in pyr] == [tuple(p.shape) for p in want_pyr]
        for got, want in zip(pyr, want_pyr):
            _close(got, want)
        for got, want in zip(tm.forward_cavity_extraction(pyr[-1]),
                             jm.apply(params, want_pyr[-1], method="forward_cavity_extraction")):
            _close(got, want)
        t = torch.from_numpy(tokens)
        scores, feats = tm.forward_token_prediction(pyr[-1], t)
        want_scores, want_feats = jm.apply(params, want_pyr[-1], tokens,
                                           method="forward_token_prediction")
        _close(scores, want_scores)
        _close(feats, want_feats)
        _close(tm.forward_segmentation(pyr, t[:4], feats[:4]),
               jm.apply(params, want_pyr, tokens[:4], np.asarray(want_feats)[:4],
                        method="forward_segmentation"))


def test_full_width_checkpoint_round_trip():
    """Upstream torch state dict -> the JAX package's flax tree -> the
    port's state dict gives back every tensor exactly, and the published
    architecture loads it strictly (no forward pass: shapes only)."""
    synth = synthesize_torch_state_dict(seed=1, weight_scale=0.8)
    back = state_dict_from_flax(convert_torch_state_dict(synth))
    assert back.keys() == synth.keys()
    for k, v in synth.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    with torch.device("meta"):
        model = build_model()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in synth.items()},
                          strict=True, assign=True)
