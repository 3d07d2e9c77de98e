"""3D Swin Transformer V2 backbone (torch, token layout [B, L, C]).

The backbone of the published PharmacoNet checkpoint, computed as the JAX
package's `network/swin3d.py` computes it:

  * patch embed: conv k2 s2 (33 -> 96) + LayerNorm
  * 4 stages, depths (2,6,2,2), heads (3,6,12,24), window 4
  * cosine attention with a per-head logit scale clamped at log 100;
    q and k normalised with max(norm, 1e-12)
  * continuous relative position bias: log-spaced table -> MLP(3,512,nH)
    -> 16*sigmoid
  * res-post-norm blocks: x + norm1(attn(x)); x + norm2(mlp(x))
  * QUIRK (kept): the cyclic shift rolls only dims (1,2) of the
    [B,D,H,W,C] view, while the attention mask is built for three shifted
    axes; the CPB table divides only the W-offset slices 0..2; the window
    is clamped and the shift dropped when the resolution is <= the window
  * patch merging: 8-way parity concat (d,h,w order) -> Linear(8C,2C, no
    bias) -> LayerNorm

The constant tables are numpy copies of the JAX package's builders and are
registered as non-persistent buffers, so the state dict holds only the
checkpoint's tensors.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import LN_EPS, Mlp


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, window^3, C]."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // window, window, h // window, window, w // window, window, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, window * window * window, c)


def window_reverse(windows: torch.Tensor, window: int, d: int, h: int, w: int) -> torch.Tensor:
    """Inverse of window_partition."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((d // window) * (h // window) * (w // window))
    x = windows.reshape(b, d // window, h // window, w // window, window, window, window, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, c)


def make_cpb_table(window: int) -> np.ndarray:
    """Log-spaced relative-coordinate table [(2w-1)^3, 3]. QUIRK (kept):
    only the W-offset slices 0..2 are divided by (w-1), across all three
    coordinate channels; the rest keep raw offsets."""
    rng = np.arange(-(window - 1), window, dtype=np.float32)
    table = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1)  # [2w-1]^3 x 3
    div = np.float32(max(window - 1, 1))
    for w_slice in range(min(3, table.shape[2])):
        table[:, :, w_slice, :] /= div
    table *= np.float32(8.0)
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.float32(math.log2(8.0))
    return table.reshape(-1, 3).astype(np.float32)


def make_relative_position_index(window: int) -> np.ndarray:
    """Pairwise relative-position index [w^3, w^3]."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), np.arange(window), indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [3, N, N]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    rel[:, :, 0] *= (2 * window - 1) * (2 * window - 1)
    rel[:, :, 1] *= 2 * window - 1
    return rel.sum(-1).astype(np.int32)


def make_shift_attn_mask(resolution: tuple[int, int, int], window: int, shift: int) -> np.ndarray:
    """Shifted-window attention mask [nW, N, N] of 0 / -100, built with
    three-axis slicing although the roll covers two axes."""
    d, h, w = resolution
    img_mask = np.zeros((1, d, h, w, 1), dtype=np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for ds in slices:
        for hs in slices:
            for ws in slices:
                img_mask[:, ds, hs, ws, :] = cnt
                cnt += 1
    x = img_mask.reshape(1, d // window, window, h // window, window, w // window, window, 1)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, window**3)
    diff = x[:, None, :] - x[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Cosine window attention with continuous relative position bias."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.cpb_mlp = nn.Sequential(nn.Linear(3, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("cpb_table", torch.from_numpy(make_cpb_table(window)),
                             persistent=False)
        index = make_relative_position_index(window).reshape(-1).astype(np.int64)
        self.register_buffer("rel_index", torch.from_numpy(index), persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        bw, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = x @ self.qkv.weight.T + qkv_bias
        qkv = qkv.reshape(bw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)  # [3,B,nh,N,hd]
        q, k, v = qkv[0], qkv[1], qkv[2]

        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
        k = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-12)
        attn = q @ k.transpose(-2, -1)
        attn = attn * torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))

        bias_table = self.cpb_mlp(self.cpb_table)  # [T, nh]
        rel_bias = bias_table[self.rel_index].reshape(n, n, nh).permute(2, 0, 1)
        attn = attn + (16.0 * torch.sigmoid(rel_bias))[None]

        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(bw, nh, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, resolution: tuple[int, int, int], num_heads: int,
                 window: int, shift: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.resolution = resolution
        if min(resolution) <= window:
            window, shift = min(resolution), 0
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        mask = make_shift_attn_mask(resolution, window, shift) if shift > 0 else None
        self.register_buffer("attn_mask", None if mask is None else torch.from_numpy(mask),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, w = self.resolution
        b, length, c = x.shape
        shortcut = x
        x = x.reshape(b, d, h, w, c)
        if self.shift > 0:
            # QUIRK: roll dims (1, 2) only
            x = torch.roll(x, shifts=(-self.shift, -self.shift), dims=(1, 2))
        attn_out = self.attn(window_partition(x, self.window), self.attn_mask)
        x = window_reverse(attn_out, self.window, d, h, w)
        if self.shift > 0:
            x = torch.roll(x, shifts=(self.shift, self.shift), dims=(1, 2))
        x = x.reshape(b, length, c)
        x = shortcut + self.norm1(x)
        return x + self.norm2(self.mlp(x))


class PatchMerging(nn.Module):
    PARITY = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
              (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))

    def __init__(self, dim: int, resolution: tuple[int, int, int]):
        super().__init__()
        self.resolution = resolution
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, w = self.resolution
        b, length, c = x.shape
        x = x.reshape(b, d, h, w, c)
        parts = [x[:, di::2, hi::2, wi::2, :] for di, hi, wi in self.PARITY]
        x = torch.cat(parts, dim=-1).reshape(b, -1, 8 * c)
        return self.norm(self.reduction(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, resolution: tuple[int, int, int], depth: int,
                 num_heads: int, window: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, resolution, num_heads, window, 0 if i % 2 == 0 else window // 2)
            for i in range(depth)
        )
        self.downsample = PatchMerging(dim, resolution) if downsample else None

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        for block in self.blocks:
            x = block(x)
        if self.downsample is not None:
            return x, self.downsample(x)
        return x, x


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv3d(in_channels, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C_in, D, H, W] -> [B, L, embed] (x-major tokens)."""
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class SwinTransformerV2_3D(nn.Module):
    """Backbone producing 4 scales: [96@32^3, 192@16^3, 384@8^3, 768@4^3]."""

    def __init__(self, in_channels: int = 33, image_size: int = 64, patch_size: int = 2,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 6, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        self.res0 = image_size // patch_size
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size)
        n = len(depths)
        self.layers = nn.ModuleList(
            SwinStage(embed_dim * 2**i, (self.res0 // 2**i,) * 3, depths[i], num_heads[i],
                      window, downsample=i < n - 1)
            for i in range(n)
        )
        for i in range(n):
            self.add_module(f"norm{i}", nn.LayerNorm(embed_dim * 2**i, eps=LN_EPS))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: [B, C_in, D, H, W] -> list of [B, C_i, d, h, w] (bottom-up)."""
        b = x.shape[0]
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.layers):
            dim, res = self.embed_dim * 2**i, self.res0 // 2**i
            x_out, x = stage(x)
            x_out = getattr(self, f"norm{i}")(x_out)
            outs.append(x_out.reshape(b, res, res, res, dim).permute(0, 4, 1, 2, 3))
        return outs
