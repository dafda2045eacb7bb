"""Cnn10 audio encoder (counterpart of ``acvae_tpu/models/encoders.py:38-135``).

Log-mel [N, T, F] -> the encoder dict of the JAX package::

    {"audio_embeds": [N, T', E], "audio_embeds_pooled": [N, E],
     "audio_embeds_lens": [N]}

NCHW layout with a 1-channel stem.  The JAX stem conv reads
``STEM_LANE_PAD`` input lanes, all but the first of them zero padding; the
port computes with one lane and keeps the other lanes' weights in the
buffer ``stem_pad_lanes`` [C, STEM_LANE_PAD - 1, 3, 3], which the forward
never reads and only the int8 bake does (scheme v1 folds one stem scale
into every lane, so those weights enter the stem's weight scale as in
JAX).  It is zero in a port-native model, and a state dict without it (an
experiment written before it existed) loads as zeros.  BatchNorm follows flax, not ``nn.BatchNorm2d``: it normalizes with
the biased batch variance (E[x²]-E[x]², in float32) and updates
``running_var`` with that same biased variance at momentum 0.9 (flax's
convention; torch's would be the unbiased variance at 0.1).  With
``dtype=torch.bfloat16`` the convs and the BN output run in bf16 while
parameters and statistics stay float32, as flax does with a block dtype.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from acvae_tpu_torch.ops.masked import max_with_lens, mean_with_lens

STEM_LANE_PAD = 2  # the JAX stem conv's input lanes (zero-padded from 1)


class BatchNorm(nn.Module):
    """flax-semantics BatchNorm over the channel ``axis``; torch names."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor, train: bool, axis: int = 1,
                dtype=None) -> torch.Tensor:
        shape = [1] * x.ndim
        shape[axis] = -1
        xf = x.float()
        if train:
            red = [d for d in range(x.ndim) if d != axis]
            mean = xf.mean(dim=red)
            var = torch.clamp_min((xf * xf).mean(dim=red) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(dtype or x.dtype)


class ConvBlock(nn.Module):
    """PANN ConvBlock (encoder.py:606-649): 2× [conv3x3 (no bias) -> BN ->
    relu], then 2×2 average pooling."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1,
                               bias=False, device=device)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1,
                               bias=False, device=device)
        self.bn1 = BatchNorm(out_channels, device=device)
        self.bn2 = BatchNorm(out_channels, device=device)
        for conv in (self.conv1, self.conv2):
            nn.init.xavier_uniform_(conv.weight)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), padding=1)
            x = F.relu(bn(x, train, axis=1, dtype=self.dtype))
        return F.avg_pool2d(x, 2)


class Cnn10(nn.Module):
    """PANN Cnn10 backbone (encoder.py:651-707): 4 ConvBlocks, time
    subsampling ×16, masked max+mean pooled head."""

    def __init__(self, inputdim: int = 64, embed_size: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 dtype=torch.float32, conv_dropout: float = 0.2,
                 head_dropout: float = 0.5, device=None):
        super().__init__()
        if embed_size != channels[-1]:
            raise ValueError("Cnn10 temporal embeds have channels[-1] dims")
        self.embed_size = embed_size
        self.conv_dropout, self.head_dropout = conv_dropout, head_dropout
        self.bn0 = BatchNorm(inputdim, device=device)
        cins = (1,) + tuple(channels[:-1])
        self.blocks = [ConvBlock(ci, co, dtype, device)
                       for ci, co in zip(cins, channels)]
        for i, blk in enumerate(self.blocks):
            self.add_module(f"conv_block{i + 1}", blk)
        self.register_buffer("stem_pad_lanes", torch.zeros(
            channels[0], STEM_LANE_PAD - 1, 3, 3, device=device))
        self.embed_pooled = nn.Linear(embed_size, embed_size, device=device)
        nn.init.xavier_uniform_(self.embed_pooled.weight)
        nn.init.zeros_(self.embed_pooled.bias)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # load_state_dict hands each module a copy of the caller's dict
        state_dict.setdefault(prefix + "stem_pad_lanes",
                              torch.zeros_like(self.stem_pad_lanes))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = self.bn0(feats, train, axis=2)[:, None]   # [N, 1, T, F]
        lens = feat_lens // 16
        for blk in self.blocks:
            x = F.dropout(blk(x, train), self.conv_dropout, train)
        x = x.mean(dim=3).transpose(1, 2)             # [N, T', C]
        pooled = max_with_lens(x, lens) + mean_with_lens(x, lens)
        pooled = F.dropout(pooled.float(), self.head_dropout, train)
        pooled = F.relu(self.embed_pooled(pooled))
        pooled = F.dropout(pooled, self.head_dropout, train)
        return {"audio_embeds": x, "audio_embeds_pooled": pooled,
                "audio_embeds_lens": lens}
