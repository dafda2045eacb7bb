"""The audio encoder zoo (counterpart of ``acvae_tpu/models/encoders.py``).

Log-mel [N, T, F] -> the encoder dict of the JAX package::

    {"audio_embeds": [N, T', E], "audio_embeds_pooled": [N, E'],
     "audio_embeds_lens": [N]}

``ENCODERS`` registers every encoder under the JAX package's name.  Convs
run NCHW as [N, C, T, F] (H is time, W is mel, as the JAX NHWC layout has
them), so a flax HWIO kernel is an OIHW weight by a transpose alone.  Where
the JAX package flattens (freq, channels) into one feature axis
(CRNNEncoder, CNNEncoder, E2EASREncoder), the port permutes to
[N, T, F, C] first, so that the flattened order, and with it every weight,
is the JAX package's.

The PANN family (Cnn10, Cnn14, ResNet38) carry PANN's own names (``bn0``,
``conv_block<i>``, ``resnet.layer<s>.<b>``, ``conv_block_after1``,
``fc1``), so a PANN state dict loads by name.  Their stem reads one mel
lane; the JAX stem conv reads ``STEM_LANE_PAD`` lanes, all but the first
zero padding, and the port keeps the other lanes' weights in the buffer
``stem_pad_lanes`` [C, STEM_LANE_PAD - 1, 3, 3], which the forward never
reads and only the int8 bake does (scheme v1 folds one stem scale into
every lane, so those weights enter the stem's weight scale as in JAX).  It
is zero in a port-native model, and a state dict without it (an experiment
written before it existed) loads as zeros.  CNN10Q/D and CRNN8_Sub4 stage
mels the same way in JAX; the port drops their padded lanes.

BatchNorm follows flax, not ``nn.BatchNorm2d``: it normalizes with the
biased batch variance (E[x²]-E[x]², in float32) and updates ``running_var``
with that same biased variance at flax's momentum (0.9 unless a module
says otherwise; torch's convention would be the unbiased variance at 0.1).
With ``dtype=torch.bfloat16`` the convs (and the BatchNorms the JAX
package gives the block dtype) run in bf16 while parameters and
statistics stay float32, as flax does with a module dtype.  The pooled
embeddings use length-masked mean/max, as in JAX.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from acvae_tpu_torch.models.decoders import MultiheadAttention, sinusoidal_pe
from acvae_tpu_torch.models.rnn import GRU
from acvae_tpu_torch.ops.amp import promoted_linear
from acvae_tpu_torch.ops.masked import length_mask, max_with_lens, mean_with_lens

STEM_LANE_PAD = 2  # the JAX stem conv's input lanes (zero-padded from 1)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ENCODERS: Dict[str, type] = {}


def register(name: str):
    def deco(cls):
        ENCODERS[name] = cls
        return cls
    return deco


# ------------------------------------------------------------------ init
def _fan_in(w: torch.Tensor) -> int:
    return w.shape[1] * (w[0, 0].numel() if w.ndim > 2 else 1)


def _init(w: torch.Tensor, kind: str) -> None:
    """flax's initializers by name: ``xavier_uniform``, ``kaiming_uniform``
    (He uniform), ``kaiming_normal`` (He truncated normal) and ``lecun``
    (flax's default for Dense and Conv: LeCun truncated normal)."""
    if kind == "xavier_uniform":
        nn.init.xavier_uniform_(w)
        return
    if kind == "kaiming_uniform":
        nn.init.kaiming_uniform_(w, nonlinearity="relu")
        return
    scale = {"kaiming_normal": 2.0, "lecun": 1.0}[kind]
    # a unit normal truncated to [-2, 2] has std 0.8796...
    std = math.sqrt(scale / _fan_in(w)) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def _conv(cin: int, cout: int, k: int = 3, init: str = "lecun",
          bias: bool = False, device=None) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, bias=bias, device=device)
    _init(conv.weight, init)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def _dense(cin: int, cout: int, init: str = "lecun", device=None) -> nn.Linear:
    lin = nn.Linear(cin, cout, device=device)
    _init(lin.weight, init)
    nn.init.zeros_(lin.bias)
    return lin


def _conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype, stride: int = 1,
           padding: int = 1) -> torch.Tensor:
    """``conv`` on ``x`` [N, C, T, F] with input and weights in ``dtype``
    (flax's ``nn.Conv(dtype=...)``)."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, stride, padding)


def _pool2d(x: torch.Tensor, size: Tuple[int, int], kind: str) -> torch.Tensor:
    """VALID ``size``-window pooling of [N, C, T, F]: ``avg``, ``max`` or
    ``avg+max``; ``(1, 1)`` is no pool."""
    if tuple(size) == (1, 1):
        return x
    if kind == "avg":
        return F.avg_pool2d(x, size)
    if kind == "max":
        return F.max_pool2d(x, size)
    if kind == "avg+max":
        return F.avg_pool2d(x, size) + F.max_pool2d(x, size)
    raise KeyError(f"pool_type must be avg, max or avg+max, got {kind!r}")


def lp_pool(x: torch.Tensor, p: float, window: Tuple[int, int]) -> torch.Tensor:
    """``(Σ_window |x|^p)^(1/p)`` over VALID windows of [N, C, T, F]
    (``encoders.py:323-328``: torch ``nn.LPPool2d``'s function, written out
    as the JAX package computes it)."""
    kh, kw = window
    N, C, T, Fd = x.shape
    x = x[:, :, :T // kh * kh, :Fd // kw * kw]
    s = (x.abs() ** p).reshape(N, C, T // kh, kh, Fd // kw, kw).sum(dim=(3, 5))
    return s ** (1.0 / p)


def _to_tfc(x: torch.Tensor) -> torch.Tensor:
    """[N, C, T, F] -> [N, T, F·C], (freq, channels) flattened freq-major
    as the JAX package's NHWC reshape flattens them."""
    N, C, T, Fd = x.shape
    return x.permute(0, 2, 3, 1).reshape(N, T, Fd * C)


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
    relu], then ``pool_type`` pooling over ``pool_size`` (``(1, 1)``: none)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(in_channels, out_channels, init="xavier_uniform",
                           device=device)
        self.conv2 = _conv(out_channels, out_channels, init="xavier_uniform",
                           device=device)
        self.bn1 = BatchNorm(out_channels, device=device)
        self.bn2 = BatchNorm(out_channels, device=device)

    def forward(self, x: torch.Tensor, train: bool,
                pool_size: Tuple[int, int] = (2, 2),
                pool_type: str = "avg") -> torch.Tensor:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = F.relu(bn(_conv2d(x, conv, self.dtype), train, dtype=self.dtype))
        return _pool2d(x, pool_size, pool_type)


class _PannEncoder(nn.Module):
    """bn0 over the mel bins, the stem's ``stem_pad_lanes`` and the PANN
    pooled head (``encoders.py:68-104``)."""

    def __init__(self, inputdim: int, stem_channels: int, conv_dropout: float,
                 head_dropout: float, device=None):
        super().__init__()
        self.conv_dropout, self.head_dropout = conv_dropout, head_dropout
        self.bn0 = BatchNorm(inputdim, device=device)
        self.register_buffer("stem_pad_lanes", torch.zeros(
            stem_channels, STEM_LANE_PAD - 1, 3, 3, device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # load_state_dict hands each module a copy of the caller's dict
        state_dict.setdefault(prefix + "stem_pad_lanes",
                              torch.zeros_like(self.stem_pad_lanes))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _stage_mel(self, feats: torch.Tensor, train: bool) -> torch.Tensor:
        return self.bn0(feats, train, axis=2)[:, None]   # [N, 1, T, F]

    def _drop(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.dropout(x, self.conv_dropout, train)

    def _head(self, x: torch.Tensor, lens: torch.Tensor, fc: nn.Linear,
              train: bool) -> Dict[str, torch.Tensor]:
        x = x.mean(dim=3).transpose(1, 2)             # [N, T', C]
        pooled = max_with_lens(x, lens) + mean_with_lens(x, lens)
        pooled = F.dropout(pooled.float(), self.head_dropout, train)
        pooled = F.relu(promoted_linear(pooled, fc))
        pooled = F.dropout(pooled, self.head_dropout, train)
        return {"audio_embeds": x, "audio_embeds_pooled": pooled,
                "audio_embeds_lens": lens}


@register("Cnn10")
class Cnn10(_PannEncoder):
    """PANN Cnn10 backbone (encoder.py:651-707): 4 ConvBlocks, time
    subsampling ×16, masked max+mean pooled head."""

    def __init__(self, inputdim: int = 64, embed_size: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 dtype=torch.float32, conv_dropout: float = 0.2,
                 head_dropout: float = 0.5, device=None):
        super().__init__(inputdim, channels[0], conv_dropout, head_dropout,
                         device)
        if embed_size != channels[-1]:
            raise ValueError("Cnn10 temporal embeds have channels[-1] dims")
        self.embed_size = embed_size
        cins = (1,) + tuple(channels[:-1])
        self.blocks = [ConvBlock(ci, co, dtype, device)
                       for ci, co in zip(cins, channels)]
        for i, blk in enumerate(self.blocks):
            self.add_module(f"conv_block{i + 1}", blk)
        self.embed_pooled = _dense(embed_size, embed_size, "xavier_uniform",
                                   device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = self._stage_mel(feats, train)
        for blk in self.blocks:
            x = self._drop(blk(x, train), train)
        return self._head(x, feat_lens // 16, self.embed_pooled, train)


@register("Cnn14")
class Cnn14(_PannEncoder):
    """PANN Cnn14_16k (encoder.py:871-964): 6 ConvBlocks 64->2048, the last
    unpooled; time subsampling ×32."""
    channels = (64, 128, 256, 512, 1024, 2048)

    def __init__(self, inputdim: int = 64, embed_size: int = 2048,
                 dtype=torch.float32, device=None):
        super().__init__(inputdim, 64, 0.2, 0.5, device)
        self.embed_size = embed_size
        cins = (1,) + self.channels[:-1]
        self.blocks = [ConvBlock(ci, co, dtype, device)
                       for ci, co in zip(cins, self.channels)]
        for i, blk in enumerate(self.blocks):
            self.add_module(f"conv_block{i + 1}", blk)
        self.fc1 = _dense(2048, embed_size, "xavier_uniform", device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = self._stage_mel(feats, train)
        for i, blk in enumerate(self.blocks):
            x = blk(x, train, pool_size=(2, 2) if i < 5 else (1, 1))
            x = self._drop(x, train)
        return self._head(x, feat_lens // 32, self.fc1, train)


class ResnetBasicBlock(nn.Module):
    """PANN ResNet basic block (encoder.py:981-1094): stride 2 is an
    avg-pool before conv1 (and before the 1×1 shortcut); bn2 starts at
    zero scale (zero_init_residual).  ``downsample`` holds the shortcut's
    conv and BN as ``downsample.0``/``downsample.1``."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv1 = _conv(inplanes, planes, init="xavier_uniform", device=device)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = _conv(planes, planes, init="xavier_uniform", device=device)
        self.bn2 = BatchNorm(planes, device=device)
        nn.init.zeros_(self.bn2.weight)
        self.downsample = None
        if downsample:
            self.downsample = nn.ModuleList([
                _conv(inplanes, planes, 1, "xavier_uniform", device=device),
                BatchNorm(planes, device=device)])

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        f32 = torch.float32
        out = F.avg_pool2d(x, 2) if self.stride == 2 else x
        out = F.relu(self.bn1(_conv2d(out, self.conv1, self.dtype), train, dtype=f32))
        out = self.bn2(_conv2d(out, self.conv2, self.dtype), train, dtype=f32)
        identity = x
        if self.downsample is not None:
            if self.stride == 2:
                identity = F.avg_pool2d(identity, 2)
            conv, bn = self.downsample
            identity = bn(_conv2d(identity, conv, self.dtype, padding=0), train,
                          dtype=f32)
        return F.relu(out + identity)


class _ResNetTrunk(nn.Module):
    """``resnet.layer1``..``layer4`` of PANN's ResNet38 ([3, 4, 6, 3])."""
    plan = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))

    def __init__(self, dtype, device=None):
        super().__init__()
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(self.plan, 1):
            layer = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != planes)
                layer.append(ResnetBasicBlock(inplanes, planes, s, ds, dtype,
                                              device))
                inplanes = planes
            self.add_module(f"layer{stage}", nn.ModuleList(layer))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for stage in range(1, 5):
            for blk in getattr(self, f"layer{stage}"):
                x = blk(x, train)
        return x


@register("ResNet38")
class ResNet38(_PannEncoder):
    """PANN ResNet38 (encoder.py:1169-1232): ConvBlock64 -> ResNet[3,4,6,3]
    -> ConvBlock2048 -> pooled head; subsampling ×32."""

    def __init__(self, inputdim: int = 64, embed_size: int = 2048,
                 dtype=torch.float32, device=None):
        super().__init__(inputdim, 64, 0.2, 0.5, device)
        self.embed_size = embed_size
        self.conv_block1 = ConvBlock(1, 64, dtype, device)
        self.resnet = _ResNetTrunk(dtype, device)
        self.conv_block_after1 = ConvBlock(512, 2048, dtype, device)
        self.fc1 = _dense(2048, embed_size, "xavier_uniform", device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = self._drop(self.conv_block1(self._stage_mel(feats, train), train),
                       train)
        x = self._drop(F.avg_pool2d(self.resnet(x, train), 2), train)
        x = self._drop(self.conv_block_after1(x, train, pool_size=(1, 1)), train)
        return self._head(x, feat_lens // 32, self.fc1, train)


class TorchvisionBasicBlock(nn.Module):
    """torchvision-style BasicBlock (encoder.py:769-806): a strided 3×3
    conv1, and a strided 1×1 conv shortcut where the shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv1 = _conv(inplanes, planes, init="kaiming_normal", device=device)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = _conv(planes, planes, init="kaiming_normal", device=device)
        self.bn2 = BatchNorm(planes, device=device)
        self.ds_conv = self.ds_bn = None
        if downsample:
            self.ds_conv = _conv(inplanes, planes, 1, "kaiming_normal",
                                 device=device)
            self.ds_bn = BatchNorm(planes, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        f32 = torch.float32
        out = _conv2d(x, self.conv1, self.dtype, self.stride)
        out = F.relu(self.bn1(out, train, dtype=f32))
        out = self.bn2(_conv2d(out, self.conv2, self.dtype), train, dtype=f32)
        identity = x
        if self.ds_conv is not None:
            identity = self.ds_bn(_conv2d(x, self.ds_conv, self.dtype, self.stride,
                                         padding=0), train, dtype=f32)
        return F.relu(out + identity)


@register("ResNetEncoder")
class ResNetEncoder(nn.Module):
    """torchvision-style ResNet18 trunk (encoder.py:808-863): 7×7/2 stem ->
    3×3/2 max-pool -> 4 stages of 2 BasicBlocks (stride 2 from stage 2) ->
    mean over the mel axis; five stride-2 halvings, so the lengths are
    ``(l - 1) // 2 + 1`` five times.  The JAX package's names
    (``stem_conv``, ``layer<s>_<b>``, ``ds_conv``/``ds_bn``)."""

    def __init__(self, inputdim: int = 64, embed_size: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 dtype=torch.float32, device=None):
        super().__init__()
        if embed_size != channels[-1]:
            raise ValueError("ResNetEncoder temporal embeds have channels[-1] dims")
        self.embed_size, self.dtype = embed_size, dtype
        self.stem_conv = _conv(1, channels[0], 7, "kaiming_normal", device=device)
        self.stem_bn = BatchNorm(channels[0], device=device)
        inplanes = channels[0]
        self.layers = []
        for stage, planes in enumerate(channels):
            for b in range(2):
                s = (1 if stage == 0 else 2) if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != planes)
                blk = TorchvisionBasicBlock(inplanes, planes, s, ds, dtype, device)
                self.add_module(f"layer{stage + 1}_{b}", blk)
                self.layers.append(blk)
                inplanes = planes

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = _conv2d(feats[:, None], self.stem_conv, self.dtype, 2, 3)
        x = F.relu(self.stem_bn(x, train, dtype=torch.float32))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for blk in self.layers:
            x = blk(x, train)
        x = x.float().mean(dim=3).transpose(1, 2)     # [N, T', C]
        lens = feat_lens
        for _ in range(5):
            lens = (lens - 1) // 2 + 1
        return {"audio_embeds": x, "audio_embeds_pooled": mean_with_lens(x, lens),
                "audio_embeds_lens": lens}


def _block2d(owner: nn.Module, name: str, cin: int, cout: int, init: str,
             device) -> None:
    """Block2D (encoder.py:180-194), BN (float32) -> conv3x3 (no bias) ->
    LeakyReLU(0.1), as ``<name>_bn``/``<name>_conv`` of ``owner``."""
    owner.add_module(f"{name}_bn", BatchNorm(cin, device=device))
    owner.add_module(f"{name}_conv", _conv(cin, cout, init=init, device=device))


def _run_block2d(owner: nn.Module, name: str, x: torch.Tensor, train: bool,
                 dtype) -> torch.Tensor:
    x = getattr(owner, f"{name}_bn")(x, train, dtype=torch.float32)
    return F.leaky_relu(_conv2d(x, getattr(owner, f"{name}_conv"), dtype), 0.1)


@register("CRNNEncoder")
class CRNNEncoder(nn.Module):
    """CRNN (encoder.py:271-342): Block2D conv stack with LPPool -> BiGRU(128);
    time subsampling ×4; pooled = masked mean."""
    plan = (("b1", 32, (2, 4)), ("b2", 128, None), ("b3", 128, (2, 4)),
            ("b4", 128, None), ("b5", 128, (1, 4)))

    def __init__(self, inputdim: int = 64, embed_size: int = 256,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.embed_size, self.dtype = embed_size, dtype
        cin, f = 1, inputdim
        for name, cout, pool in self.plan:
            _block2d(self, name, cin, cout, "kaiming_uniform", device)
            cin, f = cout, f // pool[1] if pool else f
        self.gru = GRU(f * cin, 128, bidirectional=True, device=device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = feats[:, None]
        for name, _, pool in self.plan:
            x = _run_block2d(self, name, x, train, self.dtype)
            if pool:
                x = lp_pool(x, 4.0, pool)
        x = _to_tfc(F.dropout(x, 0.3, train))
        lens = feat_lens // 4
        x, _ = self.gru(x.float(), lens)
        return {"audio_embeds": x, "audio_embeds_pooled": mean_with_lens(x, lens),
                "audio_embeds_lens": lens}


class _DoubleConvTrunk(nn.Module):
    """bn0 and ``b<i>_conv<j>``/``b<i>_bn<j>`` double-conv blocks (BN in the
    block dtype, relu) of CNN10Q/D and CRNN8_Sub4 (``encoders.py:379-393,
    465-479``); the JAX stem's padded lanes are not kept."""

    def __init__(self, inputdim: int, channels: Sequence[int], dtype, device):
        super().__init__()
        self.dtype = dtype
        self.bn0 = BatchNorm(inputdim, device=device)
        cin = 1
        for i, c in enumerate(channels):
            for j in (1, 2):
                self.add_module(f"b{i}_conv{j}", _conv(
                    cin, c, init="kaiming_uniform", device=device))
                self.add_module(f"b{i}_bn{j}", BatchNorm(c, device=device))
                cin = c
        self.n_blocks = len(channels)

    def _block(self, x: torch.Tensor, i: int, train: bool) -> torch.Tensor:
        for j in (1, 2):
            x = _conv2d(x, getattr(self, f"b{i}_conv{j}"), self.dtype)
            x = F.relu(getattr(self, f"b{i}_bn{j}")(x, train, dtype=self.dtype))
        return x


@register("CNN10QEncoder")
class CNN10QEncoder(_DoubleConvTrunk):
    """CNN10-Q (encoder.py:427-498): double-conv blocks with avg pools, final
    freq average, masked mean+max pooled embedding; subsampling ×16."""

    def __init__(self, inputdim: int = 64, embed_size: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 dtype=torch.float32, device=None):
        super().__init__(inputdim, channels, dtype, device)
        self.embed_size = embed_size
        self._make_head(channels, device)

    def _make_head(self, channels, device) -> None:
        self.embedding = _dense(channels[-1], self.embed_size,
                                "kaiming_uniform", device)

    def _trunk(self, feats, feat_lens, train):
        x = self.bn0(feats, train, axis=2)[:, None]
        for i in range(self.n_blocks):
            x = F.dropout(F.avg_pool2d(self._block(x, i, train), 2), 0.2, train)
        return x.mean(dim=3).transpose(1, 2), feat_lens // 16

    def _pooled(self, x, lens, train):
        out = mean_with_lens(x, lens) + max_with_lens(x, lens)
        return promoted_linear(F.dropout(out, 0.5, train), self.embedding)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x, lens = self._trunk(feats, feat_lens, train)
        return {"audio_embeds": x, "audio_embeds_pooled": self._pooled(x, lens, train),
                "audio_embeds_lens": lens}


@register("CNN10DEncoder")
class CNN10DEncoder(CNN10QEncoder):
    """CNN10-D (encoder.py:500-514): the Q trunk; its ``embedding`` Dense
    (channels[-1] wide) maps the pooled vector and, relu'd, every frame,
    and ``outputlayer`` maps the frames to ``embed_size``."""

    def _make_head(self, channels, device) -> None:
        self.embedding = _dense(channels[-1], channels[-1], "kaiming_uniform",
                                device)
        self.outputlayer = _dense(channels[-1], self.embed_size,
                                  "kaiming_uniform", device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x, lens = self._trunk(feats, feat_lens, train)
        frames = F.relu(promoted_linear(x, self.embedding))
        frames = promoted_linear(F.dropout(frames, 0.5, train), self.outputlayer)
        return {"audio_embeds": frames,
                "audio_embeds_pooled": self._pooled(x, lens, train),
                "audio_embeds_lens": lens}


@register("CNNEncoder")
class CNNEncoder(nn.Module):
    """GLU conv stack (encoder.py:91-141): conv -> BN -> GLU over channels
    -> freq max-pool; time-mean pooled into one utterance vector, the
    temporal embeds that vector as one frame (lens 1)."""

    def __init__(self, inputdim: int = 64, embed_size: int = 256,
                 filters: Sequence[int] = (32, 32, 32),
                 filtersizes: Sequence[int] = (5, 3, 3),
                 dtype=torch.float32, device=None):
        super().__init__()
        self.embed_size, self.dtype = embed_size, dtype
        self.kernels = tuple(filtersizes)
        cin, f = 1, inputdim
        for i, (c, k) in enumerate(zip(filters, filtersizes)):
            self.add_module(f"conv{i}", _conv(cin, c, k, "kaiming_uniform",
                                              device=device))
            self.add_module(f"bn{i}", BatchNorm(c, device=device))
            cin, f = c // 2, f // 2
        self.outputlayer = _dense(f * cin, embed_size, "kaiming_uniform", device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = feats[:, None]
        for i, k in enumerate(self.kernels):
            x = _conv2d(x, getattr(self, f"conv{i}"), self.dtype, padding=k // 2)
            x = getattr(self, f"bn{i}")(x, train, dtype=self.dtype)
            a, b = x.chunk(2, dim=1)
            x = F.max_pool2d(a * torch.sigmoid(b), (1, 2))
        x = x.mean(dim=2)                              # [N, C, F']
        x = x.transpose(1, 2).reshape(x.shape[0], -1)  # freq-major
        out = promoted_linear(x, self.outputlayer)
        return {"audio_embeds": out[:, None, :], "audio_embeds_pooled": out,
                "audio_embeds_lens": torch.ones_like(feat_lens)}


@register("CRNN8_Sub4")
class CRNN8Sub4(_DoubleConvTrunk):
    """CRNN8 (encoder.py:345-424): double-conv blocks with avg+max pooling
    -> embedding -> BiGRU; subsampling ×4."""
    pools = ((2, 2), (2, 2), (1, 2), (1, 2))

    def __init__(self, inputdim: int = 64, embed_size: int = 512,
                 channels: Sequence[int] = (64, 128, 256, 512),
                 dtype=torch.float32, device=None):
        super().__init__(inputdim, channels, dtype, device)
        self.embed_size = embed_size
        self.embedding = _dense(channels[-1], channels[-1], "kaiming_uniform",
                                device)
        self.gru = GRU(channels[-1], channels[-1] // 2, bidirectional=True,
                       device=device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = self.bn0(feats, train, axis=2)[:, None]
        for i, p in enumerate(self.pools):
            x = F.dropout(_pool2d(self._block(x, i, train), p, "avg+max"), 0.2,
                          train)
        x = F.dropout(x.mean(dim=3).transpose(1, 2), 0.5, train)
        x = F.relu(promoted_linear(x, self.embedding))
        lens = feat_lens // 4
        x, _ = self.gru(x, lens)
        return {"audio_embeds": x, "audio_embeds_pooled": mean_with_lens(x, lens),
                "audio_embeds_lens": lens}


@register("TransformerEncoder")
class TransformerAudioEncoder(nn.Module):
    """Projects features through a post-norm transformer encoder
    (encoder.py:1256-1306).  Padded positions are masked as queries and as
    keys; a padded query row attends uniformly, as flax's masked softmax
    gives it, so its ``audio_embeds`` row matches JAX's.  LayerNorm eps
    1e-6 (flax's)."""

    def __init__(self, inputdim: int, embed_size: int = 512, nhead: int = 8,
                 nlayers: int = 2, dim_feedforward: int = 2048,
                 dropout: float = 0.2, device=None):
        super().__init__()
        self.embed_size, self.nlayers, self.dropout = embed_size, nlayers, dropout
        self.proj = _dense(inputdim, embed_size, "kaiming_uniform", device)
        for i in range(nlayers):
            self.add_module(f"layer{i}_attn", MultiheadAttention(
                embed_size, nhead, dropout, device))
            self.add_module(f"layer{i}_norm1",
                            nn.LayerNorm(embed_size, eps=1e-6, device=device))
            self.add_module(f"layer{i}_ff1", _dense(embed_size, dim_feedforward,
                                                    device=device))
            self.add_module(f"layer{i}_ff2", _dense(dim_feedforward, embed_size,
                                                    device=device))
            self.add_module(f"layer{i}_norm2",
                            nn.LayerNorm(embed_size, eps=1e-6, device=device))

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = self.proj(feats)
        mask = length_mask(feat_lens, x.shape[1])
        attn_mask = mask[:, None, :] & mask[:, :, None]
        for i in range(self.nlayers):
            sa = getattr(self, f"layer{i}_attn")(x, x, attn_mask, train)
            x = getattr(self, f"layer{i}_norm1")(x + sa)
            ff = F.relu(getattr(self, f"layer{i}_ff1")(x))
            ff = getattr(self, f"layer{i}_ff2")(F.dropout(ff, self.dropout, train))
            x = getattr(self, f"layer{i}_norm2")(x + ff)
        return {"audio_embeds": x, "audio_embeds_pooled": mean_with_lens(x, feat_lens),
                "audio_embeds_lens": feat_lens}


@register("CNN10Encoder")
class CNN10Encoder(nn.Module):
    """Block2D+LPPool CNN10 (encoder.py:516-575): four double-Block2D stages
    with LPPool(4) pools (2,4)/(2,2)/(1,2)/(1,2), freq averaged; time
    subsampling ×4; pooled = masked time mean."""
    plan = ((64, (2, 4)), (128, (2, 2)), (256, (1, 2)), (512, (1, 2)))

    def __init__(self, inputdim: int = 64, embed_size: int = 512,
                 dtype=torch.float32, device=None):
        super().__init__()
        if embed_size != 512:
            raise ValueError("CNN10Encoder outputs 512 dims (encoder.py:520)")
        self.embed_size, self.dtype = embed_size, dtype
        cin = 1
        for i, (c, _) in enumerate(self.plan):
            _block2d(self, f"b{i}_1", cin, c, "xavier_uniform", device)
            _block2d(self, f"b{i}_2", c, c, "xavier_uniform", device)
            cin = c

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = feats[:, None]
        for i, (_, pool) in enumerate(self.plan):
            x = _run_block2d(self, f"b{i}_1", x, train, self.dtype)
            x = _run_block2d(self, f"b{i}_2", x, train, self.dtype)
            x = lp_pool(x, 4.0, pool)
        x = F.dropout(x, 0.3, train).mean(dim=3).transpose(1, 2)
        lens = feat_lens // 4
        return {"audio_embeds": x, "audio_embeds_pooled": mean_with_lens(x, lens),
                "audio_embeds_lens": lens}


@register("PreTrainedCNN")
class PreTrainedCNN(nn.Module):
    """A pretrained encoder ``trunk`` + a fresh linear head (encoder.py:
    144-177).  The trunk runs with ``train=False`` (its BatchNorms on
    running statistics, no dropout) and, with ``freeze``, its outputs are
    detached (JAX's ``stop_gradient``); ``outputlayer`` maps both the
    frames and the pooled vector."""

    def __init__(self, trunk: nn.Module, embed_size: int = 512,
                 freeze: bool = True, inputdim: int = 64, device=None):
        super().__init__()
        self.trunk, self.embed_size, self.freeze = trunk, embed_size, freeze
        self.outputlayer = _dense(trunk.embed_size, embed_size, "xavier_uniform",
                                  device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        out = self.trunk(feats, feat_lens, train=False)
        embeds, pooled = out["audio_embeds"], out["audio_embeds_pooled"]
        if self.freeze:
            embeds, pooled = embeds.detach(), pooled.detach()
        return {"audio_embeds": promoted_linear(embeds, self.outputlayer),
                "audio_embeds_pooled": promoted_linear(pooled, self.outputlayer),
                "audio_embeds_lens": out["audio_embeds_lens"]}


@register("CNN10CRNNEncoder")
class CNN10CRNNEncoder(nn.Module):
    """Fusion encoder (encoder.py:577-591): a CRNN and a CNN10 branch on
    the same mels, concatenated on the feature axis; the sequences cut to
    the shorter one's T and the lengths to the smaller."""

    def __init__(self, crnn: nn.Module, cnn: nn.Module, inputdim: int = 64,
                 device=None):
        super().__init__()
        self.crnn, self.cnn = crnn, cnn
        self.embed_size = crnn.embed_size + cnn.embed_size

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        a = self.crnn(feats, feat_lens, train=train)
        b = self.cnn(feats, feat_lens, train=train)
        T = min(a["audio_embeds"].shape[1], b["audio_embeds"].shape[1])
        return {
            "audio_embeds": torch.cat([a["audio_embeds"][:, :T],
                                       b["audio_embeds"][:, :T]], dim=-1),
            "audio_embeds_pooled": torch.cat([a["audio_embeds_pooled"],
                                              b["audio_embeds_pooled"]], dim=-1),
            "audio_embeds_lens": torch.minimum(a["audio_embeds_lens"],
                                               b["audio_embeds_lens"]),
        }


@register("E2EASREncoder")
class E2EASREncoder(nn.Module):
    """ESPnet-style ASR encoder (encoder.py:14-54): VGG2L (two stages of
    2× conv3x3 with bias + relu, then a 2×2 max-pool: time ×4) into
    ``nlayers`` BiGRUs, each followed by a tanh projection; pooled =
    masked time mean."""

    def __init__(self, inputdim: int = 64, embed_size: int = 320,
                 hidden_size: int = 320, nlayers: int = 2,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.embed_size, self.nlayers, self.dtype = embed_size, nlayers, dtype
        cin = 1
        for i, c in enumerate((64, 128)):
            for j in (1, 2):
                self.add_module(f"vgg{i}_conv{j}", _conv(
                    cin, c, init="xavier_uniform", bias=True, device=device))
                cin = c
        d = (inputdim // 4) * 128
        for i in range(nlayers):
            self.add_module(f"bgru{i}", GRU(d, hidden_size, bidirectional=True,
                                            device=device))
            self.add_module(f"proj{i}", _dense(2 * hidden_size, embed_size,
                                               "xavier_uniform", device))
            d = embed_size

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        x = feats[:, None]
        for i in range(2):
            for j in (1, 2):
                x = F.relu(_conv2d(x, getattr(self, f"vgg{i}_conv{j}"), self.dtype))
            x = F.max_pool2d(x, 2)
        x = _to_tfc(x).float()
        lens = feat_lens // 4
        for i in range(self.nlayers):
            x, _ = getattr(self, f"bgru{i}")(x, lens)
            x = torch.tanh(getattr(self, f"proj{i}")(x))
        return {"audio_embeds": x, "audio_embeds_pooled": mean_with_lens(x, lens),
                "audio_embeds_lens": lens}


@register("M2TransformerEncoder")
class M2TransformerEncoder(nn.Module):
    """Meshed-memory transformer encoder (encoder.py:1309-1348): each layer
    appends ``memory_slots`` learnt key/value slots (keys scaled by √d_k,
    values by √m) to its projected keys and values; the slots are always
    attendable, padded positions masked as keys only.  Sinusoidal positions
    are added after the input projection."""

    def __init__(self, inputdim: int, embed_size: int = 512, nhead: int = 8,
                 nlayers: int = 2, dim_feedforward: int = 2048,
                 memory_slots: int = 40, dropout: float = 0.1, device=None):
        super().__init__()
        self.embed_size, self.nhead, self.nlayers = embed_size, nhead, nlayers
        self.memory_slots, self.dropout = memory_slots, dropout
        D, dh = embed_size, embed_size // nhead
        self.attn_proj = _dense(inputdim, D, "xavier_uniform", device)
        for i in range(nlayers):
            for name in ("wq", "wk", "wv", "wo"):
                self.add_module(f"l{i}_{name}", _dense(D, D, device=device))
            self.register_parameter(f"l{i}_mem_k", nn.Parameter(
                torch.randn(memory_slots, D, device=device) / dh))
            self.register_parameter(f"l{i}_mem_v", nn.Parameter(
                torch.randn(memory_slots, D, device=device) / memory_slots))
            self.add_module(f"l{i}_norm1", nn.LayerNorm(D, eps=1e-6, device=device))
            self.add_module(f"l{i}_ff1", _dense(D, dim_feedforward, device=device))
            self.add_module(f"l{i}_ff2", _dense(dim_feedforward, D, device=device))
            self.add_module(f"l{i}_norm2", nn.LayerNorm(D, eps=1e-6, device=device))

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        D, H, M = self.embed_size, self.nhead, self.memory_slots
        dh = D // H
        x = self.attn_proj(feats)
        N, T = x.shape[:2]
        x = x + sinusoidal_pe(T, D).to(x.device)[None]
        kv_mask = torch.cat([length_mask(feat_lens, T),
                             torch.ones((N, M), dtype=torch.bool, device=x.device)],
                            dim=1)

        def heads(t):
            return t.reshape(N, t.shape[1], H, dh).transpose(1, 2)
        for i in range(self.nlayers):
            layer = lambda name: getattr(self, f"l{i}_{name}")  # noqa: E731
            mk = (dh ** 0.5) * layer("mem_k").expand(N, M, D)
            mv = (M ** 0.5) * layer("mem_v").expand(N, M, D)
            k = torch.cat([layer("wk")(x), mk], dim=1)
            v = torch.cat([layer("wv")(x), mv], dim=1)
            scores = heads(layer("wq")(x)) @ heads(k).transpose(2, 3) / (dh ** 0.5)
            scores = scores.masked_fill(~kv_mask[:, None, None, :], -1e9)
            out = (torch.softmax(scores, dim=-1) @ heads(v)).transpose(1, 2)
            out = layer("wo")(out.reshape(N, T, D))
            x = layer("norm1")(x + F.dropout(out, self.dropout, train))
            ff = layer("ff2")(F.dropout(F.relu(layer("ff1")(x)), self.dropout,
                                        train))
            x = layer("norm2")(x + F.dropout(ff, self.dropout, train))
        return {"audio_embeds": x, "audio_embeds_pooled": mean_with_lens(x, feat_lens),
                "audio_embeds_lens": feat_lens}


@register("RNNEncoder")
class RNNEncoder(nn.Module):
    """GRU encoder (encoder.py:709-762): the frames are the GRU's outputs;
    the pooled vector is the last valid output (``representation="time"``)
    or the masked mean (``"mean"``), through ``outputlayer`` and a
    BatchNorm at flax momentum 0.01."""

    def __init__(self, inputdim: int, embed_size: int = 256,
                 hidden_size: int = 256, bidirectional: bool = False,
                 representation: str = "time", device=None):
        super().__init__()
        self.embed_size, self.representation = embed_size, representation
        dirs = 2 if bidirectional else 1
        self.gru = GRU(inputdim, hidden_size, bidirectional=bidirectional,
                       device=device)
        self.outputlayer = _dense(dirs * hidden_size, embed_size,
                                  "kaiming_uniform", device)
        self.bn = BatchNorm(embed_size, momentum=0.01, device=device)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        out_time, _ = self.gru(feats, feat_lens)
        if self.representation == "mean":
            out = mean_with_lens(out_time, feat_lens)
        else:
            idx = torch.clamp_min(feat_lens.long() - 1, 0)
            out = out_time[torch.arange(out_time.shape[0]), idx]
        out = self.bn(self.outputlayer(out), train, dtype=torch.float32)
        return {"audio_embeds": out_time, "audio_embeds_pooled": out,
                "audio_embeds_lens": feat_lens}


def build_encoder(name: str, args: Dict, inputdim: int, device=None) -> nn.Module:
    """The encoder ``name`` from its ``encoder_args`` (``build.py:19-30``):
    a ``dtype`` string becomes a torch dtype, and the composite encoders'
    ``trunk``/``crnn``/``cnn`` given as dicts with a ``name`` are built
    first, each with its own args."""
    if name not in ENCODERS:
        raise KeyError(f"unknown encoder {name!r}; registered: "
                       f"{sorted(ENCODERS)}")
    args = dict(args)
    if "dtype" in args and isinstance(args["dtype"], str):
        args["dtype"] = DTYPES[args["dtype"]]
    for key in ("trunk", "crnn", "cnn"):
        if isinstance(args.get(key), dict):
            sub = dict(args[key])
            args[key] = build_encoder(sub.pop("name"), sub, inputdim, device)
    return ENCODERS[name](inputdim=inputdim, device=device, **args)
