"""Int8 serving encoder (counterpart of ``acvae_tpu/models/quant.py``).

Reinterprets the port's trained f32 PANN ``Cnn10`` or ``Cnn14`` as an int8
conv pipeline, inference only, with the JAX package's schemes and
arithmetic:

* conv weights: symmetric per-output-channel int8, with the per-input-channel
  activation scales folded in before quantization (bake time);
* activations: static scales calibrated by an f32 shadow pass over one
  batch (padded frames masked out of the maxima); the stem is symmetric
  int8, post-relu points symmetric (0..127) or offset-coded (255 levels,
  zero point -128, explicit -128 border) per scheme;
* each conv accumulates int8·int8 in int32 and collapses dequantize, the
  folded BatchNorm, relu and requantize into one per-channel affine
  ``acc·A + B`` in its epilogue; the 2×2 pool runs on the codes.

On the card the conv and the pool are the hand-written kernels of
``ops/cuda/conv_i8_kernel.py``; the stem quantization, the final f32 pool
and the head are plain PyTorch.  Bake-time arithmetic (BN fold, weight fold
and quantization, epilogue affine) runs on the host in numpy float32,
exactly as the JAX package computes it; the calibration's f32 convs run on
the encoder's device with TF32 off.

Schemes (``--int8_scheme``): v1 per-tensor symmetric; v2 per-channel +
offset coding; v2sym per-channel symmetric (the serving default); v3 v2sym
+ MSE-optimal clips + bias correction; v4 v2sym + quantized tail.  Cnn14's
last block has no pool, so its five pools all run on the codes, and its
last conv's 18,432-term int32 sums (2048 channels) reach ~3e8, past
float32's 2^24: the conversion rounds to nearest, as JAX's
``astype(float32)`` does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from acvae_tpu_torch.ops.cuda.conv_i8_kernel import (avgpool2x2_i8, conv3x3_i8,
                                                     pack_conv3x3_weight)
from acvae_tpu_torch.ops.int8 import (ZP, avgpool2x2_f32, quant_stem,
                                      requantize_ref)
from acvae_tpu_torch.ops.masked import max_with_lens, mean_with_lens

# clip ratios searched by the MSE-optimal calibration (r=1.0 = abs-max)
_CLIP_GRID = np.linspace(0.5, 1.0, 11).astype(np.float32)
_FLAGS = ("per_channel", "offset", "mse_clip", "bias_correct", "quant_tail")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _fold_bn(bn) -> Tuple[np.ndarray, np.ndarray]:
    """Inference BN (a port ``BatchNorm``) -> (scale, bias), float32, in the
    JAX package's order of operations (``quant.py:71-75``)."""
    var = bn.running_var.detach().cpu().float()
    inv = 1.0 / torch.sqrt(var + bn.eps)
    scale = bn.weight.detach().cpu().float() * inv
    bias = bn.bias.detach().cpu().float() - bn.running_mean.detach().cpu().float() * scale
    return scale.numpy(), bias.numpy()


def _quantize_w(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 (HWIO -> scale over HWI)."""
    s = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
    s = np.maximum(s, 1e-12)
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), \
        s.astype(np.float32)


def _mse_scale(a: torch.Tensor, s_absmax: np.ndarray, levels: float,
               dims) -> np.ndarray:
    """MSE-optimal clip search (``quant.py:107-126``): the scale
    ``r·s_absmax`` (r in _CLIP_GRID) with the least round-trip error of the
    non-negative magnitudes ``a`` [N, T, F, C]."""
    errs = []
    for r in _CLIP_GRID:
        sr = torch.as_tensor(s_absmax * np.float32(r), device=a.device)
        q = torch.clamp(torch.round(a / sr), 0, levels)
        err = (a - q * sr) ** 2
        errs.append(_np(torch.sum(err, dim=dims) if dims else torch.sum(err)))
    best = np.argmin(np.stack(errs, 0), axis=0)
    return (s_absmax * _CLIP_GRID[best]).astype(np.float32)


def _arch_spec(arch: str, channels: Sequence[int]) -> Dict[str, Any]:
    """Block modules / pooling plan / head per PANN architecture
    (``quant.py:129-141``; the port's module names)."""
    if arch == "Cnn10":
        return {"blocks": [(f"conv_block{i + 1}", True)
                           for i in range(len(channels))],
                "head": "embed_pooled", "subsample": 16}
    if arch == "Cnn14":
        return {"blocks": [(f"conv_block{i + 1}", i < 5) for i in range(6)],
                "head": "fc1", "subsample": 32}
    raise ValueError(f"int8 quantization supports Cnn10/Cnn14, not {arch!r}")


def _conv_f32(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """SAME 3×3 f32 conv in NHWC/HWIO."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _no_tf32():
    """f32 convs in full float32 on the card (cuDNN's default is TF32), so
    that a calibration on the card sees what the CPU sees."""
    return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                      allow_tf32=False)


def _frame_mask(n_time: int, n_valid: torch.Tensor) -> torch.Tensor:
    return (torch.arange(n_time, device=n_valid.device)[None, :]
            < n_valid[:, None])[:, :, None, None]


class QuantPannEncoder:
    """Int8 reinterpretation of a trained port ``Cnn10`` or ``Cnn14``.

    ``QuantPannEncoder(encoder, calib_feats, calib_lens, **scheme)`` (or
    :meth:`from_bn0_stats`) bakes on the encoder's device; then
    ``quant(feats, feat_lens)`` returns the encoder dict contract
    (``audio_embeds`` [N, T', C], ``audio_embeds_pooled`` [N, E],
    ``audio_embeds_lens``).  ``act_scales`` are numpy float32 (a [C] vector
    per quantize point, or a scalar), and each block holds its int8 HWIO
    weights ``w1``/``w2``, the kernels' OHWI copies ``wk1``/``wk2`` and the
    epilogue affines ``A1``/``B1``/``A2``/``B2`` on the device.
    """

    def __init__(self, encoder: Optional[torch.nn.Module],
                 calib_feats: Optional[torch.Tensor] = None,
                 calib_lens: Optional[torch.Tensor] = None,
                 arch: str = "Cnn10",
                 channels: Optional[Sequence[int]] = None,
                 per_channel: bool = True, offset: bool = True,
                 mse_clip: bool = False, bias_correct: bool = False,
                 quant_tail: bool = False):
        self.per_channel = bool(per_channel)
        self.offset = bool(offset)
        self.mse_clip = bool(mse_clip)
        self.bias_correct = bool(bias_correct)
        self.quant_tail = bool(quant_tail)
        if self.quant_tail and self.offset:
            raise ValueError("quant_tail composes with symmetric coding "
                             "(offset=False) only")
        if self.quant_tail and self.bias_correct:
            raise ValueError("quant_tail does not compose with bias_correct "
                             "(the correction pass walks the f32 tail)")
        if encoder is None:  # filled in by from_arrays
            return
        if channels is None:
            channels = [blk.conv1.weight.shape[0] for blk in encoder.blocks]
        spec = _arch_spec(arch, channels)
        self.subsample = spec["subsample"]
        self.device = encoder.bn0.running_mean.device
        self.bn0 = _fold_bn(encoder.bn0)
        self.blocks: List[Dict[str, Any]] = []
        for name, pooled in spec["blocks"]:
            mod = getattr(encoder, name)
            blk: Dict[str, Any] = {"pool": pooled}
            for j in (1, 2):
                blk[f"wf{j}"] = _np(getattr(mod, f"conv{j}").weight.float()
                                    ).transpose(2, 3, 1, 0).copy()  # HWIO
                blk[f"bn{j}"] = _fold_bn(getattr(mod, f"bn{j}"))
            self.blocks.append(blk)
        # the JAX stem's padded input lanes (HWIO), for v1's weight scale
        self.stem_pad = _np(encoder.stem_pad_lanes.float()).transpose(2, 3, 1, 0)
        head = getattr(encoder, spec["head"])
        self.fc = (head.weight.detach().float(), head.bias.detach().float())
        feats = torch.as_tensor(calib_feats, dtype=torch.float32, device=self.device)
        lens = torch.as_tensor(calib_lens, device=self.device).long()
        with torch.no_grad(), _no_tf32():
            self.act_scales = self._calibrate(feats, lens)
            self._fold_and_quantize()
            self._bake_epilogues()
            self._device_constants()
            if self.bias_correct:
                self._bias_correct_pass(feats, lens)
        for blk in self.blocks:  # the f32 kernels are bake-time only
            del blk["wf1"], blk["wf2"]
        del self.stem_pad, self.stem_pad_scale

    @classmethod
    def from_bn0_stats(cls, encoder: torch.nn.Module, arch: str = "Cnn10",
                       channels: Optional[Sequence[int]] = None,
                       n: int = 8, t: int = 512, seed: int = 0,
                       **kw) -> "QuantPannEncoder":
        """Calibrate on a batch synthesized from bn0's running statistics,
        ``mean + sqrt(var + 1e-5)·N(0, 1)`` per mel bin, drawn with
        ``np.random.default_rng(seed)`` as the JAX package draws it
        (``quant.py:217-237``)."""
        mean = _np(encoder.bn0.running_mean.float())
        std = np.sqrt(_np(encoder.bn0.running_var.float()) + 1e-5)
        rng = np.random.default_rng(seed)
        feats = (mean[None, None, :]
                 + std[None, None, :] * rng.normal(size=(n, t, len(mean))))
        lens = np.full((n,), t, np.int32)
        dev = encoder.bn0.running_mean.device
        return cls(encoder, torch.tensor(feats.astype(np.float32), device=dev),
                   torch.tensor(lens, device=dev), arch=arch, channels=channels,
                   **kw)

    @classmethod
    def from_arrays(cls, arrays: Dict[str, Any], device) -> "QuantPannEncoder":
        """An encoder from baked arrays, without calibrating (see
        ``convert.py::quant_from_flax``): ``act_scales``, ``bn0`` (scale,
        bias), ``fc`` (weight [out, in], bias), ``subsample``, the scheme
        flags, and per block ``pool``, ``w1``/``w2`` (int8 HWIO),
        ``A1``/``A2``, ``B1``/``B2``."""
        self = cls(None, **{k: bool(arrays[k]) for k in _FLAGS})
        self.subsample = int(arrays["subsample"])
        self.device = torch.device("cpu")
        self.act_scales = [np.asarray(s, np.float32) for s in arrays["act_scales"]]
        self.bn0 = tuple(np.asarray(a, np.float32) for a in arrays["bn0"])
        self.fc = tuple(torch.tensor(np.asarray(a, np.float32)) for a in arrays["fc"])
        self.blocks = []
        for b in arrays["blocks"]:
            blk = {"pool": bool(b["pool"])}
            for j in (1, 2):
                blk[f"w{j}"] = torch.tensor(np.asarray(b[f"w{j}"], np.int8))
                blk[f"wk{j}"] = pack_conv3x3_weight(blk[f"w{j}"])
                for k in ("A", "B"):
                    blk[f"{k}{j}"] = torch.tensor(np.asarray(b[f"{k}{j}"], np.float32))
            self.blocks.append(blk)
        return self.to(device)

    def to(self, device) -> "QuantPannEncoder":
        """Move the runtime tensors to ``device`` (in place); returns self."""
        self.device = torch.device(device)
        self.fc = tuple(t.to(self.device) for t in self.fc)
        for blk in self.blocks:
            for k, v in blk.items():
                if isinstance(v, torch.Tensor):
                    blk[k] = v.to(self.device)
        self._device_constants()
        return self

    def _device_constants(self) -> None:
        """bn0's affine, the stem's scale and (quant_tail) the final scale
        as tensors on the device, for the runtime path."""
        self._bn0 = tuple(torch.tensor(a, device=self.device) for a in self.bn0)
        s_q = self.act_scales[0]
        self._s_stem = torch.tensor(s_q.reshape(-1)[0] if s_q.ndim else s_q,
                                    device=self.device)
        self._s_tail = (torch.tensor(self.act_scales[2 * len(self.blocks)],
                                     device=self.device)
                        if self.quant_tail else None)

    # -------------------------------------------------------------- #
    def _stem(self, feats: torch.Tensor) -> torch.Tensor:
        """bn0 in f32 (mul, then add), one lane: [N, T, F, 1]."""
        s0, b0 = (torch.as_tensor(a, device=feats.device) for a in self.bn0)
        return (feats * s0 + b0)[..., None]

    def _quant_stem(self, feats: torch.Tensor) -> torch.Tensor:
        return quant_stem(feats, *self._bn0, self._s_stem)

    def _levels(self, i: int) -> float:
        """Levels per unit scale at quantize point i: the stem (i=0) is
        symmetric 127; post-relu points use 255 under offset coding."""
        return 255.0 if (self.offset and i > 0) else 127.0

    def _mode(self, k: int, n_convs: int) -> str:
        if k == n_convs and not self.quant_tail:
            return "f32relu"
        return "offset" if self.offset else "sym"

    def _pad(self, k: int) -> int:
        """Offset-coded inputs (every conv after the first) read -ZP at the
        border: the code of v = 0, as the f32 path's zero padding."""
        return -ZP if (self.offset and k > 1) else 0

    def _calibrate(self, feats: torch.Tensor, lens: torch.Tensor) -> list:
        """f32 shadow pass recording max|activation| at every quantize
        point (``quant.py:269-317``): the stem output, then each conv's
        post-relu output before pooling; padded frames masked out."""
        dims = (0, 1, 2) if self.per_channel else None
        cur_lens = lens

        def smax(v, n_valid, levels):
            a = torch.where(_frame_mask(v.shape[1], n_valid), torch.abs(v), 0.0)
            m = torch.amax(a, dim=dims) if dims else torch.amax(a)
            s = _np(m).astype(np.float32) / levels + 1e-12
            if not self.mse_clip:
                return s
            return _mse_scale(a, s, levels, dims)

        n_convs = 2 * len(self.blocks)
        x = self._stem(feats)
        scales = [smax(x, cur_lens, self._levels(0))]
        # the scale JAX gives each padded stem lane: its own max of zeros
        # per channel, the stem's one scale per tensor
        zeros = torch.zeros((1, 1, 1, self.stem_pad.shape[2]), device=x.device)
        self.stem_pad_scale = (smax(zeros, torch.ones(1, device=x.device),
                                    self._levels(0))
                               if self.per_channel else scales[0])
        k = 0
        for blk in self.blocks:
            for j in (1, 2):
                k += 1
                x = _conv_f32(x, torch.as_tensor(blk[f"wf{j}"], device=x.device))
                s, b = (torch.as_tensor(a, device=x.device) for a in blk[f"bn{j}"])
                x = torch.clamp_min(x * s + b, 0.0)
                if k < n_convs or self.quant_tail:
                    scales.append(smax(x, cur_lens, self._levels(k)))
            if blk["pool"]:
                x = avgpool2x2_f32(x)
                cur_lens = torch.clamp_min(cur_lens // 2, 1)
        return scales

    def _fold_and_quantize(self) -> None:
        """Fold each conv's input scales into its f32 kernel, quantize per
        output channel (``quant.py:319-334``).  The stem conv is quantized
        over its padded lanes too, as JAX's is, and keeps lane 0."""
        for i, blk in enumerate(self.blocks):
            for j in (1, 2):
                s_in = self.act_scales[2 * i + j - 1]
                w_eff = blk[f"wf{j}"] * np.reshape(
                    np.asarray(s_in, np.float32), (1, 1, -1, 1))
                lanes = w_eff.shape[2]
                if i == 0 and j == 1:
                    w_eff = np.concatenate([w_eff, self.stem_pad * np.reshape(
                        np.asarray(self.stem_pad_scale, np.float32),
                        (1, 1, -1, 1))], axis=2)
                w_i8, sw = _quantize_w(w_eff)
                blk[f"w{j}"] = torch.tensor(w_i8[:, :, :lanes], device=self.device)
                blk[f"wk{j}"] = pack_conv3x3_weight(blk[f"w{j}"])
                blk[f"sw{j}"] = sw
                # zero-point correction for offset inputs: ZP·Σ_hwi w_i8
                blk[f"zpk{j}"] = np.sum(w_i8.astype(np.int64),
                                        axis=(0, 1, 2)).astype(np.float32)

    def _bake_epilogues(self) -> None:
        """(weight scale × BN scale [/ output scale]) per conv, with the
        offset inputs' ``ZP·Σw`` in the bias (``quant.py:336-361``)."""
        n_convs = 2 * len(self.blocks)
        i = 0
        for blk in self.blocks:
            for j in (1, 2):
                i += 1
                bs, bb = blk[f"bn{j}"]
                A = blk[f"sw{j}"] * np.asarray(bs, np.float32)
                B = np.asarray(bb, np.float32).copy()
                if self.offset and i > 1:  # conv input is offset-coded
                    B = B + A * ZP * blk[f"zpk{j}"]
                if i < n_convs or self.quant_tail:
                    s_out = self.act_scales[i]
                    if self.per_channel:
                        A, B = A / s_out, B / s_out
                    else:
                        A, B = A / float(s_out), B / float(s_out)
                blk[f"A{j}"] = torch.tensor(A, device=self.device)
                blk[f"B{j}"] = torch.tensor(B, device=self.device)

    def _bias_correct_pass(self, feats: torch.Tensor, lens: torch.Tensor) -> None:
        """Fold the measured per-channel mean quantization error on the
        calibration batch into each conv's bias (``quant.py:363-421``),
        walking the exact f32 path and the quantized one side by side; the
        quantized convs and pools are the serving kernels."""
        cur_lens = lens
        x_ref = self._stem(feats)
        x_i8 = self._quant_stem(feats)
        n = len(self.blocks)
        n_convs = 2 * n
        k = 0
        for bi, blk in enumerate(self.blocks):
            for j in (1, 2):
                k += 1
                bs, bb = (torch.as_tensor(a, device=feats.device)
                          for a in blk[f"bn{j}"])
                y_ref = _conv_f32(x_ref, torch.as_tensor(
                    blk[f"wf{j}"], device=feats.device)) * bs + bb
                y = conv3x3_i8(x_i8, blk[f"wk{j}"], blk[f"A{j}"], blk[f"B{j}"],
                               "f32", self._pad(k))
                if k < n_convs:
                    s_out = torch.as_tensor(self.act_scales[k], device=feats.device)
                    y_cmp = y_ref / s_out
                else:
                    y_cmp = y_ref
                m = _frame_mask(y.shape[1], cur_lens)
                cnt = torch.clamp_min(torch.sum(m) * y.shape[2], 1)
                d = torch.sum(torch.where(m, y_cmp - y, 0.0), dim=(0, 1, 2)) / cnt
                blk[f"B{j}"] = blk[f"B{j}"] + d
                y = y + d
                if not (bi == n - 1 and j == 2):
                    x_i8 = requantize_ref(y, self._mode(k, n_convs))
                x_ref = torch.clamp_min(y_ref, 0.0)
            if blk["pool"]:
                x_ref = avgpool2x2_f32(x_ref)
                if bi < n - 1:
                    x_i8 = avgpool2x2_i8(x_i8)
                cur_lens = torch.clamp_min(cur_lens // 2, 1)

    # -------------------------------------------------------------- #
    def __call__(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                 train: bool = False,
                 codes: Optional[list] = None) -> Dict[str, torch.Tensor]:
        """Encode [N, T, F] log-mels.  With ``codes`` a list, the int8
        activation at every quantize point (stem, then each requantized
        conv output) is appended to it, before pooling."""
        assert not train, "QuantPannEncoder is inference-only"
        lens = feat_lens // self.subsample
        x = self._quant_stem(feats.float())
        if codes is not None:
            codes.append(x)
        n = len(self.blocks)
        n_convs, k = 2 * n, 0
        for bi, blk in enumerate(self.blocks):
            for j in (1, 2):
                k += 1
                mode = self._mode(k, n_convs)
                x = conv3x3_i8(x, blk[f"wk{j}"], blk[f"A{j}"], blk[f"B{j}"],
                               mode, self._pad(k))
                if codes is not None and mode != "f32relu":
                    codes.append(x)
            if blk["pool"]:
                x = avgpool2x2_f32(x) if x.dtype == torch.float32 \
                    else avgpool2x2_i8(x)
        if self.quant_tail:
            # freq mean on the codes (int32 sum over the last map's bins:
            # Cnn10's 4 after its pool, Cnn14's 2 unpooled), dequantized
            # on the smaller [N, T', C]
            x = (torch.sum(x.to(torch.int32), dim=2).float()
                 * (self._s_tail / x.shape[2]))
        else:
            x = torch.mean(x, dim=2)               # [N, T', C]
        pooled = max_with_lens(x, lens) + mean_with_lens(x, lens)
        pooled = F.relu(F.linear(pooled, self.fc[0], self.fc[1]))
        return {"audio_embeds": x, "audio_embeds_pooled": pooled,
                "audio_embeds_lens": lens}


# the JAX package's name for it (Cnn10, the default arch)
QuantCnn10 = QuantPannEncoder

# named quantization schemes (``quant.py:498-521``, the --int8_scheme values)
SCHEMES: Dict[str, Dict[str, bool]] = {
    "v1": {"per_channel": False, "offset": False},
    "v2": {"per_channel": True, "offset": True},
    "v2sym": {"per_channel": True, "offset": False},
    "v3": {"per_channel": True, "offset": False,
           "mse_clip": True, "bias_correct": True},
    "v4": {"per_channel": True, "offset": False, "quant_tail": True},
}

# the serving default (quant.py:524-527)
DEFAULT_INT8_SCHEME = "v2sym"


def scheme_kwargs(name: str) -> Dict[str, bool]:
    if name not in SCHEMES:
        raise ValueError(
            f"int8_scheme must be one of {sorted(SCHEMES)}, got {name!r}")
    return dict(SCHEMES[name])


def quant_encoder_for(conf: Dict[str, Any], model: Any,
                      calib: Optional[Tuple[Any, Any]] = None,
                      **scheme_kw) -> QuantPannEncoder:
    """Check an experiment's config and model for int8 serving and bake the
    encoder on the model's device (``quant.py:537-572``).  ``calib=(feats,
    feat_lens)`` calibrates on a real batch; without it the scales come from
    bn0's running statistics."""
    if conf.get("encodermodel") not in ("Cnn10", "Cnn14"):
        raise ValueError("encoder_int8 supports the PANN Cnn10/"
                         "Cnn14 encoders only")
    if not hasattr(model, "inference_from_encoded"):
        raise ValueError(
            "encoder_int8 requires a model exposing inference_from_encoded "
            f"(the VAECaptionModel family); {type(model).__name__} does not")
    encoder = model.encoder
    if not hasattr(encoder, "bn0"):
        raise ValueError(
            "encoder_int8 needs the encoder's bn0 running mean/var for "
            "calibration; this encoder has none")
    arch = conf["encodermodel"]
    channels = tuple(conf.get("encoder_args", {}).get(
        "channels", (64, 128, 256, 512)))
    if calib is not None:
        feats, lens = calib
        return QuantPannEncoder(encoder, feats, lens, arch=arch,
                                channels=channels, **scheme_kw)
    return QuantPannEncoder.from_bn0_stats(encoder, arch=arch,
                                           channels=channels, **scheme_kw)


def int8_decode_fn(model: Any, quant: QuantPannEncoder, **decode_kwargs):
    """Decode closure: the int8 encoder in front of the model's decode
    (``inference_from_encoded`` with the encoder->decoder adapter, where the
    model has one).  Call it as ``decode(feats, feat_lens, generator=...,
    eps=...)``."""
    from torch.profiler import record_function

    def decode(feats, feat_lens, **kw):
        with torch.inference_mode():
            with record_function("encoder"):
                encoded = quant(feats, feat_lens)
            return model.inference_from_encoded(encoded, apply_ln=True,
                                                **decode_kwargs, **kw)
    return decode
