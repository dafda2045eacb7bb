"""Plain reference of the int8 serving encoder (scheme v2sym: per-channel
symmetric weights and activations) of a PANN Cnn10 or Cnn14, worked out
again from the float32 weights: the calibration, the folded BatchNorms,
the quantized weights and the per-channel epilogues.

The scheme, as the model card of the int8 path describes it:

* calibration: a batch of 8 clips of 512 frames drawn from bn0's running
  statistics, ``mean + sqrt(var + 1e-5) · N(0, 1)`` with numpy's
  ``default_rng(0)``; a float32 shadow pass (BatchNorms folded to ``x·s +
  b``, relu, 2x2 average pools, padded frames masked) records ``max |x| /
  127 + 1e-12`` per channel at the stem's output and after every conv but
  the last;
* weights: each conv's float32 kernel times its input's scales, quantized
  per output channel symmetrically (``round(w / (max|w| / 127))``, clipped
  to +-127);
* the stem: ``clip(round(feats · s0/s + b0/s), -127, 127)`` with bn0's
  folded ``(s0, b0)`` and the stem scale ``s``;
* a conv: the int32 sum of int8 products (borders read code 0), then
  ``acc · A + B`` with ``A = sw · bn_scale / s_out``, ``B = bn_bias / s_out``
  (the last conv: unscaled, then relu, kept float32), rounded half to even
  and clipped to [0, 127];
* pools on codes: ``(a + b + c + d + 2) >> 2``; the last block's pool on
  float32 values: the four taps summed in window order, times 0.25; then
  the mean over mel bins.

The products are summed exactly (float64 convs, cuDNN off); the epilogue
is computed in float64 and rounded to float32 once more, so a value on a
float32 rounding tie may land one code away from a single-rounded FMA.
``q = 7`` gives the control: the same scheme in int4.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .model import finish_encoding, stride
from .params import blocks_of

EPS = 1e-5


def _fold(sd, p):
    """BatchNorm -> (scale, bias) in float32."""
    inv = 1.0 / torch.sqrt(sd[p + ".running_var"].float() + EPS)
    scale = sd[p + ".weight"].float() * inv
    return scale, sd[p + ".bias"].float() - sd[p + ".running_mean"].float() * scale


def _conv_f32(x, w):
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        return F.conv2d(x, w, None, 1, 1)


def _pool_f32(x):
    """2x2 average pool of [N, C, H, W] float32, taps in window order."""
    h, w = x.shape[2] // 2 * 2, x.shape[3] // 2 * 2
    x = x[:, :, :h, :w]
    return (x[:, :, ::2, ::2] + x[:, :, ::2, 1::2] + x[:, :, 1::2, ::2]
            + x[:, :, 1::2, 1::2]) * 0.25


def _pool_codes(x):
    h, w = x.shape[2] // 2 * 2, x.shape[3] // 2 * 2
    x = x[:, :, :h, :w].to(torch.int32)
    s = x[:, :, ::2, ::2] + x[:, :, 1::2, ::2] + x[:, :, ::2, 1::2] + x[:, :, 1::2, 1::2]
    return (s + 2) >> 2


def calibrate(sd, arch: str, q: int = 127) -> Dict:
    """The baked encoder: per conv (codes' weights, A, B), the stem's
    coefficients."""
    dev = sd["encoder.bn0.weight"].device
    chans = [co for _, co in blocks_of(sd)]
    n_convs = 2 * len(chans)
    s0, b0 = _fold(sd, "encoder.bn0")
    mean = sd["encoder.bn0.running_mean"].float().cpu().numpy()
    std = np.sqrt(sd["encoder.bn0.running_var"].float().cpu().numpy() + 1e-5)
    rng = np.random.default_rng(0)
    feats = (mean[None, None, :] + std[None, None, :]
             * rng.normal(size=(8, 512, len(mean)))).astype(np.float32)
    lens = torch.full((8,), 512, device=dev)
    x = (torch.tensor(feats, device=dev) * s0 + b0)[:, None]       # [N, 1, T, F]

    def smax(v, n_valid):
        m = torch.arange(v.shape[2], device=dev)[None, None, :, None] < n_valid[:, None, None, None]
        a = torch.where(m, v.abs(), 0.0).amax(dim=(0, 2, 3))
        return (a.cpu().numpy().astype(np.float32) / np.float32(q)
                + np.float32(1e-12)).astype(np.float32)

    scales = [smax(x, lens)]
    convs: List[Dict] = []
    k = 0
    for i, co in enumerate(chans):
        p = f"encoder.conv_block{i + 1}"
        for j in (1, 2):
            k += 1
            w = sd[f"{p}.conv{j}.weight"].float()
            bs, bb = _fold(sd, f"{p}.bn{j}")
            x = torch.clamp_min(_conv_f32(x, w) * bs[None, :, None, None]
                                + bb[None, :, None, None], 0.0)
            if k < n_convs:
                scales.append(smax(x, lens))
            convs.append({"w": w, "bn": (bs, bb)})
        if not (arch == "Cnn14" and i == len(chans) - 1):
            x = _pool_f32(x)
            lens = torch.clamp_min(lens // 2, 1)
    for k, c in enumerate(convs):
        w_eff = c["w"].cpu().numpy() * scales[k].reshape(1, -1, 1, 1)   # OIHW
        sw = np.maximum(np.max(np.abs(w_eff), axis=(1, 2, 3)) / np.float32(q),
                        np.float32(1e-12)).astype(np.float32)
        c["wq"] = torch.tensor(np.clip(np.round(w_eff / sw.reshape(-1, 1, 1, 1)),
                                       -q, q), device=dev, dtype=torch.float64)
        bs, bb = (t.cpu().numpy() for t in c["bn"])
        A, B = (sw * bs).astype(np.float32), bb.astype(np.float32)
        if k + 1 < n_convs:
            A, B = (A / scales[k + 1]).astype(np.float32), (B / scales[k + 1]).astype(np.float32)
        c["A"], c["B"] = (torch.tensor(a, device=dev, dtype=torch.float64)
                          for a in (A, B))
    s = float(scales[0].reshape(-1)[0])
    st = torch.tensor(s, device=dev, dtype=torch.float32)
    return {"arch": arch, "q": q, "convs": convs, "c1": s0 / st, "c2": b0 / st}


def encode(baked: Dict, sd, feats, lens, block: int = 4) -> Dict[str, torch.Tensor]:
    """The int8 encoder over [N, T, F] log-mels, ``block`` clips at a time
    (the float64 convs' temporaries stay near a GB)."""
    outs = []
    for n0 in range(0, feats.shape[0], block):
        outs.append(_encode(baked, feats[n0:n0 + block]))
    emb = torch.cat(outs)
    return finish_encoding(sd, emb, lens // stride(sd, baked["arch"]))


def _encode(baked, feats):
    q, arch = baked["q"], baked["arch"]
    n_blocks = len(baked["convs"]) // 2
    n_convs = 2 * n_blocks
    y = feats.double() * baked["c1"].double() + baked["c2"].double()
    x = torch.clamp(torch.round(y.float()), -q, q).double()[:, None]   # codes
    k = 0
    with torch.backends.cudnn.flags(enabled=False):
        for i in range(n_blocks):
            for _ in (1, 2):
                c = baked["convs"][k]
                k += 1
                acc = F.conv2d(x, c["wq"], None, 1, 1)
                y = (acc * c["A"][None, :, None, None]
                     + c["B"][None, :, None, None]).float()
                if k < n_convs:
                    x = torch.clamp(torch.round(y), 0, q).double()
                else:
                    x = torch.clamp_min(y, 0.0)
            last = arch == "Cnn14" and i == n_blocks - 1
            if not last:
                x = _pool_f32(x) if k == n_convs else _pool_codes(x).double()
    return x.float().mean(dim=3).transpose(1, 2)                      # [N, T', C]
