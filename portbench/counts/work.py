"""The work of each part of the flagship Hybrid AC-VAE, counted from the
configuration's shapes, and the least time it needs on the card.

The per-block int8 count re-counts ``chip_smoke.py::bound`` (:550-555, over
its ``CONV_SHAPES``/``CNN14_CONVS``, :318-328) per ConvBlock as a unit:
the operations of its two convs, or the bytes of its input, its weights
(and epilogue vectors) and its *pooled* output, each read or written once,
whichever takes longer; then the head.  An implementation that fuses the
pool into a conv, or cuts the block's kernels otherwise, does the same
work, so the share cannot pass 100% by it.

Operations count a multiply-add as two.  The model work of ``mfu``
counts the convs, the recurrent cells' gate GEMMs, the attention's
projections, scores and contexts, the classifier and the dense heads;
elementwise work (BatchNorm, activations, softmax, the beam's sort) is
left out.
"""
from __future__ import annotations

from typing import Dict, List

from ..reference.params import PANN_CHANNELS as CHANNELS, PANN_STRIDE as STRIDE
from . import peaks


def blocks(arch: str, n: int, t: int, f: int) -> List[Dict]:
    """Per ConvBlock: its input map (h, w), channels, and whether it pools."""
    out, ci, h, w = [], 1, t, f
    chans = CHANNELS[arch]
    for i, co in enumerate(chans):
        pooled = not (arch == "Cnn14" and i == len(chans) - 1)
        out.append({"n": n, "h": h, "w": w, "ci": ci, "co": co, "pooled": pooled,
                    "ops": 2.0 * n * h * w * 9 * (ci * co + co * co)})
        ci = co
        if pooled:
            h, w = h // 2, w // 2
    return out


def encoder_conv_ops(arch: str, n: int, t: int, f: int) -> float:
    return sum(b["ops"] for b in blocks(arch, n, t, f))


def int8_block_bytes(b: Dict, first: bool, last: bool) -> float:
    """Input read once (the stem: the float32 log-mel), int8 weights and
    four float32 epilogue vectors, the pooled output written once (the last
    conv writes float32)."""
    n, h, w, ci, co = b["n"], b["h"], b["w"], b["ci"], b["co"]
    inp = n * h * w * ci * (4 if first else 1)
    wts = 9 * (ci * co + co * co) + 16 * co
    oh, ow = (h // 2, w // 2) if b["pooled"] else (h, w)
    out = n * oh * ow * co * (4 if last else 1)
    return float(inp + wts + out)


def head(arch: str, n: int, t: int, f: int, enc: int) -> Dict[str, float]:
    """The float32 head after the last block: the mean over mel bins (the
    last map read once, ``audio_embeds`` written once) and the pooled Dense."""
    last = blocks(arch, n, t, f)[-1]
    h, w = (last["h"] // 2, last["w"] // 2) if last["pooled"] else (last["h"], last["w"])
    c = last["co"]
    return {"ops": 2.0 * n * c * enc,
            "bytes": float(n * h * w * c * 4 + n * h * c * 4 + c * enc * 4)}


def int8_encoder_least_s(arch: str, n: int, t: int, f: int, enc: int) -> float:
    """The int8 encoder's least time: per block, then the head."""
    bl = blocks(arch, n, t, f)
    tot = 0.0
    for i, b in enumerate(bl):
        tot += peaks.least_s(b["ops"], int8_block_bytes(b, i == 0, i == len(bl) - 1),
                             "int8")
    hd = head(arch, n, t, f, enc)
    return tot + peaks.least_s(hd["ops"], hd["bytes"], "float32")


def decode_step_ops(rows: int, s: int, d: Dict[str, int]) -> float:
    """One prior step and one decoder step over ``rows`` beams, attending to
    ``s`` frames (widths from ``reference/params.py::dims``)."""
    E, H, PH, V = d["E"], d["H"], d["PH"], d["V"]
    prior = (2 * E * E + 2 * s * E + 2 * s * E           # query, scores, context
             + 2 * 3 * E * 4 * PH + 2 * PH * 4 * PH        # LSTM gates
             + 2 * PH * 2 * E)                            # (mu, log var)
    dec = (2 * H * H + 2 * s * H + 2 * s * E
           + 2 * 3 * E * 3 * H + 2 * H * 3 * H            # GRU gates
           + 2 * H * V)                                   # classifier
    return float(rows * (prior + dec))


def serve_batch_least_s(conf: Dict, d: Dict[str, int], n: int, t: int,
                        beam: int, steps: int, int8: bool) -> float:
    """The least time of one served batch's model work at the peaks of the
    precisions the configuration states."""
    arch, prec = conf["encodermodel"], conf["precision"]
    tf = prec.get("tf32", False)
    s = t // STRIDE[arch]
    enc_p = prec["encoder_int8"] if int8 else prec["encoder"]
    least = encoder_conv_ops(arch, n, t, d["F"]) / peaks.rate(enc_p)
    f32 = head(arch, n, t, d["F"], d["enc"])["ops"]
    if d["enc"] != d["E"]:
        f32 += 2.0 * n * s * d["enc"] * d["E"]             # ln
    f32 += 2 * (2.0 * n * s * d["E"] * d["E"])            # the two memories' projections
    f32 += steps * decode_step_ops(n * beam, s, d)
    return least + f32 / peaks.rate(prec["decoder"], tf)


def train_step_least_s(conf: Dict, d: Dict[str, int], n: int, t: int,
                       cap_len: int) -> float:
    """The least time of one train step's model work: the forward's work
    three times over (forward and backward), at the peaks of the
    configuration's precisions."""
    arch, prec = conf["encodermodel"], conf["precision"]
    tf = prec.get("tf32", False)
    s, T = t // STRIDE[arch], cap_len - 1
    E, QH = d["E"], d["QH"]
    conv = encoder_conv_ops(arch, n, t, d["F"]) / peaks.rate(prec["encoder"])
    f32 = head(arch, n, t, d["F"], d["enc"])["ops"]
    f32 += 2 * T * n * (2 * E * 3 * QH + 2 * QH * 3 * QH)   # the BiGRU
    f32 += 2.0 * n * T * 2 * QH * 2 * E                     # token (mu, log var)
    f32 += 2 * (2.0 * n * s * E * E)                        # the memories' projections
    f32 += T * decode_step_ops(n, s, d)
    f32 += 2.0 * n * d["H"] * 2 * E                         # the global constraint
    return 3.0 * (conv + f32 / peaks.rate(prec["posterior"], tf))
