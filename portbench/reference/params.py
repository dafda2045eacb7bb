"""The flagship Hybrid AC-VAE's parameters, named and shaped as the port
loads them, and seeded weights for them.

The benchmark owns the weights: ``make_weights`` draws every tensor of
``param_specs`` from one generator on the device in one large call, in
float32 (the type the port keeps its parameters in), and the same dict is
loaded into the port's model (``load_state_dict(strict=True)``, so a
renamed or reshaped tensor fails loudly) and handed to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

PANN_CHANNELS = {"Cnn10": (64, 128, 256, 512),
                 "Cnn14": (64, 128, 256, 512, 1024, 2048)}
PANN_HEAD = {"Cnn10": "embed_pooled", "Cnn14": "fc1"}
# time subsampling of the trunk: 4 pools (Cnn10), 5 (Cnn14: its last block
# has none)
PANN_STRIDE = {"Cnn10": 16, "Cnn14": 32}


def channels(conf: Dict) -> Tuple[int, ...]:
    """The encoder's block widths (Cnn10 may set its own)."""
    arch = conf["encodermodel"]
    return tuple(conf["encoder_args"].get("channels", PANN_CHANNELS[arch]))


def blocks_of(sd) -> List[Tuple[int, int]]:
    """(in, out) channels of each ConvBlock of a state dict."""
    out, i = [], 1
    while f"encoder.conv_block{i}.conv1.weight" in sd:
        w = sd[f"encoder.conv_block{i}.conv1.weight"]
        out.append((w.shape[1], w.shape[0]))
        i += 1
    return out


def dims(conf: Dict) -> Dict[str, int]:
    """The widths the model is built from."""
    arch = conf["encodermodel"]
    enc = conf["encoder_args"]["embed_size"]
    dec = conf["decoder_args"]
    return {"enc": enc, "E": dec["embed_size"], "H": dec["hidden_size"],
            "QH": conf["model_args"]["posterior_args"]["hidden_size"],
            "PH": conf["model_args"]["prior_args"]["hidden_size"],
            "V": conf["vocab_size"], "F": conf["data_dim"],
            "C": channels(conf)[-1]}


def param_specs(conf: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the model's state dict; kind
    picks the draw's law in :func:`make_weights`."""
    arch = conf["encodermodel"]
    d = dims(conf)
    E, H, QH, PH, V, F = d["E"], d["H"], d["QH"], d["PH"], d["V"], d["F"]
    out = []

    def bn(prefix, n):
        out.extend([(f"{prefix}.weight", (n,), "bn_w"),
                    (f"{prefix}.bias", (n,), "bn_b"),
                    (f"{prefix}.running_mean", (n,), "bn_m"),
                    (f"{prefix}.running_var", (n,), "bn_v")])

    def lin(prefix, o, i, bias=True):
        out.append((f"{prefix}.weight", (o, i), "lin"))
        if bias:
            out.append((f"{prefix}.bias", (o,), "bias"))

    chans = channels(conf)
    out.append(("encoder.stem_pad_lanes", (chans[0], 1, 3, 3), "zero"))
    bn("encoder.bn0", F)
    cin = 1
    for i, co in enumerate(chans):
        p = f"encoder.conv_block{i + 1}"
        out.append((f"{p}.conv1.weight", (co, cin, 3, 3), "conv"))
        out.append((f"{p}.conv2.weight", (co, co, 3, 3), "conv"))
        bn(f"{p}.bn1", co)
        bn(f"{p}.bn2", co)
        cin = co
    lin(f"encoder.{PANN_HEAD[arch]}", d["enc"], chans[-1])
    if d["enc"] != E:
        lin("ln", E, d["enc"])
    out.append(("decoder.word_embeddings.weight", (V, E), "emb"))
    out.append(("decoder.attn.v", (H,), "vec"))
    lin("decoder.attn.h2attn", H, H + E)
    out.extend([("decoder.model.weight_ih", (3 * H, 3 * E), "lin"),
                ("decoder.model.weight_hh", (3 * H, H), "lin"),
                ("decoder.model.bias_ih", (3 * H,), "bias"),
                ("decoder.model.bias_hh", (3 * H,), "bias")])
    lin("decoder.classifier", V, H)
    out.append(("qnet.word_embedding.weight", (V, E), "emb"))
    for sfx in ("", "_reverse"):
        out.extend([(f"qnet.network.weight_ih_l0{sfx}", (3 * QH, E), "lin"),
                    (f"qnet.network.weight_hh_l0{sfx}", (3 * QH, QH), "lin"),
                    (f"qnet.network.bias_ih_l0{sfx}", (3 * QH,), "bias"),
                    (f"qnet.network.bias_hh_l0{sfx}", (3 * QH,), "bias")])
    lin("qnet.token_mean_log", 2 * E, 2 * QH)
    out.append(("pnet.word_embedding.weight", (V, E), "emb"))
    out.append(("pnet.word_attn.v", (E,), "vec"))
    lin("pnet.word_attn.h2attn", E, 2 * E)
    out.extend([("pnet.network.weight_ih", (4 * PH, 3 * E), "lin"),
                ("pnet.network.weight_hh", (4 * PH, PH), "lin"),
                ("pnet.network.bias_ih", (4 * PH,), "bias"),
                ("pnet.network.bias_hh", (4 * PH,), "bias")])
    lin("pnet.mean_log_out", 2 * E, PH)
    lin("mean_log_out", 2 * E, H)
    return out


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:])) if len(shape) > 1 else int(shape[0])


def make_weights(conf: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of :func:`param_specs`, drawn from ``seed`` with one
    ``torch.randn`` on ``device`` and carved into views: He-normal convs
    (so the activations keep their scale through relu), LeCun-normal
    linears and attention vectors, unit embeddings, small biases, and
    BatchNorm statistics near the identity (so that bn0's statistics fit
    the traffic's log-mels, which the int8 calibration reads)."""
    specs = param_specs(conf)
    total = sum(math.prod(s) for _, s, _ in specs)
    g = torch.Generator(device).manual_seed(seed % 2**63)
    flat = torch.randn(total, generator=g, device=device)
    sd, off = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        x = flat[off:off + n].view(shape)
        off += n
        if kind == "conv":
            x = x * math.sqrt(2.0 / _fan_in(shape))
        elif kind in ("lin", "vec"):
            x = x / math.sqrt(_fan_in(shape) if kind == "lin" else shape[0])
        elif kind == "bias":
            x = x * 0.02
        elif kind == "bn_w":
            x = 1.0 + 0.1 * x
        elif kind in ("bn_b", "bn_m"):
            x = 0.1 * x
        elif kind == "bn_v":
            x = torch.exp(0.1 * x)
        elif kind == "zero":
            x = torch.zeros_like(x)
        sd[name] = x
    return sd
