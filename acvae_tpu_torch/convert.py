"""Flax variables -> a port ``state_dict``.

``from_flax(variables)`` takes the JAX package's ``{"params": ...,
"batch_stats": ...}`` tree (numpy or array leaves) of any model family and
returns the tensors under the port's (the reference's torch) names:

* Dense kernels [in, out] and RNN ``wi``/``wh`` transpose to torch's
  [out, in]; conv kernels go HWIO -> OIHW; a stem conv that stages mels
  (``_stage_mel``) keeps only its first input lane: the PANN family's
  padded lanes (they read only zeros) go to the encoder's
  ``stem_pad_lanes`` buffer, which the int8 bake reads, and CNN10Q/D's
  and CRNN8_Sub4's (``b0_conv1``) are dropped;
* the PANN encoders take PANN's names: Cnn10's ``block<i>_<c>`` is
  ``conv_block<i+1>``; Cnn14's ``block64``..``block2048`` are
  ``conv_block1``..``conv_block6``; in a ResNet38 (told apart by its
  ``layer1_0``) ``block64``/``block2048`` are ``conv_block1``/
  ``conv_block_after1``, ``layer<s>_<b>`` is ``resnet.layer<s>.<b>`` and
  its ``ds_conv``/``ds_bn`` are ``downsample.0``/``downsample.1``;
  ``_MelBatchNorm_0/bn0`` is ``bn0``;
* flax BatchNorm ``scale``/``bias`` and batch_stats ``mean``/``var`` become
  ``weight``/``bias`` and ``running_mean``/``running_var``;
* a BiGRU's ``fwd``/``bwd`` cells become ``*_l0`` / ``*_l0_reverse``;
* an attention's ``dec_proj``/``enc_proj`` kernels join into one
  ``h2attn`` Linear over [h_dec; h_enc];
* a transformer layer ``layer<i>`` becomes ``model.layers.<i>`` and its
  ``cross_attn`` ``multihead_attn``; a ``MultiHeadDotProductAttention``'s
  ``query``/``key``/``value`` kernels [in, heads, head_dim] join (head-major)
  into ``in_proj_weight`` [3E, E] and ``in_proj_bias``, its ``out`` kernel
  [heads, head_dim, out] becomes ``out_proj``; LayerNorm ``scale`` becomes
  ``weight``;
* everything else (``ln``, ``mixture_logits``, the Linear heads) keeps its
  name.

``quant_from_flax(baked)`` carries a baked JAX int8 encoder across (no new
calibration).  ``experiment_from_flax`` writes a JAX experiment's weights,
recipe and vocabulary as a port experiment dir.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from acvae_tpu_torch import DEFAULT_DEVICE

_RNN = {"wi": "weight_ih", "wh": "weight_hh", "bi": "bias_ih", "bh": "bias_hh"}
_MHA = ("query", "key", "value", "out")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def _pann_block(c: int, resnet38: bool) -> str:
    """A PANN ``block<c>`` ConvBlock's torch name: Cnn14's six are
    ``conv_block1``..``conv_block6`` (64..2048); ResNet38's two are
    ``conv_block1`` and ``conv_block_after1``."""
    if resnet38:
        return "conv_block1" if c == 64 else "conv_block_after1"
    return f"conv_block{c.bit_length() - 6}"


def _module_path(mods, resnet38=frozenset()) -> Tuple[str, str]:
    """flax module path -> (torch module prefix, rnn weight suffix).
    ``resnet38`` holds the paths of the ResNet38 encoders in the tree (their
    ``block<c>``/``layer<s>_<b>``/``ds_*`` take PANN's ResNet38 names)."""
    out, suffix = [], ""
    for i, m in enumerate(mods):
        in_r38 = tuple(mods[:i]) in resnet38
        blk = re.fullmatch(r"block(\d+)_\d+", m)
        pann = re.fullmatch(r"block(\d+)", m)
        r38_layer = in_r38 and re.fullmatch(r"layer(\d+)_(\d+)", m)
        layer = re.fullmatch(r"layer(\d+)", m)
        if m == "_MelBatchNorm_0":
            continue
        if blk:
            out.append(f"conv_block{int(blk.group(1)) + 1}")
        elif pann:
            out.append(_pann_block(int(pann.group(1)), in_r38))
        elif r38_layer:
            out.append(f"resnet.layer{r38_layer.group(1)}.{r38_layer.group(2)}")
        elif m in ("ds_conv", "ds_bn") and tuple(mods[:i - 1]) in resnet38:
            out.append("downsample.0" if m == "ds_conv" else "downsample.1")
        elif layer:
            out.append(f"model.layers.{layer.group(1)}")
        elif m == "cross_attn":
            out.append("multihead_attn")
        elif m == "cell":
            out.append("model")
        elif m in ("fwd", "bwd"):
            suffix = "_l0" if m == "fwd" else "_l0_reverse"
        else:
            out.append(m)
    return ".".join(out), suffix


def _resnet38_paths(variables: Dict[str, Any]) -> frozenset:
    """The module paths holding both ``layer1_0`` and ``block2048``: the
    ResNet38 encoders (a ResNetEncoder has ``layer1_0`` and no
    ``block2048``, a Cnn14 ``block2048`` and no ``layer1_0``)."""
    kids: Dict[Tuple[str, ...], set] = {}
    for path, _ in _flatten(variables.get("params", {})):
        for i, m in enumerate(path[:-1]):
            kids.setdefault(tuple(path[:i]), set()).add(m)
    return frozenset(p for p, k in kids.items() if {"layer1_0", "block2048"} <= k)


def from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, np.ndarray] = {}
    attn: Dict[str, Dict[str, np.ndarray]] = {}
    mha: Dict[str, Dict[str, np.ndarray]] = {}
    r38 = _resnet38_paths(variables)
    module_path = lambda mods: _module_path(mods, r38)  # noqa: E731
    for coll in ("params", "batch_stats"):
        for path, a in _flatten(variables.get(coll, {})):
            *mods, leaf = path
            if mods and mods[-1] in ("dec_proj", "enc_proj"):
                attn.setdefault(module_path(mods[:-1])[0], {})[
                    f"{mods[-1]}.{leaf}"] = a
                continue
            if len(mods) > 1 and mods[-1] in _MHA and mods[-2].endswith("_attn"):
                mha.setdefault(module_path(mods[:-1])[0], {})[
                    f"{mods[-1]}.{leaf}"] = a
                continue
            prefix, suffix = module_path(mods)
            key = prefix + "." if prefix else ""
            if coll == "batch_stats":
                sd[key + _STATS[leaf]] = a
            elif leaf in _RNN:
                sd[key + _RNN[leaf] + suffix] = a.T if a.ndim == 2 else a
            elif leaf == "kernel" and a.ndim == 4:
                if prefix.endswith("conv_block1.conv1"):
                    enc = prefix[:-len("conv_block1.conv1")]
                    sd[enc + "stem_pad_lanes"] = a[:, :, 1:, :].transpose(3, 2, 0, 1)
                    a = a[:, :, :1, :]
                elif prefix == "b0_conv1" or prefix.endswith(".b0_conv1"):
                    a = a[:, :, :1, :]   # CNN10Q/D, CRNN8_Sub4: lanes dropped
                sd[key + "weight"] = a.transpose(3, 2, 0, 1)
            elif leaf == "kernel":
                sd[key + "weight"] = a.T
            elif leaf in ("scale", "embedding"):
                sd[key + "weight"] = a
            else:  # bias, v
                sd[key + leaf] = a
    for prefix, parts in attn.items():
        key = prefix + "." if prefix else ""
        sd[key + "h2attn.weight"] = np.concatenate(
            [parts["dec_proj.kernel"].T, parts["enc_proj.kernel"].T], axis=1)
        sd[key + "h2attn.bias"] = parts["enc_proj.bias"]
    for prefix, parts in mha.items():
        key = prefix + "." if prefix else ""
        E = parts["out.kernel"].shape[-1]
        sd[key + "in_proj_weight"] = np.concatenate(
            [parts[f"{p}.kernel"].reshape(-1, E).T for p in _MHA[:3]], axis=0)
        sd[key + "in_proj_bias"] = np.concatenate(
            [parts[f"{p}.bias"].reshape(E) for p in _MHA[:3]])
        sd[key + "out_proj.weight"] = parts["out.kernel"].reshape(E, -1).T
        sd[key + "out_proj.bias"] = parts["out.bias"]
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def experiment_from_flax(tree: Dict[str, Any], conf: Dict[str, Any], vocab,
                         out_dir: str, name: str = "best"):
    """A port experiment dir (``config.json``, ``vocab.pkl``,
    ``<name>.pt``) from a JAX experiment of any ported family: ``tree`` is the numpy tree with
    ``params`` and ``batch_stats`` that
    ``acvae_tpu.train.checkpoints.load_raw_checkpoint(exp, name,
    subset=("params", "batch_stats"))`` returns (the orbax read stays on the
    JAX side), ``conf`` its ``config.yaml`` (read with
    ``core.config.load_config``) and ``vocab`` its vocabulary.  Returns the
    weights' path."""
    from acvae_tpu_torch.models.build import build_model
    from acvae_tpu_torch.train.checkpoints import save_experiment

    conf = json.loads(json.dumps(conf))
    model = build_model(conf, len(vocab), int(conf.get("data_dim", 64)),
                        device="cpu")
    model.load_state_dict(from_flax(tree), strict=True)
    return save_experiment(out_dir, model, conf, vocab, name)


def quant_from_flax(baked: Dict[str, Any], device=DEFAULT_DEVICE):
    """The port's ``QuantPannEncoder`` from the arrays of a baked JAX
    ``acvae_tpu.models.quant.QuantPannEncoder``, as numpy, without
    calibrating again:

    * ``act_scales``: one float32 array (a [C] vector or a scalar) per
      quantize point;
    * ``blocks``: per block ``pool`` and ``w1``/``w2`` (int8 HWIO),
      ``A1``/``A2``, ``B1``/``B2``;
    * ``bn0``: (scale, bias); ``fc``: (kernel [in, out], bias);
    * ``subsample`` and the scheme flags ``per_channel``, ``offset``,
      ``mse_clip``, ``bias_correct``, ``quant_tail``.

    The JAX stem pads its one mel lane with lanes whose codes are always 0
    (``quant.py:246-261``), so their weights add nothing to any accumulator:
    the port drops them, with their activation scales.  A per-channel stem
    scale above the empty-lane floor (0/127 + 1e-12) would mean a padded
    lane was not empty in calibration; that raises."""
    from acvae_tpu_torch.models.quant import QuantPannEncoder

    blocks = [dict(b) for b in baked["blocks"]]
    blocks[0]["w1"] = np.asarray(blocks[0]["w1"])[:, :, :1]
    scales = [np.asarray(s, np.float32) for s in baked["act_scales"]]
    if scales[0].ndim:
        if (scales[0][1:] > np.float32(1e-12)).any():
            raise ValueError("the stem's padded input lanes were not empty "
                             f"in calibration (scales {scales[0]})")
        scales[0] = scales[0][:1]
    kernel, bias = baked["fc"]
    arrays = dict(baked, blocks=blocks, act_scales=scales,
                  fc=(np.asarray(kernel, np.float32).T, bias))
    return QuantPannEncoder.from_arrays(arrays, device)
