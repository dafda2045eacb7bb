"""Flax variables -> a port ``state_dict``.

``from_flax(variables)`` takes the JAX package's ``{"params": ...,
"batch_stats": ...}`` tree (numpy or array leaves) of the flagship model and
returns the tensors under the port's (the reference's torch) names:

* Dense kernels [in, out] and RNN ``wi``/``wh`` transpose to torch's
  [out, in]; conv kernels go HWIO -> OIHW; the stem conv keeps only its
  first input lane, and the JAX stem's padded lanes (they read only zeros)
  go to the encoder's ``stem_pad_lanes`` buffer, which the int8 bake reads;
* flax BatchNorm ``scale``/``bias`` and batch_stats ``mean``/``var`` become
  ``weight``/``bias`` and ``running_mean``/``running_var``;
* a BiGRU's ``fwd``/``bwd`` cells become ``*_l0`` / ``*_l0_reverse``;
* an attention's ``dec_proj``/``enc_proj`` kernels join into one
  ``h2attn`` Linear over [h_dec; h_enc].

``quant_from_flax(baked)`` carries a baked JAX int8 encoder across (no new
calibration).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from acvae_tpu_torch import DEFAULT_DEVICE

_RNN = {"wi": "weight_ih", "wh": "weight_hh", "bi": "bias_ih", "bh": "bias_hh"}
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def _module_path(mods) -> Tuple[str, str]:
    """flax module path -> (torch module prefix, rnn weight suffix)."""
    out, suffix = [], ""
    for m in mods:
        blk = re.fullmatch(r"block(\d+)_\d+", m)
        if m == "_MelBatchNorm_0":
            continue
        if blk:
            out.append(f"conv_block{int(blk.group(1)) + 1}")
        elif m == "cell":
            out.append("model")
        elif m in ("fwd", "bwd"):
            suffix = "_l0" if m == "fwd" else "_l0_reverse"
        else:
            out.append(m)
    return ".".join(out), suffix


def from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, np.ndarray] = {}
    attn: Dict[str, Dict[str, np.ndarray]] = {}
    for coll in ("params", "batch_stats"):
        for path, a in _flatten(variables.get(coll, {})):
            *mods, leaf = path
            if mods and mods[-1] in ("dec_proj", "enc_proj"):
                attn.setdefault(_module_path(mods[:-1])[0], {})[
                    f"{mods[-1]}.{leaf}"] = a
                continue
            prefix, suffix = _module_path(mods)
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
    return {k: torch.tensor(v) for k, v in sd.items()}


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
