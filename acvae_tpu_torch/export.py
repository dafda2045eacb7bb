"""Self-contained decode artifacts with ``torch.export`` (counterpart of
``acvae_tpu/export.py``).

A trained decode is exported once, weights baked in, to ``decode.pt2``
(``torch.export.save``) beside ``meta.json``; :func:`load_exported` loads it
and calls it with no model code, config or checkpoint.  The batch dimension
is symbolic when the program traces with one (``torch.export.Dim``), so one
artifact serves any batch size; the mel length stays static, as the serving
buckets are.

The exported program is ``(feats [b, T, F] float32, feat_lens [b] int32,
*noise) -> {"seqs", "scores"}`` (``scores`` where the decode method makes
them).  Every random draw of the decode is one of the ``noise`` inputs,
float32 standard normals ``eps`` (the prior's noise) or standard Gumbels
``gumbel`` (``gumbel``/``sample``), so the program itself is deterministic.
``meta.json`` lists them under ``noise``: each a ``name``, a ``shape`` and
its ``batch_axis``, whose entry is the rows a clip (the axis is that number
times ``b``).  :func:`load_exported` keeps the JAX package's calling
convention, ``(feats, feat_lens, seed) -> {seqs, scores}``: it draws the
noise from ``torch.Generator(device).manual_seed(seed)``.

The int8 serving encoder's convs and pools are the operators of
``ops/cuda/conv_i8_kernel.py``, the PANN ConvBlock's BatchNorm, ReLU
and pool at inference the operator of ``ops/cuda/bn_relu_kernel.py``, and
the beam's top-k on the card the operator of ``ops/cuda/topk_kernel.py``,
so an artifact launches the hand-written kernels on the card and runs
their plain versions on the CPU.
The port reads no ``.jaxexport`` (StableHLO) artifact: JAX weights cross
through ``convert.py``.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from acvae_tpu_torch import DEFAULT_DEVICE
# registers the int8 operators, the ConvBlock epilogue's and the top-k's
# before a program that calls them is traced or loaded
from acvae_tpu_torch.ops.cuda import bn_relu_kernel, conv_i8_kernel, topk_kernel  # noqa: F401
from acvae_tpu_torch.decoding.dbs import dbs_bdash
from acvae_tpu_torch.decoding.sampling import gumbel_noise
from acvae_tpu_torch.models.captioner import _PlainCaptioner
from acvae_tpu_torch.models.vae import SimpleVAECaptionModel
from acvae_tpu_torch.ops.amp import cast_floats_for_decode

ARTIFACT = "decode.pt2"
# the pinned batch when a program does not trace with a symbolic one
PINNED_BATCH = 32


def noise_spec(model: nn.Module, decode_method: str, max_length: int,
               beam_size: int = 3, group_size: int = 5,
               **_) -> List[Dict[str, Any]]:
    """The noise inputs of ``model``'s decode: ``[{"name", "shape",
    "batch_axis"}]``, ``shape[batch_axis]`` the rows a clip.  The shapes
    are those the models' ``inference_forward`` takes as ``eps`` and
    ``gumbel``."""
    T = max_length or model.max_length
    E = model.decoder.embed_size
    V = model.decoder.word_embeddings.num_embeddings
    spec = []
    if not isinstance(model, _PlainCaptioner):       # the prior's noise
        if decode_method == "beam":
            shape, axis = [T, beam_size, E], 1
        elif decode_method == "dbs":
            shape, axis = [group_size, T + group_size - 1,
                           dbs_bdash(beam_size, group_size), E], 2
        else:
            shape, axis = [T, 1, E], 1
        if isinstance(model, SimpleVAECaptionModel):
            # one global z a caption (a beam slot, a group's beam slot)
            shape = [group_size, shape[2], E] if decode_method == "dbs" \
                else shape[1:]
            axis -= 1
        spec.append({"name": "eps", "shape": shape, "batch_axis": axis})
    if decode_method in ("gumbel", "sample"):
        spec.append({"name": "gumbel", "shape": [T, 1, V], "batch_axis": 1})
    return spec


def draw_noise(spec: List[Dict[str, Any]], batch: int,
               generator: torch.Generator, device) -> List[torch.Tensor]:
    """The noise inputs of a batch, drawn in ``spec``'s order: normals for
    ``eps`` (as ``models/common.py::eps_stack``), Gumbels for ``gumbel``."""
    out = []
    for entry in spec:
        shape = list(entry["shape"])
        shape[entry["batch_axis"]] *= batch
        if entry["name"] == "gumbel":
            out.append(gumbel_noise(shape, generator, device))
        else:
            out.append(torch.randn(shape, generator=generator, device=device))
    return out


class DecodeProgram(nn.Module):
    """The module that is exported: ``forward(feats, feat_lens, *noise)``.
    ``quant`` (an int8 encoder) encodes in front of the model's
    ``inference_from_encoded``; otherwise the model's ``inference_forward``
    runs whole."""

    def __init__(self, model: nn.Module, noise: List[Dict[str, Any]],
                 quant=None, **decode_kwargs):
        super().__init__()
        self.model, self.quant = model, quant
        self.noise = noise
        self.decode_kwargs = decode_kwargs

    def forward(self, feats, feat_lens, *noise):
        kw = dict(self.decode_kwargs)
        kw.update({e["name"]: t for e, t in zip(self.noise, noise)})
        if self.quant is not None:
            out = self.model.inference_from_encoded(
                self.quant(feats, feat_lens), apply_ln=True, **kw)
        else:
            out = self.model.inference_forward(feats, feat_lens, **kw)
        return {k: out[k] for k in ("seqs", "scores") if k in out}


def build_decode_fn(model: nn.Module, decode_dtype: Optional[torch.dtype] = None,
                    **decode_kwargs) -> DecodeProgram:
    """The decode with ``model``'s weights baked in (``export.py:25-48``);
    ``decode_dtype`` (``torch.bfloat16``) casts its float parameters as
    ``ops/amp.py`` does, so the decode loop runs in that dtype."""
    if decode_dtype is not None:
        model = cast_floats_for_decode(model, decode_dtype)
    return DecodeProgram(model.eval(), noise_spec(model, **decode_kwargs),
                         **decode_kwargs)


def build_decode_fn_int8(model: nn.Module, quant, **decode_kwargs) -> DecodeProgram:
    """The same with the int8 serving encoder (``models/quant.py``) in front
    of the model's decode (``export.py:51-66``): its int8 weights and
    epilogue affines become constants of the program."""
    return DecodeProgram(model.eval(), noise_spec(model, **decode_kwargs),
                         quant=quant, **decode_kwargs)


def _example_inputs(fn: DecodeProgram, batch: int, t_mel: int, n_mels: int,
                    device) -> tuple:
    gen = torch.Generator(device).manual_seed(0)
    feats = torch.randn((batch, t_mel, n_mels), generator=gen, device=device)
    lens = torch.full((batch,), t_mel, dtype=torch.int32, device=device)
    return (feats, lens, *draw_noise(fn.noise, batch, gen, device))


def export_decode(fn: DecodeProgram, t_mel: int, n_mels: int,
                  batch: Optional[int] = None):
    """Export a decode (from :func:`build_decode_fn` or
    :func:`build_decode_fn_int8`) on its model's device.  ``batch=None``
    tries a symbolic batch first and pins it to 32 if the program does not
    trace with one; returns ``(exported, batch_desc)``, ``batch_desc``
    ``"symbolic"`` or the pinned batch as a string."""
    device = next(fn.model.parameters()).device
    if batch is None:
        b = torch.export.Dim("b", min=1, max=2**16)
        # ``*noise`` is one tuple of forward's arguments, absent when the
        # decode draws nothing (a plain captioner's greedy or beam)
        dyn = ({0: b}, {0: b}) + ((tuple(
            {e["batch_axis"]: e["shape"][e["batch_axis"]] * b}
            for e in fn.noise),) if fn.noise else ())
        try:
            ep = torch.export.export(
                fn, _example_inputs(fn, 2, t_mel, n_mels, device),
                dynamic_shapes=dyn)
            return ep, "symbolic"
        except Exception as e:  # noqa: BLE001 - any trace failure pins the
            # batch, loudly, because it changes the artifact's contract
            # (serve then takes this batch); a real error raises again below
            logging.getLogger("acvae_tpu_torch").warning(
                "symbolic-batch export failed (%s: %s); pinning batch=%d",
                type(e).__name__, str(e).splitlines()[0][:120], PINNED_BATCH)
            batch = PINNED_BATCH
    ep = torch.export.export(fn, _example_inputs(fn, batch, t_mel, n_mels, device))
    return ep, str(batch)


def save_exported(ep, out_dir: str, meta: Dict[str, Any]) -> str:
    """Write ``decode.pt2`` and ``meta.json`` (the JAX package's keys, with
    ``torch_version`` and ``artifact_bytes``) into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ARTIFACT)
    torch.export.save(ep, path)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({**meta, "torch_version": torch.__version__,
                   "artifact_bytes": os.path.getsize(path)}, f, indent=1)
    return path


class ExportedDecode:
    """A loaded artifact: ``decode(feats, feat_lens, seed) -> {seqs,
    scores}`` draws the noise of ``meta["noise"]`` from
    ``torch.Generator(device).manual_seed(seed)``; ``program(feats,
    feat_lens, *noise)`` runs the exported program on given noise."""

    def __init__(self, module: nn.Module, meta: Dict[str, Any], device):
        self.module, self.meta = module, meta
        self.device = torch.device(device)

    def program(self, feats, feat_lens, *noise) -> Dict[str, torch.Tensor]:
        # as the eager decodes run: without autograd, the weights still
        # marked trainable (matmul picks its kernels by requires_grad, so
        # freezing them would round differently)
        with torch.inference_mode():
            return self.module(feats, feat_lens, *noise)

    def noise(self, batch: int, seed: int) -> List[torch.Tensor]:
        gen = torch.Generator(self.device).manual_seed(int(seed))
        return draw_noise(self.meta["noise"], batch, gen, self.device)

    def __call__(self, feats, feat_lens, seed: int) -> Dict[str, torch.Tensor]:
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        lens = torch.as_tensor(feat_lens, device=self.device).to(torch.int32)
        return self.program(feats, lens, *self.noise(feats.shape[0], seed))


def load_exported(export_dir: str, device=DEFAULT_DEVICE):
    """``(decode, meta)`` of a saved artifact, its program moved to
    ``device`` (``export.py:120-132``): the card unless the caller passes
    ``device="cpu"``; a CUDA device with no card visible raises."""
    from torch.export.passes import move_to_device_pass

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_exported(device={str(device)!r}) needs a "
                           f"CUDA card and none is visible; pass "
                           f"device='cpu' to run on the CPU")
    with open(os.path.join(export_dir, "meta.json")) as f:
        meta = json.load(f)
    ep = torch.export.load(os.path.join(export_dir, ARTIFACT))
    module = move_to_device_pass(ep, torch.device(device)).module()
    return ExportedDecode(module, meta, device), meta
