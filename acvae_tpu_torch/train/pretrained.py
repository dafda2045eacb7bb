"""Warm starts: shape-filtered merges of pretrained weights and pretrained
word embeddings (counterpart of ``acvae_tpu/train/pretrained.py:36-75,
345-349``, ``acvae_tpu/cli/main.py:727-805`` and
``acvae_tpu/data/embeddings.py:66-95``).

The port's parameter names are the reference's torch names, so a
reference AC-VAE state dict merges as it is; there is no conversion.  A
tensor loads where its name and shape match the model's (each skip logged
with both shapes), and each config key logs ``"{key}[params]: loaded N/M
tensors"`` (and ``[batch_stats]`` for the buffers).  ``pretrained`` and
``pretrained_global`` merge into the whole model, ``pretrained_encoder``
and ``pretrained_decoder`` into that submodule (the source's names are
then the submodule's own).

Sources: the port's own ``.pt``, a reference ``.pth``/``.pt`` (its
``{"model": ...}`` wrapper unwrapped), a PANN audio-tagger checkpoint
(Cnn10, Cnn14_16k, ResNet38: :func:`pann_state_dict`) and an espnet
VGG2L+RNNP encoder (:func:`espnet_state_dict`), the last two renamed as
the JAX package's ``pann_to_flax``/``espnet_to_flax`` route them
(``acvae_tpu/train/pretrained.py:86-172, 422-517``).  An orbax directory or
a pickled flax tree reaches the port through the JAX side
(``acvae_tpu_torch/convert.py::experiment_from_flax``).
"""
from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from acvae_tpu_torch.models.encoders import STEM_LANE_PAD

# (config key, the submodule it loads into, None for the whole model)
PRETRAINED_KEYS = (("pretrained", None), ("pretrained_encoder", "encoder"),
                   ("pretrained_decoder", "decoder"), ("pretrained_global", None))


def merge_pretrained(target: Dict[str, torch.Tensor],
                     pretrained: Dict[str, Any], log: Callable = print
                     ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """(merged, n_loaded, n_total): ``target`` with every tensor of
    ``pretrained`` whose name is in it and whose shape matches."""
    merged, loaded = dict(target), 0
    for name, leaf in target.items():
        if name not in pretrained:
            continue
        cand = torch.as_tensor(np.asarray(pretrained[name])
                               if not torch.is_tensor(pretrained[name])
                               else pretrained[name])
        if tuple(cand.shape) == tuple(leaf.shape):
            merged[name] = cand.to(leaf.dtype)
            loaded += 1
        else:
            log(f"skip {name}: shape {tuple(cand.shape)} != {tuple(leaf.shape)}")
    return merged, loaded, len(target)


def load_subtree(target: Dict[str, torch.Tensor], pretrained: Dict[str, Any],
                 subtree: str, log: Callable = print
                 ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """:func:`merge_pretrained` into the tensors under ``<subtree>.``, the
    source's names relative to that submodule."""
    prefix = subtree + "."
    sub = {k[len(prefix):]: v for k, v in target.items() if k.startswith(prefix)}
    if not sub:
        log(f"no submodule {subtree!r} in target params")
        return dict(target), 0, 0
    merged, n, total = merge_pretrained(sub, pretrained, log)
    out = dict(target)
    out.update({prefix + k: v for k, v in merged.items()})
    return out, n, total


def unwrap_torch_state_dict(obj):
    """A loaded checkpoint as a flat state dict: the reference's
    ``{"model": ...}`` save and the port's ``{"state_dict": ...}``
    unwrapped, a module's ``state_dict()`` taken."""
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    elif isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return obj


def _looks_like_acvae(state_dict: Dict[str, Any]) -> bool:
    """A whole reference (or port) model: submodule-prefixed keys."""
    return any(k.startswith(("decoder.", "qnet.", "pnet.")) for k in state_dict)


def _looks_like_global_vae(state_dict: Dict[str, Any]) -> bool:
    """``cli global_vae``'s ``GlobalSentenceVAE``, which
    ``pretrained_global`` merges by name as it is."""
    return any(k.startswith("context_to_mu.") for k in state_dict)


def _looks_like_pann(state_dict: Dict[str, Any]) -> bool:
    return any(k.startswith("conv_block") or k.startswith("resnet.")
               for k in state_dict)


def _looks_like_espnet(state_dict: Dict[str, Any]) -> bool:
    return any(k.endswith("conv1_1.weight") for k in state_dict) and \
        any(".birnn0." in k or ".bt0." in k or k.startswith(("birnn0", "bt0"))
            for k in state_dict)


def _tensor(v) -> torch.Tensor:
    return (v.detach().cpu() if torch.is_tensor(v)
            else torch.as_tensor(np.asarray(v))).float()


def pann_state_dict(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A PANN checkpoint's tensors under the port encoder's names, as
    ``pann_to_flax`` routes them (``pretrained.py:86-172``): the arch is
    ResNet38 where a ``resnet.`` key exists, else Cnn14 where
    ``conv_block6`` does, else Cnn10; Cnn10's ``fc1`` (or the reference's
    ``embed_pooled``) is ``embed_pooled``; the spectrogram frontend,
    ``fc_audioset`` and every other key are skipped.  A one-lane stem gets
    a zero ``stem_pad_lanes``, the JAX stem's zero-padded lanes.  A
    ResNet38 shortcut is ``downsample.0``/``.1`` (``downsample.1``/``.2``
    behind PANN's stride-2 AvgPool2d, renamed down)."""
    arch = ("ResNet38" if any(k.startswith("resnet.") for k in sd) else
            "Cnn14" if any(k.startswith("conv_block6") for k in sd) else "Cnn10")
    blocks = {"Cnn10": [f"conv_block{i}" for i in range(1, 5)],
              "Cnn14": [f"conv_block{i}" for i in range(1, 7)],
              "ResNet38": ["conv_block1", "conv_block_after1"]}[arch]
    bn = (".weight", ".bias", ".running_mean", ".running_var")
    names = {"bn0" + s: "bn0" + s for s in bn}
    for blk in blocks:
        for j in (1, 2):
            names[f"{blk}.conv{j}.weight"] = f"{blk}.conv{j}.weight"
            names.update({f"{blk}.bn{j}{s}": f"{blk}.bn{j}{s}" for s in bn})
    if arch == "ResNet38":
        for k in sd:
            m = re.fullmatch(r"(resnet\.layer\d+\.\d+)\.(conv[12]\.weight|"
                             r"bn[12]\.\w+|downsample\.(\d)\.\w+)", k)
            if m and not k.endswith("num_batches_tracked"):
                shift = int(f"{m.group(1)}.downsample.2.weight" in sd)
                names[k] = (k if m.group(3) is None else
                            f"{m.group(1)}.downsample.{int(m.group(3)) - shift}."
                            + k.rsplit(".", 1)[1])
    head = "embed_pooled" if arch == "Cnn10" else "fc1"
    for src in (("embed_pooled", "fc1") if arch == "Cnn10" else ("fc1",)):
        names.update({f"{src}.weight": f"{head}.weight", f"{src}.bias": f"{head}.bias"})
    out = {dst: _tensor(sd[src]) for src, dst in names.items() if src in sd}
    stem = out.get(f"{blocks[0]}.conv1.weight")
    if stem is not None and stem.shape[1] == 1:
        out["stem_pad_lanes"] = torch.zeros(stem.shape[0], STEM_LANE_PAD - 1,
                                            *stem.shape[2:])
    return out


def espnet_state_dict(sd: Dict[str, Any], inputdim: int = 64,
                      log: Callable = print) -> Dict[str, torch.Tensor]:
    """An espnet ``vggbgrup`` encoder's tensors under the port's
    ``E2EASREncoder`` names, as ``espnet_to_flax`` converts them
    (``pretrained.py:422-517``): the ``enc.enc.``/``enc.`` prefix dropped,
    VGG2L's ``conv<s>_<j>`` -> ``vgg<s-1>_conv<j>``, ``birnn<i>``/``rnn<i>``
    -> ``bgru<i>`` and ``bt<i>`` -> ``proj<i>``.  espnet flattens VGG2L's
    output channel-major and the port freq-major, so the first GRU layer's
    input columns are permuted; that needs ``inputdim % 4 == 0`` (espnet
    ceil-pools the freq axis, the port floor-pools), else ValueError.  A
    layer with 4 gate blocks (LSTM) is skipped with a log line."""
    sd = dict(sd)
    for pre in ("enc.enc.", "enc."):
        if any(k.startswith(pre + "0.") for k in sd):
            sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
            break
    out: Dict[str, torch.Tensor] = {}
    for stage in (1, 2):
        for j in (1, 2):
            for leaf in ("weight", "bias"):
                key = f"0.conv{stage}_{j}.{leaf}"
                if key in sd:
                    out[f"vgg{stage - 1}_conv{j}.{leaf}"] = _tensor(sd[key])
    if inputdim % 4 != 0:
        raise ValueError(
            f"espnet checkpoint: inputdim={inputdim} is not divisible by 4 — "
            f"espnet's VGG2L ceil-pools the freq axis "
            f"(ceil(ceil({inputdim}/2)/2)={-(-(-(-inputdim // 2)) // 2)}) "
            f"while E2EASREncoder floor-pools ({inputdim // 4}), so the "
            f"flattened RNN input layouts cannot be reconciled; re-extract "
            f"features at a multiple-of-4 mel dim (espnet_inputdim config key)")
    fp = inputdim // 4
    perm = torch.tensor([c * fp + f for f in range(fp) for c in range(128)])
    i = 0
    while f"1.birnn{i}.weight_ih_l0" in sd or f"1.rnn{i}.weight_ih_l0" in sd:
        base = f"1.birnn{i}" if f"1.birnn{i}.weight_ih_l0" in sd else f"1.rnn{i}"
        gates = sd[base + ".weight_ih_l0"].shape[0]
        hidden = sd[base + ".weight_hh_l0"].shape[1]
        if gates != 3 * hidden:
            log(f"skip {base}: {gates // hidden}-gate RNN is not a GRU "
                "(vggblstmp checkpoint?) — E2EASREncoder is the vggbgrup flavor")
            i += 1
            continue
        for rev in ("", "_reverse"):
            if f"{base}.weight_ih_l0{rev}" not in sd:
                continue
            for leaf in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                t = _tensor(sd[f"{base}.{leaf}_l0{rev}"])
                if i == 0 and leaf == "weight_ih":
                    t = t[:, perm]
                out[f"bgru{i}.{leaf}_l0{rev}"] = t
        for leaf in ("weight", "bias"):
            if f"1.bt{i}.{leaf}" in sd:
                out[f"proj{i}.{leaf}"] = _tensor(sd[f"1.bt{i}.{leaf}"])
        i += 1
    if i == 0:
        log("no RNNP layers found — not a VGG2L+RNNP encoder dict?")
    return out


def load_state_source(path: str, espnet_inputdim: int = 64,
                      log: Callable = print) -> Dict[str, Any]:
    """The flat state dict, in the port's names, that a ``pretrained*`` key
    names: a whole AC-VAE model's or a global sentence VAE's as it is, a
    PANN or espnet encoder's
    renamed (:func:`pann_state_dict`, :func:`espnet_state_dict`).  A
    missing file raises FileNotFoundError; a directory, a non-torch file or
    a torch file of none of these kinds ValueError, naming the JAX-side
    route."""
    p = Path(path)
    route = ("convert it on the JAX side: load_raw_checkpoint, then "
             "acvae_tpu_torch/convert.py::experiment_from_flax")
    if p.is_dir():
        raise ValueError(f"{path}: an orbax checkpoint directory; {route}")
    if p.suffix not in (".pth", ".pt"):
        raise ValueError(f"{path}: not a torch checkpoint (.pth/.pt); a "
                         f"pickled flax tree is the JAX package's; {route}")
    # the reference's checkpoints pickle their vocabulary beside the
    # weights, so this reads them as the reference and the JAX package do
    sd = unwrap_torch_state_dict(torch.load(p, map_location="cpu",
                                            weights_only=False))
    # a DistributedDataParallel save prefixes every name
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    if _looks_like_acvae(sd) or _looks_like_global_vae(sd):
        return sd
    if _looks_like_espnet(sd):
        return espnet_state_dict(sd, espnet_inputdim, log)
    if _looks_like_pann(sd):
        return pann_state_dict(sd)
    raise ValueError(f"{path}: torch checkpoint is neither a full AC-VAE "
                     f"model, a global sentence VAE, an espnet encoder, nor a "
                     f"PANN backbone")


def apply_pretrained(conf: Dict[str, Any], model: torch.nn.Module,
                     log: Callable = print) -> None:
    """Merge every ``pretrained*`` key of ``conf`` into ``model`` in
    place, in the JAX CLI's order."""
    params = {n for n, _ in model.named_parameters()}
    for key, subtree in PRETRAINED_KEYS:
        if key not in conf:
            continue
        src = load_state_source(conf[key], int(conf.get("espnet_inputdim", 64)),
                                log)
        state = model.state_dict()
        cols = {"params": {k: v for k, v in state.items() if k in params},
                "batch_stats": {k: v for k, v in state.items() if k not in params}}
        for col, target in cols.items():
            rel = target if subtree is None else {
                k[len(subtree) + 1:] for k in target if k.startswith(subtree + ".")}
            # as JAX skips a collection the source lacks: buffers are
            # merged when the source has one of the model's
            if not src or (col == "batch_stats" and not any(k in rel for k in src)):
                continue
            if subtree is None:
                merged, n, total = merge_pretrained(target, src, log)
            else:
                merged, n, total = load_subtree(target, src, subtree, log)
            state.update(merged)
            log(f"{key}[{col}]: loaded {n}/{total} tensors from {conf[key]}")
        model.load_state_dict(state, strict=True)


# --------------------------------------------------------------------- #
# pretrained word embeddings
# --------------------------------------------------------------------- #
def from_glove_txt(vocabulary, path: str, seed: int = 0) -> np.ndarray:
    """A [vocab, dim] matrix from a GloVe/fastText text file; words it
    lacks get N(0, 1) rows."""
    vectors, dim = {}, None
    with open(path) as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < 3:
                continue
            vectors[parts[0]] = np.asarray(parts[1:], np.float32)
            dim = dim or len(parts) - 1
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(len(vocabulary), dim)).astype(np.float32)
    for word, idx in vocabulary.word2idx.items():
        if word in vectors:
            out[idx] = vectors[word]
    return out


def from_gensim(vocabulary, model_path: str, seed: int = 0) -> np.ndarray:
    """A [vocab, dim] matrix from a gensim word2vec/fastText model."""
    try:
        import gensim
    except ImportError as e:
        raise ImportError(f"{model_path}: reading word vectors of this format "
                          f"needs gensim, which is not installed; use a .npy "
                          f"matrix or a GloVe .txt") from e
    try:
        kv = gensim.models.KeyedVectors.load(model_path)
    except Exception:
        kv = gensim.models.KeyedVectors.load_word2vec_format(
            model_path, binary=model_path.endswith(".bin"))
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(len(vocabulary), kv.vector_size)).astype(np.float32)
    for word, idx in vocabulary.word2idx.items():
        if word in kv:
            out[idx] = kv[word]
    return out


# the globals a pickled numpy array references (numpy 1 and 2 module paths)
_ARRAY_GLOBALS = {(m, n) for m in ("numpy.core.multiarray",
                                   "numpy._core.multiarray")
                  for n in ("_reconstruct", "scalar")} | {
    (m, "_frombuffer") for m in ("numpy.core.numeric", "numpy._core.numeric")} | {
    ("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode")}


class _ArrayUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ARRAY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"embedding pickle references disallowed global {module}.{name}; "
            f"only a numpy matrix is accepted")


def load_pickled_matrix(path: str) -> np.ndarray:
    """A pickled [vocab, dim] numpy matrix, read by an unpickler that
    admits numpy's array globals and nothing else."""
    with open(path, "rb") as f:
        matrix = np.asarray(_ArrayUnpickler(f).load())
    if matrix.ndim != 2:
        raise ValueError(f"{path}: expected a [vocab, dim] matrix, got shape "
                         f"{matrix.shape}")
    return matrix


def load_word_embeddings(path: str, vocabulary=None) -> np.ndarray:
    """``.npy`` and a pickled matrix (``.pkl``/``.pickle``) load as they
    are; ``.txt``/``.vec`` and gensim models need the vocabulary to align
    rows."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith((".pkl", ".pickle")):
        return load_pickled_matrix(path)
    if vocabulary is None:
        raise ValueError(f"{path}: word vectors other than a .npy matrix need "
                         f"the vocabulary")
    if path.endswith((".txt", ".vec")):
        return from_glove_txt(vocabulary, path)
    return from_gensim(vocabulary, path)


def set_embedding_param(model: torch.nn.Module, matrix: np.ndarray,
                        module: str = "decoder", name: str = "word_embeddings"
                        ) -> None:
    """Install a [vocab, dim] matrix as ``<module>.<name>.weight``."""
    emb = getattr(getattr(model, module), name).weight
    if tuple(matrix.shape) != tuple(emb.shape):
        raise ValueError(f"embedding shape {tuple(matrix.shape)} != "
                         f"{tuple(emb.shape)}")
    with torch.no_grad():
        emb.copy_(torch.as_tensor(np.asarray(matrix, np.float32)))
