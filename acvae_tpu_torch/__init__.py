"""acvae_tpu_torch — the PyTorch/CUDA port of ``acvae_tpu``.

A second package beside the JAX one, written for one NVIDIA H100.  It keeps
its own copies of everything it needs and imports nothing of ``acvae_tpu``;
the JAX package is the frozen reference that the tests hold it against.

* ``acvae_tpu_torch.ops``    — masked reductions, losses, SpecAugment, the
  spline time warp, the log-mel frontend, the int8 encoder's plain
  arithmetic, and ``ops.cuda`` (hand-written Hopper kernels built from
  ``csrc/`` at first use).
* ``acvae_tpu_torch.models`` — the flagship Hybrid AC-VAE (Cnn10 encoder,
  hybrid posterior, AR prior, attention GRU decoder), its train forward
  and its inference forward, and the int8 serving encoder (``quant``).
* ``acvae_tpu_torch.decoding`` — next-word sampling and the batched beam
  search.
* ``acvae_tpu_torch.data`` — the vocabulary.
* ``acvae_tpu_torch.train``  — schedules, the train step and the
  experiment dir (config, vocabulary, weights).
* ``acvae_tpu_torch.serve``  — ``CaptionService`` and the micro-batching
  HTTP server (``python -m acvae_tpu_torch.serve <exp_dir>``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

PAD_IDX = 0
START_IDX = 1
END_IDX = 2
UNK_IDX = 3
# Reference token protocol: models/word_model.py:19-22, utils/build_vocab.py:100-103.
MAX_LENGTH = 20

DEFAULT_DEVICE = "cuda"
