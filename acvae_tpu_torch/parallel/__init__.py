"""Parallelism (counterpart of ``acvae_tpu/parallel/mesh.py``): one
process a card over ``torch.distributed``, data parallelism over a grid's
``data`` axis, vocab tensor parallelism and sequence parallelism over its
``model`` axis, with the step of the global batch.

* ``mesh``        — the rank grid and JAX's placement helpers by name;
* ``collectives`` — the all-reduces, gathers and the halo exchange, with
  their gradients;
* ``state``       — what a parallel step tells the model code, and the
  row-split random draws;
* ``vocab``       — the vocab-split embedding, classifier, log-softmax and
  argmax;
* ``train``       — the grid's side of ``Trainer`` (placement, gradient
  sums, checkpoints in the unsplit layout);
* ``pool``        — the ranks' worker processes, started once and sent
  work (``cli train``'s worker a card);
* ``parity``      — the parallel step held against the unsplit one (the
  tests' and ``chip_smoke.py``'s; the package does not import it).
"""
