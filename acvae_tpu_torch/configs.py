"""The flagship recipe as a Python dict.

``FLAGSHIP_CONF`` mirrors ``configs/ac_vae.yaml`` key for key, with
``augments`` widened to ``[timewarp, timemask, freqmask]`` so that the train
step runs the time-warp kernel.  It is a dict (not YAML) so that nothing
here needs PyYAML.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

FLAGSHIP_CONF: Dict[str, Any] = {
    "model": "Hybrid_VAEModel",
    "remark": "tpu",
    "seed": 1,
    "zh": False,
    "encodermodel": "Cnn10",
    "encoder_args": {"embed_size": 512, "dtype": "bfloat16"},
    "decoder": "VAERNNBahdanauAttnDecoder",
    "decoder_args": {"embed_size": 512, "hidden_size": 512, "dropout": 0.0},
    "model_args": {
        "posterior_model": "PosteriorRNN_hybrid",
        "posterior_args": {"hidden_size": 512},
        "prior_model": "PriorRNN",
        "prior_args": {"hidden_size": 512},
    },
    "h5_csv": "data/clotho/dev/lms.csv",
    "caption_file": "data/clotho/dev/text.json",
    "vocab_file": "data/clotho/dev/vocab.pkl",
    "train_percent": 90.0,
    "batch_size": 32,
    "epochs": 25,
    "optimizer": "Adam",
    "optimizer_args": {"lr": 0.0005},
    "scheduler": "ExponentialDecayScheduler",
    "scheduler_args": {"final_lr": 1.0e-05, "warmup_iters": 3000},
    "max_grad_norm": 1.0,
    "label_smoothing": True,
    "smoothing": 0.1,
    "improvecriterion": "score",
    "beta": 0.5,
    "alpha": 0.5,
    "global_loss": "MSE",
    "ss_args": {"ss_mode": "exponential", "ss_ratio": 1.0,
                "final_ss_ratio": 0.7},
    "dis_ration": {"freeze_epoch": 10, "final_ratio": 0.3},
    "kl_mask": "valid",
    "augments": ["timewarp", "timemask", "freqmask"],
    "outputpath": "experiments",
}


def flagship_conf(**overrides) -> Dict[str, Any]:
    """A deep copy of :data:`FLAGSHIP_CONF` with top-level keys replaced."""
    conf = copy.deepcopy(FLAGSHIP_CONF)
    conf.update(overrides)
    return conf
