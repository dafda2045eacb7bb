"""Offline captioning: one caller sends its next batch of clips when the
last one's captions are on the host (a closed loop), through the port's
beam decode: ``int8_decode_fn`` (``encoder: int8``, the path of ``cli
evaluate|serve --encoder_int8``) or the model's ``inference_forward``
(``encoder: bf16``, the default serving path).

Set-up draws the weights and a pool of ``pool_batches`` distinct batches
(log-mels, lengths, the beam's prior noise) on the card from the seed,
bakes the int8 encoder where the mix asks for it, and decodes every pool
batch once.  The window cycles through the pool, at least once round it;
a batch's time runs from the call until its token ids and scores are on
the host.

Correctness: once the window has closed, one clip for each row of the
batch is judged: every row position, so a fault confined to some rows of
a batch is seen.  Which pool batch each row's clip comes from is drawn
from the seed alone, so a faster program is judged on the same clips;
which of the window's repeats of that pool batch served it is drawn
among the window's.  The program's encoding of their batches (its encoder
entry at the timed batch size) against the reference's encoder
(``enc_err``, the worst clip); then the reference's beam search, fed that
same encoding and the same noise, against the beams the window served:
the share of clips whose best beam's tokens differ (``beam_mismatch``;
near-ties flip a few in sound runs), and the worst relative error of the
best beam's score over the clips whose tokens agree (``score_err``).

The model's parts are methods that a driver of another model overrides:
:meth:`Cell.weights`, :meth:`Cell.ref_encode`, :meth:`Cell.ref_beam_search`
and :meth:`Cell.per_unit_least_s`; such a driver declares its own
``FAULTS`` (``faults.py``).  The pool, the window, the timing,
:meth:`Cell.collect` and :func:`compare` are shared.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from portbench import common, faults
from portbench.reference import int8 as ref_int8
from portbench.reference import model as ref_model
from portbench.reference.params import dims, make_weights

FAULTS = faults.FAULTS["serve"]


class Cell:
    def __init__(self, conf: Dict, mix: Dict, seed: int, device: str = "cuda"):
        self.conf, self.mix, self.seed, self.device = conf, mix, int(seed), device
        self.int8 = mix["encoder"] == "int8"
        self.d = dims(conf)

    # ------------------------------------------------- the model's parts
    def weights(self) -> Dict[str, torch.Tensor]:
        """The model's weights, drawn on the card from the seed: the port's
        model loads them (strictly) and the reference reads them."""
        return make_weights(self.conf, common.seed_of(self.seed, 1), self.device)

    def ref_encode(self, s: Dict, control: bool = False,
                   block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's encoding of the judged clips, ``block`` at a time,
        in float32, and its lengths: int8 where the mix serves int8, else
        bf16; ``control`` one precision lower (int4, or bf16 with its convs'
        operands in float8 e4m3)."""
        arch, sd, out = self.conf["encodermodel"], self.sd, []
        baked = None
        if self.int8:
            baked = (ref_int8.calibrate(sd, arch, q=7) if control
                     else ref_int8.calibrate(sd, arch))
        for n0 in range(0, s["feats"].shape[0], block):
            f, n = s["feats"][n0:n0 + block], s["lens"][n0:n0 + block]
            if baked is not None:
                e = ref_int8.encode(baked, sd, f, n, block=block)
            else:
                e = ref_model.pann_encoder(sd, f, n, arch, conv_fp8=control)
            out.append(e["audio_embeds"].float())
        return torch.cat(out), s["lens"] // ref_model.stride(sd, arch)

    def ref_beam_search(self, enc, enc_lens, eps, control: bool = False) -> Dict:
        """The reference's beam search from the encoding ``enc``: ``seqs``
        [N, B, T] and ``scores`` [N, B]; ``control`` on TF32 operands."""
        return ref_model.beam_search(self.sd, enc, enc_lens, eps, self.mix["beam_size"],
                                     self.mix["max_length"], "tf32" if control else "f32")

    def per_unit_least_s(self) -> float:
        """The least time of a batch's model work at the card's peaks."""
        from portbench.counts import work
        m = self.mix
        return work.serve_batch_least_s(self.conf, self.d, m["batch"], m["t_mel"],
                                        m["beam_size"], m["max_length"], self.int8)

    # ---------------------------------------------------------- set-up
    def setup(self) -> None:
        conf, mix, dev = self.conf, self.mix, self.device
        tf = conf["precision"].get("tf32", False)
        torch.backends.cuda.matmul.allow_tf32 = tf
        torch.backends.cudnn.allow_tf32 = tf
        self.sd = self.weights()
        self.model = common.build_port_model(conf, self.sd, dev)
        kw = dict(decode_method="beam", beam_size=mix["beam_size"],
                  max_length=mix["max_length"])
        if self.int8:
            from acvae_tpu_torch.models.quant import (int8_decode_fn, quant_encoder_for,
                                                      scheme_kwargs)
            self.quant = quant_encoder_for(common.port_conf(conf), self.model,
                                           **scheme_kwargs(mix["scheme"]))
            fn = int8_decode_fn(self.model, self.quant, **kw)
            self.decode = lambda f, l, e: fn(f, l, eps=e)  # noqa: E731
            self.encode = lambda f, l: self.model.apply_ln(self.quant(f, l))  # noqa: E731
        else:
            self.decode = lambda f, l, e: self.model.inference_forward(  # noqa: E731
                f, l, eps=e, **kw)
            self.encode = lambda f, l: self.model.encode(f, l)  # noqa: E731
        g = torch.Generator(dev).manual_seed(common.seed_of(self.seed, 2))
        rng = np.random.default_rng(common.seed_of(self.seed, 3))
        N, T, F = mix["batch"], mix["t_mel"], self.d["F"]
        rows = N * mix["beam_size"]
        self.pool = []
        for _ in range(mix["pool_batches"]):
            lens = torch.tensor(common.spread(N, mix["len_min"], mix["len_max"], rng),
                                device=dev)
            feats = common.log_mels(g, N, T, F, lens, dev)
            eps = torch.randn((mix["max_length"], rows, self.d["E"]), generator=g,
                              device=dev)
            self.pool.append((feats, lens, eps))
        for i in range(len(self.pool)):
            self._unit(i)
        common.sync(dev)

    def _unit(self, i: int):
        feats, lens, eps = self.pool[i % len(self.pool)]
        with record_function("harness.call"):
            out = self.decode(feats, lens, eps)
        with record_function("harness.to_host"):
            return out["seqs"].cpu(), out["scores"].cpu()

    # ---------------------------------------------------------- window
    def window(self, seconds: float) -> Dict:
        """Batches for ``seconds``, and at least one of each pool batch
        (every judged clip was served in the window)."""
        self.outs: List = []
        times = []
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self.outs.append(self._unit(len(self.outs)))
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if t1 - start >= seconds and len(self.outs) >= len(self.pool):
                break
        n = len(self.outs) * self.mix["batch"]
        return {"metrics": {"clips_per_s": (n / (t1 - start), "clips/s"),
                            "batch_p95_ms": (common.p95(times) * 1e3, "ms")},
                "attempted": n, "failed": 0, "window_s": t1 - start,
                "units": len(self.outs)}

    def trace(self, units: int, out_dir):
        return common.profile_units(self._unit, units, out_dir)

    # ----------------------------------------------------------- check
    def judged(self) -> Tuple[np.ndarray, np.ndarray]:
        """For each row of the batch, the pool batch its judged clip comes
        from (drawn from the seed alone) and the window's batch that served
        it (one of that pool batch's repeats, drawn among those the window
        served)."""
        N, P, U = self.mix["batch"], len(self.pool), len(self.outs)
        rng = np.random.default_rng(common.seed_of(self.seed, 4))
        pools = rng.integers(0, P, size=N)
        repeats = (U - 1 - pools) // P + 1          # window batches p, p + P, …
        return pools, pools + P * (rng.random(N) * repeats).astype(np.int64)

    def collect(self) -> Dict:
        """The judged clips' inputs and what the program made of them;
        then the program's state is freed."""
        B = self.mix["beam_size"]
        pools, batch = self.judged()
        row = np.arange(len(pools))
        s = {"feats": [], "lens": [], "eps": [], "enc": [], "seqs": [], "scores": []}
        with torch.inference_mode():
            for p in sorted(set(pools.tolist())):
                feats, lens, eps = self.pool[p]
                enc = self.encode(feats, lens)["audio_embeds"]
                for b, r in zip(batch[pools == p], row[pools == p]):
                    s["feats"].append(feats[r])
                    s["lens"].append(lens[r])
                    s["eps"].append(eps[:, r * B:(r + 1) * B])
                    s["enc"].append(enc[r].float().clone())
                    s["seqs"].append(self.outs[b][0][r])
                    s["scores"].append(self.outs[b][1][r])
        out = {"feats": torch.stack(s["feats"]), "lens": torch.stack(s["lens"]),
               "eps": torch.cat(s["eps"], dim=1), "enc": torch.stack(s["enc"]),
               "seqs": torch.stack(s["seqs"]).to(self.device),
               "scores": torch.stack(s["scores"]).to(self.device)}
        del self.model, self.decode, self.encode, self.pool, self.outs
        if self.int8:
            del self.quant
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out

    def judge(self, s: Dict, control: bool = False, detail: bool = False) -> Dict:
        """The compared numbers; ``control`` puts the reference, one
        precision lower (:meth:`ref_encode`, :meth:`ref_beam_search`), in
        the program's place; ``detail`` adds what ``readings.py`` prints."""
        with ref_model.exact_f32(), torch.no_grad():
            ref_enc, enc_lens = self.ref_encode(s)
            enc, seqs, scores = s["enc"], s["seqs"], s["scores"]
            if control:
                enc = self.ref_encode(s, control=True)[0]
                low = self.ref_beam_search(enc, enc_lens, s["eps"], control=True)
                seqs, scores = low["seqs"], low["scores"]
            ref = self.ref_beam_search(enc, enc_lens, s["eps"])
        return compare(enc, ref_enc, seqs, scores, ref, detail)

    def own_encoding(self, s: Dict) -> Dict[str, float]:
        """Not compared: the reference's beam search from its own encoding
        (not the program's) against the served beams, for ``readings.py``."""
        with ref_model.exact_f32(), torch.no_grad():
            enc, enc_lens = self.ref_encode(s)
            ref = self.ref_beam_search(enc, enc_lens, s["eps"])
        got = compare(s["enc"], enc, s["seqs"], s["scores"], ref)
        return {"own_" + k: v for k, v in got.items()}


def compare(enc, ref_enc, seqs, scores, ref, detail: bool = False) -> Dict:
    """The compared numbers of served beams against the reference's;
    ``detail`` adds the five largest score errors of agreeing clips and the
    number of clips that disagree."""
    num = (enc - ref_enc).flatten(1).norm(dim=1)
    den = ref_enc.flatten(1).norm(dim=1).clamp_min(1e-30)
    serr = ((scores[:, 0] - ref["scores"][:, 0]).abs()
            / ref["scores"][:, 0].abs().clamp_min(1e-30))
    mism = (seqs[:, 0] != ref["seqs"][:, 0]).any(dim=1)
    agree = serr[~mism]
    out = {"enc_err": float((num / den).max()),
           "beam_mismatch": float(mism.double().mean()),
           "score_err": float(agree.max()) if agree.numel() else 0.0}
    if detail:
        out.update(score_err_top5=agree.sort(descending=True).values[:5].tolist(),
                   mismatched=int(mism.sum()), clips=int(mism.numel()))
    return out
