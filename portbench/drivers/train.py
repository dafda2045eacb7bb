"""Training: the recipe's train step, ``Trainer.step``, driven by a loop
that starts the next step once the last one's metrics are on the host.

Set-up draws the weights and a pool of ``pool_batches`` distinct batches
(log-mels, captions, SpecAugment's draws, the model's noise and coins) on
the card from the seed, builds one ``Trainer`` holding those weights, and
drives it through its first ``checked_steps`` steps on pool batches that
share no row, through the window's own call; torch's global generator
(the dropouts') is seeded from the seed before each.  The window then
goes on with the same trainer, cycling through the pool.  The schedules
stand at ``epoch`` of the recipe's epochs (scheduled sampling below 1,
prior grounding above 0, so both coin branches of the decode loop run).

Correctness, once the window has closed: the reference (``reference/
train.py``) follows the same first steps from the same weights, inputs and
generator seeds.  Compared: each step's loss (``loss_err``, relative);
the first step's gradient as the optimizer got it, read from Adam's first
moment after that step (``grad_err``); and the change of the parameters
over the checked steps, read before the window's first step
(``update_err``).  Both by the worst tensor: the gap between the
program's norm and the reference's, over the larger of the reference's
norm of that tensor and of the median tensor; tensors whose reference
gradient is under a thousandth of the median's are left out of the
change (Adam turns their rounding into whole steps).

One step of the window, among its first ``window_check`` and drawn from
the seed, is compared too: the parameters and Adam's state are copied on
the card before it and the global generator seeded, and the reference
follows that step from the copy (it can only follow the program's own
state there; the start is checked above).  The same three numbers of that
one step: ``win_loss_err``, ``win_grad_err`` (the gradient read from the
change of Adam's first moment) and ``win_update_err``.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from portbench import common, faults
from portbench.reference import train as ref_train
from portbench.reference.params import dims, make_weights

FAULTS = faults.FAULTS["train"]


def _span(gen, n, extent, size, device):
    """A mask span per clip: width f in [0, extent), start in [0, size - f),
    end in [start, start + max(f, 1))."""
    f = torch.randint(0, extent, (n,), generator=gen, device=device)
    hi = torch.clamp_min(size - f, 1)
    u = torch.rand((n,), generator=gen, device=device)
    f0 = torch.minimum((u * hi).long(), hi - 1)
    u = torch.rand((n,), generator=gen, device=device)
    return f0, f0 + (u * torch.clamp_min(f, 1)).long(), f


class Cell:
    world = 1       # the ranks one step's batch is split over

    def __init__(self, conf: Dict, mix: Dict, seed: int, device: str = "cuda"):
        self.conf, self.mix, self.seed, self.device = conf, mix, int(seed), device
        self.d = dims(conf)
        self.total = conf["iters_per_epoch"] * conf["epochs"]

    def _place(self) -> None:
        """Where the trainer runs (one card: as built)."""

    def _feed(self, batch: Dict) -> Dict:
        """The rows of a step's batch that this process feeds."""
        return batch

    def _seed_dropout(self, seed: int) -> None:
        """Seed torch's global generator (the dropouts') before a checked step."""
        ref_train.seed_global(self.device, seed)

    def _ratios(self, it: int) -> Dict[str, float]:
        """The recipe's schedules at iteration ``it`` of ``epoch``."""
        c, e = self.conf, self.mix["epoch"]
        ss = c["ss_args"]["ss_ratio"] * 0.01 ** (it / self.total)
        dis = c["dis_ration"]
        dr = (0.0 if e <= dis["freeze_epoch"] else dis["final_ratio"]
              * (e - dis["freeze_epoch"]) / (c["epochs"] - dis["freeze_epoch"]))
        return {"ss": ss, "dis": dr, "kl_weight": max(0.5, e / c["epochs"] * c["beta"])}

    def setup(self) -> None:
        from acvae_tpu_torch.train.trainer import Trainer
        conf, mix, dev, d = self.conf, self.mix, self.device, self.d
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.sd = make_weights(conf, common.seed_of(self.seed, 1), dev)
        self.trainer = Trainer(common.port_conf(conf), d["V"], d["F"], device=dev,
                               total_iters=self.total)
        self.trainer.model.load_state_dict(self.sd, strict=True)
        self._place()
        g = torch.Generator(dev).manual_seed(common.seed_of(self.seed, 2))
        rng = np.random.default_rng(common.seed_of(self.seed, 3))
        N, T, L, E = mix["batch"] * self.world, mix["t_mel"], mix["cap_len"], d["E"]
        self.it0 = conf["iters_per_epoch"] * (mix["epoch"] - 1)
        self.pool = []
        for b in range(mix["pool_batches"]):
            lens = torch.tensor(common.spread(N, mix["len_min"], mix["len_max"], rng),
                                device=dev)
            cap_lens = torch.tensor(common.spread(N, mix["cap_min"], L, rng), device=dev)
            caps = torch.randint(4, d["V"], (N, L), generator=g, device=dev)
            caps[:, 0] = 1
            pos = torch.arange(L, device=dev)[None, :]
            caps = torch.where(pos == (cap_lens - 1)[:, None], 2, caps)
            caps = torch.where(pos >= cap_lens[:, None], 0, caps)
            batch = {"feats": common.log_mels(g, N, T, d["F"], lens, dev),
                     "feat_lens": lens, "caps": caps, "cap_lens": cap_lens}
            spec = {"gate": torch.rand((N,), generator=g, device=dev) < mix["spec_p"],
                    "time": [_span(g, N, mix["time_mask"], lens, dev) for _ in range(2)],
                    "freq": [_span(g, N, mix["freq_mask"], torch.full_like(lens, d["F"]),
                                   dev) for _ in range(2)]}
            r = self._ratios(self.it0 + 1 + b)
            noise = {"q_eps": torch.randn((N, L - 1, E), generator=g, device=dev),
                     "p_eps": torch.randn((L - 1, N, E), generator=g, device=dev),
                     "ss_coins": torch.rand((L - 1,), generator=g, device=dev) < r["ss"],
                     "dis_coins": torch.rand((L - 1,), generator=g, device=dev) <= r["dis"]}
            self.pool.append({"batch": batch, "feed": self._feed(batch),
                              "draws": {"spec": spec}, "noise": noise,
                              "kl_weight": r["kl_weight"],
                              "rng": common.seed_of(self.seed, 10 + b)})
        names = [n for n, _ in self.trainer.model.named_parameters()]
        self.losses = []
        for i in range(mix["checked_steps"]):
            self._seed_dropout(self.pool[i]["rng"])
            m = self._unit(i)
            self.losses.append(m["loss"])
            if i == 0:
                b1 = self.trainer.optimizer.args["b1"]
                self.g_first = {n: st["mu"].detach().float() / (1 - b1) for n, st in
                                zip(names, self.trainer.optimizer.state)}
        params = dict(self.trainer.model.named_parameters())
        self.delta = {n: (params[n].detach() - self.sd[n]).clone() for n in names}
        self.done = mix["checked_steps"]
        rng = np.random.default_rng(common.seed_of(self.seed, 5))
        self.check_at = int(rng.integers(0, mix["window_check"]))
        self.names = names
        common.sync(dev)

    def _unit(self, i: int) -> Dict[str, float]:
        p = self.pool[i % len(self.pool)]
        with record_function("harness.call"):
            m = self.trainer.step(p["feed"], self.it0 + 1 + i, self.mix["epoch"],
                                  draws=p["draws"], noise=p["noise"])
        with record_function("harness.to_host"):
            return {k: float(v) for k, v in m.items()}

    def _checked_unit(self, i: int) -> None:
        """Step ``i`` with the state before it and what it did kept."""
        opt = self.trainer.optimizer
        params = [p for _, p in self.trainer.model.named_parameters()]
        with torch.no_grad():
            p0 = [p.detach().clone() for p in params]
            mu0 = [st["mu"].clone() for st in opt.state]
            nu0 = [st["nu"].clone() for st in opt.state]
        count, rng = opt.count, common.seed_of(self.seed, 30)
        self._seed_dropout(rng)
        m = self._unit(i)
        b1 = opt.args["b1"]
        with torch.no_grad():
            self.win = {
                "step": dict(self.pool[i % len(self.pool)], rng=rng),
                "p0": dict(zip(self.names, p0)),
                "adam": {"mu": dict(zip(self.names, mu0)),
                         "nu": dict(zip(self.names, nu0)), "count": count},
                "loss": m["loss"],
                "grad": {n: (st["mu"].float() - b1 * a.float()) / (1 - b1)
                         for n, st, a in zip(self.names, opt.state, mu0)},
                "delta": {n: p.detach() - a for n, p, a in zip(self.names, params, p0)}}

    def _advance(self, checked: bool) -> None:
        """Step ``self.done`` of the window or the trace."""
        (self._checked_unit if checked else self._unit)(self.done)
        self.done += 1

    def window(self, seconds: float) -> Dict:
        steps, start = 0, time.perf_counter()
        while True:
            self._advance(steps == self.check_at)
            steps += 1
            t1 = time.perf_counter()
            if t1 - start >= seconds and steps > self.check_at:
                break
        n = steps * self.mix["batch"] * self.world
        return {"metrics": {"train_samples_per_s": (n / (t1 - start), "samples/s")},
                "attempted": n, "failed": 0, "window_s": t1 - start, "units": steps}

    def trace(self, units: int, out_dir):
        return common.profile_units(lambda i: self._advance(False), units, out_dir)

    def per_unit_least_s(self) -> float:
        from portbench.counts import work
        m = self.mix
        return work.train_step_least_s(self.conf, self.d, m["batch"], m["t_mel"],
                                       m["cap_len"])

    def collect(self) -> Dict:
        out = {"losses": self.losses, "grad": self.g_first, "delta": self.delta,
               "steps": self.pool[:self.mix["checked_steps"]], "win": self.win}
        del self.trainer
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out

    def judge(self, s: Dict, control: bool = False) -> Dict[str, float]:
        w = s["win"]
        sd_w = dict(self.sd, **w["p0"])
        ref = ref_train.run_steps(self.sd, s["steps"], self.conf, self.total)
        ref_w = ref_train.run_steps(sd_w, [w["step"]], self.conf, self.total,
                                    adam=w["adam"])
        prog_w = {"losses": [w["loss"]], "grad": w["grad"], "delta": w["delta"]}
        if control:
            s = ref_train.run_steps(self.sd, s["steps"], self.conf, self.total, "bf16")
            prog_w = ref_train.run_steps(sd_w, [w["step"]], self.conf, self.total,
                                         "bf16", adam=w["adam"])
        win = {"win_" + k: v for k, v in errors(prog_w, ref_w).items()}
        return dict(errors(s, ref), **win)


def errors(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The largest relative loss gap, and the gradient's and the change's
    gap by the worst tensor."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    gr = {n: float(v.norm()) for n, v in ref["grad"].items()}
    gp = {n: float(prog["grad"][n].norm()) for n in gr}
    med = float(np.median(list(gr.values())))
    grad_err = max(abs(gp[n] - gr[n]) / max(gr[n], med) for n in gr)
    kept = [n for n in gr if gr[n] >= 1e-3 * med]
    dr = {n: float(ref["delta"][n].norm()) for n in kept}
    dp = {n: float(prog["delta"][n].norm()) for n in kept}
    dmed = float(np.median(list(dr.values())))
    update_err = max(abs(dp[n] - dr[n]) / max(dr[n], dmed) for n in kept)
    return {"loss_err": loss_err, "grad_err": grad_err, "update_err": update_err}
