"""Sequential search advisors for ``cli sweep`` (the port's copy of
``acvae_tpu/train/sweep_advisor.py``; numpy only, so the card's machine
needs nothing more).

The reference delegates hyper-parameter search to NNI
(``nni.get_next_parameter`` / ``report_*_result``,
``runners/pytorch_runner_vae.py:130-133,358,389``) and configures its
built-in tuners (grid / random / TPE / anneal).  ``cli sweep`` covers
grid/random inline; this module supplies the model-based advisors:

* :class:`TPEAdvisor` — Tree-structured Parzen Estimator over *discrete*
  candidate lists (the ``choice`` case of Bergstra et al. 2011, which is
  what NNI's TPE reduces to for our YAML spaces): after ``n_startup``
  random trials, split history at the γ-quantile into good/bad, model each
  parameter's categorical densities P(v|good), P(v|bad) with Laplace
  smoothing, draw candidates from P(·|good) and keep the one maximizing
  Π P(v|good)/P(v|bad).
* :class:`AnnealAdvisor` — NNI's "anneal" tuner semantics: sample around
  the best-so-far trial, mutating each parameter away from the incumbent
  with a probability that cools over trials (fresh random draws early,
  local refinement late).
* :class:`MedianStopAssessor` — NNI's median-stop rule for ending a trial
  early.

Each draws from ``np.random.default_rng(seed)`` in the JAX package's order,
so the same seed and history give the same suggestions there and here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

History = List[Tuple[Dict[str, Any], float]]  # (overrides, metric), higher=better


def _key(overrides: Dict[str, Any], names: Sequence[str]) -> tuple:
    return tuple(repr(overrides[n]) for n in names)


class TPEAdvisor:
    def __init__(self, space: Dict[str, List[Any]], seed: int = 0,
                 n_startup: int = 5, gamma: float = 0.25,
                 n_candidates: int = 24):
        self.space = space
        self.names = list(space)
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates

    def _random(self) -> Dict[str, Any]:
        return {n: self.space[n][int(self.rng.integers(len(self.space[n])))]
                for n in self.names}

    def _densities(self, history: History, name: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Laplace-smoothed categorical P(v|good), P(v|bad) for one param."""
        choices = self.space[name]
        idx = {repr(v): i for i, v in enumerate(choices)}
        ordered = sorted(history, key=lambda h: -h[1])
        n_good = max(1, int(math.ceil(self.gamma * len(history))))
        good, bad = ordered[:n_good], ordered[n_good:]

        def dens(group):
            counts = np.ones(len(choices))  # Laplace prior
            for overrides, _ in group:
                v = repr(overrides.get(name))
                if v in idx:
                    counts[idx[v]] += 1
            return counts / counts.sum()

        return dens(good), dens(bad)

    def suggest(self, history: History) -> Dict[str, Any]:
        if len(history) < self.n_startup:
            return self._random()
        dens = {n: self._densities(history, n) for n in self.names}
        seen = {_key(o, self.names) for o, _ in history}
        best, best_score = None, -np.inf
        for _ in range(self.n_candidates):
            cand, score = {}, 0.0
            for n in self.names:
                pg, pb = dens[n]
                i = int(self.rng.choice(len(self.space[n]), p=pg))
                cand[n] = self.space[n][i]
                score += math.log(pg[i]) - math.log(pb[i])
            if _key(cand, self.names) in seen:
                score -= 100.0  # strongly discourage exact repeats
            if score > best_score:
                best, best_score = cand, score
        return best if best is not None else self._random()


class AnnealAdvisor:
    def __init__(self, space: Dict[str, List[Any]], seed: int = 0,
                 n_trials: int = 20):
        self.space = space
        self.names = list(space)
        self.rng = np.random.default_rng(seed)
        self.n_trials = max(1, n_trials)

    def suggest(self, history: History) -> Dict[str, Any]:
        t = len(history)
        if not history:
            return {n: self.space[n][int(self.rng.integers(len(self.space[n])))]
                    for n in self.names}
        incumbent = max(history, key=lambda h: h[1])[0]
        # mutation probability cools from ~1 to ~1/len(space)
        frac = min(1.0, t / self.n_trials)
        p_mut = (1.0 - frac) + frac * (1.0 / max(1, len(self.names)))
        out = {}
        for n in self.names:
            if n in incumbent and self.rng.random() >= p_mut:
                out[n] = incumbent[n]
            else:
                out[n] = self.space[n][int(self.rng.integers(len(self.space[n])))]
        return out

class MedianStopAssessor:
    """NNI MedianstopAssessor semantics (the assessor half of the
    reference's NNI integration — intermediate results are reported at
    ``runners/pytorch_runner_vae.py:358`` precisely so an assessor can kill
    bad trials early): a running trial is stopped at epoch E when its best
    intermediate metric so far is strictly below the median of the
    completed trials' running averages at epoch E.

    Host-side and framework-free; ``cli sweep --assessor=median`` wires it
    around each trial and the train loop polls :meth:`assess` after every
    validation epoch.
    """

    def __init__(self, min_trials: int = 3, min_epochs: int = 2):
        self.min_trials = min_trials
        self.min_epochs = min_epochs
        self.histories: List[List[float]] = []
        self.current: List[float] = []
        self.stopped_trials = 0
        self.last_stop = False  # did the current/most recent trial stop?

    def trial_begin(self) -> None:
        self.current = []
        self.last_stop = False

    def assess(self, score: float) -> bool:
        """Record one intermediate (epoch-level) result; True = stop now."""
        self.current.append(float(score))
        e = len(self.current)
        if e < self.min_epochs or len(self.histories) < self.min_trials:
            return False
        avgs = [float(np.mean(h[:e])) for h in self.histories if len(h) >= e]
        if len(avgs) < self.min_trials:
            return False
        stop = max(self.current) < float(np.median(avgs))
        if stop:
            self.stopped_trials += 1
            self.last_stop = True
        return stop

    def trial_end(self) -> None:
        # NNI MedianstopAssessor counts COMPLETED trials only: a killed
        # trial's truncated (and by construction below-median) history must
        # not shift the median or satisfy min_trials
        if not self.last_stop:
            self.histories.append(self.current)
        self.current = []
