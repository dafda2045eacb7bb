"""optax's optimizer chain in torch (counterpart of
``acvae_tpu/train/trainer.py:55-181``).

:class:`OptaxChain` follows ``build_optimizer``'s chain, not torch.optim's
defaults, update for update:

* ``clip_by_global_norm`` -> coupled L2 (``add_decayed_weights``, the
  ``weight_decay`` of every optimizer but AdamW) -> the base optimizer with
  its learning rate -> ``lr_scale`` (the factor ReduceLROnPlateau sets),
  then ``params += updates``;
* the bases are optax's: ``adam``, ``adamw`` (decoupled decay, default
  ``weight_decay`` 1e-4, scaled by the lr), ``sgd`` (no momentum by
  default; the trace is ``g + μ·t``, optionally Nesterov), ``rmsprop``
  (decay 0.9, ``eps`` inside the square root, ``initial_scale`` 0, the
  momentum trace after the lr) and ``adagrad`` (accumulator from 0.1,
  ``eps`` 1e-7 inside the square root, no update where the sum is 0);
* freezing is ``multi_transform`` + ``set_to_zero``: a frozen parameter
  (its name holds one of ``frozen``, as ``freeze_mask`` reads flax paths)
  never moves, and the clip's global norm is over the trainable gradients
  only;
* ``accum_steps`` > 1 is ``optax.MultiSteps``: the gradients of k
  micro-batches are averaged (Welford: ``acc += (g - acc)/(n+1)``), and
  one update of the whole chain runs on the average; the accumulator and
  its mini-step are part of :meth:`OptaxChain.state_dict`.

A parameter without a gradient (off the loss path) steps with a zero
gradient, as JAX's ``grad`` gives it one.  The learning-rate schedule is
evaluated at the count of applied updates.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

# optimizer name -> (the optax function, the keyword arguments it takes
# besides the learning rate, at its defaults)
_ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
         "mu_dtype": None, "nesterov": False}
OPTAX_ARGS: Dict[str, Tuple[str, Dict[str, Any]]] = {
    "Adam": ("adam", _ADAM),
    "AdamW": ("adamw", dict(_ADAM, weight_decay=1e-4, mask=None)),
    "SGD": ("sgd", {"momentum": None, "nesterov": False,
                    "accumulator_dtype": None}),
    "RMSprop": ("rmsprop", {"decay": 0.9, "eps": 1e-8, "initial_scale": 0.0,
                            "eps_in_sqrt": True, "centered": False,
                            "momentum": None, "nesterov": False,
                            "bias_correction": False}),
    "Adagrad": ("adagrad", {"initial_accumulator_value": 0.1, "eps": 1e-7}),
}
# arguments optax takes whose other values the port leaves out
_DEFAULT_ONLY = {"mu_dtype": None, "mask": None, "accumulator_dtype": None,
                 "centered": False, "bias_correction": False}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the square root of every element's square,
    summed."""
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class OptaxChain:
    """``build_optimizer(name, schedule, max_grad_norm, trainable_mask,
    accum_steps, **kwargs)`` over ``named_params``.  ``kwargs`` are the
    recipe's ``optimizer_args`` without ``lr``: a key the optax function
    does not take raises its TypeError.  Call :meth:`step` after each
    micro-batch's backward."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 name: str = "Adam",
                 schedule: Callable[[int], float] = lambda step: 1e-3,
                 max_grad_norm: Optional[float] = None,
                 frozen: Sequence[str] = (), accum_steps: int = 1, **kwargs):
        if name not in OPTAX_ARGS:
            raise KeyError(f"optimizer {name!r} is not one of "
                           f"{sorted(OPTAX_ARGS)}")
        fn, defaults = OPTAX_ARGS[name]
        kwargs.pop("lr", None)
        weight_decay = kwargs.pop("weight_decay", None)
        # torch.optim's weight_decay is coupled L2 for every optimizer but
        # AdamW, whose decay is decoupled (acvae_tpu/train/trainer.py:150-158)
        if weight_decay and name == "AdamW":
            kwargs["weight_decay"] = weight_decay
        self.l2 = weight_decay if weight_decay and name != "AdamW" else None
        for k in kwargs:
            if k not in defaults:
                raise TypeError(f"{fn}() got an unexpected keyword argument {k!r}")
        self.name, self.args = name, dict(defaults, **kwargs)
        for k, v in _DEFAULT_ONLY.items():
            if k in self.args and self.args[k] != v:
                raise NotImplementedError(
                    f"optimizer_args {k}={self.args[k]!r} is not ported "
                    f"(only optax's default {v!r})")
        self.schedule, self.max_grad_norm = schedule, max_grad_norm
        self.accum_steps = max(1, int(accum_steps or 1))
        named = list(named_params)
        self.params = [p for _, p in named]
        self.trainable = [p for n, p in named if not any(f in n for f in frozen)]
        self.count = 0        # applied updates: the schedule's step
        self.mini_step = 0    # micro-batches in the accumulator
        self.lr_scale = 1.0   # ReduceLROnPlateau's factor
        self.state = [self._init_state(p) for p in self.trainable]

    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        a, z = self.args, lambda: torch.zeros_like(p)  # noqa: E731
        st: Dict[str, torch.Tensor] = {}
        if self.name in ("Adam", "AdamW"):
            st.update(mu=z(), nu=z())
        elif self.name == "RMSprop":
            st["nu"] = torch.full_like(p, a["initial_scale"])
        elif self.name == "Adagrad":
            st["sum_of_squares"] = torch.full_like(p, a["initial_accumulator_value"])
        if a.get("momentum") is not None:
            st["trace"] = z()
        if self.accum_steps > 1:
            st["acc"] = z()
        return st

    def lr(self) -> float:
        """The learning rate of the next applied update (before the
        plateau's factor)."""
        return float(self.schedule(self.count))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Take this micro-batch's ``.grad``; apply one update when the
        accumulation is complete (every call when ``accum_steps`` is 1).
        Returns the global norm of every raw gradient, frozen ones too, as
        the JAX step's ``grad_norm`` metric."""
        norm = global_norm([p.grad for p in self.params if p.grad is not None])
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.trainable]
        if self.accum_steps > 1:
            n = self.mini_step
            for st, g in zip(self.state, grads):
                st["acc"].add_((g - st["acc"]) / (n + 1))
            if n < self.accum_steps - 1:
                self.mini_step += 1
                return norm
            grads = [st["acc"].clone() for st in self.state]
            for st in self.state:
                st["acc"].zero_()
            self.mini_step = 0
        self._apply(grads)
        return norm

    def _apply(self, grads: List[torch.Tensor]) -> None:
        lr = self.lr()
        if self.max_grad_norm:
            gn = global_norm(grads)
            grads = [torch.where(gn < self.max_grad_norm, g,
                                 g / gn * self.max_grad_norm) for g in grads]
        if self.l2:
            grads = [g + self.l2 * p for g, p in zip(grads, self.trainable)]
        self.count += 1
        for p, g, st in zip(self.trainable, grads, self.state):
            u = self._base(p, g, st, lr) * self.lr_scale
            p.add_(u)

    def _base(self, p: torch.Tensor, g: torch.Tensor, st: Dict[str, torch.Tensor],
              lr: float) -> torch.Tensor:
        """The base optimizer's update of ``p`` for gradient ``g``, its
        learning rate applied; advances ``st``."""
        a, c = self.args, self.count
        if self.name in ("Adam", "AdamW"):
            b1, b2 = a["b1"], a["b2"]
            st["mu"].mul_(b1).add_(g * (1 - b1))
            st["nu"].mul_(b2).add_(g * g * (1 - b2))
            if a["nesterov"]:
                mu_hat = (b1 * (st["mu"] / (1 - b1 ** (c + 1)))
                          + (1 - b1) * (g / (1 - b1 ** c)))
            else:
                mu_hat = st["mu"] / (1 - b1 ** c)
            nu_hat = st["nu"] / (1 - b2 ** c)
            u = mu_hat / (torch.sqrt(nu_hat + a["eps_root"]) + a["eps"])
            if self.name == "AdamW":
                u = u + a["weight_decay"] * p
            return u * -lr
        if self.name == "SGD":
            return self._trace(g, st) * -lr
        if self.name == "RMSprop":
            st["nu"].mul_(a["decay"]).add_(g * g * (1 - a["decay"]))
            if a["eps_in_sqrt"]:
                u = torch.rsqrt(st["nu"] + a["eps"]) * g
            else:
                u = g / (torch.sqrt(st["nu"]) + a["eps"])
            return self._trace(u * -lr, st)
        # Adagrad
        s = st["sum_of_squares"].add_(g * g)
        inv = torch.where(s > 0, torch.rsqrt(s + a["eps"]), 0.0)
        return inv * g * -lr

    def _trace(self, u: torch.Tensor, st: Dict[str, torch.Tensor]) -> torch.Tensor:
        """optax ``trace``: ``t = u + μ·t``; the update is t, or ``u + μ·t``
        with Nesterov; ``u`` unchanged without momentum."""
        mu = self.args.get("momentum")
        if mu is None:
            return u
        st["trace"] = u + mu * st["trace"]
        return u + mu * st["trace"] if self.args["nesterov"] else st["trace"]

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mini_step": self.mini_step,
                "lr_scale": self.lr_scale,
                "state": {i: dict(st) for i, st in enumerate(self.state)}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore :meth:`state_dict` (tensors on any device); the layout
        must match this chain's."""
        if len(sd["state"]) != len(self.state):
            raise ValueError(f"optimizer state for {len(sd['state'])} "
                             f"parameters, this chain has {len(self.state)}")
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        self.lr_scale = float(sd["lr_scale"])
        for i, st in enumerate(self.state):
            saved = sd["state"][i]
            if set(saved) != set(st):
                raise ValueError(f"optimizer state {sorted(saved)} does not "
                                 f"match this chain's {sorted(st)}")
            for k, v in saved.items():
                st[k].copy_(v)


class ReduceLROnPlateau:
    """torch's ReduceLROnPlateau semantics, stepped with the validation
    score once an epoch (acvae_tpu/train/trainer.py:85-123): after
    ``patience`` epochs without a (relative-threshold) improvement the
    update is multiplied by ``factor`` once more.  The caller hands
    :attr:`scale` to :attr:`OptaxChain.lr_scale`."""

    def __init__(self, mode: str = "max", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 min_scale: float = 1e-8):
        self.mode, self.factor = mode, factor
        self.patience, self.threshold = patience, threshold
        self.min_scale = min_scale
        self.best: Optional[float] = None
        self.num_bad = 0
        self.scale = 1.0

    def _is_better(self, a: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            thr = self.best * (1 + self.threshold) if self.best >= 0 \
                else self.best * (1 - self.threshold)
            return a > thr
        thr = self.best * (1 - self.threshold) if self.best >= 0 \
            else self.best * (1 + self.threshold)
        return a < thr

    def step(self, metric: float) -> float:
        """Record this epoch's score; returns the (new) scale."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
            return self.scale
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            self.scale = max(self.scale * self.factor, self.min_scale)
        return self.scale

    def state(self) -> Dict[str, Any]:
        """The ``ckpt_steps.json`` fields (acvae_tpu/cli/main.py:706-710)."""
        return {"plateau_best": self.best, "plateau_num_bad": self.num_bad,
                "plateau_scale": self.scale}

    def load(self, meta: Dict[str, Any]) -> None:
        """Read :meth:`state`'s fields back from ``ckpt_steps.json``."""
        if "plateau_scale" in meta:
            self.best = meta.get("plateau_best")
            self.num_bad = int(meta["plateau_num_bad"])
            self.scale = float(meta["plateau_scale"])
