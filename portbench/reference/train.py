"""Plain PyTorch reference of the flagship's train step: SpecAugment's time
and frequency masks from given draws, the encoder in train mode (batch
statistics, dropout), the hybrid posterior (a masked BiGRU over the shifted
caption), the teacher-forced decode loop with scheduled sampling and prior
grounding from given coins, the label-smoothed CE + KL + global MSE loss,
its gradients by autograd, and optax's chain (clip by global norm, Adam).

Semantics, from the recipe (``configs/ac_vae.yaml``) and the AC-VAE's
description:

* masks: for each of 2 time then 2 frequency masks, a span ``[f0, end)``
  drawn per clip is filled with the clip's mean over its valid frames (as
  the masks so far left it); a drawn width of 0 ends that clip's masks of
  the call; a per-clip gate (p 0.2) keeps the masked or the plain log-mel;
* BatchNorm in train mode normalizes with the batch's biased variance
  ``E[x²] - E[x]²`` in float32; each ConvBlock is followed by dropout 0.2
  (drawn from torch's global generator, which the harness seeds alike for
  the program's step and this one); a data-parallel step (a step with
  ``rngs``, one seed a rank) normalizes over the whole batch and drops out
  each rank's equal chunk of rows from a generator seeded with its seed;
* the posterior: BiGRU states zero past each caption's length (the
  backward direction starts at its last word), ``(mu, log var)`` by a
  Linear with log var clamped to +-4, ``q_z = mu + eps · e^(log var / 2)``,
  and ``q_means_utt`` the masked mean + max of the states;
* step ``t``: the word is the caption's where ``ss_coins[t]``, else the
  argmax of the last step's logits; the decoder's z is the prior's where
  ``dis_coins[t]``, else the posterior's; the prior's z carries;
* loss: label-smoothed CE (0.1) over valid tokens + ``kl_weight`` · the
  Normal KL summed over the latent, averaged over valid tokens + ``alpha``
  · the mean square of ``q_means_utt - Linear(mean + max of the decoder
  states)``;
* optax: ``g <- g · min(1, 1 / ‖g‖)`` over every trainable tensor, Adam
  (0.9, 0.999, eps 1e-8) with bias correction, at the schedule's rate of
  the applied update's count (exponential decay with warm-up).

``matmul="bf16"`` rounds every float32 matmul's operands of the decode
side (posterior, prior, decoder, heads) to bfloat16: the control.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .model import Ctx, decoder_step, lin, prior_step
from .params import blocks_of

BUFFERS = ("running_mean", "running_var", "stem_pad_lanes")


def seed_global(device, seed: int) -> None:
    """Seed torch's global generator of ``device`` (the dropouts')."""
    if torch.device(device).type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


def _rng_state(device) -> torch.Tensor:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_rng_state(device, state: torch.Tensor) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def trainable(sd) -> List[str]:
    return [k for k in sd if not k.endswith(BUFFERS)]


# ------------------------------------------------------------- augment
def _valid_mean(x, lens):
    N, T, Fb = x.shape
    valid = torch.arange(T, device=x.device)[None, :] < lens[:, None]
    tot = torch.sum(torch.where(valid[:, :, None], x, 0.0), dim=(1, 2), keepdim=True)
    return tot / torch.clamp_min((lens * Fb).reshape(N, 1, 1).to(x.dtype), 1.0)


def spec_masks(x, lens, draws):
    """Two time masks, two frequency masks, then the per-clip gate."""
    out = x
    N, T, Fb = x.shape
    for axis, key in ((1, "time"), (2, "freq")):
        dead = torch.zeros((N,), dtype=torch.bool, device=x.device)
        length = T if axis == 1 else Fb
        for f0, end, f in draws[key]:
            dead = dead | (f == 0)
            fill = _valid_mean(out, lens)
            idx = torch.arange(length, device=x.device)[None, :]
            m = (idx >= f0[:, None]) & (idx < end[:, None])
            m = m[:, :, None] if axis == 1 else m[:, None, :]
            out = torch.where(m & ~dead[:, None, None], fill, out)
    return torch.where(draws["gate"][:, None, None], out, x)


# ------------------------------------------------------------- encoder
def batchnorm_train(x, P, p, axis, dtype, chunks=1):
    """With ``chunks`` > 1, the statistics of all rows from each equal row
    chunk's sums, added in chunk order, as a data-parallel step's ranks
    add theirs."""
    shape = [1] * x.ndim
    shape[axis] = -1
    red = [d for d in range(x.ndim) if d != axis]
    xf = x.float()
    if chunks == 1:
        mean = xf.mean(dim=red)
        var = torch.clamp_min((xf * xf).mean(dim=red) - mean * mean, 0.0)
    else:
        sums = [torch.stack([c.sum(dim=red), (c * c).sum(dim=red)]) for c in xf.chunk(chunks)]
        total = sum(sums[1:], sums[0])
        count = xf.numel() // xf.shape[axis]
        mean = total[0] / count
        var = torch.clamp_min(total[1] / count - mean * mean, 0.0)
    mul = torch.rsqrt(var + 1e-5) * P[p + ".weight"]
    parts = [((c - mean.view(shape)) * mul.view(shape) + P[p + ".bias"].view(shape)).to(dtype)
             for c in xf.chunk(chunks)]
    # each chunk normalized on its own, so that the statistics' gradients
    # are summed over the chunks, as the ranks' are
    return parts[0] if chunks == 1 else torch.cat(parts)


def _conv_bn_relu(x, P, conv, bn, dtype, chunks=1):
    """A conv (each of ``chunks`` equal row chunks on its own, as each rank
    of a data-parallel step convolves its rows), BatchNorm over all rows
    (:func:`batchnorm_train`), relu."""
    w = P[conv + ".weight"].to(dtype)
    parts = [F.conv2d(c.to(dtype), w, None, 1, 1) for c in x.chunk(chunks)]
    x = parts[0] if chunks == 1 else torch.cat(parts)
    return F.relu(batchnorm_train(x, P, bn, 1, dtype, chunks))


def _chunk_dropout(x, p, states):
    """Dropout of each of ``len(states)`` equal row chunks of ``x`` from
    its own generator state, advanced in place."""
    parts = []
    for r, part in enumerate(x.chunk(len(states))):
        _set_rng_state(x.device, states[r])
        parts.append(F.dropout(part, p, True))
        states[r] = _rng_state(x.device)
    return torch.cat(parts)


def encoder_train(P, feats, lens, dtype=torch.bfloat16, conv_dropout=0.2,
                  rngs: Optional[List[int]] = None):
    """Cnn10 in train mode: ``audio_embeds`` [N, T/16, C] and lengths.
    With ``rngs`` (a data-parallel step's seeds, one a rank) each rank's
    chunk of rows is convolved on its own, adds its sums to BatchNorm's
    statistics and drops out from its own generator, and each conv,
    BatchNorm and relu is recomputed in the backward, so that the whole
    batch's activations fit one card."""
    states = None
    if rngs is not None:
        states = []
        for s in rngs:
            seed_global(feats.device, s)
            states.append(_rng_state(feats.device))
    chunks = 1 if rngs is None else len(rngs)
    x = batchnorm_train(feats, P, "encoder.bn0", 2, feats.dtype, chunks)[:, None]
    for i in range(len(blocks_of(P))):
        p = f"encoder.conv_block{i + 1}"
        for j in (1, 2):
            args = (x, P, f"{p}.conv{j}", f"{p}.bn{j}", dtype, chunks)
            x = (_conv_bn_relu(*args) if states is None else
                 checkpoint(_conv_bn_relu, *args, use_reentrant=False))
        x = F.avg_pool2d(x, 2)
        x = (F.dropout(x, conv_dropout, True) if states is None
             else _chunk_dropout(x, conv_dropout, states))
    return x.mean(dim=3).transpose(1, 2), lens // 2 ** len(blocks_of(P))


# ----------------------------------------------------------- posterior
def _gru_seq(x, lens, P, sfx, matmul):
    """One direction of the masked GRU over x [N, T, E]: states [N, T, H]."""
    Wi, Wh = P[f"qnet.network.weight_ih_l0{sfx}"], P[f"qnet.network.weight_hh_l0{sfx}"]
    bi, bh = P[f"qnet.network.bias_ih_l0{sfx}"], P[f"qnet.network.bias_hh_l0{sfx}"]
    N, T, _ = x.shape
    h = x.new_zeros((N, Wh.shape[1]))
    gi_all = lin(x, Wi, bi, matmul)
    outs = []
    for t in range(T):
        gh = lin(h, Wh, bh, matmul)
        r_i, z_i, n_i = gi_all[:, t].chunk(3, -1)
        r_h, z_h, n_h = gh.chunk(3, -1)
        r, z = torch.sigmoid(r_i + r_h), torch.sigmoid(z_i + z_h)
        h = (1.0 - z) * torch.tanh(n_i + r * n_h) + z * h
        outs.append(h)
    return torch.stack(outs, 1)


def _mean_max(x, lens):
    m = (torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None])[:, :, None]
    mean = torch.sum(x * m, 1) / torch.clamp_min(lens.to(x.dtype), 1.0)[:, None]
    mx = torch.amax(x.masked_fill(~m, torch.finfo(x.dtype).min), 1)
    return mean + mx


def posterior(P, caps, cap_lens, q_eps, matmul):
    x = P["qnet.word_embedding.weight"][caps[:, :-1]]
    lens = cap_lens - 1
    N, T, _ = x.shape
    t = torch.arange(T, device=x.device)[None, :]
    valid = t < lens[:, None]
    rev = torch.where(valid, lens[:, None] - 1 - t, t)         # an involution
    fwd = _gru_seq(x, lens, P, "", matmul)
    bwd = _gru_seq(torch.gather(x, 1, rev[:, :, None].expand_as(x)), lens, P,
                   "_reverse", matmul)
    bwd = torch.gather(bwd, 1, rev[:, :, None].expand_as(bwd))
    hid = torch.cat([fwd, bwd], -1) * valid[:, :, None]
    mean, log = lin(hid, P["qnet.token_mean_log.weight"], P["qnet.token_mean_log.bias"],
                    matmul).chunk(2, -1)
    log = log.clamp(-4.0, 4.0)
    return {"q_means": mean, "q_logs": log, "q_z": q_eps * torch.exp(0.5 * log) + mean,
            "q_means_utt": _mean_max(hid, lens)}


# ---------------------------------------------------------------- loss
def loss_fn(P, batch, draws, noise, kl_weight, alpha, smoothing, matmul="f32",
            rngs=None):
    feats = spec_masks(batch["feats"], batch["feat_lens"], draws["spec"])
    emb, enc_lens = encoder_train(P, feats, batch["feat_lens"], rngs=rngs)
    caps, cap_lens = batch["caps"].long(), batch["cap_lens"]
    q = posterior(P, caps, cap_lens, noise["q_eps"], matmul)
    ctx = Ctx(P, emb, enc_lens, matmul)
    N, L = caps.shape
    H = P["decoder.model.weight_hh"].shape[1]
    PH = P["pnet.network.weight_hh"].shape[1]
    E = P["decoder.word_embeddings.weight"].shape[1]
    dec_h = emb.new_zeros((N, H), dtype=torch.float32)
    hc = (dec_h.new_zeros((N, PH)), dec_h.new_zeros((N, PH)))
    last_z = dec_h.new_zeros((N, E))
    prev = torch.full((N,), 1, dtype=torch.long, device=caps.device)
    logits_s, outs, pm, pl = [], [], [], []
    for t in range(L - 1):
        word = torch.where(noise["ss_coins"][t], caps[:, t], prev)
        mean, log, z, hc = prior_step(P, ctx, word, hc, last_z, noise["p_eps"][t], matmul)
        zd = torch.where(noise["dis_coins"][t], z, q["q_z"][:, t])
        logits, dec_h = decoder_step(P, ctx, word, dec_h, zd, matmul)
        prev = torch.argmax(F.log_softmax(logits.float(), -1), -1)
        last_z = z
        logits_s.append(logits), outs.append(dec_h), pm.append(mean), pl.append(log)
    logits, out = torch.stack(logits_s, 1), torch.stack(outs, 1)
    p_m, p_l = torch.stack(pm, 1), torch.stack(pl, 1)
    mask = (torch.arange(L - 1, device=caps.device)[None, :] < (cap_lens - 1)[:, None]).float()
    cnt = torch.clamp_min(mask.sum(), 1.0)
    lp = F.log_softmax(logits, -1)
    V = logits.shape[-1]
    off = smoothing / (V - 1)
    tgt = torch.gather(lp, -1, caps[:, 1:, None])[..., 0]
    ce = torch.sum((-off * lp.sum(-1) - (1.0 - smoothing - off) * tgt) * mask) / cnt
    kl = torch.sum(0.5 * (p_l - q["q_logs"]) + (torch.exp(q["q_logs"])
                   + (q["q_means"] - p_m) ** 2) / (2.0 * torch.exp(p_l)) - 0.5, -1)
    kl = torch.sum(kl * mask) / cnt
    p_utt = lin(_mean_max(out, cap_lens - 1), P["mean_log_out.weight"],
                P["mean_log_out.bias"], matmul)
    g = torch.mean((q["q_means_utt"] - p_utt) ** 2)
    return ce + kl_weight * kl + alpha * g


# ----------------------------------------------------------- optimizer
def exp_decay_lr(count: int, base: float, total: int, final: float, warmup: int) -> float:
    if warmup >= total:
        warmup = max(1, total // 10)
    it = count + 1
    return (min(it / warmup, 1.0) * base
            * math.exp((it - warmup) / total * math.log(final / base)))


def run_steps(sd0, steps: List[Dict], conf: Dict, total_iters: int,
              matmul: str = "f32", adam: Dict = None) -> Dict:
    """The recipe's train steps ``steps`` from weights ``sd0``; each entry
    holds ``batch``, ``draws``, ``noise``, ``kl_weight`` and ``rng`` (the
    global generator's seed before it), and a data-parallel step ``rngs``
    (each rank's seed of it, :func:`encoder_train`).  They start from Adam's state
    ``adam`` (``mu``, ``nu`` by tensor, ``count`` applied updates) where
    given, else from the first update.  Returns the losses, the first
    step's clipped gradient and each tensor's change."""
    names = trainable(sd0)
    P = dict(sd0)
    for n in names:
        P[n] = sd0[n].detach().clone().requires_grad_(True)
    if adam is None:
        adam = {"mu": {n: torch.zeros_like(P[n]) for n in names},
                "nu": {n: torch.zeros_like(P[n]) for n in names}, "count": 0}
    mu, nu = dict(adam["mu"]), dict(adam["nu"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    sa = conf["scheduler_args"]
    base = conf["optimizer_args"]["lr"]
    losses, g_first = [], None
    for c, st in enumerate(steps, start=adam["count"]):
        seed_global(sd0[names[0]].device, st["rng"])
        loss = loss_fn(P, st["batch"], st["draws"], st["noise"], st["kl_weight"],
                       conf["alpha"], conf["smoothing"], matmul, st.get("rngs"))
        grads = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {n: torch.zeros_like(P[n]) if gr is None else gr
                 for n, gr in zip(names, grads)}
            gn = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
            mx = conf["max_grad_norm"]
            g = {n: torch.where(gn < mx, v, v / gn * mx) for n, v in g.items()}
            if g_first is None:
                g_first = g
            lr = exp_decay_lr(c, base, total_iters, sa["final_lr"], sa["warmup_iters"])
            for n in names:
                mu[n] = g[n] * (1 - b1) + mu[n] * b1
                nu[n] = nu[n] * b2 + g[n] * g[n] * (1 - b2)
                u = (mu[n] / (1 - b1 ** (c + 1))) / (
                    torch.sqrt(nu[n] / (1 - b2 ** (c + 1))) + eps)
                P[n] = (P[n] + u * -lr).detach().requires_grad_(True)
    return {"losses": losses, "grad": g_first,
            "delta": {n: (P[n] - sd0[n]).detach() for n in names}}
