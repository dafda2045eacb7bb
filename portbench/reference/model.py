"""Plain PyTorch reference of the flagship Hybrid AC-VAE at serving: the
PANN encoder (Cnn10, Cnn14) in its stated dtype, the encoder->decoder
adapter, the AR prior's and the attention GRU decoder's step, and the
VAE-flavour beam search (a prior z a beam slot, flat top-k from step 0, no
end handling).  It works from a state dict named as the port's
(``params.py``) and imports nothing of the program.

Semantics, written down here from the model's description:

* BatchNorm at inference: ``(x - mean) · rsqrt(var + 1e-5) · w + b`` in
  float32, cast back to the block's dtype; convs 3x3, no bias, padding 1,
  in the block's dtype; relu; 2x2 average pools (Cnn14's last block none).
* Head: the mean over mel bins -> ``audio_embeds`` [N, T', C], lengths
  ``feat_lens // stride``; a model whose encoder is wider than the decoder
  maps the frames by ``ln`` (a Linear, float32).
* Additive attention: ``softmax(tanh(W_e h_enc + b + W_d q) · v)`` over the
  valid frames (invalid ones at -1e10).
* Prior step: LSTM (gates i, f, g, o) over [word; attention(word); z_prev]
  -> (mu, log var) with log var clamped to +-4, ``z = mu + eps · e^(log
  var / 2)``.  Decoder step: attention from its state, GRU (gates r, z, n,
  the reset applied after the hidden matmul) over [word; context; z],
  logits by the classifier.
* Beam: log-softmax in float32, top ``B`` over (beam, word) of the summed
  scores with ties to the lower flat index, states gathered by beam, the
  noise ``eps[t]`` read by slot (row ``n·B + b``) and never gathered.

``matmul`` = ``"tf32"`` (or ``"bf16"``) rounds both operands of every
decode matmul to TF32 (10 mantissa bits) or bfloat16 before a float32
product: the control of the serving (training) cells.  ``conv_fp8`` rounds
the bf16 encoder's conv operands to float8 e4m3: the control's encoder.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from .params import blocks_of

START, END = 1, 2
NEG = -1e10


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and convs without TF32 on the card."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def lower(x: torch.Tensor, matmul: str) -> torch.Tensor:
    """A matmul operand as the ``matmul`` precision holds it: float32 as
    is, or rounded to TF32 or bfloat16."""
    if matmul == "tf32":
        return tf32_round(x)
    if matmul == "bf16":
        return x.to(torch.bfloat16).float()
    return x


def lin(x, w, b=None, matmul: str = "f32"):
    return F.linear(lower(x, matmul), lower(w, matmul), b)


# ------------------------------------------------------------- encoder
def batchnorm_eval(x, sd, p, axis, dtype):
    shape = [1] * x.ndim
    shape[axis] = -1
    mul = torch.rsqrt(sd[p + ".running_var"] + 1e-5) * sd[p + ".weight"]
    y = ((x.float() - sd[p + ".running_mean"].view(shape)) * mul.view(shape)
         + sd[p + ".bias"].view(shape))
    return y.to(dtype)


def _fp8(t):
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def pann_encoder(sd, feats, lens, arch: str, dtype=torch.bfloat16,
                 conv_fp8: bool = False) -> Dict[str, torch.Tensor]:
    """Inference encoder: feats [N, T, F] float32 -> ``audio_embeds`` [N,
    T', E_dec] (after ``ln`` where there is one) and its lengths."""
    x = batchnorm_eval(feats, sd, "encoder.bn0", 2, feats.dtype)[:, None]
    n_blocks = len(blocks_of(sd))
    for i in range(n_blocks):
        p = f"encoder.conv_block{i + 1}"
        for j in (1, 2):
            w = sd[f"{p}.conv{j}.weight"].to(dtype)
            xin = x.to(dtype)
            if conv_fp8:
                w, xin = _fp8(w), _fp8(xin)
            x = F.conv2d(xin, w, None, 1, 1)
            x = F.relu(batchnorm_eval(x, sd, f"{p}.bn{j}", 1, dtype))
        if not (arch == "Cnn14" and i == n_blocks - 1):
            x = F.avg_pool2d(x, 2)
    emb = x.mean(dim=3).transpose(1, 2)               # [N, T', C]
    return finish_encoding(sd, emb, lens // stride(sd, arch))


def stride(sd, arch: str) -> int:
    """Time subsampling: a 2x2 pool a block, none after Cnn14's last."""
    return 2 ** (len(blocks_of(sd)) - (arch == "Cnn14"))


def finish_encoding(sd, emb, lens):
    """The adapter ``ln`` (float32) where the model has one."""
    if "ln.weight" in sd:
        emb = F.linear(emb.float(), sd["ln.weight"], sd["ln.bias"])
    return {"audio_embeds": emb, "audio_embeds_lens": lens}


# -------------------------------------------------------------- decode
class Ctx:
    """The per-clip attention memories of the prior and the decoder."""

    def __init__(self, sd, enc_mem, enc_lens, matmul="f32"):
        E = sd["decoder.word_embeddings.weight"].shape[1]
        self.mem = enc_mem.float()
        S = self.mem.shape[1]
        self.mask = torch.arange(S, device=enc_mem.device)[None] < enc_lens[:, None]
        wp, wd = sd["pnet.word_attn.h2attn.weight"], sd["decoder.attn.h2attn.weight"]
        self.p_proj = lin(self.mem, wp[:, E:], sd["pnet.word_attn.h2attn.bias"], matmul)
        Hd = wd.shape[1] - E
        self.d_proj = lin(self.mem, wd[:, Hd:], sd["decoder.attn.h2attn.bias"], matmul)


def attend(q, w_q, v, mem, proj, mask, matmul):
    """q [N·B, dq] against the clip's memory [N, S, E] -> context [N·B, E]."""
    N = mem.shape[0]
    B = q.shape[0] // N
    qp = lin(q, w_q, None, matmul).view(N, B, 1, -1)
    score = lower(torch.tanh(proj[:, None] + qp), matmul) @ lower(v, matmul)
    score = score.masked_fill(~mask[:, None], NEG)
    w = torch.softmax(score, dim=-1)
    return torch.einsum("nbs,nse->nbe", lower(w, matmul),
                        lower(mem, matmul)).reshape(N * B, -1)


def prior_step(sd, ctx: Ctx, words, hc, last_z, eps_t, matmul="f32"):
    """The AR prior's step: (mean, log var, z, (h, c))."""
    h, c = hc
    E = sd["decoder.word_embeddings.weight"].shape[1]
    x = sd["pnet.word_embedding.weight"][words]
    wp = sd["pnet.word_attn.h2attn.weight"]
    pctx = attend(x, wp[:, :E], sd["pnet.word_attn.v"], ctx.mem, ctx.p_proj,
                  ctx.mask, matmul)
    g = (lin(torch.cat([x, pctx, last_z], -1), sd["pnet.network.weight_ih"],
             sd["pnet.network.bias_ih"], matmul)
         + lin(h, sd["pnet.network.weight_hh"], sd["pnet.network.bias_hh"], matmul))
    i, f, gg, o = g.chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    h = torch.sigmoid(o) * torch.tanh(c)
    mean, log = lin(h, sd["pnet.mean_log_out.weight"], sd["pnet.mean_log_out.bias"],
                    matmul).chunk(2, -1)
    log = log.clamp(-4.0, 4.0)
    return mean, log, eps_t * torch.exp(0.5 * log) + mean, (h, c)


def decoder_step(sd, ctx: Ctx, words, dec_h, z, matmul="f32"):
    """The attention GRU decoder's step: (logits, new state)."""
    E = sd["decoder.word_embeddings.weight"].shape[1]
    wd = sd["decoder.attn.h2attn.weight"]
    Hd = wd.shape[1] - E
    dctx = attend(dec_h, wd[:, :Hd], sd["decoder.attn.v"], ctx.mem, ctx.d_proj,
                  ctx.mask, matmul)
    emb = sd["decoder.word_embeddings.weight"][words]
    gi = lin(torch.cat([emb, dctx, z], -1), sd["decoder.model.weight_ih"],
             sd["decoder.model.bias_ih"], matmul)
    gh = lin(dec_h, sd["decoder.model.weight_hh"], sd["decoder.model.bias_hh"], matmul)
    r_i, z_i, n_i = gi.chunk(3, -1)
    r_h, z_h, n_h = gh.chunk(3, -1)
    r = torch.sigmoid(r_i + r_h)
    zg = torch.sigmoid(z_i + z_h)
    n = torch.tanh(n_i + r * n_h)
    dec_h = (1.0 - zg) * n + zg * dec_h
    logits = lin(dec_h, sd["decoder.classifier.weight"], sd["decoder.classifier.bias"],
                 matmul)
    return logits, dec_h


def step(sd, ctx: Ctx, words, state, eps_t, matmul="f32"):
    """One prior step and one decoder step on the prior's z: (logits, new
    state)."""
    dec_h, hc, last_z = state
    _, _, z, hc = prior_step(sd, ctx, words, hc, last_z, eps_t, matmul)
    logits, dec_h = decoder_step(sd, ctx, words, dec_h, z, matmul)
    return logits, (dec_h, hc, z)


def init_state(sd, rows, device):
    H = sd["decoder.model.weight_hh"].shape[1]
    PH = sd["pnet.network.weight_hh"].shape[1]
    E = sd["decoder.word_embeddings.weight"].shape[1]
    z = lambda n: torch.zeros((rows, n), device=device)  # noqa: E731
    return (z(H), (z(PH), z(PH)), z(E))


def _gather(state, rows):
    if isinstance(state, tuple):
        return tuple(_gather(s, rows) for s in state)
    return state.index_select(0, rows)


def beam_search(sd, enc_mem, enc_lens, eps, beam: int, steps: int,
                matmul: str = "f32") -> Dict[str, torch.Tensor]:
    """The VAE beam search over clips [N]; eps [steps, N·B, E].  Returns
    ``seqs`` [N, B, steps] and ``scores`` [N, B], best beam first."""
    N, B, dev = enc_mem.shape[0], beam, enc_mem.device
    ctx = Ctx(sd, enc_mem, enc_lens, matmul)
    state = init_state(sd, N * B, dev)
    words = torch.full((N * B,), START, dtype=torch.long, device=dev)
    scores = torch.zeros((N, B), device=dev)
    seqs = torch.full((N, B, steps), END, dtype=torch.long, device=dev)
    for t in range(steps):
        logits, new = step(sd, ctx, words, state, eps[t].float(), matmul)
        V = logits.shape[-1]
        total = scores[:, :, None] + F.log_softmax(logits.float(), -1).view(N, B, V)
        vals, idx = torch.sort(total.reshape(N, B * V), dim=-1, descending=True,
                               stable=True)
        scores, idx = vals[:, :B], idx[:, :B]
        prev, words = idx // V, idx % V
        rows = (prev + torch.arange(N, device=dev)[:, None] * B).reshape(-1)
        state = _gather(new, rows)
        seqs = torch.gather(seqs, 1, prev[:, :, None].expand(N, B, steps)).clone()
        seqs[:, :, t] = words
        words = words.reshape(-1)
    return {"seqs": seqs, "scores": scores}
