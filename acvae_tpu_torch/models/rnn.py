"""Recurrent layers (counterpart of ``acvae_tpu/models/rnn.py:35-162``).

Gate order and math are torch's (GRU: r,z,n with the reset gate applied
after the hidden matmul; LSTM: i,f,g,o) and so are the parameter names
(``weight_ih``/``weight_hh``/``bias_ih``/``bias_hh``), so a reference
checkpoint's ``nn.GRU``/``nn.LSTM`` tensors load unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class _Cell(nn.Module):
    gates = 1

    def __init__(self, in_dim: int, hidden_size: int, device=None):
        super().__init__()
        G = self.gates * hidden_size
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(G, in_dim, device=device))
        self.weight_hh = nn.Parameter(torch.empty(G, hidden_size, device=device))
        self.bias_ih = nn.Parameter(torch.empty(G, device=device))
        self.bias_hh = nn.Parameter(torch.empty(G, device=device))
        bound = hidden_size ** -0.5
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def gates_from(self, x: torch.Tensor, h: torch.Tensor):
        """The input and hidden halves of the gates, [N, gates·H] each."""
        return (F.linear(x, self.weight_ih, self.bias_ih),
                F.linear(h, self.weight_hh, self.bias_hh))


class GRUCell(_Cell):
    """torch-compatible GRU cell."""
    gates = 3

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.recur(F.linear(x, self.weight_ih, self.bias_ih), h)

    def recur(self, gi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One step from the input half of the gates ``gi`` [N, 3H], which a
        caller can project for a whole sequence at once."""
        gh = F.linear(h, self.weight_hh, self.bias_hh)
        H = self.hidden_size
        r = torch.sigmoid(gi[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
        return (1.0 - z) * n + z * h


class LSTMCell(_Cell):
    """torch-compatible LSTM cell (i,f,g,o gate order)."""
    gates = 4

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, c = state
        gi, gh = self.gates_from(x, h)
        g = gi + gh
        H = self.hidden_size
        i = torch.sigmoid(g[..., :H])
        f = torch.sigmoid(g[..., H:2 * H])
        gg = torch.tanh(g[..., 2 * H:3 * H])
        o = torch.sigmoid(g[..., 3 * H:])
        c_new = f * c + i * gg
        return o * torch.tanh(c_new), c_new


class GRU(nn.GRU):
    """Single-layer batch-first (optionally bidirectional) GRU with lengths.

    With ``lens`` it runs packed: outputs are zero past each length and the
    final state is the state at ``len-1`` (``rnn.py:10-14``)."""

    def __init__(self, in_dim: int, hidden_size: int,
                 bidirectional: bool = False, device=None):
        super().__init__(in_dim, hidden_size, batch_first=True,
                         bidirectional=bidirectional, device=device)

    def forward(self, x: torch.Tensor, lens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [N, T, in] -> (outputs [N, T, H·dirs], h_n [dirs, N, H])."""
        if lens is None:
            return super().forward(x)
        packed = pack_padded_sequence(x, lens.cpu(), batch_first=True,
                                      enforce_sorted=False)
        out, h_n = super().forward(packed)
        out, _ = pad_packed_sequence(out, batch_first=True,
                                     total_length=x.shape[1])
        return out, h_n
