"""Rel-position multi-head attention over the espnet PE table.

Counterpart of cosyvoice_tpu/nn/attention.py:RelPositionMultiHeadAttention
in full-sequence mode (the streaming `attend_chunk` arenas are not ported
yet). Masks are bool (True = attend); fully masked rows produce zeros.
"""

import math

import torch
from torch import nn

NEG_INF = -1.0e30


def masked_softmax(scores: torch.Tensor, mask) -> torch.Tensor:
    """scores [B, H, T1, T2]; mask [B, 1 or T1, T2] bool or None."""
    if mask is None:
        return torch.softmax(scores, dim=-1)
    m = mask[:, None]
    attn = torch.softmax(scores.masked_fill(~m, NEG_INF), dim=-1)
    return attn.masked_fill(~m, 0.0)


class RelPositionMultiHeadAttention(nn.Module):
    """Transformer-XL style rel-pos MHA (linear_q/k/v/out/pos, pos_bias_u/v)."""

    def __init__(self, n_head: int, n_feat: int):
        super().__init__()
        self.n_head, self.n_feat, self.d_k = n_head, n_feat, n_feat // n_head
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)
        self.linear_pos = nn.Linear(n_feat, n_feat, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    @staticmethod
    def rel_shift(bd: torch.Tensor, t2: int) -> torch.Tensor:
        """bd [B, H, T1, P] with P = 2*T2-1 -> [B, H, T1, T2],
        out[i, j] = bd[i, j + T1 - 1 - i] (espnet's zero-pad + reshape trick
        in the square case, a gather otherwise)."""
        B, H, T1, P = bd.shape
        if t2 == T1 and P == 2 * T1 - 1:
            x = torch.nn.functional.pad(bd, (1, 0))
            x = x.reshape(B, H, 2 * T1, T1)[:, :, 1:, :].reshape(B, H, T1, 2 * T1 - 1)
            return x[..., :t2]
        i = torch.arange(T1, device=bd.device)[:, None]
        j = torch.arange(t2, device=bd.device)[None, :]
        return torch.gather(bd, -1, (j + (T1 - 1 - i)).expand(B, H, T1, t2))

    def forward(self, query, key, value, mask=None, pos_emb=None):
        """query/key/value [B, T, C]; mask [B, 1 or T1, T2] bool; pos_emb
        [1, 2T-1, C] from EspnetRelPositionalEncoding. Returns [B, T1, C]."""
        B, T1, _ = query.shape
        T2 = key.shape[1]
        q = self.linear_q(query).reshape(B, T1, self.n_head, self.d_k)
        k = self.linear_k(key).reshape(B, T2, self.n_head, self.d_k).transpose(1, 2)
        v = self.linear_v(value).reshape(B, T2, self.n_head, self.d_k).transpose(1, 2)
        p = self.linear_pos(pos_emb).reshape(1, -1, self.n_head, self.d_k).transpose(1, 2)
        q_u = (q + self.pos_bias_u).transpose(1, 2)
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        matrix_ac = torch.einsum("bhtd,bhsd->bhts", q_u, k)
        matrix_bd = torch.einsum("bhtd,bhpd->bhtp", q_v, p.expand(B, -1, -1, -1))
        if matrix_bd.shape != matrix_ac.shape:
            matrix_bd = self.rel_shift(matrix_bd, T2)
        attn = masked_softmax((matrix_ac + matrix_bd) / math.sqrt(self.d_k), mask)
        x = torch.einsum("bhts,bhsd->bhtd", attn, v)
        return self.linear_out(x.transpose(1, 2).reshape(B, T1, self.n_feat))
