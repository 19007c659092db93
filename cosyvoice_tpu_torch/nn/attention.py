"""Multi-head attention, plain and rel-position over the espnet PE table.

Counterpart of cosyvoice_tpu/nn/attention.py: MultiHeadAttention and
RelPositionMultiHeadAttention over full sequences, and `attend_chunk`, the
incremental streaming chunk over a KV arena. Masks are bool (True =
attend); fully masked rows produce zeros.
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


class MultiHeadAttention(nn.Module):
    """Absolute-position MHA (linear_q/k/v/out)."""

    def __init__(self, n_head: int, n_feat: int):
        super().__init__()
        self.n_head, self.n_feat, self.d_k = n_head, n_feat, n_feat // n_head
        self.linear_q = nn.Linear(n_feat, n_feat)
        self.linear_k = nn.Linear(n_feat, n_feat)
        self.linear_v = nn.Linear(n_feat, n_feat)
        self.linear_out = nn.Linear(n_feat, n_feat)

    def _heads(self, x, linear):
        B, T, _ = x.shape
        return linear(x).reshape(B, T, self.n_head, self.d_k)

    def _out(self, attn, v):
        """attn [B, H, T1, T2], v [B, T2, H, d] -> [B, T1, C]."""
        x = torch.einsum("bhts,bshd->bthd", attn, v)
        return self.linear_out(x.reshape(x.shape[0], x.shape[1], self.n_feat))

    def forward(self, query, key, value, mask=None, pos_emb=None):
        q, k, v = self._heads(query, self.linear_q), self._heads(key, self.linear_k), self._heads(value, self.linear_v)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(self.d_k)
        return self._out(masked_softmax(scores, mask), v)

    def _write_arena(self, key, value, k_arena, v_arena, pos: int, A: int):
        """K/V of the chunk written in place at arena rows [pos, pos+n);
        returns the first A rows as [B, A, H, d]."""
        B, n, _ = key.shape
        k_arena[:, pos : pos + n] = self.linear_k(key).to(k_arena.dtype)
        v_arena[:, pos : pos + n] = self.linear_v(value).to(v_arena.dtype)
        return (k_arena[:, :A].reshape(B, A, self.n_head, self.d_k),
                v_arena[:, :A].reshape(B, A, self.n_head, self.d_k))

    def attend_chunk(self, query, key, value, k_arena, v_arena, pos: int, mask):
        """Incremental chunk attention over a KV arena.

        query/key/value [B, n, C]: the new chunk (a padded tail writes rows
        at >= pos + real_n that `mask` excludes and the next chunk
        overwrites). k_arena/v_arena [B, A_arena, C], written in place at
        [pos, pos+n). mask [B, n, A] bool over the arena's first A >= pos+n
        rows (key validity and the chunk rule). Returns [B, n, C]: equal to
        the full recompute's rows under chunk-causal masks, as a position's
        K/V depend only on its own input."""
        A = mask.shape[-1]
        k, v = self._write_arena(key, value, k_arena, v_arena, pos, A)
        q = self._heads(query, self.linear_q)
        scores = torch.einsum("bnhd,bahd->bhna", q, k) / math.sqrt(self.d_k)
        return self._out(masked_softmax(scores, mask), v)


class RelPositionMultiHeadAttention(MultiHeadAttention):
    """Transformer-XL style rel-pos MHA (linear_q/k/v/out/pos, pos_bias_u/v)."""

    def __init__(self, n_head: int, n_feat: int):
        super().__init__(n_head, n_feat)
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

    def _pos_scores(self, q, k, pos_emb):
        """q [B, T1, H, d], k [B, T2, H, d], pos_emb [1, P, C] -> (matrix_ac
        [B, H, T1, T2], matrix_bd [B, H, T1, P])."""
        p = self._heads(pos_emb, self.linear_pos)
        matrix_ac = torch.einsum("bthd,bshd->bhts", q + self.pos_bias_u, k)
        matrix_bd = torch.einsum("bthd,bphd->bhtp", q + self.pos_bias_v, p.expand(q.shape[0], -1, -1, -1))
        return matrix_ac, matrix_bd

    def forward(self, query, key, value, mask=None, pos_emb=None):
        """query/key/value [B, T, C]; mask [B, 1 or T1, T2] bool; pos_emb
        [1, 2T-1, C] from EspnetRelPositionalEncoding. Returns [B, T1, C]."""
        q, k, v = self._heads(query, self.linear_q), self._heads(key, self.linear_k), self._heads(value, self.linear_v)
        matrix_ac, matrix_bd = self._pos_scores(q, k, pos_emb)
        if matrix_bd.shape != matrix_ac.shape:
            matrix_bd = self.rel_shift(matrix_bd, k.shape[1])
        return self._out(masked_softmax((matrix_ac + matrix_bd) / math.sqrt(self.d_k), mask), v)

    def attend_chunk(self, query, key, value, k_arena, v_arena, pos: int, mask, pos_emb=None):
        """Chunked rel-pos attention over a KV arena (see the base class).
        pos_emb [1, 2A-1, C]: the espnet table built for the A arena rows
        that `mask` covers, whose row p holds relative position (A-1) - p, so
        the bias of the query at pos+i against key s is row (A-1-pos) + (s-i)."""
        B, n, _ = query.shape
        A = mask.shape[-1]
        k, v = self._write_arena(key, value, k_arena, v_arena, pos, A)
        q = self._heads(query, self.linear_q)
        matrix_ac, bd_full = self._pos_scores(q, k, pos_emb)
        i = torch.arange(n, device=q.device)[:, None]
        s = torch.arange(A, device=q.device)[None, :]
        matrix_bd = torch.gather(bd_full, -1, ((A - 1 - pos) + (s - i)).expand(B, self.n_head, n, A))
        return self._out(masked_softmax((matrix_ac + matrix_bd) / math.sqrt(self.d_k), mask), v)
