"""CosyVoice-300M (v1) speech LM: a WeNet text encoder and a rel-pos
transformer LM, in PyTorch.

Counterpart of cosyvoice_tpu/models/llm_v1.py. The LM's input is
[sos][speaker][encoded text][task][prompt speech] (`TransformerLMModule.
prepare`: the text through the causal 6-block conformer and an affine
layer, the x-vector L2-normalised and projected; a zero x-vector gives the
instruct mode's zero speaker row), then a 14-block espnet rel-pos
transformer decodes one speech token per step over a float32 KV arena of
`max_cache_len` rows, written in place.

The step's rel-pos term for the query at position `cur` against arena key
j is row (max_len - 1 - cur + j) of q_v . P, P the projected espnet table
of all 2*max_len - 1 relative positions: the JAX step slices that window
out of q_v . P_full. P depends on the weights alone, so the port projects
it once per weight load (`TransformerLMModule.pos_tables`, 14 x 8191 x 1024
float32 = 470 MB at full width, rebuilt when a layer's `linear_pos` weight
changes) instead of on every step, and slices the window out of P before
the product (the same values). Decoding is eager, one host loop of steps
per block of `block_size` tokens: RAS sampling with eos suppressed before
min_len, as the JAX `generate`, whose prompt padding (text to multiples of
32, prompt speech to multiples of 32, at least 4) it keeps. No kernel of
the port is on this path: the JAX LM runs no Pallas kernel either (its
attention adds a per-key position bias that K1 does not compute).

Training (`forward_logits`, float32 as in the JAX package) runs the layers'
`full` path over the whole [sos][spk][text][task][speech] sequence, which
projects the rel-pos table through `linear_pos` inside autograd on every
call: the cached `pos_tables` carry no gradient, and are rebuilt after an
optimizer step changes a `linear_pos` weight (its version moves).
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cosyvoice_tpu_torch.nn.attention import masked_softmax
from cosyvoice_tpu_torch.nn.conformer import ConformerEncoder, LinearInputLayer
from cosyvoice_tpu_torch.nn.embedding import EspnetRelPositionalEncoding
from cosyvoice_tpu_torch.ops.sampling import NEG_INF, ras_sampling_batch
from cosyvoice_tpu_torch.utils.devices import resolve_device


@dataclass(frozen=True)
class LMv1Config:
    text_encoder_input_size: int = 512
    llm_input_size: int = 1024
    llm_output_size: int = 1024
    text_token_size: int = 51866
    speech_token_size: int = 4096
    spk_embed_dim: int = 192
    # text encoder
    te_heads: int = 16
    te_linear_units: int = 4096
    te_blocks: int = 6
    # llm body
    lm_heads: int = 16
    lm_linear_units: int = 4096
    lm_blocks: int = 14
    max_cache_len: int = 4096
    # sampling
    top_p: float = 0.8
    top_k: int = 25
    win_size: int = 10
    tau_r: float = 0.1
    block_size: int = 28


class RelPosDecoderLayer(nn.Module):
    """One rel-pos transformer layer: `full` over a sequence (prefill), `step`
    for one token over the arena."""

    def __init__(self, size: int, heads: int, linear_units: int):
        super().__init__()
        self.size, self.heads, self.d_k = size, heads, size // heads
        self.norm_mha = nn.LayerNorm(size, eps=1e-12)
        self.norm_ff = nn.LayerNorm(size, eps=1e-12)
        self.linear_q = nn.Linear(size, size)
        self.linear_k = nn.Linear(size, size)
        self.linear_v = nn.Linear(size, size)
        self.linear_out = nn.Linear(size, size)
        self.linear_pos = nn.Linear(size, size, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(heads, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)
        self.ff_w1 = nn.Linear(size, linear_units)
        self.ff_w2 = nn.Linear(linear_units, size)

    def _heads(self, x):
        return x.reshape(*x.shape[:-1], self.heads, self.d_k)

    def _ffn(self, x):
        return x + self.ff_w2(F.relu(self.ff_w1(self.norm_ff(x))))

    def full(self, x, att_mask, pos_emb):
        """x [B, S, D]; att_mask [B, S, S] bool; pos_emb [1, 2S-1, D].
        Returns (y, k, v), k/v [B, S, H, d]."""
        h = self.norm_mha(x)
        q, k, v = self._heads(self.linear_q(h)), self._heads(self.linear_k(h)), self._heads(self.linear_v(h))
        p = self._heads(self.linear_pos(pos_emb))[0]
        ac = torch.einsum("bthd,bshd->bhts", q + self.pos_bias_u, k)
        bd = torch.einsum("bthd,phd->bhtp", q + self.pos_bias_v, p)
        # espnet rel_shift: out[i, j] = bd[i, j + S-1-i]
        B, H, S, _ = bd.shape
        bd = F.pad(bd, (1, 0)).reshape(B, H, 2 * S, S)[:, :, 1:].reshape(B, H, S, 2 * S - 1)[..., :S]
        attn = masked_softmax((ac + bd) / math.sqrt(self.d_k), att_mask)
        o = torch.einsum("bhts,bshd->bthd", attn, v).reshape(x.shape)
        return self._ffn(x + self.linear_out(o)), k, v

    def step(self, x, cur: int, k_arena, v_arena, p_table):
        """One token: x [B, 1, D] at position `cur` (one for the batch);
        k_arena/v_arena [B, max, H, d], written in place at row cur;
        p_table [2*max-1, H, d] (pos_tables). Keys 0..cur are attended."""
        B, max_len = x.shape[0], k_arena.shape[1]
        h = self.norm_mha(x)
        q = self._heads(self.linear_q(h))[:, 0]
        k_arena[:, cur] = self._heads(self.linear_k(h))[:, 0]
        v_arena[:, cur] = self._heads(self.linear_v(h))[:, 0]
        ac = torch.einsum("bhd,bshd->bhs", q + self.pos_bias_u, k_arena)
        # relative positions of keys 0..max-1: rows max-1-cur .. 2max-2-cur
        window = p_table[max_len - 1 - cur : 2 * max_len - 1 - cur]
        bd = torch.einsum("bhd,phd->bhp", q + self.pos_bias_v, window)
        scores = (ac + bd) / math.sqrt(self.d_k)
        valid = torch.arange(max_len, device=x.device) <= cur
        attn = torch.softmax(scores.masked_fill(~valid, NEG_INF), dim=-1)
        o = torch.einsum("bhs,bshd->bhd", attn, v_arena).reshape(B, 1, self.size)
        return self._ffn(x + self.linear_out(o))


class TransformerLMModule(nn.Module):
    def __init__(self, cfg: LMv1Config = LMv1Config()):
        super().__init__()
        self.cfg = c = cfg
        self.text_embedding = nn.Embedding(c.text_token_size, c.text_encoder_input_size)
        # causal text encoding (reference llm.py:86): static chunks of one token
        self.text_encoder = ConformerEncoder(c.text_encoder_input_size, c.llm_input_size, c.te_heads,
                                             c.te_linear_units, c.te_blocks, static_chunk_size=1)
        self.text_encoder_affine_layer = nn.Linear(c.llm_input_size, c.llm_input_size)
        self.llm_embedding = nn.Embedding(2, c.llm_input_size)
        self.speech_embedding = nn.Embedding(c.speech_token_size, c.llm_input_size)
        self.spk_embed_affine_layer = nn.Linear(c.spk_embed_dim, c.llm_input_size)
        self.llm_decoder = nn.Linear(c.llm_output_size, c.speech_token_size + 1)
        self.lm_embed = LinearInputLayer(c.llm_input_size, c.llm_output_size)
        self.lm_pos = EspnetRelPositionalEncoding(c.llm_output_size, max_len=c.max_cache_len)
        self.lm_layers = nn.ModuleList(
            RelPosDecoderLayer(c.llm_output_size, c.lm_heads, c.lm_linear_units) for _ in range(c.lm_blocks)
        )
        self.lm_after_norm = nn.LayerNorm(c.llm_output_size, eps=1e-5)
        self._tables = None  # (key of the linear_pos weights, the projected tables)

    # ------------- inputs -------------
    def encode_text(self, text, text_len):
        h, mask = self.text_encoder(self.text_embedding(text.clamp_min(0)), text_len, streaming=True)
        return self.text_encoder_affine_layer(h), mask

    def embed_speech(self, tokens):
        return self.speech_embedding(tokens.clamp_min(0))

    def embed_spk(self, embedding):
        return self.spk_embed_affine_layer(embedding / (embedding.norm(dim=-1, keepdim=True) + 1e-12))

    def assemble_prompt(self, spk_emb, text_h, text_len, prompt_speech, prompt_len):
        """[sos][spk][text][task][speech] rows, zero past each row's end.
        text_h [B, Lt, D]; prompt_speech [B, Lp, D] embedded. Returns
        (embeds [B, 3+Lt+Lp, D], total_len [B])."""
        B, Lt, D = text_h.shape
        Lp = prompt_speech.shape[1]
        out = text_h.new_zeros((B, 3 + Lt + Lp, D))
        sos, task = self.llm_embedding.weight[0], self.llm_embedding.weight[1]
        for b in range(B):
            tl, pl = int(text_len[b]), int(prompt_len[b])
            out[b, 0], out[b, 1] = sos, spk_emb[b]
            out[b, 2 : 2 + tl] = text_h[b, :tl]
            out[b, 2 + tl] = task
            out[b, 3 + tl : 3 + tl + pl] = prompt_speech[b, :pl]
        return out, (3 + text_len + prompt_len).to(torch.long)

    # ------------- lm body -------------
    def pos_tables(self):
        """The projected espnet table of every layer, [2*max-1, H, d] each:
        built on first use and again after a linear_pos weight changes."""
        key = tuple((m.linear_pos.weight.data_ptr(), m.linear_pos.weight._version) for m in self.lm_layers)
        if self._tables is None or self._tables[0] != key:
            dev = self.lm_after_norm.weight.device
            pe = self.lm_pos.position_encoding(self.cfg.max_cache_len, dev)[0]
            with torch.no_grad():
                tables = [m._heads(m.linear_pos(pe)) for m in self.lm_layers]
            self._tables = (key, tables)
        return self._tables[1]

    def _lm_input(self, lm_input, true_len):
        """(x, rel-pos embedding, causal and valid mask [B, S, S]) of the
        tail-padded lm_input [B, S, D]."""
        S = lm_input.shape[1]
        x, pos = self.lm_pos(F.relu(self.lm_embed(lm_input)))
        qpos = torch.arange(S, device=x.device)
        return x, pos, (qpos[None, :, None] >= qpos[None, None, :]) & (qpos[None, None, :] < true_len[:, None, None])

    def lm_prefill(self, lm_input, true_len, k_arena, v_arena):
        """lm_input [B, S, D] tail-padded; writes arena rows [0, S). Returns
        the logits at true_len - 1 [B, V+1]."""
        B, S, _ = lm_input.shape
        x, pos, att_mask = self._lm_input(lm_input, true_len)
        for i, layer in enumerate(self.lm_layers):
            x, k, v = layer.full(x, att_mask, pos)
            k_arena[i, :, :S] = k
            v_arena[i, :, :S] = v
        x = self.lm_after_norm(x)
        hidden = x[torch.arange(B, device=x.device), (true_len - 1).clamp_min(0)]
        return self.llm_decoder(hidden).float()

    def lm_step(self, token, cur: int, k_arena, v_arena):
        """token [B] previous speech token at position `cur` -> logits [B, V+1]."""
        x = F.relu(self.lm_embed(self.embed_speech(token)[:, None])) * self.lm_pos.xscale
        for i, (layer, table) in enumerate(zip(self.lm_layers, self.pos_tables())):
            x = layer.step(x, cur, k_arena[i], v_arena[i], table)
        return self.llm_decoder(self.lm_after_norm(x)[:, 0]).float()

    def prepare(self, text, text_len, spk, prompt_speech, prompt_len, k_arena, v_arena):
        """The prompt built and prefilled. text [B, Lt] ids; spk [B, 192] raw
        x-vector (zeros: the instruct mode's zero speaker row); prompt_speech
        [B, Lp] ids. Returns (logits, total_len)."""
        text_h, _ = self.encode_text(text, text_len)
        embeds, total = self.assemble_prompt(self.embed_spk(spk), text_h, text_len, self.embed_speech(prompt_speech),
                                             prompt_len)
        return self.lm_prefill(embeds, total, k_arena, v_arena), total

    def forward_logits(self, text, text_len, spk, speech, speech_len):
        """Training forward: [sos][spk][text][task][speech] through every
        layer. text [B, Lt], speech [B, Ls] ids; spk [B, 192]. Returns
        (logits [B, 3+Lt+Ls, V+1] float32, total_len [B]); the targets are
        train/trainer.v1_lm_targets."""
        text_h, _ = self.encode_text(text, text_len)
        embeds, total = self.assemble_prompt(self.embed_spk(spk), text_h, text_len, self.embed_speech(speech),
                                             speech_len)
        x, pos, att_mask = self._lm_input(embeds, total)
        for layer in self.lm_layers:
            x, _, _ = layer.full(x, att_mask, pos)
        return self.llm_decoder(self.lm_after_norm(x)).float(), total


class TransformerLM:
    """Host orchestrator: prefill, then blockwise eager decode on `device`."""

    def __init__(self, cfg: LMv1Config = LMv1Config(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.module = TransformerLMModule(cfg).eval()
        self.decode_steps = 0

    def init_cache(self, batch: int = 1):
        c = self.cfg
        shape = (c.lm_blocks, batch, c.max_cache_len, c.lm_heads, c.llm_output_size // c.lm_heads)
        return (torch.zeros(shape, device=self.device), torch.zeros(shape, device=self.device))

    def _sample(self, generator, logits, n_dec, recent, min_len):
        c = self.cfg
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp[:, c.speech_token_size] = torch.where(n_dec < min_len, NEG_INF, logp[:, c.speech_token_size])
        return ras_sampling_batch(logp, recent, n_dec.clamp_max(c.win_size), generator,
                                  top_p=c.top_p, top_k=c.top_k, win_size=c.win_size, tau_r=c.tau_r)

    def generate(self, text_tokens, spk_embedding, prompt_speech_tokens, generator, min_len: int, max_len: int,
                 block_size: int = None):
        """Yields np.int32 blocks of speech tokens until eos or max_len.
        text_tokens [Lt] (prompt text + text); spk_embedding [1, 192] raw
        x-vector (zeros: no speaker); prompt_speech_tokens [Lp]."""
        return self._generate(np.asarray(text_tokens, np.int64), np.asarray(spk_embedding, np.float32),
                              np.asarray(prompt_speech_tokens, np.int64), generator, min_len, max_len,
                              block_size or self.cfg.block_size)

    @torch.inference_mode()
    def _generate(self, text_tokens, spk, prompt_speech, generator, min_len, max_len, block_size):
        c, dev = self.cfg, self.device
        eos = c.speech_token_size
        bucket = 32
        Lt, Lp = len(text_tokens), len(prompt_speech)
        text = torch.zeros((1, max(bucket, -(-Lt // bucket) * bucket)), dtype=torch.long, device=dev)
        text[0, :Lt] = torch.as_tensor(text_tokens, device=dev)
        pst = torch.zeros((1, max(4, -(-max(Lp, 1) // bucket) * bucket)), dtype=torch.long, device=dev)
        pst[0, :Lp] = torch.as_tensor(prompt_speech, device=dev)
        k_arena, v_arena = self.init_cache(1)
        logits, total = self.module.prepare(text, torch.tensor([Lt], device=dev), torch.tensor(spk, device=dev),
                                            pst, torch.tensor([Lp], device=dev), k_arena, v_arena)
        cur = int(total[0])
        recent = torch.full((1, c.win_size), -1, dtype=torch.int32, device=dev)
        n_dec = torch.zeros((1,), dtype=torch.int32, device=dev)
        min_l = torch.tensor([min_len], dtype=torch.int32, device=dev)
        produced = 0
        while produced < max_len:
            toks = []
            for _ in range(block_size):
                if cur >= c.max_cache_len:
                    break  # the arena is full
                # no host sync inside the block: steps past a stop are cut below
                tok = self._sample(generator, logits, n_dec, recent, min_l)
                toks.append(tok)
                recent = torch.cat([recent[:, 1:], tok[:, None].to(recent.dtype)], dim=1)
                n_dec = n_dec + 1
                logits = self.module.lm_step(torch.where(tok >= eos, 0, tok).long(), cur, k_arena, v_arena)
                self.decode_steps += 1
                cur += 1
            out = torch.stack(toks, dim=1)[0].to(torch.int32).cpu().numpy() if toks else np.zeros(0, np.int32)
            stop = np.nonzero(out >= eos)[0]
            if len(stop):
                out = out[: stop[0]]
            out = out[: max_len - produced]
            produced += len(out)
            if len(out):
                yield out
            if len(stop) or cur >= c.max_cache_len:
                return
