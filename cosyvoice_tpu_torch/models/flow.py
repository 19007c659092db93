"""Flow acoustic model: speech tokens -> mel (encoder + CFM).

Counterpart of cosyvoice_tpu/models/flow.py:CausalFlow, in both of its
layouts:

- CosyVoice2 (`encoder_type="upsample_conformer"`, `estimator_type="unet"`):
  the upsample-conformer `FlowEncoder` and the causal U-Net estimator;
- CosyVoice3 (`encoder_type="dit_prelookahead"`, `estimator_type="dit"`):
  `DiTFlowEncoder` (an 80-d token embedding, the lookahead conv of
  `dit_lookahead_channels`, no conformer, each token repeated
  token_mel_ratio times) and the DiT estimator (models/dit.py).

`inference` runs over a full prefix, offline or streaming (chunk masks,
lookahead context); the incremental chunk (`stream_state`,
`grow_stream_state`, `inference_chunk`) runs over carried KV arenas and
conv caches: the encoder's and the U-Net's (v2), or only the DiT's, with the
lookahead conv's cache (v3). `loss` is the unified streaming/offline training loss
of both layouts.
"""

from dataclasses import dataclass, field
import torch
from torch import nn

from typing import Optional

from cosyvoice_tpu_torch.models.dit import DiTConfig, DiTEstimator, dit_stream_state
from cosyvoice_tpu_torch.models.flow_decoder import ConditionalDecoder, EstimatorConfig, estimator_stream_state
from cosyvoice_tpu_torch.models.flow_matching import (
    CFMConfig,
    cfm_loss,
    fixed_noise,
    loss_draws,
    solve_euler,
    solve_euler_chunk,
)
from cosyvoice_tpu_torch.nn.conformer import PreLookaheadLayer, UpsampleConformerEncoder, upsample_encoder_stream_state
from cosyvoice_tpu_torch.ops.masks import make_non_pad_mask
from cosyvoice_tpu_torch.utils.devices import resolve_device


@dataclass(frozen=True)
class FlowConfig:
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    chunk_size: int = 25  # streaming chunk, tokens
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    # v3 DiT variant
    encoder_type: str = "upsample_conformer"  # or "dit_prelookahead"
    estimator_type: str = "unet"  # or "dit"
    dit_lookahead_channels: int = 1024
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)
    dit: Optional[DiTConfig] = None  # the DiT estimator's; default DiTConfig(static_chunk_size=chunk_size * r)
    cfm: CFMConfig = field(default_factory=CFMConfig)


class FlowEncoder(nn.Module):
    """Token embedding + speaker projection + upsample conformer + mel projection (v2)."""

    def __init__(self, cfg: FlowConfig):
        super().__init__()
        c = cfg
        self.input_embedding = nn.Embedding(c.vocab_size, c.input_size)
        self.spk_embed_affine_layer = nn.Linear(c.spk_embed_dim, c.output_size)
        self.encoder = UpsampleConformerEncoder(
            input_size=c.input_size,
            output_size=c.input_size,
            attention_heads=c.attention_heads,
            linear_units=c.linear_units,
            num_blocks=c.num_blocks,
            num_up_blocks=c.num_up_blocks,
            pre_lookahead_len=c.pre_lookahead_len,
            up_stride=c.token_mel_ratio,
            static_chunk_size=c.chunk_size,
        )
        self.encoder_proj = nn.Linear(c.input_size, c.output_size)

    def project_spk(self, embedding):
        """l2-normalize the x-vector, then project 192 -> 80."""
        embedding = embedding / (torch.linalg.norm(embedding, dim=-1, keepdim=True) + 1e-12)
        return self.spk_embed_affine_layer(embedding)

    def forward(self, token, token_len, context_token=None, streaming=False):
        """token [B, L] body tokens (tail-padded, true length token_len);
        context_token [B, la] the lookahead tokens, or None (finalize);
        streaming: chunk masks. Returns (mu [B, L*r, 80], mel non-pad mask
        [B, L*r])."""
        mask = make_non_pad_mask(token_len, token.shape[1])
        ctx = None if context_token is None else self.input_embedding(context_token.clamp_min(0))
        h, mel_mask = self.encoder(self.input_embedding(token.clamp_min(0)) * mask[..., None], token_len, ctx,
                                   streaming)
        return self.encoder_proj(h), mel_mask

    def forward_chunk(self, token, context_token, enc_state, pos: int, real_n: int):
        """Incremental encoder chunk: token [B, n] (padding beyond real_n),
        context_token [B, la] or None (finalize). Returns (mu [B, n*r, 80],
        enc_state)."""
        valid = torch.arange(token.shape[1], device=token.device)[None, :] < real_n
        emb = self.input_embedding(token.clamp_min(0)) * valid[..., None]
        ctx = None if context_token is None else self.input_embedding(context_token.clamp_min(0))
        h, enc_state = self.encoder.forward_chunk(emb, ctx, enc_state, pos, real_n)
        return self.encoder_proj(h), enc_state


class DiTFlowEncoder(nn.Module):
    """CosyVoice3 flow front end: 80-d token embedding -> PreLookaheadLayer
    (80 -> dit_lookahead_channels -> 80, residual) -> each token repeated
    token_mel_ratio times. No conformer, no output projection."""

    def __init__(self, cfg: FlowConfig):
        super().__init__()
        c = self.cfg = cfg
        self.input_embedding = nn.Embedding(c.vocab_size, c.input_size)
        self.spk_embed_affine_layer = nn.Linear(c.spk_embed_dim, c.output_size)
        self.pre_lookahead_layer = PreLookaheadLayer(c.input_size, c.dit_lookahead_channels, c.pre_lookahead_len)

    project_spk = FlowEncoder.project_spk

    def forward(self, token, token_len, context_token=None, streaming=False):
        """token [B, L] body tokens (tail-padded, true length token_len);
        context_token [B, la] the lookahead tokens, written into each row at
        its own length (clamped to L - la, as JAX's dynamic_update_slice),
        or None (finalize). Returns (mu [B, L*r, 80], mel non-pad mask)."""
        c = self.cfg
        L = token.shape[1]
        mask = make_non_pad_mask(token_len, L)
        emb = self.input_embedding(token.clamp_min(0)) * mask[..., None]
        if context_token is not None:
            ctx = self.input_embedding(context_token.clamp_min(0)).to(emb.dtype)
            la = ctx.shape[1]
            # each row's rows [start, start + la), indexed on the device (no host read)
            at = token_len.long().clamp(0, L - la)[:, None] + torch.arange(la, device=emb.device)
            emb = emb.scatter(1, at[..., None].expand(-1, -1, emb.shape[-1]), ctx)
        h = self.pre_lookahead_layer(emb)
        r = c.token_mel_ratio
        return torch.repeat_interleave(h, r, dim=1), torch.repeat_interleave(mask, r, dim=1)

    def forward_chunk(self, token, context_token, enc_state, pos: int, real_n: int):
        """Incremental encoder chunk: only the lookahead conv's cache
        ("pre_conv2", [B, 2, dit_lookahead_channels]) carries between
        chunks. Returns (mu [B, n*r, 80], enc_state)."""
        valid = torch.arange(token.shape[1], device=token.device)[None, :] < real_n
        emb = self.input_embedding(token.clamp_min(0)) * valid[..., None]
        ctx = None if context_token is None else self.input_embedding(context_token.clamp_min(0))
        st = dict(enc_state)
        h, st["pre_conv2"] = self.pre_lookahead_layer(emb, ctx, st["pre_conv2"], real_n)
        return torch.repeat_interleave(h, self.cfg.token_mel_ratio, dim=1), st


def _is_arena(part: str, key: str) -> bool:
    """A KV arena of a stream state: the conformer's ("enc_*", "up_enc_*")
    in "enc", the U-Net's ("*_tf_*") or the DiT's ("blocks_*") in "est"."""
    if part == "enc":
        return "enc_" in key
    return "_tf_" in key or key.startswith("blocks_")


class CausalFlow(nn.Module):
    """CosyVoice2 / CosyVoice3 causal flow: encoder + estimator + Euler solver."""

    def __init__(self, cfg: FlowConfig = FlowConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.encoder = DiTFlowEncoder(cfg) if cfg.encoder_type == "dit_prelookahead" else FlowEncoder(cfg)
            if cfg.estimator_type == "dit":
                self.estimator = DiTEstimator(
                    cfg.dit or DiTConfig(static_chunk_size=cfg.chunk_size * cfg.token_mel_ratio))
            else:
                self.estimator = ConditionalDecoder(cfg.estimator)
        self.eval()

    @torch.inference_mode()
    def inference(self, token, token_len, conds, embedding, context_token=None, streaming=False):
        """token [1, L] prompt+generated body tokens (zero tail-padded, true
        length token_len; L >= token_len + la with a context); conds
        [1, L*r, 80] prompt mel at the front; embedding [1, 192];
        context_token [1, la] the lookahead tokens when not finalizing;
        streaming: chunk masks in encoder and estimator. Returns mel
        [1, L*r, 80], zero beyond r*token_len."""
        mu, mel_mask = self.encoder(token, token_len, context_token, streaming)
        spks = self.encoder.project_spk(embedding)
        z = fixed_noise(mu.device)[None, : mu.shape[1]]
        mask_f = mel_mask.to(mu.dtype)
        mel = solve_euler(self.estimator, z, mu, mask_f, spks, conds, self.cfg.cfm, streaming)
        return mel * mask_f[..., None]

    # ---------------- incremental streaming ----------------
    def stream_state(self, B: int = 1, arena_tok: int = 256) -> dict:
        """Zero state of the incremental chunk: the encoder's float32 KV
        arenas (arena_tok token rows, arena_tok*r mel rows) and conv caches
        ("enc"; the DiT layout: the lookahead conv's cache alone), and one
        estimator state per Euler step ("est", a list), each with KV arenas
        of arena_tok*r rows for the CFG pair. The arenas are views of one
        buffer (one allocation, not ~1100)."""
        c = self.cfg
        mel = arena_tok * c.token_mel_ratio
        if c.estimator_type == "dit":
            enc = {"pre_conv2": torch.zeros((B, 2, c.dit_lookahead_channels), device="meta")}
            est = [dit_stream_state(self.estimator.cfg, 2 * B, mel, "meta") for _ in range(c.cfm.n_timesteps)]
        else:
            enc = upsample_encoder_stream_state(self.encoder.encoder, B, arena_tok, mel, "meta")
            est = [estimator_stream_state(c.estimator, 2 * B, mel, "meta") for _ in range(c.cfm.n_timesteps)]
        return self._place_arenas({"enc": enc, "est": est}, arena_tok)

    @staticmethod
    def stream_state_nbytes(state: dict) -> int:
        """Bytes of every tensor in a stream state."""
        def leaves(x):
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, dict):
                for v in x.values():
                    yield from leaves(v)
            else:
                for v in x:
                    yield from leaves(v)

        return sum(t.numel() * t.element_size() for t in leaves(state))

    def _place_arenas(self, state: dict, arena_tok: int) -> dict:
        """`state` (updated by entry) with every KV arena a view of one new
        zeroed buffer of arena_tok token rows (arena_tok*r mel rows) that
        holds the arena's current rows, and every other leaf on "meta" made
        zeros on the flow's device."""
        dev = next(self.parameters()).device
        r = self.cfg.token_mel_ratio
        arenas = []  # (state part, key, rows)
        for part, st in [("enc", state["enc"])] + [("est", st) for st in state["est"]]:
            for k, v in st.items():
                if _is_arena(part, k):
                    arenas.append((st, k, arena_tok if k.startswith("enc_") else arena_tok * r))
                elif isinstance(v, tuple):
                    st[k] = tuple(torch.zeros(a.shape, device=dev) if a.is_meta else a for a in v)
                elif v.is_meta:
                    st[k] = torch.zeros(v.shape, device=dev)
        flat = torch.zeros(sum(2 * a.shape[0] * rows * a.shape[2] for st, k, rows in arenas for a in st[k][:1]),
                           device=dev)
        off = 0
        for st, k, rows in arenas:
            views = []
            for a in st[k]:
                n = a.shape[0] * rows * a.shape[2]
                view = flat[off : off + n].view(a.shape[0], rows, a.shape[2])
                off += n
                if not a.is_meta:
                    view[:, : a.shape[1]] = a
                views.append(view)
            st[k] = tuple(views)
        return state

    def stream_arena_tok(self, state: dict) -> int:
        """The token rows a stream state's arenas hold."""
        if "enc_0" in state["enc"]:
            return state["enc"]["enc_0"][0].shape[1]
        return state["est"][0]["blocks_0"][0].shape[1] // self.cfg.token_mel_ratio

    @torch.inference_mode()
    def grow_stream_state(self, state: dict, new_arena_tok: int) -> dict:
        """A state whose KV arenas hold new_arena_tok token rows, the old rows
        copied and zeros past them (the mask hides rows past the frontier,
        so growth changes no value); the old and new arenas coexist while it
        runs. `state` if it is as long."""
        if new_arena_tok <= self.stream_arena_tok(state):
            return state
        return self._place_arenas({"enc": dict(state["enc"]), "est": [dict(st) for st in state["est"]]},
                                  new_arena_tok)

    @torch.inference_mode()
    def inference_chunk(self, token_chunk, context_token, conds_chunk, embedding, state: dict, pos_tok: int,
                        real_n: int):
        """One incremental streaming chunk. token_chunk [B, n] new tokens
        (padding beyond real_n); context_token [B, la] the lookahead tokens or
        None (finalize); conds_chunk [B, n*r, 80] the prompt mel at this
        chunk's mel offset; embedding [B, 192]; state from stream_state,
        updated in place, with pos_tok tokens already consumed. Returns
        (mel [B, n*r, 80], state): rows [0, real_n*r) equal the streaming
        recompute's new rows. The noise is the fixed buffer sliced at the
        chunk's mel offset."""
        r = self.cfg.token_mel_ratio
        mu, state["enc"] = self.encoder.forward_chunk(token_chunk, context_token, state["enc"], pos_tok, real_n)
        spks = self.encoder.project_spk(embedding)
        n_mel = mu.shape[1]
        z = fixed_noise(mu.device)[pos_tok * r : pos_tok * r + n_mel]
        z = z[None].expand(mu.shape[0], -1, -1)
        mel = solve_euler_chunk(self.estimator, z, mu, spks, conds_chunk, self.cfg.cfm, state["est"], pos_tok * r,
                                real_n * r)
        return mel, state

    # ---------------- training ----------------
    def loss(self, token, token_len, feat, feat_len, embedding, streaming: bool, generator=None, draws=None):
        """The unified streaming/offline CFM training loss (JAX
        `CausalFlow.loss`): token [B, L] and token_len [B]; feat [B, Tmel,
        80] the target mel, feat_len [B]; embedding [B, 192]; streaming: the
        chunk masks. A random conditioning prefix of the target mel (0-30%
        of feat_len, half of the rows) is the prompt. The draws come from
        `generator` (models/flow_matching.loss_draws) unless `draws` gives
        them. Returns the float32 scalar loss."""
        mu, _ = self.encoder(token, token_len, streaming=streaming)
        spks = self.encoder.project_spk(embedding)
        B, Tmel, n_mels = feat.shape
        d = draws if draws is not None else loss_draws(generator, B, Tmel, n_mels, self.cfg.cfm, feat.device)
        idx = torch.where(d["coin"] < 0.5, (d["frac"] * 0.3 * feat_len.float()).int(), 0)
        cond_mask = (torch.arange(Tmel, device=feat.device)[None, :] < idx[:, None]).to(feat.dtype)
        mask_f = make_non_pad_mask(feat_len, Tmel).to(feat.dtype)
        return cfm_loss(self.estimator, feat, mask_f, mu[:, :Tmel], spks, feat * cond_mask[..., None], self.cfg.cfm,
                        streaming, d)
