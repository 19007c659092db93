"""CosyVoice-300M (v1) flow: MaskedDiffWithXvec in PyTorch.

Counterpart of cosyvoice_tpu/models/flow_v1.py (inference): the 50 Hz
speech tokens go through an embedding and the non-causal WeNet conformer
(`FlowV1Encoder.encode`), are projected to 80 channels, interpolated to
the 22.05 kHz / 256-hop mel rate (1 token -> 22050 / 256 / 50 frames) with
the head / middle / tail split around the 20-token streaming overlap
(34 mel frames) and refined by a conv / GroupNorm / Mish stack
(`regulate_inference`); the non-causal two-level U-Net then solves the
10-step CFG Euler ODE from noise z to mel (models/flow_matching.py).

Streaming continuity comes from the (z, mu) cache: `inference` returns the
prompt rows and the last 34 rows of (z, mu), and the next window's call
pins its first rows to them. The noise z is the port's own draw from an
explicit torch.Generator: the JAX package draws it with
jax.random.normal(fold_in(seed, chunk)), a threefry draw the port does not
reproduce (ROADMAP C4), so `inference` takes an optional `noise` tensor
(the tests hand it JAX's).

Training (`loss`, the counterpart of the JAX `MaskedDiffFlow.loss`): the
tokens' encoding interpolated to the target mel's length and refined
(`regulate_train`, zero past each row's feat_len), then the CFM loss of
models/flow_matching.py with the prompt condition of CausalFlow.loss (a
prefix of 0-30 % of feat_len on half of the rows). Its draws come from a
torch.Generator unless `draws` gives them (the tests hand it JAX's).
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
from torch import nn

from cosyvoice_tpu_torch.models.flow_decoder import ConditionalDecoder, EstimatorConfig
from cosyvoice_tpu_torch.models.flow_matching import CFMConfig, cfm_loss, loss_draws, solve_euler
from cosyvoice_tpu_torch.nn.activation import mish
from cosyvoice_tpu_torch.nn.conformer import ConformerEncoder
from cosyvoice_tpu_torch.nn.conv import Conv1d
from cosyvoice_tpu_torch.ops.masks import make_non_pad_mask
from cosyvoice_tpu_torch.ops.resample import interpolate_linear
from cosyvoice_tpu_torch.utils.devices import resolve_device


@dataclass(frozen=True)
class FlowV1Config:
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 4096
    input_frame_rate: int = 50
    sample_rate: int = 22050
    mel_hop: int = 256
    token_overlap_len: int = 20
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    regulator_ratios: Tuple[int, ...] = (1, 1, 1, 1)
    estimator: EstimatorConfig = field(default_factory=lambda: EstimatorConfig(channels=(256, 256), causal=False))
    cfm: CFMConfig = field(default_factory=CFMConfig)

    @property
    def overlap_mel(self) -> int:
        """Mel frames of the token overlap (20 tokens -> 34 frames)."""
        return int(self.token_overlap_len / self.input_frame_rate * self.sample_rate / self.mel_hop)

    def mel_len(self, n_tokens: int) -> int:
        return int(n_tokens / self.input_frame_rate * self.sample_rate / self.mel_hop)


class RegulatorConvStack(nn.Module):
    """The length regulator's refinement: num_layers x (conv k=3 pad 1,
    GroupNorm of one group, Mish), then a 1x1 conv."""

    def __init__(self, channels: int = 80, num_layers: int = 4):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"conv_{i}", Conv1d(channels, channels, 3, padding=1))
            self.add_module(f"norm_{i}", nn.GroupNorm(1, channels, eps=1e-5))
        self.proj = Conv1d(channels, channels, 1)

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(x)
            x = mish(getattr(self, f"norm_{i}")(x.transpose(1, 2)).transpose(1, 2))
        return self.proj(x)


class FlowV1Encoder(nn.Module):
    def __init__(self, cfg: FlowV1Config):
        super().__init__()
        c = self.cfg = cfg
        self.input_embedding = nn.Embedding(c.vocab_size, c.input_size)
        self.spk_embed_affine_layer = nn.Linear(c.spk_embed_dim, c.output_size)
        self.encoder = ConformerEncoder(c.input_size, c.input_size, c.attention_heads, c.linear_units, c.num_blocks)
        self.encoder_proj = nn.Linear(c.input_size, c.output_size)
        self.regulator = RegulatorConvStack(c.output_size, len(c.regulator_ratios))

    def project_spk(self, embedding):
        """l2-normalise the x-vector, then project 192 -> 80."""
        return self.spk_embed_affine_layer(embedding / (torch.linalg.norm(embedding, dim=-1, keepdim=True) + 1e-12))

    def encode(self, token, token_len):
        """token [B, L] -> [B, L, 80] (full attention over token_len)."""
        mask = make_non_pad_mask(token_len, token.shape[1])
        h, _ = self.encoder(self.input_embedding(token.clamp_min(0)) * mask[..., None], token_len)
        return self.encoder_proj(h)

    def regulate_inference(self, h1, h2, mel_len1: int, mel_len2: int):
        """h1 [1, Lp, 80] prompt tokens, h2 [1, Lt, 80] target tokens ->
        [1, mel_len1 + mel_len2, 80]: the target's head and tail overlap
        tokens interpolated to overlap_mel frames each and its middle to the
        rest (one interpolation where it has no more than 2 x 20 tokens),
        after the prompt's own interpolation."""
        c = self.cfg
        ov, n = c.overlap_mel, c.token_overlap_len
        h2t = h2.transpose(1, 2)
        if h2.shape[1] > 2 * n:
            x2 = torch.cat([interpolate_linear(h2t[:, :, :n], ov), interpolate_linear(h2t[:, :, n:-n], mel_len2 - 2 * ov),
                            interpolate_linear(h2t[:, :, -n:], ov)], dim=2)
        else:
            x2 = interpolate_linear(h2t, mel_len2)
        x = torch.cat([interpolate_linear(h1.transpose(1, 2), mel_len1), x2], dim=2) if h1.shape[1] else x2
        return self.regulator(x.transpose(1, 2))

    def regulate_train(self, h, mel_len: int, feat_len):
        """h [B, L, 80] -> [B, mel_len, 80]: one interpolation to mel_len,
        the refinement stack, zero past each row's feat_len."""
        out = self.regulator(interpolate_linear(h.transpose(1, 2), mel_len).transpose(1, 2))
        return out * make_non_pad_mask(feat_len, mel_len)[..., None].to(out.dtype)


class MaskedDiffFlow(nn.Module):
    """v1 flow: encoder, estimator, and the (z, mu)-cached CFM inference."""

    def __init__(self, cfg: FlowV1Config = FlowV1Config(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.encoder = FlowV1Encoder(cfg)
            self.estimator = ConditionalDecoder(cfg.estimator)
        self.eval()

    @torch.inference_mode()
    def inference(self, token, prompt_token_len: int, prompt_feat, embedding, generator: torch.Generator,
                  cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, noise: Optional[torch.Tensor] = None):
        """token [1, L] prompt tokens then the window's (exact length);
        prompt_feat [1, mel_len1, 80]; embedding [1, 192]. z is drawn from
        `generator` unless `noise` [1, T, 80] is given (T = mel_len1 +
        mel_len(L - prompt_token_len)); `cache` (z, mu) from the previous
        window pins their first rows. Returns (mel [1, mel_len2, 80], the
        new (z, mu) cache: the prompt rows and the last overlap_mel rows)."""
        c = self.cfg
        L = token.shape[1]
        mel_len1 = prompt_feat.shape[1]
        mel_len2 = c.mel_len(L - prompt_token_len)
        h = self.encoder.encode(token, torch.tensor([L], device=token.device))
        spks = self.encoder.project_spk(embedding)
        mu = self.encoder.regulate_inference(h[:, :prompt_token_len], h[:, prompt_token_len:], mel_len1, mel_len2)
        T = mel_len1 + mel_len2
        conds = torch.zeros((1, T, 80), dtype=mu.dtype, device=mu.device)
        conds[:, :mel_len1] = prompt_feat
        mask = torch.ones((1, T), dtype=mu.dtype, device=mu.device)
        if noise is None:
            z = torch.randn((1, T, 80), generator=generator, device=mu.device, dtype=mu.dtype)
        else:
            z = noise.to(mu.device, mu.dtype)
        if cache is not None:
            zc, muc = cache
            lc = min(zc.shape[1], T)  # a short finalize window
            z = torch.cat([zc[:, :lc], z[:, lc:]], dim=1)
            mu = torch.cat([muc[:, :lc], mu[:, lc:]], dim=1)
        ov = c.overlap_mel
        new_cache = (torch.cat([z[:, :mel_len1], z[:, T - ov :]], dim=1),
                     torch.cat([mu[:, :mel_len1], mu[:, T - ov :]], dim=1))
        mel = solve_euler(self.estimator, z, mu, mask, spks, conds, c.cfm)
        return mel[:, mel_len1:], new_cache

    def loss(self, token, token_len, feat, feat_len, embedding, generator=None, draws=None):
        """The CFM training loss: token [B, L], token_len [B]; feat [B, Tmel,
        80] the target mel, feat_len [B]; embedding [B, 192]. The draws
        (models/flow_matching.loss_draws) come from `generator` unless
        `draws` gives them. Returns the float32 scalar loss."""
        B, Tmel, n_mels = feat.shape
        mu = self.encoder.regulate_train(self.encoder.encode(token, token_len), Tmel, feat_len)
        spks = self.encoder.project_spk(embedding)
        d = draws if draws is not None else loss_draws(generator, B, Tmel, n_mels, self.cfg.cfm, feat.device)
        idx = torch.where(d["coin"] < 0.5, (d["frac"] * 0.3 * feat_len.float()).int(), 0)
        cond_mask = (torch.arange(Tmel, device=feat.device)[None, :] < idx[:, None]).to(feat.dtype)
        mask = make_non_pad_mask(feat_len, Tmel).to(feat.dtype)
        return cfm_loss(self.estimator, feat, mask, mu, spks, feat * cond_mask[..., None], self.cfg.cfm, False, d)
