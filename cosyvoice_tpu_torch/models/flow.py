"""Flow acoustic model: speech tokens -> mel (upsample conformer + CFM).

Counterpart of cosyvoice_tpu/models/flow.py:CausalFlow for the CosyVoice2
layout (upsample-conformer encoder, causal U-Net estimator), offline
inference. Streaming (chunk masks, lookahead context, incremental chunk
state) and the v3 DiT variant are not ported yet.
"""

from dataclasses import dataclass, field
import torch
from torch import nn

from cosyvoice_tpu_torch.models.flow_decoder import ConditionalDecoder, EstimatorConfig
from cosyvoice_tpu_torch.models.flow_matching import CFMConfig, fixed_noise_buffer, solve_euler
from cosyvoice_tpu_torch.nn.conformer import UpsampleConformerEncoder
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
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)
    cfm: CFMConfig = field(default_factory=CFMConfig)


class FlowEncoder(nn.Module):
    """Token embedding + speaker projection + upsample conformer + mel projection."""

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
        )
        self.encoder_proj = nn.Linear(c.input_size, c.output_size)

    def project_spk(self, embedding):
        """l2-normalize the x-vector, then project 192 -> 80."""
        embedding = embedding / (torch.linalg.norm(embedding, dim=-1, keepdim=True) + 1e-12)
        return self.spk_embed_affine_layer(embedding)

    def forward(self, token, token_len):
        """token [B, L] (tail-padded, true length token_len) -> (mu [B, L*r, 80],
        mel non-pad mask [B, L*r])."""
        mask = make_non_pad_mask(token_len, token.shape[1])
        h, mel_mask = self.encoder(self.input_embedding(token.clamp_min(0)) * mask[..., None], token_len)
        return self.encoder_proj(h), mel_mask


class CausalFlow(nn.Module):
    """CosyVoice2 causal flow: FlowEncoder + ConditionalDecoder + Euler solver."""

    def __init__(self, cfg: FlowConfig = FlowConfig(), device="cuda"):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.encoder = FlowEncoder(cfg)
            self.estimator = ConditionalDecoder(cfg.estimator)
        self.eval()

    @torch.inference_mode()
    def inference(self, token, token_len, conds, embedding):
        """token [1, L] prompt+generated tokens (zero tail-padded, true length
        token_len); conds [1, L*r, 80] prompt mel at the front; embedding
        [1, 192]. Returns mel [1, L*r, 80], zero beyond r*token_len."""
        mu, mel_mask = self.encoder(token, token_len)
        spks = self.encoder.project_spk(embedding)
        z = torch.from_numpy(fixed_noise_buffer()[None, : mu.shape[1]]).to(mu.device)
        mask_f = mel_mask.to(mu.dtype)
        mel = solve_euler(self.estimator, z, mu, mask_f, spks, conds, self.cfg.cfm)
        return mel * mask_f[..., None]
