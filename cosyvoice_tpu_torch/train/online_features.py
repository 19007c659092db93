"""Online speech-token extraction during training.

Counterpart of cosyvoice_tpu/train/online_features.py (the reference's
batch ONNX extraction, used when a parquet lacks precomputed tokens): the
port's S3 tokenizer (models/speech_tokenizer.py) runs batched on the
training device over the whisper features already in the batch
(data/processor.compute_whisper_fbank).
"""

from typing import Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.models.speech_tokenizer import S3Tokenizer, S3TokenizerConfig
from cosyvoice_tpu_torch.utils.devices import resolve_device
from cosyvoice_tpu_torch.utils.init import init_random_


class OnlineSpeechTokenExtractor:
    """`tokenizer`: an S3Tokenizer with loaded weights (e.g. a frontend's),
    else one of `cfg` with random weights from `seed` on `device`."""

    def __init__(self, tokenizer: Optional[S3Tokenizer] = None, cfg: Optional[S3TokenizerConfig] = None,
                 seed: int = 0, device="cuda"):
        if tokenizer is None:
            with torch.device(resolve_device(device)):
                tokenizer = init_random_(S3Tokenizer(cfg or S3TokenizerConfig()), seed)
        self.tokenizer = tokenizer
        self.device = next(tokenizer.parameters()).device

    @torch.inference_mode()
    def __call__(self, whisper_feat: np.ndarray, whisper_feat_len: np.ndarray):
        """[B, T, 128] at 100 Hz -> (tokens [B, T_tok] int32, token_len [B] int32) at 25 Hz."""
        toks, lens = self.tokenizer(torch.as_tensor(np.asarray(whisper_feat, np.float32), device=self.device),
                                    torch.as_tensor(np.asarray(whisper_feat_len), device=self.device))
        return toks.cpu().numpy().astype(np.int32), lens.cpu().numpy().astype(np.int32)

    def add_to_batch(self, batch: dict) -> dict:
        """`batch` with "speech_token" / "speech_token_len" from its whisper
        features where it has none."""
        if "speech_token" in batch or "whisper_feat" not in batch:
            return batch
        batch = dict(batch)
        batch["speech_token"], batch["speech_token_len"] = self(batch["whisper_feat"], batch["whisper_feat_len"])
        return batch
