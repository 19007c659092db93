"""Inference frontend: text -> token ids, prompt wav -> (speech tokens, mel,
x-vector), and the model inputs of each mode.

Counterpart of cosyvoice_tpu/frontend/frontend.py. The speech tokenizer
(S3Tokenizer), the speaker model (CamPPEmbedding) and the three feature
extractors (ops/mel.py) run on the frontend's device; text normalisation,
tokenisation and the prompt cache run on the host. Its outputs are numpy
arrays, the engine's inputs, so that the prompt cache and the speaker file
(spk2info.pkl, a pickle of numpy arrays) are the JAX package's.
"""

import hashlib
import os
import pickle
from collections import OrderedDict
from fractions import Fraction
from typing import Dict, Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.frontend.text_normalize import basic_normalize
from cosyvoice_tpu_torch.frontend.tokenizer import get_tokenizer
from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
from cosyvoice_tpu_torch.models.speech_tokenizer import S3Tokenizer, S3TokenizerConfig
from cosyvoice_tpu_torch.ops.mel import kaldi_fbank, mel_spectrogram, whisper_log_mel
from cosyvoice_tpu_torch.ops.resample import resample_poly
from cosyvoice_tpu_torch.utils.audio_io import load_wav
from cosyvoice_tpu_torch.utils.devices import resolve_device
from cosyvoice_tpu_torch.utils.init import init_random_

PROMPT_CACHE_MAX = 16  # prompts kept by the anonymous-prompt LRU


class CosyVoiceFrontEnd:
    """`tokenizer` defaults to get_tokenizer(token_path, version); the S3
    tokenizer and CAM++ get random weights made on `device` from `seed`
    (and seed + 1); convert.load_jax_params fills them from JAX trees.
    `spk2info_path` names a spk2info.pkl to load, or a spk2info.pt beside
    that name (the reference's torch pickle) to migrate."""

    def __init__(
        self,
        tokenizer=None,
        token_path: Optional[str] = None,
        sample_rate: int = 24000,
        spk2info_path: str = "",
        seed: int = 0,
        version: int = 2,
        s3_cfg: Optional[S3TokenizerConfig] = None,
        campplus_cfg: Optional[CamPPConfig] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or get_tokenizer(token_path, version=version)
        self.sample_rate = sample_rate
        with torch.device(self.device):
            self.speech_tokenizer = init_random_(S3Tokenizer(s3_cfg or S3TokenizerConfig()), seed)
            self.campplus = init_random_(CamPPEmbedding(campplus_cfg or CamPPConfig()), seed + 1)
        self.spk2info: Dict[str, dict] = {}
        pt_path = spk2info_path[: -len(".pkl")] + ".pt" if spk2info_path.endswith(".pkl") else ""
        if spk2info_path and os.path.exists(spk2info_path):
            with open(spk2info_path, "rb") as f:
                self.spk2info = pickle.load(f)
        elif pt_path and os.path.exists(pt_path):
            raw = torch.load(pt_path, map_location="cpu")
            self.spk2info = {
                spk: {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in info.items()}
                for spk, info in raw.items()
            }
        # anonymous-prompt LRU: serving clients often repeat a prompt wav
        # without registering a speaker id; a hit skips S3, CAM++ and both mels
        self._prompt_cache: "OrderedDict[tuple, dict]" = OrderedDict()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ---------------- extraction ----------------
    def _extract_text_token(self, text):
        """str -> [Lt] int32; a generator of text pieces (an upstream LLM
        streaming its output) -> a generator of per-piece id arrays, which
        the engine routes to the bistream decode."""
        if hasattr(text, "__next__"):
            return self._extract_text_token_generator(text)
        return np.asarray(self.tokenizer.encode(text, allowed_special="all"), np.int32)

    def _extract_text_token_generator(self, text_generator):
        for piece in text_generator:
            toks = np.asarray(self.tokenizer.encode(piece, allowed_special="all"), np.int32)
            if toks.size:
                yield toks

    @torch.inference_mode()
    def _extract_speech_token(self, speech_16k: np.ndarray) -> np.ndarray:
        """speech_16k [1, L] float32 at 16 kHz -> [T_tok] int32 (25 Hz)."""
        if speech_16k.shape[1] / 16000 > 30:
            raise ValueError("do not support audio longer than 30s")
        mel = whisper_log_mel(self._tensor(speech_16k), n_mels=self.speech_tokenizer.cfg.n_mels).transpose(1, 2)
        tokens, tok_len = self.speech_tokenizer(mel, torch.tensor([mel.shape[1]], device=self.device))
        return tokens[0, : int(tok_len[0])].cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def _extract_spk_embedding(self, speech_16k: np.ndarray) -> np.ndarray:
        """speech_16k [1, L] -> x-vector [1, 192] float32."""
        feat = kaldi_fbank(self._tensor(speech_16k[0]), cmn=True)
        return self.campplus(feat[None]).float().cpu().numpy()

    @torch.inference_mode()
    def _extract_speech_feat(self, speech_24k: np.ndarray) -> np.ndarray:
        """speech at the sample rate [1, L] -> mel [1, T, 80] float32."""
        mel = mel_spectrogram(self._tensor(speech_24k), sr=self.sample_rate)
        return mel.transpose(1, 2).cpu().numpy()

    def _resample(self, speech_16k: np.ndarray) -> np.ndarray:
        """[1, L] at 16 kHz -> [1, L'] at the sample rate, on the device."""
        frac = Fraction(self.sample_rate, 16000).limit_denominator(1000)
        out = resample_poly(self._tensor(speech_16k[0]), frac.numerator, frac.denominator)
        return out.cpu().numpy()[None]

    # ---------------- text normalize ----------------
    def text_normalize(self, text, split: bool = True):
        """basic_normalize (split into segments unless `split` is False); a
        generator (bistream text input) and SSML-like text ("<|...|>") pass
        through as one segment."""
        if hasattr(text, "__next__") or ("<|" in text and "|>" in text):
            return [text] if split else text
        return basic_normalize(text, self.tokenizer.encode, split=split)

    # ---------------- per-mode assembly ----------------
    def _prompt_key(self, prompt_text: str, prompt_wav):
        if isinstance(prompt_wav, str):
            try:
                sig = (prompt_wav, os.path.getmtime(prompt_wav))
            except OSError:
                sig = (prompt_wav, 0.0)
        else:
            sig = hashlib.blake2b(np.ascontiguousarray(prompt_wav).tobytes(), digest_size=16).hexdigest()
        return (prompt_text, sig)

    def _load_16k(self, wav) -> np.ndarray:
        return load_wav(wav, 16000) if isinstance(wav, str) else wav

    def frontend_zero_shot(self, tts_text, prompt_text, prompt_wav, zero_shot_spk_id: str = ""):
        """prompt_wav: a path or a [1, L] float array at 16 kHz (resampled
        here for the mel at the sample rate)."""
        out = {"text_tokens": self._extract_text_token(tts_text)}
        if zero_shot_spk_id and zero_shot_spk_id in self.spk2info:
            out.update(self.spk2info[zero_shot_spk_id])
            return out
        key = self._prompt_key(prompt_text, prompt_wav)
        info = self._prompt_cache.get(key)
        if info is None:
            speech_16k = self._load_16k(prompt_wav)
            speech_feat = self._extract_speech_feat(self._resample(speech_16k))
            speech_token = self._extract_speech_token(speech_16k)
            if self.sample_rate == 24000:
                # mel rows == 2 * tokens (reference frontend.py:174-178)
                token_len = min(speech_feat.shape[1] // 2, len(speech_token))
                speech_feat = speech_feat[:, : 2 * token_len]
                speech_token = speech_token[:token_len]
            info = dict(
                prompt_text_tokens=self._extract_text_token(prompt_text),
                llm_prompt_speech_token=speech_token,
                flow_prompt_speech_token=speech_token,
                prompt_speech_feat=speech_feat,
                flow_embedding=self._extract_spk_embedding(speech_16k),
            )
            self._prompt_cache[key] = info
            if len(self._prompt_cache) > PROMPT_CACHE_MAX:
                self._prompt_cache.popitem(last=False)
        else:
            self._prompt_cache.move_to_end(key)
        out.update(info)
        return out

    def frontend_cross_lingual(self, tts_text, prompt_wav, zero_shot_spk_id: str = ""):
        out = self.frontend_zero_shot(tts_text, "", prompt_wav, zero_shot_spk_id)
        # no text or speech prompt in the LM (reference frontend.py:191-198)
        out["prompt_text_tokens"] = np.zeros(0, np.int32)
        out["llm_prompt_speech_token"] = np.zeros(0, np.int32)
        return out

    def frontend_instruct2(self, tts_text, instruct_text, prompt_wav, zero_shot_spk_id: str = ""):
        out = self.frontend_zero_shot(tts_text, instruct_text + "<|endofprompt|>", prompt_wav, zero_shot_spk_id)
        out["llm_prompt_speech_token"] = np.zeros(0, np.int32)
        return out

    def frontend_vc(self, source_speech_16k, prompt_wav):
        speech_16k = self._load_16k(prompt_wav)
        return dict(
            source_speech_token=self._extract_speech_token(self._load_16k(source_speech_16k)),
            flow_prompt_speech_token=self._extract_speech_token(speech_16k),
            prompt_speech_feat=self._extract_speech_feat(self._resample(speech_16k)),
            flow_embedding=self._extract_spk_embedding(speech_16k),
        )

    # ---------------- speaker cache ----------------
    def add_zero_shot_spk(self, prompt_text, prompt_wav, spk_id: str) -> bool:
        info = self.frontend_zero_shot("", prompt_text, prompt_wav, "")
        info.pop("text_tokens")
        self.spk2info[spk_id] = info
        return True

    def save_spkinfo(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self.spk2info, f)
