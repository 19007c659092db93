"""Offline TTS engine: LM speech tokens -> flow mel -> HiFT wav.

Counterpart of cosyvoice_tpu/runtime/engine.py:CosyVoice2Engine for
`tts(stream=False)`:

1. the LM prompt [sos, prompt_text, text, task, prompt_speech] is decoded by
   `Qwen2LM.generate` with min_len = 2*len(text), max_len = 20*len(text);
   when `text_tokens` is an iterator of id chunks (bi-streaming text input,
   as for LLM-generated text), by `Qwen2LM.generate_bistream` instead, with
   no length bounds from the text, whose exact-shape extends of 2..16 rows
   run K4 and K5; on the card the LM's decode steps run as CUDA graphs
   (models/decode_graph.py), eagerly with `Qwen2LM(..., graphs=False)`;
2. `synthesize_offline` runs the flow offline on prompt + generated tokens
   (10 CFG Euler steps), drops the prompt mel, pads the tail with
   LOG_SILENCE up to the same length bucket as the JAX engine, and vocodes
   with HiFT (which ends in an iSTFT). With no generated token it takes
   the JAX engine's token2wav route: the flow over the prompt tokens alone,
   and the mel rows past the prompt mel (some only for an odd prompt)
   vocoded in the `mel_bucket` bucket.

The engine serves each LM configuration of models/llm.py: bf16, int4p over
an int8 arena, and int4p over a bf16 arena (whose decode steps run the
whole-step kernel K7 while the arena holds at most 2048 rows), e.g.
`build_random_engine(seed, "cuda", LMConfig(qwen=Qwen2Config(quant="int4p")))`.
It takes ids and features; the frontend (text normalisation, BPE, S3
tokenizer, CAM++) is not part of it. Streaming output (`stream=True`), speed
change, vc mode, per-request seeds and continuous batching are not ported
yet.
"""

import dataclasses
import time
from typing import Generator

import numpy as np
import torch

from cosyvoice_tpu_torch.convert import export_lm_params, load_jax_params
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm import TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT, LMConfig, Qwen2LM, Qwen2LMModule
from cosyvoice_tpu_torch.ops.quant import quantize_lm_params
from cosyvoice_tpu_torch.utils.devices import resolve_device
from cosyvoice_tpu_torch.utils.init import init_random_
from cosyvoice_tpu_torch.utils.profiling import StageTimer

LOG_SILENCE = -11.512925  # ln(1e-5): matcha mel floor, used for mel padding
RELATIVE_BUCKET = 0.125  # the JAX engine's default geometric length bucket
SEED = 1986  # the JAX engine's default sampling seed (LM and HiFT source)


def _bucket(n: int, b: int) -> int:
    return ((n + b - 1) // b) * b


def _bucket_geo(n: int, b: int) -> int:
    """The JAX engine's length bucket: multiples of `b`, with the step
    doubling each octave beyond n = b/RELATIVE_BUCKET. The vocoder is
    non-causal, so the LOG_SILENCE tail up to this length shapes the last
    frames; the port pads alike to produce the same wav."""
    step = 1 << max(int(RELATIVE_BUCKET * n).bit_length() - 1, 0)
    return _bucket(n, max(step, b))


class CosyVoice2Engine:
    def __init__(self, lm: Qwen2LM, flow: CausalFlow, hift: HiFTGenerator, token_bucket: int = 64,
                 mel_bucket: int = 32):
        self.lm, self.flow, self.hift = lm, flow, hift
        self.device = lm.device
        for name, m in (("flow", flow), ("hift", hift)):
            dev = next(m.parameters()).device
            if dev != self.device:
                raise ValueError(f"{name} is on {dev}, the LM on {self.device}")
        self.token_mel_ratio = flow.cfg.token_mel_ratio
        self.wav_hop = hift.cfg.hop_total  # samples per mel frame (480 at 24 kHz)
        self.token_bucket = token_bucket
        self.mel_bucket = mel_bucket  # the vocoder's length bucket when it runs alone (no tokens generated)
        self.timer = StageTimer()

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(SEED)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _flow_mel(self, all_tokens, prompt_feat, embedding):
        """The flow over prompt + generated tokens, padded to the JAX
        engine's token bucket: mel [1, Lpad * r, 80], zero past L * r."""
        dev, r = self.device, self.token_mel_ratio
        L = len(all_tokens)
        Lpad = _bucket_geo(L, self.token_bucket)
        tok = torch.zeros((1, Lpad), dtype=torch.long, device=dev)
        tok[0, :L] = torch.as_tensor(np.asarray(all_tokens, np.int64), device=dev)
        conds = torch.zeros((1, Lpad * r, 80), dtype=torch.float32, device=dev)
        conds[:, : prompt_feat.shape[1]] = torch.as_tensor(prompt_feat, dtype=torch.float32, device=dev)
        emb = torch.as_tensor(embedding, dtype=torch.float32, device=dev)
        return self.flow.inference(tok, torch.tensor([L], device=dev), conds, emb)

    def synthesize_offline(self, tokens, prompt_token, prompt_feat, embedding):
        """tokens [L] generated, prompt_token [Lp], prompt_feat [1, pm, 80],
        embedding [1, 192] -> wav np.ndarray [1, L * 2 * 480].

        With no tokens it does what the JAX engine's token2wav(finalize=True)
        does: the flow over the prompt tokens alone, mel rows pm .. 2*Lp
        padded with LOG_SILENCE to the vocoder's bucket (`mel_bucket`), so an
        odd prompt (pm < 2*Lp) gives (2*Lp - pm) * 480 samples and an even
        one an empty wav."""
        t0 = time.perf_counter()
        r, pm = self.token_mel_ratio, prompt_feat.shape[1]
        all_tokens = np.concatenate([prompt_token, tokens]).astype(np.int64)
        L = len(all_tokens)
        n_mel = L * r - pm  # mel rows past the prompt mel
        if len(tokens) == 0 and n_mel <= 0:
            return np.zeros((1, 0), np.float32)
        mel = self._flow_mel(all_tokens, prompt_feat, embedding)
        if len(tokens):
            # drop the prompt mel and silence the padded tail (the JAX engine's roll + mask)
            mel_v = torch.full_like(mel, LOG_SILENCE)
            n_valid = (L - len(prompt_token)) * r * self.wav_hop
        else:
            # the JAX engine's token2wav: those rows alone, padded to the vocoder's bucket
            mel_v = torch.full((1, _bucket_geo(n_mel, self.mel_bucket), 80), LOG_SILENCE, device=self.device)
            n_valid = n_mel * self.wav_hop
        mel_v[:, :n_mel] = mel[:, pm : L * r]
        wav, _ = self.hift.inference(mel_v, self._generator())
        out = wav[:, :n_valid].float().cpu().numpy()
        self.timer.add("t2w", time.perf_counter() - t0)
        return out

    def tts(
        self,
        text_tokens: np.ndarray,
        prompt_text_tokens: np.ndarray,
        llm_prompt_speech_token: np.ndarray,
        flow_prompt_speech_token: np.ndarray,
        prompt_speech_feat: np.ndarray,
        flow_embedding: np.ndarray,
        stream: bool = False,
    ) -> Generator[dict, None, None]:
        """Yields one {'tts_speech': np.ndarray [1, n], 'speech_tokens': [n_tok]}.

        `text_tokens` is an id array, or an iterator of id chunks for
        bi-streaming text input (`Qwen2LM.generate_bistream`)."""
        if stream:
            raise NotImplementedError("streaming tts is not ported yet; pass stream=False")
        c = self.lm.cfg
        for name, arr, vocab in (
            ("llm_prompt_speech_token", llm_prompt_speech_token, c.speech_token_size),
            ("flow_prompt_speech_token", flow_prompt_speech_token, self.flow.cfg.vocab_size),
        ):
            if np.asarray(arr).size and int(np.max(arr)) >= vocab:
                raise ValueError(
                    f"{name} has id {int(np.max(arr))} >= codec vocab {vocab}: the model config "
                    "does not match the speech tokenizer that produced these tokens"
                )
        prompt_speech = np.asarray(llm_prompt_speech_token, np.int32)
        t0 = time.perf_counter()
        gen = self._generator()
        if hasattr(text_tokens, "__next__"):
            # bi-streaming text input: no length bounds from the text
            blocks = self.lm.generate_bistream(text_tokens, np.asarray(prompt_text_tokens, np.int32), prompt_speech, gen)
        else:
            text = np.concatenate([prompt_text_tokens, text_tokens]).astype(np.int32)
            ids = np.concatenate([[c.sos_id], text, [c.task_id], prompt_speech]).astype(np.int32)
            types = np.concatenate(
                [[TYPE_SPECIAL], np.full(len(text), TYPE_TEXT), [TYPE_SPECIAL], np.full(len(prompt_speech), TYPE_SPEECH)]
            ).astype(np.int32)
            min_len, max_len = int(len(text_tokens) * 2), int(len(text_tokens) * 20)
            blocks = self.lm.generate(ids, types, gen, min_len, max_len)
        produced = []
        for block in blocks:
            produced.extend(block.tolist())
        self._sync()
        self.timer.add("lm", time.perf_counter() - t0)
        tokens = np.asarray(produced, np.int32)
        wav = self.synthesize_offline(
            tokens, np.asarray(flow_prompt_speech_token, np.int32), prompt_speech_feat, flow_embedding
        )
        yield {"tts_speech": wav, "speech_tokens": tokens}


def random_lm(seed: int = 0, device="cuda", lm_cfg: LMConfig = LMConfig()):
    """A Qwen2LM with random weights made on `device` from `seed`, and the
    host seconds its quantisation took (None unquantised). With
    `lm_cfg.qwen.quant` set, the LM's fp weights are made as for the
    unquantised LM, quantised on the host by `quantize_lm_params` (as the
    JAX API quantises a checkpoint) and loaded."""
    dev = resolve_device(device)
    lm = Qwen2LM(lm_cfg, device=dev)
    if not lm_cfg.qwen.quant:
        init_random_(lm.module, seed)
        return lm, None
    fp_qwen = dataclasses.replace(lm_cfg.qwen, quant=False, kv_quant=False)
    with torch.device(dev):
        fp = init_random_(Qwen2LMModule(dataclasses.replace(lm_cfg, qwen=fp_qwen)), seed)
    t0 = time.perf_counter()
    tree = quantize_lm_params(export_lm_params(fp), lm_cfg.qwen.quant)
    del fp
    load_jax_params(lm.module, tree)
    return lm, time.perf_counter() - t0


def build_random_engine(
    seed: int = 0,
    device="cuda",
    lm_cfg: LMConfig = LMConfig(),
    flow_cfg: FlowConfig = FlowConfig(),
    hift_cfg: HiFTConfig = HiFTConfig(),
) -> CosyVoice2Engine:
    """An engine with random weights made on `device` from `seed` (default
    configs: full-width CosyVoice2-0.5B), its LM from `random_lm`; the
    engine's timer records the host time of a quantisation as stage
    "quantize"."""
    lm, quantize_s = random_lm(seed, device, lm_cfg)
    flow = CausalFlow(flow_cfg, device=lm.device)
    hift = HiFTGenerator(hift_cfg, device=lm.device)
    init_random_(flow, seed + 1)
    init_random_(hift, seed + 2)
    engine = CosyVoice2Engine(lm, flow, hift)
    if quantize_s is not None:
        engine.timer.add("quantize", quantize_s)
    return engine
