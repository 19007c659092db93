"""TTS engine: LM speech tokens -> flow mel -> HiFT wav, offline and streaming.

Counterpart of cosyvoice_tpu/runtime/engine.py:CosyVoice2Engine:

1. the LM prompt [sos, prompt_text, text, task, prompt_speech] is decoded by
   `Qwen2LM.generate` with min_len = 2*len(text), max_len = 20*len(text);
   when `text_tokens` is an iterator of id chunks (bi-streaming text input,
   as for LLM-generated text), by `Qwen2LM.generate_bistream` instead, with
   no length bounds from the text, whose exact-shape extends of 2..16 rows
   run K4 and K5; on the card the LM's decode steps run as CUDA graphs
   (models/decode_graph.py), eagerly with `Qwen2LM(..., graphs=False)`;
2. offline (`tts(stream=False)`), `synthesize_offline` runs the flow on
   prompt + generated tokens (10 CFG Euler steps), drops the prompt mel,
   pads the tail with LOG_SILENCE up to the same length bucket as the JAX
   engine, and vocodes with HiFT (which ends in an iSTFT). With no
   generated token it takes the JAX engine's generic token2wav finalize;
3. streaming (`tts(stream=True)`), the LM runs ahead on a thread of its own
   (`_Prefetcher`; on the card on a CUDA stream of its own) while this
   thread turns hop-scheduled chunks of tokens into wav on another stream:
   hops of `token_hop_len` 25 tokens (the first padded so that prompt +
   hop is a multiple of it) growing by `next_hop` ("doubling" to 100,
   "exponential" or "time_based"), each chunk gated on 3 lookahead tokens.
   A chunk's mel is either recomputed over the whole prefix under chunk
   masks (below `flow_incr_min_tok` prompt + body tokens) or made by the
   incremental flow over the session's carried KV arenas (from there on,
   after one catch-up chunk over the whole prefix; `flow_arena0` tokens
   first, doubled as needed up to `flow_arena_max`). Non-final chunks
   vocode the 8-row mel cache + the new mel unpadded, overwrite the source
   head with the cached source and cross-fade the held-back tail of the
   last chunk with a hamming window; the finalize vocodes the rest in the
   JAX engine's mel bucket. The mel, source and speech caches stay on the
   card between chunks. Each chunk equals the JAX engine's default
   streaming chunk (fused_stream, incremental_flow, flow_incr_min_tok 320,
   doubling hops), except that an odd prompt (prompt mel rows != 2 x
   prompt tokens) finalizes through the generic recompute path, which the
   JAX default engine skips (ROADMAP C4);
4. the speculative fused first chunk (`speculative_first_chunk`, on by
   default as in the JAX engine, whose gate this is): a streamed text
   request decoded by this engine's own LM (no `token_generator`, no vc,
   no scheduler, no bistream text) with an even prompt (prompt mel rows
   == 2 x prompt tokens) takes its first chunk through
   `_try_first_chunk_fast`, unless max_len (after the arena's capacity
   clamp) is below the chunk's hop + 3 tokens or the sampling has a
   repetition penalty (`_first_chunk_admits` decides all of it, in `tts`;
   a refused request streams on the standard path). A table that a
   first-chunk graph reads (the fixed noise, the position encodings, the
   STFT window) is kept on the card for good: growth keeps the table it
   replaced. `Qwen2LM.generate_first` runs the prefill and the
   first n1 decode blocks (the arena of n1 blocks) with no host read; the
   chunk's token->wav (the streaming flow over prompt + hop tokens in the
   JAX engine's first-chunk bucket, the hop's mel rows, HiFT) is one CUDA
   graph replay on the card (runtime/first_chunk.py), eager on the CPU;
   one fetch brings the tokens and the wav. A stop id inside the chunk's
   tokens discards the chunk, and the standard loop renders the tokens so
   far; otherwise the session's HiFT caches come from the graph and
   `Qwen2LM.generate_continue` carries the block loop on from the same
   generator on the prefetch thread, so the token stream is an
   uninterrupted `generate`'s. The stream goes on at chunk 1. Its chunk
   log's first entry is "fused-first"; the timer's stage
   "first_chunk_fused" holds the chunk's seconds. The unbatched server
   (runtime/api.py:CosyVoice2._in_turn) runs one request at a time, so no
   other thread replays a decode graph while a first-chunk graph is
   captured (with a scheduler the gate refuses the path).

The engine serves each LM configuration of models/llm.py: bf16, int8 or
int4 weights (over a bf16 or an int8 arena), int4p over an int8 arena, and
int4p over a bf16 arena (whose decode steps run the whole-step kernel K7
while the arena holds at most 2048 rows), e.g.
`build_random_engine(seed, "cuda", LMConfig(qwen=Qwen2Config(quant="int4p")))`.
It takes ids and features (runtime/api.py's frontend makes them from text
and a prompt wav). `tts(source_speech_token=...)` (vc) takes the source's
speech tokens as the token stream, with no LM call; `tts(speed=...)`
stretches the offline mel by linear interpolation before the vocoder (the
generic finalize), and raises when streaming; `tts(rng_seed=s)` seeds the
LM's sampling generator (the vocoder's source keeps SEED);
`tts(token_generator=...)` takes an external stream of token blocks.

Without a scheduler the engine serves one request at a time (runtime/
api.py queues them): its LM decodes one B=1 request at a time.
Continuous batching: with `engine.scheduler` set (an
runtime/batch_scheduler.py:LMBatchScheduler over this engine's LM whose
`capture_graphs()` has run, as CosyVoice2.enable_continuous_batching
does), a text request's LM prompt goes to `scheduler.submit`, and
concurrent `tts` calls (from several threads) share its one batched
decode loop; bistream requests still decode on the LM's B=1 path beside
it. Each streaming session keeps its chunk log (`stream_log` reads the
calling thread's last). Token->wav, offline or streamed, holds the decode
graphs' capture lock: no capture runs beside it (a streaming request's LM
thread may capture one), and the token->wav work of concurrent sessions
runs one at a time, which serves more audio per second than running it in
several threads at once (PERF.md §6, chip_smoke.py's serve phase).

`CosyVoice3Engine` (the JAX engine.py:CosyVoice3Engine) serves
Fun-CosyVoice3-0.5B (the v3 LM layout, the DiT flow, the causal HiFT;
`build_random_engine_v3`): the same LM routes and chunk schedule, but each
streaming chunk re-vocodes the session's cumulative mel with the causal
vocoder (bucketed and padded with LOG_SILENCE below the finalize, whose
emitted samples do not change) and emits the samples past the ones already
sent: no source or speech caches, no cross-fade. Runs of more than 5
silent / breath tokens are dropped from the LM's stream (`_squelch`, not
in vc). The speculative first chunk is off, as in the JAX v3 engine
(engine.py:CosyVoice3Engine sets it False): every chunk takes the standard
path.

`CosyVoiceV1Engine` (the JAX engine.py:CosyVoiceV1Engine) serves
CosyVoice-300M (`build_random_engine_v1`): the TransformerLM decoding
eagerly, the MaskedDiffFlow over windows of hop + 20 overlap tokens pinned
by its (z, mu) cache, the 22.05 kHz HiFT with mel, source and speech
caches (see its docstring).
"""

import contextlib
import dataclasses
import math
import queue
import threading
import time
from dataclasses import dataclass
from typing import Generator, Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config, MaskedDiffFlow
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator, v1_hift_config
from cosyvoice_tpu_torch.models.llm import TYPE_SPECIAL, TYPE_SPEECH, TYPE_TEXT, LMConfig, Qwen2LM, Qwen2LMModule
from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config, TransformerLM
from cosyvoice_tpu_torch.ops.quant import quantize_lm_params
from cosyvoice_tpu_torch.ops.resample import interpolate_linear
from cosyvoice_tpu_torch.runtime.first_chunk import FirstChunkGraphs
from cosyvoice_tpu_torch.utils.config import cosyvoice3_configs
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


@dataclass
class SessionState:
    """One streaming request's caches, on the engine's device: the HiFT mel
    cache [1, 8, 80], source and speech caches [1, 8*480] (v3: the
    cumulative mel and the emitted samples instead), and the incremental
    flow's state (`CausalFlow.stream_state`) with the prompt +
    body tokens it has consumed and its arena length in tokens."""

    hift_mel_cache: Optional[torch.Tensor] = None
    hift_source_cache: Optional[torch.Tensor] = None
    hift_speech_cache: Optional[torch.Tensor] = None
    # v3: the mel of every chunk so far and the samples already emitted
    mel_cumulative: Optional[torch.Tensor] = None
    speech_offset: int = 0
    flow_state: Optional[dict] = None
    flow_pos: int = 0
    flow_arena: int = 0
    log: list = dataclasses.field(default_factory=list)  # token2wav's record of each chunk


def lm_prompt(cfg: LMConfig, text_tokens, prompt_text_tokens, prompt_speech):
    """A text request's LM prompt [sos, prompt_text, text, task,
    prompt_speech] as (ids, types, min_len, max_len): 2 and 20 tokens per
    text id."""
    text = np.concatenate([prompt_text_tokens, text_tokens]).astype(np.int32)
    ids = np.concatenate([[cfg.sos_id], text, [cfg.task_id], prompt_speech]).astype(np.int32)
    types = np.concatenate(
        [[TYPE_SPECIAL], np.full(len(text), TYPE_TEXT), [TYPE_SPECIAL], np.full(len(prompt_speech), TYPE_SPEECH)]
    ).astype(np.int32)
    return ids, types, int(len(text_tokens) * 2), int(len(text_tokens) * 20)


class _Prefetcher:
    """Drains a token-block generator on a thread of its own (a bounded
    queue), on `stream` when given, so that the LM decodes ahead while the
    consumer turns tokens into wav. `close()` stops the thread and closes
    the generator there (the LM serves one request at a time, so a stream
    dropped early must free it). `busy_s` sums the seconds spent inside the
    generator."""

    _END = object()

    def __init__(self, gen, depth: int = 4, stream=None):
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc = None
        self.busy_s = 0.0
        self._thread = threading.Thread(target=self._run, args=(gen, stream), daemon=True, name="lm-prefetch")
        self._thread.start()

    def _run(self, gen, stream):
        try:
            ctx = contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)
            with ctx:
                if stream is not None:
                    stream.wait_stream(torch.cuda.default_stream(stream.device))
                try:
                    while not self._stop.is_set():
                        t = time.perf_counter()
                        item = next(gen, self._END)
                        self.busy_s += time.perf_counter() - t
                        if item is self._END or not self._put(item):
                            break
                finally:
                    close = getattr(gen, "close", None)  # a vc source's blocks are a plain iterator
                    if close is not None:
                        close()
        except BaseException as e:  # re-raised on the consumer's thread
            self._exc = e
        finally:
            self._put(self._END)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            self._q.put(item)  # later calls end too
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def drain_nowait(self):
        """Every block already queued, without blocking: the adaptive hop
        policies see the whole LM backlog."""
        items = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._END:
                self._q.put(item)
                break
            items.append(item)
        return items

    def close(self):
        """Stop the thread (it closes the generator) and wait for it."""
        self._stop.set()
        self._thread.join()


class CosyVoice2Engine:
    # tokens dropped from the LM's stream in runs longer than max_silent
    # (v3's silent / breath tokens; v2 has none)
    silent_tokens: tuple = ()
    max_silent = 5
    # the incremental streaming flow: a session takes it once prompt + body
    # reach flow_incr_min_tok tokens (below, a chunk that recomputes the
    # whole prefix costs less), starts with arenas of flow_arena0 tokens,
    # doubles them as needed and leaves the path past flow_arena_max
    flow_incr_min_tok = 320
    flow_arena0 = 256
    flow_arena_max = 2048
    # a plain streamed request's first chunk through the speculative fused
    # path (the JAX engine's default; see the module docstring)
    speculative_first_chunk = True

    def __init__(self, lm: Qwen2LM, flow: CausalFlow, hift: HiFTGenerator, token_bucket: int = 64,
                 mel_bucket: int = 32, hop_policy: str = "doubling"):
        if hop_policy not in ("doubling", "exponential", "time_based"):
            raise ValueError(f"hop_policy {hop_policy!r}: doubling, exponential or time_based")
        self.lm, self.flow, self.hift = lm, flow, hift
        self.device = lm.device
        for name, m in (("flow", flow), ("hift", hift)):
            dev = next(m.parameters()).device
            if dev != self.device:
                raise ValueError(f"{name} is on {dev}, the LM on {self.device}")
        self.token_mel_ratio = flow.cfg.token_mel_ratio
        self.pre_lookahead_len = flow.cfg.pre_lookahead_len
        self.wav_hop = hift.cfg.hop_total  # samples per mel frame (480 at 24 kHz)
        self.token_bucket = token_bucket
        self.mel_bucket = mel_bucket  # the vocoder's length bucket when it pads a finalize
        # a hop is the flow's streaming chunk (25 tokens), so chunk boundaries
        # fall on the flow's chunk-mask boundaries (the incremental flow is
        # exact only there)
        self.token_hop_len = flow.cfg.chunk_size
        self.token_max_hop_len = 4 * self.token_hop_len
        self.stream_scale_factor = 2
        self.hop_policy = hop_policy
        self.token_rate = 25  # Hz, the time_based policy's audio clock
        self.mel_cache_len = 8
        self.source_cache_len = self.mel_cache_len * self.wav_hop
        self.speech_window = torch.as_tensor(np.hamming(2 * self.source_cache_len), dtype=torch.float32,
                                             device=self.device)
        cuda = self.device.type == "cuda"
        # streaming: the LM's thread and the token->wav work each on a stream
        # of its own; token->wav at the higher priority, so that its kernels
        # take free SMs before the LM's (which runs far ahead of real time)
        self._lm_stream = torch.cuda.Stream(self.device) if cuda else None
        self._t2w_stream = torch.cuda.Stream(self.device, priority=-1) if cuda else None
        self._local = threading.local()  # the calling thread's last streaming session's chunk log
        self.flow_state_max_bytes = 0  # the incremental flow state's largest footprint, growth copies included
        self.timer = StageTimer()
        self.scheduler = None  # an LMBatchScheduler over self.lm: continuous batching
        self.squelched = 0  # tokens `_squelch` dropped
        self.first_chunk = FirstChunkGraphs(self)  # the speculative first chunk's token->wav (graphs on the card)

    @property
    def stream_log(self) -> list:
        """Per chunk of the calling thread's last streaming request: path,
        tokens, wall and device ms."""
        return getattr(self._local, "log", [])

    def _squelch(self, blocks):
        """The token blocks of `blocks` without the silent tokens past the
        max_silent-th of each run (the run carries across blocks); blocks
        left empty are not yielded. `blocks` itself with no silent tokens."""
        if not self.silent_tokens:
            return blocks
        return self._squelched(iter(blocks))

    def _squelched(self, blocks):
        silent = set(self.silent_tokens)
        run = 0
        try:
            for block in blocks:
                out = []
                for t in block.tolist():
                    if t in silent:
                        run += 1
                        if run > self.max_silent:
                            self.squelched += 1
                            continue
                    else:
                        run = 0
                    out.append(t)
                if out:
                    yield np.asarray(out, np.int32)
        finally:
            close = getattr(blocks, "close", None)
            if close is not None:
                close()  # free the LM's request

    def _generator(self, seed: Optional[int] = None) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(SEED if seed is None else seed)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ flow

    def _flow_prefix(self, all_tokens, prompt_feat, embedding, streaming: bool, finalize: bool):
        """The flow over prompt + generated tokens, padded to the JAX engine's
        token bucket of len(all_tokens): the last pre_lookahead_len tokens are
        the lookahead context unless `finalize`. Returns (mel [1, Lpad*r, 80],
        zero past the body, body length)."""
        r, la = self.token_mel_ratio, self.pre_lookahead_len
        L = len(all_tokens)
        body = all_tokens if finalize else all_tokens[:-la]
        Lpad = _bucket_geo(L, self.token_bucket)
        tok = torch.zeros((1, Lpad), dtype=torch.long, device=self.device)
        tok[0, : len(body)] = self._tensor(body, torch.long)
        conds = torch.zeros((1, Lpad * r, 80), device=self.device)
        conds[:, : prompt_feat.shape[1]] = self._tensor(prompt_feat)
        ctx = None if finalize else self._tensor(all_tokens[None, -la:], torch.long)
        mel = self.flow.inference(tok, torch.tensor([len(body)], device=self.device), conds, self._tensor(embedding),
                                  ctx, streaming)
        return mel, len(body)

    def _incr_chunk_inputs(self, state, all_tokens, prompt_feat, n_real: int):
        """The next incremental chunk's tokens (n_real real, padded to a
        multiple of 16) and its slice of the prompt mel; grows the flow
        state to cover it."""
        r, pm, consumed = self.token_mel_ratio, prompt_feat.shape[1], state.flow_pos
        n_pad = _bucket(n_real, 16)
        chunk = torch.zeros((1, n_pad), dtype=torch.long, device=self.device)
        chunk[0, :n_real] = self._tensor(all_tokens[consumed : consumed + n_real], torch.long)
        conds = torch.zeros((1, n_pad * r, 80), device=self.device)
        lo = consumed * r
        if lo < pm:
            k = min(pm - lo, n_pad * r)
            conds[0, :k] = self._tensor(prompt_feat[0, lo : lo + k])
        self._ensure_flow_capacity(state, consumed + n_pad)
        return chunk, conds

    def _ensure_flow_capacity(self, state, need_tok: int):
        """Make or grow the session's flow arenas (doubling from flow_arena0)
        to cover need_tok positions."""
        arena = state.flow_arena if state.flow_state is not None else self.flow_arena0
        while arena < need_tok:
            arena *= 2
        if state.flow_state is None:
            state.flow_state = self.flow.stream_state(1, arena)
            state.flow_pos = 0
            total = CausalFlow.stream_state_nbytes(state.flow_state)
        elif arena > state.flow_arena:
            old = CausalFlow.stream_state_nbytes(state.flow_state)
            state.flow_state = self.flow.grow_stream_state(state.flow_state, arena)
            total = old + CausalFlow.stream_state_nbytes(state.flow_state)  # both live while it copies
        else:
            return
        state.flow_arena = arena
        self.flow_state_max_bytes = max(self.flow_state_max_bytes, total)

    # ------------------------------------------------------------------ vocoder

    def _fade(self, wav, prev_tail):
        """Hamming cross-fade of wav's head with the last chunk's held-back tail."""
        n, w = self.source_cache_len, self.speech_window
        return torch.cat([wav[:, :n] * w[n:] + prev_tail * w[:n], wav[:, n:]], dim=1)

    def _vocode(self, mel, cache_source):
        """mel [1, T, 80] padded with LOG_SILENCE to the `mel_bucket` bucket,
        vocoded -> (wav, source) [1, T*480]."""
        T = mel.shape[1]
        mel_p = torch.full((1, _bucket_geo(T, self.mel_bucket), 80), LOG_SILENCE, device=self.device)
        mel_p[:, :T] = mel
        wav, src = self.hift.inference(mel_p, self._generator(), cache_source)
        return wav[:, : T * self.wav_hop], src[:, : T * self.wav_hop]

    def _vocode_chunk(self, state, mel_new, keep: bool = True):
        """The fused paths' vocoder step: a first chunk alone, a later one
        after the 8-row mel cache with the source cache overwriting the
        source's head and the faded head; unpadded. With `keep`, the caches
        move on and the last 8 * 480 samples are held back."""
        if state.hift_mel_cache is None:
            mel = mel_new
            wav, src = self.hift.inference(mel, self._generator())
        else:
            mel = torch.cat([state.hift_mel_cache, mel_new], dim=1)
            wav, src = self.hift.inference(mel, self._generator(), state.hift_source_cache)
            wav = self._fade(wav, state.hift_speech_cache)
        if not keep:
            return wav
        n = self.source_cache_len
        state.hift_mel_cache = mel[:, -self.mel_cache_len :]
        state.hift_source_cache, state.hift_speech_cache = src[:, -n:], wav[:, -n:]
        return wav[:, :-n]

    # ------------------------------------------------------------------ chunks

    def _stream_chunk_recompute(self, state, all_tokens, prompt_feat, embedding, token_offset, this_hop):
        """Non-final chunk, recompute: the streaming flow over the whole
        prefix (lookahead included), the chunk's this_hop * r new mel rows
        sliced out (the JAX engine's _stream_chunk_fused)."""
        r = self.token_mel_ratio
        mel_full, _ = self._flow_prefix(all_tokens, prompt_feat, embedding, streaming=True, finalize=False)
        rows = this_hop * r
        start = min(prompt_feat.shape[1] + token_offset * r, mel_full.shape[1] - rows)  # dynamic_slice's clamp
        return self._vocode_chunk(state, mel_full[:, start : start + rows])

    def _stream_chunk_incr(self, state, all_tokens, prompt_feat, embedding, token_offset, this_hop):
        """Non-final chunk, incremental: the tokens the flow state has not
        consumed (the whole prefix on a session's first incremental chunk)
        through inference_chunk, this_hop * r rows emitted."""
        r, la, consumed = self.token_mel_ratio, self.pre_lookahead_len, state.flow_pos
        n_real = len(all_tokens) - la - consumed
        ctx = self._tensor(all_tokens[None, consumed + n_real : consumed + n_real + la], torch.long)
        chunk, conds = self._incr_chunk_inputs(state, all_tokens, prompt_feat, n_real)
        mel, state.flow_state = self.flow.inference_chunk(chunk, ctx, conds, self._tensor(embedding), state.flow_state,
                                                          consumed, n_real)
        state.flow_pos = consumed + n_real
        start = (n_real - this_hop) * r
        return self._vocode_chunk(state, mel[:, start : start + this_hop * r])

    def _finalize_incr(self, state, all_tokens, prompt_feat, embedding):
        """Final chunk, incremental: the remaining tokens through the flow
        state (no lookahead), then the bucketed vocode + fade."""
        rem = len(all_tokens) - state.flow_pos
        mel = torch.zeros((1, 0, 80), device=self.device)
        if rem > 0:
            consumed = state.flow_pos
            chunk, conds = self._incr_chunk_inputs(state, all_tokens, prompt_feat, rem)
            mel, state.flow_state = self.flow.inference_chunk(chunk, None, conds, self._tensor(embedding),
                                                              state.flow_state, consumed, rem)
            state.flow_pos = consumed + rem
            mel = mel[:, : rem * self.token_mel_ratio]
        return self._vocode_rest(state, mel)

    def _finalize_recompute(self, state, all_tokens, prompt_feat, embedding, token_offset, rem):
        """Final chunk, recompute (the JAX engine's _finalize_fused): the
        streaming flow over every token, the rem * r remaining rows padded
        with LOG_SILENCE so that cache + rows fill exactly the `mel_bucket`
        bucket of the generic path (the non-causal vocoder sees the pad),
        vocoded after the caches; cut to the valid samples."""
        r = self.token_mel_ratio
        mel_full, _ = self._flow_prefix(all_tokens, prompt_feat, embedding, streaming=True, finalize=True)
        cache_rows = 0 if state.hift_mel_cache is None else self.mel_cache_len
        chunk_mel = _bucket_geo(cache_rows + rem * r, self.mel_bucket) - cache_rows
        mel_new = torch.full((1, chunk_mel, 80), LOG_SILENCE, device=self.device)
        start = prompt_feat.shape[1] + token_offset * r
        real = mel_full[:, start : start + min(rem * r, chunk_mel)]
        mel_new[:, : real.shape[1]] = real
        wav = self._vocode_chunk(state, mel_new, keep=False)
        return wav[:, : (cache_rows + rem * r) * self.wav_hop]

    def _finalize_generic(self, state, all_tokens, prompt_feat, embedding, token_offset, streaming: bool = True,
                          speed: float = 1.0):
        """Final chunk, the generic path: the flow over every token, the mel
        past the prompt mel and the emitted chunks (offline with `speed` !=
        1, stretched to int(rows / speed) rows), bucketed vocode + fade.
        Odd prompts finalize here (ROADMAP C4), as does a finalize with no
        token left, and the offline path with no generated token or a speed
        change."""
        r = self.token_mel_ratio
        mel, n = self._flow_prefix(all_tokens, prompt_feat, embedding, streaming, finalize=True)
        mel = mel[:, prompt_feat.shape[1] + token_offset * r : n * r]
        if speed != 1.0:
            mel = interpolate_linear(mel.transpose(1, 2), int(mel.shape[1] / speed)).transpose(1, 2)
        return self._vocode_rest(state, mel)

    def _vocode_rest(self, state, mel):
        """A finalize's mel after the mel cache, vocoded in the `mel_bucket`
        bucket with the source cache, faded."""
        if mel.shape[1] == 0 and state.hift_mel_cache is None:
            return torch.zeros((1, 0), device=self.device)
        if state.hift_mel_cache is None:
            wav, _ = self._vocode(mel, None)
            return wav
        wav, _ = self._vocode(torch.cat([state.hift_mel_cache, mel], dim=1), state.hift_source_cache)
        return self._fade(wav, state.hift_speech_cache)

    @torch.inference_mode()
    def token2wav(self, state: SessionState, tokens, prompt_token, prompt_feat, embedding, token_offset: int,
                  finalize: bool = False) -> np.ndarray:
        """One streaming chunk (the JAX engine's token2wav routing): tokens
        [L] generated so far (with the 3 lookahead tokens unless finalize),
        prompt_token [Lp], prompt_feat [1, pm, 80], embedding [1, 192],
        token_offset the tokens already emitted. Returns the chunk's wav
        [1, n] on the host and logs its path, tokens and times in
        the session's log (`stream_log`). The incremental flow needs pm == 2 * Lp; a session
        takes it once prompt + body reach flow_incr_min_tok and keeps it
        while they stay within flow_arena_max - 16."""
        t0, ev = self._chunk_start()
        all_tokens = np.concatenate([prompt_token, tokens]).astype(np.int64)
        even = prompt_feat.shape[1] == len(prompt_token) * self.token_mel_ratio
        incr = (even and len(all_tokens) + 16 <= self.flow_arena_max
                and (state.flow_state is not None or len(all_tokens) >= self.flow_incr_min_tok))
        if not finalize:
            this_hop = len(tokens) - token_offset - self.pre_lookahead_len
            if this_hop <= 0 and state.hift_mel_cache is None:
                return np.zeros((1, 0), np.float32)
            n_tok = this_hop
            if incr:
                path = "incremental" if state.flow_state is not None or token_offset == 0 else "catch-up"
                wav = self._stream_chunk_incr(state, all_tokens, prompt_feat, embedding, token_offset, this_hop)
            else:
                path = "recompute"
                wav = self._stream_chunk_recompute(state, all_tokens, prompt_feat, embedding, token_offset,
                                                   this_hop)
        else:
            n_tok = len(tokens) - token_offset
            if incr and state.flow_state is not None:
                path = "finalize-incremental"
                wav = self._finalize_incr(state, all_tokens, prompt_feat, embedding)
            elif n_tok > 0 and even:
                path = "finalize-recompute"
                wav = self._finalize_recompute(state, all_tokens, prompt_feat, embedding, token_offset, n_tok)
            else:
                path = "finalize-generic"
                wav = self._finalize_generic(state, all_tokens, prompt_feat, embedding, token_offset)
        return self._chunk_end(state, t0, ev, path, n_tok, wav)

    def _chunk_start(self):
        """(host clock, CUDA events with the first recorded, or None on CPU)
        of a chunk's token->wav work."""
        ev = None
        if self.device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        return time.perf_counter(), ev

    def _chunk_end(self, state, t0, ev, path, n_tok, wav, stage="stream_chunk"):
        """The chunk's wav on the host, its wall and device ms logged in the
        session's log and the timer's `stage`."""
        if ev is not None:
            ev[1].record()
        out = wav.float().cpu().numpy()
        wall = time.perf_counter() - t0
        self.timer.add(stage, wall)
        state.log.append({"path": path, "tokens": n_tok, "wall_ms": wall * 1e3,
                          "device_ms": ev[0].elapsed_time(ev[1]) if ev is not None else None})
        return out

    def synthesize_offline(self, tokens, prompt_token, prompt_feat, embedding, speed: float = 1.0):
        """tokens [L] generated, prompt_token [Lp], prompt_feat [1, pm, 80],
        embedding [1, 192] -> wav np.ndarray [1, L * 2 * 480] (at speed 1).

        With no tokens, or a speed change, it does what the JAX engine's
        token2wav(finalize=True) does (the generic finalize, offline masks):
        the flow over prompt and tokens, mel rows from pm on (stretched to
        int(rows / speed)) padded with LOG_SILENCE to the vocoder's bucket
        (`mel_bucket`); with no tokens an odd prompt (pm < 2*Lp) gives
        (2*Lp - pm) * 480 samples and an even one an empty wav. It holds
        the decode graphs' capture lock (see the module docstring)."""
        t0 = time.perf_counter()
        r, pm = self.token_mel_ratio, prompt_feat.shape[1]
        all_tokens = np.concatenate([prompt_token, tokens]).astype(np.int64)
        L = len(all_tokens)
        with self.lm.decoder.capture_lock, torch.inference_mode():
            if len(tokens) == 0 or speed != 1.0:
                wav = self._finalize_generic(SessionState(), all_tokens, prompt_feat, embedding, 0, streaming=False,
                                             speed=speed)
            else:
                # drop the prompt mel and silence the padded tail (the JAX engine's roll + mask)
                mel, _ = self._flow_prefix(all_tokens, prompt_feat, embedding, streaming=False, finalize=True)
                mel_v = torch.full_like(mel, LOG_SILENCE)
                mel_v[:, : L * r - pm] = mel[:, pm : L * r]
                wav, _ = self.hift.inference(mel_v, self._generator())
                wav = wav[:, : (L - len(prompt_token)) * r * self.wav_hop]
            out = wav.float().cpu().numpy()
        self.timer.add("t2w", time.perf_counter() - t0)
        return out

    def synthesize_finalize(self, tokens, prompt_token, prompt_feat, embedding) -> np.ndarray:
        """The JAX engine's token2wav(finalize=True) outside a stream: the
        flow over prompt and tokens under offline masks, the mel past the
        prompt vocoded in its bucket (the generic finalize), wav [1, n] on
        the host. The GRPO reward server's token->wav. It holds the decode
        graphs' capture lock."""
        all_tokens = np.concatenate([prompt_token, tokens]).astype(np.int64)
        with self.lm.decoder.capture_lock, torch.inference_mode():
            wav = self._finalize_generic(SessionState(), all_tokens, prompt_feat, embedding, 0, streaming=False)
            return wav.float().cpu().numpy()

    def next_hop(self, hop: int, chunk_index: int, elapsed_s: float, token_offset: int, n_pending: int) -> int:
        """Token hop of the chunk after chunk `chunk_index` (the JAX engine's
        policies): "doubling" x stream_scale_factor up to token_max_hop_len
        (25 -> 50 -> 100); "exponential" base * 2**chunk_index, uncapped;
        "time_based" the whole pending backlog rounded up to a hop multiple
        when the emitted audio leads the wall clock by more than 4 average
        chunk times, rounded down when by more than 2, else the base hop."""
        base = self.token_hop_len
        if self.hop_policy == "exponential":
            return base * (2**chunk_index)
        if self.hop_policy == "time_based":
            if chunk_index <= 0 or elapsed_s <= 0:
                return base
            duration_s = token_offset / float(self.token_rate)
            avg_chunk_s = elapsed_s / (chunk_index + 1)
            if avg_chunk_s <= 0:
                return base
            multiples = (duration_s - elapsed_s) / avg_chunk_s
            if multiples > 4:
                nxt = (n_pending // base + 1) * base
            elif multiples > 2:
                nxt = (n_pending // base) * base
            else:
                nxt = base
            return max(base, nxt)
        return min(self.token_max_hop_len, hop * self.stream_scale_factor)

    @contextlib.contextmanager
    def _on_t2w(self, lock: bool = True):
        """Token->wav work of a streaming request: on the engine's own CUDA
        stream, never while the LM's thread captures a decode graph (which
        would see this thread's allocations and syncs), and one session at
        a time (see the module docstring). `lock` False: on that stream
        without the capture lock (the speculative first chunk's LM blocks,
        whose decode graph captures take it)."""
        with self.lm.decoder.capture_lock if lock else contextlib.nullcontext():
            if self._t2w_stream is None:
                yield
                return
            self._t2w_stream.wait_stream(torch.cuda.default_stream(self.device))
            with torch.cuda.stream(self._t2w_stream):
                yield

    def tts(
        self,
        text_tokens: np.ndarray,
        prompt_text_tokens: np.ndarray,
        llm_prompt_speech_token: np.ndarray,
        flow_prompt_speech_token: np.ndarray,
        prompt_speech_feat: np.ndarray,
        flow_embedding: np.ndarray,
        stream: bool = False,
        speed: float = 1.0,
        source_speech_token: Optional[np.ndarray] = None,
        rng_seed: Optional[int] = None,
        token_generator=None,
    ) -> Generator[dict, None, None]:
        """Yields {'tts_speech': np.ndarray [1, n], 'speech_tokens': [n_tok]}:
        offline one dict with every token, streaming one per chunk with the
        tokens it covers (their concatenation is the request's tokens).

        `text_tokens` is an id array, or an iterator of id chunks for
        bi-streaming text input (`Qwen2LM.generate_bistream`). With
        `token_generator` (an iterable of token blocks, e.g. an
        LMBatchScheduler handle) or `source_speech_token` (vc) those tokens
        are the token stream and the LM is not called; otherwise a text
        request goes to `self.scheduler` when one is set. `rng_seed` seeds
        the LM's generator (default SEED; the scheduler draws from its own).
        `speed` != 1 is offline only."""
        c = self.lm.cfg
        if stream and speed != 1.0:
            raise ValueError("speed change only supports non-stream mode")
        for name, arr, vocab in (
            ("llm_prompt_speech_token", llm_prompt_speech_token, c.speech_token_size),
            ("flow_prompt_speech_token", flow_prompt_speech_token, self.flow.cfg.vocab_size),
            ("source_speech_token", source_speech_token, self.flow.cfg.vocab_size),
        ):
            if arr is not None and np.asarray(arr).size and int(np.max(arr)) >= vocab:
                raise ValueError(
                    f"{name} has id {int(np.max(arr))} >= codec vocab {vocab}: the model config "
                    "does not match the speech tokenizer that produced these tokens"
                )
        prompt_speech = np.asarray(llm_prompt_speech_token, np.int32)
        prompt_token = np.asarray(flow_prompt_speech_token, np.int32)
        t0 = time.perf_counter()
        speculative = None  # the LM request of a first chunk through the speculative path
        if token_generator is not None:
            blocks = self._squelch(iter(token_generator))
        elif source_speech_token is not None:
            blocks = iter([np.asarray(source_speech_token, np.int32)])
        elif hasattr(text_tokens, "__next__"):
            # bi-streaming text input: no length bounds from the text
            blocks = self._squelch(self.lm.generate_bistream(
                text_tokens, np.asarray(prompt_text_tokens, np.int32), prompt_speech, self._generator(rng_seed)))
        else:
            ids, types, min_len, max_len = lm_prompt(c, text_tokens, prompt_text_tokens, prompt_speech)
            if self.scheduler is not None:
                # continuous batching: the shared loop decodes this prompt beside the other sessions
                blocks = self._squelch(iter(self.scheduler.submit(ids, types, min_len, max_len)))
            elif stream and self._first_chunk_admits(len(ids), max_len, prompt_token, prompt_speech_feat):
                blocks, speculative = None, (ids, types, min_len, max_len, self._generator(rng_seed))
            else:
                blocks = self._squelch(self.lm.generate(ids, types, self._generator(rng_seed), min_len, max_len))
        if stream:
            yield from self._stream(blocks, t0, prompt_token, prompt_speech_feat, flow_embedding, speculative)
            return
        produced = []
        for block in blocks:
            produced.extend(block.tolist())
        if self.scheduler is None:
            # (beside the scheduler a device-wide sync would wait on its steps too)
            self._sync()
        self.timer.add("lm", time.perf_counter() - t0)
        tokens = np.asarray(produced, np.int32)
        wav = self.synthesize_offline(tokens, prompt_token, prompt_speech_feat, flow_embedding, speed)
        yield {"tts_speech": wav, "speech_tokens": tokens}

    def _first_chunk_admits(self, n_ids, max_len, prompt_token, prompt_feat) -> bool:
        """The JAX engine's gate with `_try_first_chunk_fast`'s refusals, in
        one place: a plain streamed text request decoded by this engine's
        own LM (the caller has ruled out external tokens, vc, a scheduler
        and bistream text; streaming never changes speed) takes the
        speculative first chunk when the path is on, its prompt is even
        (prompt mel rows == r x prompt tokens), the sampling has no
        repetition penalty and max_len, after the arena's capacity clamp,
        holds the chunk's tokens."""
        c = self.lm.cfg
        if not self.speculative_first_chunk or c.repetition_penalty != 1.0:
            return False
        if prompt_feat.shape[1] != len(prompt_token) * self.token_mel_ratio:
            return False
        need = self.first_chunk.plan(len(prompt_token))[1]
        return min(max_len, self.lm.capacity(self.lm.pad_prompt(n_ids), c.block_size)) >= need

    def _try_first_chunk_fast(self, state, ids, types, min_len, max_len, generator, prompt_token, prompt_feat,
                              embedding):
        """The speculative fused first chunk (the JAX engine's
        `_try_first_chunk_fast`) of a request `_first_chunk_admits` let in:
        a dict, "wav" the first chunk [1, n] on the host or None when a
        stop id fell inside the chunk's tokens (the chunk is discarded),
        "produced" the tokens so far (cut at the stop and max_len),
        "gen_done", "first" the LM's open request and "blocks" its
        continuation (None when gen_done), "token_offset".

        On the token->wav stream: `Qwen2LM.generate_first` (prefill and the
        n1 blocks on the decode graphs, no host read), then, under the
        capture lock, the prompt's static inputs, the copy of its tokens
        into the first-chunk graph's buffer and the replay
        (FirstChunkGraphs), then one fetch of the tokens and the wav (which
        syncs the stream). The session's HiFT caches are copies of the
        graph's outputs (the next request's replay rewrites those)."""
        c = self.lm.cfg
        this_hop, need, n1, _ = self.first_chunk.plan(len(prompt_token))
        t0 = time.perf_counter()
        with self._on_t2w(lock=False):
            ev = self._chunk_start()[1]
            first = self.lm.generate_first(ids, types, generator, min_len, max_len, n1)
        try:
            with self._on_t2w():
                # the static inputs are written only while this request holds the LM
                e = self.first_chunk.prepare(prompt_token, prompt_feat, embedding)
                wav, mel_cache, source_cache, speech_cache = self.first_chunk.run(e, first.tokens)
                caches = mel_cache.clone(), source_cache.clone(), speech_cache.clone()
                if ev is not None:
                    ev[1].record()
                # ONE fetch: [n1 * block sampled token ids | first-chunk wav]
                packed = torch.cat([e.tokens[0].float(), wav[0].float()]).cpu().numpy()
        except BaseException:
            first.close()
            raise
        n_tok = e.tokens.shape[1]
        gen0 = packed[:n_tok].astype(np.int32)
        wav = packed[None, n_tok:]
        stop_idx = np.nonzero(gen0 >= c.speech_token_size)[0]
        wall = time.perf_counter() - t0
        self.timer.add("first_chunk_fused", wall)
        if len(stop_idx) and stop_idx[0] < need:
            # the real stream would not emit this chunk: discard it, fall back
            first.close()
            return {"wav": None, "produced": gen0[: stop_idx[0]].tolist()[: first.max_len], "gen_done": True,
                    "first": first, "blocks": None}
        produced = (gen0[: stop_idx[0]] if len(stop_idx) else gen0).tolist()[: first.max_len]
        gen_done = bool(len(stop_idx)) or len(produced) >= first.max_len
        state.hift_mel_cache, state.hift_source_cache, state.hift_speech_cache = caches
        state.log.append({"path": "fused-first", "tokens": this_hop, "wall_ms": wall * 1e3,
                          "device_ms": ev[0].elapsed_time(ev[1]) if ev is not None else None})
        if gen_done:
            first.close()
        return {"wav": wav, "produced": produced, "gen_done": gen_done, "first": first,
                "blocks": None if gen_done else self.lm.generate_continue(first, generator), "token_offset": this_hop}

    def _stream(self, blocks, t_req, prompt_token, prompt_feat, embedding, speculative=None):
        """The JAX engine's streaming loop: pull LM blocks until prompt pad +
        hop + 3 lookahead tokens are there, emit a chunk, drain the backlog,
        take the next hop; at the LM's end, the finalize. With `speculative`
        (in place of `blocks`: the LM request (ids, types, min_len,
        max_len, generator) of a request `_first_chunk_admits` let in), the
        first chunk goes through `_try_first_chunk_fast` first: on success
        the loop goes on from token_offset this_hop, chunk 1, with no
        prompt pad, the LM's continuation on the prefetch thread (its
        stream waits on the token->wav stream, which wrote the LM's state);
        on a discarded chunk the loop renders the tokens so far from the
        start. Stage "lm" of the timer gets the
        LM thread's seconds inside the generator, "first_chunk" the seconds
        from the tts call to the first non-empty chunk, "first_chunk_fused"
        the fused first chunk's."""
        la = self.pre_lookahead_len
        hop = self.token_hop_len
        prompt_pad = math.ceil(len(prompt_token) / hop) * hop - len(prompt_token)
        state = SessionState()
        produced, token_offset, chunk_index = [], 0, 0
        gen_done = first_emitted = False
        self._local.log = state.log
        fast = None
        if speculative is not None:
            ids, types, min_len, max_len, generator = speculative
            fast = self._try_first_chunk_fast(state, ids, types, min_len, max_len, generator, prompt_token,
                                              prompt_feat, embedding)
            produced, gen_done = fast["produced"], fast["gen_done"]
            blocks = self._squelch(fast["blocks"]) if fast["blocks"] is not None else iter(())
            if self._lm_stream is not None:
                self._lm_stream.wait_stream(self._t2w_stream)
        lm = _Prefetcher(blocks, stream=self._lm_stream)
        try:
            if fast is not None and fast["wav"] is not None:
                token_offset = fast["token_offset"]
                hop = self.next_hop(hop, 0, elapsed_s=time.perf_counter() - t_req, token_offset=token_offset,
                                    n_pending=len(produced) - token_offset)
                chunk_index = 1
                prompt_pad = 0  # consumed by the first chunk
                if fast["wav"].size:
                    self.timer.add("first_chunk", time.perf_counter() - t_req)
                    first_emitted = True
                yield {"tts_speech": fast["wav"], "speech_tokens": np.asarray(produced[:token_offset], np.int32)}
            while True:
                this_hop = hop + prompt_pad if token_offset == 0 else hop
                while not gen_done and len(produced) - token_offset < this_hop + la:
                    try:
                        produced.extend(next(lm).tolist())
                    except StopIteration:
                        gen_done = True
                if len(produced) - token_offset >= this_hop + la:
                    chunk_tokens = np.asarray(produced[: token_offset + this_hop + la], np.int32)
                    with self._on_t2w():
                        wav = self.token2wav(state, chunk_tokens, prompt_token, prompt_feat, embedding, token_offset)
                    emitted = chunk_tokens[token_offset : token_offset + this_hop]
                    token_offset += this_hop
                    for blk in lm.drain_nowait():
                        produced.extend(blk.tolist())
                    hop = self.next_hop(hop, chunk_index, elapsed_s=time.perf_counter() - t_req,
                                        token_offset=token_offset, n_pending=len(produced) - token_offset)
                    chunk_index += 1
                    if not first_emitted and wav.size:
                        self.timer.add("first_chunk", time.perf_counter() - t_req)
                        first_emitted = True
                    yield {"tts_speech": wav, "speech_tokens": emitted}
                if gen_done and len(produced) - token_offset < this_hop + la:
                    break
            self.timer.add("lm", lm.busy_s)
            tokens = np.asarray(produced, np.int32)
            with self._on_t2w():
                wav = self.token2wav(state, tokens, prompt_token, prompt_feat, embedding, token_offset,
                                     finalize=True)
            if not first_emitted and wav.size:
                self.timer.add("first_chunk", time.perf_counter() - t_req)
            yield {"tts_speech": wav, "speech_tokens": tokens[token_offset:]}
        finally:
            lm.close()
            if fast is not None:
                fast["first"].close()  # a continuation the prefetch thread never started holds the request


class CosyVoice3Engine(CosyVoice2Engine):
    """The CosyVoice3 engine (see the module docstring): the chunk schedule
    and LM routes of CosyVoice2Engine, the DiT flow's incremental path over
    its own arenas, the causal vocoder re-vocoding the cumulative mel, the
    FSQ silent / breath tokens squelched."""

    silent_tokens = (1, 2, 28, 29, 55, 248, 494, 2241, 2242, 2322, 2323)
    # the fused first chunk assumes v2's vocoder caches (the JAX v3 engine
    # turns it off too): every chunk takes the standard path
    speculative_first_chunk = False

    def _flow_mel_incr(self, state, body_tokens, ctx, prompt_feat, embedding):
        """The incremental flow over the tokens of `body_tokens` (prompt +
        generated body, no lookahead) that the session's flow state has not
        consumed; ctx [1, la] the lookahead tokens or None (finalize).
        Returns their mel [1, n*r, 80] and advances state.flow_pos."""
        consumed = state.flow_pos
        n_real = len(body_tokens) - consumed
        if n_real <= 0:
            return torch.zeros((1, 0, 80), device=self.device)
        chunk, conds = self._incr_chunk_inputs(state, body_tokens, prompt_feat, n_real)
        mel, state.flow_state = self.flow.inference_chunk(chunk, ctx, conds, self._tensor(embedding), state.flow_state,
                                                          consumed, n_real)
        state.flow_pos = consumed + n_real
        return mel[:, : n_real * self.token_mel_ratio]

    def _revocode(self, state, mel, finalize: bool):
        """The causal vocoder over the cumulative mel [1, T, 80]: below the
        finalize padded with LOG_SILENCE to the `mel_bucket` bucket and cut
        back to the exact length's samples (the emitted samples are
        prefix-stable, so the pad changes none of them); the finalize at
        the exact length. Returns the samples past state.speech_offset and
        advances it."""
        if mel.shape[1] == 0:
            return torch.zeros((1, 0), device=self.device)
        if finalize:
            wav, _ = self.hift.inference(mel, self._generator(), finalize=True)
        else:
            T = mel.shape[1]
            Tb = _bucket_geo(T, self.mel_bucket)
            mel_p = torch.full((1, Tb, 80), LOG_SILENCE, device=self.device)
            mel_p[:, :T] = mel
            wav, _ = self.hift.inference(mel_p, self._generator(), finalize=False)
            wav = wav[:, : max(0, wav.shape[1] - (Tb - T) * self.wav_hop)]
        wav = wav[:, state.speech_offset :]
        state.speech_offset += wav.shape[1]
        return wav

    def synthesize_finalize(self, tokens, prompt_token, prompt_feat, embedding) -> np.ndarray:
        """The JAX CosyVoice3Engine's token2wav(finalize=True) outside a
        stream (offline masks), under the decode graphs' capture lock."""
        with self.lm.decoder.capture_lock:
            return self.token2wav(SessionState(), np.asarray(tokens, np.int32), prompt_token, prompt_feat, embedding,
                                  0, finalize=True, stream=False)

    @torch.inference_mode()
    def token2wav(self, state: SessionState, tokens, prompt_token, prompt_feat, embedding, token_offset: int,
                  finalize: bool = False, stream: bool = True, speed: float = 1.0) -> np.ndarray:
        """One chunk (the JAX CosyVoice3Engine.token2wav): tokens [L]
        generated so far (with the 3 lookahead tokens unless finalize). The
        chunk's new mel (the incremental DiT flow over the session's arenas
        once prompt + body reach flow_incr_min_tok, when streaming with an
        even prompt; else the prefix recomputed, chunk-masked when
        `stream`) joins the cumulative mel, which is re-vocoded; returns the
        new samples [1, n] on the host and logs the chunk (`stream_log`).
        `speed` (offline finalize only) stretches the mel."""
        t0, ev = self._chunk_start()
        r, la, pm = self.token_mel_ratio, self.pre_lookahead_len, prompt_feat.shape[1]
        all_tokens = np.concatenate([prompt_token, tokens]).astype(np.int64)
        incr = (stream and pm == len(prompt_token) * r and len(all_tokens) + 16 <= self.flow_arena_max
                and (state.flow_state is not None or len(all_tokens) >= self.flow_incr_min_tok))
        if incr:
            path = "incremental" if state.flow_state is not None or token_offset == 0 else "catch-up"
            prev = state.flow_pos
            ctx = None if finalize else self._tensor(all_tokens[None, -la:], torch.long)
            mel = self._flow_mel_incr(state, all_tokens if finalize else all_tokens[:-la], ctx, prompt_feat,
                                      embedding)
            mel = mel[:, max(pm + token_offset * r - prev * r, 0) :]
        else:
            path = "recompute" if stream else "offline"
            mel, n = self._flow_prefix(all_tokens, prompt_feat, embedding, streaming=stream, finalize=finalize)
            mel = mel[:, pm + token_offset * r : n * r]
        if finalize:
            path = "finalize-" + path
        if state.mel_cumulative is not None:
            mel = torch.cat([state.mel_cumulative, mel], dim=1)
        state.mel_cumulative = mel
        if speed != 1.0:
            if token_offset != 0 or not finalize:
                raise ValueError("speed change only supports non-stream mode")
            mel = interpolate_linear(mel.transpose(1, 2), int(mel.shape[1] / speed)).transpose(1, 2)
        wav = self._revocode(state, mel, finalize)
        n_tok = len(tokens) - token_offset - (0 if finalize else la)
        return self._chunk_end(state, t0, ev, path, n_tok, wav, "stream_chunk" if stream else "t2w")

    def synthesize_offline(self, tokens, prompt_token, prompt_feat, embedding, speed: float = 1.0):
        """As CosyVoice2Engine's (the causal vocoder at the finalize over
        the mel past the prompt, its padded tail LOG_SILENCE); with no
        tokens or a speed change, the JAX v3 engine's token2wav: the flow
        under offline masks, the mel past the prompt (stretched), vocoded
        at its exact length."""
        if len(tokens) and speed == 1.0:
            return super().synthesize_offline(tokens, prompt_token, prompt_feat, embedding)
        with self.lm.decoder.capture_lock:
            return self.token2wav(SessionState(), np.asarray(tokens, np.int32), prompt_token, prompt_feat, embedding,
                                  0, finalize=True, stream=False, speed=speed)


@dataclass
class V1SessionState:
    """One CosyVoice-300M request's caches, on the engine's device: the mel
    held back for the next window's cross-fade [1, 34, 80], the flow's
    (z, mu) cache, the HiFT mel cache [1, 20, 80], source and speech caches
    [1, 20*256], the windows the flow has run, and token2wav's chunk log."""

    mel_overlap: Optional[torch.Tensor] = None
    flow_cache: Optional[tuple] = None
    hift_mel_cache: Optional[torch.Tensor] = None
    hift_source_cache: Optional[torch.Tensor] = None
    hift_speech_cache: Optional[torch.Tensor] = None
    chunk_idx: int = 0
    log: list = dataclasses.field(default_factory=list)


class CosyVoiceV1Engine:
    """The CosyVoice-300M engine (the JAX engine.py:CosyVoiceV1Engine, after
    the reference cli/model.py:29-242): TransformerLM tokens -> the
    MaskedDiffFlow mel of token windows -> the 22.05 kHz HiFT wav.

    Offline, the flow runs once over every token and HiFT vocodes the whole
    mel (`speed` stretches it first). Streamed, the LM decodes on a thread
    of its own (`_Prefetcher`) while this thread emits a chunk for every
    window of hop + 20 overlap tokens, the hop growing 100 -> 200; each
    window's flow call is pinned to the previous one by the (z, mu) cache,
    its mel's head cross-faded (Hamming) with the 34 mel rows held back
    from the window before, and its last 34 rows held back in turn; HiFT
    vocodes the 20-row mel cache + the new mel with the source cache
    overwriting the source's head, and the last 20 * 256 samples are held
    back and cross-faded into the next chunk. A finalize with no new token
    emits the held-back mel. `source_speech_token` (vc) replaces the LM's
    tokens; `llm_embedding` conditions the LM on its own speaker vector
    (default the flow's).

    The flow's noise of window i is drawn from a torch.Generator seeded with
    `flow_seed(i)`, unless `flow_noise` (a function (window index, rows) ->
    [1, rows, 80]) gives it: the JAX engine draws
    jax.random.normal(fold_in(PRNGKey(seed), i)) (ROADMAP C4). HiFT's
    source draws from a generator seeded with SEED on every call, as the
    JAX engine hands HiFT the same key every chunk. The LM decodes eagerly
    (models/llm_v1.py) and runs no kernel of the port."""

    def __init__(self, lm, flow, hift: HiFTGenerator, seed: int = SEED):
        self.lm, self.flow, self.hift = lm, flow, hift
        self.device = lm.device
        for name, m in (("flow", flow), ("hift", hift)):
            dev = next(m.parameters()).device
            if dev != self.device:
                raise ValueError(f"{name} is on {dev}, the LM on {self.device}")
        self.seed = seed
        fr = flow.cfg.input_frame_rate
        self.token_min_hop_len = 2 * fr
        self.token_max_hop_len = 4 * fr
        self.stream_scale_factor = 2  # hop growth per chunk (reference cli/model.py:50, 209)
        self.token_overlap_len = flow.cfg.token_overlap_len
        self.mel_overlap_len = flow.cfg.overlap_mel
        self.wav_hop = hift.cfg.hop_total  # 256 at 22.05 kHz
        self.mel_cache_len = 20
        self.source_cache_len = self.mel_cache_len * self.wav_hop
        self.flow_noise = None  # None, or (window index, rows) -> z [1, rows, 80]
        cuda = self.device.type == "cuda"
        self._lm_stream = torch.cuda.Stream(self.device) if cuda else None
        self._local = threading.local()
        self.timer = StageTimer()
        self.scheduler = None  # the v1 LM has no batch scheduler

    @property
    def stream_log(self) -> list:
        """Per chunk of the calling thread's last request: path, tokens,
        wall and device ms."""
        return getattr(self._local, "log", [])

    def _window(self, n: int) -> torch.Tensor:
        return torch.as_tensor(np.hamming(n), dtype=torch.float32, device=self.device)

    _generator = CosyVoice2Engine._generator
    _tensor = CosyVoice2Engine._tensor
    _chunk_start = CosyVoice2Engine._chunk_start
    _chunk_end = CosyVoice2Engine._chunk_end

    def flow_seed(self, window: int) -> int:
        """The seed of window `window`'s flow noise generator."""
        return self.seed * 100_003 + window

    def _fade(self, wav, prev_tail):
        """Hamming cross-fade of wav's head with the last chunk's held-back tail."""
        n, w = self.source_cache_len, self._window(2 * self.source_cache_len)
        return torch.cat([wav[:, :n] * w[n:] + prev_tail * w[:n], wav[:, n:]], dim=1)

    def _flow(self, state, tokens, prompt_token, prompt_feat, embedding):
        """The flow over prompt + window tokens, pinned by the session's (z,
        mu) cache; the window's mel, its head cross-faded with the held-back
        overlap mel."""
        all_tok = self._tensor(np.concatenate([prompt_token, tokens])[None], torch.long)
        pf = self._tensor(prompt_feat)
        T = pf.shape[1] + self.flow.cfg.mel_len(len(tokens))
        noise = None if self.flow_noise is None else self.flow_noise(state.chunk_idx, T)
        mel, state.flow_cache = self.flow.inference(
            all_tok, len(prompt_token), pf, self._tensor(embedding),
            self._generator(self.flow_seed(state.chunk_idx)), cache=state.flow_cache, noise=noise)
        state.chunk_idx += 1
        if state.mel_overlap is not None:
            ov = self.mel_overlap_len
            n = min(ov, mel.shape[1])
            w = self._window(2 * ov)
            head = mel[:, :n] * w[:n, None] + state.mel_overlap[:, :n] * w[ov : ov + n, None]
            mel = torch.cat([head, mel[:, n:]], dim=1)
        return mel

    def _vocode(self, mel, cache_source):
        return self.hift.inference(mel, self._generator(), cache_source)

    @torch.inference_mode()
    def token2wav(self, state: V1SessionState, tokens, prompt_token, prompt_feat, embedding, finalize: bool = False,
                  speed: float = 1.0) -> np.ndarray:
        """One chunk: tokens [Lw], the window (hop + overlap, or the rest at
        the finalize); prompt_token [Lp]; prompt_feat [1, pm, 80]; embedding
        [1, 192]. Returns its wav [1, n] on the host and logs it."""
        t0, ev = self._chunk_start()
        tokens = np.asarray(tokens, np.int64)
        if len(tokens) == 0:
            # a finalize with no new token: the held-back overlap mel
            mel = state.mel_overlap if state.mel_overlap is not None else torch.zeros((1, 0, 80), device=self.device)
            state.mel_overlap = None
            if mel.shape[1] == 0 and state.hift_mel_cache is None:
                return self._chunk_end(state, t0, ev, "finalize-empty", 0, torch.zeros((1, 0), device=self.device))
        else:
            mel = self._flow(state, tokens, np.asarray(prompt_token, np.int64), prompt_feat, embedding)
        cache_source = None
        if state.hift_mel_cache is not None:
            mel = torch.cat([state.hift_mel_cache, mel], dim=1)
            cache_source = state.hift_source_cache
        if not finalize:
            state.mel_overlap = mel[:, -self.mel_overlap_len :]
            mel = mel[:, : -self.mel_overlap_len]
            wav, src = self._vocode(mel, cache_source)
            if state.hift_speech_cache is not None:
                wav = self._fade(wav, state.hift_speech_cache)
            n = self.source_cache_len
            state.hift_mel_cache = mel[:, -self.mel_cache_len :]
            state.hift_source_cache, state.hift_speech_cache = src[:, -n:], wav[:, -n:]
            return self._chunk_end(state, t0, ev, "window", len(tokens), wav[:, :-n])
        if speed != 1.0:
            if state.hift_mel_cache is not None:
                raise ValueError("speed change only supports non-stream mode")
            mel = interpolate_linear(mel.transpose(1, 2), int(mel.shape[1] / speed)).transpose(1, 2)
        wav, _ = self._vocode(mel, cache_source)
        if state.hift_speech_cache is not None:
            wav = self._fade(wav, state.hift_speech_cache)
        return self._chunk_end(state, t0, ev, "finalize", len(tokens), wav)

    def tts(
        self,
        text_tokens: np.ndarray,
        prompt_text_tokens: np.ndarray,
        llm_prompt_speech_token: np.ndarray,
        flow_prompt_speech_token: np.ndarray,
        prompt_speech_feat: np.ndarray,
        flow_embedding: np.ndarray,
        llm_embedding: Optional[np.ndarray] = None,
        stream: bool = False,
        speed: float = 1.0,
        source_speech_token: Optional[np.ndarray] = None,
        rng_seed: Optional[int] = None,
    ) -> Generator[dict, None, None]:
        """Yields {'tts_speech': np.ndarray [1, n], 'speech_tokens': ...}:
        offline one dict, streamed one per window and the finalize.
        `rng_seed` seeds the LM's sampling (default SEED); `speed` != 1 is
        offline only."""
        if stream and speed != 1.0:
            raise ValueError("speed change only supports non-stream mode")
        for name, arr, vocab in (
            ("llm_prompt_speech_token", llm_prompt_speech_token, self.lm.cfg.speech_token_size),
            ("flow_prompt_speech_token", flow_prompt_speech_token, self.flow.cfg.vocab_size),
            ("source_speech_token", source_speech_token, self.flow.cfg.vocab_size),
        ):
            if arr is not None and np.asarray(arr).size and int(np.max(arr)) >= vocab:
                raise ValueError(
                    f"{name} has id {int(np.max(arr))} >= codec vocab {vocab}: the model config "
                    "does not match the speech tokenizer that produced these tokens"
                )
        t0 = time.perf_counter()
        if source_speech_token is None:
            text = np.concatenate([prompt_text_tokens, text_tokens]).astype(np.int64)
            emb = llm_embedding if llm_embedding is not None else flow_embedding
            blocks = self.lm.generate(text, np.asarray(emb, np.float32).reshape(1, -1),
                                      np.asarray(llm_prompt_speech_token, np.int64), self._generator(rng_seed),
                                      int(len(text_tokens) * 2), int(len(text_tokens) * 20))
        else:
            blocks = iter([np.asarray(source_speech_token, np.int32)])
        prompt_token = np.asarray(flow_prompt_speech_token, np.int32)
        state = V1SessionState()
        self._local.log = state.log
        if stream:
            yield from self._stream(state, blocks, t0, prompt_token, prompt_speech_feat, flow_embedding)
            return
        tokens = np.concatenate([np.zeros(0, np.int32)] + [np.asarray(b, np.int32) for b in blocks])
        self.timer.add("lm", time.perf_counter() - t0)
        t1 = time.perf_counter()
        wav = self.token2wav(state, tokens, prompt_token, prompt_speech_feat, flow_embedding, finalize=True,
                             speed=speed)
        self.timer.add("t2w", time.perf_counter() - t1)
        yield {"tts_speech": wav, "speech_tokens": tokens}

    def _stream(self, state, blocks, t_req, prompt_token, prompt_feat, embedding):
        """The JAX engine's streaming loop: windows of hop + overlap tokens,
        the hop doubling from token_min_hop_len to token_max_hop_len, then
        the finalize over the rest."""
        pending: list = []
        hop, ov = self.token_min_hop_len, self.token_overlap_len
        gen_done = first_emitted = False
        lm = _Prefetcher(blocks, stream=self._lm_stream)
        try:
            while True:
                while not gen_done and len(pending) < hop + ov:
                    try:
                        pending.extend(next(lm).tolist())
                    except StopIteration:
                        gen_done = True
                if len(pending) >= hop + ov:
                    window = np.asarray(pending[: hop + ov], np.int32)
                    wav = self.token2wav(state, window, prompt_token, prompt_feat, embedding)
                    pending = pending[hop:]
                    hop = min(self.token_max_hop_len, int(hop * self.stream_scale_factor))
                    if not first_emitted and wav.size:
                        self.timer.add("first_chunk", time.perf_counter() - t_req)
                        first_emitted = True
                    yield {"tts_speech": wav, "speech_tokens": window[: len(window) - ov]}
                if gen_done and len(pending) < hop + ov:
                    break
            self.timer.add("lm", lm.busy_s)
            wav = self.token2wav(state, np.asarray(pending, np.int32), prompt_token, prompt_feat, embedding,
                                 finalize=True)
            if not first_emitted and wav.size:
                self.timer.add("first_chunk", time.perf_counter() - t_req)
            yield {"tts_speech": wav, "speech_tokens": np.asarray(pending, np.int32)}
        finally:
            lm.close()


def random_lm(seed: int = 0, device="cuda", lm_cfg: LMConfig = LMConfig(), tree=None):
    """A Qwen2LM with random weights made on `device` from `seed`, or the
    weights of `tree` (the fp LM's JAX param tree, e.g. a checkpoint's), and
    the host seconds its quantisation took (None unquantised). With
    `lm_cfg.qwen.quant` set, the fp weights (`tree`, or made as for the
    unquantised LM) are quantised on the host by `quantize_lm_params`, as
    the JAX API quantises a checkpoint, and loaded."""
    dev = resolve_device(device)
    lm = Qwen2LM(lm_cfg, device=dev)
    if not lm_cfg.qwen.quant:
        if tree is None:
            init_random_(lm.module, seed)
        else:
            load_jax_params(lm.module, tree)
        return lm, None
    t0 = time.perf_counter()
    if tree is None:
        fp_qwen = dataclasses.replace(lm_cfg.qwen, quant=False, kv_quant=False)
        with torch.device(dev):
            fp = init_random_(Qwen2LMModule(dataclasses.replace(lm_cfg, qwen=fp_qwen)), seed)
        t0 = time.perf_counter()
        tree = export_params(fp)
        del fp
    load_jax_params(lm.module, quantize_lm_params(tree, lm_cfg.qwen.quant))
    return lm, time.perf_counter() - t0


def build_random_engine(
    seed: int = 0,
    device="cuda",
    lm_cfg: LMConfig = LMConfig(),
    flow_cfg: FlowConfig = FlowConfig(),
    hift_cfg: HiFTConfig = HiFTConfig(),
    hop_policy: str = "doubling",
    trees: Optional[dict] = None,
    engine_cls=CosyVoice2Engine,
) -> CosyVoice2Engine:
    """An engine with random weights made on `device` from `seed` (default
    configs: full-width CosyVoice2-0.5B), its LM from `random_lm`; a module
    named in `trees` ("lm", "flow", "hift": JAX param trees, e.g. read from
    checkpoints) takes that tree's weights instead (the LM's fp tree is
    quantised as random_lm says). The engine's timer records the host time
    of a quantisation as stage "quantize"."""
    trees = trees or {}
    lm, quantize_s = random_lm(seed, device, lm_cfg, trees.get("lm"))
    flow = CausalFlow(flow_cfg, device=lm.device)
    hift = HiFTGenerator(hift_cfg, device=lm.device)
    for module, name, offset in ((flow, "flow", 1), (hift, "hift", 2)):
        if name in trees:
            load_jax_params(module, trees[name])
        else:
            init_random_(module, seed + offset)
    engine = engine_cls(lm, flow, hift, hop_policy=hop_policy)
    if quantize_s is not None:
        engine.timer.add("quantize", quantize_s)
    return engine


def build_random_engine_v3(seed: int = 0, device="cuda", lm_cfg: Optional[LMConfig] = None,
                           flow_cfg: Optional[FlowConfig] = None, hift_cfg: Optional[HiFTConfig] = None,
                           hop_policy: str = "doubling", trees: Optional[dict] = None) -> CosyVoice3Engine:
    """build_random_engine for CosyVoice3: a CosyVoice3Engine, by default at
    full width (`cosyvoice3_configs`), random from `seed` where `trees`
    names no checkpoint."""
    lm0, flow0, hift0 = cosyvoice3_configs()
    return build_random_engine(seed, device, lm_cfg or lm0, flow_cfg or flow0, hift_cfg or hift0, hop_policy, trees,
                               engine_cls=CosyVoice3Engine)


def build_random_engine_v1(seed: int = 0, device="cuda", lm_cfg: Optional[LMv1Config] = None,
                           flow_cfg: Optional[FlowV1Config] = None, hift_cfg: Optional[HiFTConfig] = None,
                           trees: Optional[dict] = None) -> CosyVoiceV1Engine:
    """A CosyVoiceV1Engine with random weights made on `device` from `seed`
    (LM seed, flow seed + 1, HiFT seed + 2), by default at the full width
    of CosyVoice-300M (LMv1Config, FlowV1Config, the 22.05 kHz HiFT); a
    module named in `trees` ("lm", "flow", "hift": JAX param trees) takes
    that tree's weights instead."""
    trees = trees or {}
    dev = resolve_device(device)
    lm = TransformerLM(lm_cfg or LMv1Config(), device=dev)
    flow = MaskedDiffFlow(flow_cfg or FlowV1Config(), device=dev)
    hift = HiFTGenerator(hift_cfg or v1_hift_config(), device=dev)
    for module, name, offset in ((lm.module, "lm", 0), (flow, "flow", 1), (hift, "hift", 2)):
        if name in trees:
            load_jax_params(module, trees[name])
        else:
            init_random_(module, seed + offset)
    return CosyVoiceV1Engine(lm, flow, hift)
