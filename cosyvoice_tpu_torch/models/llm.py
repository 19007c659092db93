"""CosyVoice2 / CosyVoice3 speech-token LM (Qwen2LM) in PyTorch.

Counterpart of cosyvoice_tpu/models/llm.py. The LM consumes the mixed
sequence [sos][text tokens][task_id][prompt speech tokens] and emits speech
tokens with RAS sampling. Decoding runs in blocks of `block_size` tokens: the
per-step loop (24-layer decode step, head, log-softmax, sampling, stop
bookkeeping) stays on the device, and the host fetches the tokens once per
block, as the JAX version does with one lax.scan per block. On the card each
step is a replayed CUDA graph, one per (route, arena bucket, stop mask),
over static state and static per-bucket KV arenas (models/decode_graph.py,
`Qwen2LM(graphs=...)`): the counterpart of the JAX LM's one compiled
program per block. The prompt prefill and the bistream extends run eagerly.

Ported: the v2 layout (sos/task in `llm_embedding`, a head with bias) and
the v3 layout (`special_in_speech_table`: no `llm_embedding`, sos / task /
fill are rows 6561, 6563 and 6564 of `speech_embedding`, 200 stop rows, a
bias-less head, fp or int8), `generate` with the min_len suppression (v2:
eos alone; v3: the whole special range, as the JAX LM does), max_len and
stop ids, the arena growth of the JAX
LM (it starts at `arena_bucket(pad_T + block_size + 1)` rows and grows in
ARENA_BUCKET steps before each block, into the LM's StaticArenas),
`generate_first` / `generate_continue` (the CosyVoice2 engine's
speculative first chunk: the prefill and the chunk's first blocks with no
host read, the arena and host mirror of the JAX engine's first-chunk
program, then generate's block loop on from the same generator),
`generate_bistream` (bi-streaming text input: exact-shape `extend_mixed`
feeds of 5 text and up to 15 prompt speech tokens, fill-token handoffs,
decode spans to the next fill, with a capacity guard at max_cache_len that
the JAX version lacks), and the three
LM configurations of `Qwen2Config`: bf16 weights and arena; `quant="int4p"`
(int4p body, int8 head) with a bf16 arena, whose B=1 decode step runs the
whole-step kernel K7 (`decode_step_fused`) while the arena holds at most
ops/int4_block.MAX_FUSED_ARENA rows, and the per-layer kernels past that;
and `kv_quant=True` (int8 arena), with int4p or bf16 weights; the
sampling config's temperature and repetition penalty (the presence set
seeded from the prompt's speech tokens, models/decode_graph.py).
Continuous batching decodes concurrent requests over B-slot arenas through
runtime/batch_scheduler.py:LMBatchScheduler, which shares this LM's weights
and, once attached, takes turns with its B=1 requests (`device_turn`). The
int8 and int4 weight modes (`Qwen2Config(quant=True | "int8" | "int4")`,
the head int8) decode through the bf16 LM's per-layer step, K2 and K1, or
K2 and K3 over the int8 arena, on the same graphs and in the scheduler.
CosyVoice-300M's LM is models/llm_v1.py.
"""

import contextlib
import logging
import threading
import weakref
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
from torch import nn

from cosyvoice_tpu_torch.models.decode_graph import DecodeGraphs
from cosyvoice_tpu_torch.models.qwen2 import QuantDense, Qwen2Config, Qwen2Model, StaticArenas
from cosyvoice_tpu_torch.ops import int4_block
from cosyvoice_tpu_torch.ops.decode_attention import kv_arena_write_kv
from cosyvoice_tpu_torch.ops.int4_block import int4_decode_layers, stack_decode_params
from cosyvoice_tpu_torch.ops.sampling import NEG_INF, apply_repetition_penalty, ras_sampling_batch
from cosyvoice_tpu_torch.utils.devices import resolve_device

TYPE_TEXT = 0
TYPE_SPEECH = 1
TYPE_SPECIAL = 2  # llm_embedding rows 0 = sos, 1 = task_id (v3: speech_embedding rows sos_id, task_id)


@dataclass(frozen=True)
class LMConfig:
    speech_token_size: int = 6561
    num_special_head: int = 3  # eos / unused / fill  (v3: 200)
    mix_ratio: Tuple[int, int] = (5, 15)  # bistream: text tokens, then speech tokens per segment
    top_p: float = 0.8
    top_k: int = 25
    win_size: int = 10
    tau_r: float = 0.1
    # the reference's Triton consumer decodes with temperature 0.8 and
    # repetition_penalty 1.1 (CosyVoice2.set_sampling); 1.0 is no-op: the
    # step then has neither op and no presence set
    temperature: float = 1.0
    repetition_penalty: float = 1.0
    block_size: int = 28  # tokens decoded per host fetch (= chunk 25 + lookahead 3)
    qwen: Qwen2Config = field(default_factory=Qwen2Config)
    # v3 layout: sos / eos / task / fill live inside the speech table
    special_in_speech_table: bool = False

    @property
    def head_size(self) -> int:
        return self.speech_token_size + self.num_special_head

    @property
    def eos_token(self) -> int:
        return self.speech_token_size

    @property
    def fill_token(self) -> int:
        return self.speech_token_size + (3 if self.special_in_speech_table else 2)

    @property
    def sos_id(self) -> int:
        return self.speech_token_size if self.special_in_speech_table else 0

    @property
    def task_id(self) -> int:
        return self.speech_token_size + 2 if self.special_in_speech_table else 1


class Qwen2LMModule(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.qwen.hidden_size
        self.llm = Qwen2Model(cfg.qwen)
        if not cfg.special_in_speech_table:
            self.llm_embedding = nn.Embedding(2, dim)
        self.speech_embedding = nn.Embedding(cfg.head_size, dim)
        bias = not cfg.special_in_speech_table  # the v3 head has no bias
        if cfg.qwen.quant:
            # the head is int8 weight-only in every quantised mode, as in the JAX package
            self.llm_decoder = QuantDense(dim, cfg.head_size, cfg.qwen.dtype, bias=bias)
        else:
            self.llm_decoder = nn.Linear(dim, cfg.head_size, bias=bias)

    def embed_input(self, ids, types):
        """ids/types [B, T] -> [B, T, C] float32."""
        safe = ids.clamp_min(0)
        zero = torch.zeros_like(safe)
        text = self.llm.embed_tokens(torch.where(types == TYPE_TEXT, safe, zero)).float()
        last = self.cfg.head_size - 1
        speech = self.speech_embedding(torch.where(types == TYPE_SPEECH, safe.clamp_max(last), zero))
        if self.cfg.special_in_speech_table:
            special = self.speech_embedding(torch.where(types == TYPE_SPECIAL, safe.clamp_max(last), zero))
        else:
            special = self.llm_embedding(torch.where(types == TYPE_SPECIAL, safe.clamp_max(1), zero))
        return torch.where(
            (types == TYPE_TEXT)[..., None], text, torch.where((types == TYPE_SPEECH)[..., None], speech, special)
        )

    def forward_logits(self, ids, types, lengths, dtype=None):
        """The teacher-forced forward of training: ids/types [B, T], lengths
        [B] (each >= 1) -> float32 logits [B, T, head]. The Qwen2 products
        compute in `dtype` (default cfg.qwen.dtype; Qwen2Model.forward), the
        embeddings and the head in float32, as in the JAX module."""
        valid = torch.arange(ids.shape[1], device=ids.device)[None, :] < lengths[:, None]
        return self._head(self.llm(self.embed_input(ids, types), valid, dtype))

    def _head(self, hidden):
        if self.cfg.qwen.quant:
            return self.llm_decoder(hidden).float()
        return self.llm_decoder(hidden.float())

    def prefill(self, ids, types, true_len, cache):
        hidden_last, cache = self.llm.prefill(self.embed_input(ids, types), true_len, cache)
        return self._head(hidden_last), cache

    def extend_mixed(self, ids, types, start: int, cache):
        """Append an exact-shape mixed segment (bistream feeds) at arena rows
        [start, start+S). ids/types [B, S]. Returns (logits of the last
        position [B, head] f32, cache)."""
        hidden_last, cache = self.llm.extend(self.embed_input(ids, types), start, cache)
        return self._head(hidden_last), cache

    def decode_step(self, token, cur_len, cache):
        """token [B] previous speech token -> (logits [B, head] f32, cache)."""
        emb = self.speech_embedding(token.long().clamp_max(self.cfg.head_size - 1))[:, None, :]
        hidden, cache = self.llm.decode_step(emb, cur_len, cache)
        return self._head(hidden), cache

    def decode_step_fused(self, token, cur_len, cache, stacked):
        """The B=1 int4p decode step over a bf16 arena through K7: every layer
        in one launch, then the new K and V rows of all layers committed with
        one K2 launch over the [L, T, Hkv, d] views of the arenas (one pos
        for every layer).
        token [1]; cur_len [1] int32 write position; `stacked` from
        stack_decode_params. Returns (logits [1, head] f32, cache)."""
        q = self.cfg.qwen
        emb = self.speech_embedding(token.long().clamp_max(self.cfg.head_size - 1))  # [1, C]
        pos = cur_len.long()
        k_all, v_all = cache
        L, _, A, Hkv, d = k_all.shape
        xo, k_new, v_new = int4_decode_layers(
            emb.to(q.dtype), self.llm.rope_cos[pos], self.llm.rope_sin[pos], cur_len,
            k_all.view(L, A, Hkv * d), v_all.view(L, A, Hkv * d), **stacked, eps=q.rms_norm_eps, out_dtype=q.dtype,
        )
        kv_arena_write_kv(k_all.view(L, A, Hkv, d), v_all.view(L, A, Hkv, d), k_new.view(L, 1, Hkv, d),
                          v_new.view(L, 1, Hkv, d), cur_len)
        return self._head(self.llm.norm(xo)), cache


@dataclass
class _Request:
    """A B=1 request's decode state between blocks: its arena, the
    decoder's carried buffers, the host mirror of the write position, the
    padded prompt length and max_len after the capacity clamp."""

    cache: tuple
    logits: torch.Tensor
    cur: torch.Tensor
    recent: torch.Tensor
    n_dec: torch.Tensor
    min_l: torch.Tensor
    fin: torch.Tensor
    cur_host: int
    pad_T: int
    max_len: int


class FirstBlocks:
    """`Qwen2LM.generate_first`'s result: the first blocks' tokens on the
    device and the open request that `generate_continue` carries on.
    `close()` ends the request (idempotent)."""

    def __init__(self, lm: "Qwen2LM", tokens: torch.Tensor, request: _Request):
        self.lm, self.tokens, self.request = lm, tokens, request
        self.max_len = request.max_len
        self._open = True

    def close(self):
        if self._open:
            self._open = False
            self.lm._request.release()


class Qwen2LM:
    """Orchestrator: prefill + blockwise decode on `device`.

    graphs: None runs the decode steps on CUDA graphs on the card and
    eagerly on the CPU; False runs them eagerly on the card too (the
    reference the graphs are held against); True on the CPU raises. The
    `graphs` attribute is the same switch on a built LM.

    One B=1 request at a time: `generate` and `generate_bistream` decode
    over the LM's one set of static arenas and decoder state, so a second
    request started while another one's generator is still open raises
    RuntimeError (close or exhaust the first; runtime/api.py queues its
    requests instead). Concurrent requests share a
    runtime/batch_scheduler.py:LMBatchScheduler: it decodes its B slots
    over a decoder and arenas of its own, beside one B=1 request (e.g. a
    bistream one). While a scheduler is attached both take turns on the
    card (`device_turn`): the kernels' counters and scratch are shared."""

    ARENA_BUCKET = 512  # KV arena lengths are multiples of this

    def __init__(self, cfg: LMConfig = LMConfig(), device="cuda", graphs=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.module = Qwen2LMModule(cfg).eval()
        self.decode_steps = 0  # decode steps made by generate (one per token slot)
        self.fused_steps = 0  # those of them that went through decode_step_fused (K7)
        self.graph_captures = self.graph_replays = 0  # CUDA graphs captured / decode steps replayed from them
        self.graph_warmups = 0  # eager decode steps on the graph path: the first at each key, before its capture
        self.graph_capture_s = self.graph_replay_s = 0.0  # host seconds capturing graphs / enqueueing replays
        self._pack = None  # (key of the layer parameters, stacked K7 weights)
        self._request = threading.Lock()  # held while a request's generator is open
        self._turn = threading.Lock()  # device_turn
        self._schedulers = weakref.WeakSet()  # attached batch schedulers (device_turn)
        self.arenas = StaticArenas(self.module.llm)  # the decode's KV arenas, one per length bucket
        self.graphs = self.device.type == "cuda" if graphs is None else graphs
        self.decoder = DecodeGraphs(self)

    @property
    def graphs(self) -> bool:
        return self._graphs

    @graphs.setter
    def graphs(self, on: bool):
        if on and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}; pass graphs=None or False")
        self._graphs = bool(on)

    @contextlib.contextmanager
    def device_turn(self):
        """One turn of this LM's work on the card: a B=1 request's prefill,
        extend or decode block, or a batch scheduler's step. Turns never
        overlap. While a scheduler is attached, each turn on the card also
        ends once its work on the current stream has finished: the
        decoders' kernels share their ticket counters and scratch
        (ops/decode_attention.py:_counters), which two streams in flight at
        once would race on. With none, a B=1 request's turns queue on its
        stream unsynchronised."""
        with self._turn:
            yield
            if self._schedulers and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()

    def attach_scheduler(self, scheduler):
        """From now on every turn ends in a stream sync (`device_turn`); the
        card first finishes what earlier turns left queued."""
        with self._turn:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._schedulers.add(scheduler)

    def detach_scheduler(self, scheduler):
        with self._turn:
            self._schedulers.discard(scheduler)

    @property
    def _busy(self) -> bool:
        """A request's generator is open."""
        return self._request.locked()

    def _acquire_request(self):
        if not self._request.acquire(blocking=False):
            raise RuntimeError("Qwen2LM decodes one request at a time: another generate / generate_bistream "
                               "generator (or generate_first's request) is still open (exhaust or close it first)")

    @contextlib.contextmanager
    def _one_request(self):
        self._acquire_request()
        try:
            yield
        finally:
            self._request.release()

    def pad_prompt(self, T: int) -> int:
        """The prompt length padded to the JAX LM's prompt bucket."""
        bucket = min(128, max(self.cfg.qwen.max_cache_len // 4, 8))
        return ((T + bucket - 1) // bucket) * bucket

    def capacity(self, pad_T: int, block_size: int) -> int:
        """Tokens of whole blocks that fit in max_cache_len after a prompt
        padded to pad_T rows."""
        return ((self.cfg.qwen.max_cache_len - pad_T - 1) // block_size) * block_size

    def clamp_to_arena(self, min_len: int, max_len: int, pad_T: int, block_size: int):
        """(min_len, max_len) with max_len cut to the whole blocks that fit
        in max_cache_len after a prompt padded to pad_T rows, with a
        warning; min_len at most max_len."""
        c = self.cfg
        capacity = self.capacity(pad_T, block_size)
        if max_len > capacity:
            logging.warning(
                "max_len %d exceeds KV arena capacity (max_cache_len=%d, prompt pad %d); clamping to %d",
                max_len, c.qwen.max_cache_len, pad_T, capacity,
            )
            max_len = max(capacity, 0)
            min_len = min(min_len, max_len)
        return min_len, max_len

    def init_cache(self, batch: int = 1, length: int = None):
        return self.module.llm.init_cache(batch, length)

    def arena_bucket(self, need: int) -> int:
        """Smallest arena length covering `need` positions: a multiple of
        ARENA_BUCKET, at most max_cache_len (the JAX LM's rule)."""
        b = self.ARENA_BUCKET
        return min(-(-need // b) * b, self.cfg.qwen.max_cache_len)

    def grow_cache(self, cache, new_len: int):
        """`cache` grown to new_len rows in the static arena of that length
        (models/qwen2.py:grow_cache's values); `cache` if long enough."""
        return self.arenas.grow(cache, new_len)

    def _decode_pack(self, cache):
        """The stacked weights for decode_step_fused (K7), or None where the
        step takes the per-layer kernels: the JAX LM's gate (int4p, a bf16
        arena, B=1, an arena of at most MAX_FUSED_ARENA rows, qkv width and
        Hkv*d multiples of 128), decided per block from the arena's length.
        The stack (~206 MB at full width) is built once and rebuilt when any
        layer parameter has changed since (a load bumps their versions)."""
        q = self.cfg.qwen
        lanes = q.num_kv_heads * q.head_dim
        if (
            q.quant != "int4p" or q.kv_quant or cache[0].shape[1] != 1
            or cache[0].shape[2] > int4_block.MAX_FUSED_ARENA
            or (q.num_heads * q.head_dim + 2 * lanes) % 128 or lanes % 128
        ):
            return None
        layers = self.module.llm.layers
        key = tuple((p.data_ptr(), p._version) for p in layers.parameters())
        if self._pack is None or self._pack[0] != key:
            self._pack = (key, stack_decode_params(layers))
            self.decoder.drop_fused()  # K7's graphs read the old stack
        return self._pack[1]

    def _sample(self, generator, logits, n_dec, recent, min_len, bistream=False, seen=None):
        """The next token of every row from `logits`: divided by the
        temperature, the repetition penalty over the presence set `seen`
        ([B, head_size] bool, None with no penalty), log-softmax, the stop
        mask, RAS (the JAX LM's `sample`)."""
        c = self.cfg
        logits = logits.float()
        if c.temperature != 1.0:
            logits = logits / c.temperature
        if seen is not None and c.repetition_penalty != 1.0:
            logits = apply_repetition_penalty(logits, seen, c.repetition_penalty)
        logp = torch.log_softmax(logits, dim=-1)
        if bistream:
            # bistream spans: the fill token is the one legal stop, every
            # other stop id is suppressed
            logp[:, c.speech_token_size :] = torch.where(
                torch.arange(c.speech_token_size, c.head_size, device=logp.device) == c.fill_token,
                logp[:, c.speech_token_size :], NEG_INF,
            )
        elif c.special_in_speech_table:
            # v3: the whole special range is suppressed before min_len (the
            # JAX LM's departure from the reference, whose mask hits the sos
            # row of the v3 table)
            suppress = (n_dec < min_len)[:, None]
            logp[:, c.speech_token_size :] = torch.where(suppress, NEG_INF, logp[:, c.speech_token_size :])
        else:
            # v2 semantics: only eos is suppressed before min_len; the other
            # stop ids stay samplable and end generation
            suppress = n_dec < min_len
            logp[:, c.eos_token] = torch.where(
                suppress, torch.full_like(n_dec, NEG_INF, dtype=logp.dtype), logp[:, c.eos_token]
            )
        return ras_sampling_batch(
            logp, recent, n_dec.clamp_max(c.win_size), generator,
            top_p=c.top_p, top_k=c.top_k, win_size=c.win_size, tau_r=c.tau_r,
        )

    def _decode_block(self, generator, cache, cur, logits, recent, n_dec, min_len, fin, stacked, steps,
                      bistream=False):
        """Decode `steps` token slots on the device (models/decode_graph.py:
        `step` per slot, eager or replayed from a CUDA graph), through
        decode_step_fused when `stacked` is given; `bistream` applies the
        bistream stop mask. Rows that stopped keep emitting eos and stop
        advancing. Returns (tokens [B, steps], logits, cur, recent, n_dec,
        fin), the last five the decoder's static buffers."""
        s = self.decoder.state
        s.load(logits, cur, recent, n_dec, min_len, fin)
        tokens = self.decoder.run(generator, cache, stacked, steps, bistream)
        return tokens, s.logits, s.cur, s.recent, s.n_dec, s.fin

    def generate(self, prompt_ids, prompt_types, generator, min_len: int, max_len: int):
        """Host generator: yields speech-token blocks (np.ndarray int32) until
        a stop token or max_len. prompt_ids/types: [T] mixed sequence. One
        request at a time (see the class docstring)."""
        with self._one_request():
            yield from self._generate(prompt_ids, prompt_types, generator, min_len, max_len)

    @torch.inference_mode()
    def _generate(self, prompt_ids, prompt_types, generator, min_len, max_len):
        rq = self._prefill_request(prompt_ids, prompt_types, min_len, max_len, 1)
        yield from self._host_blocks(generator, rq, 0)

    def generate_first(self, prompt_ids, prompt_types, generator, min_len: int, max_len: int, n1: int):
        """The LM half of the engine's speculative first chunk (the JAX
        engine's `_first_chunk_impl`): what `generate` does up to the end of
        block n1, with no host read between the blocks. The first arena
        holds the n1 blocks (`arena_bucket(pad_T + n1 * block_size + 1)`, the
        JAX engine's arena). Returns a `FirstBlocks` whose `tokens` [1, n1 *
        block_size] int32 stay on the device (eos after a stop id). The
        request stays open until `generate_continue(first, generator)` ends
        or `first.close()`: no other request decodes in between."""
        self._acquire_request()
        try:
            with torch.inference_mode():
                rq = self._prefill_request(prompt_ids, prompt_types, min_len, max_len, n1)
                tokens = torch.cat([self._next_block(generator, rq) for _ in range(n1)], dim=1)
        except BaseException:
            self._request.release()
            raise
        # the continuation's host mirror of the write position starts past
        # the padded prompt, as the JAX engine's does (cur_host0 = pad_T +
        # n1 * block_size); the arena grows from it
        rq.cur_host = rq.pad_T + n1 * self.cfg.block_size
        return FirstBlocks(self, tokens, rq)

    def generate_continue(self, first: "FirstBlocks", generator):
        """`generate`'s block loop from where `generate_first` left it (the
        JAX LM's generate_continue), with the same generator: the blocks
        after the first n1, yielded as `generate` yields them, so that the
        first blocks' tokens followed by these are an uninterrupted
        `generate`'s. Assumes no stop id in the first blocks (the engine
        continues only then). Ends the request."""
        try:
            yield from self._host_blocks(generator, first.request, first.tokens.shape[1])
        finally:
            first.close()

    def _prefill_request(self, prompt_ids, prompt_types, min_len, max_len, n_blocks: int) -> "_Request":
        """The prompt prefilled into a first arena that holds n_blocks
        blocks past the padded prompt, and the decode state of its request.
        The JAX version pads the prompt to a bucket; the capacity guard and
        the first arena use the same padded length, so max_len clamps and
        the arena grows alike."""
        c = self.cfg
        dev = self.device
        T = len(prompt_ids)
        pad_T = self.pad_prompt(T)
        min_len, max_len = self.clamp_to_arena(min_len, max_len, pad_T, c.block_size)
        with self.device_turn():
            cache = self.arenas.first(1, self.arena_bucket(pad_T + n_blocks * c.block_size + 1))
            ids = torch.as_tensor(np.asarray(prompt_ids, np.int64)[None], device=dev)
            types = torch.as_tensor(np.asarray(prompt_types, np.int64)[None], device=dev)
            logits, cache = self.module.prefill(ids, types, torch.tensor([T], device=dev), cache)
            if c.repetition_penalty != 1.0:
                # the presence set starts with the prompt's speech tokens
                self.decoder.state.seed_seen(np.asarray(prompt_ids)[np.asarray(prompt_types) == TYPE_SPEECH])
            return _Request(
                cache=cache, logits=logits, cur=torch.tensor([T], dtype=torch.int32, device=dev),
                recent=torch.full((1, c.win_size), -1, dtype=torch.int32, device=dev),
                n_dec=torch.zeros((1,), dtype=torch.int32, device=dev),
                min_l=torch.tensor([min_len], dtype=torch.int32, device=dev),
                fin=torch.zeros((1,), dtype=torch.bool, device=dev),
                cur_host=T,  # host mirror of the worst-case write position
                pad_T=pad_T, max_len=max_len,
            )

    def _next_block(self, generator, rq: "_Request", fetch: bool = False):
        """One block of block_size slots on `rq` (the arena grown first):
        its tokens [1, block_size] int32 on the device, or with `fetch` [block_size] on the host
        (the one host sync per block)."""
        c = self.cfg
        with self.device_turn():
            rq.cache = self.grow_cache(rq.cache, self.arena_bucket(rq.cur_host + c.block_size + 1))
            tokens, rq.logits, rq.cur, rq.recent, rq.n_dec, rq.fin = self._decode_block(
                generator, rq.cache, rq.cur, rq.logits, rq.recent, rq.n_dec, rq.min_l, rq.fin,
                self._decode_pack(rq.cache), c.block_size,
            )
            if fetch:
                tokens = tokens[0].to(torch.int32).cpu().numpy()
        rq.cur_host += c.block_size
        return tokens

    @torch.inference_mode()
    def _host_blocks(self, generator, rq: "_Request", produced: int):
        """Blocks fetched to the host and yielded, cut at a stop id and at
        rq.max_len, `produced` tokens already made."""
        stop_seen = False
        while produced < rq.max_len and not stop_seen:
            toks = self._next_block(generator, rq, fetch=True)
            stop_idx = np.nonzero(toks >= self.cfg.speech_token_size)[0]
            if len(stop_idx):
                toks = toks[: stop_idx[0]]
                stop_seen = True
            toks = toks[: rq.max_len - produced]
            produced += len(toks)
            if len(toks):
                yield toks

    def generate_bistream(self, text_stream, prompt_text, prompt_speech, generator, max_len: int = 4096):
        """Bi-streaming decode: text arrives as an iterator of id chunks;
        5-text / 15-speech segments interleave with fill-token handoffs;
        once the text is exhausted, [remaining text][task] is fed and decoding
        runs to a stop id. Yields np.int32 speech-token arrays (the JAX
        `generate_bistream`, step for step).

        Segments are appended by exact-shape `extend_mixed` calls; speech
        decodes in spans that end at the next fill, sampled or forced by the
        cadence. A sampled fill is recorded but never fed: the next segment
        overwrites its arena row. The arena starts at ARENA_BUCKET rows and
        grows before every feed and span; the route of each span (K7 or the
        per-layer kernels) follows from the arena's length, as in `generate`.

        Unlike the JAX version, a feed or a span that would write past
        max_cache_len is not made: a span is cut to the rows that fit, a
        warning is logged and the stream ends there. One request at a time
        (see the class docstring)."""
        with self._one_request():
            yield from self._generate_bistream(text_stream, prompt_text, prompt_speech, generator, max_len)

    @torch.inference_mode()
    def _generate_bistream(self, text_stream, prompt_text, prompt_speech, generator, max_len):
        c = self.cfg
        dev = self.device
        mt, ms = c.mix_ratio
        cap = c.qwen.max_cache_len

        with self.device_turn():
            cache = self.arenas.first(1, self.ARENA_BUCKET)
            if c.repetition_penalty != 1.0:
                self.decoder.state.seed_seen(np.asarray(prompt_speech, np.int64))
            recent = torch.full((1, c.win_size), -1, dtype=torch.int32, device=dev)
            n_dec = torch.zeros((1,), dtype=torch.int32, device=dev)
            no_min = torch.zeros((1,), dtype=torch.int32, device=dev)
            not_fin = torch.zeros((1,), dtype=torch.bool, device=dev)
        cur_host = 0  # the arena's write position, as the host knows it
        logits = None
        out_count = 0  # decoded tokens, fills included
        produced = 0  # yielded speech tokens
        # forced-fill cadence: the out index at which a fill is due
        next_fill = (len(prompt_speech) // ms + 1) * ms - len(prompt_speech)
        full = False  # the arena reached max_cache_len: the stream ends

        def room(rows, what):
            """Rows of `rows` that fit below max_cache_len; warns if fewer."""
            nonlocal full
            fit = min(rows, cap - cur_host)
            if fit < rows:
                logging.warning("bistream %s of %d rows at position %d passes the KV arena's end "
                                "(max_cache_len=%d); ending the stream", what, rows, cur_host, cap)
                full = True
            return fit

        def feed(ids, types):
            nonlocal cache, cur_host, logits
            S = len(ids)
            if full or room(S, "feed") < S:
                return
            with self.device_turn():
                cache = self.grow_cache(cache, self.arena_bucket(cur_host + S + 1))
                logits, cache = self.module.extend_mixed(
                    torch.as_tensor(np.asarray(ids, np.int64)[None], device=dev),
                    torch.as_tensor(np.asarray(types, np.int64)[None], device=dev), cur_host, cache,
                )
            cur_host += S

        def decode(steps, bistream):
            """One span or final block of `steps` slots, cut to the rows that
            fit; the tokens as np.int32 (after a stop id, eos)."""
            nonlocal cache, logits, recent, n_dec
            n = room(steps, "decode span" if bistream else "final decode block")
            if n <= 0:
                return np.zeros(0, np.int32)
            with self.device_turn():
                cache = self.grow_cache(cache, self.arena_bucket(cur_host + steps + 1))
                cur = torch.tensor([cur_host], dtype=torch.int32, device=dev)
                tokens, logits, _, recent, n_dec, _ = self._decode_block(
                    generator, cache, cur, logits, recent, n_dec, no_min, not_fin, self._decode_pack(cache), n,
                    bistream,
                )
                return tokens[0].to(torch.int32).cpu().numpy()

        def decode_span():
            """Decode until the next fill (sampled or forced); yields arrays
            and returns with the fill counted in out_count."""
            nonlocal cur_host, out_count, produced, next_fill
            while not full:
                steps = max(1, next_fill - out_count)
                toks = decode(steps, True)
                stop = np.nonzero(toks >= c.speech_token_size)[0]
                if len(stop):
                    # the sampled fill is never fed: the next segment lands
                    # on its row, right after the last real token
                    emit = toks[: stop[0]]
                    cur_host += int(stop[0])
                    out_count += len(emit)
                    produced += len(emit)
                    if len(emit):
                        yield emit
                    next_fill = out_count + ms + 1
                    out_count += 1  # the sampled fill
                    return
                cur_host += len(toks)
                out_count += len(toks)
                produced += len(toks)
                if len(toks):
                    yield toks
                if out_count >= next_fill:
                    # cadence-forced fill
                    next_fill = out_count + ms + 1
                    out_count += 1
                    return

        feed([c.sos_id], [TYPE_SPECIAL])
        text_cache = [int(t) for t in prompt_text]
        speech_q = [int(t) for t in prompt_speech]
        for this_text in text_stream:
            text_cache.extend(int(t) for t in this_text)
            # interleave the remaining prompt speech
            while speech_q and len(text_cache) >= mt:
                feed(text_cache[:mt], [TYPE_TEXT] * mt)
                n_sp = min(ms, len(speech_q))
                feed(speech_q[:n_sp], [TYPE_SPEECH] * n_sp)
                text_cache, speech_q = text_cache[mt:], speech_q[n_sp:]
            if full:
                return
            if speech_q:
                continue
            # a text segment, then speech up to the next fill
            while len(text_cache) >= mt:
                feed(text_cache[:mt], [TYPE_TEXT] * mt)
                text_cache = text_cache[mt:]
                yield from decode_span()
                if produced >= max_len or full:
                    return

        # final drain: [remaining text][task], then decode to a stop id
        feed(text_cache + [c.task_id], [TYPE_TEXT] * len(text_cache) + [TYPE_SPECIAL])
        stopped = False
        while produced < max_len and not stopped and not full:
            toks = decode(c.block_size, False)
            cur_host += len(toks)
            stop_idx = np.nonzero(toks >= c.speech_token_size)[0]
            if len(stop_idx):
                toks = toks[: stop_idx[0]]
                stopped = True
            toks = toks[: max_len - produced]
            produced += len(toks)
            if len(toks):
                yield toks
