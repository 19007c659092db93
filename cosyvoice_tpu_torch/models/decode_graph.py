"""The LM's decode step as a CUDA graph over static buffers.

Counterpart of the JAX LM's one compiled program per decode block
(cosyvoice_tpu/models/llm.py: `_jit_decode_block` over `_decode_block_impl`,
a `lax.scan` of the step; one program per span length in the bistream
spans).

- `DecodeState`: the state of B decode rows in buffers that never move:
  the logits the next token is sampled from, the write positions `cur`,
  the RAS windows `recent`, the decoded counts `n_dec`, `min_len`, the
  stop flags `fin`, the tokens of the current block with the device-side
  slot that the next token is written at, and, once a row has decoded with
  a repetition penalty, the presence sets `seen` ([B, head_size] bool: each
  row's prompt speech tokens and every token it sampled since, fills
  included). The LM's own decoder holds one row (`generate`,
  `generate_bistream`); runtime/batch_scheduler.py's holds `max_batch`.
- `step`: one token slot on that state: sample (temperature and penalty
  first where the LM's config sets them), stop bookkeeping, the presence
  set's update, the decode step (per layer, or K7's `decode_step_fused`),
  `cur` advance, the token at its slot. The eager path and the graphs run
  this same function, so the CPU tests exercise what the card captures. At
  the default sampling (temperature and penalty 1.0) the step has neither
  op nor the presence set.
- `DecodeGraphs`: runs a block of slots, eagerly (`Qwen2LM(graphs=False)`,
  and always on CPU) or by replaying one captured step per slot. One graph
  per key (`route`: "K7", "per-layer" (K2 and K1 or K3 in each layer) or
  "plain attention" (the indexed row write and the masked einsum, all
  device ops on the static arenas), which asks
  ops/decode_attention.decode_kernel_wanted as each layer does; batch
  rows; arena length;
  stop mask (`stop_mask`): the v2 min_len mask, the v3 one over the whole
  special range, or the bistream mask; the sampling
  config, whose values a graph bakes in, so that `set_sampling` never
  replays a graph of another config), captured lazily after one eager
  step at that key, so that the kernels are built, their plan tables are on
  the card and K7's tensor maps are encoded before capture. A graph of a
  whole 28-step block saved no time on the card: a one-step replay's host
  cost is 1-3 % of the step's device time (scripts/decode_graph_block.py,
  PERF.md §6). The graphs run over a `StaticArenas` (models/qwen2.py)
  whose buffers never move: the LM's, or the batch scheduler's own.
  A failed capture or replay raises; nothing falls back to eager. Replays
  run on the current stream, one at a time: the kernels' ticket and barrier
  counters (ops/decode_attention.py:_counters, never replaced once a graph
  is captured) and each graph's scratch are shared, so the LM's decoders
  take turns (`Qwen2LM.device_turn`).

Captures can happen mid-request while another thread works on the card: a
streaming `tts` decodes on a thread of its own while its own thread turns
tokens into wav, and a batch scheduler decodes on its thread while its
sessions' threads turn theirs into wav. A capture therefore holds
`capture_lock` (one per LM, shared by its decoders), which that work takes
too, and captures in "thread_local" mode, so that only the capturing
thread's own unsafe calls could invalidate it. A server's threads work on
the card's default stream at any time, which would invalidate a capture,
so with continuous batching both decoders capture every key up front
(`capture_ahead`, through LMBatchScheduler.capture_graphs) and serving
captures none.

Sampling: the graphs draw from one generator of their own, registered with
every graph (`CUDAGraph.register_generator_state`), so that each replay
advances its Philox offset as the eager step's draws advance it. The
request's generator state is handed in before the replays of a block and
back out after, so the caller's generator ends where the eager path leaves
it and the sampled tokens are the eager path's.

Counters: the kernel wrappers' `launches` and the LM's `decode_steps` and
`fused_steps` move while a step is captured, which launches nothing. Each
graph keeps the deltas of its capture, takes them back, and adds them once
per replay, so the counters count what ran (chip_smoke.py holds each
graph's deltas against its kernel nodes).
`Qwen2LM.graph_captures`, `graph_replays`, `graph_warmups`,
`graph_capture_s` and `graph_replay_s` count the graphs captured, the
decode steps replayed, the eager first steps at a key, and the host seconds
spent capturing and enqueueing replays.
"""

import gc
import threading
import time

import numpy as np
import torch

from cosyvoice_tpu_torch.ops import decode_attention
from cosyvoice_tpu_torch.ops.decode_attention import (
    decode_kernel_wanted,
    gqa_decode_attention,
    gqa_decode_attention_quant,
    kv_arena_write,
    kv_arena_write_kv,
)
from cosyvoice_tpu_torch.ops.int4_block import int4_decode_layers
from cosyvoice_tpu_torch.ops.int4_fused import int4_gemv, int4_mlp, int4_o_mlp

KERNEL_WRAPPERS = (gqa_decode_attention, gqa_decode_attention_quant, kv_arena_write, kv_arena_write_kv, int4_gemv,
                   int4_mlp, int4_o_mlp, int4_decode_layers)


class DecodeState:
    """Static buffers of `batch` decode rows on `device`; `tokens` holds the
    `capacity` slots of the longest block."""

    def __init__(self, cfg, device, capacity: int, batch: int = 1):
        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.logits = zeros(batch, cfg.head_size, dtype=torch.float32)
        self.cur, self.n_dec, self.min_len = zeros(batch), zeros(batch), zeros(batch)
        self.recent = zeros(batch, cfg.win_size)
        self.fin = zeros(batch, dtype=torch.bool)
        self.tokens = zeros(batch, capacity)
        self.slot = zeros(1, dtype=torch.int64)
        self.head_size = cfg.head_size
        self.seen = None  # made by the first seed_seen and kept: graphs read it

    def seed_seen(self, tokens, row: int = 0):
        """The presence set of row `row` with a repetition penalty: its
        prompt speech tokens below head_size (np int array)."""
        if self.seen is None:
            self.seen = torch.zeros((self.fin.shape[0], self.head_size), dtype=torch.bool, device=self.tokens.device)
        self.seen[row].zero_()
        ids = torch.as_tensor(tokens[tokens < self.head_size].astype(np.int64), device=self.seen.device)
        self.seen[row, ids] = True

    def load(self, logits, cur, recent, n_dec, min_len, fin):
        """Copy a block's inputs in (a copy of a buffer onto itself does
        nothing) and reset the slot."""
        for dst, src in ((self.logits, logits), (self.cur, cur), (self.recent, recent), (self.n_dec, n_dec),
                         (self.min_len, min_len), (self.fin, fin)):
            dst.copy_(src)
        self.slot.zero_()


def stop_mask(cfg, bistream: bool) -> str:
    """The stop mask a step applies: "bistream" (the fill token is the one
    legal stop), "v3 min_len" (the whole special range before min_len) or
    "v2 min_len" (eos alone before min_len)."""
    if bistream:
        return "bistream"
    return "v3 min_len" if cfg.special_in_speech_table else "v2 min_len"


def step(lm, s: DecodeState, cache, generator, stacked, bistream: bool):
    """One token slot on `s`, through decode_step_fused (K7) when `stacked`
    is given; `bistream` applies the bistream stop mask. A row that stopped
    keeps emitting eos and stops advancing."""
    c = lm.cfg
    penalty = c.repetition_penalty != 1.0
    tok = lm._sample(generator, s.logits, s.n_dec, s.recent, s.min_len, bistream, s.seen if penalty else None)
    stop_now = tok >= c.speech_token_size
    tok_out = torch.where(s.fin, torch.full_like(tok, c.eos_token), tok)
    s.recent.copy_(torch.where(s.fin[:, None], s.recent, torch.cat([s.recent[:, 1:], tok[:, None]], dim=1)))
    s.n_dec.copy_(torch.where(s.fin, s.n_dec, s.n_dec + 1))
    if penalty:
        # a row that has not stopped marks the token it sampled
        at = tok[:, None].long()
        s.seen.scatter_(1, at, s.seen.gather(1, at) | ~s.fin[:, None])
    if stacked is not None:
        logits, _ = lm.module.decode_step_fused(tok_out, s.cur, cache, stacked)
        lm.fused_steps += 1
    else:
        logits, _ = lm.module.decode_step(tok_out, s.cur, cache)
    lm.decode_steps += 1
    s.logits.copy_(logits)
    s.cur.add_((~s.fin).to(s.cur.dtype))
    s.fin.logical_or_(stop_now)
    s.tokens.index_copy_(1, s.slot, tok_out[:, None])
    s.slot.add_(1)


class DecodeGraphs:
    """Decode blocks of `batch` rows over `arenas`, eager or on CUDA graphs
    (see the module docstring). The LM's own decoder: one row, the LM's
    arenas, blocks of up to max(block_size, mix_ratio[1] + 1) slots (a
    bistream span). A batch scheduler's: `batch` rows, arenas of its own,
    its block size, the LM's capture_lock. Every decoder of an LM follows
    its `graphs` switch."""

    def __init__(self, lm, batch: int = 1, capacity: int = None, arenas=None, capture_lock=None):
        self.lm = lm
        self.batch = batch
        self.arenas = arenas if arenas is not None else lm.arenas
        self.state = DecodeState(lm.cfg, lm.device, capacity or max(lm.cfg.block_size, lm.cfg.mix_ratio[1] + 1),
                                 batch)
        self.graphs = {}  # key -> (CUDAGraph, [counter deltas])
        self.warm = set()  # keys with an eager step behind them
        self.generator = torch.Generator(device=lm.device) if lm.device.type == "cuda" else None
        # held while a graph is captured (see the module docstring)
        self.capture_lock = capture_lock if capture_lock is not None else threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.lm.graphs

    def counters(self):
        return [(fn, "launches") for fn in KERNEL_WRAPPERS] + [(self.lm, "decode_steps"), (self.lm, "fused_steps")]

    def drop_fused(self):
        """Forget the graphs of the K7 route (its weight stack was rebuilt);
        the next block at such a key captures anew."""
        for key in [k for k in self.graphs if k[0] == "K7"]:
            del self.graphs[key]
            self.warm.discard(key)

    def run(self, generator, cache, stacked, steps: int, bistream: bool):
        """`steps` token slots on `self.state` (loaded) over `cache`.
        Returns the tokens [batch, steps] int32."""
        s, lm = self.state, self.lm
        c = lm.cfg
        key = self._key(cache, stacked, bistream)
        if c.repetition_penalty != 1.0 and s.seen is None:
            raise ValueError("a repetition penalty needs the request's presence set (DecodeState.seed_seen)")
        if steps > s.tokens.shape[1]:
            raise ValueError(f"a block of {steps} slots is longer than the decoder's {s.tokens.shape[1]}")
        if cache[0].shape[1] != self.batch:
            raise ValueError(f"an arena of {cache[0].shape[1]} rows for a decoder of {self.batch}")
        if self.enabled and cache is not self.arenas.buffers.get((self.batch, key[2])):
            raise ValueError("graph decode runs over the decoder's static arenas (StaticArenas), not this cache")
        done = 0
        if not self.enabled or key not in self.warm:
            # eager: the reference path, and the first step at a key
            done = steps if not self.enabled else 1
            for _ in range(done):
                step(lm, s, cache, generator, stacked, bistream)
            if self.enabled:
                self.warm.add(key)
                lm.graph_warmups += 1
        if done < steps:
            graph, deltas = self.graphs.get(key) or self._capture(key, cache, stacked, bistream)
            self.generator.set_state(generator.get_state())
            t0 = time.perf_counter()
            for _ in range(steps - done):
                graph.replay()
            lm.graph_replay_s += time.perf_counter() - t0
            for (obj, attr), d in zip(self.counters(), deltas):
                setattr(obj, attr, getattr(obj, attr) + d * (steps - done))
            lm.graph_replays += steps - done
            generator.set_state(self.generator.get_state())
        return s.tokens[:, :steps].clone()

    def route(self, cache, stacked) -> str:
        """The decode step's route over `cache`: "K7" where `stacked` is
        given, else the layers' (decode_kernel_wanted at the arena's
        length): "per-layer" kernels or "plain attention"."""
        if stacked is not None:
            return "K7"
        q = self.lm.cfg.qwen
        return "per-layer" if decode_kernel_wanted(cache[0].shape[2], q.num_kv_heads * q.head_dim) else "plain attention"

    def _key(self, cache, stacked, bistream: bool):
        c = self.lm.cfg
        sampling = (c.top_p, c.top_k, c.win_size, c.tau_r, c.temperature, c.repetition_penalty)
        return (self.route(cache, stacked), self.batch, cache[0].shape[2], stop_mask(c, bistream), sampling)

    def capture_ahead(self, pack, bistream=(False,)):
        """Capture now, under the current sampling, the graph of every key
        this decoder can meet: each arena bucket up to max_cache_len, with
        `pack(cache)` as its `stacked` and each stop mask of `bistream`
        (one eager step, the capture and one replay each, from a throwaway
        generator). Later blocks then capture nothing while other threads
        work on the card. The rows and arenas hold nothing of use after it:
        a request loads its rows and zeroes its first arena. Nothing to do
        when the graphs are off."""
        if not self.enabled:
            return
        s, lm = self.state, self.lm
        c = lm.cfg
        gen = torch.Generator(device=lm.device).manual_seed(0)
        if c.repetition_penalty != 1.0 and s.seen is None:
            s.seed_seen(np.zeros(0, np.int64))
        b = lm.ARENA_BUCKET
        for length in sorted({lm.arena_bucket(n) for n in range(b, c.qwen.max_cache_len + b, b)}):
            cache = self.arenas.first(self.batch, length)
            stacked = pack(cache)
            for mask in bistream:
                if self._key(cache, stacked, mask) not in self.graphs:
                    for buf, v in ((s.logits, 0), (s.cur, 0), (s.recent, -1), (s.n_dec, 0), (s.min_len, 0),
                                   (s.fin, False), (s.slot, 0)):
                        buf.fill_(v)
                    self.run(gen, cache, stacked, 2, mask)

    def _capture(self, key, cache, stacked, bistream):
        """Capture one step at `key` (after its eager step); the counters
        keep the values they had before the capture."""
        lm = self.lm
        t0 = time.perf_counter()
        decode_attention.CAPTURED.add(lm.device)
        counters = self.counters()
        before = [getattr(obj, attr) for obj, attr in counters]
        # the captured nodes are kept (keep_graph, debug mode) so that
        # `debug_dump` can list them: chip_smoke.py holds each graph's
        # kernel nodes against its counter deltas
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.enable_debug_mode()
        graph.register_generator_state(self.generator)
        # no cycle collection while capturing: a graph it frees (an earlier
        # LM's, left in a reference cycle) would be destroyed mid-capture,
        # which CUDA forbids and which invalidates this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with self.capture_lock, torch.cuda.graph(graph, capture_error_mode="thread_local"):
                step(lm, self.state, cache, self.generator, stacked, bistream)
            graph.instantiate()
        finally:
            if collecting:
                gc.enable()
            after = [getattr(obj, attr) for obj, attr in counters]
            for (obj, attr), v in zip(counters, before):
                setattr(obj, attr, v)
        deltas = [a - b for a, b in zip(after, before)]
        self.graphs[key] = (graph, deltas)
        lm.graph_captures += 1
        lm.graph_capture_s += time.perf_counter() - t0
        return self.graphs[key]

