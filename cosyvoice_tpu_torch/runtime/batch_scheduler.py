"""Continuous batching for the speech-token LM.

Counterpart of cosyvoice_tpu/runtime/batch_scheduler.py. One decode loop
serves every request in flight: `max_batch` slots decode together, each
step one token for every slot through the LM's per-layer kernels at
B = max_batch (bf16: K1 + K2; int4p over an int8 arena: K4 + K3 + K2 + K6;
int4p over a bf16 arena: K4 + K1 + K2 + K6, never K7, whose route takes
B=1 only), on CUDA graphs keyed by the batch (models/decode_graph.py).

- A session joins by a B=1 prefill of its prompt into an arena of
  `arena_bucket(pad_T + 1)` rows (pad_T: the prompt length rounded up to
  PROMPT_BUCKET), which is copied into its slot of the B-slot arena, the
  int8 scale planes included (the JAX `_insert_cache_slot`).
- The B-slot arena starts at `arena_bucket(block_size + 1)` rows and grows
  to `arena_bucket(live max + block_size + 1)` before each block, into the
  scheduler's static arena of that bucket (its own `StaticArenas`: with a
  max_batch of 1 the LM's would be the B=1 requests' buffers).
- The tokens of a block reach the host once; stops are read from them.
  Rows that stopped keep emitting eos and stop advancing, as in
  `Qwen2LM.generate`; an empty slot is a stopped row.
- Sampling draws every row from one generator of the scheduler (seeded
  with the engine's SEED), so a session's random stream depends on its
  slot and on the other sessions: deterministic for a fixed submission
  order, as in the JAX scheduler (whose keys differ). Greedy streams do
  not depend on it.
- Unlike the JAX scheduler, a session's max_len is cut to the blocks that
  fit in max_cache_len after its padded prompt, with `Qwen2LM.generate`'s
  warning (ROADMAP C4): the JAX one clamps its writes at the arena's end
  silently. A session whose admission fails is failed too (the JAX loop
  loses it), and a consumer that closes its handle's iterator early frees
  its slot at the next block.

The scheduler attaches itself to the LM when it is made and detaches at
`stop()`; while attached, its steps and the LM's B=1 requests (e.g. a
bistream request beside the scheduler) take turns on the card
(`Qwen2LM.device_turn`). Drive it with `start()` / `stop()` (a thread; on
the card on a CUDA stream of its own) or synchronously with `step()`.
`capture_graphs()` captures up front every decode graph that it and the
LM's B=1 decoder can replay, so that serving captures none (a capture
while another thread works on the card's default stream would fail).
"""

import contextlib
import logging
import queue
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.models.decode_graph import DecodeGraphs
from cosyvoice_tpu_torch.models.llm import TYPE_SPEECH, Qwen2LM
from cosyvoice_tpu_torch.models.qwen2 import StaticArenas
from cosyvoice_tpu_torch.runtime.engine import SEED

PROMPT_BUCKET = 128  # prompts are prefilled padded to a multiple of this (the JAX scheduler's default)


@dataclass
class _Session:
    handle: "SessionHandle"
    min_len: int
    max_len: int
    produced: int = 0


class SessionHandle:
    """Iterator of np.int32 token blocks for one submitted prompt. Closing
    the iterator before its end cancels the session."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self.cancelled = False

    def __iter__(self):
        done = False
        try:
            while True:
                item = self._q.get()
                if item is None:
                    done = True
                    return
                if isinstance(item, BaseException):
                    done = True
                    raise RuntimeError("batch scheduler failed while serving this session") from item
                yield item
        finally:
            if not done:
                self.cancelled = True

    def _push(self, toks: np.ndarray):
        if len(toks):
            self._q.put(toks)

    def _close(self):
        self._q.put(None)

    def _fail(self, exc: BaseException):
        self._q.put(exc)


class LMBatchScheduler:
    """Continuous-batching decode loop over `max_batch` slots of `lm` (see
    the module docstring). submit() is thread-safe and returns a
    SessionHandle at once; each step admits pending prompts into free slots
    in submission order and decodes one block of `block_size` tokens for
    every slot."""

    def __init__(self, lm: Qwen2LM, max_batch: int = 4, block_size: Optional[int] = None):
        self.lm = lm
        self.B = max_batch
        self.block_size = block_size or lm.cfg.block_size
        self.arenas = StaticArenas(lm.module.llm)
        self.decoder = DecodeGraphs(lm, batch=max_batch, capacity=self.block_size, arenas=self.arenas,
                                    capture_lock=lm.decoder.capture_lock)
        self.generator = torch.Generator(device=lm.device).manual_seed(SEED)
        # the arena starts at one bucket and grows with the live maximum:
        # the attention reads only live rows, but the graphs are per bucket
        self.cache = self.arenas.first(max_batch, lm.arena_bucket(self.block_size + 1))
        self.decoder.state.fin.fill_(True)  # empty slots are stopped rows
        self._cur_host = np.zeros((max_batch,), np.int64)  # worst-case write positions
        self.slots: List[Optional[_Session]] = [None] * max_batch
        self.pending: "queue.Queue" = queue.Queue()
        self._parked = None  # the oldest pending item, held out of the queue (keeps FIFO)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = torch.cuda.Stream(lm.device) if lm.device.type == "cuda" else None
        lm.attach_scheduler(self)

    def capture_graphs(self):
        """Capture under the current sampling every graph that this
        scheduler's decoder (every arena bucket) and the LM's B=1 decoder
        (every bucket, route and stop mask) can replay (DecodeGraphs.
        capture_ahead), before any session is admitted and while no B=1
        request is open. Nothing to do when the LM's graphs are off."""
        lm = self.lm
        if self.n_active or self._parked is not None or not self.pending.empty() or lm._busy:
            raise RuntimeError("capture the decode graphs before the scheduler or the LM serves a request")
        with lm.device_turn():
            self.decoder.capture_ahead(lambda cache: None)
            lm.decoder.capture_ahead(lm._decode_pack, bistream=(False, True))
            self.cache = self.arenas.first(self.B, lm.arena_bucket(self.block_size + 1))
            self.decoder.state.fin.fill_(True)

    # ------------------------------------------------------------------
    def submit(self, prompt_ids: np.ndarray, prompt_types: np.ndarray, min_len: int, max_len: int) -> SessionHandle:
        h = SessionHandle()
        self.pending.put((np.asarray(prompt_ids, np.int32), np.asarray(prompt_types, np.int32),
                          _Session(h, int(min_len), int(max_len))))
        return h

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    # ------------------------------------------------------------------
    def _admit(self, b: int, prompt_ids, prompt_types, sess: _Session):
        lm, c = self.lm, self.lm.cfg
        dev = lm.device
        T = len(prompt_ids)
        pad_T = -(-T // PROMPT_BUCKET) * PROMPT_BUCKET
        sess.min_len, sess.max_len = lm.clamp_to_arena(sess.min_len, sess.max_len, pad_T, self.block_size)
        slot_cache = lm.init_cache(1, lm.arena_bucket(pad_T + 1))
        ids = torch.as_tensor(prompt_ids.astype(np.int64)[None], device=dev)
        types = torch.as_tensor(prompt_types.astype(np.int64)[None], device=dev)
        logits, slot_cache = lm.module.prefill(ids, types, torch.tensor([T], device=dev), slot_cache)
        n = slot_cache[0].shape[2]
        self.cache = self.arenas.grow(self.cache, n)
        for dst, src in zip(self.cache, slot_cache):  # the slot splice: K, V (and the int8 scale planes)
            dst[:, b : b + 1, :n].copy_(src)
        s = self.decoder.state
        s.logits[b] = logits[0]
        s.cur[b], s.n_dec[b], s.min_len[b] = T, 0, sess.min_len
        s.recent[b] = -1
        s.fin[b] = False
        if c.repetition_penalty != 1.0:
            s.seed_seen(prompt_ids[prompt_types == TYPE_SPEECH], row=b)
        self._cur_host[b] = T

    def _retire(self, b: int):
        sess = self.slots[b]
        if sess is not None:
            sess.handle._close()
        self.slots[b] = None
        self.decoder.state.fin[b] = True

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> bool:
        """Admit pending prompts into free slots, then decode one block for
        every slot. Returns True if any work was done."""
        lm, c = self.lm, self.lm.cfg
        with lm.device_turn():
            admitted = False
            for b in range(self.B):
                if self.slots[b] is not None:
                    continue
                if self._parked is not None:
                    item, self._parked = self._parked, None
                else:
                    try:
                        item = self.pending.get_nowait()
                    except queue.Empty:
                        break
                prompt_ids, prompt_types, sess = item
                self.slots[b] = sess  # from here a failure fails this session too
                self._admit(b, prompt_ids, prompt_types, sess)
                admitted = True
            if self.n_active == 0:
                return admitted

            live = max(self._cur_host[b] for b in range(self.B) if self.slots[b] is not None)
            self.cache = self.arenas.grow(self.cache, lm.arena_bucket(int(live) + self.block_size + 1))
            self.decoder.state.slot.zero_()
            tokens = self.decoder.run(self.generator, self.cache, None, self.block_size, False)
            toks_np = tokens.to(torch.int32).cpu().numpy()  # the one host sync per block
            for b in range(self.B):
                sess = self.slots[b]
                if sess is None:
                    continue
                self._cur_host[b] += self.block_size
                toks = toks_np[b]
                stop_idx = np.nonzero(toks >= c.speech_token_size)[0]
                stopped = len(stop_idx) > 0
                if stopped:
                    toks = toks[: stop_idx[0]]
                toks = toks[: sess.max_len - sess.produced]
                sess.produced += len(toks)
                sess.handle._push(toks)
                if stopped or sess.produced >= sess.max_len or sess.handle.cancelled:
                    self._retire(b)
        return True

    # ------------------------------------------------------------------
    def _fail_live(self, exc: BaseException):
        for b in range(self.B):
            if self.slots[b] is not None:
                self.slots[b].handle._fail(exc)
                self.slots[b] = None
        try:
            self.decoder.state.fin.fill_(True)
        except Exception:  # noqa: BLE001 — the card may be what failed
            logging.exception("batch scheduler: could not reset the slots' stop flags")

    def _loop(self):
        ctx = contextlib.nullcontext() if self._stream is None else torch.cuda.stream(self._stream)
        with ctx:
            if self._stream is not None:
                self._stream.wait_stream(torch.cuda.default_stream(self.lm.device))
            while not self._stop.is_set():
                try:
                    with self._lock:
                        worked = self.step()
                except Exception as e:  # noqa: BLE001 — a dead loop would leave every consumer waiting
                    logging.exception("batch scheduler step failed; failing %d live sessions", self.n_active)
                    with self._lock:
                        self._fail_live(e)
                    continue
                if not worked and self.n_active == 0 and self._parked is None:
                    # idle: hold the next submission out of the queue (a
                    # get + put round trip would rotate it behind newer ones)
                    try:
                        self._parked = self.pending.get(timeout=0.05)
                    except queue.Empty:
                        continue

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True, name="lm-batch")
        self._thread.start()

    def stop(self):
        """Stop the loop and close every live and pending handle."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        with self._lock:
            for b in range(self.B):
                self._retire(b)
            if self._parked is not None:
                self._parked[2].handle._close()
                self._parked = None
            while True:
                try:
                    _, _, sess = self.pending.get_nowait()
                except queue.Empty:
                    break
                sess.handle._close()
        self.lm.detach_scheduler(self)
