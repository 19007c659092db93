"""The CosyVoice2 engine's speculative fused first chunk: its token->wav
replayed as one CUDA graph.

Counterpart of the token->wav half of cosyvoice_tpu/runtime/engine.py:
`_first_chunk_impl` (the JAX engine compiles the LM prefill, the first n1
decode blocks, the flow and HiFT into one program; here the LM half is
`Qwen2LM.generate_first`, on its decode graphs, and this module is the
rest). From the n1 * block_size sampled tokens, still on the device:

- `safe = min(tokens, vocab - 1)` (the eos that follow a stop id);
- the first `this_hop` tokens written into the flow's token buffer at the
  prompt's length `lp` (a device scalar, as it is traced in JAX), the next
  `la` tokens the lookahead context;
- the streaming flow (chunk masks) over the prompt and those tokens, padded
  to `n_pad = _bucket(Lp + this_hop + la, 16)` tokens (the JAX engine's
  first-chunk bucket, not the standard path's `_bucket_geo`);
- the this_hop * r mel rows from lp * r, vocoded by HiFT alone (no cache),
  the source's draws a static buffer drawn once from the engine's HiFT
  generator (`CosyVoice2Engine._generator`: reseeded with SEED on every
  call, so the draws of a length are fixed; or `hift.source_draws` where
  set);
- the wav without its last 8 * 480 samples, and the mel, source and speech
  caches of the next chunk.

The body runs over static buffers (`_Entry`) and reads nothing from the
device on the host, so on the card it is captured once per (n_pad,
this_hop), the arguments the JAX program is static in (n1 follows from
this_hop), and replayed per request; on the CPU the same body runs
eagerly. A capture runs at first use, on the calling (token->wav) stream,
under the LM's `capture_lock` (the engine holds it), with Python's cycle
collector off (a graph it freed mid-capture would invalidate the capture,
as models/decode_graph.py notes), after one eager run of the body (the
warm-up: cuFFT plans for the STFT and iSTFT, cuDNN's algorithms, the
device copies of the fixed noise, position table and window), with
cudnn.benchmark off. Every graph of an engine allocates from one private
memory pool (`pool_bytes`, the device memory reserved by the captures). A
failed capture or replay raises: nothing falls back to the eager body on
the card.

`captures`, `replays`, `capture_s` count the graphs captured, the replays
and the host seconds capturing.
"""

import gc
import time

import torch

from cosyvoice_tpu_torch.models.hift import draw_source


class _Entry:
    """The static buffers of one (n_pad, this_hop): the LM's first tokens
    [1, n_tok] int32, the flow's token buffer [1, n_pad] (the prompt's
    tokens at [0, lp)), lp [1], the conds [1, n_pad * r, 80] (the prompt
    mel at the front), the speaker embedding [1, 192], the source's draws;
    the captured graph and its outputs."""

    def __init__(self, eng, n_pad: int, this_hop: int, n_tok: int):
        dev, r = eng.device, eng.token_mel_ratio
        self.n_pad, self.this_hop = n_pad, this_hop
        with torch.inference_mode(False):
            self.tokens = torch.zeros((1, n_tok), dtype=torch.int32, device=dev)
            self.flow_tokens = torch.zeros((1, n_pad), dtype=torch.long, device=dev)
            self.lp = torch.zeros((1,), dtype=torch.long, device=dev)
            self.conds = torch.zeros((1, n_pad * r, 80), device=dev)
            self.emb = torch.zeros((1, eng.flow.cfg.spk_embed_dim), device=dev)
            hift = eng.hift
            n_samples = this_hop * r * eng.wav_hop
            self.draws = (hift.source_draws(n_samples) if hift.source_draws is not None
                          else draw_source(hift.cfg, 1, n_samples, eng._generator(), dev))
        self.graph = None
        self.out = None


class FirstChunkGraphs:
    """The first chunk's token->wav of `engine` (a CosyVoice2Engine), one
    graph per (n_pad, this_hop) on the card, eager on the CPU (see the
    module docstring)."""

    def __init__(self, engine):
        self.engine = engine
        self.entries = {}  # (n_pad, this_hop) -> _Entry
        self.pool = None  # the graphs' one private memory pool
        self.pool_bytes = 0
        self.captures = self.replays = 0
        self.capture_s = 0.0

    def plan(self, n_prompt: int):
        """(this_hop, need, n1, n_pad) of a first chunk after a prompt of
        n_prompt tokens: the first hop padded so that prompt + hop is a hop
        multiple, the tokens it needs (hop + lookahead), the LM blocks that
        hold them and the flow's token bucket."""
        eng = self.engine
        hop, la = eng.token_hop_len, eng.pre_lookahead_len
        this_hop = hop + (-n_prompt % hop)
        need = this_hop + la
        n1 = -(-need // eng.lm.cfg.block_size)
        return this_hop, need, n1, -(-(n_prompt + need) // 16) * 16

    def prepare(self, prompt_token, prompt_feat, embedding) -> _Entry:
        """The entry of this prompt's first chunk with its static inputs
        written: the prompt's tokens, lp, the prompt mel and the embedding
        (host-to-device copies on the current stream)."""
        eng = self.engine
        n_prompt = len(prompt_token)
        this_hop, _, n1, n_pad = self.plan(n_prompt)
        key = (n_pad, this_hop)
        e = self.entries.get(key)
        if e is None:
            e = self.entries[key] = _Entry(eng, n_pad, this_hop, n1 * eng.lm.cfg.block_size)
        e.flow_tokens.zero_()
        e.flow_tokens[0, :n_prompt] = eng._tensor(prompt_token, torch.long)
        e.lp.fill_(n_prompt)
        e.conds.zero_()
        e.conds[0, : prompt_feat.shape[1]] = eng._tensor(prompt_feat[0])
        e.emb.copy_(eng._tensor(embedding))
        return e

    def run(self, e: _Entry, tokens: torch.Tensor):
        """The first chunk from the LM's first tokens [1, n_tok] (copied into
        the entry's buffer): (wav [1, this_hop * r * 480 - 8 * 480], mel
        cache, source cache, speech cache), the entry's static outputs on the
        card. The caller holds the LM's capture_lock, on the token->wav
        stream."""
        e.tokens.copy_(tokens)
        if e.tokens.device.type != "cuda":
            return self._body(e)
        if e.graph is None:
            self._capture(e)
        e.graph.replay()
        self.replays += 1
        return e.out

    @torch.inference_mode()
    def _body(self, e: _Entry):
        eng = self.engine
        flow, hift = eng.flow, eng.hift
        r, la, hop = eng.token_mel_ratio, eng.pre_lookahead_len, e.this_hop
        dev = e.tokens.device
        safe = e.tokens.long().clamp_max(flow.cfg.vocab_size - 1)  # the eos after a stop id
        tok = e.flow_tokens.index_copy(1, e.lp + torch.arange(hop, device=dev), safe[:, :hop])
        mel_full = flow.inference(tok, e.lp + hop, e.conds, e.emb, safe[:, hop : hop + la], streaming=True)
        mel = mel_full.index_select(1, e.lp * r + torch.arange(hop * r, device=dev))
        source = hift.source_from_f0(hift.predict_f0(mel), None, e.draws)
        wav = hift.decode(mel, source)
        n = eng.source_cache_len
        return wav[:, :-n], mel[:, -eng.mel_cache_len :], source[:, -n:], wav[:, -n:]

    def _capture(self, e: _Entry):
        dev = e.tokens.device
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        cudnn = torch.backends.cudnn
        bench, cudnn.benchmark = cudnn.benchmark, False
        collecting = gc.isenabled()
        gc.disable()
        try:
            self._body(e)  # the warm-up
            torch.cuda.current_stream(dev).synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=torch.cuda.current_stream(dev),
                                  capture_error_mode="thread_local"):
                out = self._body(e)
            self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        finally:
            cudnn.benchmark = bench
            if collecting:
                gc.enable()
        e.graph, e.out = graph, out
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def capture(self, n_prompt: int):
        """Capture now (on the card) the graph of a prompt of n_prompt
        tokens, so that no request pays it: random prompt inputs, zero
        tokens, one run under the LM's capture_lock on the engine's
        token->wav stream. Returns the entry."""
        eng = self.engine
        r = eng.token_mel_ratio
        g = torch.Generator().manual_seed(0)
        prompt_token = torch.randint(0, eng.flow.cfg.vocab_size, (n_prompt,), generator=g).numpy()
        feat = torch.randn((1, n_prompt * r, 80), generator=g).numpy()
        emb = torch.randn((1, eng.flow.cfg.spk_embed_dim), generator=g).numpy()
        with eng._on_t2w():
            e = self.prepare(prompt_token, feat, emb)
            self.run(e, torch.zeros_like(e.tokens))
        eng._sync()
        return e
