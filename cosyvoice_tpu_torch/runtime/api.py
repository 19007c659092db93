"""Public API: text and a voice-prompt wav in, 24 kHz speech out.

Counterpart of cosyvoice_tpu/runtime/api.py (the reference CLI surface,
cosyvoice/cli/cosyvoice.py). `CosyVoice2` runs the frontend
(frontend/frontend.py: text normalisation, tokenizer, S3 tokens, x-vector,
prompt mel) and the engine (runtime/engine.py) on one device:
`inference_zero_shot`, `_cross_lingual`, `_instruct2`, `_vc` and `_sft`
are generators of {'tts_speech': np.ndarray [1, n], 'speech_tokens': ...}
chunks, offline or streamed; `add_zero_shot_spk` / `save_spkinfo` keep the
speaker cache. `AutoModel` picks the class from the model dir.

A model dir supplies config.json (architectures, `engine.hop_policy`,
`frontend.s3`), spk2info.pkl, the Qwen tokenizer's assets
(frontend/tokenizer.py) and the checkpoints: `lm`, `flow`, `hift`,
`speech_tokenizer` and `campplus.msgpack`, flax msgpack files of JAX param
trees (utils/msgpack_io.py), as the JAX package's `save_pretrained` and
the converter CLI (tools/convert_checkpoint.py) write them. Each one
present is read on the host and loaded through convert.load_jax_params (a
tree that does not match its module raises); each one absent stays random,
made on the device from `seed` (engine: seed, seed + 1, seed + 2;
frontend: seed + 3, seed + 4), with the JAX package's warning for the
engine's three. With `quant_lm` True / "int8", "int4" or "int4p" (True is
"int8", as in the JAX API; `kv_quant` combines with each) the fp LM tree is
quantised on the host (ops/quant.quantize_lm_params) before it is loaded;
a tree that is already quantised in that mode (save_pretrained's) loads as
it is. `save_pretrained`
writes all five files; `set_sampling` changes the LM's sampling config in
place (the weights, the static KV arenas and the decode graphs of other
configs stay). Without continuous batching, `inference_*` calls from
several threads run one at a time, each in turn, frontend included.
`enable_continuous_batching(max_batch)` captures every decode graph and
starts an LMBatchScheduler (runtime/batch_scheduler.py) that every later
`inference_*` call, from any thread, shares; an offline request whose text
splits into several segments then runs its segments concurrently through
it and yields them in order.

`CosyVoice3` serves Fun-CosyVoice3-0.5B in every mode of CosyVoice2: the
v3 LM layout, the DiT flow and the causal HiFT (utils/config.py:
cosyvoice3_configs, unless config.json has the section or the caller
passes the config) through runtime/engine.py:CosyVoice3Engine, with the
version-3 frontend (its tokenizer knows the v3 special tokens);
`inference_instruct2` refuses an instruct text that holds the
<|endofprompt|> delimiter the frontend appends. `AutoModel` returns it for
a version-3 dir.

`CosyVoice` serves CosyVoice-300M (the JAX api.py:CosyVoice): the
TransformerLM, the MaskedDiffFlow and the 22.05 kHz HiFT through
runtime/engine.py:CosyVoiceV1Engine, with the version-1 frontend (a model
dir's `.tiktoken` vocab, frontend/tiktoken_bpe.py): zero-shot,
cross-lingual, vc, sft (a released spk2info entry's x-vector conditions the
LM and the flow) and `inference_instruct` (the LM's prompt is the
instruction + "<endofprompt>", with the zero speaker row). `AutoModel`
returns it for a version-1 dir (config.json, or the reference's
cosyvoice.yaml).
"""

import dataclasses
import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.frontend.frontend import CosyVoiceFrontEnd
from cosyvoice_tpu_torch.frontend.tokenizer import find_tokenizer_assets
from cosyvoice_tpu_torch.models.flow import FlowConfig
from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config
from cosyvoice_tpu_torch.models.hift import HiFTConfig, v1_hift_config
from cosyvoice_tpu_torch.models.llm import LMConfig
from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config
from cosyvoice_tpu_torch.ops.quant import quant_mode
from cosyvoice_tpu_torch.runtime.batch_scheduler import LMBatchScheduler
from cosyvoice_tpu_torch.runtime.engine import (
    CosyVoice2Engine,
    CosyVoice3Engine,
    build_random_engine,
    build_random_engine_v1,
)
from cosyvoice_tpu_torch.utils import msgpack_io
from cosyvoice_tpu_torch.utils.config import (
    build_flow_config,
    build_flow_v1_config,
    build_hift_config,
    build_lm_config,
    build_lm_v1_config,
    build_s3_config,
    cosyvoice3_configs,
)

CHECKPOINTS = ("lm", "flow", "hift", "speech_tokenizer", "campplus")  # <name>.msgpack in a model dir


def _read_dir_config(model_dir: str) -> dict:
    path = os.path.join(model_dir, "config.json") if model_dir else ""
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _checkpoint(model_dir: str, name: str):
    """The JAX param tree in <model_dir>/<name>.msgpack, or None."""
    path = os.path.join(model_dir, f"{name}.msgpack") if model_dir else ""
    if not (path and os.path.exists(path)):
        return None
    tree = msgpack_io.read(path)
    logging.info("loaded %s", path)
    return tree


def load_frontend(model_dir: str = "", sample_rate: int = 24000, version: int = 2, seed: int = 0,
                  device="cuda") -> CosyVoiceFrontEnd:
    """A CosyVoiceFrontEnd for a model dir: the S3 architecture from
    config.json "frontend": {"s3": ...}, the tokenizer from its assets, the
    speakers of spk2info.pkl, the S3 and CAM++ weights of
    speech_tokenizer.msgpack and campplus.msgpack where present, else
    random from `seed`."""
    s3 = _read_dir_config(model_dir).get("frontend", {}).get("s3")
    fe = CosyVoiceFrontEnd(
        token_path=find_tokenizer_assets(model_dir),
        sample_rate=sample_rate,
        spk2info_path=os.path.join(model_dir, "spk2info.pkl") if model_dir else "",
        s3_cfg=build_s3_config(s3) if s3 else None,
        seed=seed,
        version=version,
        device=device,
    )
    for name in ("speech_tokenizer", "campplus"):
        tree = _checkpoint(model_dir, name)
        if tree is not None:
            load_jax_params(getattr(fe, name), tree)
    return fe


def _require_ported(version: int):
    """Raise unless the port serves model `version` (1, 2 and 3)."""
    if version not in (1, 2, 3):
        raise ValueError(f"unsupported model version {version}")


class CosyVoice2:
    sample_rate = 24000
    version = 2  # the frontend's (its tokenizer's special tokens)
    engine_cls = CosyVoice2Engine

    def __init__(
        self,
        model_dir: str = "",
        fp16: bool = False,  # accepted and unused, as in the JAX API
        seed: int = 1986,
        lm_cfg: Optional[LMConfig] = None,
        flow_cfg: Optional[FlowConfig] = None,
        hift_cfg: Optional[HiFTConfig] = None,
        quant_lm=False,  # False, True / "int8", "int4", or "int4p" (int4 on the fused decode kernels K4..K7)
        kv_quant: bool = False,  # int8 KV arena with per-row scales (K3)
        hop_policy: str = "",  # doubling | exponential | time_based; "" = config.json's engine.hop_policy, else doubling
        device="cuda",
    ):
        self.model_dir = model_dir
        file_cfg = _read_dir_config(model_dir)
        _require_ported(int(file_cfg.get("version", 2)))
        lm_cfg = lm_cfg or (build_lm_config(file_cfg["llm"]) if "llm" in file_cfg else LMConfig())
        if quant_lm or kv_quant:
            # True means "int8", as in the JAX API
            qwen = dataclasses.replace(lm_cfg.qwen, quant=quant_mode(quant_lm) if quant_lm else lm_cfg.qwen.quant,
                                       kv_quant=kv_quant or lm_cfg.qwen.kv_quant)
            lm_cfg = dataclasses.replace(lm_cfg, qwen=qwen)
        flow_cfg = flow_cfg or (build_flow_config(file_cfg["flow"]) if "flow" in file_cfg else FlowConfig())
        hift_cfg = hift_cfg or (build_hift_config(file_cfg["hift"]) if "hift" in file_cfg else HiFTConfig())
        self.frontend = load_frontend(model_dir, self.sample_rate, self.version, seed=seed + 3, device=device)
        trees = {}
        for name in ("lm", "flow", "hift"):
            trees[name] = _checkpoint(model_dir, name)
            if trees[name] is None:
                logging.warning("no checkpoint for %s — using random init", name)
        self.engine = build_random_engine(
            seed, device, lm_cfg, flow_cfg, hift_cfg,
            hop_policy=hop_policy or file_cfg.get("engine", {}).get("hop_policy", "doubling"),
            trees={k: v for k, v in trees.items() if v is not None},
            engine_cls=self.engine_cls,
        )
        self.lm, self.flow, self.hift = self.engine.lm, self.engine.flow, self.engine.hift
        self._seg_ex, self._seg_ex_width = None, 0  # the concurrent segments' threads (_segment_executor)
        self._serial = threading.Lock()  # held by the request that runs (_in_turn)

    # ---------------- speaker cache ----------------
    def list_available_spks(self):
        return list(self.frontend.spk2info.keys())

    def add_zero_shot_spk(self, prompt_text: str, prompt_wav, zero_shot_spk_id: str) -> bool:
        if zero_shot_spk_id == "":
            raise ValueError("do not use empty zero_shot_spk_id")
        return self.frontend.add_zero_shot_spk(prompt_text, prompt_wav, zero_shot_spk_id)

    def save_spkinfo(self):
        self.frontend.save_spkinfo(os.path.join(self.model_dir or ".", "spk2info.pkl"))

    def set_sampling(self, top_p=None, top_k=None, temperature=None, repetition_penalty=None):
        """Set the LM's decode sampling (the reference's Triton consumer
        decodes with top_p 0.95 / top_k 50 / temperature 0.8 /
        repetition_penalty 1.1; the default is RAS with top_p 0.8 / top_k 25
        and neither temperature nor penalty). Arguments left None keep their
        value. The LM keeps its weights, static KV arenas and decode graphs
        (a graph is keyed by the sampling config it was captured with).
        Call it before enable_continuous_batching. Returns the LM's config."""
        if self.engine.scheduler is not None:
            raise RuntimeError("set_sampling must be called before enable_continuous_batching")
        kw = {}
        if top_p is not None:
            kw["top_p"] = float(top_p)
        if top_k is not None:
            kw["top_k"] = int(top_k)
        if temperature is not None:
            kw["temperature"] = float(temperature)
        if repetition_penalty is not None:
            kw["repetition_penalty"] = float(repetition_penalty)
        if kw:
            self.lm.cfg = dataclasses.replace(self.lm.cfg, **kw)
        return self.lm.cfg

    def enable_continuous_batching(self, max_batch: int = 4, block_size=None):
        """Serve concurrent requests through one batched LM decode loop: an
        LMBatchScheduler of `max_batch` slots over this API's LM, started on
        a thread of its own, after it has captured every decode graph that
        it and the LM's B=1 decoder can replay (`capture_graphs`), once the
        request running (if any) has ended. Call once; inference_* calls
        from any thread then share it. Returns the scheduler (its `stop()`
        ends it)."""
        with self._serial:
            if self.engine.scheduler is not None:
                raise RuntimeError("continuous batching is already enabled")
            sched = LMBatchScheduler(self.lm, max_batch=max_batch, block_size=block_size)
            try:
                sched.capture_graphs()
            except BaseException:
                sched.stop()
                raise
            sched.start()
            self.engine.scheduler = sched
        return sched

    # ---------------- checkpoint save ----------------
    def save_pretrained(self, out_dir: str):
        """Write lm, flow, hift, speech_tokenizer and campplus.msgpack: each
        module's JAX param tree (convert.export_params; the int4p LM's
        quantised tree, as the JAX API saves its LM's params)."""
        os.makedirs(out_dir, exist_ok=True)
        fe = self.frontend
        for name, module in zip(CHECKPOINTS, (self.lm.module, self.flow, self.hift, fe.speech_tokenizer, fe.campplus)):
            msgpack_io.write(os.path.join(out_dir, f"{name}.msgpack"), export_params(module))

    # ---------------- inference modes ----------------
    def _run(self, model_input: dict, stream: bool, speed: float):
        start = time.time()
        extra = {}
        if model_input.get("llm_embedding") is not None:
            # v1 conditions its LM on a speaker vector of its own; the v2/v3 engines take none
            extra["llm_embedding"] = model_input["llm_embedding"]
        for out in self.engine.tts(
            **extra,
            text_tokens=model_input.get("text_tokens", np.zeros(0, np.int32)),
            prompt_text_tokens=model_input.get("prompt_text_tokens", np.zeros(0, np.int32)),
            llm_prompt_speech_token=model_input.get("llm_prompt_speech_token", np.zeros(0, np.int32)),
            flow_prompt_speech_token=model_input.get("flow_prompt_speech_token", np.zeros(0, np.int32)),
            prompt_speech_feat=model_input.get("prompt_speech_feat", np.zeros((1, 0, 80), np.float32)),
            flow_embedding=model_input.get("flow_embedding", np.zeros((1, 192), np.float32)),
            stream=stream,
            speed=speed,
            source_speech_token=model_input.get("source_speech_token"),
        ):
            speech_len = out["tts_speech"].shape[1] / self.sample_rate
            logging.info("yield speech len %.2f, rtf %.3f", speech_len, (time.time() - start) / max(speech_len, 1e-6))
            yield out
            start = time.time()

    def _in_turn(self, chunks, text=None):
        """`chunks`, a request's generator, run while no other request that
        takes turns runs. Without a scheduler every request takes turns,
        frontend included: the LM decodes one request at a time, and it may
        capture a decode graph mid-request, which another thread's work on
        the card would invalidate. With one, only a request whose `text` is
        a generator does (its bistream decode takes the LM's B=1 path); the
        scheduler captured every graph when it was enabled."""
        if self.engine.scheduler is not None and not hasattr(text, "__next__"):
            yield from chunks
            return
        with self._serial:
            yield from chunks

    def _run_segments(self, inputs, stream: bool, speed: float):
        """`inputs` lazily yields each text segment's model input. Offline
        with continuous batching, two or more segments run concurrently
        through the shared decode loop (each on a thread of
        `_segment_executor`), and their chunks are yielded in segment order,
        each as soon as it and those before it exist. Streaming and
        scheduler-less requests run the segments one after another, each
        one's frontend as reached."""
        scheduler = self.engine.scheduler
        if stream or scheduler is None:
            for mi in inputs:
                yield from self._run(mi, stream, speed)
            return
        jobs = list(inputs)
        if len(jobs) <= 1:
            for mi in jobs:
                yield from self._run(mi, stream, speed)
            return
        ex = self._segment_executor(scheduler.B)
        queues = [queue.Queue() for _ in jobs]

        def worker(mi, q):
            try:
                for out in self._run(mi, False, speed):
                    q.put(out)
                q.put(None)
            except BaseException as e:  # raised again on the consumer's thread
                q.put(e)

        for mi, q in zip(jobs, queues):
            ex.submit(worker, mi, q)
        for q in queues:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item

    def _segment_executor(self, width: int) -> ThreadPoolExecutor:
        """The threads of concurrent offline segments, kept across requests
        (a pool per call would start and end threads under serving load)."""
        if self._seg_ex is None or self._seg_ex_width < width:
            if self._seg_ex is not None:
                self._seg_ex.shutdown(wait=False)
            self._seg_ex = ThreadPoolExecutor(max_workers=width, thread_name_prefix="cosy-seg")
            self._seg_ex_width = width
        return self._seg_ex

    def _segments(self, tts_text, text_frontend: bool):
        return self.frontend.text_normalize(tts_text, split=True) if text_frontend else [tts_text]

    def inference_zero_shot(self, tts_text, prompt_text, prompt_wav, zero_shot_spk_id="", stream=False, speed=1.0,
                            text_frontend=True):
        prompt_texts = self.frontend.text_normalize(prompt_text, split=False) if text_frontend else prompt_text

        def jobs():
            for seg in self._segments(tts_text, text_frontend):
                # a generator segment (text from an upstream LLM) takes the LM's bistream decode
                if not hasattr(seg, "__next__") and len(seg) < 0.5 * len(prompt_text):
                    logging.warning("synthesis text %s too short compared to prompt text %s", seg, prompt_text)
                yield self.frontend.frontend_zero_shot(seg, prompt_texts, prompt_wav, zero_shot_spk_id)

        yield from self._in_turn(self._run_segments(jobs(), stream, speed), tts_text)

    def inference_cross_lingual(self, tts_text, prompt_wav, zero_shot_spk_id="", stream=False, speed=1.0,
                                text_frontend=True):
        def jobs():
            for seg in self._segments(tts_text, text_frontend):
                yield self.frontend.frontend_cross_lingual(seg, prompt_wav, zero_shot_spk_id)

        yield from self._in_turn(self._run_segments(jobs(), stream, speed), tts_text)

    def inference_instruct2(self, tts_text, instruct_text, prompt_wav, zero_shot_spk_id="", stream=False, speed=1.0,
                            text_frontend=True):
        def jobs():
            for seg in self._segments(tts_text, text_frontend):
                yield self.frontend.frontend_instruct2(seg, instruct_text, prompt_wav, zero_shot_spk_id)

        yield from self._in_turn(self._run_segments(jobs(), stream, speed), tts_text)

    def inference_vc(self, source_speech_16k, prompt_wav, stream=False, speed=1.0):
        def run():
            yield from self._run(self.frontend.frontend_vc(source_speech_16k, prompt_wav), stream, speed)

        yield from self._in_turn(run())

    def inference_sft(self, tts_text, spk_id, stream=False, speed=1.0, text_frontend=True):
        """A pre-enrolled speaker, no prompt wav: an add_zero_shot_spk entry
        (the whole prompt) or a released entry (an 'embedding' x-vector alone)."""
        info = self.frontend.spk2info[spk_id]

        def jobs():
            for seg in self._segments(tts_text, text_frontend):
                if "embedding" in info:
                    mi = {"flow_embedding": np.asarray(info["embedding"], np.float32).reshape(1, -1)}
                else:
                    mi = dict(info)
                mi["text_tokens"] = self.frontend._extract_text_token(seg)
                yield mi

        yield from self._in_turn(self._run_segments(jobs(), stream, speed), tts_text)


class CosyVoice3(CosyVoice2):
    """Fun-CosyVoice3-0.5B (the JAX api.py:CosyVoice3): the FSQ-6561 codec
    with 200 special rows in the speech table, the DiT flow, the causal
    vocoder, through CosyVoice3Engine. The arguments are CosyVoice2's; a
    config left None takes the v3 default (cosyvoice3_configs) unless
    config.json has its section."""

    version = 3
    engine_cls = CosyVoice3Engine

    def __init__(
        self,
        model_dir: str = "",
        fp16: bool = False,
        seed: int = 1986,
        lm_cfg: Optional[LMConfig] = None,
        flow_cfg: Optional[FlowConfig] = None,
        hift_cfg: Optional[HiFTConfig] = None,
        quant_lm=False,
        kv_quant: bool = False,
        hop_policy: str = "",
        device="cuda",
    ):
        file_cfg = _read_dir_config(model_dir)
        lm0, flow0, hift0 = cosyvoice3_configs()
        lm_cfg = lm_cfg or (None if "llm" in file_cfg else lm0)
        flow_cfg = flow_cfg or (None if "flow" in file_cfg else flow0)
        hift_cfg = hift_cfg or (None if "hift" in file_cfg else hift0)
        super().__init__(model_dir, fp16, seed, lm_cfg, flow_cfg, hift_cfg, quant_lm, kv_quant, hop_policy, device)

    def inference_instruct2(self, tts_text, instruct_text, prompt_wav, zero_shot_spk_id="", stream=False, speed=1.0,
                            text_frontend=True):
        # the frontend appends <|endofprompt|> itself; a stray one inside
        # instruct_text would split the prompt at the wrong place
        if "<|endofprompt|>" in instruct_text:
            raise ValueError("instruct_text must not contain <|endofprompt|>")
        yield from super().inference_instruct2(tts_text, instruct_text, prompt_wav, zero_shot_spk_id, stream, speed,
                                               text_frontend)


class CosyVoice(CosyVoice2):
    """CosyVoice-300M (the JAX api.py:CosyVoice): the TransformerLM, the
    MaskedDiffFlow and the 22.05 kHz HiFT through CosyVoiceV1Engine, with
    the version-1 frontend (the `.tiktoken` tokenizer of a model dir, 22.05
    kHz prompt mels). Every mode of CosyVoice2 but instruct2, plus
    `inference_instruct`; configs left None take config.json's section,
    else the full-width defaults (LMv1Config, FlowV1Config,
    v1_hift_config)."""

    sample_rate = 22050
    version = 1

    def __init__(
        self,
        model_dir: str = "",
        fp16: bool = False,  # accepted and unused, as in the JAX API
        seed: int = 1986,
        lm_cfg: Optional[LMv1Config] = None,
        flow_cfg: Optional[FlowV1Config] = None,
        hift_cfg: Optional[HiFTConfig] = None,
        device="cuda",
    ):
        self.model_dir = model_dir
        file_cfg = _read_dir_config(model_dir)
        lm_cfg = lm_cfg or (build_lm_v1_config(file_cfg["llm"]) if "llm" in file_cfg else LMv1Config())
        flow_cfg = flow_cfg or (build_flow_v1_config(file_cfg["flow"]) if "flow" in file_cfg else FlowV1Config())
        hift_cfg = hift_cfg or (build_hift_config(file_cfg["hift"]) if "hift" in file_cfg else v1_hift_config())
        self.frontend = load_frontend(model_dir, self.sample_rate, self.version, seed=seed + 3, device=device)
        trees = {name: _checkpoint(model_dir, name) for name in ("lm", "flow", "hift")}
        self.engine = build_random_engine_v1(seed, device, lm_cfg, flow_cfg, hift_cfg,
                                             trees={k: v for k, v in trees.items() if v is not None})
        self.lm, self.flow, self.hift = self.engine.lm, self.engine.flow, self.engine.hift
        self._seg_ex, self._seg_ex_width = None, 0
        self._serial = threading.Lock()

    def set_sampling(self, *args, **kw):
        raise NotImplementedError("set_sampling is the Qwen2 LM's (CosyVoice2 / CosyVoice3)")

    def enable_continuous_batching(self, *args, **kw):
        raise NotImplementedError("continuous batching is the Qwen2 LM's (CosyVoice2 / CosyVoice3)")

    def inference_instruct2(self, *args, **kw):
        raise NotImplementedError("CosyVoice-300M has inference_instruct, not inference_instruct2")

    def inference_sft(self, tts_text, spk_id, stream=False, speed=1.0, text_frontend=True):
        """A pre-enrolled speaker: an add_zero_shot_spk entry (its prompt
        and x-vector), or a released entry (an 'embedding' x-vector for the
        LM and the flow, as the reference's frontend_sft gives)."""
        info = self.frontend.spk2info[spk_id]

        def jobs():
            for seg in self._segments(tts_text, text_frontend):
                if "embedding" in info:
                    emb = np.asarray(info["embedding"], np.float32).reshape(1, -1)
                    mi = {"llm_embedding": emb, "flow_embedding": emb}
                else:
                    mi = dict(info)
                mi["text_tokens"] = self.frontend._extract_text_token(seg)
                yield mi

        yield from self._in_turn(self._run_segments(jobs(), stream, speed), tts_text)

    def inference_instruct(self, tts_text, spk_id, instruct_text, stream=False, speed=1.0, text_frontend=True):
        """A pre-enrolled speaker read with an instruction: the LM's prompt
        text is instruct_text + "<endofprompt>", with no prompt speech and
        no speaker (the zero x-vector row, as the reference drops the LM's
        speaker embedding); the flow keeps the speaker's prompt and
        x-vector."""
        info = self.frontend.spk2info[spk_id]

        def jobs():
            for seg in self._segments(tts_text, text_frontend):
                mi = ({"flow_embedding": np.asarray(info["embedding"], np.float32).reshape(1, -1)}
                      if "embedding" in info else dict(info))
                mi["text_tokens"] = self.frontend._extract_text_token(seg)
                mi["prompt_text_tokens"] = self.frontend._extract_text_token(instruct_text + "<endofprompt>")
                mi["llm_prompt_speech_token"] = np.zeros(0, np.int32)
                mi["llm_embedding"] = np.zeros((1, self.lm.cfg.spk_embed_dim), np.float32)
                yield mi

        yield from self._in_turn(self._run_segments(jobs(), stream, speed), tts_text)


def detect_model_version(model_dir: str) -> int:
    """config.json's 'version', else the reference's yaml name
    (cosyvoice{,2,3}.yaml), else 2."""
    cfg_path = os.path.join(model_dir, "config.json") if model_dir else ""
    if cfg_path and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            return json.load(f).get("version", 2)
    if model_dir:
        for v, name in ((3, "cosyvoice3.yaml"), (2, "cosyvoice2.yaml"), (1, "cosyvoice.yaml")):
            if os.path.exists(os.path.join(model_dir, name)):
                return v
    return 2


class AutoModel:
    """The model class the model dir names (reference cosyvoice.py:228-238)."""

    def __new__(cls, model_dir: str = "", **kwargs):
        version = detect_model_version(model_dir)
        _require_ported(version)
        return {1: CosyVoice, 2: CosyVoice2, 3: CosyVoice3}[version](model_dir, **kwargs)
