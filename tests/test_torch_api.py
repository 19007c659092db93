"""The port's public API (runtime/api.py) against the JAX package's, CPU,
float32: `CosyVoice2(model_dir, device="cpu")` and the JAX `CosyVoice2`
built from one config.json (the tiny widths of tests/test_api.py, a tiny
S3 through its "frontend" section), every tree carried from the JAX API
(LM, flow, HiFT, S3, CAM++). Text and a 16 kHz prompt wav go in; the
tokens must be equal and the wavs within 1e-3 for zero-shot offline and
streamed, cross-lingual, instruct2, vc, sft from a spk2info.pkl the JAX API
saved, speed 1.5, a text split into two segments and generator text; and
for `quant_lm="int4p"` (K7's route) at the int4 layouts' tiny widths.

The LMs decode greedily (top_k 1, RAS resample off), with the stop
token's logit raised by EOS_BIAS so that each request stops when min_len
(2 x its text ids) lets it, not at max_len (20 x): the two-segment text
needs 81 byte ids. The HiFT source is pinned by configuration, as in
tests/test_torch_engine.py. Both engines stream on their standard path
(the speculative first chunk off; tests/test_torch_first_chunk.py holds
the port's fused first chunk against the JAX engine's). The JAX
frontend's CAM++ is built at a tiny config (its name patched in the JAX
frontend module while the JAX API is built; nothing in the JAX package
changes): the full one takes ~30 s to initialise on the CPU. Also: the
prompt LRU, AutoModel's version detection (version 1: tests/test_torch_api_v1.py),
and the quantised LMs' API. Checkpoints, tokenizer assets, save_pretrained and
set_sampling are held by tests/test_torch_checkpoint_api.py,
tests/test_torch_bpe.py and tests/test_torch_sampling.py."""

import inspect
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosyvoice_tpu.frontend.frontend as jfrontend
from cosyvoice_tpu.models.campplus import CamPPConfig as JCamPPConfig
from cosyvoice_tpu.models.campplus import CamPPEmbedding as JCamPPEmbedding
from cosyvoice_tpu.runtime.api import CosyVoice2 as JCosyVoice2
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
from cosyvoice_tpu_torch.runtime.api import AutoModel, CosyVoice2, detect_model_version
from tests.test_torch_common import np_tree

torch.set_num_threads(1)

ATOL = 1e-3  # float32 wav after LM, flow and HiFT, as tests/test_torch_engine.py
CAM = dict(blocks=((2, 3, 1), (2, 3, 2), (2, 3, 2)))
EOS_BIAS = 30.0
TEXT, PROMPT_TEXT = "Hello there, my friend.", "A cue."
# split_paragraph's English rule: a segment closes past 80 byte ids once it
# holds more than 60, and a last one under 20 joins the one before
TWO_SEGMENTS = "This first sentence is long enough to close a segment on its own. Then a second, shorter one."

CONFIG = {
    "version": 2,
    "llm": {"speech_token_size": 6561, "block_size": 8, "top_k": 1, "tau_r": 2.0,
            "qwen": {"hidden_size": 32, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                     "intermediate_size": 64, "vocab_size": 300, "max_cache_len": 2048, "dtype": "float32"}},
    "flow": {"input_size": 32, "vocab_size": 6561, "chunk_size": 5, "attention_heads": 2, "linear_units": 64,
             "num_blocks": 1, "num_up_blocks": 1,
             "estimator": {"channels": [32], "attention_head_dim": 8, "n_blocks": 1, "num_mid_blocks": 1,
                           "num_heads": 2, "static_chunk_size": 10, "causal": True},
             "cfm": {"n_timesteps": 2}},
    "hift": {"base_channels": 32, "resblock_kernel_sizes": [3], "resblock_dilations": [[1]],
             "source_resblock_kernel_sizes": [7, 7, 11], "source_resblock_dilations": [[1], [1], [1]],
             "nsf_sigma": 0.0, "nsf_voiced_threshold": -1.0},
    "frontend": {"s3": {"d_model": 64, "num_heads": 4, "num_layers": 2}},
}


def _wav(seed, seconds):
    return (np.random.default_rng(seed).standard_normal((1, int(16000 * seconds))) * 0.1).astype(np.float32)


def _write_dir(path, config=CONFIG):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    return str(path)


def _jax_api(model_dir, **kw):
    """The JAX API from model_dir, its CAM++ tiny, its stop logit raised, its
    HiFT source pinned, streaming on its standard path with the tiny flow's
    chunk (5) as the hop."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfrontend, "CamPPEmbedding", lambda: JCamPPEmbedding(JCamPPConfig(**CAM)))
        japi = JCosyVoice2(model_dir, **kw)
    lm = np_tree(japi.lm_params)
    head = lm["params"]["llm_decoder"]
    head["bias"] = head["bias"].copy()
    head["bias"][japi.lm.cfg.eos_token] += EOS_BIAS
    japi.lm_params = japi.engine.lm_params = jax.tree.map(jnp.asarray, lm)
    hift = np_tree(japi.hift_params)
    w = hift["params"]["m_source"]["l_linear"]["kernel"].copy()
    w[0, 0], w[1:, 0] = 1.5, 0.0
    hift["params"]["m_source"]["l_linear"]["kernel"] = w
    japi.hift_params = japi.engine.hift_params = jax.tree.map(jnp.asarray, hift)
    japi.engine.token_hop_len, japi.engine.token_max_hop_len = 5, 20
    japi.engine.speculative_first_chunk = False
    return japi


def _port_api(model_dir, japi, **kw):
    """The port's API from model_dir with every JAX tree carried over,
    streaming on its standard path as the JAX API does (_jax_api)."""
    api = CosyVoice2(model_dir, device="cpu", **kw)
    api.engine.speculative_first_chunk = False
    fe = api.frontend
    fe.campplus = CamPPEmbedding(CamPPConfig(**CAM))
    load_jax_params(api.lm.module, np_tree(japi.lm_params["params"]))
    load_jax_params(api.flow, np_tree(japi.flow_params))
    load_jax_params(api.hift, np_tree(japi.hift_params["params"]))
    load_jax_params(fe.speech_tokenizer, np_tree(japi.frontend.speech_tokenizer_params["params"]))
    load_jax_params(fe.campplus, np_tree(japi.frontend.campplus_params["params"]))
    return api


@pytest.fixture(scope="module")
def apis(tmp_path_factory):
    model_dir = _write_dir(tmp_path_factory.mktemp("model"))
    japi = _jax_api(model_dir)
    # a speaker enrolled and saved by the JAX API, loaded by the port's frontend
    japi.add_zero_shot_spk(PROMPT_TEXT, _wav(0, 1.0), "spk1")
    japi.save_spkinfo()
    return japi, _port_api(model_dir, japi)


def _hold(japi_out, api_out, label):
    """The JAX API's chunks against the port's: the same chunk count and
    lengths, wavs within ATOL; the port's tokens (the JAX API yields wavs
    only) are held through the wav lengths and returned."""
    assert len(api_out) == len(japi_out), f"{label}: {len(api_out)} chunks, the JAX API {len(japi_out)}"
    for i, (w, g) in enumerate(zip(japi_out, api_out)):
        w, g = w["tts_speech"], g["tts_speech"]
        assert g.shape == w.shape, f"{label} chunk {i}: {g.shape} vs {w.shape}"
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f"{label} chunk {i}")
    return np.concatenate([o["speech_tokens"] for o in api_out])


def _jax_tokens(japi, method, *args, **kw):
    """The JAX API's chunks for a request and the tokens its LM draws (in
    vc, the source tokens): its engine's tts with the LM's generators
    recorded."""
    eng, drawn = japi.engine, []
    tts = eng.tts

    def recording(**req):
        gen = req.get("source_speech_token")
        if gen is not None:
            drawn.append(np.asarray(gen))
        yield from tts(**req)

    lm_generate, lm_bistream = eng.lm.generate, eng.lm.generate_bistream

    def rec(fn):
        def wrapped(*a, **k):
            for block in fn(*a, **k):
                drawn.append(np.asarray(block))
                yield block
        return wrapped

    eng.tts, eng.lm.generate, eng.lm.generate_bistream = recording, rec(lm_generate), rec(lm_bistream)
    try:
        out = list(getattr(japi, method)(*args, **kw))
    finally:
        del eng.tts
        eng.lm.generate, eng.lm.generate_bistream = lm_generate, lm_bistream
    return out, (np.concatenate(drawn).astype(np.int32) if drawn else np.zeros(0, np.int32))


REQUESTS = {
    "zero_shot": ("inference_zero_shot", (TEXT, PROMPT_TEXT, "wav0"), {}),
    "zero_shot_stream": ("inference_zero_shot", (TEXT, PROMPT_TEXT, "wav0"), {"stream": True}),
    "cross_lingual": ("inference_cross_lingual", (TEXT, "wav0"), {}),
    "instruct2": ("inference_instruct2", (TEXT, "Speak slowly.", "wav0"), {}),
    "vc": ("inference_vc", ("wav1", "wav0"), {}),
    "sft": ("inference_sft", (TEXT, "spk1"), {}),
    "speed": ("inference_zero_shot", (TEXT, PROMPT_TEXT, "wav0"), {"speed": 1.5}),
    "two_segments": ("inference_zero_shot", (TWO_SEGMENTS, PROMPT_TEXT, "wav0"), {}),
    "generator_text": ("inference_zero_shot", ("gen", PROMPT_TEXT, "wav0"), {}),
}


def _args(args):
    wavs = {"wav0": lambda: _wav(0, 1.0), "wav1": lambda: _wav(1, 0.6),
            "gen": lambda: iter(["Hi there, ", "my ", "friend."])}
    return [wavs[a]() if isinstance(a, str) and a in wavs else a for a in args]


@pytest.mark.parametrize("name", list(REQUESTS))
def test_request_matches_jax_api(apis, name):
    japi, api = apis
    method, args, kw = REQUESTS[name]
    want, want_tokens = _jax_tokens(japi, method, *_args(args), **kw)
    got = list(getattr(api, method)(*_args(args), **kw))
    tokens = _hold(want, got, name)
    assert len(tokens) > 0
    np.testing.assert_array_equal(tokens, want_tokens)
    if name == "vc":
        np.testing.assert_array_equal(tokens, api.frontend._extract_speech_token(_wav(1, 0.6)))
    if name == "two_segments":
        assert len(api.frontend.text_normalize(TWO_SEGMENTS)) == len(got) == 2
    if name == "speed":
        (base,) = list(api.inference_zero_shot(TEXT, PROMPT_TEXT, _wav(0, 1.0)))
        assert got[0]["tts_speech"].shape[1] == int(len(tokens) * 2 / 1.5) * 480 < base["tts_speech"].shape[1]


def test_speed_raises_when_streaming(apis):
    _, api = apis
    with pytest.raises(ValueError, match="non-stream"):
        list(api.inference_zero_shot(TEXT, PROMPT_TEXT, _wav(0, 1.0), stream=True, speed=1.5))


def test_prompt_cache_hit_skips_s3_and_campplus(apis):
    _, api = apis
    fe = api.frontend
    calls = []
    hooks = [m.register_forward_hook(lambda *a, name=name: calls.append(name))
             for name, m in (("s3", fe.speech_tokenizer), ("campplus", fe.campplus))]
    try:
        wav = _wav(5, 0.8)
        first = fe.frontend_zero_shot(TEXT, PROMPT_TEXT, wav)
        assert sorted(calls) == ["campplus", "s3"]
        second = fe.frontend_zero_shot("Other text.", PROMPT_TEXT, wav.copy())
        assert sorted(calls) == ["campplus", "s3"]
        fe.frontend_zero_shot(TEXT, "Another prompt.", wav)
        assert len(calls) == 4
    finally:
        for h in hooks:
            h.remove()
    for key in ("llm_prompt_speech_token", "prompt_speech_feat", "flow_embedding"):
        np.testing.assert_array_equal(first[key], second[key])
    assert first["prompt_speech_feat"].shape[1] == 2 * len(first["flow_prompt_speech_token"])


def test_spk2info_round_trip(apis, tmp_path):
    japi, api = apis
    assert api.list_available_spks() == japi.list_available_spks() == ["spk1"]
    api.add_zero_shot_spk(PROMPT_TEXT, _wav(0, 1.0), "spk2")
    api.frontend.save_spkinfo(str(tmp_path / "spk2info.pkl"))
    with open(tmp_path / "spk2info.pkl", "rb") as f:
        saved = pickle.load(f)
    for key, want in saved["spk1"].items():
        got = saved["spk2"][key]
        assert type(got) is type(want) and got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=key)


def test_config_json_model_dir_builds_the_named_architecture(apis):
    _, api = apis
    assert api.lm.cfg.qwen.hidden_size == 32 and api.lm.cfg.qwen.dtype == torch.float32
    assert api.lm.cfg.top_k == 1 and api.flow.cfg.estimator.channels == (32,)
    assert api.hift.cfg.base_channels == 32 and api.frontend.speech_tokenizer.cfg.d_model == 64
    assert next(api.frontend.speech_tokenizer.parameters()).device.type == "cpu"


@pytest.mark.parametrize("files,version", [({"config.json": {"version": 3}}, 3), ({"config.json": {"version": 1}}, 1),
                                           ({"config.json": {}}, 2), ({"cosyvoice3.yaml": ""}, 3),
                                           ({"cosyvoice2.yaml": ""}, 2), ({"cosyvoice.yaml": ""}, 1), ({}, 2)])
def test_detect_model_version(tmp_path, files, version):
    from cosyvoice_tpu.runtime.api import detect_model_version as jdetect

    for name, content in files.items():
        (tmp_path / name).write_text(json.dumps(content) if name.endswith(".json") else content)
    assert detect_model_version(str(tmp_path)) == jdetect(str(tmp_path)) == version
    if version == 1:
        # CosyVoice-300M (A10, ported; it once raised naming A10), at the tiny v1 widths
        from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config
        from cosyvoice_tpu_torch.models.hift import HiFTConfig
        from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config
        from cosyvoice_tpu_torch.runtime.api import CosyVoice
        from tests.test_torch_common import jax_flow_v1_cfg, jax_hift_v1_cfg, jax_lm_v1_cfg, to_port_cfg

        api = AutoModel(str(tmp_path), device="cpu", lm_cfg=to_port_cfg(jax_lm_v1_cfg(), LMv1Config),
                        flow_cfg=to_port_cfg(jax_flow_v1_cfg(), FlowV1Config),
                        hift_cfg=to_port_cfg(jax_hift_v1_cfg(), HiFTConfig))
        assert type(api) is CosyVoice and api.sample_rate == 22050 and api.hift.cfg.sinegen_type == "1"
    elif version == 3:
        # CosyVoice3 (A9, ported), at the tiny v3 widths
        from cosyvoice_tpu_torch.models.flow import FlowConfig
        from cosyvoice_tpu_torch.models.hift import HiFTConfig
        from cosyvoice_tpu_torch.models.llm import LMConfig
        from cosyvoice_tpu_torch.runtime.api import CosyVoice3
        from tests.test_torch_common import jax_dit_flow_cfg, jax_hift_cfg_v3, jax_lm_cfg_v3, to_port_cfg

        api = AutoModel(str(tmp_path), device="cpu", lm_cfg=to_port_cfg(jax_lm_cfg_v3(), LMConfig),
                        flow_cfg=to_port_cfg(jax_dit_flow_cfg(), FlowConfig),
                        hift_cfg=to_port_cfg(jax_hift_cfg_v3(), HiFTConfig))
        assert type(api) is CosyVoice3 and api.lm.cfg.special_in_speech_table and api.hift.cfg.causal


def test_automodel_builds_cosyvoice2_from_config_json(tmp_path):
    api = AutoModel(_write_dir(tmp_path), device="cpu")
    assert type(api) is CosyVoice2 and api.lm.cfg.qwen.hidden_size == 32


def test_constructor_signature_matches_jax_api():
    """The port's CosyVoice2.__init__ takes the JAX one's parameters in the
    same order with the same defaults (fp16 second, accepted and unused),
    and one more at the end: device."""
    def params(cls):
        return [(p.name, p.kind, p.default) for p in inspect.signature(cls.__init__).parameters.values()]

    port, jax_api = params(CosyVoice2)[1:], params(JCosyVoice2)[1:]  # self apart
    assert port[:-1] == jax_api and port[1] == ("fp16", inspect.Parameter.POSITIONAL_OR_KEYWORD, False)
    assert port[-1][0] == "device"


def test_fp16_is_accepted_by_keyword_and_by_position(tmp_path):
    """CosyVoice2(dir, fp16=False) and AutoModel(dir, fp16=False) construct;
    a positional False lands on fp16, not on seed."""
    model_dir = _write_dir(tmp_path)
    api = AutoModel(model_dir, fp16=False, device="cpu")
    assert type(api) is CosyVoice2
    cfgs = dict(lm_cfg=api.lm.cfg, flow_cfg=api.flow.cfg, hift_cfg=api.hift.cfg)
    assert type(AutoModel("", fp16=False, device="cpu", **cfgs)) is CosyVoice2
    positional = CosyVoice2(model_dir, False, 7, device="cpu")
    by_name = CosyVoice2(model_dir, fp16=False, seed=7, device="cpu")
    for a, b in zip(positional.lm.module.state_dict().values(), by_name.lm.module.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("call,item", [
    (lambda api: api.enable_continuous_batching(), "A7"),
])
def test_methods_not_ported_raise(apis, call, item):
    """Each JAX API method the port lacked raised NotImplementedError naming
    its ROADMAP item. A7 (continuous batching) is ported now: the call
    starts a scheduler, and a second call, or set_sampling after it, raises
    RuntimeError (tests/test_torch_batch_scheduler.py serves through it)."""
    api = apis[1]
    sched = call(api)
    try:
        assert item == "A7" and api.engine.scheduler is sched and sched._thread.is_alive()
        with pytest.raises(RuntimeError, match="already enabled"):
            call(api)
        with pytest.raises(RuntimeError, match="before enable_continuous_batching"):
            api.set_sampling(top_k=5)
    finally:
        sched.stop()
        api.engine.scheduler = None


@pytest.mark.parametrize("quant_lm", [True, "int8", "int4"])
def test_quant_lm_not_ported_raises(tmp_path, quant_lm):
    """The weight modes that once raised NotImplementedError (ROADMAP A8)
    are ported: the API builds the mode's LM (True is "int8", as in the JAX
    API) from the fp tree and synthesises; an unknown mode raises
    ValueError. tests/test_torch_quant_modes.py and
    tests/test_torch_api_v1.py hold these LMs against the JAX package."""
    from cosyvoice_tpu_torch.models.qwen2 import QuantDense, QuantDense4

    model_dir = _write_dir(tmp_path)
    api = CosyVoice2(model_dir, quant_lm=quant_lm, device="cpu")
    mode = "int8" if quant_lm is True else quant_lm
    assert api.lm.cfg.qwen.quant == mode
    cls = QuantDense4 if mode == "int4" else QuantDense
    assert isinstance(api.lm.module.llm.layers[0].self_attn.qkv_proj, cls)
    (out,) = api.inference_cross_lingual("Hi.", _wav(1, 1.0), text_frontend=False)
    assert out["tts_speech"].shape[1] > 0 and np.isfinite(out["tts_speech"]).all()
    with pytest.raises(ValueError, match="int2"):
        CosyVoice2(model_dir, quant_lm="int2", device="cpu")


def test_int4p_api_matches_jax_api(tmp_path, monkeypatch):
    """quant_lm="int4p" over a bf16 arena: the port's decode steps take K7's
    plain version, the JAX LM's Pallas kernel in interpret mode (as in
    tests/test_torch_engine.py). Widths of the int4 layouts, the S3 FSQ's
    6561 ids and room for the byte ids and specials."""
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    cfg = json.loads(json.dumps(CONFIG))
    cfg["llm"]["qwen"].update(hidden_size=384, num_heads=6, num_kv_heads=2, head_dim=64, intermediate_size=448,
                              max_cache_len=256)
    model_dir = _write_dir(tmp_path, cfg)
    japi = _jax_api(model_dir, quant_lm="int4p")
    api = _port_api(model_dir, japi, quant_lm="int4p")
    assert api.lm.cfg.qwen.quant == "int4p" and not api.lm.cfg.qwen.kv_quant
    steps, fused = api.lm.decode_steps, api.lm.fused_steps
    want, want_tokens = _jax_tokens(japi, "inference_zero_shot", "Hi.", PROMPT_TEXT, _wav(0, 1.0))
    got = list(api.inference_zero_shot("Hi.", PROMPT_TEXT, _wav(0, 1.0)))
    np.testing.assert_array_equal(_hold(want, got, "int4p"), want_tokens)
    assert api.lm.fused_steps - fused == api.lm.decode_steps - steps > 0
