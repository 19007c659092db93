"""The port's CosyVoice-300M API (runtime/api.py:CosyVoice) against the JAX
package's CosyVoice, CPU, float32: both built from one model dir (a
config.json of version 1 at tiny widths, a VQ-4096 S3 at 50 Hz, and a
`.tiktoken` vocab written by the test, so that AutoModel picks the class
and the v1 tokenizer runs), every tree carried from the JAX API. The LMs
decode greedily with the eos logit raised (EOS_BIAS), the HiFT source is
pinned by configuration (no noise, the fundamental alone), and the JAX
flow noise of each window is handed to the port (`engine.flow_noise`).
Text and a 16 kHz prompt wav go in; the wavs agree within 1e-3 for
zero-shot (offline and streamed), cross-lingual, vc, sft from a speaker
the JAX API saved, and instruct (the LM with the zero speaker row: the
JAX engine called with it, ROADMAP C4). Also AutoModel on a version-1
dir and a cosyvoice.yaml dir, `llm_embedding` in sft from a released
spk2info entry, and save_pretrained reloading bit for bit."""

import base64
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosyvoice_tpu.frontend.frontend as jfrontend
from cosyvoice_tpu.models.campplus import CamPPConfig as JCamPPConfig
from cosyvoice_tpu.models.campplus import CamPPEmbedding as JCamPPEmbedding
from cosyvoice_tpu.runtime.api import CosyVoice as JCosyVoice
from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
from cosyvoice_tpu_torch.runtime.api import AutoModel, CosyVoice
from tests.test_torch_checkpoint import assert_same_tree
from tests.test_torch_common import np_tree

torch.set_num_threads(1)

ATOL = 1e-3
CAM = dict(blocks=((2, 3, 1), (2, 3, 2), (2, 3, 2)))
EOS_BIAS = 1.0
SEED = 1986
TEXT, PROMPT_TEXT = "hello there my friend", "a cue"

CONFIG = {
    "version": 1,
    "llm": {"text_encoder_input_size": 16, "llm_input_size": 32, "llm_output_size": 32, "text_token_size": 2048,
            "speech_token_size": 4096, "te_heads": 2, "te_linear_units": 32, "te_blocks": 1, "lm_heads": 2,
            "lm_linear_units": 32, "lm_blocks": 2, "max_cache_len": 1024, "block_size": 8, "top_k": 1,
            "tau_r": 2.0},
    "flow": {"input_size": 16, "vocab_size": 4096, "attention_heads": 2, "linear_units": 32, "num_blocks": 1,
             "regulator_ratios": [1],
             "estimator": {"channels": [16, 16], "attention_head_dim": 8, "n_blocks": 1, "num_mid_blocks": 1,
                           "num_heads": 2, "causal": False},
             "cfm": {"n_timesteps": 2}},
    "hift": {"base_channels": 32, "sampling_rate": 22050, "upsample_rates": [8, 8], "upsample_kernel_sizes": [16, 16],
             "resblock_kernel_sizes": [3], "resblock_dilations": [[1]], "source_resblock_kernel_sizes": [7, 11],
             "source_resblock_dilations": [[1], [1]], "nsf_sigma": 0.0, "nsf_voiced_threshold": -1.0},
    "frontend": {"s3": {"d_model": 64, "num_heads": 4, "num_layers": 2, "codebook_size": 4096, "use_fsq": False,
                        "token_rate_div": 1}},
}


def _wav(seed, seconds):
    return (np.random.default_rng(seed).standard_normal((1, int(16000 * seconds))) * 0.1).astype(np.float32)


def write_v1_dir(path, config=CONFIG):
    """A version-1 model dir: config.json and a .tiktoken vocab of the 256
    bytes and some merges of lower-case English."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    merges = [b"he", b"ll", b"hell", b"hello", b" t", b"th", b" th", b"er", b"ere", b" f", b"fr", b"ie", b"nd"]
    lines = [f"{base64.b64encode(bytes([b])).decode()} {b}" for b in range(256)]
    lines += [f"{base64.b64encode(m).decode()} {256 + i}" for i, m in enumerate(merges)]
    with open(os.path.join(path, "vocab.tiktoken"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def _jax_api(model_dir):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfrontend, "CamPPEmbedding", lambda: JCamPPEmbedding(JCamPPConfig(**CAM)))
        japi = JCosyVoice(model_dir, seed=SEED)
    lm = np_tree(japi.lm_params)
    head = lm["params"]["llm_decoder"]
    head["bias"] = head["bias"].copy()
    head["bias"][japi.lm.cfg.speech_token_size] += EOS_BIAS
    japi.lm_params = japi.engine.lm_params = jax.tree.map(jnp.asarray, lm)
    hift = np_tree(japi.hift_params)
    w = hift["params"]["m_source"]["l_linear"]["kernel"].copy()
    w[0, 0], w[1:, 0] = 1.5, 0.0  # the fundamental alone: its phase starts at 0
    hift["params"]["m_source"]["l_linear"]["kernel"] = w
    japi.hift_params = japi.engine.hift_params = jax.tree.map(jnp.asarray, hift)
    return japi


def _port_api(model_dir, japi):
    api = AutoModel(model_dir, device="cpu")
    assert type(api) is CosyVoice
    fe = api.frontend
    fe.campplus = CamPPEmbedding(CamPPConfig(**CAM))
    load_jax_params(api.lm.module, np_tree(japi.lm_params["params"]))
    load_jax_params(api.flow, np_tree(japi.flow_params))
    load_jax_params(api.hift, np_tree(japi.hift_params["params"]))
    load_jax_params(fe.speech_tokenizer, np_tree(japi.frontend.speech_tokenizer_params["params"]))
    load_jax_params(fe.campplus, np_tree(japi.frontend.campplus_params["params"]))
    api.engine.flow_noise = lambda i, T: torch.from_numpy(
        np.array(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(SEED), i), (1, T, 80))))
    return api


@pytest.fixture(scope="module")
def apis(tmp_path_factory):
    model_dir = write_v1_dir(tmp_path_factory.mktemp("v1model"))
    japi = _jax_api(model_dir)
    japi.add_zero_shot_spk(PROMPT_TEXT, _wav(0, 1.0), "spk1")
    japi.save_spkinfo()
    return japi, _port_api(model_dir, japi)


def _hold(want, got, label):
    assert len(got) == len(want), f"{label}: {len(got)} chunks, the JAX API {len(want)}"
    for i, (w, g) in enumerate(zip(want, got)):
        assert g["tts_speech"].shape == w["tts_speech"].shape, f"{label} chunk {i}"
        assert np.isfinite(g["tts_speech"]).all()
        np.testing.assert_allclose(g["tts_speech"], w["tts_speech"], rtol=0, atol=ATOL, err_msg=f"{label} chunk {i}")


def _small_hops(*engines):
    from tests.test_torch_engine_v1 import _small

    for eng in engines:
        _small(eng)


REQUESTS = {
    "zero_shot": ("inference_zero_shot", (TEXT, PROMPT_TEXT, "wav0"), {}),
    "zero_shot_stream": ("inference_zero_shot", (TEXT, PROMPT_TEXT, "wav0"), {"stream": True}),
    "cross_lingual": ("inference_cross_lingual", (TEXT, "wav0"), {}),
    "vc": ("inference_vc", ("wav1", "wav0"), {}),
    "sft": ("inference_sft", (TEXT, "spk1"), {}),
    "speed": ("inference_zero_shot", (TEXT, PROMPT_TEXT, "wav0"), {"speed": 1.5}),
}


def _args(args):
    wavs = {"wav0": lambda: _wav(0, 1.0), "wav1": lambda: _wav(1, 0.6)}
    return [wavs[a]() if a in wavs else a for a in args]


@pytest.mark.parametrize("name", list(REQUESTS))
def test_request_matches_jax_api(apis, name):
    japi, api = apis
    method, args, kw = REQUESTS[name]
    _small_hops(japi.engine, api.engine)
    want = list(getattr(japi, method)(*_args(args), **kw))
    got = list(getattr(api, method)(*_args(args), **kw))
    _hold(want, got, name)
    if kw.get("stream"):
        assert len(got) >= 2


def test_instruct_matches_jax_engine_with_the_zero_speaker(apis):
    """inference_instruct: the LM's prompt text is instruct + <endofprompt>,
    no prompt speech and the zero x-vector row; the flow keeps the
    speaker's prompt. The JAX API's own instruct hands the LM the flow's
    x-vector through its engine's fallback, so the reference here is the
    JAX engine called with llm_embedding zeros."""
    japi, api = apis
    info = japi.frontend.spk2info["spk1"]
    instruct = "Speak slowly."
    mi = dict(info)
    (seg,) = japi.frontend.text_normalize(TEXT, split=True)
    mi["text_tokens"] = japi.frontend._extract_text_token(seg)
    mi["prompt_text_tokens"] = japi.frontend._extract_text_token(instruct + "<endofprompt>")
    mi["llm_prompt_speech_token"] = np.zeros(0, np.int32)
    want = list(japi.engine.tts(**mi, llm_embedding=np.zeros((1, 192), np.float32)))
    got = list(api.inference_instruct(TEXT, "spk1", instruct))
    _hold(want, got, "instruct")
    ids = api.frontend._extract_text_token(instruct + "<endofprompt>")
    np.testing.assert_array_equal(ids, mi["prompt_text_tokens"])


def test_released_speaker_entry_conditions_both(apis):
    """A released spk2info entry (an 'embedding' x-vector alone) conditions
    the LM and the flow on it, as the reference's frontend_sft does."""
    japi, api = apis
    emb = np.asarray(japi.frontend.spk2info["spk1"]["flow_embedding"], np.float32)
    api.frontend.spk2info["released"] = {"embedding": emb[0]}
    try:
        (got,) = list(api.inference_sft(TEXT, "released"))
    finally:
        del api.frontend.spk2info["released"]
    (seg,) = japi.frontend.text_normalize(TEXT, split=True)
    tokens = japi.frontend._extract_text_token(seg)
    want = list(japi.engine.tts(text_tokens=tokens, prompt_text_tokens=np.zeros(0, np.int32),
                                llm_prompt_speech_token=np.zeros(0, np.int32),
                                flow_prompt_speech_token=np.zeros(0, np.int32),
                                prompt_speech_feat=np.zeros((1, 0, 80), np.float32), flow_embedding=emb,
                                llm_embedding=emb))
    _hold(want, [got], "released sft")


def test_tokenizer_is_the_v1_tiktoken(apis):
    japi, api = apis
    assert type(api.frontend.tokenizer).__name__ == "TiktokenBPE"
    for text in (TEXT, "<|en|>hello<|endoftext|>", "ninety-nine 99"):
        assert api.frontend.tokenizer.encode(text) == japi.frontend.tokenizer.encode(text)


def test_automodel_picks_v1_by_yaml_name(tmp_path):
    """A dir with the reference's cosyvoice.yaml and no config.json: AutoModel
    builds CosyVoice at the full-width default configs (made on the meta
    device here: only the classes and configs are held)."""
    from cosyvoice_tpu_torch.runtime import api as papi

    (tmp_path / "cosyvoice.yaml").write_text("")
    seen = {}

    def fake_init(self, model_dir="", **kw):
        seen.update(model_dir=model_dir, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(papi.CosyVoice, "__init__", fake_init)
        api = AutoModel(str(tmp_path), device="cpu")
    assert type(api) is CosyVoice and seen == {"model_dir": str(tmp_path), "device": "cpu"}


def test_v1_refuses_the_qwen_only_methods(apis):
    _, api = apis
    for call in (lambda: api.set_sampling(top_k=5), lambda: api.enable_continuous_batching(),
                 lambda: list(api.inference_instruct2(TEXT, "x", _wav(0, 1.0)))):
        with pytest.raises(NotImplementedError):
            call()


def test_save_pretrained_round_trip(apis, tmp_path):
    """save_pretrained writes the five trees; CosyVoice(out) (with the
    source dir's config.json and vocab) reloads the LM, flow, HiFT and S3
    bit for bit (the tiny CAM++ file is dropped: the API builds the full
    one)."""
    _, api = apis
    out = write_v1_dir(tmp_path / "saved")
    api.save_pretrained(out)
    assert sorted(os.listdir(out)) == ["campplus.msgpack", "config.json", "flow.msgpack", "hift.msgpack",
                                       "lm.msgpack", "speech_tokenizer.msgpack", "vocab.tiktoken"]
    os.remove(os.path.join(out, "campplus.msgpack"))
    again = CosyVoice(out, device="cpu")
    for a, b in ((api.lm.module, again.lm.module), (api.flow, again.flow), (api.hift, again.hift),
                 (api.frontend.speech_tokenizer, again.frontend.speech_tokenizer)):
        assert_same_tree(export_params(b), export_params(a))


def test_build_model_configs_matches_jax():
    """utils/config.py's v1 builders against the JAX ones: config.json's
    version-1 sections (CONFIG), and an empty version-1 dict (the defaults)."""
    from cosyvoice_tpu.utils.config import build_model_configs as jbuild
    from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config
    from cosyvoice_tpu_torch.models.hift import HiFTConfig
    from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config
    from cosyvoice_tpu_torch.utils.config import build_model_configs
    from tests.test_torch_common import to_port_cfg

    for cfg in (CONFIG, {"version": 1}):
        got, want = build_model_configs(cfg), jbuild(cfg)
        assert got == tuple(to_port_cfg(w, c) for w, c in zip(want, (LMv1Config, FlowV1Config, HiFTConfig)))
    assert build_model_configs({"version": 1})[1].estimator.channels == (256, 256)


def test_load_config_reads_the_dir(tmp_path):
    from cosyvoice_tpu_torch.utils.config import load_config

    path = write_v1_dir(tmp_path)
    assert load_config(os.path.join(path, "config.json")) == CONFIG
