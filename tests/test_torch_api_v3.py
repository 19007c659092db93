"""The port's CosyVoice3 API against the JAX package's, CPU, float32:
`CosyVoice3(model_dir, device="cpu")` and the JAX `CosyVoice3` built from
one config.json of version 3 (tiny v3 widths: the v3 LM layout, the DiT
flow, the causal HiFT, a tiny S3), every tree carried from the JAX API.
Text and a 16 kHz prompt wav go in; the wavs must agree within 1e-3 for
zero-shot offline and streamed and for instruct2; AutoModel returns a
CosyVoice3 for the dir, whose frontend has the v3 special tokens, and
instruct2 refuses a stray <|endofprompt|>.

The LMs decode greedily, the head's special columns scaled up so that each
request stops when min_len lets it; the port's causal source is handed the
JAX noise buffer (ROADMAP C4). The JAX CAM++ is patched tiny as in
tests/test_torch_api.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosyvoice_tpu.frontend.frontend as jfrontend
from cosyvoice_tpu.models.campplus import CamPPConfig as JCamPPConfig
from cosyvoice_tpu.models.campplus import CamPPEmbedding as JCamPPEmbedding
from cosyvoice_tpu.runtime.api import CosyVoice3 as JCosyVoice3
from cosyvoice_tpu_torch.convert import load_jax_params
from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
from cosyvoice_tpu_torch.runtime.api import AutoModel, CosyVoice3
from cosyvoice_tpu_torch.runtime.engine import CosyVoice3Engine
from tests.test_torch_api import ATOL, CAM, PROMPT_TEXT, _hold, _wav, _write_dir
from tests.test_torch_common import jax_causal_noise, np_tree

torch.set_num_threads(1)

TEXT = "Hello there."
STOP_SCALE = 4.0  # the head's special columns, scaled: a stop wins once min_len allows it

CONFIG_V3 = {
    "version": 3,
    "llm": {"speech_token_size": 6561, "num_special_head": 200, "special_in_speech_table": True, "block_size": 8,
            "top_k": 1, "tau_r": 2.0,
            "qwen": {"hidden_size": 32, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                     "intermediate_size": 64, "vocab_size": 300, "max_cache_len": 2048, "dtype": "float32"}},
    "flow": {"input_size": 80, "vocab_size": 6561, "chunk_size": 5, "encoder_type": "dit_prelookahead",
             "estimator_type": "dit", "dit_lookahead_channels": 32,
             "dit": {"dim": 32, "depth": 1, "heads": 2, "dim_head": 8, "static_chunk_size": 10, "freq_embed_dim": 16},
             "cfm": {"n_timesteps": 2}},
    "hift": {"base_channels": 32, "causal": True, "resblock_kernel_sizes": [3], "resblock_dilations": [[1]],
             "source_resblock_kernel_sizes": [7, 7, 11], "source_resblock_dilations": [[1], [1], [1]]},
    "frontend": {"s3": {"d_model": 64, "num_heads": 4, "num_layers": 2}},
}


@pytest.fixture(scope="module")
def apis(tmp_path_factory):
    model_dir = _write_dir(tmp_path_factory.mktemp("model3"), CONFIG_V3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfrontend, "CamPPEmbedding", lambda: JCamPPEmbedding(JCamPPConfig(**CAM)))
        japi = JCosyVoice3(model_dir)
    lm = np_tree(japi.lm_params)
    head = lm["params"]["llm_decoder"]
    head["kernel"] = head["kernel"].copy()
    head["kernel"][:, japi.lm.cfg.speech_token_size :] *= STOP_SCALE
    japi.lm_params = japi.engine.lm_params = jax.tree.map(jnp.asarray, lm)
    japi.engine.token_hop_len, japi.engine.token_max_hop_len = 5, 20

    api = CosyVoice3(model_dir, device="cpu")
    fe = api.frontend
    fe.campplus = CamPPEmbedding(CamPPConfig(**CAM))
    load_jax_params(api.lm.module, np_tree(japi.lm_params["params"]))
    load_jax_params(api.flow, np_tree(japi.flow_params))
    load_jax_params(api.hift, np_tree(japi.hift_params["params"]))
    load_jax_params(fe.speech_tokenizer, np_tree(japi.frontend.speech_tokenizer_params["params"]))
    load_jax_params(fe.campplus, np_tree(japi.frontend.campplus_params["params"]))
    api.hift.noise_buffer = jax_causal_noise()
    return model_dir, japi, api


def test_cosyvoice3_builds_the_v3_parts(apis):
    model_dir, _, api = apis
    assert isinstance(api.engine, CosyVoice3Engine) and api.version == 3
    assert api.lm.cfg.special_in_speech_table and api.lm.module.llm_decoder.bias is None
    assert api.flow.cfg.estimator_type == "dit" and api.hift.cfg.causal
    # the version-3 frontend: one id for a v3 special token
    assert len(api.frontend.tokenizer.encode("[breath]")) == 1
    assert type(AutoModel(model_dir, device="cpu")) is CosyVoice3


@pytest.mark.parametrize("stream", [False, True], ids=["offline", "streamed"])
def test_zero_shot_matches_jax(apis, stream):
    _, japi, api = apis
    wav = _wav(1, 1.5)
    want = list(japi.inference_zero_shot(TEXT, PROMPT_TEXT, wav, stream=stream))
    got = list(api.inference_zero_shot(TEXT, PROMPT_TEXT, wav, stream=stream))
    tokens = _hold(want, got, f"zero-shot stream={stream}")
    assert len(tokens) >= 2 * len(TEXT.encode())
    assert sum(o["tts_speech"].shape[1] for o in got) == len(tokens) * 960
    if stream:
        assert len(got) >= 3


def test_instruct2_matches_jax_and_refuses_a_stray_delimiter(apis):
    _, japi, api = apis
    wav = _wav(2, 1.0)
    want = list(japi.inference_instruct2(TEXT, "Speak slowly.", wav))
    got = list(api.inference_instruct2(TEXT, "Speak slowly.", wav))
    _hold(want, got, "instruct2")
    with pytest.raises(AssertionError):
        list(japi.inference_instruct2(TEXT, "Slowly<|endofprompt|>", wav))
    with pytest.raises(ValueError, match="endofprompt"):
        list(api.inference_instruct2(TEXT, "Slowly<|endofprompt|>", wav))


def test_cosyvoice3_defaults_raise_without_a_card(monkeypatch):
    """The default device is the card: without one, CosyVoice3() raises
    before building anything at full width."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CosyVoice3()
