"""Model dirs with checkpoints through the public API, CPU, float32: a
tiny config.json dir (tests/test_torch_api.py's widths) with synthetic Qwen
tokenizer assets (tests/test_torch_bpe.py) and the five checkpoints
written by the JAX package's `save_pretrained`. The JAX `CosyVoice2(dir)`
and the port's `CosyVoice2(dir, device="cpu")` load the same weights (every
port parameter equals the JAX tree) and the same text ids, and give the
same tokens for a greedy zero-shot request, with wavs within
tests/test_torch_api.py's ATOL. The port's `save_pretrained` writes files
the JAX API loads to the same tokens and wav. A dir with some checkpoints
loads those and seeds the rest; a checkpoint that does not match its
module raises. `quant_lm="int4p"` from a checkpoint:
tests/test_torch_checkpoint_int4p.py.

As in tests/test_torch_api.py, both APIs' CAM++ is tiny (the default
config's name patched in each package's frontend while an API is built:
the JAX package's full CAM++ takes ~30 s to initialise on the CPU), the
LMs decode greedily, the stop logit is raised by EOS_BIAS (in the saved
weights) and the HiFT source is pinned by its saved weights."""

import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosyvoice_tpu.frontend.frontend as jfrontend
import cosyvoice_tpu.models.campplus as jcampplus
import cosyvoice_tpu_torch.frontend.frontend as pfrontend
from cosyvoice_tpu.models.campplus import CamPPConfig as JCamPPConfig
from cosyvoice_tpu.runtime.api import CosyVoice2 as JCosyVoice2
from cosyvoice_tpu_torch.convert import export_params
from cosyvoice_tpu_torch.models.campplus import CamPPConfig
from cosyvoice_tpu_torch.runtime.api import CHECKPOINTS, CosyVoice2
from tests.test_torch_api import CAM, CONFIG, EOS_BIAS, PROMPT_TEXT, _hold, _jax_tokens, _wav, _write_dir
from tests.test_torch_bpe import write_tokenizer
from tests.test_torch_checkpoint import assert_same_tree
from tests.test_torch_common import np_tree

torch.set_num_threads(1)

TEXT = "Hello there, my friend."


def _config(**qwen):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["llm"]["qwen"].update(vocab_size=512, **qwen)  # room for the BPE's ids and the specials
    return cfg


def _jax_api(model_dir, **kw):
    """The JAX API from model_dir, its CAM++ tiny."""
    cls = jcampplus.CamPPEmbedding
    tiny = lambda: cls(JCamPPConfig(**CAM))  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfrontend, "CamPPEmbedding", tiny)
        mp.setattr(jcampplus, "CamPPEmbedding", tiny)
        return JCosyVoice2(str(model_dir), **kw)


def _port_api(model_dir, **kw):
    """The port's API from model_dir, its CAM++ tiny."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pfrontend, "CamPPConfig", lambda: CamPPConfig(**CAM))
        return CosyVoice2(str(model_dir), device="cpu", **kw)


def _model_dir(path, config):
    """config.json and the tokenizer assets (tokenizer/), no checkpoint."""
    _write_dir(path, config)
    write_tokenizer(os.path.join(path, "tokenizer"), n_merges=200)
    return str(path)


def _pin(japi):
    """Raise the stop logit by EOS_BIAS and pin the HiFT source, in the JAX
    API's params (what save_pretrained then writes)."""
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


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A model dir whose five checkpoints the JAX API saved, and the JAX
    API and the port's API loaded from it."""
    model_dir = _model_dir(tmp_path_factory.mktemp("model"), _config())
    japi = _jax_api(model_dir, seed=7)
    _pin(japi)
    japi.save_pretrained(model_dir)
    assert sorted(f for f in os.listdir(model_dir) if f.endswith(".msgpack")) == sorted(
        f"{n}.msgpack" for n in CHECKPOINTS)
    return model_dir, _jax_api(model_dir), _port_api(model_dir)


def _zero_shot(api, jax_api=None):
    args = (TEXT, PROMPT_TEXT, _wav(0, 1.0))
    return _jax_tokens(api, "inference_zero_shot", *args) if jax_api else list(api.inference_zero_shot(*args))


def test_jax_saved_dir_loads_in_the_port(saved):
    """Every parameter the port loaded equals the JAX API's tree; both
    tokenise with the Qwen BPE; a greedy zero-shot request gives the same
    tokens and wavs within ATOL."""
    _, japi, api = saved
    fe, jfe = api.frontend, japi.frontend
    for module, tree in ((api.lm.module, japi.lm_params), (api.flow, japi.flow_params), (api.hift, japi.hift_params),
                         (fe.speech_tokenizer, jfe.speech_tokenizer_params), (fe.campplus, jfe.campplus_params)):
        assert_same_tree(export_params(module), np_tree(tree))
    assert type(fe.tokenizer).__name__ == type(jfe.tokenizer).__name__ == "QwenTokenizer"
    assert fe.tokenizer.encode(TEXT) == jfe.tokenizer.encode(TEXT) and len(fe.tokenizer.encode(TEXT)) < len(TEXT)
    want, want_tokens = _zero_shot(japi, jax_api=True)
    tokens = _hold(want, _zero_shot(api), "zero-shot from checkpoints")
    np.testing.assert_array_equal(tokens, want_tokens)
    assert len(tokens) > 0


def test_port_save_pretrained_loads_in_the_jax_api(saved, tmp_path):
    """The port's save_pretrained of the loaded API: the JAX API reads the
    five files to the same trees, and its request gives the port's tokens
    and wav."""
    model_dir, japi, api = saved
    out = tmp_path / "saved"
    api.save_pretrained(str(out))
    shutil.copy(os.path.join(model_dir, "config.json"), out / "config.json")
    shutil.copytree(os.path.join(model_dir, "tokenizer"), out / "tokenizer")
    again = _jax_api(out)
    for a, b in ((again.lm_params, japi.lm_params), (again.flow_params, japi.flow_params),
                 (again.hift_params, japi.hift_params),
                 (again.frontend.speech_tokenizer_params, japi.frontend.speech_tokenizer_params),
                 (again.frontend.campplus_params, japi.frontend.campplus_params)):
        assert_same_tree(np_tree(a), np_tree(b))
    want, want_tokens = _zero_shot(again, jax_api=True)
    np.testing.assert_array_equal(_hold(want, _zero_shot(api), "port save, JAX load"), want_tokens)


def test_partly_filled_dir_loads_what_is_there_and_seeds_the_rest(saved, tmp_path, caplog):
    model_dir, japi, _ = saved
    part = tmp_path / "part"
    part.mkdir()
    for name in ("config.json", "lm.msgpack", "campplus.msgpack"):
        shutil.copy(os.path.join(model_dir, name), part / name)
    with caplog.at_level(logging.WARNING):
        api = _port_api(part, seed=11)
    warned = [r.getMessage() for r in caplog.records]
    seeded = _port_api(_write_dir(tmp_path / "none", _config()), seed=11)
    assert_same_tree(export_params(api.lm.module), np_tree(japi.lm_params))
    assert_same_tree(export_params(api.frontend.campplus), np_tree(japi.frontend.campplus_params))
    for a, b in ((api.flow, seeded.flow), (api.hift, seeded.hift),
                 (api.frontend.speech_tokenizer, seeded.frontend.speech_tokenizer)):
        assert_same_tree(export_params(a), export_params(b))
    assert any("no checkpoint for flow" in m for m in warned) and any("no checkpoint for hift" in m for m in warned)
    assert not any("no checkpoint for lm" in m for m in warned)
    assert type(api.frontend.tokenizer).__name__ == "ByteFallbackTokenizer"  # no tokenizer assets in this dir


def test_mismatched_checkpoint_raises(saved, tmp_path):
    """A flow.msgpack of another architecture raises; nothing serves random
    weights in its place."""
    model_dir, _, _ = saved
    cfg = _config()
    cfg["flow"]["linear_units"] = 32
    _write_dir(tmp_path, cfg)
    shutil.copy(os.path.join(model_dir, "flow.msgpack"), tmp_path / "flow.msgpack")
    with pytest.raises(ValueError, match="shape"):
        _port_api(tmp_path)
