"""`quant_lm="int4p"` from a checkpoint, CPU: at the int4 layouts' widths,
one fp model dir (written by the port's save_pretrained, with synthetic
Qwen tokenizer assets) loaded with quant_lm="int4p" by the JAX API and the
port's: the LM trees quantised on the host are equal leaf for leaf, and a
greedy zero-shot request gives the same tokens, wavs within
tests/test_torch_api.py's ATOL, every decode step through K7's route (the
port's plain version; the JAX LM's Pallas kernel in interpret mode, with
COSY_INT4_BLOCK=force)."""

import numpy as np
import torch

from cosyvoice_tpu_torch.convert import export_params
from tests.test_torch_api import EOS_BIAS, PROMPT_TEXT, _hold, _jax_tokens, _wav
from tests.test_torch_checkpoint import assert_same_tree
from tests.test_torch_checkpoint_api import _config, _jax_api, _model_dir, _port_api
from tests.test_torch_common import np_tree

torch.set_num_threads(1)


def test_int4p_from_one_fp_dir(tmp_path, monkeypatch):
    """At the int4 layouts' widths, one fp dir (written by the port's
    save_pretrained) loaded with quant_lm="int4p" by both APIs: the LM trees
    quantised on the host are equal, and a greedy request gives the same
    tokens through K7's route."""
    monkeypatch.setenv("COSY_INT4_BLOCK", "force")
    model_dir = _model_dir(tmp_path, _config(hidden_size=384, num_heads=6, num_kv_heads=2, head_dim=64,
                                             intermediate_size=448, max_cache_len=256))
    fp = _port_api(model_dir, seed=3)
    with torch.no_grad():
        fp.lm.module.llm_decoder.bias[fp.lm.cfg.eos_token] += EOS_BIAS
    fp.save_pretrained(model_dir)
    japi, api = _jax_api(model_dir, quant_lm="int4p"), _port_api(model_dir, quant_lm="int4p")
    assert api.lm.cfg.qwen.quant == "int4p"
    assert_same_tree(export_params(api.lm.module), np_tree(japi.lm_params))
    steps, fused = api.lm.decode_steps, api.lm.fused_steps
    want, want_tokens = _jax_tokens(japi, "inference_zero_shot", "Hi.", PROMPT_TEXT, _wav(0, 1.0))
    got = list(api.inference_zero_shot("Hi.", PROMPT_TEXT, _wav(0, 1.0)))
    np.testing.assert_array_equal(_hold(want, got, "int4p from checkpoints"), want_tokens)
    assert api.lm.fused_steps - fused == api.lm.decode_steps - steps > 0
