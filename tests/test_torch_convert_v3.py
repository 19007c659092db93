"""The port's Fun-CosyVoice3 converters (tools/convert_checkpoint.py:
convert_llm_v3, convert_flow_v3, and convert_hift on the causal layout)
against the JAX ones on the same synthetic reference-shaped state dicts, bit
for bit, CPU: the LM's from a tiny `transformers.Qwen2ForCausalLM` under
llm.model. plus the v3 heads (no llm_embedding, no head bias); the DiT flow
and the causal HiFT written out from the JAX templates' paths (both
weight-norm layouts), which also gives the tree a correct converter makes
of them. A leftover or missing key raises."""

import re

import jax
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow import CausalFlow as JCausalFlow
from cosyvoice_tpu.models.hift import HiFTGenerator as JHiFT
from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
from cosyvoice_tpu_torch.tools import convert_checkpoint as pcc
from tests.test_torch_checkpoint import _leaves, assert_same_tree
from tests.test_torch_checkpoint_convert import _HIFT_RULES, _jcc, _state_from_template, _torch_key
from tests.test_torch_common import jax_dit_flow_cfg, jax_hift_cfg_v3, jax_lm_cfg_v3, np_tree, to_port_cfg

torch.set_num_threads(1)

# JAX DiT-flow template paths (after "<sub-model>/params/") -> reference flow.pt names
_FLOW_V3_RULES = [
    (r"^(input_embedding|spk_embed_affine_layer)$", r"\1"),
    (r"^pre_lookahead_layer/(conv[12])$", r"pre_lookahead_layer.\1"),
    (r"^time_embed/mlp1$", r"decoder.estimator.time_embed.time_mlp.0"),
    (r"^time_embed/mlp2$", r"decoder.estimator.time_embed.time_mlp.2"),
    (r"^input_proj$", r"decoder.estimator.input_embed.proj"),
    (r"^conv_pos/(conv[12])$", r"decoder.estimator.input_embed.conv_pos_embed.\1.0"),
    (r"^blocks_(\d+)/adaln$", r"decoder.estimator.transformer_blocks.\1.attn_norm.linear"),
    (r"^blocks_(\d+)/(to_[qkv])$", r"decoder.estimator.transformer_blocks.\1.attn.\2"),
    (r"^blocks_(\d+)/to_out$", r"decoder.estimator.transformer_blocks.\1.attn.to_out.0"),
    (r"^blocks_(\d+)/ff_in$", r"decoder.estimator.transformer_blocks.\1.ff.ff.0.0"),
    (r"^blocks_(\d+)/ff_out$", r"decoder.estimator.transformer_blocks.\1.ff.ff.2"),
    (r"^final_adaln$", r"decoder.estimator.norm_out.linear"),
    (r"^proj_out$", r"decoder.estimator.proj_out"),
]


def hf_qwen_state_v3(seed=0):
    """A tiny transformers Qwen2ForCausalLM's state dict under llm.model.,
    plus the v3 heads at jax_lm_cfg_v3()'s widths (220 speech rows, a
    head without bias)."""
    from transformers import Qwen2Config, Qwen2ForCausalLM

    cfg = jax_lm_cfg_v3()
    q = cfg.qwen
    torch.manual_seed(seed)
    hf = Qwen2ForCausalLM(Qwen2Config(vocab_size=q.vocab_size, hidden_size=q.hidden_size,
                                      intermediate_size=q.intermediate_size, num_hidden_layers=q.num_layers,
                                      num_attention_heads=q.num_heads, num_key_value_heads=q.num_kv_heads,
                                      tie_word_embeddings=False))
    sd = {f"llm.model.{k}": v.numpy() for k, v in hf.state_dict().items()}
    rng = np.random.default_rng(seed)
    V = cfg.head_size
    for k in ("speech_embedding.weight", "llm_decoder.weight"):
        sd[k] = rng.standard_normal((V, q.hidden_size)).astype(np.float32)
    return sd


def hift_state_v3(tree, rng):
    """A random reference-shaped causal hift.pt for a JAX template, and the
    tree a correct converter makes of it: every weight-normed conv (all
    plain convs, the upsampling ones too) as [out, in, k] v and [c, 1, 1]
    g, alternately in the legacy and the parametrizations layout."""
    sd, want, wn = {}, {}, {}
    for path, leaf in _leaves(tree):
        owner = _torch_key(re.sub(r"/conv$", "", "/".join(path[1:-1])), _HIFT_RULES)
        val = rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
        node = want
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = val
        name = path[-1]
        if name == "kernel":
            sd[f"{owner}.weight"] = val.T if val.ndim == 2 else val.transpose(2, 1, 0)
        elif name in ("v", "g"):
            legacy = wn.setdefault(owner, len(wn)) % 2 == 0
            t = val.transpose(2, 1, 0) if name == "v" else val.reshape(-1, 1, 1)
            sfx = ("weight_v" if name == "v" else "weight_g") if legacy else \
                "parametrizations.weight.original" + ("1" if name == "v" else "0")
            sd[f"{owner}.{sfx}"] = t
        else:
            sd[f"{owner}.{name}"] = val
    return sd, want


def templates():
    """{case: (JAX template, port template)} at the tiny v3 widths."""
    K = jax.random.PRNGKey
    lm, flow, hift = jax_lm_cfg_v3(), jax_dit_flow_cfg(), jax_hift_cfg_v3()
    import jax.numpy as jnp

    return {
        "llm": (np_tree(JQwen2LM(lm).init(K(0))),
                pcc.template(lambda: Qwen2LMModule(to_port_cfg(lm, LMConfig)))),
        "flow": (np_tree(JCausalFlow(flow).init(K(1))),
                 pcc.template(lambda: CausalFlow(to_port_cfg(flow, FlowConfig), device="meta"))),
        "hift": (np_tree(JHiFT(hift).init(K(2), jnp.zeros((1, 12, 80)), K(3))),
                 pcc.template(lambda: HiFTGenerator(to_port_cfg(hift, HiFTConfig), device="meta"))),
    }


def reference_states_v3(tmpl):
    """{case: (reference-shaped state dict, the tree it was written from or None)}."""
    rng = np.random.default_rng(0)
    return {"llm": (hf_qwen_state_v3(), None),
            "flow": _state_from_template(tmpl["flow"][0], _FLOW_V3_RULES, rng),
            "hift": hift_state_v3(tmpl["hift"][0], rng)}


@pytest.fixture(scope="module")
def cases():
    tmpl = templates()
    return tmpl, reference_states_v3(tmpl)


CONVERTERS = {"llm": "convert_llm_v3", "flow": "convert_flow_v3", "hift": "convert_hift"}


@pytest.mark.parametrize("case", list(CONVERTERS))
def test_v3_converters_match_jax(cases, case):
    """The port's converter and the JAX one on the same state dict: equal
    trees, bit for bit (and the tree the state dict was written from)."""
    jcc = _jcc()
    tmpl, states = cases
    sd, expected = states[case]
    if case == "hift":
        assert any(k.endswith("weight_g") for k in sd) and any(k.endswith("original0") for k in sd)
        assert "ups.0.weight_v" in sd or "ups.0.parametrizations.weight.original1" in sd
    want = getattr(jcc, CONVERTERS[case])(jcc._fold_weight_norm(dict(sd)), tmpl[case][0])
    got = getattr(pcc, CONVERTERS[case])(pcc._fold_weight_norm(dict(sd)), tmpl[case][1])
    assert_same_tree(got, np_tree(want))
    if expected is not None:
        assert_same_tree(got, expected)
    if case == "llm":
        assert "llm_embedding" not in got["params"] and set(got["params"]["llm_decoder"]) == {"kernel"}


def test_v3_converters_raise_on_leftover_and_missing_keys(cases):
    tmpl, states = cases
    llm = dict(states["llm"][0])
    with pytest.raises(AssertionError, match="unconsumed"):
        pcc.convert_llm_v3({**llm, "llm_embedding.weight": np.zeros((2, 32), np.float32)}, tmpl["llm"][1])
    del llm["llm.model.model.norm.weight"]
    with pytest.raises(KeyError):
        pcc.convert_llm_v3(llm, tmpl["llm"][1])
    flow = dict(states["flow"][0])
    with pytest.raises(AssertionError, match="unconsumed"):
        pcc.convert_flow_v3({**flow, "decoder.estimator.extra.weight": np.zeros(3, np.float32)}, tmpl["flow"][1])
    # the v2 converter refuses the v3 flow
    with pytest.raises(KeyError):
        pcc.convert_flow_v2(flow, tmpl["flow"][1])
