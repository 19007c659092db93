"""The port's v2 checkpoint converters (tools/convert_checkpoint.py,
tools/onnx_reader.py) against the JAX ones on the same synthetic
reference-shaped state dicts, bit for bit, CPU: the LM's from a tiny
`transformers.Qwen2ForCausalLM` under llm.model. plus the CosyVoice heads;
flow and HiFT written out from the JAX templates' paths (both weight-norm
layouts), which also gives the tree a correct converter makes of them; S3
and CAM++ from the torch mirrors of tests/test_convert_s3.py and
tests/test_convert_campplus.py through synthetic .onnx bytes; and the
port's converter CLI on a synthetic reference dir, whose msgpack files,
read by flax, equal the JAX converters' trees. The JAX convert_flow_v2
counts one U-Net mid block and one transformer block per level whatever
the checkpoint holds (ROADMAP C4): it is compared on a flow with one of
each, and the port's alone on a flow with two of each."""

import re

import flax.serialization as ser
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
from cosyvoice_tpu_torch.models.speech_tokenizer import S3Tokenizer
from cosyvoice_tpu_torch.tools import convert_checkpoint as pcc
from tests.test_torch_checkpoint import CASE_CFGS, K, _bits, _jax_tree, _leaves, assert_same_tree
from tests.test_torch_common import jax_hift_cfg, jax_lm_cfg, np_tree, to_port_cfg

torch.set_num_threads(1)


def _jcc():
    import cosyvoice_tpu.tools.convert_checkpoint as jcc

    return jcc


def _hf_qwen_state(seed=0):
    """A tiny transformers Qwen2ForCausalLM's state dict under llm.model.,
    plus the CosyVoice heads: the reference llm.pt's layout, at
    jax_lm_cfg()'s widths."""
    from transformers import Qwen2Config, Qwen2ForCausalLM

    cfg = jax_lm_cfg()
    q = cfg.qwen
    torch.manual_seed(seed)
    hf = Qwen2ForCausalLM(Qwen2Config(vocab_size=q.vocab_size, hidden_size=q.hidden_size,
                                      intermediate_size=q.intermediate_size, num_hidden_layers=q.num_layers,
                                      num_attention_heads=q.num_heads, num_key_value_heads=q.num_kv_heads,
                                      tie_word_embeddings=False))
    sd = {f"llm.model.{k}": v for k, v in hf.state_dict().items()}
    rng = np.random.default_rng(seed)
    H, V = q.hidden_size, cfg.speech_token_size + cfg.num_special_head
    for k, shape in (("llm_embedding.weight", (2, H)), ("speech_embedding.weight", (V, H)),
                     ("llm_decoder.weight", (V, H)), ("llm_decoder.bias", (V,))):
        sd[k] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return sd


# JAX flow template paths (after "<sub-model>/params/") -> reference flow.pt names
_FLOW_RULES = [
    (r"^(input_embedding|spk_embed_affine_layer|encoder_proj)$", r"\1"),
    (r"^encoder/(embed|up_embed)/out_dense$", r"encoder.\1.out.0"),
    (r"^encoder/(embed|up_embed)/out_norm$", r"encoder.\1.out.1"),
    (r"^encoder/pre_lookahead_layer/(conv[12])(/conv)?$", r"encoder.pre_lookahead_layer.\1"),
    (r"^encoder/up_layer/conv(/conv)?$", r"encoder.up_layer.conv"),
    (r"^encoder/(encoders|up_encoders)_(\d+)/(.+)$", r"encoder.\1.\2.\3"),
    (r"^encoder/after_norm$", r"encoder.after_norm"),
    (r"^time_mlp/(linear_\d)$", r"decoder.estimator.time_mlp.\1"),
    (r"^(down|up|mid)_resnet_(\d+)/(block[12])/conv/conv$", r"decoder.estimator.\1_blocks.\2.0.\3.block.0"),
    (r"^(down|up|mid)_resnet_(\d+)/(block[12])/norm$", r"decoder.estimator.\1_blocks.\2.0.\3.block.2"),
    (r"^(down|up|mid)_resnet_(\d+)/mlp$", r"decoder.estimator.\1_blocks.\2.0.mlp.1"),
    (r"^(down|up|mid)_resnet_(\d+)/res_conv$", r"decoder.estimator.\1_blocks.\2.0.res_conv"),
    (r"^(down|up|mid)_tf_(\d+)_(\d+)/attn1/to_out$", r"decoder.estimator.\1_blocks.\2.1.\3.attn1.to_out.0"),
    (r"^(down|up|mid)_tf_(\d+)_(\d+)/ff_in$", r"decoder.estimator.\1_blocks.\2.1.\3.ff.net.0.proj"),
    (r"^(down|up|mid)_tf_(\d+)_(\d+)/ff_out$", r"decoder.estimator.\1_blocks.\2.1.\3.ff.net.2"),
    (r"^(down|up|mid)_tf_(\d+)_(\d+)/(.+)$", r"decoder.estimator.\1_blocks.\2.1.\3.\4"),
    (r"^(down|up)_post_(\d+)/conv$", r"decoder.estimator.\1_blocks.\2.2"),
    (r"^final_block/conv/conv$", r"decoder.estimator.final_block.block.0"),
    (r"^final_block/norm$", r"decoder.estimator.final_block.block.2"),
    (r"^final_proj$", r"decoder.estimator.final_proj"),
]
# JAX HiFT template paths (after "params/") -> reference hift.pt names
_HIFT_RULES = [
    (r"^f0_predictor/condnet_(\d+)$", lambda m: f"f0_predictor.condnet.{2 * int(m.group(1))}"),
    (r"^(f0_predictor/classifier|m_source/l_linear|conv_pre|conv_post)$", lambda m: m.group(1).replace("/", ".")),
    (r"^(ups|source_downs)_(\d+)$", r"\1.\2"),
    (r"^(resblocks|source_resblocks)_(\d+)/(convs[12])_(\d+)$", r"\1.\2.\3.\4"),
    (r"^(resblocks|source_resblocks)_(\d+)/act([12])_(\d+)$", r"\1.\2.activations\3.\4"),
]


def _torch_key(owner, rules):
    for pat, rep in rules:
        m = re.match(pat, owner)
        if m:
            return m.expand(rep).replace("/", ".") if isinstance(rep, str) else rep(m)
    raise KeyError(owner)


def _state_from_template(tree, rules, rng, legacy_every=2):
    """A random reference-shaped state dict for a JAX template, and the
    tree a correct converter makes of it: names by `rules`, torch layouts
    (Linear [out, in], Conv1d [out, in, k], ConvTranspose1d [in, out, k],
    weight norm g [c, 1, 1]); every `legacy_every`-th weight-normed conv in
    the legacy weight_g / weight_v layout, the others as
    parametrizations.weight.original0/1."""
    sd, want, wn = {}, {}, {}
    for path, leaf in _leaves(tree):
        owner = _torch_key(re.sub(r"^(encoder|estimator)/params/|^params/", "", "/".join(path[:-1])), rules)
        val = rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
        node = want
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = val
        name = path[-1]
        if name == "kernel":
            sd[f"{owner}.weight"] = val.T if val.ndim == 2 else val.transpose(2, 1, 0)
        elif name in ("scale", "embedding"):
            sd[f"{owner}.weight"] = val
        elif name in ("v", "g"):
            legacy = wn.setdefault(owner, len(wn)) % legacy_every == 0
            if name == "v":
                t = val.transpose(1, 2, 0) if owner.startswith("ups.") else val.transpose(2, 1, 0)
            else:
                t = val.reshape(-1, 1, 1)
            sd[f"{owner}.{('weight_v' if name == 'v' else 'weight_g') if legacy else 'parametrizations.weight.original' + ('1' if name == 'v' else '0')}"] = t
        else:
            sd[f"{owner}.{name}"] = val
    return sd, want


def _jax_template(case):
    return _jax_tree(case)


def _port_template(case):
    cfg = CASE_CFGS[case]()
    if case == "llm":
        return pcc.template(lambda: Qwen2LMModule(to_port_cfg(cfg, LMConfig)))
    if case == "hift":
        return pcc.template(lambda: HiFTGenerator(to_port_cfg(cfg, HiFTConfig), device="meta"))
    return pcc.template(lambda: CausalFlow(to_port_cfg(cfg, FlowConfig), device="meta"))


CONVERTERS = {"llm": "convert_llm_v2", "flow1": "convert_flow_v2", "flow": "convert_flow_v2", "hift": "convert_hift"}


@pytest.fixture(scope="module")
def reference_states():
    """{case: (reference-shaped state dict of numpy arrays with unfolded
    weight norm, the tree a correct converter makes of it or None)}."""
    rng = np.random.default_rng(0)
    out = {"llm": ({k: v.numpy() for k, v in _hf_qwen_state().items()}, None)}
    for case, rules in (("flow1", _FLOW_RULES), ("flow", _FLOW_RULES), ("hift", _HIFT_RULES)):
        out[case] = _state_from_template(_jax_template(case), rules, rng)
    out["hift"][0]["stft_window"] = np.hanning(16).astype(np.float32)  # a buffer both converters skip
    return out


@pytest.mark.parametrize("case", ["llm", "flow1", "hift"])
def test_v2_converters_match_jax(reference_states, case):
    """The port's converter and the JAX one on the same state dict: equal
    trees, bit for bit (and the tree the state dict was written from)."""
    jcc = _jcc()
    sd, expected = reference_states[case]
    if case == "hift":
        assert any(k.endswith("weight_g") for k in sd) and any(k.endswith("original0") for k in sd)
    want = getattr(jcc, CONVERTERS[case])(jcc._fold_weight_norm(dict(sd)), _jax_template(case))
    got = getattr(pcc, CONVERTERS[case])(pcc._fold_weight_norm(dict(sd)), _port_template(case))
    assert_same_tree(got, np_tree(want))
    if expected is not None:
        assert_same_tree(got, expected)


def test_flow_converter_counts_mid_and_transformer_blocks(reference_states):
    """Two mid blocks and two transformer blocks per level (the released
    flow has 12 and 4): the port's converter gives the tree the state dict
    was written from; the JAX one counts one of each and raises on the
    keys it leaves (ROADMAP C4)."""
    sd, expected = reference_states["flow"]
    assert_same_tree(pcc.convert_flow_v2(dict(sd), _port_template("flow")), expected)
    with pytest.raises(AssertionError, match="unconsumed torch keys"):
        _jcc().convert_flow_v2(dict(sd), _jax_template("flow"))


def test_v2_converters_raise_on_leftover_and_missing_keys(reference_states):
    sd = pcc._fold_weight_norm(dict(reference_states["hift"][0]))
    with pytest.raises(AssertionError, match="unconsumed"):
        pcc.convert_hift({**sd, "extra.weight": np.zeros(3, np.float32)}, _port_template("hift"))
    llm = dict(reference_states["llm"][0])
    del llm["llm.model.model.norm.weight"]
    with pytest.raises(KeyError):
        pcc.convert_llm_v2(llm, _port_template("llm"))
    with pytest.raises(AssertionError, match="unknown flax path"):
        pcc.convert_flow_v2(dict(reference_states["flow"][0]), _port_template("flow1"))


def _onnx_bytes(sd):
    from tests.test_onnx_reader import _ld, _tensor_raw, make_onnx

    return make_onnx(b"".join(_ld(5, _tensor_raw(k, np.ascontiguousarray(v))) for k, v in sd.items()))


def _s3_state():
    from tests.test_convert_s3 import _TorchS3

    torch.manual_seed(0)
    return {k: v.detach().numpy() for k, v in _TorchS3(n_mels=16, d=32, h=4, n_blocks=2, n_levels=8).state_dict().items()}


def _campplus_state():
    from tests.test_convert_campplus import SMALL, TorchCAMPPlus, _randomize_bn_stats

    torch.manual_seed(0)
    tm = TorchCAMPPlus(**SMALL).eval()
    with torch.no_grad():
        _randomize_bn_stats(tm, np.random.default_rng(0))
    return {k: v.detach().numpy() for k, v in tm.state_dict().items()}


def test_onnx_reader_matches_jax(tmp_path):
    from cosyvoice_tpu.tools.onnx_reader import read_onnx_weights as jread

    from cosyvoice_tpu_torch.tools.onnx_reader import read_onnx_weights

    path = tmp_path / "m.onnx"
    path.write_bytes(_onnx_bytes(_campplus_state()))
    got, want = read_onnx_weights(str(path)), jread(str(path))
    assert got.keys() == want.keys() == _campplus_state().keys()
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


def test_s3_and_campplus_converters_match_jax(tmp_path):
    """Through synthetic .onnx bytes: the S3 config the graph implies and
    the converted trees, for S3 (FSQ, 25 Hz downsample) and CAM++."""
    from cosyvoice_tpu.models.speech_tokenizer import S3Tokenizer as JS3
    from cosyvoice_tpu.tools.onnx_reader import read_onnx_weights as jread
    from cosyvoice_tpu.utils.devices import jit_init
    from tests.test_convert_campplus import SMALL_CFG

    from cosyvoice_tpu_torch.tools.onnx_reader import read_onnx_weights

    jcc = _jcc()
    (tmp_path / "s3.onnx").write_bytes(_onnx_bytes(_s3_state()))
    (tmp_path / "cam.onnx").write_bytes(_onnx_bytes(_campplus_state()))
    jw, pw = jread(str(tmp_path / "s3.onnx")), read_onnx_weights(str(tmp_path / "s3.onnx"))
    jcfg, pcfg = jcc.s3_config_from_weights(jw), pcc.s3_config_from_weights(pw)
    assert {f: getattr(pcfg, f) for f in pcfg.__dataclass_fields__} == {
        f: getattr(jcfg, f) for f in pcfg.__dataclass_fields__}
    jt = jit_init(JS3(jcfg).init, K, jnp.zeros((1, 16, jcfg.n_mels)), jnp.asarray([16]))
    want = jcc.convert_s3_tokenizer(jw, jt)
    got = pcc.convert_s3_tokenizer(pw, pcc.template(lambda: S3Tokenizer(pcfg)))
    assert_same_tree(got, np_tree(want))

    jw, pw = jread(str(tmp_path / "cam.onnx")), read_onnx_weights(str(tmp_path / "cam.onnx"))
    port_cfg = CamPPConfig(**{f: getattr(SMALL_CFG, f) for f in CamPPConfig.__dataclass_fields__})
    want = jcc.convert_campplus(jw, _jax_tree("campplus"))
    got = pcc.convert_campplus(pw, pcc.template(lambda: CamPPEmbedding(port_cfg)))
    assert_same_tree(got, np_tree(want))


def test_converter_cli_matches_jax(tmp_path, monkeypatch, reference_states):
    """The port's CLI (`main`) on a synthetic reference dir (llm.pt,
    flow.pt and hift.pt as torch.save'd state dicts, the HiFT one under the
    reference's `generator.` prefix; the S3 and CAM++ .onnx), its default
    configs set to the tiny ones: the msgpack files it writes, read by
    flax, equal the JAX converters' trees. lm.msgpack is the name the APIs
    read."""
    from cosyvoice_tpu.models.speech_tokenizer import S3Tokenizer as JS3
    from cosyvoice_tpu.tools.onnx_reader import read_onnx_weights as jread
    from cosyvoice_tpu.utils.devices import jit_init
    from tests.test_convert_campplus import SMALL_CFG

    jcc = _jcc()
    ref, out = tmp_path / "ref", tmp_path / "out"
    ref.mkdir()
    for name, case in (("llm", "llm"), ("flow", "flow1"), ("hift", "hift")):
        prefix = "generator." if name == "hift" else ""
        sd = reference_states[case][0]
        torch.save({prefix + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, ref / f"{name}.pt")
    (ref / "s3.onnx").write_bytes(_onnx_bytes(_s3_state()))
    (ref / "cam.onnx").write_bytes(_onnx_bytes(_campplus_state()))
    monkeypatch.setattr(pcc, "LMConfig", lambda: to_port_cfg(jax_lm_cfg(), LMConfig))
    monkeypatch.setattr(pcc, "FlowConfig", lambda: to_port_cfg(CASE_CFGS["flow1"](), FlowConfig))
    monkeypatch.setattr(pcc, "HiFTConfig", lambda: to_port_cfg(jax_hift_cfg(), HiFTConfig))
    monkeypatch.setattr(pcc, "CamPPConfig", lambda: CamPPConfig(
        **{f: getattr(SMALL_CFG, f) for f in CamPPConfig.__dataclass_fields__}))
    pcc.main(["--model_dir", str(ref), "--out_dir", str(out), "--s3_onnx", str(ref / "s3.onnx"),
              "--campplus_onnx", str(ref / "cam.onnx")])
    assert sorted(p.name for p in out.iterdir()) == ["campplus.msgpack", "flow.msgpack", "hift.msgpack",
                                                      "lm.msgpack", "speech_tokenizer.msgpack"]
    jt = {"llm": _jax_template("llm"), "flow": _jax_template("flow1"), "hift": _jax_template("hift")}
    s3w = jread(str(ref / "s3.onnx"))
    s3cfg = jcc.s3_config_from_weights(s3w)
    want = {
        "lm": jcc.convert_llm_v2(jcc.load_torch_state(str(ref / "llm.pt")), jt["llm"]),
        "flow": jcc.convert_flow_v2(jcc.load_torch_state(str(ref / "flow.pt")), jt["flow"]),
        "hift": jcc.convert_hift(jcc.load_torch_state(str(ref / "hift.pt")), jt["hift"]),
        "speech_tokenizer": jcc.convert_s3_tokenizer(s3w, jit_init(JS3(s3cfg).init, K, jnp.zeros((1, 16, s3cfg.n_mels)),
                                                                   jnp.asarray([16]))),
        "campplus": jcc.convert_campplus(jread(str(ref / "cam.onnx")), _jax_tree("campplus")),
    }
    for name, tree in want.items():
        got = ser.from_bytes(np_tree(tree), (out / f"{name}.msgpack").read_bytes())
        assert_same_tree(np_tree(got), np_tree(tree))


@pytest.mark.parametrize("version,item", [(1, "A10"), (3, "A9")])
def test_converter_cli_v1_and_v3_raise(tmp_path, monkeypatch, version, item):
    """`--version 1` (A10) and `--version 3` (A9), which once raised naming
    their ROADMAP items, are ported. Version 1 on a dir with no checkpoint
    writes nothing (tests/test_torch_convert_v1.py converts a synthetic v1
    dir), and an unknown version raises. `--version 3` converts a synthetic
    Fun-CosyVoice3 reference dir (llm.pt, flow.pt, hift.pt, the v3 configs
    set to the tiny ones): the files it writes equal the JAX v3 converters'
    trees, and CosyVoice3 reads them from the dir with a config.json of
    version 3."""
    if version == 1:
        assert item == "A10"
        pcc.main(["--model_dir", str(tmp_path), "--out_dir", str(tmp_path / "o"), "--version", "1"])
        assert list((tmp_path / "o").iterdir()) == []
        with pytest.raises(ValueError, match="unsupported model version"):
            pcc.main(["--model_dir", str(tmp_path), "--out_dir", str(tmp_path / "o"), "--version", "4"])
        return
    import json

    from cosyvoice_tpu_torch.runtime.api import AutoModel, CosyVoice3
    from tests.test_torch_common import jax_dit_flow_cfg, jax_hift_cfg_v3, jax_lm_cfg_v3
    from tests.test_torch_convert_v3 import reference_states_v3, templates

    jcc = _jcc()
    tmpl = templates()
    states = reference_states_v3(tmpl)
    ref, out = tmp_path / "ref", tmp_path / "out"
    ref.mkdir()
    for name in ("llm", "flow", "hift"):
        prefix = "generator." if name == "hift" else ""
        torch.save({prefix + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in states[name][0].items()},
                   ref / f"{name}.pt")
    cfgs = (to_port_cfg(jax_lm_cfg_v3(), LMConfig), to_port_cfg(jax_dit_flow_cfg(), FlowConfig),
            to_port_cfg(jax_hift_cfg_v3(), HiFTConfig))
    monkeypatch.setattr(pcc, "cosyvoice3_configs", lambda: cfgs)
    pcc.main(["--model_dir", str(ref), "--out_dir", str(out), "--version", "3"])
    assert sorted(p.name for p in out.iterdir()) == ["flow.msgpack", "hift.msgpack", "lm.msgpack"]
    want = {"lm": jcc.convert_llm_v3(jcc.load_torch_state(str(ref / "llm.pt")), tmpl["llm"][0]),
            "flow": jcc.convert_flow_v3(jcc.load_torch_state(str(ref / "flow.pt")), tmpl["flow"][0]),
            "hift": jcc.convert_hift(jcc.load_torch_state(str(ref / "hift.pt")), tmpl["hift"][0])}
    for name, tree in want.items():
        got = ser.from_bytes(np_tree(tree), (out / f"{name}.msgpack").read_bytes())
        assert_same_tree(np_tree(got), np_tree(tree))
    (out / "config.json").write_text(json.dumps({"version": 3}))
    api = AutoModel(str(out), device="cpu", lm_cfg=cfgs[0], flow_cfg=cfgs[1], hift_cfg=cfgs[2])
    assert type(api) is CosyVoice3
    np.testing.assert_array_equal(api.flow.estimator.proj_out.bias.detach().numpy(),
                                  want["flow"]["estimator"]["params"]["proj_out"]["bias"])
    np.testing.assert_array_equal(api.lm.module.speech_embedding.weight.detach().numpy(),
                                  want["lm"]["params"]["speech_embedding"]["embedding"])
