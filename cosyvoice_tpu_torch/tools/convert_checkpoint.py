"""Convert reference torch checkpoints (llm.pt / flow.pt / hift.pt) and
ONNX graphs (speech_tokenizer_v*.onnx, campplus.onnx) into JAX param trees
for CosyVoice-300M (v1), CosyVoice2 (v2) and Fun-CosyVoice3 (v3), written
as flax msgpack files.

Counterpart of cosyvoice_tpu/tools/convert_checkpoint.py,
over plain nested dicts of numpy arrays: the converters are the JAX
file's, and the trees they fill come from `convert.export_params` of the
port's modules built on the meta device (the Flax paths, shapes and dtypes
of the JAX templates, with no weights made). Conversion is host work: it
touches no card. Mapping rules:

- torch Linear weight [out, in]      -> flax Dense kernel [in, out] (transpose)
- torch Conv1d weight [out, in, k]   -> Conv1d kernel [k, in, out]
- torch ConvTranspose1d [in, out, k] -> WNConvTranspose1d v [k, in, out]
- torch weight_norm: both the legacy (weight_g / weight_v) and the
  parametrizations (parametrizations.weight.original0/1) layouts
- HF Qwen2 q/k/v_proj  -> fused qkv_proj (concat out dim)
-           gate/up_proj -> fused gate_up_proj

Every converter asserts that all torch keys are consumed and all leaves are
filled with matching shapes, so a mapping drift fails loudly.

    python -m cosyvoice_tpu_torch.tools.convert_checkpoint --model_dir REF --out_dir OUT \
        [--s3_onnx REF/speech_tokenizer_v2.onnx] [--campplus_onnx REF/campplus.onnx]

writes OUT/lm.msgpack, flow.msgpack and hift.msgpack (from the llm.pt,
flow.pt and hift.pt present), speech_tokenizer.msgpack and
campplus.msgpack, which `runtime/api.py:CosyVoice2(OUT)` and the JAX
package's CosyVoice2 load. `--version 3` converts a Fun-CosyVoice3 dir
(`convert_llm_v3`: the same Qwen2 body, sos / task in the speech table, no
head bias; `convert_flow_v3`: the DiT flow; `convert_hift` with the causal
layout) at the full v3 widths, for `runtime/api.py:CosyVoice3(OUT)` (add a
config.json with "version": 3, or the cosyvoice3.yaml the reference dir
ships, so that AutoModel picks it). `--version 1` converts a
CosyVoice-300M dir (`convert_llm_v1`: the WeNet text encoder and the
rel-pos LM; `convert_flow_v1`: the conformer, the length regulator and the
non-causal two-level U-Net; `convert_hift` at 22.05 kHz) at the full v1
widths, for `runtime/api.py:CosyVoice(OUT)` (with a config.json of
"version": 1 or the reference's cosyvoice.yaml, and its .tiktoken vocab).
"""

import argparse
import os
import re
from typing import Dict

import numpy as np
import torch

from cosyvoice_tpu_torch.convert import export_params
from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config, MaskedDiffFlow
from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator, v1_hift_config
from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config, TransformerLMModule
from cosyvoice_tpu_torch.models.speech_tokenizer import S3Tokenizer, S3TokenizerConfig
from cosyvoice_tpu_torch.tools.onnx_reader import read_onnx_weights
from cosyvoice_tpu_torch.utils import msgpack_io
from cosyvoice_tpu_torch.utils.config import cosyvoice3_configs

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        k = k.replace("generator.", "") if k.startswith("generator.") else k
        out[k] = v.detach().numpy()
    return _fold_weight_norm(out)


def _fold_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Normalize both weight-norm layouts to ('.weight_g', '.weight_v')."""
    out = dict(sd)
    for k in list(out.keys()):
        m = re.match(r"(.*)\.parametrizations\.weight\.original0$", k)
        if m:
            out[m.group(1) + ".weight_g"] = out.pop(k)
        m = re.match(r"(.*)\.parametrizations\.weight\.original1$", k)
        if m:
            out[m.group(1) + ".weight_v"] = out.pop(k)
    return out


def _lin(w):  # torch Linear -> Dense kernel
    return np.ascontiguousarray(w.T)


def _conv(w):  # torch Conv1d [out, in, k] -> [k, in, out]
    return np.ascontiguousarray(w.transpose(2, 1, 0))


def _convT(w):  # torch ConvTranspose1d [in, out, k] -> [k, in, out]
    return np.ascontiguousarray(w.transpose(2, 0, 1))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class TreeFiller:
    """Fills a template tree (nested dicts of LeafSpec, from export_params
    of a module on the meta device) by "/"-joined Flax path."""

    def __init__(self, template: dict):
        self.shapes = {"/".join(path): leaf.shape for path, leaf in _leaves(template)}
        self.values = {}
        self.template = template

    def resolve(self, path: str) -> str:
        """Resolve a path allowing one extra 'conv' nesting level (the causal
        conv wrappers nest their inner conv under 'conv')."""
        if path in self.shapes:
            return path
        head, leaf = path.rsplit("/", 1)
        alt = f"{head}/conv/{leaf}"
        if alt in self.shapes:
            return alt
        return path

    def put(self, path: str, value: np.ndarray):
        path = self.resolve(path)
        assert path in self.shapes, f"unknown flax path {path}"
        assert tuple(self.shapes[path]) == tuple(value.shape), (
            f"shape mismatch at {path}: flax {self.shapes[path]} vs torch {value.shape}"
        )
        self.values[path] = np.asarray(value, np.float32)

    def build(self):
        missing = set(self.shapes) - set(self.values)
        assert not missing, f"unfilled flax leaves: {sorted(missing)[:10]} (+{max(0, len(missing)-10)} more)"

        def fill(node, prefix):
            return {k: fill(v, prefix + (k,)) if isinstance(v, dict)
                    else self.values["/".join(prefix + (k,))].astype(v.dtype) for k, v in node.items()}

        return fill(self.template, ())


# ---------------------------------------------------------------------------
# HiFT (hift.pt) -> HiFTGenerator params
# ---------------------------------------------------------------------------

def convert_hift(sd: Dict[str, np.ndarray], template: dict) -> dict:
    tf = TreeFiller(template)
    used = set()

    def wn_conv(torch_prefix, flax_prefix):
        tf.put(f"{flax_prefix}/v", _conv(sd[f"{torch_prefix}.weight_v"]))
        tf.put(f"{flax_prefix}/g", sd[f"{torch_prefix}.weight_g"].reshape(-1))
        tf.put(f"{flax_prefix}/bias", sd[f"{torch_prefix}.bias"])
        used.update({f"{torch_prefix}.weight_v", f"{torch_prefix}.weight_g", f"{torch_prefix}.bias"})

    def wn_convT(torch_prefix, flax_prefix):
        tf.put(f"{flax_prefix}/v", _convT(sd[f"{torch_prefix}.weight_v"]))
        tf.put(f"{flax_prefix}/g", sd[f"{torch_prefix}.weight_g"].reshape(-1))
        tf.put(f"{flax_prefix}/bias", sd[f"{torch_prefix}.bias"])
        used.update({f"{torch_prefix}.weight_v", f"{torch_prefix}.weight_g", f"{torch_prefix}.bias"})

    p = "params"
    for i in range(5):
        wn_conv(f"f0_predictor.condnet.{2 * i}", f"{p}/f0_predictor/condnet_{i}")
    tf.put(f"{p}/f0_predictor/classifier/kernel", _lin(sd["f0_predictor.classifier.weight"]))
    tf.put(f"{p}/f0_predictor/classifier/bias", sd["f0_predictor.classifier.bias"])
    used.update({"f0_predictor.classifier.weight", "f0_predictor.classifier.bias"})

    tf.put(f"{p}/m_source/l_linear/kernel", _lin(sd["m_source.l_linear.weight"]))
    tf.put(f"{p}/m_source/l_linear/bias", sd["m_source.l_linear.bias"])
    used.update({"m_source.l_linear.weight", "m_source.l_linear.bias"})

    wn_conv("conv_pre", f"{p}/conv_pre")
    wn_conv("conv_post", f"{p}/conv_post")

    n_ups = len([k for k in sd if re.match(r"ups\.\d+\.weight_v", k)])
    # causal HiFT replaces ConvTranspose ups with CausalConv1dUpsample
    # (regular convs, generator.py:626-637); detect by the nested layout
    causal_ups = tf.resolve(f"{p}/ups_0/v") != f"{p}/ups_0/v"
    for i in range(n_ups):
        (wn_conv if causal_ups else wn_convT)(f"ups.{i}", f"{p}/ups_{i}")

    def resblock(torch_prefix, flax_prefix, n_convs):
        for j in range(n_convs):
            wn_conv(f"{torch_prefix}.convs1.{j}", f"{flax_prefix}/convs1_{j}")
            wn_conv(f"{torch_prefix}.convs2.{j}", f"{flax_prefix}/convs2_{j}")
            tf.put(f"{flax_prefix}/act1_{j}/alpha", sd[f"{torch_prefix}.activations1.{j}.alpha"])
            tf.put(f"{flax_prefix}/act2_{j}/alpha", sd[f"{torch_prefix}.activations2.{j}.alpha"])
            used.update({f"{torch_prefix}.activations1.{j}.alpha", f"{torch_prefix}.activations2.{j}.alpha"})

    n_src = len({k.split(".")[1] for k in sd if k.startswith("source_downs.")})
    for i in range(n_src):
        # plain convs (generator.py:446-458)
        tf.put(f"{p}/source_downs_{i}/kernel", _conv(sd[f"source_downs.{i}.weight"]))
        tf.put(f"{p}/source_downs_{i}/bias", sd[f"source_downs.{i}.bias"])
        used.update({f"source_downs.{i}.weight", f"source_downs.{i}.bias"})
        n_convs = len({k.split(".")[3] for k in sd if k.startswith(f"source_resblocks.{i}.convs1.") and k.endswith("weight_v")})
        resblock(f"source_resblocks.{i}", f"{p}/source_resblocks_{i}", n_convs)

    n_res = len({k.split(".")[1] for k in sd if k.startswith("resblocks.")})
    for i in range(n_res):
        n_convs = len({k.split(".")[3] for k in sd if k.startswith(f"resblocks.{i}.convs1.") and k.endswith("weight_v")})
        resblock(f"resblocks.{i}", f"{p}/resblocks_{i}", n_convs)

    leftover = set(sd) - used
    leftover = {k for k in leftover if "stft_window" not in k and "f0_upsamp" not in k}
    assert not leftover, f"unconsumed torch keys: {sorted(leftover)[:10]}"
    return tf.build()


# ---------------------------------------------------------------------------
# LLM v2 (llm.pt, HF Qwen2 inside) -> Qwen2LMModule params
# ---------------------------------------------------------------------------

def convert_llm_v2(sd: Dict[str, np.ndarray], template: dict) -> dict:
    tf = TreeFiller(template)
    used = set()
    p = "params"

    tf.put(f"{p}/llm_embedding/embedding", sd["llm_embedding.weight"]); used.add("llm_embedding.weight")
    tf.put(f"{p}/speech_embedding/embedding", sd["speech_embedding.weight"]); used.add("speech_embedding.weight")
    tf.put(f"{p}/llm_decoder/kernel", _lin(sd["llm_decoder.weight"])); used.add("llm_decoder.weight")
    if "llm_decoder.bias" in sd:
        tf.put(f"{p}/llm_decoder/bias", sd["llm_decoder.bias"]); used.add("llm_decoder.bias")

    q = "llm.model.model"
    tf.put(f"{p}/llm/embed_tokens/embedding", sd[f"{q}.embed_tokens.weight"]); used.add(f"{q}.embed_tokens.weight")
    tf.put(f"{p}/llm/norm/weight", sd[f"{q}.norm.weight"]); used.add(f"{q}.norm.weight")
    n_layers = len({m.group(1) for k in sd if (m := re.match(rf"{re.escape(q)}\.layers\.(\d+)\.", k))})
    for i in range(n_layers):
        _qwen2_layer(sd, used, tf, f"{q}.layers.{i}", f"{p}/llm/layers_{i}")
    leftover = {
        k for k in set(sd) - used
        if "rotary_emb" not in k and not k.startswith("llm.model.lm_head") and "criterion" not in k
    }
    assert not leftover, f"unconsumed torch keys: {sorted(leftover)[:10]}"
    return tf.build()


# ---------------------------------------------------------------------------
# LLM v3 (CosyVoice3LM): the Qwen2 body; sos / task in the speech table, no
# llm_embedding, a bias-less llm_decoder
# ---------------------------------------------------------------------------

def convert_llm_v3(sd: Dict[str, np.ndarray], template: dict) -> dict:
    sd = dict(sd)
    sd.setdefault("llm_decoder.bias", None)
    tf = TreeFiller(template)
    used = set()
    p = "params"
    tf.put(f"{p}/speech_embedding/embedding", sd["speech_embedding.weight"]); used.add("speech_embedding.weight")
    tf.put(f"{p}/llm_decoder/kernel", _lin(sd["llm_decoder.weight"])); used.add("llm_decoder.weight")
    q = "llm.model.model"
    tf.put(f"{p}/llm/embed_tokens/embedding", sd[f"{q}.embed_tokens.weight"]); used.add(f"{q}.embed_tokens.weight")
    tf.put(f"{p}/llm/norm/weight", sd[f"{q}.norm.weight"]); used.add(f"{q}.norm.weight")
    n_layers = len({m.group(1) for k in sd if (m := re.match(rf"{re.escape(q)}\.layers\.(\d+)\.", k))})
    for i in range(n_layers):
        _qwen2_layer(sd, used, tf, f"{q}.layers.{i}", f"{p}/llm/layers_{i}")
    leftover = {
        k for k in set(sd) - used
        if "rotary_emb" not in k and not k.startswith("llm.model.lm_head") and "criterion" not in k
        and sd.get(k) is not None
    }
    assert not leftover, f"unconsumed torch keys: {sorted(leftover)[:10]}"
    return tf.build()


def _qwen2_layer(sd, used, tf, t, f):
    """One HF Qwen2 decoder layer `t` into the fused layout at flax path `f`."""
    qw, kw, vw = sd[f"{t}.self_attn.q_proj.weight"], sd[f"{t}.self_attn.k_proj.weight"], sd[f"{t}.self_attn.v_proj.weight"]
    qb, kb, vb = sd[f"{t}.self_attn.q_proj.bias"], sd[f"{t}.self_attn.k_proj.bias"], sd[f"{t}.self_attn.v_proj.bias"]
    tf.put(f"{f}/self_attn/qkv_proj/kernel", _lin(np.concatenate([qw, kw, vw], axis=0)))
    tf.put(f"{f}/self_attn/qkv_proj/bias", np.concatenate([qb, kb, vb]))
    tf.put(f"{f}/self_attn/o_proj/kernel", _lin(sd[f"{t}.self_attn.o_proj.weight"]))
    gw, uw = sd[f"{t}.mlp.gate_proj.weight"], sd[f"{t}.mlp.up_proj.weight"]
    tf.put(f"{f}/mlp/gate_up_proj/kernel", _lin(np.concatenate([gw, uw], axis=0)))
    tf.put(f"{f}/mlp/down_proj/kernel", _lin(sd[f"{t}.mlp.down_proj.weight"]))
    tf.put(f"{f}/input_layernorm/weight", sd[f"{t}.input_layernorm.weight"])
    tf.put(f"{f}/post_attention_layernorm/weight", sd[f"{t}.post_attention_layernorm.weight"])
    used.update({
        f"{t}.self_attn.q_proj.weight", f"{t}.self_attn.k_proj.weight", f"{t}.self_attn.v_proj.weight",
        f"{t}.self_attn.q_proj.bias", f"{t}.self_attn.k_proj.bias", f"{t}.self_attn.v_proj.bias",
        f"{t}.self_attn.o_proj.weight", f"{t}.mlp.gate_proj.weight", f"{t}.mlp.up_proj.weight",
        f"{t}.mlp.down_proj.weight", f"{t}.input_layernorm.weight", f"{t}.post_attention_layernorm.weight",
    })


# ---------------------------------------------------------------------------
# Flow v3 (CausalMaskedDiffWithDiT, flow.pt) -> {"encoder": ..., "estimator": ...}
# ---------------------------------------------------------------------------

def convert_flow_v3(sd: Dict[str, np.ndarray], template: dict) -> dict:
    enc = TreeFiller(template["encoder"])
    est = TreeFiller(template["estimator"])
    used = set()
    p = "params"

    def lin(t, f, filler):
        filler.put(f"{f}/kernel", _lin(sd[f"{t}.weight"])); used.add(f"{t}.weight")
        filler.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    def conv(t, f, filler):
        filler.put(f"{f}/kernel", _conv(sd[f"{t}.weight"])); used.add(f"{t}.weight")
        filler.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    # encoder side: embedding + speaker affine + the lookahead conv
    enc.put(f"{p}/input_embedding/embedding", sd["input_embedding.weight"]); used.add("input_embedding.weight")
    lin("spk_embed_affine_layer", f"{p}/spk_embed_affine_layer", enc)
    conv("pre_lookahead_layer.conv1", f"{p}/pre_lookahead_layer/conv1", enc)
    conv("pre_lookahead_layer.conv2", f"{p}/pre_lookahead_layer/conv2", enc)
    # the DiT estimator
    d = "decoder.estimator"
    lin(f"{d}.time_embed.time_mlp.0", f"{p}/time_embed/mlp1", est)
    lin(f"{d}.time_embed.time_mlp.2", f"{p}/time_embed/mlp2", est)
    lin(f"{d}.input_embed.proj", f"{p}/input_proj", est)
    conv(f"{d}.input_embed.conv_pos_embed.conv1.0", f"{p}/conv_pos/conv1", est)
    conv(f"{d}.input_embed.conv_pos_embed.conv2.0", f"{p}/conv_pos/conv2", est)
    n_blocks = len({m.group(1) for k in sd if (m := re.match(rf"{re.escape(d)}\.transformer_blocks\.(\d+)\.", k))})
    for i in range(n_blocks):
        t, f = f"{d}.transformer_blocks.{i}", f"{p}/blocks_{i}"
        lin(f"{t}.attn_norm.linear", f"{f}/adaln", est)
        for name in ("to_q", "to_k", "to_v"):
            lin(f"{t}.attn.{name}", f"{f}/{name}", est)
        lin(f"{t}.attn.to_out.0", f"{f}/to_out", est)
        lin(f"{t}.ff.ff.0.0", f"{f}/ff_in", est)
        lin(f"{t}.ff.ff.2", f"{f}/ff_out", est)
    lin(f"{d}.norm_out.linear", f"{p}/final_adaln", est)
    lin(f"{d}.proj_out", f"{p}/proj_out", est)
    leftover = {k for k in set(sd) - used if "rand_noise" not in k and "rotary" not in k}
    assert not leftover, f"unconsumed torch keys: {sorted(leftover)[:12]}"
    return {"encoder": enc.build(), "estimator": est.build()}


# ---------------------------------------------------------------------------
# Flow v2 (flow.pt) -> {"encoder": ..., "estimator": ...}
# ---------------------------------------------------------------------------

def convert_flow_v2(sd: Dict[str, np.ndarray], template: dict) -> dict:
    enc = TreeFiller(template["encoder"])
    est = TreeFiller(template["estimator"])
    used = set()
    p = "params"

    def lin(t, f, filler, bias=True):
        filler.put(f"{f}/kernel", _lin(sd[f"{t}.weight"])); used.add(f"{t}.weight")
        if bias:
            filler.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    def ln(t, f, filler):
        filler.put(f"{f}/scale", sd[f"{t}.weight"]); used.add(f"{t}.weight")
        filler.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    def conv(t, f, filler, bias=True):
        filler.put(f"{f}/kernel", _conv(sd[f"{t}.weight"])); used.add(f"{t}.weight")
        if bias:
            filler.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    # ---- encoder side ----
    enc.put(f"{p}/input_embedding/embedding", sd["input_embedding.weight"]); used.add("input_embedding.weight")
    lin("spk_embed_affine_layer", f"{p}/spk_embed_affine_layer", enc)
    lin("encoder_proj", f"{p}/encoder_proj", enc)

    def conformer_layer(t, f):
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            lin(f"{t}.self_attn.{name}", f"{f}/self_attn/{name}", enc)
        lin(f"{t}.self_attn.linear_pos", f"{f}/self_attn/linear_pos", enc, bias=False)
        enc.put(f"{f}/self_attn/pos_bias_u", sd[f"{t}.self_attn.pos_bias_u"]); used.add(f"{t}.self_attn.pos_bias_u")
        enc.put(f"{f}/self_attn/pos_bias_v", sd[f"{t}.self_attn.pos_bias_v"]); used.add(f"{t}.self_attn.pos_bias_v")
        lin(f"{t}.feed_forward.w_1", f"{f}/feed_forward/w_1", enc)
        lin(f"{t}.feed_forward.w_2", f"{f}/feed_forward/w_2", enc)
        ln(f"{t}.norm_mha", f"{f}/norm_mha", enc)
        ln(f"{t}.norm_ff", f"{f}/norm_ff", enc)

    e = "encoder"
    lin(f"{e}.embed.out.0", f"{p}/encoder/embed/out_dense", enc)
    ln(f"{e}.embed.out.1", f"{p}/encoder/embed/out_norm", enc)
    conv(f"{e}.pre_lookahead_layer.conv1", f"{p}/encoder/pre_lookahead_layer/conv1", enc)
    conv(f"{e}.pre_lookahead_layer.conv2", f"{p}/encoder/pre_lookahead_layer/conv2", enc)
    n_enc = len({k.split(".")[2] for k in sd if k.startswith(f"{e}.encoders.")})
    for i in range(n_enc):
        conformer_layer(f"{e}.encoders.{i}", f"{p}/encoder/encoders_{i}")
    conv(f"{e}.up_layer.conv", f"{p}/encoder/up_layer/conv", enc)
    lin(f"{e}.up_embed.out.0", f"{p}/encoder/up_embed/out_dense", enc)
    ln(f"{e}.up_embed.out.1", f"{p}/encoder/up_embed/out_norm", enc)
    n_up = len({k.split(".")[2] for k in sd if k.startswith(f"{e}.up_encoders.")})
    for i in range(n_up):
        conformer_layer(f"{e}.up_encoders.{i}", f"{p}/encoder/up_encoders_{i}")
    ln(f"{e}.after_norm", f"{p}/encoder/after_norm", enc)

    # ---- estimator ----
    d = "decoder.estimator"
    lin(f"{d}.time_mlp.linear_1", f"{p}/time_mlp/linear_1", est)
    lin(f"{d}.time_mlp.linear_2", f"{p}/time_mlp/linear_2", est)

    def causal_block(t, f):
        conv(f"{t}.block.0", f"{f}/conv/conv", est)
        ln(f"{t}.block.2", f"{f}/norm", est)

    def resnet(t, f):
        causal_block(f"{t}.block1", f"{f}/block1")
        causal_block(f"{t}.block2", f"{f}/block2")
        lin(f"{t}.mlp.1", f"{f}/mlp", est)
        conv(f"{t}.res_conv", f"{f}/res_conv", est)

    def tblock(t, f):
        ln(f"{t}.norm1", f"{f}/norm1", est)
        ln(f"{t}.norm3", f"{f}/norm3", est)
        lin(f"{t}.attn1.to_q", f"{f}/attn1/to_q", est, bias=False)
        lin(f"{t}.attn1.to_k", f"{f}/attn1/to_k", est, bias=False)
        lin(f"{t}.attn1.to_v", f"{f}/attn1/to_v", est, bias=False)
        lin(f"{t}.attn1.to_out.0", f"{f}/attn1/to_out", est)
        lin(f"{t}.ff.net.0.proj", f"{f}/ff_in", est)
        lin(f"{t}.ff.net.2", f"{f}/ff_out", est)

    # the index fields of "decoder.estimator.down_blocks.0.1.<j>..." and
    # "decoder.estimator.mid_blocks.<i>..." (the JAX converter reads the
    # fields before them, so it counts one of each whatever the checkpoint
    # holds)
    n_blocks = len({k.split(".")[5] for k in sd if k.startswith(f"{d}.down_blocks.0.1.")})
    resnet(f"{d}.down_blocks.0.0", f"{p}/down_resnet_0")
    for j in range(n_blocks):
        tblock(f"{d}.down_blocks.0.1.{j}", f"{p}/down_tf_0_{j}")
    conv(f"{d}.down_blocks.0.2", f"{p}/down_post_0/conv", est)

    n_mid = len({k.split(".")[3] for k in sd if k.startswith(f"{d}.mid_blocks.")})
    for i in range(n_mid):
        resnet(f"{d}.mid_blocks.{i}.0", f"{p}/mid_resnet_{i}")
        for j in range(n_blocks):
            tblock(f"{d}.mid_blocks.{i}.1.{j}", f"{p}/mid_tf_{i}_{j}")

    resnet(f"{d}.up_blocks.0.0", f"{p}/up_resnet_0")
    for j in range(n_blocks):
        tblock(f"{d}.up_blocks.0.1.{j}", f"{p}/up_tf_0_{j}")
    conv(f"{d}.up_blocks.0.2", f"{p}/up_post_0/conv", est)
    causal_block(f"{d}.final_block", f"{p}/final_block")
    conv(f"{d}.final_proj", f"{p}/final_proj", est)

    leftover = {k for k in set(sd) - used if "rand_noise" not in k and "onnx" not in k}
    assert not leftover, f"unconsumed torch keys: {sorted(leftover)[:12]}"
    return {"encoder": enc.build(), "estimator": est.build()}


# ---------------------------------------------------------------------------

def _normalize_s3_keys(weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip the prefixes ONNX/torch exporters add to the whisper names."""
    sd = {}
    for k, v in weights.items():
        # strip stacked prefixes until none match ("model.encoder.conv1" needs
        # two passes — a single sweep misses "encoder." once "model." strips)
        stripped = True
        while stripped:
            stripped = False
            for pre in ("encoder.", "model.", "s3tokenizer."):
                if k.startswith(pre):
                    k = k[len(pre):]
                    stripped = True
        arr = np.asarray(v, np.float32)
        if k in sd and not (sd[k].shape == arr.shape and np.array_equal(sd[k], arr)):
            # two distinct checkpoint keys normalized to the same name (e.g.
            # 'conv1.weight' alongside 'model.conv1.weight' with different
            # values) — silently keeping the last would load wrong weights
            raise ValueError(f"prefix-stripping collision on '{k}': differing duplicate weights")
        sd[k] = arr
    return sd


_S3_DS_KEYS = ("conv3.weight", "downsample.conv.weight", "conv_ds.weight")
_S3_FSQ_KEYS = ("quantizer.project_in.weight", "quantizer.project_down.weight",
                "fsq.project_in.weight", "proj.weight")
_S3_VQ_KEYS = ("quantizer._codebook.embed", "quantizer.codebook", "codebook")


def s3_config_from_weights(weights: Dict[str, np.ndarray]):
    """Derive S3TokenizerConfig from the graph's own initializer tensors.

    The released speech_tokenizer_v*.onnx graphs (cli/frontend.py:46-48) are
    the only source of truth for depth/width — nothing is hardcoded here:
    n_mels/d_model come from conv1, num_layers from the block index range,
    the quantizer family from which quantizer tensors exist, and the 25 Hz
    second downsample from the presence of its conv. Heads follow the
    whisper 64-dim-head convention (d_model // 64)."""
    sd = _normalize_s3_keys(weights)
    if "conv1.weight" not in sd:
        raise KeyError("not an S3 tokenizer graph: no conv1.weight initializer")
    w1 = sd["conv1.weight"]  # torch Conv1d layout [d_model, n_mels, k]
    d_model, n_mels = int(w1.shape[0]), int(w1.shape[1])
    num_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    num_heads = max(1, d_model // 64)
    rate_div = 2 if any(k in sd for k in _S3_DS_KEYS) else 1
    for k in _S3_FSQ_KEYS:
        if k in sd:
            n_levels = int(sd[k].shape[0])
            return S3TokenizerConfig(
                n_mels=n_mels, d_model=d_model, num_heads=num_heads, num_layers=num_layers,
                codebook_size=3 ** n_levels, use_fsq=True, fsq_levels=(3,) * n_levels,
                token_rate_div=rate_div,
            )
    for k in _S3_VQ_KEYS:
        if k in sd:
            cb = sd[k]
            cb = cb[0] if cb.ndim == 3 else cb
            return S3TokenizerConfig(
                n_mels=n_mels, d_model=d_model, num_heads=num_heads, num_layers=num_layers,
                codebook_size=int(cb.shape[0]), use_fsq=False, token_rate_div=rate_div,
            )
    raise KeyError("no quantizer tensors found (tried FSQ proj and VQ codebook names)")


def convert_s3_tokenizer(weights: Dict[str, np.ndarray], template: dict, strict: bool = True) -> dict:
    """Speech tokenizer weights (whisper-style encoder + FSQ/VQ quantizer)
    -> models/speech_tokenizer.py param tree.

    `weights` comes from tools/onnx_reader.read_onnx_weights on the
    reference's speech_tokenizer_v*.onnx (cli/frontend.py:46-48) or from the
    public s3tokenizer torch state_dict — both use the whisper module names
    (conv1/conv2, blocks.N.attn.{query,key,value,out}, blocks.N.mlp.{0,2},
    attn_ln/mlp_ln/ln_post).

    strict=True additionally requires that every substantive weight tensor of
    the graph is consumed — a graph with layers/submodules this module does
    not model fails loudly instead of converting to a silently-different
    network (TreeFiller.build already guarantees the converse: every flax
    leaf must be filled)."""
    raw = _normalize_s3_keys(weights)
    used = set()

    class _Tracked(dict):
        def __getitem__(self, k):
            used.add(k)
            return dict.__getitem__(self, k)

        def __contains__(self, k):
            # membership probes of the candidate lists are not consumption,
            # but `find` marks its chosen key via __getitem__
            return dict.__contains__(self, k)

    sd = _Tracked(raw)
    filler = TreeFiller(template)
    P = "params"

    def conv(t, f):
        filler.put(f"{P}/{f}/kernel", sd[f"{t}.weight"].transpose(2, 1, 0))
        filler.put(f"{P}/{f}/bias", sd[f"{t}.bias"])

    def linear(t, f, bias=True):
        filler.put(f"{P}/{f}/kernel", sd[f"{t}.weight"].T)
        if bias:
            filler.put(f"{P}/{f}/bias", sd[f"{t}.bias"])

    def ln(t, f):
        filler.put(f"{P}/{f}/scale", sd[f"{t}.weight"])
        filler.put(f"{P}/{f}/bias", sd[f"{t}.bias"])

    conv("conv1", "conv1")
    conv("conv2", "conv2")
    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    for i in range(n_blocks):
        t, f = f"blocks.{i}", f"blocks_{i}"
        ln(f"{t}.attn_ln", f"{f}/attn_ln")
        linear(f"{t}.attn.query", f"{f}/q")
        linear(f"{t}.attn.key", f"{f}/k", bias=False)
        linear(f"{t}.attn.value", f"{f}/v")
        linear(f"{t}.attn.out", f"{f}/out")
        ln(f"{t}.mlp_ln", f"{f}/mlp_ln")
        linear(f"{t}.mlp.0", f"{f}/mlp_in")
        linear(f"{t}.mlp.2", f"{f}/mlp_out")
    ln("ln_post", "ln_post")

    def find(cands, shape):
        for c in cands:
            if c in sd and sd[c].shape == shape:
                return sd[c]
        # fallback: a shape match is only trusted when it is UNIQUE —
        # returning the first of several would silently load wrong weights
        matches = [
            k for k, v in sd.items()
            if v.shape == shape and not k.startswith(("conv1", "conv2", "blocks", "ln_post"))
        ]
        if len(matches) == 1:
            return sd[matches[0]]
        raise KeyError(
            f"no tensor of shape {shape} among candidates {cands}"
            + (f"; ambiguous shape matches: {matches}" if matches else "")
        )

    shapes = filler.shapes
    if f"{P}/conv_ds/kernel" in shapes:
        d = shapes[f"{P}/conv_ds/kernel"][2]
        w = find(["conv3.weight", "downsample.conv.weight", "conv_ds.weight"], (d, d, 3))
        filler.put(f"{P}/conv_ds/kernel", w.transpose(2, 1, 0))
        filler.put(f"{P}/conv_ds/bias",
                   find(["conv3.bias", "downsample.conv.bias", "conv_ds.bias"], (d,)))
    if f"{P}/fsq_proj/kernel" in shapes:
        n_lv, d = shapes[f"{P}/fsq_proj/kernel"][1], shapes[f"{P}/fsq_proj/kernel"][0]
        w = find(["quantizer.project_in.weight", "quantizer.project_down.weight",
                  "fsq.project_in.weight", "proj.weight"], (n_lv, d))
        filler.put(f"{P}/fsq_proj/kernel", w.T)
        filler.put(f"{P}/fsq_proj/bias",
                   find(["quantizer.project_in.bias", "quantizer.project_down.bias",
                         "fsq.project_in.bias", "proj.bias"], (n_lv,)))
    if f"{P}/codebook" in shapes:
        V, d = shapes[f"{P}/codebook"]
        try:
            cb = find(["quantizer._codebook.embed", "quantizer.codebook", "codebook"], (V, d))
        except KeyError:
            cb = find(["quantizer._codebook.embed"], (1, V, d))[0]
        filler.put(f"{P}/codebook", cb)

    if strict:
        leftovers = sorted(
            k for k, v in raw.items()
            if k not in used
            and v.size > 8           # shape constants / scalars are graph plumbing
            and "position" not in k  # sinusoid table: recomputed, not loaded
        )
        if leftovers:
            raise ValueError(
                "graph tensors not consumed by the conversion (the module does not "
                f"model them — conversion would be silently lossy): {leftovers[:10]}"
                + (f" (+{len(leftovers) - 10} more)" if len(leftovers) > 10 else "")
            )
    return filler.build()


def convert_campplus(weights: Dict[str, np.ndarray], template: dict) -> dict:
    """CAM++ speaker-embedding weights -> models/campplus.py param tree.

    `weights` comes from tools/onnx_reader.read_onnx_weights on the
    reference's campplus.onnx (cli/frontend.py:45,108-118) or from the public
    3D-Speaker CAMPPlus torch state_dict — both use the speakerlab module
    names (head.conv1/bn1/layer{1,2}.{0,1}/conv2/bn2, xvector.tdnn,
    xvector.block{N}.tdnnd{M}.{nonlinear1,linear1,nonlinear2,cam_layer},
    xvector.transit{N}, xvector.out_nonlinear, xvector.dense).

    Structure (block count, layers per block, residual stages) is derived
    from the checkpoint keys; every torch tensor must be consumed and every
    flax leaf filled, so a graph drift fails loudly instead of silently.
    """
    sd = {}
    for k, v in weights.items():
        stripped = True
        while stripped:
            stripped = False
            for pre in ("campplus.", "model.", "module."):
                if k.startswith(pre):
                    k = k[len(pre):]
                    stripped = True
        arr = np.asarray(v, np.float32)
        if k in sd and not (sd[k].shape == arr.shape and np.array_equal(sd[k], arr)):
            raise ValueError(f"prefix-stripping collision on '{k}': differing duplicate weights")
        sd[k] = arr
    used = set()

    def take(k):
        used.add(k)
        return sd[k]

    tf = TreeFiller(template)
    P = "params"

    def conv2d(t, f):  # torch [out, in, kh, kw] -> flax [kh, kw, in, out]
        tf.put(f"{P}/{f}/kernel", take(f"{t}.weight").transpose(2, 3, 1, 0))

    def conv1d(t, f, bias=False):
        tf.put(f"{P}/{f}/kernel", _conv(take(f"{t}.weight")))
        if bias:
            tf.put(f"{P}/{f}/bias", take(f"{t}.bias"))

    def bn(t, f, affine=True):
        tf.put(f"{P}/{f}/mean", take(f"{t}.running_mean"))
        tf.put(f"{P}/{f}/var", take(f"{t}.running_var"))
        if affine:
            tf.put(f"{P}/{f}/scale", take(f"{t}.weight"))
            tf.put(f"{P}/{f}/bias", take(f"{t}.bias"))
        used.add(f"{t}.num_batches_tracked")

    # ---- head (FCM) ----
    conv2d("head.conv1", "head/conv1")
    bn("head.bn1", "head/bn1")
    for li in (1, 2):
        n_blocks = 1 + max(
            int(k.split(".")[2]) for k in sd if k.startswith(f"head.layer{li}."))
        for bi in range(n_blocks):
            t, f = f"head.layer{li}.{bi}", f"head/layer{li}_{bi}"
            conv2d(f"{t}.conv1", f"{f}/conv1")
            bn(f"{t}.bn1", f"{f}/bn1")
            conv2d(f"{t}.conv2", f"{f}/conv2")
            bn(f"{t}.bn2", f"{f}/bn2")
            if f"{t}.shortcut.0.weight" in sd:
                conv2d(f"{t}.shortcut.0", f"{f}/shortcut_conv")
                bn(f"{t}.shortcut.1", f"{f}/shortcut_bn")
    conv2d("head.conv2", "head/conv2")
    bn("head.bn2", "head/bn2")

    # ---- xvector trunk ----
    conv1d("xvector.tdnn.linear", "tdnn_linear")
    bn("xvector.tdnn.nonlinear.batchnorm", "tdnn_bn")
    n_dense = len({k.split(".")[1] for k in sd if k.startswith("xvector.block")})
    for i in range(1, n_dense + 1):
        n_layers = len({
            k.split(".")[2] for k in sd if k.startswith(f"xvector.block{i}.")})
        for j in range(1, n_layers + 1):
            t, f = f"xvector.block{i}.tdnnd{j}", f"block{i}/tdnnd{j}"
            bn(f"{t}.nonlinear1.batchnorm", f"{f}/nonlinear1_bn")
            conv1d(f"{t}.linear1", f"{f}/linear1")
            bn(f"{t}.nonlinear2.batchnorm", f"{f}/nonlinear2_bn")
            conv1d(f"{t}.cam_layer.linear_local", f"{f}/cam_layer/linear_local")
            conv1d(f"{t}.cam_layer.linear1", f"{f}/cam_layer/linear1", bias=True)
            conv1d(f"{t}.cam_layer.linear2", f"{f}/cam_layer/linear2", bias=True)
        bn(f"xvector.transit{i}.nonlinear.batchnorm", f"transit{i}_bn")
        conv1d(f"xvector.transit{i}.linear", f"transit{i}_linear")
    bn("xvector.out_nonlinear.batchnorm", "out_bn")
    conv1d("xvector.dense.linear", "dense_linear")
    bn("xvector.dense.nonlinear.batchnorm", "dense_bn", affine=False)

    leftover = set(sd) - used
    assert not leftover, f"unconsumed campplus tensors: {sorted(leftover)[:10]}"
    return tf.build()


# ---------------------------------------------------------------------------
# CosyVoice-300M (v1): the WeNet conformer layers, TransformerLM (llm.pt)
# and MaskedDiffWithXvec (flow.pt)
# ---------------------------------------------------------------------------

def _conformer_layer(sd, used, filler, t, f, flat_attn=False):
    """Map one WeNet encoder layer. flat_attn=True targets the v1 LM's
    RelPosDecoderLayer, whose attention linears, FFN and position biases
    sit at the layer level."""

    def lin(tt, ff, bias=True):
        filler.put(f"{ff}/kernel", _lin(sd[f"{tt}.weight"])); used.add(f"{tt}.weight")
        if bias:
            filler.put(f"{ff}/bias", sd[f"{tt}.bias"]); used.add(f"{tt}.bias")

    def ln(tt, ff):
        filler.put(f"{ff}/scale", sd[f"{tt}.weight"]); used.add(f"{tt}.weight")
        filler.put(f"{ff}/bias", sd[f"{tt}.bias"]); used.add(f"{tt}.bias")

    attn = f if flat_attn else f"{f}/self_attn"
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        lin(f"{t}.self_attn.{name}", f"{attn}/{name}")
    lin(f"{t}.self_attn.linear_pos", f"{attn}/linear_pos", bias=False)
    for name in ("pos_bias_u", "pos_bias_v"):
        filler.put(f"{attn}/{name}", sd[f"{t}.self_attn.{name}"]); used.add(f"{t}.self_attn.{name}")
    if flat_attn:
        lin(f"{t}.feed_forward.w_1", f"{f}/ff_w1")
        lin(f"{t}.feed_forward.w_2", f"{f}/ff_w2")
    else:
        lin(f"{t}.feed_forward.w_1", f"{f}/feed_forward/w_1")
        lin(f"{t}.feed_forward.w_2", f"{f}/feed_forward/w_2")
    # the reference ConformerEncoderLayer's norm_mha / norm_ff; TransformerEncoderLayer's norm1 / norm2
    ln(f"{t}.norm_mha" if f"{t}.norm_mha.weight" in sd else f"{t}.norm1", f"{f}/norm_mha")
    ln(f"{t}.norm_ff" if f"{t}.norm_ff.weight" in sd else f"{t}.norm2", f"{f}/norm_ff")


def _wenet_encoder(sd, used, filler, t_prefix, f_prefix, layer_list_name="encoders"):
    """Map a WeNet encoder: the linear input layer, every layer, the final norm."""

    def lin(tt, ff):
        filler.put(f"{ff}/kernel", _lin(sd[f"{tt}.weight"])); used.add(f"{tt}.weight")
        filler.put(f"{ff}/bias", sd[f"{tt}.bias"]); used.add(f"{tt}.bias")

    def ln(tt, ff):
        filler.put(f"{ff}/scale", sd[f"{tt}.weight"]); used.add(f"{tt}.weight")
        filler.put(f"{ff}/bias", sd[f"{tt}.bias"]); used.add(f"{tt}.bias")

    lin(f"{t_prefix}.embed.out.0", f"{f_prefix}/embed/out_dense")
    ln(f"{t_prefix}.embed.out.1", f"{f_prefix}/embed/out_norm")
    n = len({m.group(1) for k in sd if (m := re.match(rf"{re.escape(t_prefix)}\.encoders\.(\d+)\.", k))})
    for i in range(n):
        _conformer_layer(sd, used, filler, f"{t_prefix}.encoders.{i}", f"{f_prefix}/{layer_list_name}_{i}")
    ln(f"{t_prefix}.after_norm", f"{f_prefix}/after_norm")


def convert_llm_v1(sd: Dict[str, np.ndarray], template: dict) -> dict:
    """llm.pt of CosyVoice-300M -> the TransformerLMModule tree: the text
    encoder and the LM body (`llm.encoders.<i>` -> lm_layers_<i>); the
    position-encoding buffers and the loss's keys are not weights."""
    tf = TreeFiller(template)
    used = set()
    p = "params"

    def lin(t, f):
        tf.put(f"{f}/kernel", _lin(sd[f"{t}.weight"])); used.add(f"{t}.weight")
        tf.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    def ln(t, f):
        tf.put(f"{f}/scale", sd[f"{t}.weight"]); used.add(f"{t}.weight")
        tf.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    for name in ("text_embedding", "llm_embedding", "speech_embedding"):
        tf.put(f"{p}/{name}/embedding", sd[f"{name}.weight"]); used.add(f"{name}.weight")
    for name in ("text_encoder_affine_layer", "spk_embed_affine_layer", "llm_decoder"):
        lin(name, f"{p}/{name}")
    _wenet_encoder(sd, used, tf, "text_encoder", f"{p}/text_encoder")
    lin("llm.embed.out.0", f"{p}/lm_embed/out_dense")
    ln("llm.embed.out.1", f"{p}/lm_embed/out_norm")
    n = len({m.group(1) for k in sd if (m := re.match(r"llm\.encoders\.(\d+)\.", k))})
    for i in range(n):
        _conformer_layer(sd, used, tf, f"llm.encoders.{i}", f"{p}/lm_layers_{i}", flat_attn=True)
    ln("llm.after_norm", f"{p}/lm_after_norm")
    leftover = {k for k in set(sd) - used if "criterion" not in k and "pe" not in k.split(".")[-1]}
    assert not leftover, f"unconsumed torch keys: {sorted(leftover)[:10]}"
    return tf.build()


def convert_flow_v1(sd: Dict[str, np.ndarray], template: dict) -> dict:
    """flow.pt of CosyVoice-300M -> {"encoder", "estimator"} trees: the
    conformer encoder, the length regulator's conv stack (a Sequential of
    [conv, GroupNorm, Mish] x n + a 1x1 conv) and the non-causal
    multi-level U-Net (matcha Block1D: conv .0, GroupNorm .1; plain
    ConvTranspose1d upsampling, carried onto the weight-normed layout as
    v = w, g = the per-input-channel norm of w)."""
    enc = TreeFiller(template["encoder"])
    est = TreeFiller(template["estimator"])
    used = set()
    p = "params"

    def lin(t, f, filler, bias=True):
        filler.put(f"{f}/kernel", _lin(sd[f"{t}.weight"])); used.add(f"{t}.weight")
        if bias:
            filler.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    def ln(t, f, filler):  # LayerNorm and GroupNorm alike
        filler.put(f"{f}/scale", sd[f"{t}.weight"]); used.add(f"{t}.weight")
        filler.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    def conv(t, f, filler):
        filler.put(f"{f}/kernel", _conv(sd[f"{t}.weight"])); used.add(f"{t}.weight")
        filler.put(f"{f}/bias", sd[f"{t}.bias"]); used.add(f"{t}.bias")

    enc.put(f"{p}/input_embedding/embedding", sd["input_embedding.weight"]); used.add("input_embedding.weight")
    lin("spk_embed_affine_layer", f"{p}/spk_embed_affine_layer", enc)
    lin("encoder_proj", f"{p}/encoder_proj", enc)
    _wenet_encoder(sd, used, enc, "encoder", f"{p}/encoder")
    i = idx = 0
    while (f"length_regulator.model.{idx}.weight" in sd and sd[f"length_regulator.model.{idx}.weight"].ndim == 3
           and f"length_regulator.model.{idx + 1}.weight" in sd):
        conv(f"length_regulator.model.{idx}", f"{p}/regulator/conv_{i}", enc)
        ln(f"length_regulator.model.{idx + 1}", f"{p}/regulator/norm_{i}", enc)
        i += 1
        idx += 3
    conv(f"length_regulator.model.{idx}", f"{p}/regulator/proj", enc)

    d = "decoder.estimator"
    lin(f"{d}.time_mlp.linear_1", f"{p}/time_mlp/linear_1", est)
    lin(f"{d}.time_mlp.linear_2", f"{p}/time_mlp/linear_2", est)

    def block(t, f):
        conv(f"{t}.block.0", f"{f}/conv", est)
        ln(f"{t}.block.1", f"{f}/norm", est)

    def resnet(t, f):
        block(f"{t}.block1", f"{f}/block1")
        block(f"{t}.block2", f"{f}/block2")
        lin(f"{t}.mlp.1", f"{f}/mlp", est)
        conv(f"{t}.res_conv", f"{f}/res_conv", est)

    def tblock(t, f):
        ln(f"{t}.norm1", f"{f}/norm1", est)
        ln(f"{t}.norm3", f"{f}/norm3", est)
        for n in ("to_q", "to_k", "to_v"):
            lin(f"{t}.attn1.{n}", f"{f}/attn1/{n}", est, bias=False)
        lin(f"{t}.attn1.to_out.0", f"{f}/attn1/to_out", est)
        lin(f"{t}.ff.net.0.proj", f"{f}/ff_in", est)
        lin(f"{t}.ff.net.2", f"{f}/ff_out", est)

    def conv_t_plain(t, f):
        w = _convT(sd[f"{t}.weight"])  # [k, in, out]
        est.put(f"{f}/v", w)
        est.put(f"{f}/g", np.sqrt((w.astype(np.float64) ** 2).sum(axis=(0, 2))).astype(np.float32))
        est.put(f"{f}/bias", sd[f"{t}.bias"])
        used.update({f"{t}.weight", f"{t}.bias"})

    n_levels = len({m.group(1) for k in sd if (m := re.match(rf"{re.escape(d)}\.down_blocks\.(\d+)\.", k))})
    n_tf = len({m.group(1) for k in sd if (m := re.match(rf"{re.escape(d)}\.down_blocks\.0\.1\.(\d+)\.", k))})
    for lv in range(n_levels):
        resnet(f"{d}.down_blocks.{lv}.0", f"{p}/down_resnet_{lv}")
        for j in range(n_tf):
            tblock(f"{d}.down_blocks.{lv}.1.{j}", f"{p}/down_tf_{lv}_{j}")
        if lv < n_levels - 1:
            conv(f"{d}.down_blocks.{lv}.2.conv", f"{p}/downsample_{lv}/conv", est)
        else:
            conv(f"{d}.down_blocks.{lv}.2", f"{p}/down_post_{lv}", est)
    n_mid = len({m.group(1) for k in sd if (m := re.match(rf"{re.escape(d)}\.mid_blocks\.(\d+)\.", k))})
    for i in range(n_mid):
        resnet(f"{d}.mid_blocks.{i}.0", f"{p}/mid_resnet_{i}")
        for j in range(n_tf):
            tblock(f"{d}.mid_blocks.{i}.1.{j}", f"{p}/mid_tf_{i}_{j}")
    for lv in range(n_levels):
        resnet(f"{d}.up_blocks.{lv}.0", f"{p}/up_resnet_{lv}")
        for j in range(n_tf):
            tblock(f"{d}.up_blocks.{lv}.1.{j}", f"{p}/up_tf_{lv}_{j}")
        if lv < n_levels - 1:
            conv_t_plain(f"{d}.up_blocks.{lv}.2.conv", f"{p}/upsample_{lv}/conv")
        else:
            conv(f"{d}.up_blocks.{lv}.2", f"{p}/up_post_{lv}", est)
    block(f"{d}.final_block", f"{p}/final_block")
    conv(f"{d}.final_proj", f"{p}/final_proj", est)
    leftover = {k for k in set(sd) - used if "rand_noise" not in k}
    assert not leftover, f"unconsumed torch keys: {sorted(leftover)[:12]}"
    return {"encoder": enc.build(), "estimator": est.build()}


def template(module_fn) -> dict:
    """The JAX param tree's LeafSpecs for the module `module_fn` builds,
    built on the meta device (no weights made)."""
    with torch.device("meta"):
        return export_params(module_fn())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model_dir", required=True, help="reference model dir with llm.pt/flow.pt/hift.pt")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--version", type=int, default=2)
    parser.add_argument("--s3_onnx", default="", help="speech_tokenizer_v*.onnx to convert (optional)")
    parser.add_argument("--campplus_onnx", default="", help="campplus.onnx to convert (optional)")
    args = parser.parse_args(argv)
    if args.version not in (1, 2, 3):
        raise ValueError(f"unsupported model version {args.version}")
    lm_module, flow_module = Qwen2LMModule, CausalFlow
    if args.version == 1:
        lm_cfg, flow_cfg, hift_cfg = LMv1Config(), FlowV1Config(), v1_hift_config()
        lm_conv, flow_conv = convert_llm_v1, convert_flow_v1
        lm_module, flow_module = TransformerLMModule, MaskedDiffFlow
    elif args.version == 3:
        lm_cfg, flow_cfg, hift_cfg = cosyvoice3_configs()
        lm_conv, flow_conv = convert_llm_v3, convert_flow_v3
    else:
        lm_cfg, flow_cfg, hift_cfg = LMConfig(), FlowConfig(), HiFTConfig()
        lm_conv, flow_conv = convert_llm_v2, convert_flow_v2

    os.makedirs(args.out_dir, exist_ok=True)
    # templates are built per converted file: converting only --s3_onnx
    # builds no other module
    for name, conv_fn, module_fn in (
        ("llm", lm_conv, lambda: lm_module(lm_cfg)),
        ("flow", flow_conv, lambda: flow_module(flow_cfg, device="meta")),
        ("hift", convert_hift, lambda: HiFTGenerator(hift_cfg, device="meta")),
    ):
        src = os.path.join(args.model_dir, f"{name}.pt")
        if not os.path.exists(src):
            print(f"skip {name}: {src} not found")
            continue
        params = conv_fn(load_torch_state(src), template(module_fn))
        # the API reads lm.msgpack: the JAX package's name for the LM file
        out = "lm" if name == "llm" else name
        msgpack_io.write(os.path.join(args.out_dir, f"{out}.msgpack"), params)
        print(f"converted {name}")

    if args.s3_onnx:
        s3_weights = read_onnx_weights(args.s3_onnx)
        # architecture comes from the graph itself (depth/width/quantizer
        # family), never from the --version flag
        s3_cfg = s3_config_from_weights(s3_weights)
        print(f"s3 graph: d={s3_cfg.d_model} layers={s3_cfg.num_layers} "
              f"{'fsq' + str(len(s3_cfg.fsq_levels)) if s3_cfg.use_fsq else 'vq' + str(s3_cfg.codebook_size)} "
              f"rate_div={s3_cfg.token_rate_div}")
        params = convert_s3_tokenizer(s3_weights, template(lambda: S3Tokenizer(s3_cfg)))
        msgpack_io.write(os.path.join(args.out_dir, "speech_tokenizer.msgpack"), params)
        print("converted speech_tokenizer")

    if args.campplus_onnx:
        params = convert_campplus(read_onnx_weights(args.campplus_onnx), template(lambda: CamPPEmbedding(CamPPConfig())))
        msgpack_io.write(os.path.join(args.out_dir, "campplus.msgpack"), params)
        print("converted campplus")


if __name__ == "__main__":
    main()
