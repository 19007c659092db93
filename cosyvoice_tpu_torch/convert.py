"""Carry the JAX package's parameters into the port's modules.

`load_jax_params(module, tree)` takes a param tree of the JAX package
(`Qwen2LM.init`, `CausalFlow.init`, `HiFTGenerator.init`, as nested dicts of
numpy arrays) and copies every leaf into the matching parameter of the port's
module (Qwen2LMModule, CausalFlow, HiFTGenerator, and the frontend's
S3Tokenizer and CamPPEmbedding):

- names: "/"-joined Flax paths become "."-joined PyTorch names, with the
  Flax list suffixes (`layers_3`, `mid_tf_2_1`) as ModuleList indices
  (`layers.3`, `mid_tf.2.1`, `blocks.0`) and `kernel`/`embedding`/`scale`
  as `weight`, unless the port's module has a parameter of the leaf's own
  name: the quantised leaves (`kernel_q4b`, `scale4`, and the int8 head's
  `kernel_q` and `scale`) and CAM++'s batch norms (`mean`, `var`, `scale`,
  `bias`) keep their names;
- layouts: Dense [in, out] -> Linear [out, in]; conv [k, in, out] ->
  [out, in, k]; 2-D conv [kF, kT, in, out] -> [out, in, kF, kT];
  weight-normed ConvTranspose v [k, in, out] -> [in, out, k];
  the int8 head's kernel_q [in, out] -> [out, in] and scale [1, out] ->
  [out]; the int4p layouts (`kernel_q4b`, `scale4`) as they are.

It raises if a leaf has no parameter, a shape differs, or a parameter is left
unset. Values are cast to each parameter's dtype (bf16 LM layers on the card).

`export_lm_params(module)` is the inverse for the LM's modules: the port's
Qwen2LMModule as a JAX param tree, e.g. to quantise random weights made on
the card with `ops/quant.quantize_lm_params`.
"""

import re

import numpy as np
import torch
from torch import nn

from cosyvoice_tpu_torch.models.qwen2 import Int4PWeights, QuantDense, RMSNorm
from cosyvoice_tpu_torch.nn.conv import WNConvTranspose1d

_LISTS = (
    "layers|encoders|up_encoders|condnet|resblocks|source_resblocks|source_downs|ups|act1|act2|convs1|convs2"
    "|down_resnet|mid_resnet|up_resnet|down_post|up_post|down_tf|mid_tf|up_tf|blocks"
)
_LIST_SEGMENT = re.compile(rf"^({_LISTS})((?:_\d+)+)$")
_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for key, sub in tree.items():
            yield from _flatten(sub, prefix + (str(key),))
    else:
        yield prefix, np.asarray(tree)


def port_name(path, params=()) -> str:
    """Flax path (tuple of keys) -> the port's parameter name. A leaf keeps
    its own name where `params` (the port's parameter names) has it."""
    parts = []
    for seg in path[:-1]:
        if seg == "params":
            continue
        m = _LIST_SEGMENT.match(seg)
        parts.append(m.group(1) + m.group(2).replace("_", ".") if m else seg)
    literal = ".".join(parts + [path[-1]])
    if literal in params:
        return literal
    return ".".join(parts + [_LEAF_NAMES.get(path[-1], path[-1])])


def _port_layout(leaf: str, arr: np.ndarray, owner) -> np.ndarray:
    if isinstance(owner, QuantDense):
        return {"kernel_q": arr.T, "scale": arr.reshape(-1)}.get(leaf, arr)
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    if leaf == "kernel" and arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if leaf == "v":
        return arr.transpose(1, 2, 0) if isinstance(owner, WNConvTranspose1d) else arr.transpose(2, 1, 0)
    return arr


def load_jax_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX param tree into `module` in place; returns the module."""
    params = dict(module.named_parameters())
    done = set()
    for path, arr in _flatten(tree):
        name = port_name(path, params)
        if name not in params:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no port parameter (looked for {name})")
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        value = np.ascontiguousarray(_port_layout(path[-1], arr, owner))
        p = params[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: JAX shape {arr.shape} -> {value.shape}, port {name} has {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.tensor(value))
        done.add(name)
    unset = sorted(set(params) - done)
    if unset:
        raise KeyError(f"port parameters left unset by the JAX tree: {unset}")
    return module


_LIST_INDEX = re.compile(r"\.(\d+)")


def export_lm_params(module: nn.Module) -> dict:
    """The LM module's parameters as a JAX param tree (nested dicts of float32
    or int8 numpy arrays on the host), the inverse of load_jax_params for the
    module types of the LM: Linear, Embedding, RMSNorm, QuantDense and the
    int4p holders. Raises on any other owner."""
    tree = {}
    for name, p in module.named_parameters():
        owner_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        owner = module.get_submodule(owner_name)
        arr = p.detach().cpu()
        arr = (arr if arr.dtype == torch.int8 else arr.float()).numpy()
        if isinstance(owner, nn.Linear) and leaf == "weight":
            leaf, arr = "kernel", arr.T
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif isinstance(owner, QuantDense) and leaf != "bias":
            arr = arr.T if leaf == "kernel_q" else arr[None]
        elif not isinstance(owner, (nn.Linear, RMSNorm, Int4PWeights, QuantDense)):
            raise TypeError(f"export_lm_params: no JAX layout for {name} of {type(owner).__name__}")
        node = tree
        for seg in _LIST_INDEX.sub(r"_\1", owner_name).split(".") if owner_name else []:
            node = node.setdefault(seg, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree
