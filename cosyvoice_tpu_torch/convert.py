"""Carry the JAX package's parameters into the port's modules.

`load_jax_params(module, tree)` takes a param tree of the JAX package
(`Qwen2LM.init`, `CausalFlow.init`, `HiFTGenerator.init`, the v1
`TransformerLM.init` and `MaskedDiffFlow.init`, as nested dicts of numpy
arrays) and copies every leaf into the matching parameter of the port's
module (Qwen2LMModule, CausalFlow, HiFTGenerator, TransformerLMModule,
MaskedDiffFlow, the GAN's MultipleDiscriminator, and the frontend's
S3Tokenizer and CamPPEmbedding; `load_gan_params` takes a GAN checkpoint):

- names: "/"-joined Flax paths become "."-joined PyTorch names, with the
  Flax list suffixes (`layers_3`, `mid_tf_2_1`) as ModuleList indices
  (`layers.3`, `mid_tf.2.1`, `blocks.0`) and `kernel`/`embedding`/`scale`
  as `weight`, unless the port's module has a parameter of the leaf's own
  name: the quantised leaves (`kernel_q4b`, `kernel_q4`, `scale4`, and the
  int8 layers' `kernel_q` and `scale`) and CAM++'s batch norms (`mean`, `var`, `scale`,
  `bias`) keep their names;
- layouts: Dense [in, out] -> Linear [out, in]; conv [k, in, out] ->
  [out, in, k]; 2-D conv [kF, kT, in, out] -> [out, in, kF, kT];
  weight-normed ConvTranspose v [k, in, out] -> [in, out, k];
  the int8 layers' kernel_q [in, out] -> [out, in] and scale [1, out] ->
  [out]; the int4 and int4p layouts (`kernel_q4`, `kernel_q4b`, `scale4`)
  as they are.

It raises if a leaf has no parameter, a shape differs, or a parameter is left
unset. Values are cast to each parameter's dtype (bf16 LM layers on the card).

`export_params(module)` is the inverse for these module families (the
discriminator's 2-D kernels OIHW -> HWIO): the
module's parameters as the JAX module's variable dict (`{"params": ...}`;
the flows' per sub-model), in the JAX layouts and dtypes. It is what
`save_pretrained` writes, what quantises random weights made on the card
(`ops/quant.quantize_lm_params`), and, run on a module built on the meta
device, the Flax paths and shapes the converters fill.

Leaves may be read-only or unaligned views of a checkpoint file's buffer
(utils/msgpack_io.py), bfloat16 ones included: `load_jax_params` copies
them straight into the parameters.
"""

import re
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from cosyvoice_tpu_torch.models.flow import CausalFlow
from cosyvoice_tpu_torch.models.flow_v1 import MaskedDiffFlow
from cosyvoice_tpu_torch.models.qwen2 import Int4PWeights, QuantDense, RMSNorm
from cosyvoice_tpu_torch.nn.conv import Conv1d, WNConvTranspose1d
from cosyvoice_tpu_torch.utils.msgpack_io import to_torch

_LISTS = (
    "layers|lm_layers|encoders|up_encoders|condnet|resblocks|source_resblocks|source_downs|ups|act1|act2|convs1|convs2"
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
        value = _port_layout(path[-1], arr, owner)
        p = params[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: JAX shape {arr.shape} -> {value.shape}, port {name} has {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(to_torch(value))
        done.add(name)
    unset = sorted(set(params) - done)
    if unset:
        raise KeyError(f"port parameters left unset by the JAX tree: {unset}")
    return module


_LIST_INDEX = re.compile(r"\.(\d+)")
# the Flax leaf behind a port parameter named `weight`, by its owner's type
# (any other owner of a `weight` holds a Dense or conv kernel)
_WEIGHT_LEAF = ((nn.Embedding, "embedding"), (nn.LayerNorm, "scale"), (nn.GroupNorm, "scale"), (RMSNorm, "weight"))
# the inverse of _port_layout: port layout -> JAX layout
_PERM = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


class LeafSpec(NamedTuple):
    """Shape and dtype of one JAX leaf, without its values."""

    shape: tuple
    dtype: np.dtype


def _jax_leaf(name: str, p: torch.Tensor, owner):
    """(Flax leaf name, the function from the port's layout to the JAX
    layout) of port parameter `name` held by `owner`."""
    leaf = name.rsplit(".", 1)[-1]
    if isinstance(owner, QuantDense) and leaf != "bias":
        return leaf, (lambda a: a.T) if leaf == "kernel_q" else (lambda a: a[None])
    if isinstance(owner, WNConvTranspose1d) and leaf == "v":
        return leaf, lambda a: a.transpose(2, 0, 1)
    if leaf == "v":
        return leaf, lambda a: a.transpose(2, 1, 0)
    if leaf != "weight" or isinstance(owner, (QuantDense, Int4PWeights)):
        return leaf, lambda a: a
    for cls, jax_name in _WEIGHT_LEAF:
        if isinstance(owner, cls):
            return jax_name, lambda a: a
    if not isinstance(owner, (nn.Linear, Conv1d, nn.Conv2d)) or p.dim() not in _PERM:
        raise TypeError(f"export_params: no JAX layout for {name} of {type(owner).__name__}")
    return "kernel", lambda a: a.transpose(_PERM[p.dim()])


def _collections(module: nn.Module, tree: dict) -> dict:
    """The JAX module's variable dict around `tree`: {"params": tree}, or
    per sub-model for the flow ({"encoder": {"params": ...}, "estimator":
    {"params": ...}}, as CausalFlow.init returns it)."""
    if isinstance(module, (CausalFlow, MaskedDiffFlow)):
        return {k: {"params": v} for k, v in tree.items()}
    return {"params": tree}


def load_gan_params(generator: nn.Module, discriminator: nn.Module, tree) -> bool:
    """A HiFT GAN checkpoint into the modules: {"generator", "discriminator"}
    (the tree bin/train.py --model hifigan writes in either package) into
    both, or a generator-only tree (a converted hift.msgpack) into the
    generator. Returns whether the discriminator was loaded."""
    if set(tree) == {"generator", "discriminator"}:
        load_jax_params(generator, tree["generator"])
        load_jax_params(discriminator, tree["discriminator"])
        return True
    load_jax_params(generator, tree)
    return False


def export_params(module: nn.Module) -> dict:
    """The JAX param tree of `module` (Qwen2LMModule, fp, int8, int4 or
    int4p; CausalFlow; HiFTGenerator; TransformerLMModule; MaskedDiffFlow;
    S3Tokenizer; CamPPEmbedding), the inverse of
    load_jax_params: nested dicts as the JAX module's `init` returns them,
    each leaf a host numpy array in the JAX layout and the JAX dtype
    (float32 for floating parameters, so a bf16 LM exports bf16-exact
    values; the quantised int8 leaves as they are). On a module built on
    torch.device("meta") the leaves are LeafSpecs: the Flax paths, shapes
    and dtypes the converters fill (tools/convert_checkpoint.py)."""
    tree = {}
    params = dict(module.named_parameters())
    for name, p in params.items():
        owner_name = name.rsplit(".", 1)[0] if "." in name else ""
        leaf, layout = _jax_leaf(name, p, module.get_submodule(owner_name))
        path = tuple(_LIST_INDEX.sub(r"_\1", owner_name).split(".")) if owner_name else ()
        if port_name(path + (leaf,), params) != name:
            raise AssertionError(f"export_params: {name} -> {'/'.join(path + (leaf,))} does not load back")
        dtype = np.dtype(np.float32) if p.is_floating_point() else np.dtype(str(p.dtype).split(".")[1])
        if p.is_meta:
            value = LeafSpec(layout(np.broadcast_to(np.zeros((), dtype), tuple(p.shape))).shape, dtype)
        else:
            t = p.detach().to("cpu", torch.float32 if p.is_floating_point() else p.dtype)
            value = np.ascontiguousarray(layout(t.numpy()))
        node = tree
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = value
    return _collections(module, tree)
