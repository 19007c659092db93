"""Weight-only quantisation of the LM's param tree, on the host.

Counterpart of `cosyvoice_tpu/ops/quant.py`, in its three modes:

- "int8" (also `True`): qkv, o, gate|up, down and the `llm_decoder` head
  become int8 weight-only kernels with per-output-channel absmax scales
  (`QuantDense`);
- "int4": the body's kernels become half-split nibble-packed int4 with 8
  input-blockwise scales (`quantize_tensor_int4`, `QuantDense4`), the head
  stays int8;
- "int4p": the body takes the blocked half-split int4 layouts of
  `ops/int4_fused.py` (served by kernels K4..K7), the head stays int8.

The CosyVoice3 head has no bias, and none is made for it. The functions
take and return nested dicts of numpy arrays in the JAX package's names and
layouts ([in, out] kernels), and give bit-identical output on the same
input. `unpack_int4` / `int4_matmul` are the int4 product in PyTorch: the
dot summed per scale block, as the JAX function computes it.
"""

from typing import Tuple

import numpy as np
import torch

from cosyvoice_tpu_torch.ops.int4_fused import pack_down_int4, pack_gate_up_int4, pack_gemv_int4

# the LM decode path's matmuls (fused qkv / o / gate|up / down, and the head)
QUANT_LM_LAYERS = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj", "llm_decoder")


def quantize_tensor(w: np.ndarray, axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 along `axis`: (w_q int8, scale f32 with the
    reduced axes kept as size 1)."""
    w = np.asarray(w, np.float32)
    red = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    scale = np.max(np.abs(w), axis=red, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)
    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return wq, scale.astype(np.float32)


def _map_dense(params, path_pred, quantize):
    """Replace every {'kernel': [in, out], (bias)} dict whose path satisfies
    path_pred by quantize(path, kernel) plus the bias (kept as it is where
    quantize returns None)."""

    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node and getattr(node["kernel"], "ndim", 0) == 2 and path_pred(path):
                out = quantize(path, np.asarray(node["kernel"]))
                if out is not None:
                    if "bias" in node:
                        out["bias"] = node["bias"]
                    return out
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return walk(params, ())


def quantize_dense_tree(params, path_pred):
    """int8 weight-only: kernels become {'kernel_q': int8 [in, out], 'scale': [1, out]}."""

    def q(path, w):
        wq, scale = quantize_tensor(w, axis=1)
        return {"kernel_q": wq, "scale": scale}

    return _map_dense(params, path_pred, q)


INT4_BLOCKS = 8  # scale blocks per int4 tensor: the input dim splits into 8 contiguous blocks


def quantize_tensor_int4(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """w [in, out] -> (packed int8 [in/2, out], scale f32 [8, out]): symmetric
    int4 in [-7, 7] with one absmax scale per (input block, output channel);
    packed[i, o] holds w[i, o] in the low nibble and w[i + in/2, o] in the
    high nibble."""
    w = np.asarray(w, np.float32)
    n_in, n_out = w.shape
    if n_in % (2 * INT4_BLOCKS):
        raise ValueError(f"int4 input dim {n_in} is not a multiple of {2 * INT4_BLOCKS}")
    g = w.reshape(INT4_BLOCKS, n_in // INT4_BLOCKS, n_out)
    scale = np.maximum(np.max(np.abs(g), axis=1, keepdims=True) / 7.0, 1e-12)
    q = np.clip(np.round(g / scale), -7, 7).astype(np.int8).reshape(n_in, n_out)
    half = n_in // 2
    packed = (q[:half] & 0x0F) | (q[half:] << 4)
    return packed.astype(np.int8), scale[:, 0, :].astype(np.float32)


def unpack_int4(packed: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """packed int8 [in/2, out] -> [in, out] in `dtype`: the low nibbles (rows
    [0, in/2)) then the high nibbles (rows [in/2, in)), sign-extended."""
    lo = torch.bitwise_left_shift(packed, 4) >> 4  # arithmetic shifts sign-extend
    return torch.cat([lo, packed >> 4], dim=0).to(dtype)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """x [..., in] @ dequant(packed [in/2, out], scale [8, out]) in `dtype`:
    one product per scale block (the block's int4 rows times its scale row),
    summed over the blocks in order, as the JAX int4_matmul does."""
    half = packed.shape[0]
    group = 2 * half // INT4_BLOCKS
    w = unpack_int4(packed, dtype)
    s = scale.to(dtype)
    xd = x.to(dtype)
    y = 0
    for b in range(INT4_BLOCKS):
        rows = slice(b * group, (b + 1) * group)
        y = y + xd[..., rows] @ (w[rows] * s[b])
    return y


def quantize_dense_tree_int4(params, path_pred):
    """int4: kernels whose input dim is a multiple of 16 become {'kernel_q4':
    int8 [in/2, out], 'scale4': [8, out]} (others stay as they are)."""

    def q(path, w):
        if w.shape[0] % (2 * INT4_BLOCKS):
            return None
        wq, scale = quantize_tensor_int4(w)
        return {"kernel_q4": wq, "scale4": scale}

    return _map_dense(params, path_pred, q)


def quantize_dense_tree_int4p(params, path_pred):
    """Blocked half-split int4: qkv/o -> {kernel_q4b [nb, 128, out], scale4
    [nb, out]}; gate_up -> gate|up planes padded to the aligned intermediate;
    down -> 512-row scale blocks over the padded intermediate."""

    def q(path, w):
        pack = {"gate_up_proj": pack_gate_up_int4, "down_proj": pack_down_int4}.get(path[-1], pack_gemv_int4)
        wq, scale = pack(w)
        return {"kernel_q4b": wq, "scale4": scale}

    return _map_dense(params, path_pred, q)


def quant_mode(quant) -> str:
    """The quantisation mode a `Qwen2Config.quant` / `quant_lm` value names:
    True and "int8" are "int8"; "int4" and "int4p" themselves."""
    if quant is True or quant == "int8":
        return "int8"
    if quant in ("int4", "int4p"):
        return quant
    raise ValueError(f"weight quantisation {quant!r}: True, 'int8', 'int4' or 'int4p'")


def quantize_lm_params(params, mode="int8"):
    """fp Qwen2LM param tree -> the tree of the quantised module: mode
    "int8" (or True) every QUANT_LM_LAYERS kernel int8; "int4" / "int4p"
    the body int4 (QuantDense4's / the int4p layouts) and the llm_decoder
    head int8."""
    mode = quant_mode(mode)

    def body(path):
        return bool(path) and path[-1] in QUANT_LM_LAYERS and path[-1] != "llm_decoder"

    if mode == "int8":
        return quantize_dense_tree(params, lambda path: bool(path) and path[-1] in QUANT_LM_LAYERS)
    params = (quantize_dense_tree_int4 if mode == "int4" else quantize_dense_tree_int4p)(params, body)
    return quantize_dense_tree(params, lambda path: bool(path) and path[-1] == "llm_decoder")
