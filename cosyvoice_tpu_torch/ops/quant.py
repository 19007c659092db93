"""Weight-only quantisation of the LM's param tree, on the host.

Counterpart of `cosyvoice_tpu/ops/quant.py`, for the mode the port serves:
"int4p", where qkv, o, gate|up and down take the blocked half-split int4
layouts of `ops/int4_fused.py` (served by kernels K4 and K6) and the
`llm_decoder` head stays int8 weight-only (per-output-channel absmax; the
CosyVoice3 head has no bias, and none is made for it). The
functions take and return nested dicts of numpy arrays in the JAX package's
names and layouts ([in, out] kernels), and give bit-identical output on the
same input. Modes "int8" and "int4" are not ported.
"""

from typing import Tuple

import numpy as np

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
    path_pred by quantize(path, kernel) plus the bias."""

    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node and getattr(node["kernel"], "ndim", 0) == 2 and path_pred(path):
                out = quantize(path, np.asarray(node["kernel"]))
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


def quantize_dense_tree_int4p(params, path_pred):
    """Blocked half-split int4: qkv/o -> {kernel_q4b [nb, 128, out], scale4
    [nb, out]}; gate_up -> gate|up planes padded to the aligned intermediate;
    down -> 512-row scale blocks over the padded intermediate."""

    def q(path, w):
        pack = {"gate_up_proj": pack_gate_up_int4, "down_proj": pack_down_int4}.get(path[-1], pack_gemv_int4)
        wq, scale = pack(w)
        return {"kernel_q4b": wq, "scale4": scale}

    return _map_dense(params, path_pred, q)


def quantize_lm_params(params, mode: str):
    """fp Qwen2LM param tree -> the tree of the quantised module. mode
    "int4p": the body in the int4p layouts, the llm_decoder head int8."""
    if mode != "int4p":
        raise NotImplementedError(f"quantize_lm_params mode {mode!r}: the port serves 'int4p' only")

    def body(path):
        return bool(path) and path[-1] in QUANT_LM_LAYERS and path[-1] != "llm_decoder"

    params = quantize_dense_tree_int4p(params, body)
    return quantize_dense_tree(params, lambda path: bool(path) and path[-1] == "llm_decoder")
