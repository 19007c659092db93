"""Padding / chunk masks (counterpart of cosyvoice_tpu/ops/masks.py), and the
incremental chunk masks over KV arenas (cosyvoice_tpu/nn/conformer.py:
chunk_arena_mask, cosyvoice_tpu/models/flow_decoder.py:_chunk_attn_bias)."""

import torch


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True inside the sequence."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def subsequent_chunk_mask(size: int, chunk_size: int, device=None) -> torch.Tensor:
    """[size, size] bool: position i attends to j iff j < (i//chunk+1)*chunk."""
    i = torch.arange(size, device=device)[:, None]
    j = torch.arange(size, device=device)[None, :]
    return j < (i // chunk_size + 1) * chunk_size


def add_optional_chunk_mask(pad_mask: torch.Tensor, static_chunk_size: int) -> torch.Tensor:
    """Combine a [B, 1, T] non-pad mask with a static chunk mask -> [B, T, T].
    static_chunk_size <= 0 means full attention."""
    T = pad_mask.shape[-1]
    if static_chunk_size > 0:
        return pad_mask & subsequent_chunk_mask(T, static_chunk_size, pad_mask.device)[None]
    return pad_mask.expand(pad_mask.shape[0], T, T)


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool mask -> additive attention bias (0 keep / -1e10 drop)."""
    return (1.0 - mask.to(dtype)) * -1.0e10


def chunk_arena_mask(B: int, n: int, A: int, pos: int, real_n: int, chunk: int, device=None) -> torch.Tensor:
    """Bool mask [B, n, A] for incremental chunk queries at positions pos+i
    over the first A rows of a KV arena that holds pos+real_n valid keys,
    under the streaming chunk rule (key s visible iff s < (t//chunk+1)*chunk)."""
    i = torch.arange(n, device=device)[None, :, None]
    s = torch.arange(A, device=device)[None, None, :]
    keep = s < (((pos + i) // chunk + 1) * chunk).clamp_max(pos + real_n)
    return keep.expand(B, n, A)


def chunk_attn_bias(B: int, n: int, A: int, pos: int, real_n: int, chunk: int, device=None) -> torch.Tensor:
    """Additive bias [B, n, A] of chunk_arena_mask (the estimator's arena
    attention). Chunk boundaries are hop-aligned in the engine, so the
    frontier cuts a chunk only at finalize: exactly the full-recompute mask
    restricted to the new rows."""
    return mask_to_bias(chunk_arena_mask(B, n, A, pos, real_n, chunk, device))
