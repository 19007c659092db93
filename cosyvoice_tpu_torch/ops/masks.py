"""Padding / chunk masks (counterpart of cosyvoice_tpu/ops/masks.py)."""

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
