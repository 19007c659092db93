"""Deterministic random weights, made on the parameters' device from a seed."""

import math

import torch
from torch import nn


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Refill every parameter from one torch.Generator seeded with `seed`:
    embedding tables N(0, 1); matrices and conv kernels U(+-1/sqrt(fan_in));
    biases and batch-norm running means 0; other vectors (norm weights and
    running variances, weight-norm gains, snake alphas) 1. Returns the
    module."""
    gens = {}
    embeddings = {id(m.weight) for m in module.modules() if isinstance(m, nn.Embedding)}
    for name, p in module.named_parameters():
        dev = p.device
        if dev not in gens:
            gens[dev] = torch.Generator(device=dev).manual_seed(seed)
        g = gens[dev]
        if id(p) in embeddings:
            p.copy_(torch.randn(p.shape, generator=g, device=dev))
        elif p.dim() >= 2:
            bound = 1.0 / math.sqrt(p[0].numel())
            p.copy_(torch.rand(p.shape, generator=g, device=dev) * (2 * bound) - bound)
        elif name.endswith(("bias", "mean")):
            p.zero_()
        else:
            p.fill_(1.0)
    return module
