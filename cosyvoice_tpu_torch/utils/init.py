"""Deterministic random weights, made on the parameters' device from a seed.

Each parameter is drawn from the distribution of its JAX counterpart's Flax
initializer, so a model trained from scratch starts where the JAX trainer's
does:

- matrices and conv kernels (nn.Linear, the port's Conv1d, nn.Conv2d):
  lecun_normal, a normal truncated at two standard deviations whose std is
  1/sqrt(fan_in); PyTorch's [out, in, *k] layout has fan_in = in * prod(k);
- embedding tables [V, D]: nn.Embed's normal with std 1/sqrt(D);
- weight-norm directions `v`: normal(0.01); their gains `g`: ones;
- the rel-pos biases `pos_bias_u` / `pos_bias_v` [H, d_k]: xavier_uniform;
- the S3 tokenizer's VQ `codebook`: normal(1.0);
- biases and batch-norm means: zeros; norm scales, batch-norm variances and
  snake alphas: ones.

Frozen (requires_grad=False) parameters, the quantised layouts' int8 codes
and their scales, keep the values their modules were built with.
"""

import math

import torch
from torch import nn

# std of the standard normal truncated to [-2, 2] (flax.linen.initializers'
# truncated-normal variance scaling divides by it)
_TRUNC_STD = 0.87962566103423978


def _trunc_normal(shape, std: float, g, dev):
    """Normal draws truncated at +-2 raw standard deviations, scaled so the
    result's std is `std` (jax.nn.initializers.variance_scaling with
    "truncated_normal")."""
    raw = std / _TRUNC_STD
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    return nn.init.trunc_normal_(t, 0.0, raw, -2.0 * raw, 2.0 * raw, generator=g)


def _draw(module: nn.Module, name: str, p: torch.Tensor, g, dev):
    """The JAX initializer's draw for parameter `name` of `module` (float32),
    or a fill value."""
    if isinstance(module, nn.Embedding):
        return torch.randn(p.shape, generator=g, device=dev) / math.sqrt(p.shape[-1])
    if name == "v":
        return torch.randn(p.shape, generator=g, device=dev) * 0.01
    if name in ("pos_bias_u", "pos_bias_v"):
        limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
        return torch.rand(p.shape, generator=g, device=dev) * (2 * limit) - limit
    if name == "codebook":
        return torch.randn(p.shape, generator=g, device=dev)
    if p.dim() >= 2:
        return _trunc_normal(p.shape, 1.0 / math.sqrt(p[0].numel()), g, dev)
    return 0.0 if name in ("bias", "mean") else 1.0


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Refill every trainable parameter from one torch.Generator per device
    seeded with `seed`, each from its JAX initializer's distribution (module
    docstring). Returns the module."""
    gens = {}
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if not p.requires_grad or not p.is_floating_point():
                continue
            dev = p.device
            if dev not in gens:
                gens[dev] = torch.Generator(device=dev).manual_seed(seed)
            val = _draw(mod, name, p, gens[dev], dev)
            if isinstance(val, float):
                p.fill_(val)
            else:
                p.copy_(val)
    return module
