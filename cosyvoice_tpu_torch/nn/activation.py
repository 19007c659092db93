"""Activations (counterpart of cosyvoice_tpu/nn/activation.py)."""

import torch
from torch import nn
from torch.nn import functional as F


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + sin^2(alpha*x)/alpha over the last (channel) axis."""
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(x * alpha).square()


class Snake(nn.Module):
    """Channel-wise trainable snake over the last axis of [..., C]."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        return snake(x, self.alpha)
