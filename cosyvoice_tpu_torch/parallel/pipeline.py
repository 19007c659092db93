"""Pipeline parallelism (GPipe schedule) over a "pp" mesh axis.

Counterpart of cosyvoice_tpu/parallel/pipeline.py. Each stage (rank along
"pp") holds L/pp consecutive layers of a homogeneous stack; microbatches
enter at stage 0 and move one stage per tick around the ring, the last
stage's outputs are summed over "pp" so every stage returns them. The JAX
version takes its backward schedule from autodiff through `ppermute` and
`psum`; here the ring shift is an autograd Function (sent forward to the
next stage, its gradient sent back to the previous one) and the closing
sum is the identity backward, so one `backward()` runs the reverse
pipeline.
"""

import torch
import torch.distributed as dist
from torch.func import functional_call

from cosyvoice_tpu_torch.parallel.sharding import axis_group, axis_rank, axis_size, reduce_from_group


def stack_layer_params(layers) -> dict:
    """[structurally identical layer modules] -> {parameter name: tensor
    [L, ...]} (a leading layer axis)."""
    params = [dict(layer.named_parameters()) for layer in layers]
    return {k: torch.stack([p[k].detach() for p in params]) for k in params[0]}


def shard_stacked_layers(mesh, stacked: dict, axis: str = "pp") -> dict:
    """This stage's slab of a stacked layer tree: rows r*L/pp..(r+1)*L/pp of
    every leaf (stage r of `axis`), as leaves that require grad."""
    pp, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    out = {}
    for k, v in stacked.items():
        if v.shape[0] % pp:
            raise ValueError(f"{k}: {v.shape[0]} layers over pp={pp}")
        out[k] = v.chunk(pp)[r].clone().requires_grad_(True)
    return out


class _RingShift(torch.autograd.Function):
    """Stage i's tensor to stage i+1 (mod pp), stage i-1's received;
    backward sends the gradient the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, +1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _shift(x, group, step: int):
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]):
        req.wait()
    return out


def pipeline_forward(mesh, layer_fn, stacked: dict, x: torch.Tensor, bcast=(), n_micro: int = 2,
                     axis: str = "pp") -> torch.Tensor:
    """Run a homogeneous layer stack as a `pp`-staged pipeline.

    layer_fn: (one layer's params {name: tensor}, h, *bcast) -> h.
    stacked:  this stage's slab (shard_stacked_layers), leaves [L/pp, ...].
    x:        [B, ...] activations, the same on every stage; B % n_micro == 0.
    bcast:    extras passed to every layer (rope tables, masks).

    Returns [B, ...], the whole stack's output, on every stage."""
    pp, idx, group = axis_size(mesh, axis), axis_rank(mesh, axis), axis_group(mesh, axis)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} over {n_micro} microbatches")
    xm = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    n_local = next(iter(stacked.values())).shape[0]
    buf = torch.zeros_like(xm[0])
    outs = [torch.zeros_like(xm[0]) for _ in range(n_micro)]
    for t in range(n_micro + pp - 1):
        # stage 0 takes microbatch t (clamped: the re-runs past the tail
        # are never written out); it keeps a zero-weighted dependence on
        # what it received, so that every stage runs every shift's backward,
        # in the same order
        h = xm[min(t, n_micro - 1)] + 0.0 * buf if idx == 0 else buf
        for i in range(n_local):
            h = layer_fn({k: v[i] for k, v in stacked.items()}, h, *bcast)
        w = t - (pp - 1)  # the last stage's tick-t result is microbatch w
        if w >= 0:
            outs[w] = h
        if t < n_micro + pp - 2:
            buf = _RingShift.apply(h, group)
    # the last stage's outputs, replicated; the other stages' are masked
    # out but stay in the graph, so that the loss's backward reaches their
    # shifts
    out = torch.where(torch.tensor(idx == pp - 1, device=x.device), torch.stack(outs), torch.zeros_like(xm))
    return reduce_from_group(out, group).reshape(B, *x.shape[1:])


def qwen2_layer_fn(cfg, dtype=None):
    """One Qwen2 decoder layer as (params, h, cos, sin, keep) -> h for
    pipeline_forward (the training forward, no KV cache; keep [B, 1, T, T]
    bool; products in `dtype`, default cfg.dtype)."""
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Layer

    with torch.device("meta"):
        layer = Qwen2Layer(cfg)
    dt = dtype or cfg.dtype

    def fn(lp, h, cos, sin, keep):
        return functional_call(layer, lp, (h, cos, sin, keep, dt))

    return fn
