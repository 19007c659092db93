"""Mesh and sharding rules for training over torch.distributed.

Counterpart of cosyvoice_tpu/parallel/sharding.py. The mesh is a
DeviceMesh over ("dp", "tp"): NCCL on the card, gloo on the CPU, chosen by
the device. A spec is a tuple with one mesh axis (or None) per dimension of
a parameter, () for replicated, as a PartitionSpec is.

The rules are the JAX package's, on the same Flax paths and shapes: each
port parameter is looked at through its Flax name and layout
(convert.py), and the spec found there is carried back to PyTorch's
layout, so P(None, "tp") on a Dense kernel [in, out] is ("tp", None) on the
Linear weight [out, in]. Where JAX's GSPMD inserts the collectives from
the specs, the port places them itself:

- "tp" (Megatron): the fused qkv projection keeps, on tp rank r, the rows
  of its q heads r*H/tp.., its k heads and its v heads (a per-rank head
  layout: the attention then runs on H/tp and Hkv/tp heads), the fused
  gate/up projection its gate and its up chunk; o_proj and down_proj keep
  their matching column chunks and the block's output is summed over
  "tp". The token and speech tables are split by rows (vocab-parallel
  lookups, summed over "tp"), the head by rows (its logits gathered over
  "tp"). A block's input is the identity forward and sums its gradient
  over "tp" backward;
- "dp": the train steps (train/trainer.py) sum the gradients over "dp"
  and normalise the loss by the global count of valid tokens;
- `shard_opt_state_zero` and `shard_params_fsdp` take the JAX package's
  ZeRO-2 and FSDP specs, but both run one mechanism: optimizer-state
  sharding in the manner of ZeRO-1. A parameter with a "dp" dimension in
  its spec is updated as its dp shard: the optimizer
  (train/trainer.Optimizer.use_mesh) holds that shard of the float32
  master weights and of Adam's moments, applies the update to it and
  gathers the shards back into the weights the forward reads. Every rank
  keeps the whole weights and the whole gradients (all-reduced over "dp",
  not reduce-scattered), so only the master copy and Adam's moments are
  divided; where JAX's FSDP also divides the weights and the gradients,
  this saves less memory. With dp 1 no parameter is sharded.
"""

import dataclasses
import math
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from cosyvoice_tpu_torch.convert import LeafSpec, _LIST_INDEX, _jax_leaf


def init_distributed(device, init_method: str = "env://", rank: Optional[int] = None,
                     world_size: Optional[int] = None):
    """torch.distributed's process group: NCCL for a CUDA device, gloo for
    the CPU. `init_method` "env://" reads torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); "tcp://127.0.0.1:<port>" takes
    `rank` and `world_size`."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {} if rank is None else {"rank": rank, "world_size": world_size}
    if dev.type == "cuda":
        kw["device_id"] = dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, **kw)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: Optional[int] = None):
    """A DeviceMesh ("dp", "tp") over the process group's ranks (the JAX
    make_mesh's defaults: tp 2 where the count is even, else 1)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (init_distributed)")
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a process group of {dist.get_world_size()}")
    if tp is None:
        tp = 1 if n == 1 else (2 if n % 2 == 0 else 1)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


def _names(mesh):
    if mesh is None:
        return ()
    return tuple(mesh) if isinstance(mesh, dict) else tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """The size of mesh axis `axis` (1 where the mesh has none). `mesh` is a
    DeviceMesh or a dict of axis sizes."""
    if axis not in _names(mesh):
        return 1
    return int(mesh[axis]) if isinstance(mesh, dict) else mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if axis in _names(mesh) else 0


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


# Flax path regex -> spec of the Flax layout (Dense kernels [in, out],
# embeddings [V, D]); the JAX package's _LM_RULES
_LM_RULES = [
    (r"embed_tokens.*embedding", ("tp", None)),
    (r"speech_embedding.*embedding", ("tp", None)),
    (r"(qkv_proj|q_proj|k_proj|v_proj|gate_up_proj|gate_proj|up_proj).*kernel", (None, "tp")),
    (r"(o_proj|down_proj).*kernel", ("tp", None)),
    (r"llm_decoder.*kernel", (None, "tp")),
    (r"(qkv_proj|q_proj|k_proj|v_proj|gate_up_proj|gate_proj|up_proj).*bias", ("tp",)),
    (r"llm_decoder.*bias", ("tp",)),
]


def lm_param_spec(path: str, leaf, mesh=None) -> tuple:
    """The Megatron rule of the Flax leaf at `path` (anything with .shape,
    in the Flax layout): the first rule whose pattern matches and whose
    sharded dimensions divide by the mesh axes, else () (replicated)."""
    shape = tuple(leaf.shape)

    def fits(spec) -> bool:
        return all(ax is None or shape[d] % axis_size(mesh, ax) == 0 for d, ax in enumerate(spec))

    for pat, spec in _LM_RULES:
        if re.search(pat, path) and len(spec) <= len(shape) and fits(spec):
            return spec
    return ()


def fsdp_param_spec(path: str, leaf, mesh=None, min_size: int = 1 << 14) -> tuple:
    """lm_param_spec plus "dp" on the largest free dimension that divides by
    it, for leaves of at least `min_size` elements (the JAX FSDP rule)."""
    base = lm_param_spec(path, leaf, mesh)
    shape = tuple(leaf.shape)
    dp = axis_size(mesh, "dp")
    if not shape or math.prod(shape) < min_size or mesh is None or dp == 1:
        return base
    dims = list(base) + [None] * (len(shape) - len(base))
    if "dp" in dims:
        return base
    free = [i for i in range(len(shape)) if dims[i] is None and shape[i] % dp == 0]
    if not free:
        return tuple(dims)
    dims[max(free, key=lambda i: shape[i])] = "dp"
    return tuple(dims)


def _flax_view(module: nn.Module, name: str, p: torch.Tensor):
    """(Flax path, LeafSpec of the Flax shape, perm) of port parameter
    `name`: Flax dimension j is PyTorch dimension perm[j]."""
    owner_name = name.rsplit(".", 1)[0] if "." in name else ""
    leaf, layout = _jax_leaf(name, p, module.get_submodule(owner_name))
    path = (_LIST_INDEX.sub(r"_\1", owner_name).split(".") if owner_name else []) + [leaf]
    probe = layout(np.zeros(tuple(range(2, 2 + p.dim())), np.int8))  # distinct sizes 2, 3, ...
    perm = tuple(s - 2 for s in probe.shape)
    return "/".join(path), LeafSpec(tuple(p.shape[d] for d in perm), np.dtype(np.float32)), perm


def param_specs(module: nn.Module, rule=lm_param_spec, mesh=None) -> dict:
    """{parameter name: spec in PyTorch's layout} of every parameter of
    `module` under `rule` (frozen and integer parameters replicated)."""
    specs = {}
    for name, p in module.named_parameters():
        if not (p.requires_grad and p.is_floating_point()):
            specs[name] = ()
            continue
        path, leaf, perm = _flax_view(module, name, p)
        spec = rule(path, leaf, mesh)
        dims = [None] * p.dim()
        for j, ax in enumerate(spec):
            dims[perm[j]] = ax
        specs[name] = tuple(dims) if any(ax is not None for ax in dims) else ()
    return specs


# ---------------------------------------------------------------- collectives with autograd


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over `group` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over `group` forward; the identity backward (each rank's
    gradient of the replicated sum is its own)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """Concatenation of every rank's x along the last dimension forward;
    this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, ctx.width = dist.get_world_size(group), x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.width:(r + 1) * ctx.width].contiguous(), None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group):
    return _GatherFromGroup.apply(x, group)


# ---------------------------------------------------------------- placement


def _tp_rows(module: nn.Module, name: str, p: torch.Tensor, tp: int, r: int) -> torch.Tensor:
    """Rank r's rows (dim 0) of a column-parallel weight or bias: the per-rank
    head layout of qkv_proj, the gate and up chunks of gate_up_proj, a
    contiguous chunk of any other."""
    owner = module.get_submodule(name.rsplit(".", 2)[0]) if name.count(".") >= 2 else module
    if ".qkv_proj." in name:
        c = owner.cfg
        if c.num_heads % tp or c.num_kv_heads % tp:
            raise ValueError(f"tp={tp} does not divide {c.num_heads} q / {c.num_kv_heads} kv heads")
        nq, nkv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        q, k, v = p.split([nq, nkv, nkv])
        return torch.cat([q.chunk(tp)[r], k.chunk(tp)[r], v.chunk(tp)[r]])
    if ".gate_up_proj." in name:
        gate, up = p.chunk(2)
        return torch.cat([gate.chunk(tp)[r], up.chunk(tp)[r]])
    return p.chunk(tp)[r]


def _vocab_parallel(emb: nn.Embedding, group, r: int):
    """Hooks that make `emb` (rank r's rows of the table) a vocab-parallel
    lookup: ids outside the rank's rows read zeros, the rows summed over
    `group`."""
    n = emb.weight.shape[0]
    lo = r * n

    def pre(mod, args):
        ids = args[0]
        mod._tp_mine = (ids >= lo) & (ids < lo + n)
        return (torch.where(mod._tp_mine, ids - lo, torch.zeros_like(ids)),) + tuple(args[1:])

    def post(mod, args, out):
        mine = mod._tp_mine
        del mod._tp_mine
        return reduce_from_group(out * mine[..., None].to(out.dtype), group)

    emb.register_forward_pre_hook(pre)
    emb.register_forward_hook(post)


def _block_parallel(block: nn.Module, group, gather: bool = False):
    """Hooks around a column-then-row-parallel block (attention, MLP): its
    input the identity forward and summed over `group` backward, its output
    summed over `group` (gather: a column-parallel head, its output
    gathered along the last dimension)."""

    def pre(mod, args):
        return (copy_to_group(args[0], group),) + tuple(args[1:])

    def post(mod, args, out):
        return gather_from_group(out, group) if gather else reduce_from_group(out, group)

    block.register_forward_pre_hook(pre)
    block.register_forward_hook(post)


def _install_tp(module: nn.Module, specs: dict, mesh):
    """Rewire the tp-sharded modules of the LM (see the module docstring);
    raises on a tp-sharded parameter of any other module."""
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Attention, Qwen2MLP

    tp, r, group = axis_size(mesh, "tp"), axis_rank(mesh, "tp"), axis_group(mesh, "tp")
    covered = set()
    for mname, mod in module.named_modules():
        own = {f"{mname}.{n}" if mname else n for n, _ in mod.named_parameters()}
        sharded = {n for n in own if "tp" in specs.get(n, ())}
        if not sharded:
            continue
        if isinstance(mod, (Qwen2Attention, Qwen2MLP)):
            if sharded != own:
                raise NotImplementedError(f"{mname}: tp shards {sorted(sharded)}, not the whole block")
            if isinstance(mod, Qwen2Attention):
                c = mod.cfg
                mod.cfg = dataclasses.replace(c, num_heads=c.num_heads // tp, num_kv_heads=c.num_kv_heads // tp)
            _block_parallel(mod, group)
        elif isinstance(mod, nn.Embedding):
            _vocab_parallel(mod, group, r)
        elif isinstance(mod, nn.Linear) and mname.endswith("llm_decoder"):
            _block_parallel(mod, group, gather=True)
        else:
            continue
        covered |= sharded
    left = {n for n, s in specs.items() if "tp" in s} - covered
    if left:
        raise NotImplementedError(f"no tensor-parallel layout for {sorted(left)}")


def replicate(mesh, tree):
    """Every rank's copy of `tree` (a module, or a dict or list of tensors)
    made equal to the first rank's, in place. Returns it."""
    tensors = list(tree.parameters()) + list(tree.buffers()) if isinstance(tree, nn.Module) else (
        list(tree.values()) if isinstance(tree, dict) else list(tree))
    if dist.get_world_size() > 1:
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)
    return tree


def shard_params(mesh, module: nn.Module, rule=lm_param_spec) -> nn.Module:
    """Place `module`'s parameters on the mesh by `rule`, in place: equal on
    every rank first (replicate), then each tp-sharded parameter cut to
    this rank's part and the LM's blocks rewired (module docstring). Each
    parameter carries its spec (`p.spec`), and `p.tp_dim` / `p.dp_dim`
    where an axis of size > 1 shards it. Returns the module."""
    specs = param_specs(module, rule, mesh)
    replicate(mesh, module)
    tp, r, dp = axis_size(mesh, "tp"), axis_rank(mesh, "tp"), axis_size(mesh, "dp")
    with torch.no_grad():
        for name, p in module.named_parameters():
            spec = specs[name]
            p.spec = spec
            if tp > 1 and "tp" in spec:
                d = spec.index("tp")
                if d != 0 and p.dim() != 2:
                    raise NotImplementedError(f"{name}: tp on dimension {d}")
                p.data = (_tp_rows(module, name, p.data, tp, r) if d == 0 else p.data.chunk(tp, 1)[r]).contiguous()
                p.tp_dim = d
            if dp > 1 and "dp" in spec:
                p.dp_dim = spec.index("dp")
    if tp > 1:
        _install_tp(module, specs, mesh)
    return module


def shard_params_fsdp(mesh, module: nn.Module) -> nn.Module:
    """shard_params under fsdp_param_spec: the tp placement of lm_param_spec,
    and "dp" marked on a dimension of every large parameter, which the
    optimizer then updates as its dp shard (ZeRO-1 style, module
    docstring: the weights themselves stay whole on every rank)."""
    return shard_params(mesh, module, rule=fsdp_param_spec)


def shard_opt_state_zero(mesh, optimizer, module: nn.Module, rule=lm_param_spec):
    """The JAX package's ZeRO-2 placement, run as ZeRO-1 style optimizer-state
    sharding (module docstring): Adam's moments (and the float32 master
    shard they update) of each parameter that `rule` replicates are split
    over "dp" on the first dimension of its Flax layout that divides by it;
    a parameter `rule` shards keeps its placement. Gradients stay whole. Hands the mesh to `optimizer`
    (train/trainer.Optimizer.use_mesh). Returns the optimizer."""
    dp = axis_size(mesh, "dp")
    for name, p in module.named_parameters():
        if dp == 1 or not (p.requires_grad and p.is_floating_point()) or getattr(p, "dp_dim", None) is not None:
            continue
        path, leaf, perm = _flax_view(module, name, p)
        if any(ax is not None for ax in rule(path, leaf, mesh)):
            continue
        for j, n in enumerate(leaf.shape):
            if n % dp == 0:
                p.dp_dim = perm[j]
                break
    optimizer.use_mesh(mesh)
    return optimizer


def _split(x: torch.Tensor, mesh, axis: int) -> torch.Tensor:
    if x.dim() <= axis:
        return x
    return x.chunk(axis_size(mesh, "dp"), axis)[axis_rank(mesh, "dp")].contiguous()


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's part of a global batch: each tensor's leading axis split
    over "dp" (0-d tensors kept)."""
    return {k: _split(v, mesh, 0) for k, v in batch.items()}


def shard_accum_batch(mesh, batch: dict) -> dict:
    """shard_batch for batches [A, B, ...] with the accumulation axis first:
    axis 1 split over "dp"."""
    return {k: _split(v, mesh, 1) for k, v in batch.items()}


def reduce_gradients(mesh, grads):
    """Sum every gradient over "dp" in place (nothing without a mesh)."""
    if mesh is None:
        return
    group = axis_group(mesh, "dp")
    for g in grads:
        dist.all_reduce(g, group=group)


def reduce_sum(mesh, x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """A tensor summed over mesh axis `axis` (a copy; no autograd); x itself,
    detached, without a mesh."""
    if mesh is None:
        return x.detach()
    y = x.detach().clone()
    dist.all_reduce(y, group=axis_group(mesh, axis))
    return y


def dp_shard(mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This dp rank's chunk of `x` along `dim`."""
    return x.chunk(axis_size(mesh, "dp"), dim)[axis_rank(mesh, "dp")].contiguous()


def dp_gather(mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every dp rank's chunk `x`, concatenated along `dim` (dp_shard's
    inverse)."""
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, "dp"))]
    dist.all_gather(parts, x, group=axis_group(mesh, "dp"))
    return torch.cat(parts, dim)


def global_norm(mesh, params) -> torch.Tensor:
    """The global norm of the gradients of `params` (float32). Those that
    are tp-sharded hold this rank's part: their squares are summed over
    "tp", the replicated ones counted once. The gradients are the dp-summed
    ones every dp rank holds whole. Without a tp-sharded gradient (no mesh,
    or tp 1) it is the norm of them all."""
    from cosyvoice_tpu_torch.train.trainer import global_norm as norm

    sharded = [p.grad for p in params if getattr(p, "tp_dim", None) is not None]
    whole = [p.grad for p in params if getattr(p, "tp_dim", None) is None]
    if not sharded:
        return norm(whole)
    sq_whole = norm(whole).square() if whole else torch.zeros((), device=sharded[0].device)
    return torch.sqrt(reduce_sum(mesh, norm(sharded).square(), "tp") + sq_whole)
