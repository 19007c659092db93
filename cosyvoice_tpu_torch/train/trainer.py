"""Training steps for the CosyVoice2 / CosyVoice3 LM and flow.

Counterpart of cosyvoice_tpu/train/trainer.py:

- `make_optimizer`: optax's chain clip_by_global_norm(grad_clip) ->
  scale_by_adam -> scale_by_schedule(-sched) as `Optimizer`: the gradient
  clip, then torch.optim.Adam with its rate set from the schedule before
  each update, at the count of updates applied so far (optax evaluates the
  schedule at its count before the increment: 0 on the first update);
- `skip_nonfinite`: a step whose gradient norm is not finite moves nothing.
  The JAX step reverts every leaf of the optimizer state, its count
  included; here Adam's step is not called, so the weights, both moments,
  Adam's step and the schedule count stay as they were;
- `make_lm_train_step` / `make_flow_train_step`: gradients summed over A
  microbatches and scaled by 1/A; the loss (and the LM's accuracy) the
  mean of the microbatches' values, each normalised by its own token count.
  With a `mesh` (parallel/sharding.py) each rank holds its "dp" part of
  every microbatch: a microbatch's loss is normalised by the count summed
  over "dp" (valid tokens, the flow's valid mel values), the gradients are
  summed over "dp", and the gradient norm is the global one. Without one
  (mesh None) these sums are the identity: one path serves both;
- `v1_lm_targets` / `make_lm_v1_train_step`: the CosyVoice-300M LM's CE
  step (float32, one batch, the non-finite skip kept).

The weights, gradients and Adam state are float32; the LM's products
compute in the dtype the step is given (Qwen2Model.forward).
"""

import math
from typing import Optional

import torch

from cosyvoice_tpu_torch.parallel import sharding
from cosyvoice_tpu_torch.train.losses import IGNORE_ID, lm_ce_loss, lm_ce_sums
from cosyvoice_tpu_torch.train.schedulers import get_scheduler


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), float32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def skip_nonfinite(gnorm: torch.Tensor) -> bool:
    """Whether the update is skipped: the gradient's global norm is not
    finite (one host sync)."""
    return not math.isfinite(float(gnorm))


class Optimizer:
    """Gradient clip by global norm, Adam (b1 0.9, b2 0.999, eps 1e-8) and
    a scheduled rate over `params`. `count` is the updates applied: the
    schedule's step (resuming sets it to the restored global step).
    skip_nonfinite=False is optax's plain chain clip -> Adam (the GAN's and
    the v1 flow's): a non-finite norm is applied like any other.
    weight_decay > 0 is optax's adamw: the decay decoupled from the
    gradient, p -= lr * (adam + weight_decay * p), on every parameter.

    `use_mesh(mesh)` (after parallel.sharding placed the parameters) makes
    the gradient norm the global one over tp-sharded gradients, and
    updates each parameter that carries a `dp_dim` as its dp shard (the
    float32 master part and Adam's moments of this rank alone), gathering
    the updated shards back into the parameter."""

    def __init__(self, params, sched, grad_clip: float = 5.0, skip_nonfinite: bool = True,
                 weight_decay: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.sched = sched
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.weight_decay = weight_decay
        self.mesh = None
        self.masters = []  # (parameter, its dp shard, the dimension) under a mesh
        self.adam = self._adam(self.params)
        self.count = 0

    def _adam(self, tensors):
        if self.weight_decay > 0:
            return torch.optim.AdamW(tensors, lr=self.sched(0), betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=self.weight_decay)
        return torch.optim.Adam(tensors, lr=self.sched(0), betas=(0.9, 0.999), eps=1e-8)

    def use_mesh(self, mesh):
        """Train over `mesh` (class docstring); before the first update."""
        if self.count:
            raise RuntimeError("use_mesh after an update: Adam's moments would be lost")
        self.mesh = mesh
        self.masters = [(p, sharding.dp_shard(mesh, p.detach(), p.dp_dim).clone(), p.dp_dim) for p in self.params
                        if getattr(p, "dp_dim", None) is not None and sharding.axis_size(mesh, "dp") > 1]
        sharded = {id(p) for p, _, _ in self.masters}
        self.adam = self._adam([m for _, m, _ in self.masters] + [p for p in self.params if id(p) not in sharded])

    def zero_grad(self):
        for p in self.params:
            p.grad = None
        self.adam.zero_grad(set_to_none=True)

    def grads(self):
        """Every parameter's gradient, a zero one made where backward left
        none (the JAX step updates every leaf, Adam's moments decaying)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def step(self):
        """Clip, then one Adam update at the scheduled rate unless the
        gradient norm is not finite (and skip_nonfinite). Adam updates the
        dp shards of `masters` (none without a mesh) and the whole
        parameters that have none; every rank's updated shard is then
        gathered into the parameter. Returns (gradient norm before the
        clip, whether the update was applied)."""
        grads = self.grads()
        gnorm = sharding.global_norm(self.mesh, self.params)
        if self.skip_nonfinite and skip_nonfinite(gnorm):
            return gnorm, False
        if float(gnorm) >= self.grad_clip:
            torch._foreach_div_(grads, gnorm)
            torch._foreach_mul_(grads, self.grad_clip)
        for group in self.adam.param_groups:
            group["lr"] = self.sched(self.count)
        for p, m, d in self.masters:
            m.grad = sharding.dp_shard(self.mesh, p.grad, d)
        self.adam.step()
        with torch.no_grad():
            for p, m, d in self.masters:
                p.copy_(sharding.dp_gather(self.mesh, m, d))
        self.count += 1
        return gnorm, True


def make_optimizer(params, lr: float = 1e-4, warmup_steps: int = 2500, grad_clip: float = 5.0,
                   scheduler: str = "warmuplr", skip_nonfinite: bool = True, **sched_conf) -> Optimizer:
    return Optimizer(params, get_scheduler(scheduler, lr, warmup_steps=warmup_steps, **sched_conf), grad_clip,
                     skip_nonfinite)


def _scale_grads(optimizer: Optimizer, scale: float):
    grads = [p.grad for p in optimizer.params if p.grad is not None]
    if grads and scale != 1.0:
        torch._foreach_mul_(grads, scale)


def _on_mesh(optimizer: Optimizer, mesh):
    if mesh is not None and optimizer.mesh is not mesh:
        optimizer.use_mesh(mesh)


def make_lm_train_step(lm_module, optimizer: Optimizer, accum_steps: int = 1, dtype: Optional[torch.dtype] = None,
                       mesh=None):
    """Returns step(batch, step) -> metrics. batch: {"ids", "types",
    "targets": [A, B, T], "lengths": [A, B]} tensors on the module's device,
    A = accum_steps microbatches (with a mesh, this rank's "dp" part of each:
    parallel.sharding.shard_accum_batch). Metrics: "loss", "acc",
    "grad_norm" (0-d float32 tensors, the same on every rank), "step"
    (step + 1). The Qwen2 products compute in `dtype` (default the module's
    cfg.qwen.dtype)."""
    inv = 1.0 / accum_steps
    _on_mesh(optimizer, mesh)

    def step_fn(batch, step):
        optimizer.zero_grad()
        loss_sum = acc_sum = 0.0
        for a in range(batch["ids"].shape[0]):
            logits = lm_module.forward_logits(batch["ids"][a], batch["types"][a], batch["lengths"][a], dtype)
            nll, correct, n_valid = lm_ce_sums(logits, batch["targets"][a])
            n_all = sharding.reduce_sum(mesh, n_valid).clamp_min(1)
            loss, acc = nll / n_all, correct.float() / n_all
            loss.backward()
            loss_sum, acc_sum = loss_sum + loss.detach(), acc_sum + acc.detach()
        sharding.reduce_gradients(mesh, optimizer.grads())
        loss_sum, acc_sum = sharding.reduce_sum(mesh, loss_sum), sharding.reduce_sum(mesh, acc_sum)
        _scale_grads(optimizer, inv)
        gnorm, _ = optimizer.step()
        return {"loss": loss_sum * inv, "acc": acc_sum * inv, "grad_norm": gnorm, "step": step + 1}

    return step_fn


def v1_lm_targets(speech_token_size: int, text_pad_len: int, text_len, speech, speech_len):
    """The targets of TransformerLMModule.forward_logits [B, 3 + text_pad_len
    + Ls]: position 2 + text_len (the task slot) predicts speech[0], each
    speech position the next, position 2 + text_len + speech_len the stop
    token (speech_token_size); IGNORE_ID elsewhere."""
    S = 3 + text_pad_len + speech.shape[1]
    k = torch.arange(S, device=speech.device)[None, :] - (2 + text_len[:, None])  # index into speech
    in_speech = (k >= 0) & (k < speech_len[:, None])
    gathered = torch.gather(speech, 1, k.clamp(0, speech.shape[1] - 1))
    tgt = torch.where(in_speech, gathered, torch.full_like(gathered, IGNORE_ID))
    return torch.where(k == speech_len[:, None], torch.full_like(tgt, speech_token_size), tgt)


def make_lm_v1_train_step(lm_module, optimizer: Optimizer, speech_token_size: int):
    """Returns step(batch, step) -> metrics ("loss", "acc", "grad_norm",
    "step"). batch: {"text" [B, Lt], "text_len", "spk" [B, 192], "speech"
    [B, Ls], "speech_len"} tensors on the module's device."""

    def step_fn(batch, step):
        optimizer.zero_grad()
        logits, _ = lm_module.forward_logits(batch["text"], batch["text_len"], batch["spk"], batch["speech"],
                                             batch["speech_len"])
        tgt = v1_lm_targets(speech_token_size, batch["text"].shape[1], batch["text_len"], batch["speech"],
                            batch["speech_len"])
        loss, acc = lm_ce_loss(logits, tgt)
        loss.backward()
        gnorm, _ = optimizer.step()
        return {"loss": loss.detach(), "acc": acc, "grad_norm": gnorm, "step": step + 1}

    return step_fn


def make_flow_train_step(flow, optimizer: Optimizer, accum_steps: int = 1, mesh=None):
    """Returns step(batch, generator, streaming, draws=None) -> metrics
    ("loss", "grad_norm"). batch: {"token", "token_len", "feat",
    "feat_len", "embedding"} tensors [A, B, ...], A = accum_steps
    microbatches (with a mesh, this rank's "dp" part of each); `streaming`
    is drawn per step by the caller (unified training). Each microbatch's
    draws come from `generator` (models/flow_matching.loss_draws) unless
    `draws`, a list of A dicts, gives them. With a mesh the flow's masked
    mean is taken over the valid mel values of every rank's rows."""
    inv = 1.0 / accum_steps
    _on_mesh(optimizer, mesh)

    def step_fn(batch, generator, streaming: bool, draws=None):
        optimizer.zero_grad()
        loss_sum = 0.0
        for a in range(batch["token"].shape[0]):
            loss = flow.loss(batch["token"][a], batch["token_len"][a], batch["feat"][a], batch["feat_len"][a],
                             batch["embedding"][a], streaming=streaming, generator=generator,
                             draws=None if draws is None else draws[a])
            # the rank's share of the global denominator (cfm_loss divides by
            # its rows' valid frames times the mel width): 1 without a mesh
            frames = batch["feat_len"][a].clamp_max(batch["feat"].shape[2]).sum().float()
            loss = loss * (frames / sharding.reduce_sum(mesh, frames).clamp_min(1))
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        sharding.reduce_gradients(mesh, optimizer.grads())
        loss_sum = sharding.reduce_sum(mesh, loss_sum)
        _scale_grads(optimizer, inv)
        gnorm, _ = optimizer.step()
        return {"loss": loss_sum * inv, "grad_norm": gnorm}

    return step_fn
