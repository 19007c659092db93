"""Training steps for the CosyVoice2 / CosyVoice3 LM and flow.

Counterpart of cosyvoice_tpu/train/trainer.py (one device; the JAX
package's mesh sharding waits with parallel/, ROADMAP A11c):

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
  mean of the microbatches' values, each normalised by its own token count;
- `v1_lm_targets` / `make_lm_v1_train_step`: the CosyVoice-300M LM's CE
  step (float32, one batch, the non-finite skip kept).

The weights, gradients and Adam state are float32; the LM's products
compute in the dtype the step is given (Qwen2Model.forward).
"""

import math
from typing import Optional

import torch

from cosyvoice_tpu_torch.train.losses import IGNORE_ID, lm_ce_loss
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
    the v1 flow's): a non-finite norm is applied like any other."""

    def __init__(self, params, sched, grad_clip: float = 5.0, skip_nonfinite: bool = True):
        self.params = [p for p in params if p.requires_grad]
        self.sched = sched
        self.grad_clip = grad_clip
        self.skip_nonfinite = skip_nonfinite
        self.adam = torch.optim.Adam(self.params, lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
        self.count = 0

    def zero_grad(self):
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
        gradient norm is not finite (and skip_nonfinite). Returns (gradient
        norm before the clip, whether the update was applied)."""
        grads = self.grads()
        gnorm = global_norm(grads)
        if self.skip_nonfinite and skip_nonfinite(gnorm):
            return gnorm, False
        if float(gnorm) >= self.grad_clip:
            torch._foreach_div_(grads, gnorm)
            torch._foreach_mul_(grads, self.grad_clip)
        for group in self.adam.param_groups:
            group["lr"] = self.sched(self.count)
        self.adam.step()
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


def make_lm_train_step(lm_module, optimizer: Optimizer, accum_steps: int = 1, dtype: Optional[torch.dtype] = None):
    """Returns step(batch, step) -> metrics. batch: {"ids", "types",
    "targets": [A, B, T], "lengths": [A, B]} tensors on the module's device,
    A = accum_steps microbatches. Metrics: "loss", "acc", "grad_norm"
    (0-d float32 tensors), "step" (step + 1). The Qwen2 products compute in
    `dtype` (default the module's cfg.qwen.dtype)."""
    inv = 1.0 / accum_steps

    def step_fn(batch, step):
        optimizer.zero_grad()
        loss_sum = acc_sum = 0.0
        for a in range(batch["ids"].shape[0]):
            logits = lm_module.forward_logits(batch["ids"][a], batch["types"][a], batch["lengths"][a], dtype)
            loss, acc = lm_ce_loss(logits, batch["targets"][a])
            loss.backward()
            loss_sum, acc_sum = loss_sum + loss.detach(), acc_sum + acc
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


def make_flow_train_step(flow, optimizer: Optimizer, accum_steps: int = 1):
    """Returns step(batch, generator, streaming, draws=None) -> metrics
    ("loss", "grad_norm"). batch: {"token", "token_len", "feat",
    "feat_len", "embedding"} tensors [A, B, ...], A = accum_steps
    microbatches; `streaming` is drawn per step by the caller (unified
    training). Each microbatch's draws come from `generator`
    (models/flow_matching.loss_draws) unless `draws`, a list of A dicts,
    gives them."""
    inv = 1.0 / accum_steps

    def step_fn(batch, generator, streaming: bool, draws=None):
        optimizer.zero_grad()
        loss_sum = 0.0
        for a in range(batch["token"].shape[0]):
            loss = flow.loss(batch["token"][a], batch["token_len"][a], batch["feat"][a], batch["feat_len"][a],
                             batch["embedding"][a], streaming=streaming, generator=generator,
                             draws=None if draws is None else draws[a])
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        _scale_grads(optimizer, inv)
        gnorm, _ = optimizer.step()
        return {"loss": loss_sum * inv, "grad_norm": gnorm}

    return step_fn
