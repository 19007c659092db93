"""GRPO (Group Relative Policy Optimization) for the speech-token LM.

Counterpart of cosyvoice_tpu/train/grpo.py:

- K rollouts per prompt are sampled from the current policy. The policy
  trains float32 master weights (a Qwen2LMModule); the rollouts decode
  through a Qwen2LM in the config's dtype (bf16 on the card) whose weights
  are a copy of the master's, refreshed in place after every update
  (`refresh_rollout`: copy_, never rebound, so the CUDA graphs captured
  before an update replay the new weights). Each rollout draws from its own
  torch.Generator, seeded from (seed, step, prompt, k) (`rollout_generator`),
  where the JAX version folds one PRNG key per prompt and rollout;
- rewards come from a `reward_fn(tokens, ground_truth) -> float`;
  `http_reward` is the client of serving/reward_server.py (KServe v2 JSON);
- advantages are group-normalised rewards: (r - mean) / (std + eps);
- the update is the token-level PPO clipped surrogate plus a k3 KL penalty
  to a frozen reference copy of the policy, token-mean over the valid
  targets; per-token log-probs of the policy, the old policy and the
  reference run the teacher-forced `forward_logits` (products in the
  config's dtype, the head in float32). The optimizer is optax's
  chain(clip_by_global_norm(1.0), adamw(lr)) as train/trainer.Optimizer
  with weight_decay 1e-4 (optax's default; torch's AdamW defaults to 1e-2)
  and a constant rate; a step whose gradient norm is not finite moves
  nothing, its count included.
"""

import copy
import json
import urllib.request
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from cosyvoice_tpu_torch.models.llm import TYPE_SPEECH, LMConfig
from cosyvoice_tpu_torch.train.losses import IGNORE_ID

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


@dataclass
class GRPOConfig:
    group_size: int = 8  # K rollouts per prompt
    clip_eps: float = 0.2  # PPO ratio clip
    kl_coef: float = 1e-3  # weight of the k3 KL penalty to the reference policy
    min_len_mult: int = 2  # rollout min/max token length per text token,
    max_len_mult: int = 20  # the inference limits


def grpo_optimizer(module, lr: float, grad_clip: float = 1.0):
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr)) over `module`'s
    parameters (train/trainer.Optimizer, constant rate, non-finite skip)."""
    from cosyvoice_tpu_torch.train.trainer import Optimizer

    return Optimizer(module.parameters(), lambda _: lr, grad_clip, skip_nonfinite=True,
                     weight_decay=ADAMW_WEIGHT_DECAY)


# ---------------------------------------------------------------- advantages
def grpo_advantages(rewards: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Group-relative advantages: rewards [B, K] -> [B, K], zero-mean and
    unit-std within each group of K rollouts of one prompt."""
    rewards = np.asarray(rewards, np.float32)
    mean = rewards.mean(axis=-1, keepdims=True)
    std = rewards.std(axis=-1, keepdims=True)
    return (rewards - mean) / (std + eps)


# ---------------------------------------------------------------- per-token log-probs
def _token_logps(logits: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logp [B, T] float32, valid [B, T]); positions with IGNORE_ID get 0."""
    valid = targets != IGNORE_ID
    tgt = torch.where(valid, targets, torch.zeros_like(targets)).long()
    tok = torch.gather(F.log_softmax(logits.float(), dim=-1), -1, tgt[..., None])[..., 0]
    return torch.where(valid, tok, torch.zeros_like(tok)), valid


def make_logps_fn(dtype: Optional[torch.dtype] = None):
    """fn(module, batch) -> the per-token log-probs [B, T] of the rollouts in
    `batch` under `module` (the policy, or the reference copy), without
    gradients; products in `dtype` (default the module's cfg.qwen.dtype)."""

    @torch.no_grad()
    def fn(module, batch):
        logits = module.forward_logits(batch["ids"], batch["types"], batch["lengths"], dtype)
        return _token_logps(logits, batch["targets"])[0]

    return fn


# ---------------------------------------------------------------- the update step
def make_grpo_train_step(lm_module, optimizer, clip_eps: float = 0.2, kl_coef: float = 1e-3,
                         dtype: Optional[torch.dtype] = None):
    """Returns step(batch, step) -> metrics ("loss", "kl", "clipfrac",
    "grad_norm": 0-d float32 tensors; "step": step + 1), one update of
    `lm_module` through `optimizer`.

    batch: ids / types / targets [B, T], lengths [B], old_logps / ref_logps
    [B, T], advantages [B] (the group flattened into B), on the module's
    device."""

    def step_fn(batch, step):
        optimizer.zero_grad()
        logits = lm_module.forward_logits(batch["ids"], batch["types"], batch["lengths"], dtype)
        lp, valid = _token_logps(logits, batch["targets"])
        n_valid = valid.sum().clamp_min(1)
        ratio = torch.exp(lp - batch["old_logps"])
        adv = batch["advantages"][:, None]
        surr = torch.minimum(ratio * adv, ratio.clamp(1.0 - clip_eps, 1.0 + clip_eps) * adv)
        # k3 KL estimator: exp(ref - lp) - (ref - lp) - 1 >= 0
        d = batch["ref_logps"] - lp
        kl = torch.exp(d) - d - 1.0
        zero = torch.zeros_like(lp)
        loss = torch.where(valid, -surr + kl_coef * kl, zero).sum() / n_valid
        loss.backward()
        with torch.no_grad():
            clipfrac = torch.where(valid, ((ratio - 1.0).abs() > clip_eps).float(), zero).sum() / n_valid
            kl_mean = torch.where(valid, kl, zero).sum() / n_valid
        gnorm, _ = optimizer.step()
        return {"loss": loss.detach(), "kl": kl_mean, "clipfrac": clipfrac, "grad_norm": gnorm, "step": step + 1}

    return step_fn


# ---------------------------------------------------------------- rollouts
def make_rollout_lm(policy, cfg: LMConfig, device, graphs=None):
    """A Qwen2LM of `cfg` (its dtype: the rollout copy) on `device` with the
    weights of `policy` (the float32 master Qwen2LMModule)."""
    from cosyvoice_tpu_torch.models.llm import Qwen2LM

    lm = Qwen2LM(cfg, device=device, graphs=graphs)
    refresh_rollout(lm, policy)
    return lm


@torch.no_grad()
def refresh_rollout(lm, policy):
    """Copy the policy's weights into the rollout LM's, in place (each cast
    to the rollout's dtype)."""
    dst = dict(lm.module.named_parameters())
    for name, p in policy.named_parameters():
        dst[name].copy_(p)


def rollout_generator(seed: int, step: int, prompt: int, k: int, device) -> torch.Generator:
    """The generator of rollout k of prompt `prompt` at GRPO step `step`."""
    state = np.random.SeedSequence([seed, step, prompt, k]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def sample_group(lm, ids: np.ndarray, types: np.ndarray, generators: Sequence[torch.Generator], cfg: GRPOConfig,
                 n_text: int) -> List[np.ndarray]:
    """K = len(generators) independent rollouts of one prompt from the
    rollout LM, the k-th drawing from generators[k]."""
    out = []
    for gen in generators:
        blocks = list(lm.generate(ids, types, gen, int(n_text * cfg.min_len_mult), int(n_text * cfg.max_len_mult)))
        toks = np.concatenate(blocks) if blocks else np.zeros(0, np.int64)
        out.append(toks.astype(np.int32))
    return out


def build_grpo_batch(cfg: LMConfig, prompt_ids: np.ndarray, prompt_types: np.ndarray,
                     rollouts: Sequence[np.ndarray], pad_to: int = 8) -> dict:
    """ids / types / targets / lengths arrays [K, T] for one prompt's
    rollouts, with the alignment of CE training (train/lm_data): the last
    prompt position targets the first rollout token, each rollout position
    the next, the final one eos. An empty rollout (immediate eos) targets
    eos at the prompt's last position, so that its one action carries its
    advantage."""
    K = len(rollouts)
    P = len(prompt_ids)
    T = max(P + len(r) for r in rollouts)
    T = ((T + pad_to - 1) // pad_to) * pad_to
    ids = np.zeros((K, T), np.int32)
    types = np.full((K, T), TYPE_SPEECH, np.int32)
    targets = np.full((K, T), IGNORE_ID, np.int32)
    lengths = np.zeros(K, np.int32)
    for k, r in enumerate(rollouts):
        n = P + len(r)
        ids[k, :P] = prompt_ids
        types[k, :P] = prompt_types
        ids[k, P:n] = r
        if len(r):
            targets[k, P - 1] = r[0]
            targets[k, P : n - 1] = r[1:]
            targets[k, n - 1] = cfg.eos_token
        else:
            targets[k, P - 1] = cfg.eos_token
        lengths[k] = n
    return {"ids": ids, "types": types, "targets": targets, "lengths": lengths}


# ---------------------------------------------------------------- the reward client
def http_reward(server_url: str) -> Callable[[np.ndarray, str], float]:
    """reward_fn over HTTP: KServe v2 JSON with the TOKENS, TOKEN_LENS and GT
    inputs; the response's outputs[0].data[0] is the reward
    (serving/reward_server.py)."""

    def fn(tokens: np.ndarray, ground_truth: str) -> float:
        tokens = np.asarray(tokens, np.int32).reshape(1, -1)
        payload = {
            "inputs": [
                {"name": "TOKENS", "shape": list(tokens.shape), "datatype": "INT32", "data": tokens.tolist()},
                {"name": "TOKEN_LENS", "shape": [1, 1], "datatype": "INT32", "data": [[int(tokens.shape[1])]]},
                {"name": "GT", "shape": [1], "datatype": "BYTES", "data": [ground_truth]},
            ]
        }
        req = urllib.request.Request(server_url, json.dumps(payload).encode(), {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=200.0) as resp:
            out = json.loads(resp.read())
        return float(out["outputs"][0]["data"][0])

    return fn


def frozen_copy(module):
    """The reference policy: a copy of `module` that does not train."""
    ref = copy.deepcopy(module)
    ref.requires_grad_(False)
    return ref.eval()


def to_device(batch: dict, device) -> dict:
    """A host batch (build_grpo_batch) as int64 tensors on `device`."""
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------- one GRPO iteration
def grpo_step(lm, policy, prompts: Sequence[dict], reward_fn, seed: int, cfg: GRPOConfig, train_step, logps_fn,
              ref, step: int, pad_to: int = 8) -> dict:
    """prompts: [{"ids", "types", "n_text", "ground_truth"}]. For each prompt:
    K rollouts from the rollout LM `lm`, their rewards, one update of
    `policy` (train_step), then the rollout copy refreshed. Returns the last
    group's metrics, with "rewards" and "rollout_tokens" of that group."""
    metrics = {}
    dev = next(policy.parameters()).device
    for i, p in enumerate(prompts):
        gens = [rollout_generator(seed, step, i, k, lm.device) for k in range(cfg.group_size)]
        rollouts = sample_group(lm, p["ids"], p["types"], gens, cfg, p["n_text"])
        rewards = np.asarray([[reward_fn(r, p["ground_truth"]) for r in rollouts]], np.float32)
        batch = to_device(build_grpo_batch(lm.cfg, p["ids"], p["types"], rollouts, pad_to=pad_to), dev)
        batch["old_logps"] = logps_fn(policy, batch)
        batch["ref_logps"] = logps_fn(ref, batch)
        batch["advantages"] = torch.from_numpy(grpo_advantages(rewards)[0]).to(dev)
        metrics = train_step(batch, step)
        refresh_rollout(lm, policy)
        metrics = {**metrics, "rewards": rewards[0], "rollout_tokens": sum(len(r) for r in rollouts)}
    return metrics
