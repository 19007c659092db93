"""GRPO RL fine-tuning of the speech-token LM.

Counterpart of cosyvoice_tpu/bin/rl_grpo.py:

    python -m cosyvoice_tpu_torch.bin.rl_grpo --train_data prompts.jsonl \\
        --model_dir exp/grpo [--checkpoint lm.msgpack] [--config lm.json] \\
        [--reward_path mypkg.rewards:cer_reward | --reward_url http://host:8000/...] \\
        [--device cuda]

prompts.jsonl: one JSON object per line with at least {"text": ...}
(examples/grpo/cosyvoice2/prepare_data.py). The reward is a Python
``fn(tokens: np.ndarray, ground_truth: str) -> float`` from --reward_path,
or the token2wav+ASR server (serving/reward_server.py) at --reward_url.
--config is JSON of LMConfig overrides ({"qwen": {...}, ...}). The policy
trains float32 master weights, random from --seed or read from
--checkpoint (a flax msgpack LM tree, lm.msgpack); its rollouts decode in
the config's dtype (train/grpo.py). Checkpoints (lm_grpo_step<N>.msgpack,
lm_grpo.msgpack) are the JAX package's LM tree, written by
utils/msgpack_io.py. `main(argv)` returns (policy, last metrics).
"""

import argparse
import dataclasses
import importlib
import json
import logging
import os

import numpy as np
import torch


def resolve_reward(args):
    if args.reward_url:
        from cosyvoice_tpu_torch.train.grpo import http_reward

        return http_reward(args.reward_url)
    if args.reward_path:
        mod, _, fn = args.reward_path.partition(":")
        return getattr(importlib.import_module(mod), fn or "reward")
    raise SystemExit("one of --reward_path / --reward_url is required")


def build_prompt(cfg, tokenizer, text: str) -> dict:
    """The RL prompt [sos, text, task] of one text (no zero-shot prompt)."""
    from cosyvoice_tpu_torch.models.llm import TYPE_SPECIAL, TYPE_TEXT

    tt = np.asarray(tokenizer.encode(text), np.int32)
    ids = np.concatenate([[cfg.sos_id], tt, [cfg.task_id]]).astype(np.int32)
    types = np.concatenate([[TYPE_SPECIAL], np.full(len(tt), TYPE_TEXT), [TYPE_SPECIAL]]).astype(np.int32)
    return {"ids": ids, "types": types, "n_text": len(tt), "ground_truth": text}


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_data", required=True, help="jsonl with {'text': ...} per line")
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--tokenizer_path", default="")
    parser.add_argument("--reward_path", default="", help="module:function reward")
    parser.add_argument("--reward_url", default="", help="token2wav+ASR KServe endpoint")
    parser.add_argument("--group_size", type=int, default=8)
    parser.add_argument("--clip_eps", type=float, default=0.2)
    parser.add_argument("--kl_coef", type=float, default=1e-3)
    parser.add_argument("--lr", type=float, default=1e-6)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--save_per_step", type=int, default=100)
    parser.add_argument("--seed", type=int, default=1986)
    parser.add_argument("--config", default="", help="json with LMConfig overrides, e.g. {\"qwen\": {...}}")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from cosyvoice_tpu_torch.convert import export_params, load_jax_params
    from cosyvoice_tpu_torch.frontend.tokenizer import get_tokenizer
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
    from cosyvoice_tpu_torch.train.grpo import (
        GRPOConfig, frozen_copy, grpo_optimizer, grpo_step, make_grpo_train_step, make_logps_fn, make_rollout_lm,
    )
    from cosyvoice_tpu_torch.utils import msgpack_io
    from cosyvoice_tpu_torch.utils.config import build_lm_config
    from cosyvoice_tpu_torch.utils.devices import resolve_device
    from cosyvoice_tpu_torch.utils.init import init_random_

    device = resolve_device(args.device)
    reward_fn = resolve_reward(args)
    tokenizer = get_tokenizer(args.tokenizer_path or None, version=2)
    cfg = GRPOConfig(group_size=args.group_size, clip_eps=args.clip_eps, kl_coef=args.kl_coef)
    if args.config:
        with open(args.config) as f:
            lm_cfg = build_lm_config(json.load(f))
    else:
        lm_cfg = LMConfig()
    master_cfg = dataclasses.replace(lm_cfg, qwen=dataclasses.replace(lm_cfg.qwen, dtype=torch.float32))
    with torch.device(device):
        policy = init_random_(Qwen2LMModule(master_cfg), args.seed)
    if args.checkpoint:
        load_jax_params(policy, msgpack_io.read(args.checkpoint))
    # the frozen reference policy (the KL anchor) is a copy, not an alias
    ref = frozen_copy(policy)
    optimizer = grpo_optimizer(policy, args.lr)
    train_step = make_grpo_train_step(policy, optimizer, cfg.clip_eps, cfg.kl_coef, dtype=lm_cfg.qwen.dtype)
    logps_fn = make_logps_fn(lm_cfg.qwen.dtype)
    lm = make_rollout_lm(policy, lm_cfg, device)

    prompts = []
    with open(args.train_data) as f:
        for line in f:
            line = line.strip()
            if line:
                prompts.append(build_prompt(lm_cfg, tokenizer, json.loads(line)["text"]))
    logging.info("GRPO: %d prompts, K=%d", len(prompts), cfg.group_size)

    os.makedirs(args.model_dir, exist_ok=True)
    step, metrics = 0, {}
    for epoch in range(args.epochs):
        for p in prompts:
            metrics = grpo_step(lm, policy, [p], reward_fn, args.seed, cfg, train_step, logps_fn, ref, step)
            step += 1
            logging.info("epoch %d step %d: %s", epoch, step,
                         {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0})
            if args.save_per_step > 0 and step % args.save_per_step == 0:
                msgpack_io.write(os.path.join(args.model_dir, f"lm_grpo_step{step}.msgpack"), export_params(policy))
    msgpack_io.write(os.path.join(args.model_dir, "lm_grpo.msgpack"), export_params(policy))
    return policy, metrics


if __name__ == "__main__":
    main()
