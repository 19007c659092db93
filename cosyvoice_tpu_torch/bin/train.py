"""Training entry point: one sub-model (llm | flow) of CosyVoice2 or
CosyVoice3 on one device.

Counterpart of cosyvoice_tpu/bin/train.py. The LM trains float32 master
weights with its Qwen2 products in the config's dtype (bf16 by default),
the flow in float32; Adam and the gradients are float32. The data list's
parquet shards run through the processor chain (`build_pipeline`);
checkpoints, their sidecars and the CV loss come from train/executor.py.
`build_lm` and `build_flow` build a branch's module, optimizer, step,
collate and CV loss, which chip_smoke.py drives as main() does.

Not ported yet (they raise NotImplementedError): the CosyVoice-300M (v1)
LM and flow branches and `--model hifigan` (ROADMAP A11b), `--multihost`
(ROADMAP A11c).

    python -m cosyvoice_tpu_torch.bin.train --model llm --train_data data.list \\
        --model_dir exp/llm [--cv_data cv.list] [--checkpoint ckpt.msgpack] [--config config.json] \\
        [--device cuda]

A config's "train" section gives defaults to these flags (explicit flags
win), and its scheduler keys (hold_steps, max_steps, min_lr, ...) reach the
schedule.
"""

import argparse
import dataclasses
import logging
import random
from functools import partial
from types import SimpleNamespace

import numpy as np
import torch

SCHED_KEYS = ("hold_steps", "max_steps", "min_lr", "decay_rate", "d_model", "decay_steps", "power", "cycle",
              "constant_steps")


def grouped(it, n: int):
    """Lists of n items of `it` (the ragged tail dropped): the microbatches
    of one accumulated step."""
    buf = []
    for item in it:
        buf.append(item)
        if len(buf) == n:
            yield buf
            buf = []


def build_pipeline(args, tokenizer):
    """The processor chain of the LM and flow branches."""
    from cosyvoice_tpu_torch.data import processor as P

    return [
        P.parquet_opener,
        partial(P.tokenize, tokenizer=tokenizer),
        partial(P.filter_samples, max_length=args.max_length, token_max_length=200),
        partial(P.resample, resample_rate=args.sample_rate),
        partial(P.compute_fbank, sample_rate=args.sample_rate, hop=args.mel_hop),
        P.parse_embedding,
        partial(P.shuffle, shuffle_size=1000),
        partial(P.sort_by_len, sort_size=500),
        partial(P.batch, batch_type=args.batch_type, batch_size=args.batch_size,
                max_frames_in_batch=args.max_frames_in_batch),
        partial(P.padding, dpo=args.dpo),
    ]


def parse_args(argv=None):
    """(args, config dict). --config's "train" section sets the defaults."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default="")
    pre_args, _ = pre.parse_known_args(argv)
    cfg = {}
    if pre_args.config:
        from cosyvoice_tpu_torch.utils.config import load_config

        cfg = load_config(pre_args.config)

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="", help="JSON config (model sections + train defaults)")
    parser.add_argument("--model", required=True, choices=["llm", "flow", "hifigan"])
    parser.add_argument("--train_data", required=True)
    parser.add_argument("--cv_data", default="")
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--tokenizer_path", default="")
    parser.add_argument("--sample_rate", type=int, default=24000)
    parser.add_argument("--mel_hop", type=int, default=480)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--scheduler", default="warmuplr")
    parser.add_argument("--warmup_steps", type=int, default=2500)
    parser.add_argument("--grad_clip", type=float, default=5.0)
    parser.add_argument("--accum_grad", type=int, default=2)
    parser.add_argument("--max_epoch", type=int, default=200)
    parser.add_argument("--max_length", type=int, default=40960)
    parser.add_argument("--batch_type", default="dynamic")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--max_frames_in_batch", type=int, default=2000)
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--save_per_step", type=int, default=-1)
    parser.add_argument("--dpo", action="store_true")
    parser.add_argument("--seed", type=int, default=1986)
    parser.add_argument("--multihost", action="store_true", help="multi-host training (not ported yet)")
    parser.add_argument("--device", default="cuda")
    if cfg.get("train"):
        parser.set_defaults(**cfg["train"])
    return parser.parse_args(argv), cfg


def _optimizer(args, module):
    from cosyvoice_tpu_torch.train.trainer import make_optimizer

    sched_conf = {k: getattr(args, k) for k in SCHED_KEYS if hasattr(args, k)}
    return make_optimizer(module.parameters(), lr=args.lr, warmup_steps=args.warmup_steps,
                          grad_clip=args.grad_clip, scheduler=args.scheduler, **sched_conf)


def _stack(mbs, fills, device):
    """Microbatches (dicts of numpy arrays [B, ...]) stacked to tensors
    [A, B_max, T_max, ...] on `device`, padded with fills[key]."""
    out = {}
    for k, fill in fills.items():
        arrs = [m[k] for m in mbs]
        shape = (len(arrs),) + tuple(max(a.shape[i] for a in arrs) for i in range(arrs[0].ndim))
        buf = np.full(shape, fill, arrs[0].dtype)
        for a, arr in enumerate(arrs):
            buf[(a,) + tuple(slice(0, n) for n in arr.shape)] = arr
        out[k] = torch.from_numpy(buf).to(device)
    return out


def build_lm(args, cfg: dict, device):
    """The LM branch: float32 master weights (random from args.seed),
    products in the config's dtype. Returns a namespace of module,
    optimizer, step(batch, step_no) -> metrics, collate(batch or list of A
    batches) -> [A, B, T] tensors, cv_fn(batch) -> loss, accum."""
    from cosyvoice_tpu_torch.models.llm import Qwen2LMModule
    from cosyvoice_tpu_torch.train.lm_data import collate_lm_batch
    from cosyvoice_tpu_torch.train.losses import IGNORE_ID, lm_ce_loss
    from cosyvoice_tpu_torch.train.trainer import make_lm_train_step
    from cosyvoice_tpu_torch.utils.config import build_lm_config
    from cosyvoice_tpu_torch.utils.init import init_random_

    lm_cfg = build_lm_config(cfg.get("llm"))
    master = dataclasses.replace(lm_cfg, qwen=dataclasses.replace(lm_cfg.qwen, dtype=torch.float32))
    with torch.device(device):
        module = init_random_(Qwen2LMModule(master), args.seed)
    optimizer = _optimizer(args, module)
    accum = max(args.accum_grad, 1)
    step = make_lm_train_step(module, optimizer, accum_steps=accum, dtype=lm_cfg.qwen.dtype)
    # pad rows get length 1 and all-IGNORE targets: loss-neutral, and no
    # query row is fully masked
    fills = {"ids": 0, "types": 1, "targets": IGNORE_ID, "lengths": 1}

    def collate(batch_group):
        """A collated microbatches stacked to [A, B, T]; a bare batch (the
        CV path) is A = 1."""
        groups = batch_group if isinstance(batch_group, list) else [batch_group]
        t = _stack([collate_lm_batch(master, b) for b in groups], fills, device)
        return {k: v.long() if k != "lengths" else v for k, v in t.items()}

    @torch.no_grad()
    def cv_fn(mb):
        logits = module.forward_logits(mb["ids"][0], mb["types"][0], mb["lengths"][0], lm_cfg.qwen.dtype)
        return lm_ce_loss(logits, mb["targets"][0])[0]

    return SimpleNamespace(module=module, optimizer=optimizer, step=step, collate=collate, cv_fn=cv_fn, accum=accum)


def build_flow(args, cfg: dict, device):
    """The flow branch (the U-Net or the DiT flow), float32, random from
    args.seed; each step draws streaming or offline with Python's `random`
    (unified training) and its loss draws from a generator seeded
    args.seed; CV is offline with a generator seeded 0 each pass. Returns
    the namespace of build_lm."""
    from cosyvoice_tpu_torch.models.flow import CausalFlow
    from cosyvoice_tpu_torch.train.trainer import make_flow_train_step
    from cosyvoice_tpu_torch.utils.config import build_flow_config
    from cosyvoice_tpu_torch.utils.init import init_random_

    flow = init_random_(CausalFlow(build_flow_config(cfg.get("flow")), device=device), args.seed)
    optimizer = _optimizer(args, flow)
    accum = max(args.accum_grad, 1)
    flow_step = make_flow_train_step(flow, optimizer, accum_steps=accum)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def step(batch, step_no):
        return flow_step(batch, generator, random.random() < 0.5)

    fills = {"token": 0, "token_len": 1, "feat": 0.0, "feat_len": 2, "embedding": 0.0}

    def collate(batch_group):
        """A batches stacked to [A, B, ...] (pad rows: token_len 1, feat_len
        2); a bare batch (the CV path) is A = 1."""
        groups = batch_group if isinstance(batch_group, list) else [batch_group]
        mbs = [{"token": b["speech_token"].astype(np.int64), "token_len": b["speech_token_len"],
                "feat": b["speech_feat"].astype(np.float32), "feat_len": b["speech_feat_len"],
                "embedding": b["embedding"].astype(np.float32)} for b in groups]
        return _stack(mbs, fills, device)

    @torch.no_grad()
    def cv_fn(mb):
        gen = torch.Generator(device=device).manual_seed(0)
        return flow.loss(*(mb[k][0] for k in ("token", "token_len", "feat", "feat_len", "embedding")),
                         streaming=False, generator=gen)

    return SimpleNamespace(module=flow, optimizer=optimizer, step=step, collate=collate, cv_fn=cv_fn, accum=accum)


def main(argv=None):
    """Train; returns the Executor and the branch (build_lm / build_flow)."""
    args, cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    version = int(cfg.get("version", 2))
    if args.model == "hifigan" or version == 1:
        what = "--model hifigan" if args.model == "hifigan" else f"the CosyVoice-300M (v1) {args.model} branch"
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP A11b)")
    if args.multihost:
        raise NotImplementedError("--multihost is not ported yet (ROADMAP A11c)")
    from cosyvoice_tpu_torch.data.dataset import Dataset
    from cosyvoice_tpu_torch.frontend.tokenizer import get_tokenizer
    from cosyvoice_tpu_torch.train.executor import Executor
    from cosyvoice_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    random.seed(args.seed)
    np.random.seed(args.seed)
    tokenizer = get_tokenizer(args.tokenizer_path or None, version=version)
    branch = (build_lm if args.model == "llm" else build_flow)(args, cfg, device)
    pipeline = build_pipeline(args, tokenizer)
    dataset = Dataset(args.train_data, pipeline)
    cv_dataset = Dataset(args.cv_data, pipeline) if args.cv_data else None
    cv_iter_fn = (lambda: iter(cv_dataset)) if cv_dataset is not None else None
    executor = Executor(branch.step, args.model_dir, model_name=args.model, log_interval=args.log_interval,
                        save_per_step=args.save_per_step)
    if args.checkpoint:
        executor.resume(branch.module, args.checkpoint)
        # the schedule resumes at the restored global step; Adam's moments
        # start fresh, as the reference's resume (it saves the model only)
        branch.optimizer.count = executor.step
    executor.save(branch.module, {"note": "init"})
    for epoch in range(args.max_epoch):
        dataset.set_epoch(epoch)
        executor.train_one_epoch(branch.module, grouped(iter(dataset), branch.accum), branch.collate,
                                 cv_fn=branch.cv_fn, cv_iter=cv_iter_fn)
        cv_metrics = executor.cross_validate(branch.cv_fn, cv_iter_fn, branch.collate) if cv_dataset else None
        executor.save(branch.module, cv_metrics)
    return executor, branch


if __name__ == "__main__":
    main()
