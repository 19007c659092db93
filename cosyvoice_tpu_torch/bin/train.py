"""Training entry point: one sub-model (llm | flow | hifigan) of
CosyVoice2, CosyVoice3 or CosyVoice-300M ({"version": 1} configs) on one
device.

Counterpart of cosyvoice_tpu/bin/train.py. The CosyVoice2/3 LM trains
float32 master weights with its Qwen2 products in the config's dtype (bf16
by default); the v1 LM, the flows and the GAN train in float32; Adam and
the gradients are float32. The data list's parquet shards run through the
processor chain (`build_pipeline`; the GAN's crops each utterance and adds
its F0); checkpoints, their sidecars and the CV loss come from
train/executor.py. `build_lm`, `build_lm_v1`, `build_flow`,
`build_flow_v1` and `build_gan` build a branch, which chip_smoke.py drives
as main() does.

`--model hifigan` trains the config's HiFT (v2, v1 or causal v3) against
the MPD + MRD discriminators (train/gan.py): an optional generator-only
pretrain (the config's "gan" section: pretrain_steps, pretrain_lr) on
optax's warmup-cosine schedule with a plateau restart, then alternating
generator and discriminator steps, a {"generator", "discriminator"}
checkpoint each epoch with the epoch's mean generator loss as its
cv_loss (so bin/average_model.py --model_name hifigan picks the best).

`--multihost` trains the CosyVoice2/3 llm or flow data-parallel over the
processes torchrun starts (one per card; NCCL on the card, gloo with
--device cpu): the process group from torchrun's environment, a "dp"
mesh over every rank (parallel/sharding.py), each rank reading its part
of the data list (Dataset(rank, world_size)), the weights made equal from
rank 0's, the gradients summed over the ranks and the loss normalised by
the global token count (train/trainer.py), only rank 0 writing. The v1
branches and hifigan raise under it.

    torchrun --nproc_per_node 4 -m cosyvoice_tpu_torch.bin.train --multihost --model llm ...

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
import os
import random
from functools import partial
from types import SimpleNamespace

from typing import Optional

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


def build_pipeline(args, tokenizer, gan: bool = False, truncate_length: int = 24480, opener=None):
    """The processor chain; `gan`: a random crop of truncate_length samples
    before the mel, the F0 after it, and "speech" / "pitch_feat" batched.
    `opener` ({"src": a line of the data list} -> the rows parquet_opener
    would yield) replaces data/processor.parquet_opener as its first stage."""
    from cosyvoice_tpu_torch.data import processor as P

    crop = [partial(P.truncate, truncate_length=truncate_length)] if gan else []
    f0 = [partial(P.compute_f0, sample_rate=args.sample_rate, hop_size=args.mel_hop)] if gan else []
    return [
        opener or P.parquet_opener,
        partial(P.tokenize, tokenizer=tokenizer),
        partial(P.filter_samples, max_length=args.max_length, token_max_length=200),
        partial(P.resample, resample_rate=args.sample_rate),
        *crop,
        partial(P.compute_fbank, sample_rate=args.sample_rate, hop=args.mel_hop),
        *f0,
        P.parse_embedding,
        partial(P.shuffle, shuffle_size=1000),
        partial(P.sort_by_len, sort_size=500),
        partial(P.batch, batch_type=args.batch_type, batch_size=args.batch_size,
                max_frames_in_batch=args.max_frames_in_batch),
        partial(P.padding, gan=gan, dpo=args.dpo),
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
    parser.add_argument("--multihost", action="store_true",
                        help="data-parallel over torchrun's processes (llm and flow of CosyVoice2/3)")
    parser.add_argument("--device", default="cuda")
    if cfg.get("train"):
        parser.set_defaults(**cfg["train"])
    return parser.parse_args(argv), cfg


def _optimizer(args, module, skip_nonfinite: bool = True):
    from cosyvoice_tpu_torch.train.trainer import make_optimizer

    sched_conf = {k: getattr(args, k) for k in SCHED_KEYS if hasattr(args, k)}
    return make_optimizer(module.parameters(), lr=args.lr, warmup_steps=args.warmup_steps,
                          grad_clip=args.grad_clip, scheduler=args.scheduler, skip_nonfinite=skip_nonfinite,
                          **sched_conf)


def _one(batch_group):
    """The batch of a group of one (accum 1), or a bare batch (CV)."""
    if isinstance(batch_group, list):
        if len(batch_group) != 1:
            raise ValueError(f"this branch takes one batch per step, not {len(batch_group)}")
        return batch_group[0]
    return batch_group


def _tensors(arrays: dict, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


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


def build_lm(args, cfg: dict, device, mesh=None):
    """The LM branch: float32 master weights (random from args.seed),
    products in the config's dtype; with a "dp" `mesh`, the weights made
    equal over the ranks and the step data-parallel. Returns a namespace
    of module, optimizer, step(batch, step_no) -> metrics,
    collate(batch or list of A batches) -> [A, B, T] tensors,
    cv_fn(batch) -> loss, accum."""
    from cosyvoice_tpu_torch.models.llm import Qwen2LMModule
    from cosyvoice_tpu_torch.parallel.sharding import replicate
    from cosyvoice_tpu_torch.train.lm_data import collate_lm_batch
    from cosyvoice_tpu_torch.train.losses import IGNORE_ID, lm_ce_loss
    from cosyvoice_tpu_torch.train.trainer import make_lm_train_step
    from cosyvoice_tpu_torch.utils.config import build_lm_config
    from cosyvoice_tpu_torch.utils.init import init_random_

    lm_cfg = build_lm_config(cfg.get("llm"))
    master = dataclasses.replace(lm_cfg, qwen=dataclasses.replace(lm_cfg.qwen, dtype=torch.float32))
    with torch.device(device):
        module = init_random_(Qwen2LMModule(master), args.seed)
    if mesh is not None:
        replicate(mesh, module)
    optimizer = _optimizer(args, module)
    accum = max(args.accum_grad, 1)
    step = make_lm_train_step(module, optimizer, accum_steps=accum, dtype=lm_cfg.qwen.dtype, mesh=mesh)
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


def build_flow(args, cfg: dict, device, mesh=None):
    """The flow branch (the U-Net or the DiT flow), float32, random from
    args.seed; each step draws streaming or offline with Python's `random`
    (unified training, the same draw on every rank) and its loss draws from
    a generator seeded args.seed (plus the "dp" rank under a `mesh`); CV is
    offline with a generator seeded 0 each pass. Returns the namespace of
    build_lm."""
    from cosyvoice_tpu_torch.models.flow import CausalFlow
    from cosyvoice_tpu_torch.parallel.sharding import axis_rank, replicate
    from cosyvoice_tpu_torch.train.trainer import make_flow_train_step
    from cosyvoice_tpu_torch.utils.config import build_flow_config
    from cosyvoice_tpu_torch.utils.init import init_random_

    flow = init_random_(CausalFlow(build_flow_config(cfg.get("flow")), device=device), args.seed)
    if mesh is not None:
        replicate(mesh, flow)
    optimizer = _optimizer(args, flow)
    accum = max(args.accum_grad, 1)
    flow_step = make_flow_train_step(flow, optimizer, accum_steps=accum, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed + axis_rank(mesh, "dp"))

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


def build_lm_v1(args, cfg: dict, device):
    """The CosyVoice-300M LM branch (TransformerLM, float32, random from
    args.seed), one batch per step (accum_grad > 1 warns and runs
    without, as the JAX trainer), the non-finite skip kept. Returns the
    namespace of build_lm."""
    from cosyvoice_tpu_torch.models.llm_v1 import TransformerLMModule
    from cosyvoice_tpu_torch.train.losses import lm_ce_loss
    from cosyvoice_tpu_torch.train.trainer import make_lm_v1_train_step, v1_lm_targets
    from cosyvoice_tpu_torch.utils.config import build_lm_v1_config
    from cosyvoice_tpu_torch.utils.init import init_random_

    if args.accum_grad > 1:
        logging.warning("accum_grad > 1 is not implemented for the v1 LM trainer; running without")
    with torch.device(device):
        module = init_random_(TransformerLMModule(build_lm_v1_config(cfg.get("llm"))), args.seed)
    optimizer = _optimizer(args, module)
    n_speech = module.cfg.speech_token_size
    step = make_lm_v1_train_step(module, optimizer, n_speech)

    def collate(batch_group):
        b = _one(batch_group)
        return _tensors({"text": b["text_token"].astype(np.int64), "text_len": b["text_token_len"].astype(np.int64),
                         "spk": b["embedding"].astype(np.float32), "speech": b["speech_token"].astype(np.int64),
                         "speech_len": b["speech_token_len"].astype(np.int64)}, device)

    @torch.no_grad()
    def cv_fn(mb):
        logits, _ = module.forward_logits(mb["text"], mb["text_len"], mb["spk"], mb["speech"], mb["speech_len"])
        tgt = v1_lm_targets(n_speech, mb["text"].shape[1], mb["text_len"], mb["speech"], mb["speech_len"])
        return lm_ce_loss(logits, tgt)[0]

    return SimpleNamespace(module=module, optimizer=optimizer, step=step, collate=collate, cv_fn=cv_fn, accum=1)


def build_flow_v1(args, cfg: dict, device):
    """The CosyVoice-300M flow branch (MaskedDiffFlow, float32, random from
    args.seed), one batch per step, no non-finite skip (the JAX v1 flow
    step applies optax's chain as it is); the loss's draws from a
    generator seeded args.seed, CV's from one seeded 0 each pass. Returns
    the namespace of build_lm."""
    from cosyvoice_tpu_torch.models.flow_v1 import MaskedDiffFlow
    from cosyvoice_tpu_torch.utils.config import build_flow_v1_config
    from cosyvoice_tpu_torch.utils.init import init_random_

    flow = init_random_(MaskedDiffFlow(build_flow_v1_config(cfg.get("flow")), device=device), args.seed)
    optimizer = _optimizer(args, flow, skip_nonfinite=False)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    keys = ("token", "token_len", "feat", "feat_len", "embedding")

    def step(batch, step_no, draws=None):
        optimizer.zero_grad()
        loss = flow.loss(*(batch[k] for k in keys), generator=generator, draws=draws)
        loss.backward()
        gnorm, _ = optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    def collate(batch_group):
        b = _one(batch_group)
        return _tensors({"token": b["speech_token"].astype(np.int64), "token_len": b["speech_token_len"],
                         "feat": b["speech_feat"].astype(np.float32), "feat_len": b["speech_feat_len"],
                         "embedding": b["embedding"].astype(np.float32)}, device)

    @torch.no_grad()
    def cv_fn(mb):
        return flow.loss(*(mb[k] for k in keys), generator=torch.Generator(device=device).manual_seed(0))

    return SimpleNamespace(module=flow, optimizer=optimizer, step=step, collate=collate, cv_fn=cv_fn, accum=1)


# the HiFT GAN's defaults, each overridable in the config's "gan" section
GAN_DEFAULTS = {"truncate_length": 24480, "mpd_channels": (32, 128, 512, 1024),
                "mrd_resolutions": ((1024, 120), (2048, 240), (512, 50)), "lr": 2e-4, "pretrain_steps": 0,
                "pretrain_lr": 1e-3}
PLATEAU_MEL = 3.0  # a pretrain attempt whose last three 50-step mel L1 readings all exceed this restarts
PRETRAIN_ATTEMPTS = 3
PRETRAIN_EPOCH0 = 10_000  # the pretrain's epochs, apart from the GAN's


def build_gan(args, cfg: dict, device):
    """The HiFT GAN branch: the config's HiFT and MultipleDiscriminator,
    float32, random from args.seed (the discriminator from args.seed + 1),
    resumed from args.checkpoint (a {"generator", "discriminator"} tree, or
    a generator-only one); clip -> Adam at the "gan" section's constant lr
    for each, no non-finite skip. The "gan" section's batch_size replaces
    args.batch_size. Returns a namespace of hift, disc, gen_step /
    disc_step (batch, draws) -> metrics, their optimizers, loss_cfg, conf
    (the "gan" section over GAN_DEFAULTS), collate(batch) -> tensors and
    draws(batch) -> the HiFT source's draws from a generator seeded
    args.seed (one step number's two steps take the same)."""
    from cosyvoice_tpu_torch.convert import load_gan_params
    from cosyvoice_tpu_torch.models.discriminator import MultipleDiscriminator
    from cosyvoice_tpu_torch.models.hift import HiFTGenerator, draw_source
    from cosyvoice_tpu_torch.train.gan import GanLossConfig, make_gan_train_steps
    from cosyvoice_tpu_torch.train.trainer import Optimizer
    from cosyvoice_tpu_torch.utils import msgpack_io
    from cosyvoice_tpu_torch.utils.config import build_hift_config
    from cosyvoice_tpu_torch.utils.init import init_random_

    conf = {**GAN_DEFAULTS, **cfg.get("gan", {})}
    hift = init_random_(HiFTGenerator(build_hift_config(cfg.get("hift")), device=device), args.seed).train()
    with torch.device(device):
        disc = MultipleDiscriminator(mpd_channels=tuple(conf["mpd_channels"]),
                                     mrd_resolutions=tuple(tuple(r) for r in conf["mrd_resolutions"]))
    init_random_(disc, args.seed + 1)
    if args.checkpoint and os.path.exists(args.checkpoint):
        both = load_gan_params(hift, disc, msgpack_io.read(args.checkpoint))
        logging.info("resumed %s checkpoint %s", "GAN" if both else "generator-only", args.checkpoint)
    elif args.checkpoint:
        logging.warning("checkpoint %s not found; training hifigan from scratch", args.checkpoint)
    if "batch_size" in conf:
        args.batch_size = int(conf["batch_size"])
    lr = float(conf["lr"])
    g_opt = Optimizer(hift.parameters(), lambda _: lr, args.grad_clip, skip_nonfinite=False)
    d_opt = Optimizer(disc.parameters(), lambda _: lr, args.grad_clip, skip_nonfinite=False)
    loss_cfg = GanLossConfig(sample_rate=args.sample_rate, mel_hop=args.mel_hop)
    gen_step, disc_step = make_gan_train_steps(hift, disc, g_opt, d_opt, loss_cfg)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def collate(b):
        return _tensors({k: b[k].astype(np.float32) for k in ("speech", "speech_feat", "pitch_feat")}, device)

    def draws(batch):
        B, T = batch["speech_feat"].shape[:2]
        return draw_source(hift.cfg, B, T * hift.cfg.hop_total, generator, device)

    return SimpleNamespace(hift=hift, disc=disc, gen_step=gen_step, disc_step=disc_step, g_opt=g_opt, d_opt=d_opt,
                           loss_cfg=loss_cfg, conf=conf, collate=collate, draws=draws)


def pretrain_generator(args, gan, dataset) -> Optional[dict]:
    """The generator-only pretrain of conf["pretrain_steps"] steps (none at
    0): clip -> Adam on optax's warmup_cosine_decay_schedule(0, lr, min(500,
    max(1, n // 4)), n, lr / 5). An attempt whose last three 50-step mel L1
    readings all exceed PLATEAU_MEL at or past the probe step (max(200,
    min(1200, n // 4))) restarts from a fresh init at half the lr, at most
    PRETRAIN_ATTEMPTS attempts. Epochs count from PRETRAIN_EPOCH0; an
    epoch without a batch ends the pretrain. Returns the last step's
    metrics (with "steps" and "attempt"), or None."""
    from cosyvoice_tpu_torch.train.gan import make_generator_pretrain_step
    from cosyvoice_tpu_torch.train.schedulers import warmup_cosine_decay
    from cosyvoice_tpu_torch.train.trainer import Optimizer
    from cosyvoice_tpu_torch.utils.init import init_random_

    n = int(gan.conf["pretrain_steps"])
    if n <= 0:
        return None
    probe_at = max(200, min(1200, n // 4))
    for attempt in range(PRETRAIN_ATTEMPTS):
        lr = float(gan.conf["pretrain_lr"]) * 0.5**attempt
        if attempt > 0:
            init_random_(gan.hift, args.seed + 555_000 + attempt)
        opt = Optimizer(gan.hift.parameters(), warmup_cosine_decay(0.0, lr, min(500, max(1, n // 4)), n, lr / 5.0),
                        args.grad_clip, skip_nonfinite=False)
        p_step = make_generator_pretrain_step(gan.hift, opt, gan.loss_cfg)
        done, epoch, pm, mel_recent, plateau = 0, 0, None, [], False
        while done < n and not plateau:
            dataset.set_epoch(PRETRAIN_EPOCH0 + epoch)
            epoch += 1
            had_batches = False
            for b in iter(dataset):
                had_batches = True
                batch = gan.collate(b)
                pm = p_step(batch, gan.draws(batch))
                done += 1
                if done % args.log_interval == 0:
                    logging.info("gan pretrain step %d loss=%.4f mel=%.4f", done, float(pm["loss"]), float(pm["mel"]))
                if done % 50 == 0:
                    mel_recent = (mel_recent + [float(pm["mel"])])[-5:]
                if (done >= probe_at and attempt < PRETRAIN_ATTEMPTS - 1 and len(mel_recent) >= 3
                        and min(mel_recent) > PLATEAU_MEL):
                    logging.warning("gan pretrain attempt %d in the plateau at step %d (recent mel %.2f); restarting "
                                    "from a fresh init at lr %.2e", attempt, done, float(np.mean(mel_recent)), lr * 0.5)
                    plateau = True
                    break
                if done >= n:
                    break
            if not had_batches:
                logging.warning("gan pretrain: the dataset yielded no batches; stopping at %d steps", done)
                break
        if not plateau:
            break
    if pm is not None:
        logging.info("generator pretrain done: %d steps, final mel=%.4f", done, float(pm["mel"]))
        pm = {**pm, "steps": done, "attempt": attempt}
    return pm


def train_gan(args, gan, dataset, executor):
    """args.max_epoch epochs of alternating generator and discriminator
    steps (the same source draws for both), each epoch saved by `executor`
    as {"generator", "discriminator"} with the epoch's mean generator loss
    as cv_loss."""
    for epoch in range(args.max_epoch):
        dataset.set_epoch(epoch)
        gen_losses = []
        for b in iter(dataset):
            batch = gan.collate(b)
            d = gan.draws(batch)
            gm = gan.gen_step(batch, d)
            dm = gan.disc_step(batch, d)
            executor.step += 1
            gen_losses.append(float(gm["loss"]))
            if executor.step % args.log_interval == 0:
                logging.info("gan step %d gen=%.4f disc=%.4f", executor.step, gen_losses[-1], float(dm["loss"]))
        executor.epoch = epoch + 1
        executor.save({"generator": gan.hift, "discriminator": gan.disc},
                      {"cv_loss": float(np.mean(gen_losses)) if gen_losses else float("inf")})


def _multihost(device):
    """(this rank's device, the "dp" mesh over every rank): the process
    group from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; on the card the device LOCAL_RANK), unless one is open."""
    import torch.distributed as dist

    from cosyvoice_tpu_torch.parallel.sharding import init_distributed, make_mesh

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", device.index or 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        init_distributed(device)
    return device, make_mesh(dp=dist.get_world_size(), tp=1)


def main(argv=None, opener=None):
    """Train; returns the Executor and the branch (build_lm, build_lm_v1,
    build_flow, build_flow_v1 or build_gan). `opener` replaces the
    pipeline's parquet_opener (build_pipeline): a caller that holds the rows
    in memory (the hermetic recipe) gives the data list's lines its own
    meaning."""
    args, cfg = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    version = int(cfg.get("version", 2))
    from cosyvoice_tpu_torch.data.dataset import Dataset
    from cosyvoice_tpu_torch.frontend.tokenizer import get_tokenizer
    from cosyvoice_tpu_torch.train.executor import Executor
    from cosyvoice_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    rank, world, mesh = 0, 1, None
    if args.multihost:
        if args.model == "hifigan" or version == 1:
            raise NotImplementedError("--multihost trains the llm and flow branches of CosyVoice2/3")
        device, mesh = _multihost(device)
        rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    random.seed(args.seed)
    np.random.seed(args.seed)
    tokenizer = get_tokenizer(args.tokenizer_path or None, version=version)
    if args.model == "hifigan":
        gan = build_gan(args, cfg, device)
        dataset = Dataset(args.train_data, build_pipeline(args, tokenizer, gan=True,
                                                          truncate_length=int(gan.conf["truncate_length"]),
                                                          opener=opener))
        pretrain_generator(args, gan, dataset)
        executor = Executor(None, args.model_dir, model_name="hifigan", log_interval=args.log_interval)
        train_gan(args, gan, dataset, executor)
        return executor, gan
    if version == 1:
        branch = {"llm": build_lm_v1, "flow": build_flow_v1}[args.model](args, cfg, device)
    else:
        branch = (build_lm if args.model == "llm" else build_flow)(args, cfg, device, mesh)
    pipeline = build_pipeline(args, tokenizer, opener=opener)
    dataset = Dataset(args.train_data, pipeline, rank=rank, world_size=world)
    cv_dataset = Dataset(args.cv_data, pipeline, rank=rank, world_size=world) if args.cv_data else None
    cv_iter_fn = (lambda: iter(cv_dataset)) if cv_dataset is not None else None
    executor = Executor(branch.step, args.model_dir, model_name=args.model, log_interval=args.log_interval,
                        save_per_step=args.save_per_step, rank=rank)
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
