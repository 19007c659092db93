"""Training executor: the epoch loop, cross-validation, checkpoints,
TensorBoard.

Counterpart of cosyvoice_tpu/train/executor.py. A checkpoint is the
module's JAX param tree (`convert.export_params`: float32, the Flax paths)
written as flax msgpack by utils/msgpack_io.py, beside a JSON sidecar
{"epoch", "step", "save_time", CV metrics}: the JAX package's
`flax.serialization.from_bytes` reads it, and `resume` reads the JAX
package's. TensorBoard logging is optional (torch.utils.tensorboard).
"""

import glob
import json
import logging
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from cosyvoice_tpu_torch.convert import export_params, load_jax_params
from cosyvoice_tpu_torch.utils import msgpack_io
from cosyvoice_tpu_torch.utils.devices import resolve_device
from cosyvoice_tpu_torch.utils.msgpack_io import to_torch


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Executor:
    """train_step(batch, step) -> metrics runs one optimizer step on the
    trained module; `step` counts the steps taken, `epoch` the epochs. Of
    the ranks of a multi-process run only rank 0 writes (checkpoints,
    sidecars, TensorBoard)."""

    def __init__(self, train_step: Callable, out_dir: str, model_name: str = "model", log_interval: int = 100,
                 save_per_step: int = -1, tensorboard: bool = True, rank: int = 0):
        self.train_step = train_step
        self.out_dir = out_dir
        self.model_name = model_name
        self.log_interval = log_interval
        self.save_per_step = save_per_step
        self.rank = rank
        self.step = 0
        self.epoch = 0
        self.writer = None
        if tensorboard and rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(os.path.join(out_dir, "tensorboard"))
            except Exception:  # noqa: BLE001 — the tensorboard package is optional
                logging.warning("tensorboard unavailable; logging to stdout only")
        os.makedirs(out_dir, exist_ok=True)

    def train_one_epoch(self, module, train_iter: Iterable, collate: Callable, cv_fn=None, cv_iter=None):
        """One pass over `train_iter` (batches, or lists of A batches under
        accumulation), each through `collate` into one step; every
        save_per_step steps a CV pass and a checkpoint of `module`."""
        t0 = time.time()
        for batch in train_iter:
            metrics = self.train_step(collate(batch), self.step)
            self.step += 1
            if self.step % self.log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
                rate = self.log_interval / (time.time() - t0)
                t0 = time.time()
                logging.info("epoch %d step %d %s (%.2f it/s)", self.epoch, self.step, m, rate)
                self._tb(m)
            if self.save_per_step > 0 and self.step % self.save_per_step == 0:
                cv_metrics = self.cross_validate(cv_fn, cv_iter, collate) if cv_fn else {}
                self.save(module, cv_metrics)
        self.epoch += 1

    def cross_validate(self, loss_fn: Callable, cv_iter, collate: Callable) -> dict:
        """{"cv_loss": the mean of loss_fn(collate(batch)) over `cv_iter`
        (an iterable, or a factory of a fresh one)}."""
        if cv_iter is None:
            return {}
        if callable(cv_iter):
            cv_iter = cv_iter()
        tot, n = 0.0, 0
        for batch in cv_iter:
            tot += float(loss_fn(collate(batch)))
            n += 1
        metrics = {"cv_loss": tot / max(n, 1)}
        logging.info("CV epoch %d step %d: %s", self.epoch, self.step, metrics)
        self._tb(metrics)
        return metrics

    def save(self, module, metrics: Optional[dict] = None) -> Optional[str]:
        """<model_name>_epoch<E>_step<S>.msgpack (the module's JAX param
        tree; for a dict of modules, such as the GAN's {"generator",
        "discriminator"}, the dict of their trees) and its .json sidecar.
        Returns the checkpoint's path; None on a rank other than 0, which
        writes nothing."""
        if self.rank != 0:
            return None
        tag = f"{self.model_name}_epoch{self.epoch}_step{self.step}"
        path = os.path.join(self.out_dir, f"{tag}.msgpack")
        tree = {k: export_params(m) for k, m in module.items()} if isinstance(module, dict) else export_params(module)
        msgpack_io.write(path, tree)
        side = {"epoch": self.epoch, "step": self.step, "save_time": time.strftime("%Y-%m-%d %H:%M:%S")}
        for k, v in (metrics or {}).items():
            try:
                side[k] = float(v)
            except (TypeError, ValueError):  # non-numeric metadata, e.g. {"note": "init"}
                side[k] = v
        with open(os.path.join(self.out_dir, f"{tag}.json"), "w") as f:
            json.dump(side, f, indent=2)
        logging.info("saved %s", path)
        return path

    def resume(self, module, checkpoint_path: str):
        """Load a checkpoint (either package's) into `module`, and the step
        and epoch from its sidecar where there is one. Returns the module."""
        load_jax_params(module, msgpack_io.read(checkpoint_path))
        side_path = checkpoint_path.replace(".msgpack", ".json")
        if os.path.exists(side_path):
            with open(side_path) as f:
                side = json.load(f)
            self.step = side.get("step", 0)
            self.epoch = side.get("epoch", 0)
        logging.info("resumed from %s (epoch %d step %d)", checkpoint_path, self.epoch, self.step)
        return module

    def _tb(self, metrics: dict):
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(f"train/{k}", v, self.step)


def average_checkpoints(paths, device="cuda"):
    """The leafwise mean of the checkpoints' trees (the reference's best-N
    averaging), summed in float64 on `device` and returned as float32 numpy
    arrays: the JAX package's numpy float64 mean, bit for bit."""
    dev = resolve_device(device)
    acc = None
    for p in paths:
        tree = _tree_map(lambda x: to_torch(np.asarray(x)).to(dev, torch.float64), msgpack_io.read(p))
        acc = tree if acc is None else _tree_map(torch.add, acc, tree)
    return _tree_map(lambda a: (a / len(paths)).float().cpu().numpy(), acc)


def select_best_checkpoints(out_dir: str, model_name: str, num: int = 5, metric: str = "cv_loss"):
    """The `num` checkpoints of `model_name` with the lowest `metric` in
    their sidecars."""
    cands = []
    for side in glob.glob(os.path.join(out_dir, f"{model_name}_*.json")):
        with open(side) as f:
            info = json.load(f)
        if metric in info:
            cands.append((info[metric], side.replace(".json", ".msgpack")))
    cands.sort()
    return [p for _, p in cands[:num]]
