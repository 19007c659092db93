"""Multi-process workers of the port's distributed CPU tests.

`run_ranks(fn, world, out_dir, *args)` starts `world` spawned processes
with a gloo process group over 127.0.0.1 (torchrun's environment
variables set), runs worker `fn` (a function of this module) as
fn(rank, world, *args) in each and returns their results, rank by rank.
The workers import torch and the port only (no JAX), so that a spawn
costs an interpreter and torch."""

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120  # a collective that waits longer than this fails the worker instead of hanging


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn_name, args, out_dir):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        torch.save(globals()[fn_name](rank, world, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn_name: str, world: int, out_dir: str, *args) -> list:
    mp.start_processes(_entry, args=(world, free_port(), fn_name, args, str(out_dir)), nprocs=world,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- LM steps on a mesh


def _lm_module(spec):
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LMModule
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config

    cfg = LMConfig(**{**spec["lm"], "qwen": Qwen2Config(**spec["qwen"])})
    with torch.device("cpu"):
        module = Qwen2LMModule(cfg)
    module.load_state_dict(spec["init"])
    return module


def lm_steps(rank, world, spec_path):
    """Each scenario of the spec (mesh dp x tp and a placement: "lm" rules,
    "fsdp" rules or "zero2": lm rules plus ZeRO-2) takes the spec's steps
    from its initial weights on this rank's part of each global batch.
    Returns {scenario: {"loss", "acc", "grad_norm": per step, "max_err":
    the largest difference of this rank's weights (its shards) from the
    reference weights}}."""
    from functools import partial

    from cosyvoice_tpu_torch.parallel.sharding import (
        _tp_rows, axis_rank, axis_size, fsdp_param_spec, make_mesh, shard_accum_batch, shard_opt_state_zero,
        shard_params,
    )
    from cosyvoice_tpu_torch.train.trainer import make_lm_train_step, make_optimizer

    spec = torch.load(spec_path, weights_only=False)
    ref = _lm_module({**spec, "init": spec["ref"]})
    out = {}
    for name, dp, tp, placement in spec["scenarios"]:
        mesh = make_mesh(dp=dp, tp=tp)
        module = _lm_module(spec)
        rule = partial(fsdp_param_spec, min_size=spec["fsdp_min_size"]) if placement == "fsdp" else None
        shard_params(mesh, module, **({"rule": rule} if rule else {}))
        opt = make_optimizer(module.parameters(), **spec["opt"])
        if placement == "zero2":
            shard_opt_state_zero(mesh, opt, module)
        step = make_lm_train_step(module, opt, accum_steps=spec["accum"], mesh=mesh)
        hist = {"loss": [], "acc": [], "grad_norm": []}
        for i, b in enumerate(spec["batches"]):
            m = step(shard_accum_batch(mesh, b), i)
            for k in hist:
                hist[k].append(float(m[k]))
        tp_n, r = axis_size(mesh, "tp"), axis_rank(mesh, "tp")
        err = 0.0
        full = dict(ref.named_parameters())
        for pname, p in module.named_parameters():
            want = full[pname].detach()
            d = getattr(p, "tp_dim", None)
            if d == 0:
                want = _tp_rows(ref, pname, want, tp_n, r)
            elif d == 1:
                want = want.chunk(tp_n, 1)[r]
            err = max(err, float((p.detach() - want).abs().max()))
        hist["max_err"] = err
        hist["sharded"] = sorted(n for n, p in module.named_parameters()
                                 if getattr(p, "tp_dim", None) is not None or getattr(p, "dp_dim", None) is not None)
        out[name] = hist
    return out


# ---------------------------------------------------------------- the pipeline


def pipeline(rank, world, spec_path):
    """pipeline_forward over pp = world stages, n_micro 2: the output and
    this stage's gradients of mean(y^2) with respect to its layer slab."""
    from torch.distributed.device_mesh import init_device_mesh

    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config
    from cosyvoice_tpu_torch.parallel.pipeline import pipeline_forward, qwen2_layer_fn, shard_stacked_layers

    spec = torch.load(spec_path, weights_only=False)
    cfg = Qwen2Config(**spec["qwen"])
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pp",))
    stacked = shard_stacked_layers(mesh, spec["stacked"])
    y = pipeline_forward(mesh, qwen2_layer_fn(cfg), stacked, spec["x"], bcast=spec["bcast"], n_micro=2)
    y.square().mean().backward()
    return {"y": y.detach(), "grads": {k: v.grad for k, v in stacked.items()}}


# ---------------------------------------------------------------- bin/train.py --multihost


def train_multihost(rank, world, cfg_path, model_dir, rows_spec):
    """bin/train.main(... --multihost --device cpu) over an in-memory data
    list of `world` shards (one a rank), each rank with a model dir of its
    own. Returns the trained weights, the executor's step, the optimizer's
    count and the files in this rank's model dir."""
    from cosyvoice_tpu_torch.bin import train

    rng = np.random.default_rng(rows_spec["seed"])
    shards = {}
    for s in range(world):
        shards[f"s{s}"] = [
            {"utt": f"u{s}{i}", "text": f"hello world {i}", "audio": (rng.standard_normal(24000) * 0.1).astype(np.float32),
             "sample_rate": 24000, "utt_embedding": rng.standard_normal(192).astype(np.float32).tolist(),
             "speech_token": rng.integers(0, 64, 25).tolist()}
            for i in range(rows_spec["per_shard"])]
    data_list = os.path.join(model_dir, f"data_rank{rank}.list")
    with open(data_list, "w") as f:
        f.write("\n".join(shards) + "\n")

    def opener(sources):
        for s in sources:
            for row in shards[s["src"]]:
                yield {**row, "audio": row["audio"].copy()}

    out_dir = os.path.join(model_dir, f"out_rank{rank}")
    executor, branch = train.main(["--model", "llm", "--config", cfg_path, "--train_data", data_list,
                                   "--model_dir", out_dir, "--device", "cpu", "--multihost"], opener=opener)
    dist.barrier()
    return {"weights": {n: p.detach().clone() for n, p in branch.module.named_parameters()},
            "step": executor.step, "files": sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else [],
            "count": branch.optimizer.count}


# ---------------------------------------------------------------- the flow step on a mesh


def flow_steps(rank, world, spec_path):
    """The flow's accumulated step data-parallel over dp = world: this
    rank's rows of the global batch and of each microbatch's draws.
    Returns the metrics and the weights after the step."""
    from cosyvoice_tpu_torch.models.flow import CausalFlow
    from cosyvoice_tpu_torch.parallel.sharding import make_mesh, shard_accum_batch, shard_params
    from cosyvoice_tpu_torch.train.trainer import make_flow_train_step, make_optimizer

    spec = torch.load(spec_path, weights_only=False)
    flow = CausalFlow(spec["cfg"], device="cpu")
    flow.load_state_dict(spec["init"])
    mesh = make_mesh(dp=world, tp=1)
    shard_params(mesh, flow)
    opt = make_optimizer(flow.parameters(), **spec["opt"])
    step = make_flow_train_step(flow, opt, accum_steps=len(spec["draws"]), mesh=mesh)
    rows = spec["batch"]["token"].shape[1] // world
    draws = [{k: v[rank * rows:(rank + 1) * rows] for k, v in d.items()} for d in spec["draws"]]
    m = step(shard_accum_batch(mesh, spec["batch"]), None, True, draws)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "weights": {n: p.detach().clone() for n, p in flow.named_parameters()}}
