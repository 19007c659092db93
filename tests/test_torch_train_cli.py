"""The port's training entry points on the CPU, held against the JAX
package: bin/train.py for one epoch with CV on tiny LM and flow configs
over a parquet data list, checkpoints read by flax.serialization and JAX
checkpoints resumed, bin/average_model against the JAX averaging,
--multihost in two gloo processes and its raise on the GAN branch (the GAN
and v1 branches themselves: tests/test_torch_gan.py,
tests/test_torch_train_v1.py), and the data-prep tools (extract_embedding,
extract_speech_token, make_parquet_list) against the JAX tools on a tiny
kaldi-style dir."""

import json
import os
import pickle
import shutil
import sys

import flax.serialization as ser
import jax
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow import CausalFlow as JCausalFlow
from cosyvoice_tpu.models.llm import Qwen2LM as JQwen2LM
from cosyvoice_tpu.train import executor as jexecutor
from cosyvoice_tpu.utils.config import build_flow_config as jbuild_flow_config
from cosyvoice_tpu.utils.config import build_lm_config as jbuild_lm_config
from cosyvoice_tpu_torch.bin import average_model, train
from cosyvoice_tpu_torch.convert import export_params
from cosyvoice_tpu_torch.train.executor import Executor
from cosyvoice_tpu_torch.utils import msgpack_io
from cosyvoice_tpu_torch.utils.audio_io import save_wav
from tests.test_torch_common import np_tree

torch.set_num_threads(1)

CFG = {
    "llm": {"speech_token_size": 64, "qwen": {"hidden_size": 32, "num_layers": 1, "num_heads": 2, "num_kv_heads": 1,
                                              "head_dim": 16, "intermediate_size": 64, "vocab_size": 300,
                                              "max_cache_len": 256, "dtype": "float32"}},
    "flow": {"input_size": 32, "chunk_size": 5, "attention_heads": 2, "linear_units": 64, "num_blocks": 1,
             "num_up_blocks": 1, "estimator": {"channels": [32], "attention_head_dim": 8, "n_blocks": 1,
                                               "num_mid_blocks": 1, "num_heads": 2, "static_chunk_size": 10},
             "cfm": {"n_timesteps": 2}},
    "train": {"max_epoch": 1, "log_interval": 1, "batch_type": "static", "batch_size": 2, "accum_grad": 2,
              "warmup_steps": 2, "lr": 1e-3},
}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg="/".join(k))


def _jax_template(model):
    key = jax.random.PRNGKey(0)
    if model == "llm":
        return JQwen2LM(jbuild_lm_config(CFG["llm"])).init(key)
    return JCausalFlow(jbuild_flow_config(CFG["flow"])).init(key)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two parquet shards of 8 one-second utterances and their data list."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    paths = []
    for s in range(2):
        rows = {"utt": [f"u{s}{i}" for i in range(4)], "text": [f"hello world {i}" for i in range(4)],
                "audio": [(rng.standard_normal(24000) * 0.1).astype(np.float32).tolist() for _ in range(4)],
                "sample_rate": [24000] * 4,
                "utt_embedding": [rng.standard_normal(192).astype(np.float32).tolist() for _ in range(4)],
                "speech_token": [rng.integers(0, 64, 25).tolist() for _ in range(4)]}
        paths.append(str(d / f"shard{s}.parquet"))
        pq.write_table(pa.table(rows), paths[-1])
    (d / "data.list").write_text("\n".join(paths) + "\n")
    (d / "cfg.json").write_text(json.dumps(CFG))
    return d


def _train(data, out, model, *flags):
    return train.main(["--model", model, "--config", str(data / "cfg.json"), "--train_data", str(data / "data.list"),
                       "--cv_data", str(data / "data.list"), "--model_dir", str(out), "--device", "cpu", *flags])


@pytest.mark.parametrize("model", ["llm", "flow"])
def test_train_one_epoch_with_cv_writes_checkpoints_flax_reads(data, tmp_path, model):
    executor, branch = _train(data, tmp_path, model)
    assert executor.epoch == 1 and executor.step == 2  # 8 utterances, batches of 2, 2 per step
    assert branch.optimizer.count == 2
    init, last = tmp_path / f"{model}_epoch0_step0", tmp_path / f"{model}_epoch1_step2"
    side = json.loads((tmp_path / f"{last.name}.json").read_text())
    assert side["epoch"] == 1 and side["step"] == 2 and np.isfinite(side["cv_loss"])
    assert json.loads((tmp_path / f"{init.name}.json").read_text())["note"] == "init"
    for path in (init, last):
        blob = (tmp_path / f"{path.name}.msgpack").read_bytes()
        restored = ser.from_bytes(_jax_template(model), blob)
        _assert_trees_equal(np_tree(restored), msgpack_io.loads(blob))
    _assert_trees_equal(msgpack_io.read(str(last) + ".msgpack"), export_params(branch.module))


def executor_args(data, model):
    return train.parse_args(["--model", model, "--config", str(data / "cfg.json"), "--train_data", "",
                             "--model_dir", ""])[0]


@pytest.mark.parametrize("model", ["llm", "flow"])
def test_jax_checkpoint_resumes_in_the_port(data, tmp_path, model):
    """A checkpoint the JAX package writes (flax to_bytes, sidecar at step
    7, epoch 3): bin/train.py --checkpoint loads its weights, the step and
    the epoch, and the schedule resumes at step 7."""
    params = _jax_template(model)
    ckpt = tmp_path / f"{model}_epoch3_step7.msgpack"
    ckpt.write_bytes(ser.to_bytes(params))
    (tmp_path / f"{model}_epoch3_step7.json").write_text(json.dumps({"epoch": 3, "step": 7}))
    loaded = Executor(lambda *a: {}, str(tmp_path / "resume"), model_name=model, tensorboard=False)
    module = train.build_lm if model == "llm" else train.build_flow
    branch = module(executor_args(data, model), CFG, torch.device("cpu"))
    loaded.resume(branch.module, str(ckpt))
    assert (loaded.epoch, loaded.step) == (3, 7)
    _assert_trees_equal(export_params(branch.module), np_tree(params))
    executor, branch = _train(data, tmp_path / "out", model, "--checkpoint", str(ckpt))
    assert (executor.epoch, executor.step) == (4, 9) and branch.optimizer.count == 9


def test_average_model_matches_jax_averaging(tmp_path):
    """Three checkpoints with CV sidecars: bin/average_model picks the two
    of lowest cv_loss and averages them as the JAX package's
    average_checkpoints does, bit for bit."""
    params = _jax_template("flow")
    rng = np.random.default_rng(1)
    for i, cv in enumerate((3.0, 1.0, 2.0)):
        tree = jax.tree.map(lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32), params)
        (tmp_path / f"flow_epoch{i}_step{i}.msgpack").write_bytes(ser.to_bytes(tree))
        (tmp_path / f"flow_epoch{i}_step{i}.json").write_text(json.dumps({"epoch": i, "step": i, "cv_loss": cv}))
    out = tmp_path / "flow.msgpack"
    paths = average_model.main(["--src_dir", str(tmp_path), "--model_name", "flow", "--num", "2", "--dst_model",
                                str(out), "--device", "cpu"])
    jpaths = jexecutor.select_best_checkpoints(str(tmp_path), "flow", 2)
    assert paths == jpaths and [os.path.basename(p) for p in paths] == ["flow_epoch1_step1.msgpack",
                                                                         "flow_epoch2_step2.msgpack"]
    want = jexecutor.average_checkpoints(jpaths, params)
    _assert_trees_equal(msgpack_io.read(str(out)), np_tree(want))
    assert ser.from_bytes(params, out.read_bytes()) is not None


@pytest.mark.parametrize("argv,match", [
    (["--model", "hifigan", "--multihost"], "llm and flow"),
])
def test_unported_branches_raise(tmp_path, argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train.main(argv + ["--train_data", "x", "--model_dir", str(tmp_path), "--device", "cpu"])


def test_multihost_two_ranks_train_equal_weights_and_rank0_alone_writes(tmp_path):
    """bin/train.py --multihost in two gloo processes (torchrun's
    environment), each reading one of two shards of 8 utterances: both take
    the same two accumulated steps, end with equal weights, and only rank 0
    writes checkpoints."""
    from tests.torch_dist import run_ranks

    cfg = {**CFG, "train": {**CFG["train"], "max_epoch": 1}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    res = run_ranks("train_multihost", 2, tmp_path, str(tmp_path / "cfg.json"), str(tmp_path),
                    {"seed": 0, "per_shard": 8})
    assert [r["step"] for r in res] == [2, 2] and [r["count"] for r in res] == [2, 2]
    for name, w in res[0]["weights"].items():
        np.testing.assert_array_equal(w.numpy(), res[1]["weights"][name].numpy(), err_msg=name)
    assert "llm_epoch1_step2.msgpack" in res[0]["files"] and "llm_epoch0_step0.msgpack" in res[0]["files"]
    assert res[1]["files"] == []


# ---------------------------------------------------------------- data-prep tools

CAM = ((2, 3, 1), (2, 3, 2), (2, 3, 2))  # tiny CAM++ blocks (tests/test_torch_api.py's)
S3 = {"d_model": 64, "num_heads": 4, "num_layers": 2}
EMB_ATOL = 1e-4  # CAM++ x-vectors, float32 on both


@pytest.fixture
def prep_dirs(tmp_path, monkeypatch):
    """A model dir (tiny S3 and CAM++ weights written by the port) and a
    kaldi-style dir of 4 utterances (16 and 24 kHz), with both packages'
    frontends built tiny."""
    from cosyvoice_tpu.frontend import frontend as jfrontend
    from cosyvoice_tpu.models import campplus as jcampplus
    from cosyvoice_tpu_torch.frontend import frontend as pfrontend
    from cosyvoice_tpu_torch.models.campplus import CamPPConfig, CamPPEmbedding
    from cosyvoice_tpu_torch.models.speech_tokenizer import S3Tokenizer, S3TokenizerConfig
    from cosyvoice_tpu_torch.utils.init import init_random_

    model = tmp_path / "model"
    model.mkdir()
    (model / "config.json").write_text(json.dumps({"frontend": {"s3": S3}}))
    msgpack_io.write(str(model / "speech_tokenizer.msgpack"),
                     export_params(init_random_(S3Tokenizer(S3TokenizerConfig(**S3)), 3)))
    msgpack_io.write(str(model / "campplus.msgpack"),
                     export_params(init_random_(CamPPEmbedding(CamPPConfig(blocks=CAM)), 4)))
    jcam = jcampplus.CamPPEmbedding
    for mod in (jcampplus, jfrontend):  # load_frontend's template and the frontend's own module
        monkeypatch.setattr(mod, "CamPPEmbedding", lambda: jcam(jcampplus.CamPPConfig(blocks=CAM)))
    monkeypatch.setattr(pfrontend, "CamPPConfig", lambda: CamPPConfig(blocks=CAM))
    d = tmp_path / "train"
    d.mkdir()
    rng = np.random.default_rng(0)
    lines = {"wav.scp": [], "utt2spk": [], "text": []}
    for i, sr in enumerate((16000, 24000, 16000, 22050)):
        t = np.arange(int(sr * (0.7 + 0.2 * i))) / sr
        save_wav(str(d / f"u{i}.wav"), 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                 + 0.02 * rng.standard_normal(len(t)), sr)
        lines["wav.scp"].append(f"u{i} {d / f'u{i}.wav'}")
        lines["utt2spk"].append(f"u{i} spk{i % 2}")
        lines["text"].append(f"u{i} hello number {i}")
    for name, ls in lines.items():
        (d / name).write_text("\n".join(ls) + "\n")
    return model, d


def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    module.main()


def test_extract_tools_and_parquet_list_match_jax(prep_dirs, tmp_path, monkeypatch):
    import pyarrow.parquet as pq

    from cosyvoice_tpu.tools import extract_embedding as jemb
    from cosyvoice_tpu.tools import extract_speech_token as jtok
    from cosyvoice_tpu.tools import make_parquet_list as jparquet
    from cosyvoice_tpu_torch.tools import extract_embedding, extract_speech_token, make_parquet_list

    model, d = prep_dirs
    jd = tmp_path / "jax_train"
    shutil.copytree(d, jd)
    extract_embedding.main(["--dir", str(d), "--model_dir", str(model), "--device", "cpu"])
    extract_speech_token.main(["--dir", str(d), "--model_dir", str(model), "--device", "cpu"])
    _jax_main(jemb, ["--dir", str(jd), "--model_dir", str(model), "--num_thread", "1"], monkeypatch)
    _jax_main(jtok, ["--dir", str(jd), "--model_dir", str(model)], monkeypatch)

    def load(path):
        with open(path, "rb") as f:
            return pickle.load(f)

    for name in ("utt2embedding.pkl", "spk2embedding.pkl"):
        got, want = load(d / name), load(jd / name)
        assert got.keys() == want.keys() and len(got) == (4 if name.startswith("utt") else 2)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=EMB_ATOL, err_msg=f"{name} {k}")
    got, want = load(d / "utt2speech_token.pkl"), load(jd / "utt2speech_token.pkl")
    assert got == want and all(len(v) > 5 for v in got.values())

    make_parquet_list.main(["--src_dir", str(d), "--des_dir", str(tmp_path / "pq"), "--num_utts_per_parquet", "3"])
    _jax_main(jparquet, ["--src_dir", str(d), "--des_dir", str(tmp_path / "jpq"), "--num_utts_per_parquet", "3"],
              monkeypatch)
    lists = [(tmp_path / p / "data.list").read_text().split() for p in ("pq", "jpq")]
    assert [os.path.basename(p) for p in lists[0]] == [os.path.basename(p) for p in lists[1]] and len(lists[0]) == 2
    for a, b in zip(*lists):
        ta, tb = pq.read_table(a).to_pydict(), pq.read_table(b).to_pydict()
        assert ta.keys() == tb.keys()
        for k in ta:
            if k == "audio":  # load_wav resamples 22.05 kHz: the port's resample_poly against scipy's
                for x, y in zip(ta[k], tb[k]):
                    np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)
            else:
                assert ta[k] == tb[k], k
