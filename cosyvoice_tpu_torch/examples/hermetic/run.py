"""The hermetic quality recipe: corpus -> supervised S3 tokenizer -> train the
tiny v2 (or v3) stack -> score the zero-shot engine.

Counterpart of examples/hermetic/run.py, with the same defaults, `--check`
thresholds, `--version 3` overrides and artifact fields. Real checkpoints
are not part of the repo, so quality is evidenced by overfitting the whole
stack (Qwen2 LM, causal flow, HiFT GAN, each through bin/train.py's own
code) on the synthetic corpus of corpus.py and scoring the engine with
tools/eval_quality.evaluate:

  cer                 template-ASR CER against the requested text
  speaker_similarity  CAM++ x-vector cosine, prompt against synthesis
  token_recovery      S3 re-tokenization of the synthesis against the truth
  mel_corr            log-mel Pearson correlation against the true audio

Stages: corpus (make_corpus, train_tokenizer, prep_features), rows (the
rows make_parquet_list would pack, held in memory: no parquet is written
or read, so the run needs no pyarrow), train_llm / train_flow /
train_hifigan (bin/train.main with `opener`, the data list's lines naming
in-memory shards of 16 utterances), assemble (lm, flow and the GAN
checkpoint's generator as hift.msgpack), eval. One route on the card and on
the CPU. The artifact (--out_json) adds the card's name and power limit,
the TF32 settings of the run and each stage's wall seconds.

    python -m cosyvoice_tpu_torch.examples.hermetic.run --work /tmp/hermetic \\
        [--n_utts 32] [--lm_epochs 60] [--flow_epochs 150] [--gan_epochs 40] \\
        [--check] [--out_json QUALITY.json] [--version 2|3] [--device cuda]
"""

import argparse
import glob
import json
import os
import pickle
import re
import shutil
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
SHARD_UTTS = 16  # utterances per shard (make_parquet_list --num_utts_per_parquet 16)

V3_OVERRIDES = {
    # CosyVoice3 at hermetic scale: the special rows inside the speech table,
    # the DiT flow (PreLookahead front end), a causal HiFT
    "version": 3,
    "llm": {"num_special_head": 200, "special_in_speech_table": True},
    "flow": {
        "input_size": 80, "encoder_type": "dit_prelookahead", "estimator_type": "dit",
        "dit_lookahead_channels": 64,
        "dit": {"dim": 64, "depth": 2, "heads": 2, "dim_head": 16, "ff_mult": 2, "static_chunk_size": 10},
    },
    "hift": {"causal": True},
}

CONFIG = {
    "version": 2,
    "llm": {
        "speech_token_size": 81,
        "block_size": 8,
        # the corpus's token streams are ~6-long constant runs (one word is
        # 6 frames of one tone), which RAS at tau_r 0.1 flags on every
        # repeat; 2.0 turns the anti-loop resample off for this corpus
        "tau_r": 2.0,
        "qwen": {
            "hidden_size": 64, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2,
            "head_dim": 16, "intermediate_size": 128, "vocab_size": 300,
            "max_cache_len": 512, "dtype": "float32",
        },
    },
    "flow": {
        "input_size": 64, "vocab_size": 81, "attention_heads": 2, "linear_units": 128,
        "num_blocks": 2, "num_up_blocks": 1,
        "estimator": {
            "channels": [64], "attention_head_dim": 16, "n_blocks": 1,
            "num_mid_blocks": 2, "num_heads": 2, "static_chunk_size": 10, "causal": True,
        },
        "cfm": {"n_timesteps": 10},
    },
    "hift": {
        "base_channels": 48, "resblock_kernel_sizes": [3, 7],
        "resblock_dilations": [[1, 3], [1, 3]],
        "source_resblock_kernel_sizes": [7, 7, 11],
        "source_resblock_dilations": [[1], [1], [1]],
    },
    "frontend": {
        "s3": {
            "n_mels": 32, "d_model": 32, "num_heads": 2, "num_layers": 1,
            "fsq_levels": [3, 3, 3, 3], "codebook_size": 81, "use_fsq": True,
        }
    },
    # GAN: a generator-only mel + F0 warmup, then a short adversarial polish;
    # batch 2 makes 16 optimizer steps an epoch of 32 utterances
    "gan": {"truncate_length": 11520, "mpd_channels": [16, 32, 64, 64],
            "mrd_resolutions": [[512, 120], [1024, 240]],
            "lr": 2e-4, "pretrain_steps": 5000, "pretrain_lr": 1e-3, "batch_size": 2},
    "train": {"sample_rate": 24000, "mel_hop": 480, "batch_type": "static",
              "batch_size": 8, "accum_grad": 1, "scheduler": "constantlr",
              "warmup_steps": 1, "log_interval": 200, "grad_clip": 5.0},
}
STRETCH = {"cer_max": 0.25, "token_recovery_min": 0.6, "mel_corr_min": 0.9}


def _merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def recipe_config(version: int = 2, gan_pretrain_steps: int = 0) -> dict:
    cfg = CONFIG if version == 2 else _merge(CONFIG, V3_OVERRIDES)
    if gan_pretrain_steps > 0:
        cfg = _merge(cfg, {"gan": {"pretrain_steps": gan_pretrain_steps}})
    return cfg


def latest_ckpt(exp_dir: str, model_name: str) -> str:
    cands = []
    for p in glob.glob(os.path.join(exp_dir, f"{model_name}_epoch*_step*.msgpack")):
        m = re.search(r"epoch(\d+)_step(\d+)", p)
        cands.append(((int(m.group(1)), int(m.group(2))), p))
    if not cands:
        raise FileNotFoundError(f"no {model_name} checkpoints in {exp_dir}")
    return max(cands)[1]


def corpus_rows(data_dir: str, sample_rate: int = 24000) -> list:
    """The rows tools/make_parquet_list packs from data_dir, in its order,
    as data/processor.parquet_opener yields them: utt, text, audio (float32
    at sample_rate), sample_rate, utt_embedding and speech_token (lists)."""
    from cosyvoice_tpu_torch.tools.extract_embedding import read_scp
    from cosyvoice_tpu_torch.utils.audio_io import load_wav

    utt2wav, utt2text = read_scp(f"{data_dir}/wav.scp"), read_scp(f"{data_dir}/text")
    with open(f"{data_dir}/utt2embedding.pkl", "rb") as f:
        utt2embedding = pickle.load(f)
    with open(f"{data_dir}/utt2speech_token.pkl", "rb") as f:
        utt2token = pickle.load(f)
    utts = [u for u in utt2wav if u in utt2text and u in utt2embedding and u in utt2token]
    return [{"utt": u, "text": utt2text[u], "audio": load_wav(utt2wav[u], sample_rate)[0],
             "sample_rate": sample_rate, "utt_embedding": np.asarray(utt2embedding[u], np.float32).tolist(),
             "speech_token": list(utt2token[u])} for u in utts]


def shard_rows(rows: list, out_dir: str, per_shard: int = SHARD_UTTS):
    """The rows cut into shards of `per_shard` and a data list naming them
    (out_dir/data.list, one shard name a line). Returns (data list path,
    opener): the opener maps {"src": name} to copies of its shard's rows,
    as parquet_opener maps a shard's path."""
    os.makedirs(out_dir, exist_ok=True)
    shards = {f"shard_{i // per_shard:09d}": rows[i : i + per_shard] for i in range(0, len(rows), per_shard)}
    data_list = os.path.join(out_dir, "data.list")
    with open(data_list, "w") as f:
        f.write("\n".join(shards) + "\n")

    def opener(sources):
        for s in sources:
            for row in shards[s["src"]]:
                yield {**row, "audio": row["audio"].copy(), **{k: v for k, v in s.items() if k != "src"}}

    return data_list, opener


def card_info() -> dict:
    """The card's name and power limit as nvidia-smi gives them (null off
    the card), and the TF32 settings of matmuls and cuDNN in this process."""
    name = power = None
    if torch.cuda.is_available():
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
            name, power = (x.strip() for x in out[0].split(",", 1))
        except (OSError, IndexError, ValueError, subprocess.SubprocessError):
            name = torch.cuda.get_device_name(0)
    return {"card": name, "power_limit": power,
            "tf32": {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}}


def thresholds_met(metrics: dict, th: dict) -> bool:
    return bool(metrics.get("cer") is not None and metrics["cer"] <= th["cer_max"]
                and (metrics.get("token_recovery") or 0) >= th["token_recovery_min"]
                and (metrics.get("mel_corr") or 0) >= th["mel_corr_min"]
                and (metrics.get("speaker_similarity") or 0) >= th["speaker_similarity_min"])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", required=True)
    ap.add_argument("--n_utts", type=int, default=32)
    ap.add_argument("--lm_epochs", type=int, default=60)
    ap.add_argument("--flow_epochs", type=int, default=150)
    ap.add_argument("--gan_epochs", type=int, default=40)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--tok_steps", type=int, default=500, help="S3 supervision steps")
    ap.add_argument("--max_eval_utts", type=int, default=16)
    ap.add_argument("--check", action="store_true", help="assert the quality thresholds")
    ap.add_argument("--cer_max", type=float, default=0.5)
    ap.add_argument("--token_recovery_min", type=float, default=0.25)
    ap.add_argument("--mel_corr_min", type=float, default=0.8)
    ap.add_argument("--speaker_similarity_min", type=float, default=0.5)
    ap.add_argument("--out_json", default="", help="also write the metrics JSON here")
    ap.add_argument("--version", type=int, default=2, choices=[2, 3],
                    help="model generation (3 = DiT flow + causal HiFT)")
    ap.add_argument("--gan_pretrain_steps", type=int, default=0,
                    help=">0 overrides the config's generator-warmup step count")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the recipe; returns the metrics (or raises, after writing the
    artifact with the failing stage)."""
    from cosyvoice_tpu_torch.utils.devices import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    th = {"cer_max": args.cer_max, "token_recovery_min": args.token_recovery_min, "mel_corr_min": args.mel_corr_min,
          "speaker_similarity_min": args.speaker_similarity_min}
    stage_s = {}
    meta_out = {
        "git_rev": _git_rev(), "version": args.version, "n_utts": args.n_utts,
        "epochs": {"llm": args.lm_epochs, "flow": args.flow_epochs, "gan": args.gan_epochs},
        "lr": args.lr, "tok_steps": args.tok_steps, "thresholds": th, "device": str(device),
        **card_info(), "stage_s": stage_s, "started": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    current = {"name": "startup"}

    def write_out(metrics, error=""):
        if not args.out_json:
            return
        out = {**metrics, **meta_out, "wall_s": round(time.time() - t0, 1),
               "finished": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
        if error:
            out["error"] = error
        else:
            out["thresholds_passed"] = thresholds_met(metrics, th)
            out["stretch_thresholds"] = STRETCH
            if metrics.get("cer") is not None:
                out["stretch_passed"] = {
                    "cer": metrics["cer"] <= STRETCH["cer_max"],
                    "token_recovery": (metrics.get("token_recovery") or 0) >= STRETCH["token_recovery_min"],
                    "mel_corr": (metrics.get("mel_corr") or 0) >= STRETCH["mel_corr_min"],
                }
        with open(args.out_json, "w") as f:
            json.dump(out, f, indent=1)

    def stage(name):
        now = time.time()
        if current["name"] != "startup":
            stage_s[current["name"]] = round(now - current["t"], 1)
        current.update(name=name, t=now)
        print(f"# stage {name} t={now - t0:.0f}s", flush=True)

    work = os.path.abspath(args.work)
    model_dir, data_dir = os.path.join(work, "model"), os.path.join(work, "data")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(recipe_config(args.version, args.gan_pretrain_steps), f, indent=1)
    try:
        metrics = _pipeline(args, device, work, model_dir, data_dir, stage)
        stage("done")
    except Exception as e:  # noqa: BLE001 - the artifact names the failing stage, then the error propagates
        write_out({}, error=f"stage '{current['name']}': {type(e).__name__}: {e}")
        raise
    print(json.dumps(metrics), flush=True)
    write_out(metrics)
    if args.check:
        assert metrics["n"] >= 1, metrics
        assert metrics["cer"] <= th["cer_max"], metrics
        assert metrics["token_recovery"] >= th["token_recovery_min"], metrics
        assert metrics["mel_corr"] >= th["mel_corr_min"], metrics
        assert metrics["speaker_similarity"] >= th["speaker_similarity_min"], metrics
        print("quality thresholds PASSED", flush=True)
    return metrics


def _git_rev() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO, capture_output=True, text=True,
                             timeout=10)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _pipeline(args, device, work, model_dir, data_dir, stage) -> dict:
    from functools import partial

    from cosyvoice_tpu_torch.bin import train
    from cosyvoice_tpu_torch.convert import export_params
    from cosyvoice_tpu_torch.examples.hermetic import template_asr
    from cosyvoice_tpu_torch.examples.hermetic.corpus import make_corpus, prep_features, segment_labels, \
        train_tokenizer
    from cosyvoice_tpu_torch.runtime.api import AutoModel, load_frontend
    from cosyvoice_tpu_torch.tools.eval_quality import _scp, evaluate
    from cosyvoice_tpu_torch.utils import msgpack_io
    from cosyvoice_tpu_torch.utils.audio_io import load_wav

    # 1. corpus; the S3 tokenizer supervised on the segments' word labels
    # (in context: each segment wav whole, word-boundary slots unsupervised);
    # the frontend's weights written into the model dir; the features
    stage("corpus")
    make_corpus(data_dir, n_utts=args.n_utts)
    fe = load_frontend(model_dir, device=device)
    with open(os.path.join(data_dir, "meta.json")) as f:
        meta = json.load(f)
    wavs, labels = [], []
    for utt, m in meta.items():
        for seg, key in (("_A", "text_a"), ("_B", "text_b")):
            wavs.append(load_wav(os.path.join(data_dir, "wavs", f"{utt}{seg}.wav"), 16000)[0])
            labels.append(segment_labels(m[key]))
    stage("tokenizer")
    tok_loss = train_tokenizer(fe, wavs, labels, steps=args.tok_steps)
    print(f"tokenizer supervision final CE loss: {tok_loss:.4f}", flush=True)
    for name in ("speech_tokenizer", "campplus"):
        msgpack_io.write(os.path.join(model_dir, f"{name}.msgpack"), export_params(getattr(fe, name)))
    stage("features")
    prep_features(data_dir, model_dir, device=device)

    # 2. the rows make_parquet_list would pack, in shards of 16
    stage("rows")
    data_list, opener = shard_rows(corpus_rows(data_dir), os.path.join(work, "rows"))

    # 3. each sub-model through bin/train.py's main
    cfg_path = os.path.join(model_dir, "config.json")
    for model, epochs, lr in (("llm", args.lm_epochs, args.lr), ("flow", args.flow_epochs, args.lr),
                              ("hifigan", args.gan_epochs, None)):
        stage(f"train_{model}")
        argv = ["--config", cfg_path, "--model", model, "--train_data", data_list, "--model_dir",
                os.path.join(work, f"exp_{model}"), "--max_epoch", str(epochs), "--device", str(device)]
        if lr is not None:
            argv += ["--lr", str(lr)]
        if model == "flow":
            argv += ["--batch_size", "2"]  # 16 optimizer steps an epoch on 32 utterances
        train.main(argv, opener=opener)

    # 4. the model dir: llm, flow and the GAN checkpoint's generator
    stage("assemble")
    shutil.copy(latest_ckpt(os.path.join(work, "exp_llm"), "llm"), os.path.join(model_dir, "lm.msgpack"))
    shutil.copy(latest_ckpt(os.path.join(work, "exp_flow"), "flow"), os.path.join(model_dir, "flow.msgpack"))
    gan = msgpack_io.read(latest_ckpt(os.path.join(work, "exp_hifigan"), "hifigan"))
    msgpack_io.write(os.path.join(model_dir, "hift.msgpack"), gan["generator"])

    # 5. the quality numbers through tools/eval_quality
    stage("eval")
    eval_dir = os.path.join(data_dir, "eval")
    synth = os.path.join(work, "synth")
    os.makedirs(synth, exist_ok=True)
    with open(os.path.join(eval_dir, "tts_text.json")) as f:
        tts_text = json.load(f)
    model = AutoModel(model_dir, device=device)
    return evaluate(model, tts_text, _scp(os.path.join(eval_dir, "wav.scp")), _scp(os.path.join(eval_dir, "text")),
                    _scp(os.path.join(eval_dir, "ref.scp")), partial(template_asr.transcribe, corpus_dir=data_dir),
                    synth, args.max_eval_utts)


if __name__ == "__main__":
    main()
