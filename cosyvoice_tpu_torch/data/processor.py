"""Host-side streaming data processors (parquet rows -> padded numpy batches).

Counterpart of cosyvoice_tpu/data/processor.py (the reference's
IterableDataset chain): parquet_opener -> tokenize -> filter -> resample ->
compute_fbank (+ whisper_fbank; the GAN's truncate before and compute_f0
after) -> parse_embedding -> shuffle -> sort -> dynamic/static batch ->
padding. Every processor is a generator over sample dicts; `Dataset`
(data/dataset.py) composes them. The features come from the port's ops
(ops/mel.py, ops/resample.py, ops/f0.py) on the host's CPU, so the trainer
sees the numerics the models expect.

`parquet_opener` imports pyarrow inside its body, the one place the port
reads parquet (tools/make_parquet_list.py writes it): without pyarrow it
raises an ImportError that names the package, rather than skipping shards.
"""

import logging
import random
from fractions import Fraction
from typing import Iterable, Iterator, List

import numpy as np
import torch

from cosyvoice_tpu_torch.ops.mel import mel_spectrogram, whisper_log_mel
from cosyvoice_tpu_torch.ops.resample import resample_poly


def parquet_opener(sources: Iterable[dict]) -> Iterator[dict]:
    """sources yield {"src": path}; emits one dict per row, "audio" as a
    float32 array. A shard that cannot be read is logged and skipped."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("parquet_opener needs the pyarrow package to read parquet shards") from e

    for s in sources:
        try:
            table = pq.read_table(s["src"]).to_pydict()
            keys = list(table.keys())
            for i in range(len(table[keys[0]])):
                row = {**{k: table[k][i] for k in keys}, **{k: v for k, v in s.items() if k != "src"}}
                if "audio" in row:  # parquet round-trips arrays as lists
                    row["audio"] = np.asarray(row["audio"], np.float32)
                yield row
        except Exception as e:  # noqa: BLE001 — skip a bad shard, keep training
            logging.warning("parquet_opener: failed to open %s: %s", s["src"], e)


def tokenize(data, tokenizer, allowed_special="all"):
    for sample in data:
        sample["text_token"] = np.asarray(tokenizer.encode(sample["text"], allowed_special=allowed_special), np.int32)
        yield sample


def filter_samples(data, max_length=40960, min_length=0, token_max_length=200, token_min_length=1,
                   min_output_input_ratio=0.0005, max_output_input_ratio=1.0):
    """Length filters in 10 ms frames and text tokens."""
    for sample in data:
        dur_frames = sample["audio"].shape[-1] / sample["sample_rate"] * 100
        if not (min_length <= dur_frames <= max_length):
            continue
        nt = len(sample["text_token"])
        if not (token_min_length <= nt <= token_max_length):
            continue
        if not (min_output_input_ratio <= nt / dur_frames <= max_output_input_ratio):
            continue
        yield sample


def _resample(audio: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """scipy's resample_poly at the rational ratio (denominator <= 1000),
    in float64 (as scipy computes a float32 input), returned float32."""
    frac = Fraction(sr_to, sr_from).limit_denominator(1000)
    out = resample_poly(torch.from_numpy(np.asarray(audio, np.float64)), frac.numerator, frac.denominator)
    return out.numpy().astype(np.float32)


def resample(data, resample_rate=24000, min_sample_rate=16000):
    for sample in data:
        sr = sample["sample_rate"]
        if sr < min_sample_rate:
            continue
        if sr != resample_rate:
            sample["audio"] = _resample(sample["audio"], sr, resample_rate)
            sample["sample_rate"] = resample_rate
        peak = np.abs(sample["audio"]).max()
        if peak > 1.0:
            sample["audio"] = sample["audio"] / peak
        yield sample


def truncate(data, truncate_length=24480):
    """Random fixed-length crop (GAN training)."""
    for sample in data:
        wav = sample["audio"]
        if wav.shape[-1] >= truncate_length:
            start = random.randint(0, wav.shape[-1] - truncate_length)
            sample["audio"] = wav[..., start : start + truncate_length]
        else:
            sample["audio"] = np.pad(wav, (0, truncate_length - wav.shape[-1]))
        yield sample


def compute_fbank(data, sample_rate=24000, hop=480, num_frames=0):
    """The flow's 80-mel target, [T, 80] float32, T = usable samples / hop."""
    for sample in data:
        wav = sample["audio"].reshape(1, -1)
        usable = (wav.shape[1] // hop) * hop
        mel = mel_spectrogram(torch.from_numpy(np.ascontiguousarray(wav[:, :usable])), sr=sample_rate, hop=hop)
        sample["speech_feat"] = mel[0].T.numpy()
        if num_frames and sample["speech_feat"].shape[0] > num_frames:
            sample["speech_feat"] = sample["speech_feat"][:num_frames]
        yield sample


def compute_whisper_fbank(data, num_frames=0):
    """128-mel whisper features [T, 128] at 100 Hz for online speech tokens
    (train/online_features.py), from "audio_16k" or the audio resampled."""
    for sample in data:
        wav16 = sample.get("audio_16k")
        if wav16 is None:
            wav16 = _resample(sample["audio"], sample["sample_rate"], 16000)
        mel = whisper_log_mel(torch.from_numpy(np.ascontiguousarray(wav16.reshape(1, -1))))[0]
        sample["whisper_feat"] = mel.T.numpy()
        yield sample


def compute_f0(data, sample_rate=24000, hop_size=480):
    """"pitch_feat": the native YIN F0 per hop interpolated to the mel's
    length ([T] float32, the HiFT GAN's F0 target)."""
    from cosyvoice_tpu_torch.ops.f0 import extract_f0

    for sample in data:
        sample["pitch_feat"] = extract_f0(sample["audio"], sample_rate, hop_size, sample["speech_feat"].shape[0])
        yield sample


def parse_embedding(data, normalize=True):
    for sample in data:
        emb = np.asarray(sample["utt_embedding"], np.float32)
        if normalize:
            emb = emb / (np.linalg.norm(emb) + 1e-12)
        sample["embedding"] = emb
        yield sample


def shuffle(data, shuffle_size=1000):
    buf: List[dict] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= shuffle_size:
            random.shuffle(buf)
            yield from buf
            buf = []
    random.shuffle(buf)
    yield from buf


def sort_by_len(data, sort_size=500):
    buf: List[dict] = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= sort_size:
            buf.sort(key=lambda s: s["speech_feat"].shape[0])
            yield from buf
            buf = []
    buf.sort(key=lambda s: s["speech_feat"].shape[0])
    yield from buf


def batch(data, batch_type="dynamic", batch_size=16, max_frames_in_batch=2000):
    """static: batch_size samples; dynamic: as many as keep the PADDED batch
    (longest * count mel frames) within max_frames_in_batch."""
    buf, frames = [], 0
    for sample in data:
        if batch_type == "static":
            buf.append(sample)
            if len(buf) >= batch_size:
                yield buf
                buf = []
        else:
            n = sample["speech_feat"].shape[0]
            if buf and max(frames, n) * (len(buf) + 1) > max_frames_in_batch:
                yield buf
                buf, frames = [], 0
            buf.append(sample)
            frames = max(frames, n)
    if buf:
        yield buf


def _pad2d(arrs, pad_value=0.0):
    T = max(a.shape[0] for a in arrs)
    out = np.full((len(arrs), T) + arrs[0].shape[1:], pad_value, arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out


def _padded(arrs, key, out):
    out[key] = _pad2d(arrs)
    out[key + "_len"] = np.asarray([a.shape[0] for a in arrs], np.int32)


def padding(data, gan: bool = False, dpo: bool = False):
    """Collate a list-of-samples batch into padded numpy arrays."""
    for samples in data:
        out = {"utts": [s.get("utt", "") for s in samples],
               "embedding": np.stack([s["embedding"] for s in samples])}
        _padded([s["text_token"] for s in samples], "text_token", out)
        _padded([s["speech_feat"] for s in samples], "speech_feat", out)
        if "speech_token" in samples[0]:
            _padded([np.asarray(s["speech_token"], np.int32) for s in samples], "speech_token", out)
        if "whisper_feat" in samples[0]:
            _padded([s["whisper_feat"] for s in samples], "whisper_feat", out)
        if gan:
            out["speech"] = _pad2d([s["audio"].reshape(-1, 1) for s in samples])[..., 0]
            out["pitch_feat"] = _pad2d([s["pitch_feat"].reshape(-1, 1) for s in samples])[..., 0]
        if dpo and "reject_speech_token" in samples[0]:
            _padded([np.asarray(s["reject_speech_token"], np.int32) for s in samples], "reject_speech_token", out)
        yield out
