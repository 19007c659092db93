"""The port's training data pipeline against the JAX package's
(cosyvoice_tpu/data/processor.py, dataset.py, train/online_features.py):
the processor chain array for array on synthetic rows and on shards that
pyarrow writes, the shard partition, pyarrow's absence, and the online S3
tokens."""

import random
import sys
from functools import partial

import numpy as np
import pytest

from cosyvoice_tpu.data import dataset as jdataset
from cosyvoice_tpu.data import processor as J
from cosyvoice_tpu.frontend.tokenizer import get_tokenizer as jget_tokenizer
from cosyvoice_tpu_torch.data import dataset
from cosyvoice_tpu_torch.data import processor as P
from cosyvoice_tpu_torch.frontend.tokenizer import get_tokenizer

# log-mel features: the port computes in float64 (ops/mel.py), the JAX ops
# in float32; the resampled audio: the port's resample_poly in float64
# against scipy's
MEL_ATOL = 2e-4
AUDIO_ATOL = 1e-6


def _rows(seed=0, n=6):
    """Rows as parquet_opener yields them: 24, 16 and 22.05 kHz audio (one
    with a peak past 1), one too short for the length filter."""
    rng = np.random.default_rng(seed)
    rates = [24000, 16000, 22050, 24000, 16000, 24000]
    rows = []
    for i in range(n):
        sr = rates[i % len(rates)]
        secs = 0.05 if i == 5 else 0.6 + 0.15 * i
        audio = (rng.standard_normal(int(sr * secs)) * (1.5 if i == 2 else 0.1)).astype(np.float32)
        rows.append({"utt": f"u{i}", "text": f"hello world {i}" * (1 + i % 3), "audio": audio, "sample_rate": sr,
                     "utt_embedding": rng.standard_normal(192).astype(np.float32).tolist(),
                     "speech_token": rng.integers(0, 6561, 10 + 5 * i).tolist(),
                     "reject_speech_token": rng.integers(0, 6561, 7 + i).tolist()})
    return rows


def _chain(mod, tok, opener=None):
    """The LM/flow chain of bin/train.py plus the whisper features, over
    `mod`'s processors."""
    chain = [
        partial(mod.tokenize, tokenizer=tok),
        partial(mod.filter_samples, max_length=40960, min_length=10, token_max_length=200),
        partial(mod.resample, resample_rate=24000),
        partial(mod.compute_fbank, sample_rate=24000, hop=480),
        mod.compute_whisper_fbank,
        mod.parse_embedding,
        partial(mod.shuffle, shuffle_size=3),
        partial(mod.sort_by_len, sort_size=4),
        partial(mod.batch, batch_type="dynamic", max_frames_in_batch=150),
        partial(mod.padding, dpo=True),
    ]
    return ([opener] if opener else []) + chain


def _run(chain, source, seed=0):
    random.seed(seed)  # shuffle draws from Python's global random, in both packages
    it = iter(source)
    for fn in chain:
        it = fn(it)
    return list(it)


def _hold(got, want):
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "utts":
                assert g[k] == w[k]
            elif np.issubdtype(np.asarray(w[k]).dtype, np.integer):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                atol = MEL_ATOL if k in ("speech_feat", "whisper_feat") else AUDIO_ATOL
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)
                assert g[k].dtype == np.asarray(w[k]).dtype, k


def test_tokenizers_agree():
    text = "hello world <|endofprompt|> 你好"
    assert get_tokenizer(None).encode(text, allowed_special="all") == jget_tokenizer(None).encode(
        text, allowed_special="all")


def test_processor_chain_matches_jax_on_rows():
    got = _run(_chain(P, get_tokenizer(None)), [dict(r) for r in _rows()])
    want = _run(_chain(J, jget_tokenizer(None)), [dict(r) for r in _rows()])
    _hold(got, want)
    assert sum(len(b["utts"]) for b in got) == 5  # the 0.05 s row filtered out


def test_resample_and_truncate_match_jax():
    rows = _rows(1)
    got = list(P.resample([dict(r) for r in rows], resample_rate=16000))
    want = list(J.resample([dict(r) for r in rows], resample_rate=16000))
    for g, w in zip(got, want):
        assert g["sample_rate"] == w["sample_rate"] == 16000
        np.testing.assert_allclose(g["audio"], w["audio"], rtol=0, atol=AUDIO_ATOL)
    random.seed(3)
    got = [s["audio"] for s in P.truncate([dict(r) for r in rows], truncate_length=12000)]
    random.seed(3)
    want = [s["audio"] for s in J.truncate([dict(r) for r in rows], truncate_length=12000)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _write_shards(tmp_path, rows, per_shard=3):
    import pyarrow as pa
    import pyarrow.parquet as pq

    paths = []
    for i in range(0, len(rows), per_shard):
        shard = rows[i : i + per_shard]
        table = {k: [r[k].tolist() if k == "audio" else r[k] for r in shard] for k in shard[0]}
        path = tmp_path / f"shard{i // per_shard}.parquet"
        pq.write_table(pa.table(table), path)
        paths.append(str(path))
    listfile = tmp_path / "data.list"
    listfile.write_text("\n".join(paths) + "\n")
    return str(listfile), paths


def test_dataset_over_parquet_shards_matches_jax(tmp_path):
    listfile, _ = _write_shards(tmp_path, _rows(2, n=12))
    ds = dataset.Dataset(listfile, _chain(P, get_tokenizer(None), P.parquet_opener))
    jds = jdataset.Dataset(listfile, _chain(J, jget_tokenizer(None), J.parquet_opener))
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        random.seed(epoch)
        got = list(iter(ds))
        random.seed(epoch)
        want = list(iter(jds))
        _hold(got, want)


def test_data_list_partition_matches_jax():
    paths = [f"s{i}" for i in range(11)]
    for epoch in (0, 3):
        for world in (1, 2, 4):
            for rank in range(world):
                got = list(dataset.DataList(paths, rank=rank, world_size=world, epoch=epoch))
                want = list(jdataset.DataList(paths, rank=rank, world_size=world, epoch=epoch))
                assert got == want and len(got) == len(paths) // world


def test_parquet_opener_without_pyarrow_raises_naming_it(monkeypatch, tmp_path):
    listfile, paths = _write_shards(tmp_path, _rows(3, n=3))
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        list(P.parquet_opener([{"src": paths[0]}]))


def test_parquet_opener_skips_an_unreadable_shard(tmp_path):
    listfile, paths = _write_shards(tmp_path, _rows(4, n=3))
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(b"not parquet")
    rows = list(P.parquet_opener([{"src": str(bad)}, {"src": paths[0]}]))
    assert [r["utt"] for r in rows] == ["u0", "u1", "u2"] and rows[0]["audio"].dtype == np.float32


def test_online_speech_tokens_match_jax():
    from cosyvoice_tpu.models.speech_tokenizer import S3TokenizerConfig as JS3Config
    from cosyvoice_tpu.train.online_features import OnlineSpeechTokenExtractor as JExtractor
    from cosyvoice_tpu_torch.convert import load_jax_params
    from cosyvoice_tpu_torch.models.speech_tokenizer import S3Tokenizer, S3TokenizerConfig
    from cosyvoice_tpu_torch.train.online_features import OnlineSpeechTokenExtractor
    from tests.test_torch_common import np_tree, to_port_cfg

    jcfg = JS3Config(d_model=32, num_heads=2, num_layers=1, fsq_levels=(3,) * 4, codebook_size=81)
    jex = JExtractor(cfg=jcfg, rng_seed=3)
    s3 = S3Tokenizer(to_port_cfg(jcfg, S3TokenizerConfig))
    load_jax_params(s3, np_tree(jex.params["params"]))
    ex = OnlineSpeechTokenExtractor(tokenizer=s3)
    rng = np.random.default_rng(0)
    batch = {"whisper_feat": rng.standard_normal((2, 100, 128)).astype(np.float32),
             "whisper_feat_len": np.asarray([100, 60], np.int32)}
    got, want = ex.add_to_batch(batch), jex.add_to_batch(batch)
    for k in ("speech_token", "speech_token_len"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["speech_token_len"][0] == 25 and ex.add_to_batch(got) is got
