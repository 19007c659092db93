"""The port's F0 extraction (ops/f0.py, the native YIN helper built with
g++) against the JAX package's, and the GAN pipeline's `compute_f0`: the
native tracks equal, the numpy plain versions equal, the port's native
track against its own plain version, processor rows through both
packages' `compute_f0`, and a g++ failure raises instead of falling back."""

import subprocess

import numpy as np
import pytest

from cosyvoice_tpu.data import processor as jprocessor
from cosyvoice_tpu.ops import f0 as jf0
from cosyvoice_tpu_torch.data import processor
from cosyvoice_tpu_torch.ops import f0

# the native helper against its numpy plain version: the helper accumulates
# the difference function in float64, numpy sums the float32 squares
# pairwise, which moves the parabolic refinement slightly (measured 8e-8
# relative on the 180 Hz tone)
PLAIN_RTOL = 1e-4


def _signals(sr=24000, seconds=1.02):
    """A voiced tone with noise, a gliding tone, noise, silence, and a tone
    that stops half way (voiced, unvoiced and energy-gated frames)."""
    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    tone = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.01 * rng.standard_normal(len(t))
    glide = 0.3 * np.sin(2 * np.pi * (120 * t + 100 * t**2))
    half = tone * (t < seconds / 2)
    return [x.astype(np.float32) for x in (tone, glide, 0.1 * rng.standard_normal(len(t)), 0 * t, half)]


@pytest.mark.parametrize("sr,hop", [(24000, 480), (22050, 256)])
def test_native_yin_equals_jax_and_its_plain_version(sr, hop):
    for i, wav in enumerate(_signals(sr)):
        got = f0.yin_f0(wav, sr, hop)
        np.testing.assert_array_equal(got, jf0.yin_f0(wav, sr, hop), err_msg=f"signal {i}")
        np.testing.assert_array_equal(f0.yin_f0_numpy(wav, sr, hop), jf0.yin_f0_numpy(wav, sr, hop))
        np.testing.assert_allclose(got, f0.yin_f0_numpy(wav, sr, hop), rtol=PLAIN_RTOL, atol=0, err_msg=f"signal {i}")
    tone = f0.yin_f0(_signals(sr)[0], sr, hop)
    assert np.median(tone[tone > 0]) == pytest.approx(180, rel=1e-2)
    assert not f0.yin_f0(_signals(sr)[3], sr, hop).any()  # silence is unvoiced


def test_compute_f0_on_processor_rows_matches_jax():
    """Rows as the GAN pipeline has them after compute_fbank (speech_feat
    gives the mel length the track is interpolated to)."""
    def rows():
        for i, wav in enumerate(_signals()):
            n = 51 if i % 2 else len(wav) // 480  # interpolated, and already at the mel length
            yield {"utt": f"u{i}", "audio": wav, "speech_feat": np.zeros((n, 80), np.float32)}

    got = list(processor.compute_f0(rows(), sample_rate=24000, hop_size=480))
    want = list(jprocessor.compute_f0(rows(), sample_rate=24000, hop_size=480))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["pitch_feat"].dtype == np.float32 and g["pitch_feat"].shape == (g["speech_feat"].shape[0],)
        np.testing.assert_array_equal(g["pitch_feat"], w["pitch_feat"])


def test_a_failed_build_raises_naming_gxx(tmp_path, monkeypatch):
    """No library yet and g++ failing (absent, then exiting 1): extract_f0
    raises a RuntimeError naming g++ (the JAX package falls back to numpy)."""
    monkeypatch.setattr(f0, "BUILD_DIR", tmp_path)
    f0.load_library.cache_clear()
    wav = _signals()[0]

    def absent(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(subprocess, "run", absent)
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        f0.extract_f0(wav, 24000, 480, 51)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(a, 1, "", "error"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        f0.extract_f0(wav, 24000, 480, 51)
    assert not list(tmp_path.iterdir())  # nothing half-built is left
    monkeypatch.undo()
    f0.load_library.cache_clear()
