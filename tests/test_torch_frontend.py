"""The port's host frontend and feature ops against the JAX package's, CPU:
text normalisation (English, Chinese, mixed, numbers, brackets, SSML,
punctuation only), the byte tokenizer, the tokenizer routing, the Matcha mel, the whisper log-mel
and the kaldi fbank (atol 1e-4 on the log values, noise and a chirp at three
lengths), `resample_poly` against scipy (max abs error 1e-5 on
unit-amplitude input) and the wav IO round trip.

The feature ops are held twice: on float64 input against the JAX op traced
in float64 (every signal), and on float32 input, as served, against the
JAX op in float32 (the noise). In float32 the JAX op's own FFT rounding
moves the chirp's quiet bands (100 dB below the frame's peak) by up to
9e-3 from the float64 value (and the noise's pre-emphasised lowest fbank
band by 5e-5); the port computes in float64 inside (ops/mel.py), so in
float32 it differs from the JAX op by the JAX op's own rounding error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from cosyvoice_tpu.frontend import text_normalize as jtn
from cosyvoice_tpu.frontend import zh_tn as jzh
from cosyvoice_tpu.frontend.tokenizer import ByteFallbackTokenizer as JByteTokenizer
from cosyvoice_tpu.frontend.tokenizer import get_tokenizer as jget_tokenizer
from cosyvoice_tpu.ops import mel as jmel
from cosyvoice_tpu.utils import audio_io as jaudio
from cosyvoice_tpu_torch.frontend import text_normalize as tn
from cosyvoice_tpu_torch.frontend import zh_tn
from cosyvoice_tpu_torch.frontend.tokenizer import ByteFallbackTokenizer, find_tokenizer_assets, get_tokenizer
from cosyvoice_tpu_torch.ops import mel
from cosyvoice_tpu_torch.ops.resample import resample_poly
from cosyvoice_tpu_torch.utils import audio_io

torch.set_num_threads(1)

LOG_ATOL = 1e-4  # float32 FFTs of two libraries, then a log
RESAMPLE_ATOL = 1e-5  # float32 polyphase sums against scipy's float64

TEXTS = [
    "Hello there, friend. How are you today?",
    "The year 2024 was great; I had 3 cats and 1001 ideas!",
    "你好，世界。今天是2024年3月5日，气温35.5%，花了¥12.5元。",
    "我的电话是13812345678，房间3-5个人，比例3/4。",
    "Mixed 中文 and English 文本 with 42 numbers.",
    "（括号）【测试】`反引号`——破折号，结尾，",
    "<|im_start|>SSML-like passthrough<|im_end|>",
    "!!..,",
    "?",
    "",
    "This is one. This is two. " + "word " * 40 + ". Short tail",
    "A long English paragraph that goes on and on, with commas, clauses and more clauses. " * 3,
]


@pytest.mark.parametrize("text", TEXTS)
def test_basic_normalize_matches_jax(text):
    enc, jenc = ByteFallbackTokenizer().encode, JByteTokenizer().encode
    for split in (True, False):
        assert tn.basic_normalize(text, enc, split=split) == jtn.basic_normalize(text, jenc, split=split)


@pytest.mark.parametrize("lang", ["zh", "en"])
@pytest.mark.parametrize("comma_split", [False, True])
def test_split_paragraph_matches_jax(lang, comma_split):
    enc = ByteFallbackTokenizer().encode
    for text in TEXTS:
        for lens in ((80, 60, 20), (40, 20, 10)):
            assert (tn.split_paragraph(text, enc, lang, *lens, comma_split=comma_split)
                    == jtn.split_paragraph(text, enc, lang, *lens, comma_split=comma_split))


def test_normalize_zh_matches_jax():
    for text in TEXTS + ["10005", "-3.50", "08:30:05", "3点15分", "0", "1234567890123"]:
        assert zh_tn.normalize_zh(text) == jzh.normalize_zh(text)


@pytest.mark.parametrize("version", [2, 3])
def test_byte_tokenizer_matches_jax(version):
    tok, jtok = get_tokenizer("", version), jget_tokenizer("", version)
    assert tok.vocab_size == jtok.vocab_size
    for text in TEXTS + ["[breath]x<|endofprompt|>y[laughter]", "[AA1][zh]"]:
        ids = tok.encode(text)
        assert ids == jtok.encode(text)
        assert tok.decode(ids) == text


def test_tokenizer_assets_load_the_bpe(tmp_path):
    """get_tokenizer on a model dir's tokenizer assets loads the Qwen BPE
    (its ids against transformers': tests/test_torch_bpe.py); a v1
    .tiktoken vocab loads the v1 tokenizer (its ids against the JAX one's:
    tests/test_torch_tiktoken.py; it once raised, naming ROADMAP A10)."""
    from tests.test_torch_bpe import write_tokenizer

    assert find_tokenizer_assets("") is None
    write_tokenizer(tmp_path / "CosyVoice-BlankEN", n_merges=20)
    path = find_tokenizer_assets(str(tmp_path))
    assert path == str(tmp_path / "CosyVoice-BlankEN")
    tok = get_tokenizer(path)
    assert type(tok).__name__ == "QwenTokenizer" and tok.decode(tok.encode("Hi [breath] there")) == "Hi  there"
    (tmp_path / "v1").mkdir()
    import base64

    (tmp_path / "v1" / "vocab.tiktoken").write_text("".join(f"{base64.b64encode(bytes([b])).decode()} {b}\n"
                                                             for b in range(256)))
    tok = get_tokenizer(find_tokenizer_assets(str(tmp_path / "v1")))
    assert type(tok).__name__ == "TiktokenBPE" and tok.encode("Hi<|endoftext|>") == [72, 105, 256]


def _signals(sr):
    rng = np.random.default_rng(0)
    for n in (sr // 2, sr + 77, 3 * sr // 2 + 1):  # the middle and last are not multiples of any hop
        t = np.arange(n) / sr
        chirp = 0.5 * np.sin(2 * np.pi * (100 + 3000 * t) * t)
        yield f"noise{n}", (rng.standard_normal(n) * 0.1).astype(np.float32)
        yield f"chirp{n}", chirp.astype(np.float32)


def _hold(fn, jfn, sr):
    """fn (the port's op) against jfn (the JAX op) in float64 on every signal
    and in float32 on the noise, atol LOG_ATOL."""
    for name, x in _signals(sr):
        for dtype in (np.float64, np.float32) if name.startswith("noise") else (np.float64,):
            with jax.enable_x64(dtype == np.float64):
                want = np.asarray(jfn(jnp.asarray(x.astype(dtype))))
            got = fn(torch.tensor(x.astype(dtype))).numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, name
            np.testing.assert_allclose(got, want, rtol=0, atol=LOG_ATOL, err_msg=f"{name} {dtype.__name__}")


def test_mel_spectrogram_matches_jax():
    _hold(lambda x: mel.mel_spectrogram(x[None]), lambda x: jmel.mel_spectrogram(x[None]), 24000)


def test_whisper_log_mel_matches_jax():
    _hold(lambda x: mel.whisper_log_mel(x[None]), lambda x: jmel.whisper_log_mel(x[None]), 16000)


@pytest.mark.parametrize("cmn", [True, False])
def test_kaldi_fbank_matches_jax(cmn):
    _hold(lambda x: mel.kaldi_fbank(x, cmn=cmn), lambda x: jmel.kaldi_fbank(x, cmn=cmn), 16000)


@pytest.mark.parametrize("sr_in,sr_out", [(16000, 24000), (24000, 16000), (22050, 16000)])
def test_resample_poly_matches_scipy(sr_in, sr_out):
    from fractions import Fraction

    frac = Fraction(sr_out, sr_in)
    rng = np.random.default_rng(1)
    for n in (sr_in, sr_in + 13, 257):
        x = rng.uniform(-1, 1, n).astype(np.float32)
        want = scipy.signal.resample_poly(x, frac.numerator, frac.denominator)
        got = resample_poly(torch.tensor(x), frac.numerator, frac.denominator).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= RESAMPLE_ATOL


@pytest.mark.parametrize("sr_file,target", [(16000, 16000), (24000, 16000), (16000, 24000)])
def test_wav_round_trip_matches_jax(tmp_path, sr_file, target):
    x = (np.random.default_rng(2).uniform(-0.9, 0.9, sr_file // 2)).astype(np.float32)
    path, jpath = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    audio_io.save_wav(path, x[None], sr_file)
    jaudio.save_wav(jpath, x[None], sr_file)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got, want = audio_io.load_wav(path, target), jaudio.load_wav(jpath, target)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=RESAMPLE_ATOL)
    if sr_file == target:
        # 16-bit rounding (half a step) and the save/load scales (32767 vs 32768)
        np.testing.assert_allclose(got[0], x, rtol=0, atol=2 / 32767)
