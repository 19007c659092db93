"""The port's CosyVoice-300M (v1) tokenizer (frontend/tiktoken_bpe.py) against
the JAX package's, CPU: `get_tokenizer` on a `.tiktoken` vocab written by the
test (256 byte tokens and several hundred merges of English, Chinese,
Japanese and digit words, in a shuffled rank order, as
tests/test_native_bpe.py builds a smaller one) gives the ids of the JAX
`get_tokenizer` (NativeBPETokenizer over csrc/bpe_tokenizer.cc, the whisper
pattern compiled by `regex`) on fixed and hypothesis texts, special tokens
included; decode inverts encode. The hand-written whisper pre-tokenizer
splits hypothesis strings as `regex.findall(WHISPER_PAT_STR, ...)` does."""

import base64

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cosyvoice_tpu.frontend import tokenizer as jtok
from cosyvoice_tpu_torch.frontend import tokenizer as ttok
from cosyvoice_tpu_torch.frontend.tiktoken_bpe import TiktokenBPE, whisper_pretokenize

WORDS = ("hello world the quick brown fox jumps over lazy dog it's we're they'll don't 2024 12345 3.14 "
         "你好 世界 今天 天气 不错 出去 走走 日本語 テスト こんにちは 東京 ok OK Hello Hi").split()
SAMPLES = [
    "Hello, world! It's 2024.",
    "你好，世界。今天天气不错，想出去走走。",
    "日本語のテストです。こんにちは!",
    "the quick  brown fox\n\njumps   over the lazy dog's back 12345",
    "<|en|>hello<|endoftext|> world<|TTS/SP01|>",
    "  leading and trailing spaces  ",
    "tabs\tand\r\nnewlines\n",
    "they'll WE'RE don't 3.14x",
]


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    rng = np.random.default_rng(0)
    pieces = set()
    for w in WORDS:
        for prefix in ("", " "):
            raw = (prefix + w).encode("utf-8")
            pieces.update(raw[:k] for k in range(2, len(raw) + 1))
    merges = sorted(pieces)
    order = rng.permutation(len(merges))
    lines = [f"{base64.b64encode(bytes([b])).decode()} {b}" for b in range(256)]
    lines += [f"{base64.b64encode(merges[i]).decode()} {256 + r}" for r, i in enumerate(order)]
    path = tmp_path_factory.mktemp("v1") / "vocab.tiktoken"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def pair(vocab_path):
    return jtok.get_tokenizer(vocab_path, version=1), ttok.get_tokenizer(vocab_path, version=1)


def test_constants_match_jax():
    assert ttok.whisper_v1_specials() == jtok.whisper_v1_specials()
    assert ttok.WHISPER_PAT_STR == jtok.WHISPER_PAT_STR
    assert len(ttok.whisper_v1_specials()) == len(set(ttok.whisper_v1_specials()))


@pytest.mark.parametrize("text", SAMPLES)
def test_encode_matches_jax(pair, text):
    want, got = pair
    assert isinstance(got, TiktokenBPE)
    ids = got.encode(text)
    assert ids == want.encode(text)
    assert got.decode(ids) == want.decode(ids) == text


def test_vocab_size_and_special_ids_match_jax(pair, vocab_path):
    want, got = pair
    assert got.vocab_size == want.vocab_size
    n_lines = sum(1 for _ in open(vocab_path, "rb"))
    assert got.encode("<|endoftext|>") == [n_lines] and got.encode("<|en|>") == [n_lines + 2]


def test_a_byte_missing_from_the_vocab_raises(tmp_path):
    path = tmp_path / "small.tiktoken"
    path.write_text("".join(f"{base64.b64encode(bytes([b])).decode()} {b}\n" for b in range(128)))
    tok = ttok.get_tokenizer(str(path))
    assert tok.encode("ab") == [97, 98]
    with pytest.raises(ValueError, match="not in the vocab"):
        tok.encode("é")


_TEXT = st.text(alphabet=st.sampled_from(list("ab xyz'sltdrevm09 \t\n\r.,!?-你好日本語テスト٣²Ⅷ  ́\u001c\x85")),
                max_size=40)


@settings(max_examples=300, deadline=None)
@given(_TEXT)
def test_pretokenizer_matches_regex(text):
    regex = pytest.importorskip("regex")
    assert whisper_pretokenize(text) == regex.findall(ttok.WHISPER_PAT_STR, text)


@settings(max_examples=100, deadline=None)
@given(st.text(st.characters(exclude_categories=("Cn", "Cs")), max_size=30))
def test_pretokenizer_matches_regex_on_any_text(text):
    """Any assigned character: the port classes characters by Python's
    unicodedata, `regex` by its own (newer) tables, so a character assigned
    after Python's Unicode version may split otherwise (ROADMAP C4)."""
    regex = pytest.importorskip("regex")
    assert whisper_pretokenize(text) == regex.findall(ttok.WHISPER_PAT_STR, text)


@settings(max_examples=100, deadline=None)
@given(_TEXT)
def test_encode_matches_jax_on_hypothesis_text(pair, text):
    want, got = pair
    assert got.encode(text) == want.encode(text)
