"""The port's Qwen2 byte-level BPE (frontend/bpe.py, frontend/tokenizer.py)
against the JAX package's QwenTokenizer (`transformers` over the same
assets), on a synthetic Qwen2-structured tokenizer built here with
`tokenizers`: the NFC normaliser, the Qwen2 Split pre-tokenizer, ByteLevel,
a few hundred merges trained on a seeded corpus, and the Qwen2 added
tokens, saved as tokenizer.json and as vocab.json + merges.txt +
tokenizer_config.json. Ids must be equal, exactly, and so must the decoded
text, on fixed strings (contractions in upper case, Chinese, Japanese,
digits and vulgar fractions, combining marks and decomposed accents, runs
of spaces and newlines, tabs, U+001C, emoji, every CosyVoice special next
to text) and under hypothesis text."""

import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cosyvoice_tpu_torch.frontend.bpe import QWEN2_PATTERN, ByteLevelBPE, pretokenize
from cosyvoice_tpu_torch.frontend.tokenizer import V2_SPECIAL_TOKENS, V3_EXTRA_SPECIAL_TOKENS, get_tokenizer

QWEN2_ADDED = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
FORMS = ["tokenizer.json", "vocab.json+merges.txt"]


def _corpus(seed=0, n=3000):
    """Seeded pseudo-text: Latin syllables with case and apostrophes, CJK,
    kana, digits, accents and punctuation, so that merges cover each."""
    rng = np.random.default_rng(seed)
    pools = [["th", "e", "an", "re", "on", "in", "s", "'s", "'ll", "'T", "ing", "er", "HE", "Wor", "ld"],
             list("你好世界今天气很中文语音合成"), list("こんにちはカタカナひらがな"), list("0123456789½"),
             ["é", "è", "ü", "ñ", "é"], [" ", " ", " ", ",", ".", "!", "\n", "  "]]
    words = []
    for _ in range(n):
        pool = pools[rng.integers(len(pools))]
        words.append("".join(pool[rng.integers(len(pool))] for _ in range(rng.integers(1, 5))))
    return [" ".join(words[i : i + 30]) for i in range(0, n, 30)]


def write_tokenizer(root, n_merges=400, form="tokenizer.json", seed=0):
    """A Qwen2-structured byte-level BPE with `n_merges` merges trained on
    _corpus(seed) and the Qwen2 added tokens, written to `root` as
    tokenizer.json + tokenizer_config.json, or as vocab.json + merges.txt +
    tokenizer_config.json. Returns `root`."""
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(dropout=None, unk_token=None, continuing_subword_prefix="", end_of_word_suffix="",
                               fuse_unk=False, byte_fallback=False))
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=256 + n_merges, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  special_tokens=[], show_progress=False)
    tok.train_from_iterator(_corpus(seed), trainer)
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in QWEN2_ADDED])
    root = str(root)
    os.makedirs(root, exist_ok=True)
    spec = json.loads(tok.to_str())
    added = {str(t["id"]): {k: t[k] for k in ("content", "lstrip", "normalized", "rstrip", "single_word", "special")}
             for t in spec["added_tokens"]}
    config = {"tokenizer_class": "Qwen2Tokenizer", "added_tokens_decoder": added, "clean_up_tokenization_spaces": False,
              "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>", "unk_token": None, "bos_token": None,
              "errors": "replace", "split_special_tokens": False, "model_max_length": 32768}
    with open(os.path.join(root, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    if form == "tokenizer.json":
        tok.save(os.path.join(root, "tokenizer.json"))
    else:
        with open(os.path.join(root, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(spec["model"]["vocab"], f, ensure_ascii=False)
        with open(os.path.join(root, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for m in spec["model"]["merges"]:
                f.write((m if isinstance(m, str) else " ".join(m)) + "\n")
    return root


FIXED = [
    "Hello world, it's a test. I'M HERE; WE'LL SEE what THEY'VE done, DON'T they'D? 'ſ",
    "你好，世界。今天天气很好，我们去公园吧！",
    "こんにちは世界、カタカナとひらがなの混ざった文。",
    "Numbers 12345, 3.14 and ½ ⅔ ² ⁴ Ⅻ ٣",
    "café naïve résumé vs café naïve á̖ ́x",
    "  two  spaces,   three\n\nnew lines\r\n\r\n ending   ",
    "tabs\tand\t\tmore\t",
    "a\x1cb\x1d c \x1e\x1f d",
    "emoji 😀👍🏽 🇨🇳 ok!!",
    " nbsp　ideographic em\u0085nel ls",
    "",
    " ",
    "\n",
    "x  ",
    "''s 's",
] + [f"text{t}more {t} x{t}" for t in V2_SPECIAL_TOKENS] + ["".join(V2_SPECIAL_TOKENS), "[breath][breath]<|endoftext|>"]


@pytest.fixture(scope="module", params=FORMS)
def pair(request, tmp_path_factory):
    """(the JAX package's QwenTokenizer, the port's) over one asset form."""
    from cosyvoice_tpu.frontend.tokenizer import get_tokenizer as jget

    root = write_tokenizer(tmp_path_factory.mktemp("tok"), form=request.param)
    jtok = jget(root)
    assert type(jtok).__name__ == "QwenTokenizer", "the JAX package fell back to byte ids"
    return jtok, get_tokenizer(root)


def test_synthetic_tokenizer_is_qwen2_shaped(pair):
    jtok, tok = pair
    assert tok.vocab_size == jtok.vocab_size == len(jtok.tokenizer)
    assert len(tok.tokenizer.ranks) >= 300  # a few hundred merges
    # the CosyVoice specials take the ids add_special_tokens gives them; the
    # Qwen2 ones that already exist keep theirs
    for t in V2_SPECIAL_TOKENS + list(QWEN2_ADDED):
        assert tok.encode(t) == jtok.encode(t) == [jtok.tokenizer.convert_tokens_to_ids(t)]


@pytest.mark.parametrize("i", range(len(FIXED)))
def test_ids_and_decode_match_transformers_on_fixed_strings(pair, i):
    jtok, tok = pair
    text = FIXED[i]
    ids = tok.encode(text)
    assert ids == jtok.encode(text), repr(text)
    assert tok.decode(ids) == jtok.decode(ids), repr(text)
    assert len(ids) <= max(len(text.encode("utf-8")), 0) + 1


TEXT = st.lists(st.one_of(st.characters(), st.sampled_from(list("aZsStT'\n\r\t \x1ć½😀你") + V2_SPECIAL_TOKENS)),
                max_size=40).map("".join)


@settings(max_examples=200, deadline=None)
@given(text=TEXT)
def test_ids_and_decode_match_transformers_under_hypothesis(pair, text):
    jtok, tok = pair
    try:
        want = jtok.encode(text)
    except TypeError:
        # the tokenizers library refuses text with a lone surrogate; so does the port
        assert any(0xD800 <= ord(ch) <= 0xDFFF for ch in text), repr(text)
        with pytest.raises(ValueError, match="lone surrogate"):
            tok.encode(text)
        return
    ids = tok.encode(text)
    assert ids == want
    assert tok.decode(ids) == jtok.decode(ids)


@pytest.mark.parametrize("text", ["\ud800", "a\udfffb", "x\ud83d"])
def test_lone_surrogate_is_refused_as_transformers_does(pair, text):
    jtok, tok = pair
    with pytest.raises(TypeError):
        jtok.encode(text)
    with pytest.raises(ValueError, match="lone surrogate"):
        tok.encode(text)


def test_pretokenizer_matches_the_qwen2_regex():
    """The scanner against the pattern itself through `regex` (which the
    port does not import), on the fixed strings."""
    import regex

    pat = regex.compile(QWEN2_PATTERN)
    for text in FIXED:
        assert pretokenize(text) == pat.findall(text), repr(text)


def test_merges_by_rank_and_ignore_merges():
    """Ranks over a hand-made vocab, against the tokenizers BPE model on
    each word: the lowest rank first, the leftmost of equal pairs first, a
    queued pair that a merge beside it changed skipped; with ignore_merges
    a whole pre-token in the vocab is one id even where the merges would
    not build it."""
    from tokenizers import models

    from cosyvoice_tpu_torch.frontend.bpe import bytes_to_unicode

    base = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    vocab = dict(base, aa=256, aaa=257, ab=258, aab=259, xyz=260, ba=261, bab=262)
    merges = [("a", "b"), ("a", "a"), ("aa", "a"), ("a", "ab"), ("b", "a"), ("ba", "b")]
    for ignore in (False, True):
        bpe = ByteLevelBPE(vocab, merges, ignore_merges=ignore)
        ref = models.BPE(vocab, merges, ignore_merges=ignore)
        for word in ("aab", "aaaa", "aaa", "abab", "babab", "aabaa", "xyz", "bbbaaab"):
            assert bpe.encode(word) == [t.id for t in ref.tokenize(word)], (word, ignore)
    assert ByteLevelBPE(vocab, merges).encode("aaaa") == [256, 256]
    assert ByteLevelBPE(vocab, merges, ignore_merges=True).encode("xyz") == [260]


def test_added_tokens_match_leftmost_longest():
    from cosyvoice_tpu_torch.frontend.bpe import AddedToken, bytes_to_unicode

    base = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    bpe = ByteLevelBPE(base, [], [(AddedToken("<a>"), 300), (AddedToken("<a><b>"), 301), (AddedToken("b>"), 302)])
    assert bpe.encode("x<a><b>") == [base["x"], 301]
    assert bpe.encode("<a>b>") == [300, 302]
    assert bpe.add_special_tokens(["<a>", "new", "x"]) == 2
    assert bpe.encode("new") == [303] and bpe.encode("x") == [base["x"]] and len(bpe) == 256 + 4


def test_v3_specials_and_non_qwen_assets(tmp_path):
    """version 3 adds the v3 inventory after the v2 one, as the JAX
    QwenTokenizer does; a tokenizer.json that is not Qwen2's, a normalized
    added token and clean_up_tokenization_spaces raise rather than
    tokenise differently."""
    from cosyvoice_tpu.frontend.tokenizer import get_tokenizer as jget

    root = write_tokenizer(tmp_path / "v3", n_merges=50)
    tok, jtok = get_tokenizer(root, version=3), jget(root, version=3)
    assert tok.vocab_size == jtok.vocab_size
    text = "[AA1]hi[ià]" + V3_EXTRA_SPECIAL_TOKENS[-1] + "<|endofsystem|>"
    assert tok.encode(text) == jtok.encode(text)
    path = tmp_path / "v3" / "tokenizer.json"
    spec = json.loads(path.read_text())
    for edit, match in ((lambda sp: sp.update(normalizer={"type": "NFKC"}), "Qwen2"),
                        (lambda sp: sp["added_tokens"][0].update(normalized=True), "normalized")):
        changed = json.loads(json.dumps(spec))
        edit(changed)
        path.write_text(json.dumps(changed))
        with pytest.raises(NotImplementedError, match=match):
            get_tokenizer(root)
    path.write_text(json.dumps(spec))
    config = json.loads((tmp_path / "v3" / "tokenizer_config.json").read_text())
    (tmp_path / "v3" / "tokenizer_config.json").write_text(json.dumps({**config, "clean_up_tokenization_spaces": True}))
    with pytest.raises(NotImplementedError, match="clean_up"):
        get_tokenizer(root)
