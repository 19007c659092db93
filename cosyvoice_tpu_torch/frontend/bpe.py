"""The Qwen2 byte-level BPE tokenizer on the host, in pure Python.

Gives the ids of the JAX package's `QwenTokenizer`
(cosyvoice_tpu/frontend/tokenizer.py: `transformers.AutoTokenizer` over a
Qwen2 tokenizer dir, plus `add_special_tokens`), without `transformers`,
`tokenizers` or `regex`:

1. added tokens are split out of the raw text first, leftmost-longest;
2. each remaining piece goes through the NFC normaliser, then the Qwen2
   pre-tokenizer (QWEN2_PATTERN), here a scanner over
   `unicodedata.category`: \\p{L} is Lu, Ll, Lt, Lm and Lo (so a combining
   mark splits a word), \\p{N} is Nd, Nl and No, one character per match,
   \\s is Unicode White_Space (not `str.isspace`, which also takes
   U+001C..U+001F), and the contractions match case-insensitively;
3. each pre-token's UTF-8 bytes go through the GPT-2 byte -> unicode map
   and are merged by rank: the lowest-ranked adjacent pair first, the
   leftmost of equal pairs first, as the `tokenizers` BPE model does (a
   whole pre-token that is a vocab entry is taken as it is where the model
   sets `ignore_merges`);
4. `decode` drops special added tokens (skip_special_tokens), maps the
   characters back to bytes and decodes UTF-8 with replacement.

The assets are `tokenizer.json`, or `vocab.json` + `merges.txt` +
`tokenizer_config.json`'s `added_tokens_decoder` (the slow tokenizer's
files, which `transformers` converts to the same fast tokenizer).
`add_special_tokens` gives a token that is already in the vocab or the
added tokens its id, and each new one the next id. A tokenizer whose
normaliser, pre-tokenizer, model or decoder is not Qwen2's raises
NotImplementedError rather than tokenise differently, as do added tokens
that are normalized or strip or match single words, and
`clean_up_tokenization_spaces` set (no Qwen2 asset has them). Each
pre-token's ids are cached, which is enough at TTS text lengths.
"""

import json
import os
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
    r"\s+(?!\S)|\s+"
)
# Unicode White_Space: what \s matches in the pattern
WHITE_SPACE = frozenset([chr(c) for c in (*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                                           0x2028, 0x2029, 0x202F, 0x205F, 0x3000)])
_LETTER = frozenset(("Lu", "Ll", "Lt", "Lm", "Lo"))
_NUMBER = frozenset(("Nd", "Nl", "No"))
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")  # after an apostrophe, in the pattern's order


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map of the ByteLevel steps."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_CHAR = bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


def _letter(ch: str) -> bool:
    return unicodedata.category(ch) in _LETTER


def _number(ch: str) -> bool:
    return unicodedata.category(ch) in _NUMBER


def _other(ch: str) -> bool:
    return not (ch in WHITE_SPACE or _letter(ch) or _number(ch))


def _casefold_eq(seg: str, want: str) -> bool:
    # (?i) with Unicode case folding: U+017F (long s) folds to "s" too
    return seg.lower().replace("ſ", "s") == want


def _match_end(text: str, i: int) -> int:
    """End of the pattern's match at position i: its alternatives tried in
    order, each with the backtracking a regex engine would do."""
    n, c = len(text), text[i]
    if c == "'":
        for suffix in _CONTRACTIONS:
            seg = text[i + 1 : i + 1 + len(suffix)]
            if len(seg) == len(suffix) and _casefold_eq(seg, suffix):
                return i + 1 + len(suffix)
    # [^\r\n\p{L}\p{N}]?\p{L}+
    start = None
    if _letter(c):
        start = i
    elif c not in "\r\n" and not _number(c) and i + 1 < n and _letter(text[i + 1]):
        start = i + 1
    if start is not None:
        k = start
        while k < n and _letter(text[k]):
            k += 1
        return k
    # \p{N}
    if _number(c):
        return i + 1
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    start = i + 1 if c == " " and i + 1 < n and _other(text[i + 1]) else (i if _other(c) else None)
    if start is not None:
        k = start
        while k < n and _other(text[k]):
            k += 1
        while k < n and text[k] in "\r\n":
            k += 1
        return k
    # c is whitespace: \s*[\r\n]+ | \s+(?!\S) | \s+
    e = i
    while e < n and text[e] in WHITE_SPACE:
        e += 1
    for q in range(e - 1, i - 1, -1):
        if text[q] in "\r\n":
            return q + 1
    if e == n or e - i < 2:
        return e
    return e - 1


def pretokenize(text: str) -> List[str]:
    """The pieces QWEN2_PATTERN splits `text` into (isolated matches; the
    pattern matches at every position, so there are no gaps)."""
    out, i = [], 0
    while i < len(text):
        j = _match_end(text, i)
        out.append(text[i:j])
        i = j
    return out


@dataclass(frozen=True)
class AddedToken:
    content: str
    special: bool = True


def _index(tokens: Dict[str, int]):
    """{first character: (tokens starting with it, longest first)}, and the ids."""
    first = {}
    for t in sorted(tokens, key=len, reverse=True):
        first.setdefault(t[0], []).append(t)
    return first, tokens


def _split_added(text: str, index) -> List[Tuple[str, Optional[int]]]:
    """`text` split into [(piece, None)] and [(token, id)] at the added
    tokens of `index` (from _index), leftmost-longest."""
    first, tokens = index
    out, pos, gap = [], 0, 0
    if not tokens:
        return [(text, None)] if text else []
    while pos < len(text):
        hit = next((t for t in first.get(text[pos], ()) if text.startswith(t, pos)), None)
        if hit is None:
            pos += 1
            continue
        if gap < pos:
            out.append((text[gap:pos], None))
        out.append((hit, tokens[hit]))
        pos = gap = pos + len(hit)
    if gap < len(text):
        out.append((text[gap:], None))
    return out


class ByteLevelBPE:
    """The Qwen2 byte-level BPE over `vocab` (token -> id), `merges` (pairs
    in rank order) and `added` tokens with their ids (see the module
    docstring)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 added: Sequence[Tuple[AddedToken, int]] = (), ignore_merges: bool = False):
        self.vocab = dict(vocab)
        self.ignore_merges = ignore_merges
        self.ranks = {}
        for rank, (a, b) in enumerate(merges):
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                raise ValueError(f"merge {a!r} {b!r}: a part or the merged token is not in the vocab")
            self.ranks[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        missing = [c for c in _BYTE_CHAR.values() if c not in self.vocab]
        if missing:
            raise ValueError(f"not a byte-level vocab: {len(missing)} of the 256 byte characters are missing")
        self.added: Dict[int, AddedToken] = {}
        self._index = _index({})
        for token, i in added:
            self._set_added(token, i)
        self._cache: Dict[str, List[int]] = {}

    def _set_added(self, token: AddedToken, i: int):
        self.added[i] = token
        self.id_to_token[i] = token.content
        self._index = _index({t.content: i for i, t in self.added.items()})

    # ---------------- assets ----------------
    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPE":
        """From tokenizer.json, else vocab.json + merges.txt +
        tokenizer_config.json's added_tokens_decoder."""
        config = {}
        if os.path.exists(os.path.join(path, "tokenizer_config.json")):
            with open(os.path.join(path, "tokenizer_config.json"), encoding="utf-8") as f:
                config = json.load(f)
        if config.get("clean_up_tokenization_spaces"):
            raise NotImplementedError("clean_up_tokenization_spaces is not ported (no Qwen2 asset sets it)")
        if os.path.exists(os.path.join(path, "tokenizer.json")):
            with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
                spec = json.load(f)
            model = _check_spec(spec)
            merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
            added = [(_added(t), t["id"]) for t in spec.get("added_tokens", [])]
            return cls(model["vocab"], merges, added, bool(model.get("ignore_merges", False)))
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if (i == 0 and line.startswith("#version:")) or not line:
                    continue
                merges.append(tuple(line.split()))
        added = [(_added(t), int(i)) for i, t in config.get("added_tokens_decoder", {}).items()]
        return cls(vocab, merges, sorted(added, key=lambda a: a[1]))

    def add_special_tokens(self, tokens: Sequence[str]) -> int:
        """Add special tokens as transformers' add_special_tokens does: one
        already added or in the vocab keeps its id, each new one takes the
        next id. Returns the number added."""
        n = 0
        for content in tokens:
            if not content or content in self._index[1]:
                continue
            if content in self.vocab:
                i = self.vocab[content]
            elif self.added and max(self.added) >= len(self.vocab):
                i = max(self.added) + 1
            else:
                i = len(self.vocab)
            self._set_added(AddedToken(content, special=True), i)
            n += 1
        return n

    def __len__(self) -> int:
        return len(set(self.vocab.values()) | set(self.added))

    # ---------------- encode / decode ----------------
    def _bpe(self, piece: str) -> List[int]:
        ids = self._cache.get(piece)
        if ids is not None:
            return ids
        chars = "".join(_BYTE_CHAR[b] for b in piece.encode("utf-8"))
        if self.ignore_merges and chars in self.vocab:
            ids = [self.vocab[chars]]
        else:
            ids = self._merge([self.vocab[c] for c in chars])
        self._cache[piece] = ids
        return ids

    def _merge(self, syms: List[int]) -> List[int]:
        """Merge by rank, as the tokenizers BPE model's `merge_all`: a queue
        of (rank, position); an entry whose pair has changed since it was
        queued is skipped."""
        import heapq

        n = len(syms)
        nxt, prv = list(range(1, n + 1)), list(range(-1, n - 1))
        alive = [True] * n
        heap = [(r[0], p, r[1]) for p in range(n - 1) if (r := self.ranks.get((syms[p], syms[p + 1])))]
        heapq.heapify(heap)
        while heap:
            _, p, new = heapq.heappop(heap)
            if not alive[p] or nxt[p] >= n:
                continue
            q = nxt[p]
            r = self.ranks.get((syms[p], syms[q]))
            if r is None or r[1] != new:
                continue
            syms[p], alive[q] = new, False
            nxt[p] = nxt[q]
            if nxt[q] < n:
                prv[nxt[q]] = p
            if prv[p] >= 0 and (r := self.ranks.get((syms[prv[p]], new))):
                heapq.heappush(heap, (r[0], prv[p], r[1]))
            if nxt[p] < n and (r := self.ranks.get((new, syms[nxt[p]]))):
                heapq.heappush(heap, (r[0], p, r[1]))
        return [s for s, a in zip(syms, alive) if a]

    def encode(self, text: str) -> List[int]:
        """Ids of `text`; ValueError for text that UTF-8 cannot encode (a
        lone surrogate), which the tokenizers library refuses too."""
        try:
            text.encode("utf-8")
        except UnicodeEncodeError as e:
            raise ValueError(f"text is not valid Unicode: lone surrogate at position {e.start}") from e
        ids: List[int] = []
        for piece, i in _split_added(text, self._index):
            if i is not None:
                ids.append(i)
                continue
            for pre in pretokenize(unicodedata.normalize("NFC", piece)):
                ids.extend(self._bpe(pre))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i in self.added and skip_special_tokens and self.added[i].special:
                continue
            token = self.id_to_token.get(i)
            if token is None:
                continue
            if all(c in _CHAR_BYTE for c in token):
                out.extend(_CHAR_BYTE[c] for c in token)
            else:
                out.extend(token.encode("utf-8"))
        return out.decode("utf-8", errors="replace")


def _added(t: dict) -> AddedToken:
    """An added token of the assets, matched on the raw text: one that is
    normalized, strips or matches single words raises."""
    if t.get("normalized", not t.get("special", False)) or t.get("lstrip") or t.get("rstrip") or t.get("single_word"):
        raise NotImplementedError(f"added token {t.get('content')!r}: normalized / lstrip / rstrip / single_word "
                                  "added tokens are not ported")
    return AddedToken(t["content"], bool(t.get("special", False)))


def _check_spec(spec: dict) -> dict:
    """The BPE model of a tokenizer.json whose steps are Qwen2's; raises
    NotImplementedError for any other step."""
    model, pre, norm, dec = spec.get("model", {}), spec.get("pre_tokenizer") or {}, spec.get("normalizer"), spec.get(
        "decoder") or {}
    steps = pre.get("pretokenizers", [])
    split_ok = (pre.get("type") == "Sequence" and len(steps) == 2 and steps[0].get("type") == "Split"
                and steps[0].get("pattern", {}).get("Regex") == QWEN2_PATTERN
                and steps[0].get("behavior") == "Isolated" and not steps[0].get("invert")
                and steps[1].get("type") == "ByteLevel" and not steps[1].get("add_prefix_space")
                and not steps[1].get("use_regex", True))
    plain_bpe = (model.get("type") == "BPE" and model.get("dropout") is None and not model.get("byte_fallback")
                 and not model.get("continuing_subword_prefix") and not model.get("end_of_word_suffix"))
    if not (split_ok and plain_bpe and (norm or {}).get("type") == "NFC" and dec.get("type") == "ByteLevel"):
        raise NotImplementedError("tokenizer.json is not a Qwen2 byte-level BPE (NFC, the Qwen2 Split pattern + "
                                  "ByteLevel, a plain BPE model, the ByteLevel decoder)")
    return model
