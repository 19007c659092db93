"""The CosyVoice-300M (v1) tokenizer on the host, in pure Python: rank-merge
byte-level BPE over a tiktoken vocab file.

Gives the ids of the JAX package's v1 tokenizer
(cosyvoice_tpu/frontend/native_bpe.py:NativeBPETokenizer over
csrc/bpe_tokenizer.cc, built by frontend/tokenizer.py:get_tokenizer), with
no compiler and without the `regex` module:

1. special tokens are split out of the text first, longest match first;
2. each remaining span is cut into pieces by the whisper pre-tokenizer
   (WHISPER_PAT_STR, here a scanner over `unicodedata.category`, beside
   frontend/bpe.py's scanner for the Qwen pattern): the case-sensitive
   contractions, then an optional space before a run of letters (\\p{L}),
   of numbers (\\p{N}) or of other characters, then whitespace runs, the
   last whitespace character left to the next piece when a non-space
   follows;
3. each piece's UTF-8 bytes start as single-byte parts, and the adjacent
   pair whose concatenation has the lowest rank is merged until no
   concatenation is in the vocab (the leftmost of equal ranks first); each
   part's rank is its id.

The vocab file holds one "<base64 token> <rank>" per line. The special
tokens' ids follow the file's line count (get_tokenizer's rule). `decode`
joins the tokens' bytes, the special tokens as text, and decodes UTF-8 with
replacement.
"""

import base64
import re
import unicodedata
from typing import Dict, List, Optional, Sequence

from cosyvoice_tpu_torch.frontend.bpe import WHITE_SPACE

WHISPER_PAT_STR = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""

_LETTER = frozenset(("Lu", "Ll", "Lt", "Lm", "Lo"))
_NUMBER = frozenset(("Nd", "Nl", "No"))
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")  # after an apostrophe, in the pattern's order


def _class(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    if ch in WHITE_SPACE:
        return "S"
    cat = unicodedata.category(ch)
    return "L" if cat in _LETTER else "N" if cat in _NUMBER else "O"


def _match_end(text: str, cls: str, i: int) -> int:
    """End of WHISPER_PAT_STR's match at position i (`cls` the classes of
    `text`): its alternatives in order, with a regex engine's backtracking."""
    n = len(text)
    if text[i] == "'":
        for suffix in _CONTRACTIONS:
            if text.startswith(suffix, i + 1):
                return i + 1 + len(suffix)
    # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+'
    for want in "LNO":
        start = i + 1 if text[i] == " " and i + 1 < n and cls[i + 1] == want else (i if cls[i] == want else None)
        if start is not None:
            k = start
            while k < n and cls[k] == want:
                k += 1
            return k
    # text[i] is whitespace: '\s+(?!\S)' backs off one character before a
    # non-space, '\s+' takes a lone one
    e = i
    while e < n and cls[e] == "S":
        e += 1
    return e if e == n or e - i < 2 else e - 1


def whisper_pretokenize(text: str) -> List[str]:
    """The pieces WHISPER_PAT_STR splits `text` into (the pattern matches at
    every position, so the pieces cover the text)."""
    cls = "".join(_class(ch) for ch in text)
    out, i = [], 0
    while i < len(text):
        j = _match_end(text, cls, i)
        out.append(text[i:j])
        i = j
    return out


def read_tiktoken(path: str) -> Dict[bytes, int]:
    """{token bytes: rank} of a tiktoken vocab file; blank or malformed
    lines are skipped."""
    ranks = {}
    with open(path, "rb") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                ranks[base64.b64decode(parts[0])] = int(parts[1])
    return ranks


def count_lines(path: str) -> int:
    with open(path, "rb") as f:
        return sum(1 for _ in f)


class TiktokenBPE:
    """Rank-merge BPE over `ranks` ({token bytes: rank = id}), with
    `special_tokens` ({text: id}) split out first."""

    def __init__(self, ranks: Dict[bytes, int], special_tokens: Optional[Dict[str, int]] = None):
        self.ranks = dict(ranks)
        self.n_vocab = max(self.ranks.values(), default=-1) + 1
        self.id_to_bytes = {i: b for b, i in self.ranks.items()}
        self.special_tokens = dict(special_tokens or {})
        self._special_re = (
            re.compile("|".join(re.escape(t) for t in sorted(self.special_tokens, key=len, reverse=True)))
            if self.special_tokens else None
        )

    @classmethod
    def from_file(cls, path: str, special_tokens: Sequence[str] = ()) -> "TiktokenBPE":
        """The vocab of `path`, the special tokens numbered after its lines."""
        base = count_lines(path)
        return cls(read_tiktoken(path), {t: base + i for i, t in enumerate(special_tokens)})

    @property
    def vocab_size(self) -> int:
        return self.n_vocab + len(self.special_tokens)

    def _merge(self, raw: bytes) -> List[int]:
        parts = [raw[i : i + 1] for i in range(len(raw))]
        ranks = self.ranks
        while len(parts) > 1:
            best, best_i = None, -1
            for i in range(len(parts) - 1):
                r = ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best is None or r < best):
                    best, best_i = r, i
            if best_i < 0:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        try:
            return [ranks[p] for p in parts]
        except KeyError as e:
            raise ValueError(f"byte {e.args[0]!r} is not in the vocab") from None

    def _encode_span(self, text: str) -> List[int]:
        out: List[int] = []
        for piece in whisper_pretokenize(text):
            out.extend(self._merge(piece.encode("utf-8")))
        return out

    def encode(self, text: str, allowed_special: str = "all") -> List[int]:
        if self._special_re is None:
            return self._encode_span(text)
        out: List[int] = []
        pos = 0
        for m in self._special_re.finditer(text):
            out.extend(self._encode_span(text[pos : m.start()]))
            out.append(self.special_tokens[m.group(0)])
            pos = m.end()
        out.extend(self._encode_span(text[pos:]))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        rev = {v: k for k, v in self.special_tokens.items()}
        out, span = [], []
        for i in ids:
            if i in rev:
                out.append(b"".join(span).decode("utf-8", errors="replace"))
                out.append(rev[i])
                span = []
            else:
                if i not in self.id_to_bytes:
                    raise ValueError(f"id {i} is not in the vocab")
                span.append(self.id_to_bytes[i])
        out.append(b"".join(span).decode("utf-8", errors="replace"))
        return "".join(out)
