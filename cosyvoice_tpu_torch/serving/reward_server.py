"""The GRPO reward server's scoring functions: Levenshtein distance and the
character error rate.

Counterpart of the scoring half of cosyvoice_tpu/serving/reward_server.py
(`edit_distance`, `cer`), which tools/eval_quality.py uses. The server
itself (token2wav + a pluggable ASR behind a KServe v2 endpoint, for GRPO
training) is not ported yet: it comes with GRPO (ROADMAP A11c).
"""

import re


def edit_distance(a, b) -> int:
    """Levenshtein distance between two sequences."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _normalize(s: str) -> str:
    return re.sub(r"[\s\W]+", "", s.lower())


def cer(hyp: str, ref: str) -> float:
    """Character error rate of `hyp` against `ref`, lower-cased, whitespace
    and punctuation removed (a plain character CER, not the reference's
    pinyin CER). An empty reference scores 0 against an empty hypothesis,
    else 1."""
    h, r = _normalize(hyp), _normalize(ref)
    if not r:
        return 0.0 if not h else 1.0
    return edit_distance(h, r) / len(r)
