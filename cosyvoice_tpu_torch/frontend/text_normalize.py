"""Text normalization utilities (host-side, pure Python).

A copy of cosyvoice_tpu/frontend/text_normalize.py (the port imports
nothing of the JAX package).

Behavioral port of cosyvoice/utils/frontend_utils.py + the regex fallback
chain of cli/frontend.py:127-160 (the ttsfrd/wetext external normalizers are
optional in the reference; this module implements the always-available regex
path plus a self-contained English number speller replacing `inflect`).
"""

import re
import unicodedata
from typing import Callable, List

_CHINESE_RE = re.compile(r"[一-鿿]+")


def contains_chinese(text: str) -> bool:
    return bool(_CHINESE_RE.search(text))


def replace_corner_mark(text: str) -> str:
    return text.replace("²", "平方").replace("³", "立方")


def remove_bracket(text: str) -> str:
    for ch in ("（", "）", "【", "】", "`"):
        text = text.replace(ch, "")
    return text.replace("——", " ")


def replace_blank(text: str) -> str:
    """Remove spaces between non-ascii (CJK) characters."""
    out = []
    for i, c in enumerate(text):
        if c == " ":
            prev_ok = i > 0 and text[i - 1].isascii() and text[i - 1] != " "
            next_ok = i + 1 < len(text) and text[i + 1].isascii() and text[i + 1] != " "
            if prev_ok and next_ok:
                out.append(c)
        else:
            out.append(c)
    return "".join(out)


_ONES = "zero one two three four five six seven eight nine ten eleven twelve thirteen fourteen fifteen sixteen seventeen eighteen nineteen".split()
_TENS = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()
_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"), (100, "hundred")]


def number_to_words(num_str: str) -> str:
    """English spelling of a non-negative integer string (inflect-style with
    'and', e.g. 123 -> 'one hundred and twenty-three')."""
    n = int(num_str)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] + ("-" + _ONES[ones] if ones else "")
    for scale, name in _SCALES:
        if n >= scale:
            head = number_to_words(str(n // scale)) + " " + name
            rest = n % scale
            if rest == 0:
                return head
            joiner = " and " if rest < 100 else " "
            return head + joiner + number_to_words(str(rest))
    return _ONES[0]


def spell_out_number(text: str) -> str:
    out, st = [], None
    for i, c in enumerate(text):
        # ASCII digits only: str.isdigit() also accepts superscripts and
        # circled numbers, which int() rejects
        if c not in "0123456789":
            if st is not None:
                out.append(number_to_words(text[st:i]))
                st = None
            out.append(c)
        else:
            if st is None:
                st = i
    if st is not None:
        out.append(number_to_words(text[st:]))
    return "".join(out)


def is_only_punctuation(text: str) -> bool:
    return all(unicodedata.category(c)[0] in ("P", "S") for c in text) if text else True


def split_paragraph(
    text: str,
    tokenize: Callable[[str], list],
    lang: str = "zh",
    token_max_n: int = 80,
    token_min_n: int = 60,
    merge_len: int = 20,
    comma_split: bool = False,
) -> List[str]:
    """Punctuation-driven paragraph split (frontend_utils.py:65-117)."""

    def length(t):
        return len(t) if lang == "zh" else len(tokenize(t))

    pounc = ["。", "？", "！", "；", "：", "、", ".", "?", "!", ";"] if lang == "zh" else [".", "?", "!", ";", ":"]
    if comma_split:
        pounc.extend(["，", ","])
    if not text:
        return []
    if text[-1] not in pounc:
        text += "。" if lang == "zh" else "."

    st, utts = 0, []
    i = 0
    while i < len(text):
        c = text[i]
        if c in pounc:
            if len(text[st:i]) > 0:
                utts.append(text[st:i] + c)
            if i + 1 < len(text) and text[i + 1] in ['"', "”"]:
                if utts:
                    utts[-1] = utts[-1] + text[i + 1]
                st = i + 2
            else:
                st = i + 1
        i += 1

    final, cur = [], ""
    for utt in utts:
        if length(cur + utt) > token_max_n and length(cur) > token_min_n:
            final.append(cur)
            cur = ""
        cur += utt
    if cur:
        if length(cur) < merge_len and final:
            final[-1] += cur
        else:
            final.append(cur)
    return final


def basic_normalize(text: str, tokenize: Callable[[str], list], split: bool = True):
    """Regex normalization chain (cli/frontend.py:138-158, no-external-tool
    branch) + paragraph split."""
    text = text.strip()
    if not text:
        return [] if split else text
    if contains_chinese(text):
        # the wetext slot (cli/frontend.py:66-70): native zh verbalization of
        # digits/dates/percent/currency before the regex cleanup chain
        from cosyvoice_tpu_torch.frontend.zh_tn import normalize_zh

        text = normalize_zh(text)
        text = text.replace("\n", "")
        text = replace_blank(text)
        text = replace_corner_mark(text)
        text = text.replace(".", "。").replace(" - ", "，")
        text = remove_bracket(text)
        text = re.sub(r"[，,、]+$", "。", text)
        texts = split_paragraph(text, tokenize, "zh")
    else:
        text = spell_out_number(text)
        texts = split_paragraph(text, tokenize, "en")
    texts = [t for t in texts if not is_only_punctuation(t)]
    return texts if split else "".join(texts)
