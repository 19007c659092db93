"""A copy of cosyvoice_tpu/frontend/zh_tn.py.

Native Chinese text normalization (the wetext/ttsfrd role,
cli/frontend.py:56-75 fallback chain — the reference degrades to raw text
when neither external tool is installed; this module fills that slot with a
dependency-free rule set so zh digits/dates/percents are verbalized).

Coverage (applied in order, longest-context first):
  dates  2024年3月5日 -> 二零二四年三月五日
  times  3点15分 / 08:30 -> 三点十五分 / 八点三十分
  percent  35.5% -> 百分之三十五点五
  currency  ¥12.5 / 12.5元 -> 十二点五元
  fractions  3/4 -> 四分之三
  ranges  3-5个 -> 三到五个
  phone/long digits (>=7) -> digit-by-digit (1 read 幺)
  decimals / negatives / cardinals with 万/亿 grouping
"""

import re

_DIGITS = "零一二三四五六七八九"
_TEL_DIGITS = "零幺二三四五六七八九"  # phone reading: 1 -> 幺
_UNITS_SMALL = ["", "十", "百", "千"]
_UNITS_BIG = ["", "万", "亿", "万亿"]


def _four(n: int, trailing: bool) -> str:
    """Read 0 <= n < 10000; `trailing` marks that lower groups follow (so a
    leading gap needs 零)."""
    if n == 0:
        return ""
    out, started, zero_pending = [], False, False
    for i in range(3, -1, -1):
        d = (n // 10**i) % 10
        if d == 0:
            if started:
                zero_pending = True
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        out.append(_DIGITS[d] + _UNITS_SMALL[i])
        started = True
    return "".join(out)


def read_cardinal(num: str) -> str:
    """Integer string -> hanzi with 万/亿 grouping; '十X' contraction for
    10..19 (一十五 -> 十五, matching common TN output)."""
    num = num.lstrip("0") or "0"
    if num == "0":
        return "零"
    n = int(num)
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        text = _four(g, gi > 0)
        # inter-group zero: 10005 -> 一万零五 (gap when the group < 1000)
        if parts and g < 1000:
            parts.append("零")
        parts.append(text + _UNITS_BIG[gi])
    out = "".join(parts)
    if out.startswith("一十"):
        out = out[1:]
    return out


def read_digits(num: str, tel: bool = False) -> str:
    table = _TEL_DIGITS if tel else _DIGITS
    return "".join(table[int(c)] for c in num if c.isdigit())


def read_number(num: str) -> str:
    """Cardinal with optional sign and decimal point."""
    sign = ""
    if num.startswith(("-", "−")):
        sign, num = "负", num[1:]
    if "." in num:
        ip, fp = num.split(".", 1)
        fp = fp.rstrip("0")
        base = read_cardinal(ip or "0")
        return sign + base + ("点" + read_digits(fp) if fp else "")
    return sign + read_cardinal(num)


_RULES = [
    # dates: year digit-by-digit, month/day cardinal
    (re.compile(r"(\d{4})年"), lambda m: read_digits(m.group(1)) + "年"),
    (re.compile(r"(\d{1,2})月(\d{1,2})[日号]"),
     lambda m: read_cardinal(m.group(1)) + "月" + read_cardinal(m.group(2)) + "日"),
    (re.compile(r"(\d{1,2})月(?!\d)"), lambda m: read_cardinal(m.group(1)) + "月"),
    # clock times
    (re.compile(r"(\d{1,2}):(\d{2})(?::(\d{2}))?"),
     lambda m: read_cardinal(m.group(1)) + "点" + (
         ("" if m.group(2) == "00" else read_cardinal(m.group(2)) + "分")
         + (read_cardinal(m.group(3)) + "秒" if m.group(3) and m.group(3) != "00" else ""))),
    (re.compile(r"(\d{1,2})点(\d{1,2})分"),
     lambda m: read_cardinal(m.group(1)) + "点" + read_cardinal(m.group(2)) + "分"),
    # percent
    (re.compile(r"(-?\d+(?:\.\d+)?)%"), lambda m: "百分之" + read_number(m.group(1))),
    # currency
    (re.compile(r"[¥￥](\d+(?:\.\d+)?)"), lambda m: read_number(m.group(1)) + "元"),
    (re.compile(r"(\d+(?:\.\d+)?)元"), lambda m: read_number(m.group(1)) + "元"),
    # fraction (a/b -> b分之a), bounded to avoid dates already handled
    (re.compile(r"(?<!\d)(\d{1,3})/(\d{1,3})(?!\d)"),
     lambda m: read_cardinal(m.group(2)) + "分之" + read_cardinal(m.group(1))),
    # numeric range 3-5 (between zh context or before a measure word)
    (re.compile(r"(?<!\d)(\d+)[-~—](\d+)(?!\d)"),
     lambda m: read_number(m.group(1)) + "到" + read_number(m.group(2))),
    # long digit strings (phone numbers, ids): digit-by-digit with 幺
    (re.compile(r"(?<!\d)(\d{7,})(?!\d)"), lambda m: read_digits(m.group(1), tel=True)),
    # plain numbers (int/decimal, optional sign)
    (re.compile(r"(?<![\d.])-?\d+(?:\.\d+)?(?![\d.])"), lambda m: read_number(m.group(0))),
]


def normalize_zh(text: str) -> str:
    """Verbalize digits/dates/percent/currency in zh text (the wetext role).
    Pure string -> string; idempotent on text without ASCII digits."""
    if not re.search(r"\d", text):
        return text
    for pat, fn in _RULES:
        text = pat.sub(fn, text)
    return text
