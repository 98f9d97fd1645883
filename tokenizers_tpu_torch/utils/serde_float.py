"""serde_json-compatible float parsing for tokenizer.json; copy of
`tokenizers_tpu.utils.serde_float`.

The reference loads `tokenizer.json` with Rust's `serde_json`, whose default
f64 path (`f64_from_parts`, serde_json `src/de.rs`) is NOT correctly rounded:
it converts the decimal significand to f64 and then applies the decimal
exponent with a single multiply/divide by a pre-rounded `POW10` table entry.
That double rounding differs from a correctly-rounded parse (Python `float`)
in the last ulp for ~23% of typical shortest-repr score literals, and Unigram
Viterbi tie-breaks are sensitive to exactly those ulps
(reference `tokenizers/src/models/unigram/model.rs:280` sums parsed scores).

`json.loads(..., parse_float=serde_f64)` reproduces the wheel's values
bit-for-bit.
"""

from __future__ import annotations


def serde_f64(literal: str) -> float:
    """Parse a JSON number literal exactly as serde_json's default f64 path."""
    s = literal.strip()
    positive = True
    if s and s[0] in "+-":
        positive = s[0] == "+"
        s = s[1:]

    mant, _, exp_part = s.partition("e") if "e" in s else s.partition("E")
    int_part, _, frac_part = mant.partition(".")
    explicit_exp = int(exp_part) if exp_part else 0

    # Accumulate the significand into a u64, serde-style: once another digit
    # would overflow, remaining integer digits only bump the exponent and
    # remaining fraction digits are ignored.
    U64_MAX = (1 << 64) - 1
    sig = 0
    exponent = 0
    overflowed = False
    for ch in int_part:
        d = ord(ch) - 48
        if not overflowed:
            nxt = sig * 10 + d
            if nxt > U64_MAX:
                overflowed = True
                exponent += 1
            else:
                sig = nxt
        else:
            exponent += 1
    for ch in frac_part:
        d = ord(ch) - 48
        if not overflowed:
            nxt = sig * 10 + d
            if nxt > U64_MAX:
                overflowed = True
            else:
                sig = nxt
                exponent -= 1
        # serde ignores fraction digits after overflow (no exponent change)
    exponent += explicit_exp

    # f64_from_parts: f = sig as f64, then one mul/div per POW10 chunk.
    f = float(sig)
    e = exponent
    while True:
        if -309 < e < 309:
            pow10 = float("1e%d" % abs(e))
            if e >= 0:
                f *= pow10
            else:
                f /= pow10
            break
        if f == 0.0:
            break
        if e >= 0:
            f = float("inf")
            break
        f /= 1e308
        e += 308
    return f if positive else -f
