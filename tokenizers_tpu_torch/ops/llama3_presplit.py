"""Llama-3 pre-split boundaries over packed bytes; port of
`tokenizers_tpu.ops.llama3_presplit`.

The Llama-3 split pattern (`tests/fixtures/llama3*/tokenizer.json`):

    (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}{1,3}|
     ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+

is not run as a regex.  Its match starts are local char-class rules plus
three row scans:

  * letters extend their run, and are absorbed into a preceding single
    non-newline, non-letter, non-digit char when that char itself starts a
    match (the `[^\\r\\n..]?` prefix), a rule local in the class two chars
    back;
  * digits split every 3 chars from the digit run's start (`\\p{N}{1,3}`);
  * punctuation runs absorb a following `[\\r\\n]*`;
  * whitespace runs split after their last newline (`\\s*[\\r\\n]+`), then
    attach before a word as in GPT-2;
  * contractions are case-insensitive, U+017F (ſ) folding to 's'.

The JAX package's three `associative_scan`s become whole-tensor cumsum and
cummax/cummin forms over segment heads: no Python loop over positions.
"""

from __future__ import annotations

import torch

from .bpe_merge2 import _cols, _rev_cummin, _seg_count, _shift_next, _shift_prev
from .unicode_tables import CLS_END, CLS_L, CLS_N, CLS_O, CLS_SP, CLS_WS

CLS_NL = 7  # \r / \n: a class the shared tables fold into WS; split here
_BIG = 1 << 30


def _seg_or_reverse(val, run, run_end):
    """Suffix-OR of `val` within contiguous True-runs of `run` (each run
    ends at a `run_end` position): whether a `val` lies at or after each
    position, up to its run's end."""
    cols = _cols(run)
    nxt_val = _rev_cummin(torch.where(val, cols, _BIG))
    nxt_end = _rev_cummin(torch.where(run_end, cols, _BIG))
    return run & (nxt_val <= nxt_end)


def _seg_fill_forward(head_val, head, run):
    """`head_val` of the last run head at or before each position (False
    before the first head), within contiguous True-runs of `run`."""
    last = torch.cummax(torch.where(head, _cols(head), -1), 1).values
    filled = head_val.gather(1, last.clamp(min=0)) & (last >= 0)
    return filled & run


def _ws(c):
    return (c == CLS_SP) | (c == CLS_WS) | (c == CLS_NL)


def llama3_boundaries(b, inb, cls_table, ascii_only=False):
    """Match-start mask of the Llama-3 split pattern over packed bytes.

    b: int32[B, L] byte values (0 outside text); inb: bool[B, L] in-text.
    cls_table: flat int8[0x110000] codepoint -> class table (unused when
    `ascii_only`, every byte < 128).  Returns (bnd bool[B, L], is_start
    bool[B, L])."""
    from .bpe_encode import ascii_cls

    B, L = b.shape
    pos = torch.arange(L, device=b.device).expand(B, L)
    length = inb.sum(1, keepdim=True)
    nl_byte = (b == 0x0A) | (b == 0x0D)

    b1 = _shift_next(b, 0)
    b2 = _shift_next(b, 0, 2)

    if ascii_only:
        is_start = inb
        cls = torch.where(nl_byte, CLS_NL, ascii_cls(b))
        cls_fill = cls
        prev_cls = torch.where(pos == 0, CLS_END, _shift_prev(cls_fill, CLS_END))
        pp_cls = torch.where(pos <= 1, CLS_END, _shift_prev(cls_fill, CLS_END, 2))
        next_exists = (pos + 1) < length
        next_cls = torch.where(next_exists, _shift_next(cls_fill, -1), CLS_END)
    else:
        is_cont = (b & 0xC0) == 0x80
        is_start = inb & ~is_cont
        charlen = 1 + (b >= 0xC0).int() + (b >= 0xE0).int() + (b >= 0xF0).int()
        b3 = _shift_next(b, 0, 3)
        cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
        cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
        cp4 = (((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
               | (b3 & 0x3F))
        cp = torch.where(
            charlen == 1, b,
            torch.where(charlen == 2, cp2, torch.where(charlen == 3, cp3, cp4)),
        ).clamp(0, 0x10FFFF)
        cls = cls_table[cp.to(torch.int64)].to(torch.int32)
        cls = torch.where(nl_byte, CLS_NL, cls)

        # forward-fill class and char-start position over continuation bytes
        f = torch.where(is_start, cls, -1)
        sp = torch.where(is_start, pos, -1)
        for _ in range(3):
            f = torch.where(f >= 0, f, _shift_prev(f, -1))
            sp = torch.where(sp >= 0, sp, _shift_prev(sp, -1))
        cls_fill, start_fill = f, sp

        prev_cls = torch.where(pos == 0, CLS_END, _shift_prev(cls_fill, CLS_END))
        # class two chars back: prev_cls at the previous char's start, 1..4
        # bytes back
        d1 = pos - _shift_prev(start_fill, 0)
        pp_cls_raw = _shift_prev(prev_cls, CLS_END)
        for k in (2, 3, 4):
            pp_cls_raw = torch.where(d1 == k, _shift_prev(prev_cls, CLS_END, k), pp_cls_raw)
        pp_cls = torch.where(pos <= 1, CLS_END, pp_cls_raw)

        # class of the next char, at distance charlen in {1..4}
        next_exists = (pos + charlen) < length
        next_cls_raw = _shift_next(cls_fill, -1)
        for k in (2, 3, 4):
            next_cls_raw = torch.where(charlen == k, _shift_next(cls_fill, -1, k), next_cls_raw)
        next_cls = torch.where(next_exists, next_cls_raw, CLS_END)

    is_ws_b = _ws(cls_fill) & inb  # per byte, continuation bytes included
    is_nl_b = (cls_fill == CLS_NL) & inb

    # ---- scans -----------------------------------------------------------
    # nlge: a newline at or after this byte within the same whitespace run
    run_end = is_ws_b & ~_shift_next(is_ws_b, False)
    nlge = _seg_or_reverse(is_nl_b, is_ws_b, run_end)
    # absorbed_nl: a newline run directly continuing a punctuation run
    prev_b_cls = _shift_prev(cls_fill, CLS_END)
    nl_head = is_nl_b & (prev_b_cls != CLS_NL)
    absorbed_nl = _seg_fill_forward(nl_head & (prev_b_cls == CLS_O), nl_head, is_nl_b)
    # chars since the digit run's first char (garbage outside runs, masked)
    dig_start = is_start & (cls == CLS_N) & (prev_cls != CLS_N)
    dig_off = _seg_count(is_start, dig_start) - 1

    # ---- contractions (case-insensitive, ſ folds to s) -------------------
    apo = is_start & (b == 0x27)
    p_ok = (prev_cls != CLS_O) & (prev_cls != CLS_SP)

    def ci(x, lo):
        return (x == ord(lo)) | (x == ord(lo.upper()))

    sfold = (b1 == 0xC5) & (b2 == 0xBF)  # U+017F ſ
    is2a = ci(b1, "s") | ci(b1, "t") | ci(b1, "m") | ci(b1, "d")
    is3 = (ci(b1, "r") & ci(b2, "e")) | (ci(b1, "v") & ci(b2, "e")) | (ci(b1, "l") & ci(b2, "l"))
    blen = torch.where(
        is3 & ((pos + 2) < length), 3,
        torch.where(is2a & ((pos + 1) < length), 2,
                    torch.where(sfold & ((pos + 2) < length), 3, 0)),
    )
    contr = apo & p_ok & (blen > 0)
    c2 = contr & (blen == 2)
    c3 = contr & (blen == 3)
    interior = _shift_prev(contr, False) | _shift_prev(c3, False, 2)
    contr_end = _shift_prev(c2, False, 2) | _shift_prev(c3, False, 3)

    # ---- per-class boundary rules ----------------------------------------
    p = prev_cls
    is_ws_prev = _ws(p)
    nlge_prev = _shift_prev(nlge, False)
    absorbed_prev = _shift_prev(absorbed_nl, False)
    next_nonws = next_exists & ~_ws(next_cls) & (next_cls != CLS_END)

    # letter: N, NL and the text start split; SP/WS are the absorbed
    # one-char prefix; O splits only when that O could not start a match
    b_letter = torch.where(
        (p == CLS_L) | (p == CLS_SP) | (p == CLS_WS), False,
        torch.where(p == CLS_O, (pp_cls == CLS_O) | (pp_cls == CLS_SP), True),
    )
    b_digit = (p != CLS_N) | (dig_off % 3 == 0)
    b_punct = (p != CLS_O) & (p != CLS_SP)
    b_ws = ~absorbed_nl & (
        ~is_ws_prev
        | ((p == CLS_NL) & (~nlge | absorbed_prev))
        | (next_nonws & is_ws_prev & (p != CLS_NL) & ~nlge_prev)
    )

    bnd = torch.where(
        cls == CLS_L, b_letter,
        torch.where(cls == CLS_N, b_digit, torch.where(cls == CLS_O, b_punct, b_ws)),
    )
    bnd = bnd | (pos == 0) | contr_end
    bnd = bnd & ~interior & is_start & inb
    return bnd, is_start
