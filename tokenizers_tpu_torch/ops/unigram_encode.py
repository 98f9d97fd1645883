"""The stages shared by the Unigram (SentencePiece) programs; port of the
shared part of `tokenizers_tpu.ops.unigram_encode` (the JAX package
computes them in plain XLA, with no Pallas kernel, and so does this port
in torch ops).

* `normalize_metaspace`: Nmt (control chars deleted, whitespace-likes
  mapped to a space), `Replace(" {2,}" -> " ")` (a space whose next
  surviving char is a space is dropped: the reference's replacement
  takes the span of the run's last char) and Metaspace (each space
  becomes `▁`, 3 bytes, and one is prepended when the text does not
  start with it), fused per char: a two-stage class table, a scan for
  the next surviving char and byte scatters into a [B, 2L + 4] row.
  Every `▁` begins a word.  With `with_src` it also gives each
  normalized byte its source char (the offsets path).
* `byte_fallback_expand`: the emitted tokens in byte space, an unk span
  expanded into one `<0xXX>` token per normalized byte.

The dense `unigram_program` of the JAX package (its CPU route and
oracle) is not ported: the port runs the dedup program
(`unigram_dedup.py`) for ids and the packed one (`unigram_packed.py`)
for offsets on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..normalizers import Nmt
from .bpe_merge2 import _rev_cummin, _shift_next, next_index
from .wordpiece_encode import decode_chars, fill_last

NEG = np.float32(-1e30)
MAX_TOKENS_PER_WORD = 64

CLS_KEEP = 0
CLS_SPACE = 1
CLS_DELETE = 2

META = (0xE2, 0x96, 0x81)  # "▁"

_nmt_cache = None


def nmt_metaspace_class_table():
    """(s1 int32[4352], s2 int8): the two-stage codepoint -> class table
    (CLS_KEEP, CLS_SPACE, CLS_DELETE) of the fused Nmt + space pipeline,
    from the port's own Nmt sets, identical pages shared."""
    global _nmt_cache
    if _nmt_cache is None:
        cls = np.zeros(0x110000, np.int8)
        cls[sorted(Nmt.FILTERED)] = CLS_DELETE
        cls[sorted(Nmt.TO_SPACE)] = CLS_SPACE
        cls[0x20] = CLS_SPACE
        uniq, s1 = np.unique(cls.reshape(-1, 256), axis=0, return_inverse=True)
        _nmt_cache = (s1.reshape(-1).astype(np.int32), uniq.reshape(-1).astype(np.int8))
    return _nmt_cache


def normalize_metaspace(bytes_u8, lengths, cls_s1, cls_s2, with_src):
    """uint8[B, L] + int32[B] -> (nb int32, wbnd bool, ninb bool [B, L2],
    total int32[B], row_bad bool[B], src_char int32[B, L2] or None), L2 =
    2L + 4: the normalized bytes, the word starts (each `▁`), the in-row
    mask, the normalized length and the rows it overflows.  `cls_s1`,
    `cls_s2`: `nmt_metaspace_class_table` as tensors."""
    B, L = bytes_u8.shape
    L2 = L * 2 + 4
    dev = bytes_u8.device
    pos = torch.arange(L, dtype=torch.int32, device=dev).expand(B, L)
    inb = pos < lengths[:, None]
    b = torch.where(inb, bytes_u8.to(torch.int32), 0)

    cp, is_start, charlen = decode_chars(b, inb)
    page = cls_s1[(cp >> 8).to(torch.int64)].to(torch.int32)
    cls = torch.where(is_start, cls_s2[((page << 8) | (cp & 255)).to(torch.int64)].to(torch.int32),
                      CLS_DELETE)
    surv = is_start & (cls != CLS_DELETE)
    # Replace(" {2,}" -> " ") keeps the LAST space of a run: a space whose
    # next surviving char is a space is dropped
    j = next_index(surv)
    nfnd = j < L
    ncls = torch.where(nfnd, cls.gather(1, j.clamp(max=L - 1)), 0)
    collapsed = (cls == CLS_SPACE) & nfnd & (ncls == CLS_SPACE)
    cls = torch.where(collapsed, CLS_DELETE, cls)

    keep = is_start & (cls == CLS_KEEP)
    space = is_start & (cls == CLS_SPACE)
    out_len = torch.where(keep, charlen, torch.where(space, 3, 0))
    first_pos = torch.where(surv & ~collapsed, pos, L).amin(1)
    first_cls = cls.gather(1, first_pos.clamp(0, L - 1).to(torch.int64)[:, None])[:, 0]
    prepend = (first_pos < L) & (first_cls != CLS_SPACE)
    base = torch.where(prepend, 3, 0).to(torch.int32)

    csum = torch.cumsum(out_len, 1, dtype=torch.int32)
    opos = base[:, None] + csum - out_len
    total = base + csum[:, -1]
    row_bad = total > L2

    W = L2 + 4  # the JAX program's junk columns; writes past them drop
    rows = torch.arange(B, device=dev)[:, None].expand(B, L)

    def put(dst, mask, tgt, vals):
        m = mask & (tgt < W)
        dst[rows[m], tgt[m].to(torch.int64)] = vals[m] if isinstance(vals, torch.Tensor) \
            else vals

    nb = torch.zeros((B, W), dtype=torch.uint8, device=dev)
    wbnd = torch.zeros((B, W), dtype=torch.bool, device=dev)
    for k, v in enumerate(META):
        nb[:, k] = torch.where(prepend, v, nb[:, k])
    wbnd[:, 0] |= prepend
    for k, v in enumerate(META):
        put(nb, space, opos + k, v)
    put(wbnd, space, opos, True)
    for k in range(4):
        src = _shift_next(b, 0, k) if k else b
        put(nb, keep & (k < charlen), opos + k, src.to(torch.uint8))
    nb = nb[:, :L2].to(torch.int32)
    wbnd = wbnd[:, :L2].contiguous()
    npos = torch.arange(L2, dtype=torch.int32, device=dev).expand(B, L2)
    ninb = npos < total[:, None]
    nb = torch.where(ninb, nb, 0)

    src_char = None
    if with_src:
        # the source char of each normalized byte: the char that emits it,
        # carried forward over its bytes; the prepended `▁` takes the first
        # emitting char's (NormalizedString.prepend's alignment)
        in_char_idx = torch.cumsum(is_start.to(torch.int32), 1, dtype=torch.int32) - 1
        srcm = torch.full((B, W), -1, dtype=torch.int32, device=dev)
        put(srcm, is_start & (out_len > 0), opos, in_char_idx)
        src = fill_last(srcm[:, :L2], -1)
        cols = torch.arange(L2, device=dev).expand(B, L2)
        jn = _rev_cummin(torch.where(src >= 0, cols, L2))
        back = torch.where(jn < L2, src.gather(1, jn.clamp(max=L2 - 1)), -1)
        src_char = torch.where(src >= 0, src, back)
        src_char = torch.where(ninb, src_char.clamp(min=0), 0)

    return nb, wbnd, ninb, total, row_bad, src_char


def byte_fallback_expand(emit, jlen, node_id, unk_id, bf_tab, nb, inb, K):
    """Boundary-space emissions [R, C + 1] -> byte-space emissions [R, C],
    with the `<0xXX>` expansion of unk spans (reference
    `unigram/model.rs:429-446`): a token other than unk emits at its start
    byte; each emitted (fused) unk span emits one byte token per
    normalized byte it covers, each carrying the whole span.  `bf_tab`:
    the complete int32[256] byte -> token id table.

    Returns (ids, start, exclusive end, emit) over [R, C]."""
    R = emit.shape[0]
    C = emit.shape[1] - 1
    dev = emit.device
    ids_b = torch.full((R, C + 1), -1, dtype=torch.int32, device=dev)
    len_b = torch.zeros((R, C + 1), dtype=torch.int32, device=dev)
    for d in range(1, K + 1):
        m = _shift_next(emit & (jlen == d), False, d)
        ids_b = torch.where(m, _shift_next(node_id, -1, d), ids_b)
        len_b = torch.where(m, d, len_b)
    ids_b = ids_b[:, :C]
    len_b = len_b[:, :C]
    start = ids_b >= 0
    pos = torch.arange(C, dtype=torch.int32, device=dev).expand(R, C)

    # (id, start) of the covering token, carried forward over word bytes
    j = torch.cummax(torch.where(start, pos, -1), 1).values
    cov_set = j >= 0
    jc = j.clamp(min=0).to(torch.int64)
    cov_id = torch.where(cov_set, ids_b.gather(1, jc), -1)
    cov_st = torch.where(cov_set, j, 0)
    # exclusive end of the covering span: the next emission start or dead
    # position strictly after p
    mark = torch.where(start | ~inb, pos, C)
    en_next = _shift_next(_rev_cummin(mark), C)
    isbf = inb & cov_set & (cov_id == unk_id)
    emit_b = inb & (isbf | (start & (ids_b != unk_id)))
    bf_ids = bf_tab[nb.clamp(0, 255).to(torch.int64)]
    ids_out = torch.where(isbf, bf_ids, torch.where(emit_b, ids_b, -1))
    st_b = torch.where(isbf, cov_st, pos)
    en_b = torch.where(isbf, en_next, pos + len_b)
    st_b = torch.where(emit_b, st_b, 0)
    en_b = torch.where(emit_b, en_b, 0)
    return ids_out, st_b, en_b, emit_b
