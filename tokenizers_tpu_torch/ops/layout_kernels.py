"""Layout kernel B3 (`csrc/layout.cu`) and its plain version; port of
`tokenizers_tpu.ops.layout_pallas`.

`layout_fused(b, lengths)` -> (bnd bool, nxt int32, h1 int32, h2 int32),
all [B, L], for ASCII chunks: the GPT-2 pre-split boundaries, each
position's next boundary (0x7FFFFFFF if none), and both rolling word
hashes delivered from each word's last byte back over the word (2^9
positions at most).  The plain version composes the same stages from
`bpe_encode.gpt2_boundaries` and `bpe_dedup.word_hash_heads`.

Two kernels, chosen by row width: the row kernel (`tt_layout_row`) for
L <= ROW_MAX_L, which keeps the row on the SM and needs L % 16 == 0 (the
main path's chunks are [B, 8192]), and the tiled one
(`layout_fused_wide`, through global scratch) for wider rows.  Bytes are
0-255.

The wrapper runs the plain version for tensors on the CPU; for CUDA
tensors it launches a kernel or raises.  Every launch adds one to
`LAUNCHES["layout_fused"]`, the wide kernel's also to
`LAUNCHES["layout_fused_wide"]`.
"""

from __future__ import annotations

import ctypes

import torch

from .kernel_build import check_cuda_int32, check_status, device_of, library

LAUNCHES = {"layout_fused": 0, "layout_fused_wide": 0}
ROW_MAX_L = 8192  # widest row of the row kernel (csrc: LROW_MAX_L)
ROW_K = 16  # positions a thread of the row kernel owns (csrc: LROW_K)
BIGP = 0x7FFFFFFF
_SRC = "layout.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_ROW_READY = set()  # (library, device) where the row kernel's shared memory is allowed


def supported(shape) -> bool:
    _B, L = shape
    return L % 128 == 0 and L >= 256


def load(defines=()):
    """The typed library of layout.cu, built with the macros `defines`
    (() is the shipped build)."""
    lib = library(_SRC, tuple(defines))
    if not getattr(lib, "_tt_typed", False):
        lib.tt_layout_row.argtypes = [_P] * 6 + [_I, _I, _I, _P]
        lib.tt_layout_row.restype = _I
        lib.tt_layout_wide.argtypes = [_P] * 7 + [_I, _I, _P]
        lib.tt_layout_wide.restype = _I
        lib.tt_n_scratch_layout_wide.restype = _I
        lib.tt_layout_row_init.restype = _I
        lib.tt_layout_row_smem.argtypes = [_I]
        lib.tt_layout_row_smem.restype = ctypes.c_longlong
        lib.tt_layout_row_blocks_per_sm.argtypes = [_I]
        lib.tt_layout_row_blocks_per_sm.restype = _I
        lib.tt_layout_row_max_l.restype = _I
        if lib.tt_layout_row_max_l() != ROW_MAX_L:
            raise RuntimeError("layout.cu and layout_kernels.py disagree on ROW_MAX_L")
        lib._tt_typed = True
    return lib


def next_boundary(bnd):
    """Per position: the first boundary strictly after it, else BIGP."""
    from .bpe_merge2 import _rev_cummin, _shift_next

    L = bnd.shape[1]
    pos = torch.arange(L, dtype=torch.int32, device=bnd.device).expand_as(bnd)
    nbp = _rev_cummin(torch.where(bnd, pos, BIGP))
    return _shift_next(nbp, BIGP)


def layout_fused_plain(b, lengths):
    from .bpe_dedup import H1_MULT, H2_MULT, word_hash_heads
    from .bpe_encode import gpt2_boundaries

    L = b.shape[1]
    pos = torch.arange(L, device=b.device)
    inb = pos[None, :] < lengths[:, None]
    b = torch.where(inb, b, 0)
    bnd, _ = gpt2_boundaries(b, inb, None, ascii_only=True)
    return (
        bnd,
        next_boundary(bnd),
        word_hash_heads(b, bnd, inb, H1_MULT),
        word_hash_heads(b, bnd, inb, H2_MULT),
    )


def _outputs(name, b, lengths):
    B, L = b.shape
    check_cuda_int32(name, (B, L), b=b)
    check_cuda_int32(name, (B,), lengths=lengths)
    bnd = torch.empty((B, L), dtype=torch.bool, device=b.device)
    return (bnd,) + tuple(torch.empty_like(b) for _ in range(3))


def _row_init(lib, dev):
    """Allow the row kernel its dynamic shared memory, once per library and
    device."""
    if (lib._name, dev.index) in _ROW_READY:
        return
    with torch.cuda.device(dev):
        st = lib.tt_layout_row_init()
    if st != 0:
        raise RuntimeError(
            "layout_fused: cudaFuncSetAttribute(MaxDynamicSharedMemorySize, "
            f"{lib.tt_layout_row_smem(ROW_MAX_L)}) failed with cudaError {st}"
        )
    _ROW_READY.add((lib._name, dev.index))


def row_residency(L):
    """(dynamic shared memory bytes, blocks resident per SM) of the row
    kernel at width L, on the current device."""
    lib = load()
    _row_init(lib, torch.device("cuda", torch.cuda.current_device()))
    return lib.tt_layout_row_smem(L), lib.tt_layout_row_blocks_per_sm(L)


def layout_fused(b, lengths, lib=None):
    """(b int32[B, L] bytes, lengths int32[B]) -> (bnd, nxt, h1, h2).
    `lib`: the build whose row kernel runs, from `load` (None: the shipped
    one); `tools/b3_phases.py` passes its timing build."""
    if device_of("layout_fused", b) == "cpu":
        return layout_fused_plain(b, lengths)
    B, L = b.shape
    if L > ROW_MAX_L:
        return layout_fused_wide(b, lengths)
    if L % ROW_K:
        raise ValueError(f"layout_fused: the row kernel takes L % {ROW_K} == 0, got L = {L}")
    outs = _outputs("layout_fused", b, lengths)
    if b.numel() == 0:
        return outs
    if lib is None:
        lib = load()
    _row_init(lib, b.device)
    vec = all(t.data_ptr() % 16 == 0 for t in (b,) + outs)
    LAUNCHES["layout_fused"] += 1
    check_status("layout_fused", lib.tt_layout_row(
        b.data_ptr(), lengths.data_ptr(), *(t.data_ptr() for t in outs), B, L,
        int(vec), torch.cuda.current_stream(b.device).cuda_stream,
    ))
    return outs


def layout_fused_wide(b, lengths):
    """B3 through the tiled kernel, at any width.  `layout_fused` takes it
    for rows wider than ROW_MAX_L."""
    if device_of("layout_fused_wide", b) == "cpu":
        return layout_fused_plain(b, lengths)
    B, L = b.shape
    outs = _outputs("layout_fused_wide", b, lengths)
    if b.numel() == 0:
        return outs
    lib = load()
    scratch = torch.empty(
        (lib.tt_n_scratch_layout_wide(), B, L), dtype=torch.int32, device=b.device
    )
    LAUNCHES["layout_fused"] += 1
    LAUNCHES["layout_fused_wide"] += 1
    check_status("layout_fused_wide", lib.tt_layout_wide(
        b.data_ptr(), lengths.data_ptr(), *(t.data_ptr() for t in outs),
        scratch.data_ptr(), B, L, torch.cuda.current_stream(b.device).cuda_stream,
    ))
    return outs
