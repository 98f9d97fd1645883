"""Layout kernel B3 (`csrc/layout.cu`) and its plain version; port of
`tokenizers_tpu.ops.layout_pallas`.

`layout_fused(b, lengths)` -> (bnd bool, nxt int32, h1 int32, h2 int32),
all [B, L], for ASCII chunks: the GPT-2 pre-split boundaries, each
position's next boundary (0x7FFFFFFF if none), and both rolling word
hashes delivered from each word's last byte back over the word (2^9
positions at most).  The plain version composes the same stages from
`bpe_encode.gpt2_boundaries` and `bpe_dedup.word_hash_heads`.

The wrapper runs the plain version for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  Each launch adds one to
`LAUNCHES["layout_fused"]`.
"""

from __future__ import annotations

import ctypes

import torch

from .kernel_build import check_cuda_int32, check_status, device_of, library

LAUNCHES = {"layout_fused": 0}
BIGP = 0x7FFFFFFF
_SRC = "layout.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int


def supported(shape) -> bool:
    _B, L = shape
    return L % 128 == 0 and L >= 256


def _lib():
    lib = library(_SRC)
    if not getattr(lib, "_tt_typed", False):
        lib.tt_layout.argtypes = [_P] * 7 + [_I, _I, _P]
        lib.tt_layout.restype = _I
        lib.tt_n_scratch_layout.restype = _I
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


def layout_fused(b, lengths):
    """(b int32[B, L] bytes, lengths int32[B]) -> (bnd, nxt, h1, h2)."""
    if device_of("layout_fused", b) == "cpu":
        return layout_fused_plain(b, lengths)
    B, L = b.shape
    check_cuda_int32("layout_fused", (B, L), b=b)
    check_cuda_int32("layout_fused", (B,), lengths=lengths)
    bnd = torch.empty((B, L), dtype=torch.bool, device=b.device)
    nxt, h1, h2 = (torch.empty_like(b) for _ in range(3))
    if b.numel() == 0:
        return bnd, nxt, h1, h2
    lib = _lib()
    scratch = torch.empty(
        (lib.tt_n_scratch_layout(), B, L), dtype=torch.int32, device=b.device
    )
    LAUNCHES["layout_fused"] += 1
    check_status("layout_fused", lib.tt_layout(
        b.data_ptr(), lengths.data_ptr(), bnd.data_ptr(), nxt.data_ptr(),
        h1.data_ptr(), h2.data_ptr(), scratch.data_ptr(), B, L,
        torch.cuda.current_stream(b.device).cuda_stream,
    ))
    return bnd, nxt, h1, h2
