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
8 KB documents' chunks are [B, 8192]), and the same body over a
thread-block cluster (`layout_fused_wide`, `tt_layout_wide`) for the long
documents' chunks, L up to WIDE_MAX_L: `wide_geometry` cuts a row into
n <= 8 slices of at most ROW_MAX_L positions, one CTA each.  Bytes are
0-255.

The wrapper runs the plain version for tensors on the CPU; for CUDA
tensors it launches a kernel or raises.  Every launch adds one to
`LAUNCHES["layout_fused"]`, the wide kernel's also to
`LAUNCHES["layout_fused_wide"]`.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build
from .kernel_build import ceil_div, check_cuda_int32, check_status, device_of, library

LAUNCHES = {"layout_fused": 0, "layout_fused_wide": 0}
ROW_MAX_L = 8192  # widest row of the row kernel, widest slice (csrc: LROW_MAX_L)
ROW_K = 16  # positions a thread owns (csrc: LROW_K)
WIDE_MAX_L = 65536  # widest row of the cluster kernel: packing.MAX_L // 2 (csrc: LWIDE_MAX_L)
WIDE_MAX_N = 16  # CTAs a cluster may have, above 8 non-portable (csrc: LWIDE_MAX_N)
BIGP = 0x7FFFFFFF
_SRC = "layout.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
# slice sizes other than the rule's, where `tools/cluster_sweep.py` found
# them faster on an H100 (PERF.md, section 6): at L = 32768 eight slices of
# 4096 take 0.0356 ms against 0.0383 for four of 8192.  A measured exception,
# not a rule: sweep again whenever the kernel's body changes
WIDE_SLICE = {32768: 4096}
_READY = set()  # (library, device) where the kernels' shared memory is allowed


def supported(shape) -> bool:
    """Chunks `bpe_encode` gives this module.  On the card a row wider
    than WIDE_MAX_L is refused (`wide_geometry` raises), not sent to the
    plain boundaries."""
    _B, L = shape
    return L % 128 == 0 and L >= 256


def smem_bytes(S):
    """Dynamic shared memory of a block holding S positions (csrc:
    lrow_smem_bytes): two striped uint32 a thread's position and the bytes."""
    nth = ceil_div(ceil_div(S, ROW_K), 32) * 32
    return 2 * 4 * nth * ROW_K + 4 + S + 12


def wide_geometry(L):
    """(S, n) of the cluster kernel for rows of L positions: n =
    ceil(L / ROW_MAX_L) CTAs of S = ceil(L / n) positions, rounded up to a
    multiple of ROW_K, unless WIDE_SLICE names S.  Raises for rows it does
    not take."""
    if not (ROW_MAX_L <= L <= WIDE_MAX_L and L % 128 == 0):
        raise ValueError(
            f"layout_fused_wide: takes L % 128 == 0 from {ROW_MAX_L} to {WIDE_MAX_L}, "
            f"got L = {L}"
        )
    S = WIDE_SLICE.get(L) or ceil_div(ceil_div(L, ceil_div(L, ROW_MAX_L)), ROW_K) * ROW_K
    return S, ceil_div(L, S)


def load(defines=()):
    """The typed library of layout.cu, built with the macros `defines`
    (() is the shipped build)."""
    lib = library(_SRC, tuple(defines))
    if not getattr(lib, "_tt_typed", False):
        lib.tt_layout_row.argtypes = [_P] * 6 + [_I, _I, _I, _P]
        lib.tt_layout_row.restype = _I
        lib.tt_layout_wide.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        lib.tt_layout_wide.restype = _I
        lib.tt_layout_wide_max_clusters.argtypes = [_I, _I]
        lib.tt_layout_wide_max_clusters.restype = _I
        lib.tt_layout_wide_max_l.restype = _I
        lib.tt_layout_wide_max_n.restype = _I
        lib.tt_layout_row_init.restype = _I
        lib.tt_layout_row_smem.argtypes = [_I]
        lib.tt_layout_row_smem.restype = ctypes.c_longlong
        lib.tt_layout_row_blocks_per_sm.argtypes = [_I]
        lib.tt_layout_row_blocks_per_sm.restype = _I
        lib.tt_layout_row_max_l.restype = _I
        if (lib.tt_layout_row_max_l(), lib.tt_layout_wide_max_l(),
                lib.tt_layout_wide_max_n()) != (ROW_MAX_L, WIDE_MAX_L, WIDE_MAX_N):
            raise RuntimeError("layout.cu and layout_kernels.py disagree on their limits")
        for S in (16, 1024, ROW_MAX_L):
            if lib.tt_layout_row_smem(S) != smem_bytes(S):
                raise RuntimeError("layout.cu and layout_kernels.py disagree on shared memory")
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
    """Allow both kernels their dynamic shared memory, once per library and
    device."""
    if (lib._name, dev.index) in _READY:
        return
    with torch.cuda.device(dev):
        st = lib.tt_layout_row_init()
    if st != 0:
        raise RuntimeError(
            "layout_fused: cudaFuncSetAttribute(MaxDynamicSharedMemorySize, "
            f"{lib.tt_layout_row_smem(ROW_MAX_L)}) failed with cudaError {st}"
        )
    _READY.add((lib._name, dev.index))


def row_residency(L):
    """(dynamic shared memory bytes, blocks resident per SM) of the row
    kernel at width L, on the current device."""
    lib = load()
    _row_init(lib, torch.device("cuda", torch.cuda.current_device()))
    return lib.tt_layout_row_smem(L), lib.tt_layout_row_blocks_per_sm(L)


def max_clusters(S, n, dev=None, lib=None):
    """Clusters of n CTAs with slices of S the card holds at once
    (`kernel_build.max_clusters`); raises where there are none."""
    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None else dev
    lib = load() if lib is None else lib
    _row_init(lib, dev)
    return kernel_build.max_clusters(lib, "tt_layout_wide_max_clusters", dev, S, n)


def layout_fused(b, lengths, lib=None):
    """(b int32[B, L] bytes, lengths int32[B]) -> (bnd, nxt, h1, h2).
    `lib`: the build whose row kernel runs, from `load` (None: the shipped
    one); `tools/b3_phases.py` passes its timing build."""
    if device_of("layout_fused", b) == "cpu":
        return layout_fused_plain(b, lengths)
    B, L = b.shape
    if L > ROW_MAX_L:
        return layout_fused_wide(b, lengths, lib)
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


def layout_fused_wide(b, lengths, lib=None):
    """B3 through the cluster kernel, L % 128 == 0 from ROW_MAX_L to
    WIDE_MAX_L.  `layout_fused` takes it for rows wider than ROW_MAX_L.
    `lib` as `layout_fused`'s."""
    if device_of("layout_fused_wide", b) == "cpu":
        return layout_fused_plain(b, lengths)
    return _layout_cluster(b, lengths, *wide_geometry(b.shape[1]), lib)


def _layout_cluster(b, lengths, S, n, lib=None):
    """The cluster kernel in n slices of S positions a row, for CUDA
    tensors: `layout_fused_wide` with the geometry given
    (`tools/cluster_sweep.py` times each)."""
    B, L = b.shape
    outs = _outputs("layout_fused_wide", b, lengths)
    if b.numel() == 0:
        return outs
    if lib is None:
        lib = load()
    max_clusters(S, n, b.device, lib)
    vec = all(t.data_ptr() % 16 == 0 for t in (b,) + outs)
    LAUNCHES["layout_fused"] += 1
    LAUNCHES["layout_fused_wide"] += 1
    check_status("layout_fused_wide", lib.tt_layout_wide(
        b.data_ptr(), lengths.data_ptr(), *(t.data_ptr() for t in outs), B, L,
        S, n, int(vec), torch.cuda.current_stream(b.device).cuda_stream,
    ))
    return outs
