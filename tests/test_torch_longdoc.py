"""The long-document path of the port on the CPU.

* The host functions that cut rows over thread-block clusters
  (`layout_kernels.wide_geometry`, `merge_kernels.cluster_geometry`), for
  every shape the long-document path and the full-width branch produce:
  each covers the row exactly, stays within its cluster limit and fits the
  card's shared memory.  Pure Python.
* `split_long` and `pack_batch` against the JAX package's on long inputs,
  with and without safe seams: the same chunks and the same [B, L].
* `Tokenizer.encode_batch_fast(device="cpu")` against the `tokenizers`
  wheel on 12-40 KB corpus documents and a dense document
  (`smoke_data.dense_docs`), whose chunk takes the full-width branch.

The JAX program itself is held against the port's at [2, 16, 256] in
test_torch_slice.py: compiling it costs about 40 s here at any width, so
the long widths are held piece by piece (B3's plain version at 16384 in
test_torch_layout.py, the merge phases in test_torch_merge_phases.py).
"""

import numpy as np
import pytest

from tokenizers import Tokenizer as WheelTokenizer

from tokenizers_tpu.ops import longdoc as jl
from tokenizers_tpu.ops import packing as jpk
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.ops import bpe_encode, engine_base
from tokenizers_tpu_torch.ops import bpe_merge2 as tm
from tokenizers_tpu_torch.ops import kernel_build as kb
from tokenizers_tpu_torch.ops import layout_kernels as lk
from tokenizers_tpu_torch.ops import longdoc as tld
from tokenizers_tpu_torch.ops import merge_kernels as mk
from tokenizers_tpu_torch.ops import packing as tpk
from tokenizers_tpu_torch.smoke_data import build_docs, dense_docs

GPT2 = "tests/fixtures/gpt2/tokenizer.json"
WIDTHS = (8192, 16384, 32768, 65536)  # bucket widths of the long path's chunks
STATIC_SMEM = 2048  # more than either kernel's static shared memory (ptxas: 1,328 B)


def _rows(L, budget=tpk.POSITION_BUDGET):
    """Every row count `pack_batch` gives chunks of width L."""
    return [1 << k for k in range((budget // L).bit_length())]


def _b1_shapes():
    """(R, C) of every wide B1 round of the full-width branch: chunks of
    fewer than 2^20 positions, rounds at W, 5/8 W and W/2."""
    out = set()
    for W in WIDTHS:
        for R in _rows(W, 1 << 20):
            if R * W < 1 << 20:
                for num, den in ((1, 1), (5, 8), (1, 2)):
                    C = tm._round_width(W, num, den)
                    if C > mk.ROW_MAX_C:
                        out.add((R, C))
    return sorted(out)


def test_cluster_geometry_covers_every_shape():
    shapes = _b1_shapes()
    assert (32, 16384) in shapes and (8, 40960) in shapes and (8, 65536) in shapes
    for R, C in shapes:
        S, n = mk.cluster_geometry(R, C)
        assert S & (S - 1) == 0 and mk.WIDE_MIN_S <= S <= mk.ROW_MAX_C
        assert (n - 1) * S < C <= n * S, (R, C, S, n)
        assert n <= (kb.PORTABLE_N if C <= kb.PORTABLE_N * mk.ROW_MAX_C else mk.WIDE_MAX_N)
        assert mk.smem_bytes(S) + STATIC_SMEM <= kb.SMEM_MAX
        # the clusters fill the card wherever a portable cluster can
        if R * min(kb.PORTABLE_N, -(-C // mk.WIDE_MIN_S)) >= mk.SMS:
            assert R * n >= mk.SMS, (R, C, S, n)
        # the SMs to fill are the card's: fewer SMs, slices no narrower
        assert mk.cluster_geometry(R, C, mk.SMS // 2)[0] >= S
    assert mk.cluster_geometry(8, 8192) == (1024, 8)  # 64 SMs, not 8
    assert mk.cluster_geometry(8, 8192, 64) == (1024, 8)
    assert mk.cluster_geometry(8, 8192, 32) == (2048, 4)
    assert mk.cluster_geometry(32, 16384) == (2048, 8)
    with pytest.raises(ValueError):
        mk.cluster_geometry(1, mk.WIDE_MAX_C + 128)


def test_wide_layout_geometry_covers_every_width():
    for L in range(lk.ROW_MAX_L, lk.WIDE_MAX_L + 1, 128):
        S, n = lk.wide_geometry(L)
        assert S % lk.ROW_K == 0 and S <= lk.ROW_MAX_L and n <= kb.PORTABLE_N
        assert (n - 1) * S < L <= n * S, (L, S, n)
        assert lk.smem_bytes(S) + STATIC_SMEM <= kb.SMEM_MAX
    assert [lk.wide_geometry(L) for L in WIDTHS[1:]] == [(8192, 2), (4096, 8), (8192, 8)]
    assert lk.smem_bytes(8192) == 73744
    for L in (lk.ROW_MAX_L - 128, lk.ROW_MAX_L + 64, 2 * lk.WIDE_MAX_L):
        with pytest.raises(ValueError):
            lk.wide_geometry(L)
    for L in WIDTHS:  # every long chunk the engine makes goes to a kernel
        assert lk.supported((1, L)) and all(R * L <= tpk.POSITION_BUDGET for R in _rows(L))
    # a wider ASCII chunk goes to `layout_fused` too, whose cluster kernel
    # refuses it on the card (above); it never takes the plain boundaries there
    assert lk.supported((1, 2 * lk.WIDE_MAX_L))


def test_split_and_pack_match_jax():
    corpus = build_docs(3 * 100_000, 100_000)
    inputs = [d.encode() for d in corpus] + [
        b"x" * 140_000,  # no seam at all
        b"y" * 40_000 + b" z" + b"w" * 20_000,  # one seam, found by the wider search
        (b"ab " * 30_000)[:90_001],
        b"q " * 6_000,
        b"short doc",
    ]
    target = engine_base.CHUNK_TARGET
    pieces = []
    for data in inputs:
        got = tld.split_long(data, target)
        assert got == jl.split_long(data, target)
        assert b"".join(got) == data
        assert len(got) == 1 or all(len(c) <= 2 * target for c in got)
        pieces += got
    assert len(pieces) > len(inputs)
    got, want = tpk.pack_batch(pieces), jpk.pack_batch(pieces)
    assert len(got) == len(want)
    for (gb, gl, go), (wb, wl, wo) in zip(got, want):
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gl, wl)
        assert go == wo
    assert {c[0].shape[1] for c in got} >= {16384, 32768, 65536}


def test_long_documents_match_wheel(monkeypatch):
    calls = []
    branch = bpe_encode._branch_full

    def spy(ids0, *args):
        calls.append(tuple(ids0.shape))
        return branch(ids0, *args)

    monkeypatch.setattr(bpe_encode, "_branch_full", spy)
    docs = (build_docs(100_000, 40_000)[:1] + build_docs(60_000, 20_000)[1:2]
            + build_docs(30_000, 12_500)[:1] + dense_docs(1))
    assert [len(d.encode()) // 1000 for d in docs] == [40, 20, 12, 12]
    tok = Tokenizer.from_file(GPT2, device="cpu")
    engine_base.STATS.reset()
    got = [e.ids for e in tok.encode_batch_fast(docs)]
    want = [e.ids for e in WheelTokenizer.from_file(GPT2).encode_batch_fast(
        docs, add_special_tokens=True)]
    assert got == want
    # the dense document's words overflow the dedup buffer of its [1, 16384]
    # chunk (the 12 KB corpus document, not ASCII, has a chunk of its own),
    # so the chunk takes the full-width branch
    assert calls == [(1, 16384)]
    assert engine_base.STATS.snapshot()["bad_rows"] == 0
