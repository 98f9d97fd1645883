"""Merge-round kernels B1, B2 and B4 (`csrc/merge_round.cu`) and their
plain versions; port of `tokenizers_tpu.ops.merge_pallas`.

* `keys` (B2, replaces `keys_pallas`): each position's next alive id
  within 2^k_steps, and both cuckoo slot hashes of (id, next id).  The
  kernel reads tiles of 1024 positions and the 512 after them, so it takes
  k_steps <= 9 (every caller passes FILL_K = 9) and raises beyond.
* `merge_round_fused` (B1, replaces `merge_round_fused`): one safe-set
  merge round from the carried keys, merge-table row reads included, then
  the next round's keys.  Returns (ids, own_l, own_r, f, h0, h1, nid).
  Two kernels from one body, chosen by row width: the row kernel for
  C <= ROW_MAX_C (the row held in one block's shared memory; every launch
  of the dedup branch) and the wide one (`merge_round_fused_wide`, the row
  split over a thread-block cluster, `cluster_geometry`) for wider rows,
  up to WIDE_MAX_C (the full-width branch).
* `merge_round_standalone` (B4, replaces `merge_round_pallas`): one round
  that computes its own keys and carries none out; word segments derive
  from wid.  Returns (ids, own_l, own_r, f).  B1's two kernels without
  carried keys, chosen by width as B1's (the cluster one up to
  WIDE_MAX_C; wider rows raise).  Only `bpe_merge2._round` calls it: the
  merge loops carry keys through B2 and B1.

A wrapper runs its plain version for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; there is no fallback.  Each
launch adds one to `LAUNCHES[name]`.
"""

from __future__ import annotations

import ctypes

import torch

from .bpe_merge2 import FILL_K, _seg_of, apply_round, fill_next, merge_round, select_rows
from . import kernel_build
from .kernel_build import (
    PORTABLE_N, ceil_div, check_cuda_int32, check_status, device_of, library,
)
from .merge_table import hash_pair

# every B1 (B4) launch counts in "merge_round_fused" ("merge_round_standalone"),
# the cluster kernel's also in "merge_round_fused_wide" ("merge_round_standalone_wide")
LAUNCHES = {"keys": 0, "merge_round_fused": 0, "merge_round_fused_wide": 0,
            "merge_round_standalone": 0, "merge_round_standalone_wide": 0}
ROW_MAX_C = 4096  # widest row of B1's row kernel, widest slice (csrc: ROW_MAX_C)
WIDE_MAX_C = 65536  # widest row of the wide kernel: packing.MAX_L // 2 (csrc: WIDE_MAX_C)
WIDE_MAX_N = 16  # CTAs a cluster may have; above 8 non-portable (csrc: WIDE_MAX_N)
WIDE_MIN_S = 512  # narrowest slice (csrc: WIDE_MIN_S)
SMS = 132  # SMs of an H100 SXM: `cluster_geometry`'s default; the wrapper asks the card
_SRC = "merge_round.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_READY = set()  # (library, device) where the kernels' shared memory is allowed


def load(defines=()):
    """The typed library of merge_round.cu, built with the macros `defines`
    (() is the shipped build)."""
    lib = library(_SRC, tuple(defines))
    if not getattr(lib, "_tt_typed", False):
        lib.tt_keys.argtypes = [_P] * 4 + [_I, _I, _I, _U, _U, _I, _P]
        lib.tt_keys.restype = _I
        lib.tt_merge_round.argtypes = [_P] * 16 + [_I] * 5 + [_U, _U, _I, _I, _P]
        lib.tt_merge_round.restype = _I
        lib.tt_merge_round_max_clusters.argtypes = [_I, _I, _I]
        lib.tt_merge_round_max_clusters.restype = _I
        for f in ("max_c", "max_n", "min_s"):
            getattr(lib, f"tt_merge_round_{f}").restype = _I
        lib.tt_merge_round_row.argtypes = [_P] * 16 + [_I, _I, _I, _U, _U, _I, _I, _P]
        lib.tt_merge_round_row.restype = _I
        lib.tt_merge_round_row_init.restype = _I
        lib.tt_merge_round_row_smem.argtypes = [_I]
        lib.tt_merge_round_row_smem.restype = ctypes.c_longlong
        lib.tt_merge_round_row_max_c.restype = _I
        if ((lib.tt_merge_round_row_max_c(), lib.tt_merge_round_max_c(),
             lib.tt_merge_round_max_n(), lib.tt_merge_round_min_s())
                != (ROW_MAX_C, WIDE_MAX_C, WIDE_MAX_N, WIDE_MIN_S)):
            raise RuntimeError("merge_round.cu and merge_kernels.py disagree on their limits")
        for S in (1001, WIDE_MIN_S, ROW_MAX_C):
            if lib.tt_merge_round_row_smem(S) != smem_bytes(S):
                raise RuntimeError("merge_round.cu and merge_kernels.py disagree on "
                                   "shared memory")
        lib._tt_typed = True
    return lib


def _mask(rows0) -> int:
    S = rows0.shape[0]
    if S & (S - 1):
        raise ValueError(f"merge table rows {S} is not a power of two")
    return S - 1


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def keys_plain(ids, rows0, seed, k_steps=FILL_K):
    """(h0, h1, nid) of every position: nid is the next alive id within
    2^k_steps (0 beyond), h0/h1 the slot hashes of (id, nid)."""
    (nid,), _ = fill_next([ids], ids >= 0, k_steps)
    mask = _mask(rows0)
    return hash_pair(ids, nid, seed, mask, 0), hash_pair(ids, nid, seed, mask, 1), nid


def merge_round_fused_plain(ids, own_l, own_r, wid, h0, h1, nid, rows0, rows1,
                            seed, k_steps=FILL_K):
    r_in, new_id, mcl_new, mcr_new = select_rows(ids, nid, h0, h1, rows0, rows1)
    ids2, ol2, or2, f = apply_round(
        ids, own_l, own_r, wid, _seg_of(wid), r_in, new_id, mcl_new, mcr_new,
        k_steps,
    )
    h0n, h1n, nidn = keys_plain(ids2, rows0, seed, k_steps)
    return ids2, ol2, or2, f, h0n, h1n, nidn


def keys(ids, rows0, seed, k_steps=FILL_K):
    if device_of("keys", ids) == "cpu":
        return keys_plain(ids, rows0, seed, k_steps)
    R, C = ids.shape
    check_cuda_int32("keys", (R, C), ids=ids)
    check_cuda_int32("keys", None, rows0=rows0)
    mask = _mask(rows0)
    h0, h1, nid = (torch.empty_like(ids) for _ in range(3))
    if ids.numel() == 0:
        return h0, h1, nid
    vec = C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (ids, h0, h1, nid))
    lib = load()
    check_status("keys", lib.tt_keys(
        ids.data_ptr(), h0.data_ptr(), h1.data_ptr(), nid.data_ptr(), R, C,
        1 << k_steps, int(seed) & 0xFFFFFFFF, mask, int(vec), _stream(ids),
    ))
    LAUNCHES["keys"] += 1  # after the check: a refused reach launches nothing
    return h0, h1, nid


def _row_init(lib, dev):
    """Allow the kernels of B1 and B4 their dynamic shared memory (and the
    cluster ones their non-portable clusters), once per library and
    device."""
    if (lib._name, dev.index) in _READY:
        return
    with torch.cuda.device(dev):
        st = lib.tt_merge_round_row_init()
    if st != 0:
        raise RuntimeError(
            "merge_round.cu: cudaFuncSetAttribute(MaxDynamicSharedMemorySize "
            f"{smem_bytes(ROW_MAX_C)}, NonPortableClusterSizeAllowed) failed with "
            f"cudaError {st}"
        )
    _READY.add((lib._name, dev.index))


def smem_bytes(S):
    """Dynamic shared memory of a B1 or B4 block holding S positions (csrc:
    row_smem_bytes): six padded int arrays, three striped ones and three
    byte arrays."""
    nth = ceil_div(ceil_div(S, 4), 32) * 32
    return (6 * (S + S // 4 + 1) + 3 * nth * 4) * 4 + 3 * S


def cluster_geometry(R, C, sms=SMS):
    """(S, n) of the cluster B1 or B4 for R rows of C positions on a card of `sms`
    SMs: slices of S (a power of two, WIDE_MIN_S .. ROW_MAX_C), n =
    ceil(C / S) CTAs a row.  The widest S whose R * n CTAs fill the SMs,
    with n at most PORTABLE_N; where no S does, the narrowest S with
    n <= PORTABLE_N; where C > PORTABLE_N * ROW_MAX_C, slices of ROW_MAX_C
    in a non-portable cluster.  Raises for rows it does not take."""
    if not 1 <= C <= WIDE_MAX_C:
        raise ValueError(f"the cluster merge round takes 1 <= C <= {WIDE_MAX_C}, got C = {C}")
    if C > PORTABLE_N * ROW_MAX_C:
        return ROW_MAX_C, ceil_div(C, ROW_MAX_C)
    fits = [S for S in (4096, 2048, 1024, 512) if ceil_div(C, S) <= PORTABLE_N]
    full = [S for S in fits if R * ceil_div(C, S) >= sms]
    S = full[0] if full else fits[-1]
    return S, ceil_div(C, S)


def max_clusters(S, n, dev=None, lib=None, carry=True):
    """Clusters of n CTAs with slices of S of B1's cluster kernel (B4's
    where not `carry`) the card holds at once (`kernel_build.max_clusters`);
    raises where there are none."""
    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None else dev
    lib = load() if lib is None else lib
    _row_init(lib, dev)
    return kernel_build.max_clusters(lib, "tt_merge_round_max_clusters", dev, S, n, int(carry))


def row_vec_flags(rows, f, rows0, rows1):
    """The row kernel's `vec_flags`: bit 0 when C % 8 == 0 and the [R, C]
    int32 arrays are 16-byte aligned (f 8-byte), bit 1 when the tables are."""
    row_vec = (f.shape[1] % 8 == 0 and f.data_ptr() % 8 == 0
               and all(t.data_ptr() % 16 == 0 for t in rows))
    table_vec = rows0.data_ptr() % 16 == 0 and rows1.data_ptr() % 16 == 0
    return int(row_vec) | 2 * int(table_vec)


def _launch(geometry, ins, keys, rows0, rows1, seed, k_steps=FILL_K, lib=None):
    """One launch of the round body on CUDA tensors ins = (ids, own_l,
    own_r, wid): B1 from keys = (h0, h1, nid), returning (ids, own_l,
    own_r, f, h0, h1, nid); B4 where keys is None, returning (ids, own_l,
    own_r, f).  The row kernel where geometry is None, else the cluster
    kernel in n slices of S, geometry = (S, n).  `lib` from `load` (None:
    the shipped build).  The wrappers call it with the geometry their width
    takes; `tools/cluster_sweep.py` and `tools/b1_phases.py` with another
    geometry or build."""
    carry = keys is not None
    name = "merge_round_fused" if carry else "merge_round_standalone"
    ins = ins + (tuple(keys) if carry else ())
    R, C = ins[0].shape
    check_cuda_int32(name, (R, C), **dict(zip(("ids", "own_l", "own_r", "wid", "h0", "h1",
                                               "nid"), ins)))
    check_cuda_int32(name, None, rows0=rows0, rows1=rows1)
    mask = _mask(rows0)
    if rows1.shape != rows0.shape or rows0.shape[1] != 8:
        raise ValueError(f"{name}: rows0/rows1 must both be [S, 8]")
    outs = [torch.empty_like(ins[0]) for _ in range(len(ins) - 1)]
    f = torch.empty((R, C), dtype=torch.bool, device=ins[0].device)
    result = (*outs[:3], f, *outs[3:])
    if ins[0].numel() == 0:
        return result
    if lib is None:
        lib = load()
    if geometry is None:
        _row_init(lib, ins[0].device)
        entry, shape = lib.tt_merge_round_row, ()
    else:
        max_clusters(*geometry, ins[0].device, lib, carry)
        entry, shape = lib.tt_merge_round, geometry
        LAUNCHES[f"{name}_wide"] += 1
    LAUNCHES[name] += 1
    ptr = [t.data_ptr() for t in ins]
    optr = [t.data_ptr() for t in outs]
    no_keys = [] if carry else [None] * 3
    check_status(name, entry(
        *ptr, *no_keys, rows0.data_ptr(), rows1.data_ptr(), *optr[:3], f.data_ptr(),
        *optr[3:], *no_keys, R, C, *shape, 1 << k_steps, int(seed) & 0xFFFFFFFF, mask,
        row_vec_flags(ins + tuple(outs), f, rows0, rows1), int(carry), _stream(ins[0]),
    ))
    return result


def _cluster(ids):
    """`cluster_geometry` of the CUDA rows ids [R, C] on their card."""
    R, C = ids.shape
    return cluster_geometry(R, C, torch.cuda.get_device_properties(ids.device)
                            .multi_processor_count)


def merge_round_fused(ids, own_l, own_r, wid, h0, h1, nid, rows0, rows1, seed,
                      k_steps=FILL_K):
    """B1: the row kernel for C <= ROW_MAX_C, the cluster kernel
    (`cluster_geometry`) up to WIDE_MAX_C; raises beyond."""
    if device_of("merge_round_fused", ids) == "cpu":
        return merge_round_fused_plain(
            ids, own_l, own_r, wid, h0, h1, nid, rows0, rows1, seed, k_steps
        )
    geometry = None if ids.shape[1] <= ROW_MAX_C else _cluster(ids)
    return _launch(geometry, (ids, own_l, own_r, wid), (h0, h1, nid), rows0, rows1, seed,
                   k_steps)


def merge_round_fused_wide(ids, own_l, own_r, wid, h0, h1, nid, rows0, rows1,
                           seed, k_steps=FILL_K):
    """B1 through the cluster kernel (`cluster_geometry`) at any width up to
    WIDE_MAX_C; `merge_round_fused` takes it for rows wider than ROW_MAX_C."""
    if device_of("merge_round_fused_wide", ids) == "cpu":
        return merge_round_fused_plain(
            ids, own_l, own_r, wid, h0, h1, nid, rows0, rows1, seed, k_steps
        )
    return _launch(_cluster(ids), (ids, own_l, own_r, wid), (h0, h1, nid), rows0, rows1,
                   seed, k_steps)


def merge_round_standalone_plain(ids, own_l, own_r, wid, rows0, rows1, seed,
                                 k_steps=FILL_K):
    """`bpe_merge2.merge_round` with the segments derived from wid."""
    return merge_round(ids, own_l, own_r, wid, _seg_of(wid), rows0, rows1,
                       seed, k_steps)


def merge_round_standalone(ids, own_l, own_r, wid, rows0, rows1, seed,
                           k_steps=FILL_K):
    """B4: the row kernel for C <= ROW_MAX_C, the cluster kernel
    (`cluster_geometry`) up to WIDE_MAX_C; raises beyond."""
    if device_of("merge_round_standalone", ids) == "cpu":
        return merge_round_standalone_plain(
            ids, own_l, own_r, wid, rows0, rows1, seed, k_steps
        )
    geometry = None if ids.shape[1] <= ROW_MAX_C else _cluster(ids)
    return _launch(geometry, (ids, own_l, own_r, wid), None, rows0, rows1, seed, k_steps)
