"""Monotone routing: stable compaction and spreading to increasing targets.

Port of `tokenizers_tpu.ops.route` by its semantics.  The JAX package
builds these moves from butterfly networks of shifts and selects, because
scatters cost per index on the TPU (a Mosaic/XLA:TPU workaround, not a
Pallas kernel).  Here each move is a stable cumulative sum plus one
scatter, which is what a GPU does well.

Conventions kept from the JAX package:

* `wrap=False`: each row of a [R, C] array is its own stream; counts are
  int32[R].  `wrap=True`: the array is ONE row-major stream; the count is a
  0-d int32 tensor.
* `fills`: the value of every slot that receives no element.
* `n_out`: output columns per row (`wrap=False`) or total flat elements
  (`wrap=True`, a multiple of C).  Elements whose target is >= n_out are
  dropped.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _flat_pos(shape, wrap, device):
    R, C = shape
    col = torch.arange(C, dtype=torch.int64, device=device).expand(R, C)
    if not wrap:
        return col
    row = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    return row * C + col


def _scatter(vals, fills, rows, cols, out_shape):
    """New arrays of `out_shape` holding `fills`, with vals[k] written at
    (rows[k], cols[k])."""
    outs = []
    for v, f in zip(vals, fills):
        o = torch.full(out_shape, f, dtype=v.dtype, device=v.device)
        o[rows, cols] = v
        outs.append(o)
    return tuple(outs)


def compact_left(vals: Sequence[torch.Tensor], live: torch.Tensor, fills,
                 wrap: bool = False):
    """Stable left-pack of the live elements of [R, C] arrays.
    Returns (vals', count)."""
    R, C = live.shape
    if wrap:
        cnt = torch.cumsum(live.reshape(-1).to(torch.int64), 0).reshape(R, C)
    else:
        cnt = torch.cumsum(live.to(torch.int64), 1)
    dest = (cnt - 1)[live]
    if wrap:
        rows, cols = dest // C, dest % C
    else:
        rows = torch.arange(R, device=live.device)[:, None].expand(R, C)[live]
        cols = dest
    out = _scatter([v[live] for v in vals], fills, rows, cols, (R, C))
    count = cnt[-1, -1] if wrap else cnt[:, -1]
    return out, count.to(torch.int32)


def spread_right(vals: Sequence[torch.Tensor], count, tgt: torch.Tensor, fills,
                 wrap: bool = False, n_out=None):
    """Move the dense prefix (flat positions 0..count-1) to strictly
    increasing targets `tgt` (read at the dense positions).
    Returns (vals', live')."""
    R, C = tgt.shape
    pos = _flat_pos((R, C), wrap, tgt.device)
    if wrap:
        live = pos < count
    else:
        live = pos < (count[:, None] if count.dim() == 1 else count)
    return _place(vals, live, tgt, fills, wrap, n_out)


def route_to(vals: Sequence[torch.Tensor], live: torch.Tensor, tgt: torch.Tensor,
             fills, wrap: bool = False, n_out=None):
    """Route live elements (any positions) to strictly increasing targets
    `tgt` (read at live positions).  Equal to `spread_right` after
    `compact_left`, done as one scatter.  Returns (vals', live')."""
    return _place(vals, live, tgt, fills, wrap, n_out)


def scatter_flat(vals, live, tgt, fills, n_out):
    """Row-major form of the wrap move for any n_out: flat arrays of
    n_out elements holding vals at the live elements' targets (targets
    >= n_out dropped).  Returns (vals', live') flat."""
    t = tgt.reshape(-1).to(torch.int64)
    keep = live.reshape(-1) & (t < n_out)
    tk = t[keep]
    outs = []
    for v, f in zip(vals, fills):
        o = torch.full((n_out,), f, dtype=v.dtype, device=v.device)
        o[tk] = v.reshape(-1)[keep]
        outs.append(o)
    lv = torch.zeros((n_out,), dtype=torch.bool, device=tgt.device)
    lv[tk] = True
    return tuple(outs), lv


def _place(vals, live, tgt, fills, wrap, n_out):
    R, C = tgt.shape
    if n_out is None:
        n_out = R * C if wrap else C
    if wrap:
        assert n_out % C == 0, "wrap-mode n_out must be a multiple of C"
        out, lv = scatter_flat(vals, live, tgt, fills, n_out)
        shape = (n_out // C, C)
        return tuple(o.reshape(shape) for o in out), lv.reshape(shape)
    t = tgt.to(torch.int64)
    keep = live & (t < n_out)
    rows = torch.arange(R, device=tgt.device)[:, None].expand(R, C)[keep]
    cols = t[keep]
    out = _scatter([v[keep] for v in vals], fills, rows, cols, (R, n_out))
    lv = torch.zeros((R, n_out), dtype=torch.bool, device=tgt.device)
    lv[rows, cols] = True
    return out, lv
