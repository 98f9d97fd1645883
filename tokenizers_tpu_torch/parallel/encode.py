"""Data-parallel batch encode over the ranks of a mesh; port of
`tokenizers_tpu.parallel.encode`.

SPMD: every rank is given the same inputs, packs them into the same
chunks, and runs its contiguous block of each chunk's rows (rows padded
to a multiple of the ranks, as the JAX package pads before its
`NamedSharding(P("data"))` split) through the engine's mesh program
(`DeviceEngineBase._program_sharded`); ids, token counts and row flags
are gathered in rank order, so every rank returns the whole batch.
"""

from __future__ import annotations

from typing import List, Optional

from ..ops.packing import pack_batch


def shard_encode_batch_arrays(engine, inputs: List[str], mesh):
    """Per packed chunk (ids, ntok, row_bad, orig): the engine's mesh
    program over `mesh` (a `DeviceMesh`), whole on every rank.  Rows with
    per-word patch records (Unigram) are flagged too: they lack the
    host's ids of those words.  Inputs are prepared as the engine's
    program takes them; an input over the program's widest row raises
    ValueError (`encode_batch_arrays` cuts long inputs into pieces)."""
    byte_strings = [engine._prepare(s) for s in inputs]
    limit = engine._piece_max(False)
    for i, b in enumerate(byte_strings):
        if len(b) > limit:
            raise ValueError(f"input {i} is {len(b)} bytes, over the program's {limit}")
    chunks = pack_batch(byte_strings)
    out = []
    for (_buf, _lens, orig), res in zip(chunks, engine._program_sharded(chunks, mesh)):
        ids, ntok, row_bad = res[:3]
        if len(res) > 3:
            recs, n = res[3]
            row_bad = row_bad.clone()
            row_bad[recs[:n, 0].long()] = True
        out.append((ids, ntok, row_bad, orig))
    return out


def shard_encode_batch(engine, inputs: List[str], mesh) -> List[List[int]]:
    """Mesh-sharded encode returning each input's id list as the program
    gave it (the conformance helper of the JAX package: a flagged row's
    ids are the program's, which the host would replace)."""
    results: List[Optional[List[int]]] = [None] * len(inputs)
    for ids, ntok, _bad, orig in shard_encode_batch_arrays(engine, inputs, mesh):
        ids, ntok = ids.cpu().numpy(), ntok.cpu().numpy()
        for r, i in enumerate(orig):
            results[i] = ids[r, : ntok[r]].tolist()
    return results
