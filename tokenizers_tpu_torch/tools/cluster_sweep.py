"""Time both cluster kernels at the long-document path's shapes for every
slice size they take: the data behind `layout_kernels.wide_geometry` and
`merge_kernels.cluster_geometry`.

    python -m tokenizers_tpu_torch.tools.cluster_sweep

B3 (`layout_fused_wide`) on `smoke_data.corpus_chunk` at the shapes of
`wide_ab.B3_SHAPES` ([128, 16384], [64, 32768], [32, 65536]) in slices of
8192, 4096 and 2048; B1 (`merge_round_fused_wide`) at
`smoke_data.full_width_states` ([8, 8192], [32, 16384]) and at the offsets
path's `smoke_data.offsets_states` ([256, 8192], [256, 5120]) in slices of
4096, 2048, 1024 and 512 (clusters of at most 16 CTAs).  Each geometry runs
through the kernel's launch with that geometry given and is held bit for
bit against the plain version first.  Prints one JSON line per kernel and
shape: per slice size the cluster size, the resident clusters
(cudaOccupancyMaxActiveClusters) and the ms a call (`timing.median_ms`, 20
calls), with the card's name and power limit.
"""

from __future__ import annotations

import json

import torch

from .. import Tokenizer
from ..ops import layout_kernels as lk
from ..ops import merge_kernels as mk
from ..smoke_data import GPT2_JSON, corpus_chunk, full_width_states, offsets_states
from .b1_phases import _smi
from .timing import median_ms
from .wide_ab import B3_SHAPES


def _sweep(name, module, slices, width, run, plain):
    """Time run(S, n) at each slice size S, n = ceil(width / S)."""
    want = plain()
    out = {}
    for S in slices:
        n = -(-width // S)
        if n > module.WIDE_MAX_N:
            continue
        for g, w in zip(run(S, n), want):
            if not torch.equal(g, w):
                raise SystemExit(f"{name} S={S}: differs from its plain version")
        out[S] = {"cluster": n, "max_active_clusters": module.max_clusters(S, n),
                  "ms": median_ms(lambda: run(S, n), 20)}
    return out


def main() -> None:
    card = _smi("name,power.limit")
    eng = Tokenizer.from_file(GPT2_JSON)._get_device_engine()
    for B, L in B3_SHAPES:
        b, n, _inb = corpus_chunk(eng, (B, L))
        res = _sweep("layout_fused_wide", lk, (8192, 4096, 2048), L,
                     lambda S, nc: lk._layout_cluster(b, n, S, nc),
                     lambda: lk.layout_fused_plain(b, n))
        print(json.dumps({"kernel": "layout_fused_wide", "shape": [B, L],
                          "chosen": lk.wide_geometry(L), "by_slice": res, "card": card}),
              flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (R, C), args in {**full_width_states(eng), **offsets_states(eng)}.items():
        res = _sweep("merge_round_fused_wide", mk, (4096, 2048, 1024, 512), C,
                     lambda S, nc: mk._launch((S, nc), args[:4], args[4:7], *args[7:]),
                     lambda: mk.merge_round_fused_plain(*args))
        print(json.dumps({"kernel": "merge_round_fused_wide", "shape": [R, C],
                          "chosen": mk.cluster_geometry(R, C, sms), "by_slice": res,
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
