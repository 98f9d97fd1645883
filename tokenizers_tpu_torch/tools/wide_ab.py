"""Time the two wide kernels, B3 wide (`layout_fused_wide`) and B1 wide
(`merge_round_fused_wide`), at the long-document path's shapes, and B4
(`merge_round_standalone`) at its own: the one timer of these kernels,
used by `chip_smoke.py` and, run as a script, on any checkout, so that two
commits can be compared in turns within one call on one card.

    python tokenizers_tpu_torch/tools/wide_ab.py [--root DIR]

DIR (default: the checkout this file is in) holds the `tokenizers_tpu_torch`
whose kernels and tables are timed.  The inputs and the timer come from
this file's own checkout (`smoke_data.py` and `tools/timing.py`, loaded by
path under DIR's package), so every commit gets the same inputs and the
same clock:
- B3 wide on `smoke_data.corpus_chunk` at [128, 16384], [64, 32768] and
  [32, 65536];
- B1 wide at `smoke_data.full_width_states`, [8, 8192] and [32, 16384];
- B4 at the llama-3 path's unique buffer [74, 4096]
  (`smoke_data.llama3_unique_state`, its row kernel) and at those two
  full-width states (its cluster kernel).
Each kernel is first held bit for bit against its plain version on those
inputs.  Prints one JSON line: the root, the card's name and power limit,
and per kernel and shape the milliseconds a call (`timing.median_ms`, 20
calls), the bound and the plain version's time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
B3_SHAPES = ((128, 16384), (64, 32768), (32, 65536))


def _check(torch, name, got, want):
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise SystemExit(f"{name} differs from its plain version")


def wide_times(torch, lk, mk, eng, data, timing):
    """{kernel: {"RxC": {"ms", "plain_ms", "bound_ms"}}} of the wide
    kernels of the modules lk (`layout_kernels`) and mk (`merge_kernels`)
    on the inputs of `data` (`smoke_data`), timed by `timing`
    (`tools/timing`); each call is first held against the plain version."""
    out = {"layout_fused_wide": {}, "merge_round_fused_wide": {}}
    for B, L in B3_SHAPES:
        b, n, _inb = data.corpus_chunk(eng, (B, L))
        got = lk.layout_fused_wide(b, n)
        _check(torch, f"layout_fused_wide [{B}, {L}]", got, lk.layout_fused_plain(b, n))
        out["layout_fused_wide"][f"{B}x{L}"] = {
            "ms": timing.median_ms(lambda: lk.layout_fused_wide(b, n), 20),
            "plain_ms": timing.median_ms(lambda: lk.layout_fused_plain(b, n), 2),
            "bound_ms": timing.bound_ms(timing.nbytes(b, n, *got)),
        }
    for (R, C), args in data.full_width_states(eng).items():
        got = mk.merge_round_fused_wide(*args)
        _check(torch, f"merge_round_fused_wide [{R}, {C}]", got,
               mk.merge_round_fused_plain(*args))
        out["merge_round_fused_wide"][f"{R}x{C}"] = {
            "ms": timing.median_ms(lambda: mk.merge_round_fused_wide(*args), 20),
            "plain_ms": timing.median_ms(lambda: mk.merge_round_fused_plain(*args), 2),
            "bound_ms": timing.bound_ms(timing.nbytes(*args[:7], *got)
                                        + timing.table_bytes(args[0], args[3], *args[4:6],
                                                             *args[7:9])),
        }
    return out


def b4_times(torch, mk, eng, eng3, data, timing):
    """{"RxC": {"ms", "plain_ms", "bound_ms"}} of B4 (`merge_round_standalone`
    of the module mk) at the llama-3 unique buffer of the llama3 engine
    eng3 and at the full-width states of the gpt2 engine eng, inputs from
    `data`, timed by `timing`; each call is first held against the plain
    version."""
    T = eng3.tables
    states = [(data.llama3_unique_state(eng3), (T["merge_rows0"], T["merge_rows1"], T["seed"]))]
    states += [(args[:4], args[7:]) for args in data.full_width_states(eng).values()]
    out = {}
    for st, tabs in states:
        args = (*st, *tabs)
        R, C = st[0].shape
        got = mk.merge_round_standalone(*args)
        _check(torch, f"merge_round_standalone [{R}, {C}]", got,
               mk.merge_round_standalone_plain(*args))
        h0, h1, _nid = mk.keys_plain(st[0], tabs[0], tabs[2])
        out[f"{R}x{C}"] = {
            "ms": timing.median_ms(lambda: mk.merge_round_standalone(*args), 20),
            "plain_ms": timing.median_ms(lambda: mk.merge_round_standalone_plain(*args), 2),
            "bound_ms": timing.bound_ms(timing.nbytes(*st, *got)
                                        + timing.table_bytes(st[0], st[3], h0, h1,
                                                             *tabs[:2])),
        }
    return out


def _here(name, path):
    """This checkout's module at `path`, loaded as a module of the
    `tokenizers_tpu_torch` already imported, so that its relative imports
    resolve there."""
    spec = importlib.util.spec_from_file_location(f"tokenizers_tpu_torch._wide_ab_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(PKG))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("wide_ab: no CUDA device", file=sys.stderr)
        return 1
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops import layout_kernels as lk
    from tokenizers_tpu_torch.ops import merge_kernels as mk

    data = _here("smoke_data", os.path.join(PKG, "smoke_data.py"))
    timing = _here("timing", os.path.join(HERE, "timing.py"))
    eng = Tokenizer.from_file(data.GPT2_JSON)._get_device_engine()
    eng3 = Tokenizer.from_file(data.CONFIGS["llama3"])._get_device_engine()
    out = {"root": root, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]}
    out.update(wide_times(torch, lk, mk, eng, data, timing))
    out["merge_round_standalone"] = b4_times(torch, mk, eng, eng3, data, timing)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
