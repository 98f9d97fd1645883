"""Entry points of the port: the flagship program and a multi-rank dry run;
the port's twin of the JAX package's `__graft_entry__.py`.

    python -m tokenizers_tpu_torch.entry                    # one card
    torchrun --nproc_per_node N -m tokenizers_tpu_torch.entry   # N cards

`entry()` returns the gpt2 encode program (pre-split and merge loop, no
word cache) over a packed uint8 batch on the card, and its arguments.
`dryrun_multichip(n)` starts n ranks (`runtime.spawn`) and runs JAX's
three multi-device checks in them against single-process results:
sharded BPE training equals the host trainer's merges at the alphabet
plus 128 on the corpus's first 1.5 MB; sharded Unigram EM on toy words
equals the unsharded pieces; a sharded gpt2 encode of 16 rows of 4 KB a
rank equals the host pipeline on every row it does not flag, and flags
at most an eighth of them.  Run under torchrun, `__main__` joins the
group torchrun made and runs the checks in it; alone, it runs `entry()`'s
program and a dry run of every card (NCCL: one rank a card).

It reads the gpt2 tokenizer and the corpus from the repo's
`tests/fixtures/`, so it runs only from a checkout of the repo, as
`__graft_entry__.py` does, not from an installed package.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

PKG = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(PKG)
FIXTURE = os.path.join(REPO, "tests", "fixtures", "gpt2", "tokenizer.json")
CORPUS = os.path.join(REPO, "tests", "fixtures", "corpus.txt")
DRYRUN_CORPUS_BYTES = 1536 * 1024
DRYRUN_ROWS_PER_RANK = 16
UNIGRAM_WORDS = "abc abd bcd abcd abc bc cd ab".split()


def entry(device=None):
    """(fn, example_args): the gpt2 encode program over a packed uint8
    byte batch on `device` (the card unless the caller asks for the CPU);
    fn(bytes_u8, lengths) -> (ids, ntok, row_bad)."""
    from .ops.bpe_encode import encode_core
    from .tokenizer import Tokenizer

    tok = Tokenizer.from_file(FIXTURE, device=device)
    eng = tok._get_device_engine()
    if eng is None:
        raise RuntimeError("the gpt2 fixture has no device engine")
    T = eng.tables

    def fn(bytes_u8, lengths):
        return encode_core(bytes_u8, lengths, T, cache=None, ascii_only=True,
                           boundary=T["boundary"], whole_word=T["whole_word"])

    docs = [b" The quick brown fox jumps over the lazy dog.", b" Hello world!"]
    L = 64
    buf = np.zeros((2, L), dtype=np.uint8)
    lengths = np.zeros((2,), dtype=np.int32)
    for i, d in enumerate(docs):
        buf[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lengths[i] = len(d)
    return fn, (torch.from_numpy(buf).to(eng.device), torch.from_numpy(lengths).to(eng.device))


def _corpus(nbytes: int) -> str:
    with open(CORPUS, encoding="utf-8") as f:
        return f.read()[:nbytes]


def _encode_docs(data: bytes, n: int, L: int):
    """n documents of at most L - 64 bytes, cut at char starts, laid end to
    end from the corpus (JAX's rule), and their packed [n, L] batch."""
    docs, off = [], 0
    for _ in range(n):
        c = data[off : off + L - 64]
        while c and (c[-1] & 0xC0) == 0x80:
            c = c[:-1]
        if c and c[-1] >= 0xC0:
            c = c[:-1]
        docs.append(c)
        off += max(len(c), 1)
    buf = np.zeros((n, L), dtype=np.uint8)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, d in enumerate(docs):
        buf[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lengths[i] = len(d)
    return docs, buf, lengths


def dryrun_checks(device=None) -> dict:
    """JAX's three dry-run checks on this rank of an initialized group, on
    `device`; raises on a mismatch.  Every rank must call it: the sharded
    runs come first, then rank 0 holds them against its single-process
    runs (every rank holds the same results: the trainer checks its
    merges across the ranks, and the encode is gathered).  Returns the
    rank's timings and counts."""
    from .models.bpe import BPE
    from .models.unigram import Unigram
    from .parallel import DistributedBpeTrainer, runtime
    from .pre_tokenizers.whitespace import Whitespace
    from .tokenizer import Tokenizer
    from .trainers import BpeTrainer, UnigramTrainer

    mesh = runtime.build_mesh(("data",))
    _group, rank, n = runtime.mesh_group(mesh)
    out = {"rank": rank, "ranks": n}

    # ---- the sharded runs
    text = _corpus(DRYRUN_CORPUS_BYTES)
    pt = Whitespace()
    wc: dict = {}
    for line in text.splitlines():
        for w in pt.pre_tokenize(line):
            wc[w] = wc.get(w, 0) + 1
    vocab_size = len({c for w in wc for c in w}) + 128
    t = time.perf_counter()
    model_dev = BPE({}, [])
    trainer = DistributedBpeTrainer(mesh=mesh, device=device, vocab_size=vocab_size)
    trainer.do_train(dict(wc), model_dev)
    out.update(bpe_train_s=time.perf_counter() - t, bpe_path=trainer.stats["path"],
               bpe_merges=len(model_dev.merges_list))

    uwords: dict = {}
    for w in UNIGRAM_WORDS:
        uwords[w] = uwords.get(w, 0) + 1

    def train_unigram(mesh_arg):
        m = Unigram([("<unk>", 0.0)], unk_id=0)
        tr = UnigramTrainer(vocab_size=12, special_tokens=["<unk>"], unk_token="<unk>",
                            device=device, mesh=mesh_arg)
        tr.words = dict(uwords)
        tr.train(m)
        return [p for p, _ in m.pieces]

    pieces_mesh = train_unigram(mesh)

    tok = Tokenizer.from_file(FIXTURE, device=device)
    eng = tok._get_device_engine()
    B, L = n * DRYRUN_ROWS_PER_RANK, 4096
    docs, buf, lengths = _encode_docs(text.encode("utf-8"), B, L)
    t = time.perf_counter()
    ids, ntok, bad = eng._program_sharded([(buf, lengths, list(range(B)))], mesh)[0]
    ids, ntok, bad = ids.cpu().numpy(), ntok.cpu().numpy(), bad.cpu().numpy()
    out.update(encode_s=time.perf_counter() - t, encode_rows=B, encode_flagged=int(bad.sum()))
    if rank:
        return out

    # ---- rank 0: against the single-process runs
    model_host = BpeTrainer(vocab_size=vocab_size)
    host = BPE({}, [])
    model_host.do_train(dict(wc), host)
    if len(model_dev.merges_list) < 128 or model_dev.merges_list != host.merges_list:
        raise AssertionError("sharded BPE training diverged from the host trainer")
    if pieces_mesh != train_unigram(None):
        raise AssertionError("sharded Unigram EM diverged from the unsharded EM")
    for r in range(B):
        if bad[r]:
            continue
        want = tok.encode_host(docs[r].decode("utf-8"), add_special_tokens=False).ids
        if ids[r, : ntok[r]].tolist() != want:
            raise AssertionError(f"sharded encode diverged from the host pipeline (row {r})")
    if int(bad.sum()) > B // 8:
        raise AssertionError(f"{int(bad.sum())} of {B} rows flagged, over B/8")
    return out


def _dryrun_rank(rank: int, world: int, device) -> dict:
    return dryrun_checks(device)


def dryrun_multichip(n_devices: int, backend: Optional[str] = None, device=None,
                     timeout_s: float = 900.0) -> list:
    """Spawn `n_devices` ranks (`backend`: NCCL on the card, gloo on the
    CPU, unless named) and run `dryrun_checks` in each; returns each
    rank's result, raises if a rank fails or hangs."""
    from .parallel import runtime

    return runtime.spawn(_dryrun_rank, n_devices, (device,), backend=backend, device=device,
                         timeout_s=timeout_s)


def main() -> int:
    from .parallel import runtime

    if runtime.initialize():  # under torchrun: this process is one rank
        try:
            print(f"rank {torch.distributed.get_rank()}: {dryrun_checks()}", flush=True)
        finally:
            runtime.shutdown()
        return 0
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [list(o.shape) for o in out], flush=True)
    print("dryrun ok:", dryrun_multichip(torch.cuda.device_count()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
