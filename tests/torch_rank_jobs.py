"""What the multi-rank tests run in each spawned rank (`runtime.spawn`).

This module imports torch and the port only, never JAX, so a rank starts
without it; the tests hold the ranks' results against JAX and the
unsharded port in the pytest process.  The jobs run on the CPU over gloo
(the card in the `gpu` tests), and return plain numpy and Python values.
"""

from __future__ import annotations

import sys

import numpy as np

from tokenizers_tpu_torch import Tokenizer, smoke_data
from tokenizers_tpu_torch.ops.packing import pack_batch
from tokenizers_tpu_torch.parallel import runtime, shard_encode_batch, shard_encode_batch_arrays

ENCODE_CONFIGS = ("gpt2", "llama3", "bert", "unigram_bf", "char_bpe", "wordlevel")
# settings of tests/test_distributed_bpe_trainer.py
TRAIN_SETTINGS = (
    {},
    {"min_frequency": 2, "special_tokens": ["<unk>", "<pad>"]},
    {"max_token_length": 3},
    {"continuing_subword_prefix": "##", "end_of_word_suffix": "</w>"},
)


def encode_inputs():
    """Corpus lines chosen by a seed, and edge cases: multi-byte chars,
    contractions, empty and space-led inputs, a word of 200 bytes (a
    Unigram patch record), a long repeated run (a second bucket)."""
    lines = [s for s in smoke_data.train_lines(1 << 18) if s]
    rng = np.random.default_rng(14)
    picked = [lines[i] for i in rng.choice(len(lines), 21, replace=False)]
    return picked + ["Hello world!", "序号123 héllo wörld", "y'all'll've", "", "  x",
                     "a" * 200 + " end", "don't stop " * 40]


def _arrays(chunks):
    return [(ids.cpu().numpy(), ntok.cpu().numpy(), bad.cpu().numpy(), list(orig))
            for ids, ntok, bad, orig in chunks]


def unsharded_chunks(eng, inputs, ranks: int):
    """The engine's mesh program on every whole chunk in one process, rows
    padded to `ranks` as a sharded run pads them: per chunk (ids, ntok,
    row_bad with the rows of patch records flagged, orig), numpy."""
    out = []
    for buf, lengths, orig in pack_batch([eng._prepare(s) for s in inputs]):
        rows = -(-buf.shape[0] // ranks) * ranks
        buf = np.pad(buf, ((0, rows - buf.shape[0]), (0, 0)))
        lengths = np.pad(lengths, (0, rows - lengths.shape[0]))
        res = eng._program_mesh(buf, lengths, rows)
        bad = res[2].clone()
        if len(res) > 3:
            ptab, n = res[3]
            bad[ptab[:int(n), 0].long()] = True
        out.append((res[0].cpu().numpy(), res[1].cpu().numpy(), bad.cpu().numpy(), list(orig)))
    return out


def encode_job(mesh, device, names=ENCODE_CONFIGS) -> dict:
    """Per config: `shard_encode_batch_arrays` and `shard_encode_batch`
    over `mesh`, and `encode_batch_fast` with `mesh` as the default."""
    inputs = encode_inputs()
    out = {}
    for name in names:
        tok = Tokenizer.from_str(smoke_data.config_json(name), device=device)
        eng = tok._get_device_engine()
        res = {"arrays": _arrays(shard_encode_batch_arrays(eng, inputs, mesh)),
               "lists": shard_encode_batch(eng, inputs, mesh)}
        runtime.set_default_mesh(mesh)
        try:
            res["fast"] = [e.ids for e in tok.encode_batch_fast(inputs)]
        finally:
            runtime.set_default_mesh(None)
        out[name] = res
    return out


def bpe_job(mesh, device, word_counts, vocab_size) -> list:
    """Per setting of TRAIN_SETTINGS: (merges, vocab, path) of the dense
    trainer through `DistributedBpeTrainer(mesh=...)` and of the per-round
    trainer over the same mesh."""
    from tokenizers_tpu_torch.models.bpe import BPE
    from tokenizers_tpu_torch.parallel.bpe_train import (
        DistributedBpeTrainer, check_replicated, train_per_round,
    )
    from tokenizers_tpu_torch.trainers import BpeTrainer

    out = []
    for kw in TRAIN_SETTINGS:
        m = BPE({}, [])
        tr = DistributedBpeTrainer(mesh=mesh, device=device, vocab_size=vocab_size, **kw)
        tr.do_train(dict(word_counts), m)
        dense = (m.merges_list, m.vocab, tr.stats["path"])
        cfg = BpeTrainer(vocab_size=vocab_size, device=device, **kw)
        w2i, i2w, words, counts = cfg.prepare(dict(word_counts))
        merges = train_per_round(cfg, w2i, i2w, words, counts, device, cfg.stats,
                                 runtime.mesh_group(mesh))
        check_replicated(merges, runtime.mesh_group(mesh)[0], device)
        m2 = BPE({}, [])
        cfg.finalize_model(m2, w2i, i2w, merges)
        out.append({"dense": dense, "per_round": (m2.merges_list, m2.vocab, cfg.stats["path"])})
    return out


def em_job(mesh, device, sentences, pieces) -> dict:
    """`DeviceEm` over `mesh`: its chunks' shapes, one E-step and one
    Viterbi-frequency pass of the Unigram model of `pieces`."""
    from tokenizers_tpu_torch.models.unigram import Unigram
    from tokenizers_tpu_torch.ops.unigram_em_step import DeviceEm

    model = Unigram(pieces, unk_id=0)
    dev = DeviceEm(sentences, device, mesh)
    expected, z, ntok = dev.e_step(model)
    return {"chunks": dev.stats["chunks"], "expected": expected, "z": z, "ntok": ntok,
            "freq": dev.viterbi_freq(model)}


def parallel_job(rank: int, world: int, jobs: dict, device: str = "cpu") -> dict:
    """The jobs named in `jobs` ({"encode": (), "bpe": (word_counts,
    vocab_size), "em": (sentences, pieces)}) over a 1-D mesh of every rank
    on `device`, and the mesh's shapes in 1-D and 2-D; gpt2's sharded
    encode once more over the 2-D mesh."""
    mesh = runtime.build_mesh(("data",))
    mesh2 = runtime.build_mesh(("hosts", "data"))
    out = {"rank": rank, "mesh": (tuple(mesh.shape), mesh.mesh_dim_names),
           "mesh2": (tuple(mesh2.shape), mesh2.mesh_dim_names)}
    for name, args in jobs.items():
        out[name] = {"encode": encode_job, "bpe": bpe_job, "em": em_job}[name](mesh, device,
                                                                             *args)
    if "encode" in jobs:
        out["encode_2d"] = encode_job(mesh2, device, ("gpt2",))["gpt2"]
    out["modules"] = sorted({m.split(".")[0] for m in sys.modules})
    return out


def hang_job(rank: int, world: int) -> int:
    """Rank 1 never returns."""
    import time

    if rank == 1:
        time.sleep(3600)
    return rank


def fail_job(rank: int, world: int) -> int:
    """Rank 1 raises."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank
