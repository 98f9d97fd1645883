#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`tokenizers_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels of `tokenizers_tpu_torch/csrc/` with nvcc
   (one process per source, all at once) and prints what ptxas reported
   (kept beside each library, so a reused build prints it too).
2. Holds each kernel of the gpt2 path bit for bit against its plain
   PyTorch version on the card, at that path's shapes: the layout kernel
   (B3) on a [256, 8192] corpus chunk, and on the adversarial rows of
   `smoke_data.adversarial_layout_case` at widths 256-8192 (its row
   kernel) and 16384-65536 (its cluster kernel, the long documents');
   the keys (B2) and merge-round (B1)
   kernels on the first rounds of that chunk's real [74, 4096] unique
   buffer, then at the compacted widths 2560 and 2048 and on a
   ladder-sized [37, 2048] slice, B2 also on every adversarial layout
   of B1's below.  B1 has two kernels, chosen by width:
   the row kernel (C <= 4096) runs there, and both are held on the
   adversarial layouts of `smoke_data.adversarial_case` (the row kernel
   at widths 64-4096, the cluster one at 5120-65536, where its cluster of
   16 CTAs is non-portable); the cluster one also on the chunk's first 8
   rows at [8, 8192] and at its 5/8 width.
   Times each kernel and its plain version with CUDA events, the B1 row
   kernel against the cluster one in turns at [74, 4096] and [74, 2048],
   and B2 on one 1024-position tile beside an empty kernel (its launch and
   ramp).
3. Drives the gpt2 path: `Tokenizer.encode_batch_fast` on 512 8 KB corpus
   documents (two [256, 8192] ASCII chunks and one [32, 8192] chunk of the
   documents with multi-byte characters), cold and then on the warm word
   cache, with every kernel's launch count set to 0 just before the cold
   run and read just after it.  Every document's ids must match its
   committed SHA-256 (`tokenizers_tpu_torch/data/`).
4. B4, the standalone merge round (B1's two kernels without carried
   keys, chosen by width as B1's): at the llama-3 path's unique-buffer
   shape (its first [256, 8192] ASCII chunk, whole-word bypass applied),
   then at the widths 2560 and 2048 and a [37, 2048] slice, on the
   adversarial layouts at widths 64-65536 (the row kernel to 4096, the
   cluster one beyond, 16 non-portable CTAs at 65536) and at the
   full-width states [8, 8192] and [32, 16384], B4 must equal its plain
   version and the first four outputs of B2 then B1, and B2 and B1 there
   must equal their plain versions (all outputs).  Then the one entry
   that reaches it, `bpe_merge2._round`, merges the llama-3 buffer (row
   kernel) and the [32, 16384] state (cluster kernel) to completion
   (counts set to 0 first), launching B4 once a round, and must end where
   the B2/B1 loop ends.  Times B4 at [74, 4096], [8, 8192] and
   [32, 16384] (`tools/wide_ab.b4_times`).
5. Drives the llama3 path the same way as 3, on the same documents with
   the llama3_128k tokenizer: cold launches of B1 and B2 above 0 and of
   B3 at 0 (the layout kernel is gpt2's), every digest matched.  The
   cold launch counts of both 8 KB paths must be those in EIGHT_KB_COLD.
6. The gpt2 long documents (`smoke_data.long_parts`): the cluster
   kernels at this path's real states, bit for bit against their plain
   versions: B3 on a [64, 32768] chunk of 32 KB documents and on the
   [8, 16384] chunk of the 12 KB dense documents, B1 on the latter's
   full-width branch at 16384, 10240 and 8192 (two rounds each).  Then
   drives `encode_batch_fast` on (a) the 32 KB and 100 KB documents, (b)
   the 12 KB dense ones and (c) 16 KB dense ones, each cold and cached,
   counts set to 0 before each run, every document against
   `data/gpt2_long_digests.json`: (a) must launch the cluster B3, (b) and
   (c) the cluster B1; (c)'s rows all overflow the 5/8 width and go to the
   host, and its flagged share is printed.  Times the cluster B3 at
   [128, 16384], [64, 32768] and [32, 65536] and the cluster B1 at
   [8, 8192] and the dense full-width state [32, 16384]
   (`tools/wide_ab.wide_times`), with each one's slice, cluster size,
   shared memory and resident clusters (cudaOccupancyMaxActiveClusters).
7. The offsets path (`Tokenizer.encode_batch`: ids, char offsets,
   token strings, word ids; no dedup and no word cache, every chunk
   merged at full width): first the cluster B1 timed at this path's new
   shapes, the full-width state of the first [256, 8192] chunk and its
   5/8 width [256, 5120]; then
   `encode_batch` on the 512 8 KB documents with the gpt2 and the
   llama3_128k tokenizer and on the long documents (a) with gpt2, counts
   set to 0 just before each run, every document against its committed
   offsets digest (`data/*_offsets_digests.json`); each run once more
   with every launch of B3, B2 and B1 held bit for bit against its plain
   version on the inputs the path gave it (`checked_run`: every shape of
   the path, the compacted widths and ladder rungs included, tallied by
   kernel and shape), its launches equal to the counted run's; and
   `encode_batch_byte_offsets` on the first 64 documents of each
   tokenizer against the port's own host path with byte offsets.
8. The bert WordPiece path (`bert_path`), on no kernel of `csrc/`: the
   bert tokenizer built (its tables timed), `encode_batch_fast` on the
   512 8 KB documents (two [256, 8192] ASCII chunks on the dedup program,
   one [32, 8192] chunk on the dense program) and on the long documents
   (a), each cold and cached, and `encode_batch` on both, every document
   against `data/bert*_digests.json`; `encode_batch_byte_offsets` on 64
   documents against the host path; every B1-B4 launch count must stay 0
   over the phase.  One more cold pass times the unique-word encoder (the
   longest-match sweep and the doubling) and the program with CUDA events.
9. The WordLevel and char-level BPE paths (`char_level_path`), on the
   frozen tokenizers of `smoke_data.CHAR_CONFIGS` and the Llama-2 SPM
   shape derived from sp_bpe (`smoke_data.spm_bf_json`): each built (its
   tables timed); `encode_batch_fast` cold on the 512 8 KB documents with
   char_bpe (BertNormalizer, BertPreTokenizer, `</w>`), sp_bpe (NFKC,
   Metaspace, `fuse_unk`: rows of 2L + 4 = 16,388 positions after the
   expansion on the card), spm_bf (no pre-tokenizer, byte fallback) and
   wordlevel, and with sp_bpe on the long documents (a) (pieces of at
   most 16 KB); `encode_batch` on the 8 KB documents with char_bpe,
   sp_bpe and wordlevel; every document against its committed digest
   (`data/{name}*_digests.json`), byte offsets on 64 documents against
   the host path; counts set to 0 before each run and read after.  Each
   char-level BPE run again under `checked_run`: every B2 and B1 launch
   bit for bit against its plain version on the path's own inputs,
   tallied by kernel and shape (sp_bpe's [256, 16388], its 5/8 and 1/2
   widths among them), its launches equal to the counted run's; the cold
   launches of the 8 KB runs must equal CHAR_COLD; the WordLevel runs
   launch no kernel, and no merge row is wider than 65,536.  The cluster
   B1 is timed at sp_bpe's first state [256, 16388] on the path's inputs.
10. The Unigram (SentencePiece) path (`unigram_path`), on no kernel of
   `csrc/` (torch ops, as the JAX package runs it in plain XLA): the
   `unigram` and `unigram_bf` fixtures built (tables timed);
   `encode_batch_fast` with unigram on the 512 8 KB documents cold and
   cached (the deduplicated compensated-f32 Viterbi with the word cache,
   near ties and words over 128 bytes spliced from the host as per-word
   patch records) and cold on the long documents (a) with a new
   tokenizer, `encode_batch` on the 8 KB documents (the packed f64
   program); with unigram_bf `encode_batch_fast` cold and `encode_batch`;
   every document against `data/unigram*_digests.json`, byte offsets on
   64 documents against the host path; every B1-B4 count 0 over the
   phase.  One more cold pass times the program and the unique encoder's
   forward scan and backtrack with CUDA events.
11. Training (`train_path`), on no kernel of `csrc/` (torch ops, as the
   JAX package trains in plain XLA): BPE on `bench.py`'s `train` config
   (1 MB, vocab 512, the dense whole-loop trainer) and on the whole
   corpus at 16,000 (the dense trainer's widest count matrix), both
   against the wheel's merges and vocab digests (`data/
   train_digests.json`); the SentencePiece BPE recipe at 30,000 through
   `Tokenizer.train` (the per-round registry trainer), equal to the frozen
   `data/sp_bpe.json`, whose trained tokenizer then encodes the 8 KB
   documents against the sp_bpe digests with the frozen one's cold
   launches; WordPiece at 2,000 against the port's host BpeTrainer;
   WordLevel against `data/wordlevel.json`.  Every B1-B4 count stays 0
   over the training runs; each run prints its path, feed, packing and
   device-loop seconds, merges per second, host reads per merge (counted
   by the trainer) and host syncs per merge (measured: CUDA sync-debug
   warnings) and peak memory.
12. Unigram training (`unigram_train_path`), on no kernel of `csrc/`
   (torch ops, as the JAX package runs its E-step in plain XLA): the
   `unigram` fixture's recipe (`smoke_data.recipe_json`) trained by
   `UnigramTrainer(vocab_size=8000, special_tokens=["<unk>"],
   unk_token="<unk>")` through `Tokenizer.train_from_iterator` on the
   lines of the corpus's first 1 MB, the E-step and the pruning's Viterbi
   frequencies on the card: its pieces must be the wheel's
   (`data/unigram_train.json`), each score within rel 1e-6 / abs 1.6e-3
   (`tests/test_unigram_trainer.py`'s tolerance); no pass may lack a device
   table.  The seed model's first E-step and Viterbi-frequency pass on
   the card must equal the host lattices on a seeded sample of 2,000
   sentences from every bucket plus 4 sentences over 512 bytes (the host
   route): expected counts and z within 1e-12 relative, token counts and
   frequencies exact; a second E-step of the seed model on every
   sentence must be bit-equal to the first.  The trained tokenizer then
   encodes the 512 8 KB documents on the card, every document's ids equal
   to its own host pipeline's.  Prints seeding, E-step, Viterbi, pruning,
   M-step and total seconds, EM rounds, host sentences, syncs an E-step
   (CUDA sync-debug warnings) and peak memory; B1-B4 counts stay 0.
13. Decode (`decode_path`, host only): `decode_batch` of the ids every
   8 KB run of phases 3-10 produced on the card (gpt2, llama3_128k, bert,
   unigram, unigram_bf, char_bpe, sp_bpe, spm_bf, wordlevel), with and
   without `skip_special_tokens`, every text against the wheel's
   (`data/decode_digests.json`), and `decode_stream` over the first 32
   documents of gpt2 and unigram_bf against the wheel's stream; B1-B4
   counts stay 0.
14. The multi-rank runtime (`multirank_path`): (a) a one-rank NCCL group
   in this process: `shard_encode_batch_arrays` of the 512 8 KB
   documents with gpt2 (every row it does not flag against its digest,
   the flagged share printed), both BPE trainers' mesh paths on phase
   11's config (a) against the wheel's digests, `DeviceEm` over the mesh
   bit-equal to the unsharded one on the `unigram` fixture's model, and
   `entry()`'s program, then `destroy_process_group`; the B3, B2 and B1
   launches of the sharded encode and of `entry()`'s program, each
   counted from 0 just before it and read just after (reported apart),
   are held bit for bit against their plain versions in a checked second
   run of each; (b) two gloo ranks
   sharing the card (`multirank_rank`, spawned): with the default mesh of
   both, `encode_batch_fast` of the 512 documents with gpt2,
   llama3_128k, bert, unigram and char_bpe, each rank's whole list
   against every digest, every B3, B2 and B1 launch counted per rank and
   held bit for bit against its plain version in a checked second run;
   phase 11's config (a) on the dense and the per-round trainer and
   phase 12's Unigram setting, against the single-rank results (the
   wheel's; a swapped piece must be a near tie, and is named); (c)
   `dryrun_multichip(2, backend="gloo")`'s two ranks, each under
   `checked_run` (`multirank_dryrun_rank`), so that every launch of its
   sharded encode is held against its plain version.  Every run's seconds, its rank
   count and backend are printed beside the card's name and power limit.
15. The Tokenizer's full surface and the recipes (`recipes_path`): (a)
   the gpt2 fixture's model written as `vocab.json` and `merges.txt` by
   `BPE.save`, read by `ByteLevelBPETokenizer.from_file`, with
   `<|endoftext|>` special and `smoke_data.RECIPE_TOKEN` (lstrip, rstrip;
   in no document) added, truncation at 1,024 with stride 128 and padding
   to a multiple of 8: `encode_batch_fast` and `encode_batch` on the 512
   8 KB documents and `RECIPE_EXTRA` (they hold the added tokens: the
   host path), then `to_str`, `from_str` on the card and
   `encode_batch_fast` again, each cold, counts set to 0 just before and
   read just after, every input against `data/recipes_digests.json` (the
   wheel's same recipe and settings: ids, type ids, attention mask,
   overflowing ids; offsets and word ids on the offsets path), B3, B2 and
   B1 launched and each run repeated on a tokenizer in the same state
   with every launch held bit for bit against its plain version
   (`checked_again`); (b) `to_str` of every tokenizer phases 3-11 load or
   train (the nine configs of `smoke_data.TO_STR_CONFIGS`, phase 11's
   trained sp_bpe and WordLevel) against the wheel's `to_str` digest of
   its source, `from_str` on the card and a cold `encode_batch_fast` of
   the 8 KB documents under `checked_run` against that config's digests;
   (c) `BertWordPieceTokenizer` on the bert fixture's `vocab.txt` written
   by `WordPiece.save`: `encode_batch` and `encode_batch_fast` of 128
   pairs of the documents' first 2,048 chars, `longest_first` truncation
   at 512 and padding to 512, against the wheel's digests, no kernel of
   `csrc/` launched; (d) `ByteLevelBPETokenizer.train_from_iterator` on
   the corpus's first 1 MB at vocab 8,000 with `<|endoftext|>` (the dense
   trainer, no kernel launched): its `to_str` against the wheel's digest,
   then `encode_batch_fast` of the 512 documents cold against the wheel's
   trained recipe's digests, B3, B2 and B1 launched and held as in (a).
   Prints the phase's seconds with the card's name and power limit.
16. The general host pipeline and the byte-level engine's new pipelines
   (`host_pipelines_path`, the six of `smoke_data.host_pipelines()`):
   (a) gpt2_lower, qwen2_shape, char_bpe_punct and wordlevel_scripts,
   which no engine takes (`_get_device_engine()` must be None):
   `encode_batch_fast` and `encode_batch` on the first 16 8 KB documents,
   every document against `data/host_pipelines_digests.json` (the
   wheel's ids and `offsets_digest`s), no kernel of `csrc/` launched,
   each pipeline's seconds and MB/s printed; (b) gpt2_ignore_merges (B3,
   B2, B1 with the whole-word bypass) and llama3_prefix (B2, B1; the
   prefix spaces put on the device) on the 512 documents through
   `drive_path`, cold then cached, against the same file, each kernel of
   the pipeline launched, and the cold run once more on a new tokenizer
   under `checked_again` (every launch bit for bit against its plain
   version); (c) `to_str` -> `from_str` of all six, `to_str` given back,
   and one cold `encode_batch_fast` against the digests.  Adds each
   kernel's `host_pipelines_launches` (the (b) cold runs).
17. The last host modules (`host_modules_path`): (a) `t5_shape`
   (`smoke_data.host_pipelines()`: the unigram fixture behind
   Sequence[Precompiled(`data/charsmap_nfkc.bin`), Replace]; no engine
   takes it) on the first 16 8 KB documents, `encode_batch_fast` and
   `encode_batch` against `data/host_pipelines_digests.json`, no kernel of
   `csrc/` launched, run by default, then with TOKENIZERS_PARALLELISM
   false and true (the host pool, after CUDA is initialised; before the
   true run the pool's workers are up and hold the tokenizer, and one of
   them must take a chunk): the two results equal, each run's MB/s and
   the pool's start-up time printed; `decode_batch` of gpt2's first 64
   and 512 ids, serial and on the pool, timed; `decode_batch` of phase
   13's gpt2 and llama3_128k ids with TOKENIZERS_PARALLELISM true against
   `data/decode_digests.json`; (b) the C ABI: `build_c_api`,
   `tests/c_api_torch_driver.c` and `tests/c_api_driver.c` built against
   it; the first, through `tokenizers_create` (the card) and
   `tokenizers_encode_batch`, encodes the 512 gpt2 8 KB documents in its
   embedded interpreter against `data/gpt2_digests.json` and reports that
   interpreter's launch counts (B3, B2 and B1 must launch); the second,
   unchanged, fails under `CUDA_VISIBLE_DEVICES=` (no CPU fallback);
   (c) a trained Unigram through `to_str` and `from_str`: the model of
   `data/unigram_train.json` held exactly gives the wheel's ids of the 512
   documents on the card, in memory and after the round trip
   (`data/unigram_round_trip_digests.json`, the wheel's own round trip,
   which moves some documents); then phase 12's model (a second round
   trip gives the same `to_str`): each score read back as serde_json
   parses what `to_str` wrote, pieces and scores the wheel's within the
   training tolerance, and a cold `encode_batch_fast` of the 512
   documents on the card, no kernel launched, equal to its host
   pipeline's ids (run on the host pool); the documents whose ids moved
   off the trained model's are counted.  Adds each kernel's
   `c_abi_launches` (the (b) driver's counts).
18. The JAX package's public API (`jax_api_path`), written only in its
   names on `import tokenizers_tpu_torch as tt`, with no device named (the
   card by default): (a) `tt.Tokenizer(tt.models.BPE(unk_token=None))` with
   `tt.pre_tokenizers.ByteLevel` and `tt.decoders.ByteLevel`, trained by
   `tt.trainers.BpeTrainer` (vocab 8,000, `tt.AddedToken("<|endoftext|>",
   special=True)`) through `train_from_iterator` on the corpus's first
   256 KB (`smoke_data.jax_api_tokenizer`): no kernel of `csrc/`
   launched, its `to_str` equal to the same phase run on the CPU
   (`data/jax_api_digests.json`); (b) gpt2 by `tt.Tokenizer.from_file`;
   `encode_batch_fast` of the 512 documents with both, counts set to 0
   just before and read just after, gpt2's against the wheel's digests and
   the trained one's against the CPU's, B3, B2 and B1 launched by each,
   and each run again on a tokenizer in the same state under
   `checked_again` (every launch bit for bit against its plain version);
   (c) `decode_batch` and `tt.DecodeStream` (the first `STREAM_DOCS`)
   give the documents back; (d) `model.tokenize` of
   `smoke_data.JAX_API_WORDS` gives the `Token`s of the same model loaded
   after `tt.set_default_device("cpu")` (which is then given back), and
   the trained model's those of the CPU run; (e) `enable_truncation(8,
   strategy="bogus")` raises `tt.TruncationError`.  Prints the phase's
   seconds and launches with the card's name and power limit, and adds
   each kernel's `jax_api_launches`.
19. Prints a line of numbers per path, the per-kernel JSON line (with each
   merge kernel's registers and spills from ptxas: a merge kernel missing
   from the report, or spill bytes in B4's two kernels or B1's row kernel,
   fail the run), the card's
   name and power limit, and last `{"ok": true, "device": {...}}`.

Any mismatch or error exits non-zero; there is no fallback.  Without a
card, or without the rest of the repo beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
GPT2 = os.path.join(FIXTURES, "gpt2", "tokenizer.json")
LLAMA3 = os.path.join(FIXTURES, "llama3_128k", "tokenizer.json")
BERT = os.path.join(FIXTURES, "bert", "tokenizer.json")
UNIGRAM = os.path.join(FIXTURES, "unigram", "tokenizer.json")
UNIGRAM_BF = os.path.join(FIXTURES, "unigram_bf", "tokenizer.json")
TPU_KERNELS = {  # file:line of the `pallas_call` each kernel replaces
    "layout_fused": "tokenizers_tpu/ops/layout_pallas.py:176",
    "layout_fused_wide": "tokenizers_tpu/ops/layout_pallas.py:176",
    "keys": "tokenizers_tpu/ops/merge_pallas.py:258",
    "merge_round_fused": "tokenizers_tpu/ops/merge_pallas.py:283",
    "merge_round_fused_wide": "tokenizers_tpu/ops/merge_pallas.py:283",
    "merge_round_standalone": "tokenizers_tpu/ops/merge_pallas.py:315",
    "merge_round_standalone_wide": "tokenizers_tpu/ops/merge_pallas.py:315",
}
SOURCES = {
    "layout_fused": "tokenizers_tpu_torch/csrc/layout.cu",
    "layout_fused_wide": "tokenizers_tpu_torch/csrc/layout.cu",
    "keys": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_fused": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_fused_wide": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_standalone": "tokenizers_tpu_torch/csrc/merge_round.cu",
    "merge_round_standalone_wide": "tokenizers_tpu_torch/csrc/merge_round.cu",
}
# the prefix of each merge kernel's mangled name in ptxas's report
PTXAS_NAMES = {
    "keys": "_Z11keys_kernel",
    "merge_round_fused": "_Z18merge_round_kernelILb0ELb1E",
    "merge_round_fused_wide": "_Z18merge_round_kernelILb1ELb1E",
    "merge_round_standalone": "_Z18merge_round_kernelILb0ELb0E",
    "merge_round_standalone_wide": "_Z18merge_round_kernelILb1ELb0E",
}
# merge kernels that must build with no spill bytes
NO_SPILLS = ("merge_round_fused", "merge_round_standalone", "merge_round_standalone_wide")
# the compacted states of the merge loop each kernel is checked at:
# (width, rows): full unique buffer, 5/8 and 1/2 width, a ladder rung
STATES = ((4096, None), (2560, None), (2048, None), (2048, 37))
# widths of the adversarial layouts: the row kernel's, then the cluster one's
ADVERSARIAL_WIDTHS = (64, 256, 1536, 2048, 2560, 4096, 5120, 8192, 16384, 40960, 65536)
LAYOUT_WIDTHS = (256, 1024, 4096, 8192, 16384, 32768, 65536)  # B3's: row kernel to 8192
# the char-level phase's tokenizers (smoke_data.CHAR_CONFIGS and spm_bf)
CHAR_LEVEL = ("char_bpe", "sp_bpe", "spm_bf", "wordlevel")
# cold launches of the 8 KB paths: no change to a kernel may move them
CHAR_COLD = {  # the char-level phase's 8 KB runs (each B1 count holds its cluster kernel's)
    "char_bpe": {"keys": 18, "merge_round_fused": 108, "merge_round_fused_wide": 12},
    "sp_bpe": {"keys": 22, "merge_round_fused": 357, "merge_round_fused_wide": 357},
    "spm_bf": {"keys": 20, "merge_round_fused": 399, "merge_round_fused_wide": 399},
    "wordlevel": {"keys": 0, "merge_round_fused": 0, "merge_round_fused_wide": 0},
}
# the ids each 8 KB run's first pass gave on the card, by config (phase 13)
CARD_IDS = {}
# the tokenizers phase 11 trained, by run, and the config whose frozen file
# each must equal (phase 15 (b) round-trips them)
TRAINED = {}
# phase 12's trained Unigram and the ids digests of its 8 KB run (phase 17 (c))
TRAINED_UNIGRAM = {}
EIGHT_KB_COLD = {
    "gpt2": {"layout_fused": 2, "layout_fused_wide": 0, "keys": 16,
             "merge_round_fused": 79, "merge_round_fused_wide": 0},
    "llama3": {"layout_fused": 0, "layout_fused_wide": 0, "keys": 14,
               "merge_round_fused": 69, "merge_round_fused_wide": 0},
}


def _check_equal(torch, name, got, want):
    """Bit-for-bit equality of two output tuples; returns max |diff|."""
    err = 0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise SystemExit(f"{name}: output {k} differs from its reference")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def b1_checked(torch, mk, name, args):
    """One B1 round on args = (ids, own_l, own_r, wid, h0, h1, nid, rows0,
    rows1, seed), held against the plain version; the kernel must be the
    one `merge_round_fused` picks by width.  Returns (outputs, max |diff|)."""
    wide = args[0].shape[1] > mk.ROW_MAX_C
    before = mk.LAUNCHES["merge_round_fused_wide"]
    got = mk.merge_round_fused(*args)
    if mk.LAUNCHES["merge_round_fused_wide"] - before != int(wide):
        raise SystemExit(f"{name}: B1 took the wrong kernel at width {args[0].shape[1]}")
    return got, _check_equal(torch, name, got, mk.merge_round_fused_plain(*args))


def b1_rounds(torch, mk, name, st, wid, rows0, rows1, seed, rounds):
    """`rounds` checked B1 rounds from the state st = (ids, own_l, own_r,
    h0, h1, nid).  Returns (state, max |diff|)."""
    err = 0
    for _ in range(rounds):
        got, e = b1_checked(torch, mk, name, (*st[:3], wid, *st[3:], rows0, rows1, seed))
        err = max(err, e)
        st = (got[0], got[1], got[2], got[4], got[5], got[6])
    return st, err


def adversarial_b3(torch, lk):
    """Both B3 kernels against the plain version on the adversarial rows,
    the kernel each width takes read from the launch counts.  Returns
    {kernel: max |diff|}."""
    from tokenizers_tpu_torch.smoke_data import adversarial_layout_case

    errs = {"layout_fused": 0, "layout_fused_wide": 0}
    for L in LAYOUT_WIDTHS:
        buf, lens = adversarial_layout_case(L, 30, L)
        b, n = torch.from_numpy(buf).cuda(), torch.from_numpy(lens).cuda()
        wide = L > lk.ROW_MAX_L
        before = lk.LAUNCHES["layout_fused_wide"]
        got = lk.layout_fused(b, n)
        if lk.LAUNCHES["layout_fused_wide"] - before != int(wide):
            raise SystemExit(f"layout_fused took the wrong kernel at width {L}")
        k = "layout_fused_wide" if wide else "layout_fused"
        errs[k] = max(errs[k], _check_equal(torch, f"{k} adversarial [30, {L}]", got,
                                            lk.layout_fused_plain(b, n)))
    print(f"B3 bit-equal (tolerance 0) on the adversarial rows at [30, L], L in "
          f"{list(LAYOUT_WIDTHS)} (row kernel to {lk.ROW_MAX_L}, cluster beyond)", flush=True)
    return errs


def adversarial_state(torch, C):
    """The adversarial merge layout [12, C] of `smoke_data.adversarial_case`
    on the card: (ids, own_l, own_r, wid, rows0, rows1, seed)."""
    from tokenizers_tpu_torch.ops.bpe_merge2 import init_own
    from tokenizers_tpu_torch.ops.merge_table import CuckooMergeTable, consume_mins
    from tokenizers_tpu_torch.smoke_data import adversarial_case

    merges, n_ids, ids, wid = adversarial_case(C, 12, C)
    table = CuckooMergeTable(merges)
    mclr = consume_mins(merges, n_ids)
    rows0, rows1 = (torch.from_numpy(table.rows8(t, mclr)).cuda() for t in (0, 1))
    ids, wid = torch.from_numpy(ids).cuda(), torch.from_numpy(wid).cuda()
    own_l, own_r = init_own(ids, torch.from_numpy(mclr).cuda())
    return ids, own_l, own_r, wid, rows0, rows1, table.seed


def adversarial_b1(torch, mk):
    """B2, then both B1 kernels (three rounds each), on the adversarial
    layouts, each against its plain version."""
    errs = {"keys": 0, "merge_round_fused": 0, "merge_round_fused_wide": 0}
    for C in ADVERSARIAL_WIDTHS:
        ids, own_l, own_r, wid, rows0, rows1, seed = adversarial_state(torch, C)
        k_got = mk.keys(ids, rows0, seed)
        errs["keys"] = max(errs["keys"], _check_equal(
            torch, f"keys adversarial [12, {C}]", k_got, mk.keys_plain(ids, rows0, seed)))
        st = (ids, own_l, own_r) + tuple(k_got)
        k = "merge_round_fused_wide" if C > mk.ROW_MAX_C else "merge_round_fused"
        _st, err = b1_rounds(torch, mk, f"{k} adversarial [12, {C}]", st, wid, rows0,
                             rows1, seed, 3)
        errs[k] = max(errs[k], err)
    print(f"B2 and B1 bit-equal (tolerance 0) on the adversarial layouts at [12, C], C in "
          f"{list(ADVERSARIAL_WIDTHS)} (B1's row kernel to {mk.ROW_MAX_C}, cluster beyond)",
          flush=True)
    return errs


def b4_rounds(torch, mk, name, st, wid, rows0, rows1, seed, rounds, errs):
    """`rounds` B4 rounds from st = (ids, own_l, own_r), each held against
    its plain version and against B2 then B1 (each against theirs); the
    kernel must be the one `merge_round_standalone` picks by width.  Raises
    max |diff| in errs[kernel] for B4's, B2's and B1's kernels.  Returns
    (state, f of the last round)."""
    wide = wid.shape[1] > mk.ROW_MAX_C
    k4 = "merge_round_standalone_wide" if wide else "merge_round_standalone"
    k1 = "merge_round_fused_wide" if wide else "merge_round_fused"
    for _ in range(rounds):
        before = mk.LAUNCHES["merge_round_standalone_wide"]
        got = mk.merge_round_standalone(*st, wid, rows0, rows1, seed)
        if mk.LAUNCHES["merge_round_standalone_wide"] - before != int(wide):
            raise SystemExit(f"{name}: B4 took the wrong kernel at width {wid.shape[1]}")
        errs[k4] = max(errs[k4], _check_equal(
            torch, f"{name} B4", got, mk.merge_round_standalone_plain(*st, wid, rows0, rows1,
                                                                      seed)))
        k_got = mk.keys(st[0], rows0, seed)
        errs["keys"] = max(errs["keys"], _check_equal(
            torch, f"{name} B2", k_got, mk.keys_plain(st[0], rows0, seed)))
        chain, err = b1_checked(torch, mk, f"{name} B1", (*st, wid, *k_got, rows0, rows1, seed))
        errs[k1] = max(errs[k1], err)
        _check_equal(torch, f"{name} B4 against B2, B1", got, chain[:4])
        st = got[:3]
    return st, got[3]


def round_to_completion(torch, mk, counts, name, st, wid, rows0, rows1, seed):
    """`bpe_merge2._round` (B4) from st until no head merges, every count
    of `counts` set to 0 first; it must end where the B2/B1 loop ends and
    launch B4 once a round.  Returns (rounds, B4 launches, B4 cluster
    launches)."""
    from tokenizers_tpu_torch.ops.bpe_merge2 import _round, make_round_driver

    for c in counts.values():
        for k in c:
            c[k] = 0
    st0, rounds = st, 0
    while True:
        a, l_, r_, f = _round(*st, wid, rows0, rows1, seed)
        st, rounds = (a, l_, r_), rounds + 1
        if not bool(f.any()):
            break
    launches = (mk.LAUNCHES["merge_round_standalone"], mk.LAUNCHES["merge_round_standalone_wide"])
    if launches[0] != rounds:
        raise SystemExit(f"{name}: _round did not launch B4 once per round")
    init, step, unpack = make_round_driver(wid, rows0, rows1, seed)
    cst = init(*st0)
    while True:
        cst, f = step(cst)
        if not bool(f.any()):
            break
    _check_equal(torch, f"{name}: _round to completion against the B2/B1 loop", st, unpack(cst))
    print(f"_round: {rounds} B4 rounds to completion at {list(wid.shape)} ({name}), equal to "
          f"the B2/B1 loop", flush=True)
    return (rounds,) + launches


def full_width_rounds(torch, mk, args, widths):
    """Two checked B1 rounds at each of `widths` from the full-width state
    args = (ids, own_l, own_r, wid, h0, h1, nid, rows0, rows1, seed),
    compacting to each next width as `run_merge_phases` does.  Returns
    max |diff|."""
    from tokenizers_tpu_torch.ops.bpe_merge2 import compact

    ids, own_l, own_r, wid, h0, h1, nid, rows0, rows1, seed = args
    st, err = (ids, own_l, own_r, h0, h1, nid), 0
    for width in widths:
        if st[0].shape[1] != width:
            ids_c, wid, _bad, (l_c, r_c) = compact(st[0], wid, width, st[1:3])
            st = (ids_c, l_c, r_c) + tuple(mk.keys(ids_c, rows0, seed))
        st, e = b1_rounds(torch, mk, f"merge_round_fused_wide {list(st[0].shape)}", st, wid,
                          rows0, rows1, seed, 2)
        err = max(err, e)
    return err


def check_eight_kb(runs, config):
    cold = {k: runs["cold"]["launches"][k] for k in EIGHT_KB_COLD[config]}
    if cold != EIGHT_KB_COLD[config]:
        raise SystemExit(f"{config} (8 KB documents) cold launches {cold}, "
                         f"want {EIGHT_KB_COLD[config]}")


def drive_path(torch, tok, docs, config, counts, digests=None, passes=("cold", "cached")):
    """`encode_batch_fast` on `docs`, cold then on the warm word cache (the
    `passes`); every launch count set to 0 just before each run and read
    just after.
    Returns the runs' numbers; raises on a document that differs from its
    digest (`digests`, else the committed ones of `config`)."""
    from tokenizers_tpu_torch.ops import engine_base
    from tokenizers_tpu_torch.smoke_data import ids_digest, load_digests

    eng = tok._get_device_engine()
    if eng is None:
        raise SystemExit(f"{config}: no device engine")
    program_s = []
    run_program = eng._program_many

    def timed_program(chunks_):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_program(chunks_)
        torch.cuda.synchronize()
        program_s.append(time.perf_counter() - t)
        return out

    eng._program_many = timed_program
    if digests is None:
        digests = load_digests(config)
    runs = {}
    for run in passes:
        for c in counts.values():
            for k in c:
                c[k] = 0
        engine_base.STATS.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        encs = tok.encode_batch_fast(docs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: c[k] for k, c in counts.items()}
        bad = [i for i, e in enumerate(encs) if ids_digest(e.ids) != digests[i]]
        if bad:
            raise SystemExit(f"{config} {run}: {len(bad)} documents differ from "
                             f"their digests: {bad[:10]}")
        runs[run] = dict(secs=secs, program_s=program_s[-1], launches=launches,
                         **engine_base.STATS.snapshot())
        CARD_IDS.setdefault(config, [e.ids for e in encs])
    eng._program_many = run_program
    return runs


def path_numbers(eng, docs, prepared, runs, config):
    from tokenizers_tpu_torch.ops.packing import pack_batch

    nbytes = sum(len(p) for p in prepared)
    return {
        "config": config, "docs": len(docs), "bytes": nbytes,
        "chunks": [list(c[0].shape) + [bool(eng._is_ascii(c[0]))]
                   for c in pack_batch(prepared)],
        **{f"{run}_MBps": nbytes / r["secs"] / 1e6 for run, r in runs.items()},
        **{f"{run}_program_MBps": nbytes / r["program_s"] / 1e6 for run, r in runs.items()},
        **{f"{run}_bad_row_fraction": r["bad_row_fraction"] for run, r in runs.items()},
        **{f"{run}_launches": r["launches"] for run, r in runs.items()},
        "patched_words": runs["cold"]["patched_words"],
        "digests_matched": len(docs),
    }


def long_path(torch, stats, b3_err, b1_err, counts, numbers):
    """Phase 6, the gpt2 long documents: both cluster kernels at this
    path's real states against their plain versions, the parts of
    `long_parts` driven cold (a new tokenizer, its word cache empty) and
    cached against their digests, both cluster kernels timed.  Fills the cluster
    kernels' entries of `stats`, every kernel's `long_path_launches` and
    `numbers`."""
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch import smoke_data
    from tokenizers_tpu_torch.ops import kernel_build
    from tokenizers_tpu_torch.ops import layout_kernels as lk
    from tokenizers_tpu_torch.ops import merge_kernels as mk
    from tokenizers_tpu_torch.ops.engine_base import CHUNK_TARGET
    from tokenizers_tpu_torch.ops.packing import MAX_L
    from tokenizers_tpu_torch.smoke_data import (
        first_ascii_chunk, full_width_state, load_digests, long_parts,
    )
    from tokenizers_tpu_torch.tools import timing
    from tokenizers_tpu_torch.tools.wide_ab import wide_times

    tok = Tokenizer.from_file(GPT2)
    eng = tok._get_device_engine()
    T = eng.tables
    rows0, rows1, seed = T["merge_rows0"], T["merge_rows1"], T["seed"]

    def pieces(docs):  # the work items encode_batch makes of the documents
        out = []
        for d in docs:
            p = eng._prepare(d)
            out += eng._split_long(p, CHUNK_TARGET) if len(p) > MAX_L // 2 else [p]
        return out

    parts = long_parts()
    # the cluster kernels at this path's states
    b, n, _inb = first_ascii_chunk(eng, pieces(parts["long"]), (64, 32768))
    b3_err = max(b3_err, _check_equal(torch, "layout_fused [64, 32768]", lk.layout_fused(b, n),
                                      lk.layout_fused_plain(b, n)))
    bd, nd, inbd = first_ascii_chunk(eng, pieces(parts["dense"]), (8, 16384))
    lay = lk.layout_fused(bd, nd)
    b3_err = max(b3_err, _check_equal(torch, "layout_fused [8, 16384]", lay,
                                      lk.layout_fused_plain(bd, nd)))
    ids, own_l, own_r, wid = full_width_state(eng, bd, inbd, lay[0])
    args = (ids, own_l, own_r, wid, *mk.keys(ids, rows0, seed), rows0, rows1, seed)
    b1_err = max(b1_err, full_width_rounds(torch, mk, args, (16384, 10240, 8192)))
    print("cluster B3 bit-equal (tolerance 0) at [64, 32768] (32 KB documents) and [8, 16384] "
          "(dense documents); cluster B1 at the dense full-width state [8, 16384] and its "
          "widths 10240 and 8192", flush=True)

    # (a), (b) and (c), cold then cached, each against its digests
    digests = load_digests("gpt2_long")
    runs = {}
    for part, want in (("long", "layout_fused_wide"), ("dense", "merge_round_fused_wide"),
                       ("dense_16k", "merge_round_fused_wide")):
        docs = parts[part]
        dig, digests = digests[:len(docs)], digests[len(docs):]
        runs[part] = drive_path(torch, tok, docs, f"gpt2 {part}", counts, dig)
        cold = runs[part]["cold"]["launches"]
        if cold[want] < (2 if part == "long" else 1):
            raise SystemExit(f"gpt2 {part} documents: {want} launched {cold[want]} times")
        numbers[f"gpt2_{part}"] = path_numbers(eng, docs, pieces(docs), runs[part], f"gpt2_{part}")
        print("numbers " + json.dumps(numbers[f"gpt2_{part}"]), flush=True)
    print(f"gpt2 dense_16k documents: {numbers['gpt2_dense_16k']['cold_bad_row_fraction']} of "
          f"rows flagged cold (the 5/8 width's overflow), "
          f"{runs['dense_16k']['cold']['launches']['merge_round_fused_wide']} cluster B1 "
          f"launches", flush=True)
    for k, st in stats.items():
        st["long_path_launches"] = stats_launches(runs, k)

    # timing: the cluster B3 on corpus chunks, the cluster B1 at full-width states
    by = wide_times(torch, lk, mk, eng, smoke_data, timing)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, t in by["layout_fused_wide"].items():
        S, nc = lk.wide_geometry(int(shape.split("x")[1]))
        t.update(slice=S, cluster=nc, smem_bytes=lk.smem_bytes(S),
                 max_active_clusters=lk.max_clusters(S, nc))
    for shape, t in by["merge_round_fused_wide"].items():
        S, nc = mk.cluster_geometry(*(int(x) for x in shape.split("x")), sms)
        t.update(slice=S, cluster=nc, smem_bytes=mk.smem_bytes(S),
                 max_active_clusters=mk.max_clusters(S, nc))
    for k, err, head, entry in (
            ("layout_fused_wide", b3_err, "64x32768", ("tt_layout_wide_max_clusters", ())),
            ("merge_round_fused_wide", b1_err, "32x16384",
             ("tt_merge_round_max_clusters", (1,)))):
        stats[k] = {
            "max_abs_err": err, **{x: by[k][head][x] for x in ("ms", "plain_ms", "bound_ms")},
            "shape": [int(x) for x in head.split("x")], "by_shape": by[k],
            "launches": stats_launches(runs, k),
            "launches_from": "gpt2 long documents, cold: (a) + (b) + (c)",
            "long_path_launches": stats_launches(runs, k),
            # every (slice, cluster size) this run launched, phase 2's included
            "max_active_clusters": {f"S={S} n={nc}": v for (_l, e, _d, S, nc, a), v
                                    in sorted(kernel_build.CLUSTERS.items())
                                    if (e, a) == entry},
        }
        print(f"{k} by shape: {json.dumps(by[k])}", flush=True)


def checked_run(torch, fn, capture=None):
    """fn() with the serving paths' kernel wrappers (B3, B2, B1) replaced
    by ones that launch the kernel as the path asks, hold its outputs bit
    for bit against the plain version on the same inputs, and tally each
    launch by the kernel that ran (the row or the cluster one) and its
    shape.  `capture` (a dict): the inputs of each kernel's first launch
    at each shape, by (kernel, "RxC").  Returns (fn's result, {kernel:
    {"RxC": launches}}, {kernel: max |diff|})."""
    from tokenizers_tpu_torch.ops import bpe_encode
    from tokenizers_tpu_torch.ops import layout_kernels as lk
    from tokenizers_tpu_torch.ops import merge_kernels as mk

    shapes, errs = {}, {}

    def checked(wrapper, plain, counter, name):
        def run(x, *args, **kw):
            before = (counter[name], counter.get(f"{name}_wide", 0))
            got = wrapper(x, *args, **kw)
            if counter[name] == before[0]:  # an empty input launches nothing
                return got
            k = f"{name}_wide" if counter.get(f"{name}_wide", 0) > before[1] else name
            errs[k] = max(errs.get(k, 0), _check_equal(
                torch, f"{k} {list(x.shape)} on the path", got, plain(x, *args, **kw)))
            by = shapes.setdefault(k, {})
            key = "x".join(str(d) for d in x.shape)
            by[key] = by.get(key, 0) + 1
            if capture is not None and (k, key) not in capture:
                capture[(k, key)] = (x, *args)
            return got
        return run

    wrappers = (lk.layout_fused, mk.keys, mk.merge_round_fused)
    lk.layout_fused = bpe_encode.layout_fused = checked(
        lk.layout_fused, lk.layout_fused_plain, lk.LAUNCHES, "layout_fused")
    mk.keys = checked(mk.keys, mk.keys_plain, mk.LAUNCHES, "keys")
    mk.merge_round_fused = checked(mk.merge_round_fused, mk.merge_round_fused_plain,
                                   mk.LAUNCHES, "merge_round_fused")
    try:
        out = fn()
    finally:
        lk.layout_fused = bpe_encode.layout_fused = wrappers[0]
        mk.keys, mk.merge_round_fused = wrappers[1:]
    return out, shapes, errs


def checked_again(torch, fn, name, launches, digest, digests, capture=None):
    """fn() once more under `checked_run`: every launch of B3, B2 and B1
    held bit for bit against its plain version; its launches must equal
    the counted run's `launches` and its encodings' `digest` the
    `digests`.  Returns (shapes, errs) of `checked_run`."""
    encs, shapes, errs = checked_run(torch, fn, capture)
    for k, n in launches.items():
        # a wrapper's count holds its cluster kernel's launches too
        n_checked = sum(shapes.get(k, {}).values()) + (
            sum(shapes.get(f"{k}_wide", {}).values()) if f"{k}_wide" in launches else 0)
        if n_checked != n:
            raise SystemExit(f"{name}: {k} launched {n} times in the counted run and "
                             f"{n_checked} in the checked one")
    if [digest(e) for e in encs] != digests:
        raise SystemExit(f"{name}: the checked run's documents differ from their digests")
    print(f"{name}: every launch bit-equal (tolerance 0) to its plain version; "
          f"launches by kernel and shape: {json.dumps(shapes)}", flush=True)
    return shapes, errs


def offsets_run(torch, tok, docs, name, counts, digests, byte_sample=0):
    """`encode_batch` on `docs`, every launch count set to 0 just before and
    read just after, timed end to end, in the offsets program and in the
    host pipeline, each document against its offsets digest; then
    `encode_batch_byte_offsets` on the first `byte_sample` documents against
    the port's host path with byte offsets.  Returns the run's numbers."""
    from tokenizers_tpu_torch.ops import engine_base
    from tokenizers_tpu_torch.smoke_data import offsets_digest

    eng = tok._get_device_engine()
    program_s = []
    run_program = eng._program_offsets

    def timed_program(buf, lengths):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_program(buf, lengths)
        torch.cuda.synchronize()
        program_s.append(time.perf_counter() - t)
        return out

    eng._program_offsets = timed_program
    host_s = []
    run_host = tok.encode_host

    def timed_host(*a, **k):
        t = time.perf_counter()
        out = run_host(*a, **k)
        host_s.append(time.perf_counter() - t)
        return out

    tok.encode_host = timed_host
    for c in counts.values():
        for k in c:
            c[k] = 0
    engine_base.STATS.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    encs = tok.encode_batch(docs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {k: c[k] for k, c in counts.items()}
    st = engine_base.STATS.snapshot()
    eng._program_offsets = run_program
    tok.encode_host = run_host
    bad = [i for i, e in enumerate(encs) if offsets_digest(e) != digests[i]]
    if bad:
        raise SystemExit(f"offsets {name}: {len(bad)} documents differ from their offsets "
                         f"digests: {bad[:10]}")
    sample = docs[:byte_sample]
    for i, (g, w) in enumerate(zip(tok.encode_batch_byte_offsets(sample),
                                   [tok.encode_host(d, True, offsets="byte") for d in sample])):
        if (g.ids, g.offsets, g.tokens, g.words) != (w.ids, w.offsets, w.tokens, w.words):
            raise SystemExit(f"offsets {name}: document {i}'s byte offsets differ from the "
                             f"host path's")
    # the same run again, every launch held against its plain version at
    # the shape and on the data the path gave it
    shapes, errs = checked_again(torch, lambda: tok.encode_batch(docs), f"offsets {name}",
                                 launches, offsets_digest, digests[:len(docs)])
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    return {
        "config": f"offsets_{name}", "docs": len(docs), "bytes": nbytes,
        "MBps": nbytes / secs / 1e6, "secs": secs, "program_s": sum(program_s),
        "program_MBps": nbytes / sum(program_s) / 1e6, "chunks": len(program_s),
        # the host pipeline's share: flagged rows and inputs the card does not take
        "host_encode_s": sum(host_s),
        "bad_row_fraction": st["bad_row_fraction"], "bad_rows": st["bad_rows"],
        "device_rows": st["device_rows"], "host_pre_inputs": st["host_pre_inputs"],
        "launches": launches, "digests_matched": len(docs),
        "byte_offsets_checked": len(sample),
        "checked_shapes": shapes, "checked_max_abs_err": errs,
    }


def offsets_path(torch, tok, tok3, stats, counts, numbers):
    """Phase 7: the cluster B1 at the offsets path's new shapes, then the
    offsets path on the gpt2 and llama3_128k 8 KB documents and on the
    long documents (a).  Adds the cluster B1's shapes to its entry of
    `stats`, every kernel's `offsets_path_launches` and
    `offsets_path_shapes`, and `numbers`."""
    from tokenizers_tpu_torch.ops import merge_kernels as mk
    from tokenizers_tpu_torch.smoke_data import build_docs, load_digests, long_parts, offsets_states
    from tokenizers_tpu_torch.tools.timing import bound_ms, median_ms, nbytes, table_bytes

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    by = stats["merge_round_fused_wide"]["by_shape"]
    err = stats["merge_round_fused_wide"]["max_abs_err"]
    # timed here; `offsets_run` holds every launch of the path, these shapes
    # included, against the plain version
    for (R, C), args in offsets_states(tok._get_device_engine()).items():
        got, e = b1_checked(torch, mk, f"merge_round_fused_wide {[R, C]}", args)
        S, nc = mk.cluster_geometry(R, C, sms)
        by[f"{R}x{C}"] = {
            "ms": median_ms(lambda: mk.merge_round_fused_wide(*args), 20),
            "plain_ms": median_ms(lambda: mk.merge_round_fused_plain(*args), 2),
            "bound_ms": bound_ms(nbytes(*args[:7], *got) + table_bytes(
                args[0], args[3], *args[4:6], *args[7:9])),
            "slice": S, "cluster": nc, "smem_bytes": mk.smem_bytes(S),
            "max_active_clusters": mk.max_clusters(S, nc),
            "from": "offsets path, first [256, 8192] chunk of the 8 KB documents",
        }
        err = max(err, e)
    stats["merge_round_fused_wide"]["max_abs_err"] = err
    print("cluster B1 bit-equal (tolerance 0) at the offsets path's [256, 8192] and [256, 5120] "
          "(first round); by shape: " + json.dumps({k: by[k] for k in ("256x8192",
                                                                            "256x5120")}),
          flush=True)

    docs = build_docs()
    runs = {}
    for name, tk, part, dig in (
            ("gpt2", tok, docs, "gpt2_offsets"), ("llama3", tok3, docs, "llama3_offsets"),
            ("gpt2_long", tok, long_parts()["long"], "gpt2_long_offsets")):
        runs[name] = offsets_run(torch, tk, part, name, counts, load_digests(dig),
                                 byte_sample=0 if name == "gpt2_long" else 64)
        numbers[f"offsets_{name}"] = runs[name]
        print("numbers " + json.dumps(runs[name]), flush=True)
    want = {"gpt2": ("layout_fused", "keys", "merge_round_fused", "merge_round_fused_wide"),
            "llama3": ("keys", "merge_round_fused", "merge_round_fused_wide"),
            "gpt2_long": ("layout_fused_wide", "keys", "merge_round_fused_wide")}
    for name, ks in want.items():
        zero = [k for k in ks if runs[name]["launches"][k] == 0]
        if zero:
            raise SystemExit(f"offsets {name}: {zero} never launched")
    for k, s_ in stats.items():
        s_["offsets_path_launches"] = {name: r["launches"][k] for name, r in runs.items()}
        s_["offsets_path_shapes"] = {name: r["checked_shapes"].get(k, {})
                                     for name, r in runs.items()}
        s_["max_abs_err"] = max([s_["max_abs_err"]] + [r["checked_max_abs_err"].get(k, 0)
                                                       for r in runs.values()])


def bert_path(torch, stats, counts, numbers):
    """Phase 9, the BERT WordPiece path: no kernel of `csrc/` runs on it
    (the JAX package computes it in plain XLA, the port in torch ops), and
    every B1-B4 launch count must stay 0 over the whole phase.  Builds the
    bert tokenizer (its tables timed), then `encode_batch_fast` on the 512
    8 KB documents cold and cached (two [256, 8192] ASCII chunks on the
    dedup program, one [32, 8192] chunk on the generic dense program) and
    on the long documents (a) cold and cached (a new tokenizer: an empty
    word cache), `encode_batch` on both, every document against its
    committed digest, `encode_batch_byte_offsets` on 64 documents against
    the host path, and one more cold pass with CUDA events around the
    unique-word encoder (the longest-match sweep and the doubling) and the
    program.  Adds each kernel's `bert_path_launches` to `stats` and the
    bert numbers to `numbers`."""
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops import bert_tables, wordpiece_dedup
    from tokenizers_tpu_torch.ops.packing import pack_batch
    from tokenizers_tpu_torch.ops.wordpiece_engine import WordPieceEngine
    from tokenizers_tpu_torch.smoke_data import build_docs, load_digests, long_parts

    for c in counts.values():
        for k in c:
            c[k] = 0
    tables_cached = bool(os.listdir(bert_tables.cache_dir()))  # a checkout has none
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    tok = Tokenizer.from_file(BERT)
    eng = tok._get_device_engine()
    tables_s = time.perf_counter() - t
    if not isinstance(eng, WordPieceEngine):
        raise SystemExit(f"bert: the device engine is {type(eng).__name__}")
    print(f"bert tables {tables_s:.3f} s ({'loaded from' if tables_cached else 'built into'} "
          f"{bert_tables.cache_dir()})", flush=True)
    docs = build_docs()
    long_docs = long_parts()["long"]
    runs = drive_path(torch, tok, docs, "bert", counts)
    tok_long = Tokenizer.from_file(BERT)
    runs_long = drive_path(torch, tok_long, long_docs, "bert_long", counts,
                           digests=load_digests("bert_long"))
    offs = offsets_run(torch, tok, docs, "bert", counts, load_digests("bert_offsets"),
                       byte_sample=64)
    offs_long = offsets_run(torch, tok_long, long_docs, "bert_long", counts,
                            load_digests("bert_long_offsets"))

    # one more cold pass: CUDA events around the program and around each
    # call of the unique-word encoder
    enc_events, prog_events = [], []
    base_encoder = wordpiece_dedup.wordpiece_unique_encoder
    run_program = eng._program_many

    def events(fn, into):
        def run(*a):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a)
            e1.record()
            into.append((e0, e1))
            return out
        return run

    wordpiece_dedup.wordpiece_unique_encoder = lambda T: events(base_encoder(T), enc_events)
    eng._program_many = events(run_program, prog_events)
    eng._wc = None  # an empty word cache: a cold pass
    try:
        tok.encode_batch_fast(docs)
    finally:
        wordpiece_dedup.wordpiece_unique_encoder = base_encoder
        eng._program_many = run_program
    torch.cuda.synchronize()
    enc_ms = sum(a.elapsed_time(b) for a, b in enc_events)
    prog_ms = sum(a.elapsed_time(b) for a, b in prog_events)

    launches = {k: c[k] for k, c in counts.items()}  # the whole phase
    every = [launches] + [r["launches"] for r in (*runs.values(), *runs_long.values(), offs,
                                                  offs_long)]
    if any(n for ls in every for n in ls.values()):
        raise SystemExit(f"bert: a kernel of csrc/ launched on the bert path: {every}")
    chunks = pack_batch([eng._prepare(d) for d in docs])
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    long_bytes = sum(len(d.encode("utf-8")) for d in long_docs)
    numbers["bert"] = {
        "config": "bert", "docs": len(docs), "bytes": nbytes,
        "chunks": [list(c[0].shape) + [bool(eng._use_dedup(c[0]))] for c in chunks],
        "dedup_chunk_share": sum(eng._use_dedup(c[0]) for c in chunks) / len(chunks),
        **{f"{run}_MBps": nbytes / r["secs"] / 1e6 for run, r in runs.items()},
        **{f"{run}_program_s": r["program_s"] for run, r in runs.items()},
        # outside the program: packing, staging, host re-encodes, encodings
        **{f"{run}_host_s": r["secs"] - r["program_s"] for run, r in runs.items()},
        **{f"{run}_bad_row_fraction": r["bad_row_fraction"] for run, r in runs.items()},
        "offsets_MBps": offs["MBps"], "offsets_program_s": offs["program_s"],
        "offsets_host_encode_s": offs["host_encode_s"],
        "offsets_bad_row_fraction": offs["bad_row_fraction"],
        "long_bytes": long_bytes,
        **{f"long_{run}_MBps": long_bytes / r["secs"] / 1e6 for run, r in runs_long.items()},
        **{f"long_{run}_bad_row_fraction": r["bad_row_fraction"]
           for run, r in runs_long.items()},
        "long_offsets_MBps": offs_long["MBps"],
        "tables_s": tables_s, "tables_were_cached": tables_cached,
        "cold_event_program_ms": prog_ms, "cold_unique_encoder_ms": enc_ms,
        "unique_encoder_share": enc_ms / prog_ms,
        "unique_encoder_calls": len(enc_events),
        "peak_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
        "phase_launches": launches,
        "digests_matched": len(docs) + len(long_docs),
        "offsets_digests_matched": len(docs) + len(long_docs),
        "byte_offsets_checked": offs["byte_offsets_checked"],
    }
    print("numbers " + json.dumps(numbers["bert"]), flush=True)
    for k, s_ in stats.items():
        s_["bert_path_launches"] = launches[k]


def patch_tally(eng):
    """Wrap `eng._program_many` to tally, per call of `take()`, the patch
    records of its chunks: near ties (words within the dedup buffer's
    slack, whose Viterbi comparison was too close for compensated f32)
    and words over the slack.  Returns (take, restore)."""
    from tokenizers_tpu_torch.ops.unigram_dedup import UD_SLACK

    run_program = eng._program_many
    tally = {"near_tie_words": 0, "long_words": 0, "patch_overflow_chunks": 0}

    def tallied(chunks_):
        out = run_program(chunks_)
        for res in out:
            ptab, nflag = res[3]
            n = int(nflag)
            if n > ptab.shape[0]:
                tally["patch_overflow_chunks"] += 1
            wlen = ptab[:min(n, ptab.shape[0]), 2]
            tally["near_tie_words"] += int((wlen <= UD_SLACK).sum())
            tally["long_words"] += int((wlen > UD_SLACK).sum())
        return out

    def take():
        got = dict(tally)
        for k in tally:
            tally[k] = 0
        return got

    def restore():
        eng._program_many = run_program

    eng._program_many = tallied
    return take, restore


def unigram_path(torch, stats, counts, numbers):
    """Phase 10, the Unigram path: no kernel of `csrc/` runs on it (the JAX
    package computes it in plain XLA, the port in torch ops), and every
    B1-B4 launch count must stay 0 over the whole phase.  Builds both
    fixtures (tables timed); with unigram `encode_batch_fast` on the 512
    8 KB documents cold and cached, on the long documents (a) cold with a
    new tokenizer (an empty word cache), and `encode_batch` on the 8 KB
    documents; with unigram_bf `encode_batch_fast` cold and `encode_batch`;
    every document against its committed digest, byte offsets on 64
    documents against the host path; one more cold pass with CUDA events
    around the program and the unique encoder's forward scan and
    backtrack.  Adds each kernel's `unigram_path_launches` to `stats` and
    a numbers line per fixture to `numbers`."""
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops import unigram_dedup
    from tokenizers_tpu_torch.ops.unigram_engine import UnigramEngine
    from tokenizers_tpu_torch.smoke_data import build_docs, load_digests, long_parts

    for c in counts.values():
        for k in c:
            c[k] = 0
    torch.cuda.reset_peak_memory_stats()
    docs = build_docs()
    long_docs = long_parts()["long"]
    nbytes = sum(len(d.encode("utf-8")) for d in docs)
    long_bytes = sum(len(d.encode("utf-8")) for d in long_docs)
    every = []

    def build(path):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok = Tokenizer.from_file(path)
        eng = tok._get_device_engine()
        torch.cuda.synchronize()
        if not isinstance(eng, UnigramEngine):
            raise SystemExit(f"{path}: the device engine is {type(eng).__name__}")
        return tok, eng, time.perf_counter() - t

    def fast(tok, eng, part, name, digests, passes):
        take, restore = patch_tally(eng)
        out = {}
        try:
            for run in passes:
                r = drive_path(torch, tok, part, name, counts, digests, passes=(run,))[run]
                size = long_bytes if part is long_docs else nbytes
                out[run] = {
                    "e2e_MBps": size / r["secs"] / 1e6, "secs": r["secs"],
                    "program_s": r["program_s"], "host_s": r["secs"] - r["program_s"],
                    "bad_row_fraction": r["bad_row_fraction"], "bad_rows": r["bad_rows"],
                    "host_pre_inputs": r["host_pre_inputs"],
                    "patched_words": r["patched_words"], **take()}
                every.append(r["launches"])
        finally:
            restore()
        return out

    def offsets(tok, name):
        r = offsets_run(torch, tok, docs, name, counts, load_digests(f"{name}_offsets"),
                        byte_sample=64)
        every.append(r["launches"])
        return {k: r[k] for k in ("MBps", "secs", "program_s", "host_encode_s",
                                  "bad_row_fraction", "bad_rows", "host_pre_inputs",
                                  "byte_offsets_checked")}

    tok, eng, tables_s = build(UNIGRAM)
    runs = fast(tok, eng, docs, "unigram", load_digests("unigram"), ("cold", "cached"))
    tok_long, eng_long, _ = build(UNIGRAM)
    runs_long = fast(tok_long, eng_long, long_docs, "unigram_long",
                     load_digests("unigram_long"), ("cold",))
    offs = offsets(tok, "unigram")
    tok_bf, eng_bf, tables_bf_s = build(UNIGRAM_BF)
    runs_bf = fast(tok_bf, eng_bf, docs, "unigram_bf", load_digests("unigram_bf"), ("cold",))
    offs_bf = offsets(tok_bf, "unigram_bf")

    # one more cold pass: CUDA events around the program and around the
    # unique encoder's forward scan and backtrack
    enc_events, prog_events = [], []
    base = (unigram_dedup.forward_dp, unigram_dedup.backtrack)
    run_program = eng._program_many

    def events(fn, into, name):
        def run(*a):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a)
            e1.record()
            into.append((name, e0, e1))
            return out
        return run

    unigram_dedup.forward_dp = events(base[0], enc_events, "forward")
    unigram_dedup.backtrack = events(base[1], enc_events, "backtrack")
    eng._program_many = events(run_program, prog_events, "program")
    eng._wc = None  # an empty word cache: a cold pass
    try:
        tok.encode_batch_fast(docs)
    finally:
        unigram_dedup.forward_dp, unigram_dedup.backtrack = base
        eng._program_many = run_program
    torch.cuda.synchronize()
    prog_ms = sum(a.elapsed_time(b) for _n, a, b in prog_events)
    fwd_ms = sum(a.elapsed_time(b) for n, a, b in enc_events if n == "forward")
    bt_ms = sum(a.elapsed_time(b) for n, a, b in enc_events if n == "backtrack")

    launches = {k: c[k] for k, c in counts.items()}  # the whole phase
    if any(n for ls in [launches] + every for n in ls.values()):
        raise SystemExit(f"unigram: a kernel of csrc/ launched on the Unigram path: "
                         f"{[launches] + every}")
    numbers["unigram"] = {
        "config": "unigram", "docs": len(docs), "bytes": nbytes,
        "tables_s": tables_s, **{f"{run}_{k}": v for run, r in runs.items()
                                 for k, v in r.items()},
        "long_docs": len(long_docs), "long_bytes": long_bytes,
        **{f"long_cold_{k}": v for k, v in runs_long["cold"].items()},
        **{f"offsets_{k}": v for k, v in offs.items()},
        "cold_event_program_ms": prog_ms, "cold_forward_scan_ms": fwd_ms,
        "cold_backtrack_ms": bt_ms, "dp_share_of_program": (fwd_ms + bt_ms) / prog_ms,
        "encoder_calls": len(enc_events) // 2,
        "peak_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
        "phase_launches": launches,
        "digests_matched": 2 * len(docs) + len(long_docs),
        "offsets_digests_matched": len(docs),
    }
    numbers["unigram_bf"] = {
        "config": "unigram_bf", "docs": len(docs), "bytes": nbytes, "tables_s": tables_bf_s,
        **{f"cold_{k}": v for k, v in runs_bf["cold"].items()},
        **{f"offsets_{k}": v for k, v in offs_bf.items()},
        "digests_matched": len(docs), "offsets_digests_matched": len(docs),
    }
    for name in ("unigram", "unigram_bf"):
        print("numbers " + json.dumps(numbers[name]), flush=True)
    for k, s_ in stats.items():
        s_["unigram_path_launches"] = launches[k]


def char_level_path(torch, stats, counts, numbers):
    """Phase 10, the WordLevel and char-level BPE paths: the tokenizers of
    CHAR_LEVEL built (tables timed), `encode_batch_fast` cold on the 8 KB
    documents with each and on the long documents (a) with sp_bpe,
    `encode_batch` on the 8 KB documents with char_bpe, sp_bpe and
    wordlevel (`offsets_run`: byte offsets on 64 documents, and every
    launch checked), every document against its digest; each char-level
    BPE `encode_batch_fast` run again under `checked_run`.  Adds each
    kernel's `char_level_launches` and `char_level_shapes` to `stats` and
    a numbers line per tokenizer to `numbers`."""
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops import merge_kernels as mk
    from tokenizers_tpu_torch.ops.charbpe_engine import CharBpeEngine
    from tokenizers_tpu_torch.ops.wordlevel_engine import WordLevelEngine
    from tokenizers_tpu_torch.smoke_data import (
        build_docs, config_json, ids_digest, load_digests, long_parts,
    )
    from tokenizers_tpu_torch.tools.timing import bound_ms, median_ms, nbytes, table_bytes

    docs = build_docs()
    long_docs = long_parts()["long"]
    runs, shapes, fast_shapes, capture = {}, {}, {}, {}
    for name in CHAR_LEVEL:
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok = Tokenizer.from_str(config_json(name))
        eng = tok._get_device_engine()
        tables_s = time.perf_counter() - t
        want = WordLevelEngine if name == "wordlevel" else CharBpeEngine
        if type(eng) is not want:
            raise SystemExit(f"{name}: the device engine is {type(eng).__name__}")
        parts = [("", docs)] + ([("_long", long_docs)] if name == "sp_bpe" else [])
        for suffix, part in parts:
            key = name + suffix
            digests = load_digests(key)
            cold = drive_path(torch, tok, part, key, counts, digests, passes=("cold",))["cold"]
            if name != "wordlevel":
                fast_shapes[key], errs = checked_again(
                    torch, lambda: tok.encode_batch_fast(part), key, cold["launches"],
                    lambda e: ids_digest(e.ids), digests, capture if key == "sp_bpe" else None)
                for k, e in errs.items():
                    stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], e)
            size = sum(len(d.encode("utf-8")) for d in part)
            numbers[key] = {
                "config": key, "docs": len(part), "bytes": size,
                "e2e_MBps": size / cold["secs"] / 1e6, "secs": cold["secs"],
                "program_s": cold["program_s"], "program_MBps": size / cold["program_s"] / 1e6,
                "bad_row_fraction": cold["bad_row_fraction"], "bad_rows": cold["bad_rows"],
                "host_pre_inputs": cold["host_pre_inputs"], "launches": cold["launches"],
                "tables_s": tables_s, "digests_matched": len(part),
            }
            runs[key] = cold["launches"]
        if name != "spm_bf":
            offs = offsets_run(torch, tok, docs, name, counts, load_digests(f"{name}_offsets"),
                               byte_sample=64)
            runs[f"{name}_offsets"] = offs["launches"]
            shapes[f"{name}_offsets"] = offs["checked_shapes"]
            for k, e in offs["checked_max_abs_err"].items():
                stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], e)
            numbers[name].update({f"offsets_{k}": offs[k] for k in (
                "MBps", "secs", "program_s", "host_encode_s", "bad_row_fraction",
                "byte_offsets_checked")})
        print("numbers " + json.dumps(numbers[name]), flush=True)
        if name == "sp_bpe":
            print("numbers " + json.dumps(numbers["sp_bpe_long"]), flush=True)
    shapes.update(fast_shapes)

    for key, launches in runs.items():
        merges = sum(launches[k] for k in ("keys", "merge_round_fused"))
        others = sum(n for k, n in launches.items() if k not in ("keys", "merge_round_fused",
                                                                 "merge_round_fused_wide"))
        if key.startswith("wordlevel"):
            if any(launches.values()):
                raise SystemExit(f"{key}: a kernel of csrc/ launched on the WordLevel path: "
                                 f"{launches}")
        elif merges == 0 or others:
            raise SystemExit(f"{key}: launches {launches}: B2 and B1 must run, B3 and B4 not")
    for key, by in shapes.items():
        widest = max([int(x.split("x")[1]) for k in by.values() for x in k] or [0])
        if widest > mk.WIDE_MAX_C:
            raise SystemExit(f"{key}: a merge row of {widest} positions")
    meta = fast_shapes["sp_bpe"].get("merge_round_fused_wide", {})
    if not all(any(x.endswith(f"x{w}") for x in meta) for w in (16388, 10368, 8320)):
        raise SystemExit(f"sp_bpe: the metaspace widths were not all launched: {meta}")
    cold = {name: {k: runs[name][k] for k in CHAR_COLD[name]} for name in CHAR_COLD}
    if cold != CHAR_COLD:
        raise SystemExit(f"char-level cold launches {cold}, want {CHAR_COLD}")
    # the cluster B1 timed at sp_bpe's first state, [256, 16388] (a last CTA of
    # 4 positions), on the inputs the path gave it
    args = capture[("merge_round_fused_wide", "256x16388")]
    got = mk.merge_round_fused_wide(*args)
    S, nc = mk.cluster_geometry(256, 16388, torch.cuda.get_device_properties(0)
                                .multi_processor_count)
    stats["merge_round_fused_wide"]["by_shape"]["256x16388"] = {
        "ms": median_ms(lambda: mk.merge_round_fused_wide(*args), 20),
        "plain_ms": median_ms(lambda: mk.merge_round_fused_plain(*args), 2),
        "bound_ms": bound_ms(nbytes(*args[:7], *got) + table_bytes(
            args[0], args[3], *args[4:6], *args[7:9])),
        "slice": S, "cluster": nc, "smem_bytes": mk.smem_bytes(S),
        "max_active_clusters": mk.max_clusters(S, nc),
        "from": "sp_bpe path, first [256, 8192] chunk expanded by Metaspace",
    }
    print("cluster B1 at sp_bpe's [256, 16388]: " + json.dumps(
        stats["merge_round_fused_wide"]["by_shape"]["256x16388"]), flush=True)
    for k, s_ in stats.items():
        s_["char_level_launches"] = {key: launches[k] for key, launches in runs.items()}
        s_["char_level_shapes"] = {key: by.get(k, {}) for key, by in shapes.items()}


def train_path(torch, stats, counts, numbers):
    """Phase 11, BPE, WordPiece and WordLevel training on the card, in
    torch ops on no kernel of `csrc/` (the JAX package trains in plain
    XLA): every B1-B4 count must stay 0 over the training runs.  (a)
    `bench.py`'s `train` config (the first 1 MB of the corpus, its lines'
    Whitespace words, vocab 512: the dense trainer) and (c) the whole
    corpus at vocab 16,000 (the dense trainer's widest run: a 16,001 x
    16,128 count matrix) against the wheel's merges and vocab digests
    (`data/train_digests.json`); (b) the SentencePieceBPETokenizer recipe
    (NFKC, Metaspace, `fuse_unk`; vocab 30,000, min_frequency 2,
    limit_alphabet 1000, `<unk>`: the per-round registry trainer)
    through `Tokenizer.train` on the corpus, whose vocab and 29,807 merges
    must equal the frozen `data/sp_bpe.json`, then `encode_batch_fast` of
    the 8 KB documents with the tokenizer it trained against the sp_bpe
    digests, with the frozen tokenizer's cold launches (CHAR_COLD); (d)
    the WordPieceTrainer (`##`) on (a)'s words at vocab 2,000 (dense)
    against the port's host BpeTrainer with the same prefix in this run;
    (e) the WordLevelTrainer (host only) on `data/wordlevel.json`'s
    pipeline against its vocab.  Prints, per run, the path, the seconds of
    feed, packing and tables and the device loop, merges per second, host
    reads per merge (counted by the trainer where it reads), host syncs
    per merge (measured: every synchronizing CUDA call of the run warns
    under `torch.cuda.set_sync_debug_mode("warn")` and is counted) and
    peak memory.  Adds each kernel's `train_path_launches` to `stats`."""
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.models.bpe import BPE
    from tokenizers_tpu_torch.models.wordpiece import WordPiece
    from tokenizers_tpu_torch.parallel import DistributedBpeTrainer
    from tokenizers_tpu_torch.pre_tokenizers.whitespace import Whitespace
    from tokenizers_tpu_torch.smoke_data import (
        CORPUS, TRAIN_RUNS, build_docs, config_json, load_digests, load_train_digests,
        merges_digest, recipe_json, train_lines, vocab_digest,
    )
    from tokenizers_tpu_torch.trainers import BpeTrainer, WordLevelTrainer, WordPieceTrainer

    def zero():
        for c in counts.values():
            for k in c:
                c[k] = 0

    def read():
        return {k: c[k] for k, c in counts.items()}

    zero()
    want = load_train_digests()
    ws = Whitespace()
    runs = {}

    def timed(fn):
        """(seconds, synchronizing CUDA calls) of fn()."""
        torch.cuda.reset_peak_memory_stats()
        _out, secs, syncs = timed_syncs(torch, fn)
        return secs, syncs

    def record(name, trainer, timing, path):
        st = trainer.stats
        secs, syncs = timing
        if st.get("path") != path:
            raise SystemExit(f"train {name}: path {st.get('path')} (want {path})")
        merges = st.get("merges")
        r = {"path": path, "secs": secs, "feed_s": st["feed_s"], "words": st["words"],
             "prepare_s": st.get("prepare_s"), "pack_and_tables_s": st.get("pack_s"),
             "device_loop_s": st.get("loop_s", st.get("train_s")), "merges": merges,
             "merges_per_s": merges / st["loop_s"] if merges else None,
             "host_reads_per_merge": st["host_reads"] / merges if merges else None,
             "host_syncs": syncs, "host_syncs_per_merge": syncs / merges if merges else None,
             "peak_allocated_GB": torch.cuda.max_memory_allocated() / 1e9,
             **{k: st[k] for k in ("shape", "words_shape", "v_cap", "v_pad", "p_cap",
                                   "registry_pairs", "registry_grown", "host_upsert_s",
                                   "mean_rows_per_round", "packed_rounds", "k_steps")
                if k in st}}
        runs[name] = r
        print("train " + json.dumps({"run": name, **r}), flush=True)

    def against_wheel(name, model):
        got = {"merges_sha256": merges_digest(model.merges_list),
               "n_merges": len(model.merges_list), "vocab_sha256": vocab_digest(model.vocab),
               "vocab_size": len(model.vocab)}
        if got != want[name]:
            raise SystemExit(f"train {name}: {got}, the wheel's {want[name]}")

    def bpe_run(name, path):
        nchars, vocab_size = TRAIN_RUNS[name]
        trainer = DistributedBpeTrainer(vocab_size=vocab_size)
        model = BPE({}, [])
        timing = timed(lambda: (trainer.feed(train_lines(nchars), ws.pre_tokenize),
                                trainer.train(model)))
        record(name, trainer, timing, path)
        against_wheel(name, model)

    # (a) bench.py's train config, on the dense trainer
    bpe_run("bench_512", "dense")

    # (b) the sp_bpe recipe at full size, on the per-round trainer
    tok = Tokenizer.from_str(recipe_json("sp_bpe"))
    trainer = BpeTrainer(vocab_size=30000, min_frequency=2, limit_alphabet=1000,
                         special_tokens=["<unk>"])
    record("sp_bpe_30000", trainer, timed(lambda: tok.train([CORPUS], trainer)), "per_round")
    frozen = json.loads(config_json("sp_bpe"))["model"]
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
              for m in frozen["merges"]]
    if (tok.model.vocab, tok.model.merges_list, tok.added) != (frozen["vocab"], merges,
                                                               {"<unk>": 0}):
        raise SystemExit(f"train sp_bpe_30000: {len(tok.model.vocab)} vocab entries and "
                         f"{len(tok.model.merges_list)} merges unlike data/sp_bpe.json's")
    launches = read()
    enc = drive_path(torch, tok, build_docs(), "sp_bpe trained", counts, load_digests("sp_bpe"),
                     passes=("cold",))["cold"]
    cold = {k: enc["launches"][k] for k in CHAR_COLD["sp_bpe"]}
    if cold != CHAR_COLD["sp_bpe"]:
        raise SystemExit(f"the trained sp_bpe's cold launches {cold}, want {CHAR_COLD['sp_bpe']}")
    runs["sp_bpe_30000"]["encode"] = {"docs_matched": len(build_docs()), "secs": enc["secs"],
                                      "program_s": enc["program_s"], "launches": enc["launches"]}
    TRAINED["sp_bpe_30000"] = (tok, "sp_bpe")
    zero()

    # (c) the dense trainer at its widest
    bpe_run("corpus_16000", "dense")

    # (d) WordPiece (the ## prefix) on the dense trainer, against the host loop
    lines = train_lines(TRAIN_RUNS["bench_512"][0])
    wp = WordPieceTrainer(vocab_size=2000)
    model = WordPiece({})
    record("wordpiece_2000", wp, timed(lambda: (wp.feed(lines, ws.pre_tokenize),
                                                 wp.train(model))), "dense")
    host = BpeTrainer(vocab_size=2000, continuing_subword_prefix="##", device="cpu")
    host.feed(lines, ws.pre_tokenize)
    host_model = BPE({}, [], continuing_subword_prefix="##")
    t = time.perf_counter()
    host.do_train(host.words, host_model)
    runs["wordpiece_2000"]["host_loop_s"] = time.perf_counter() - t
    if model.vocab != host_model.vocab:
        raise SystemExit("train wordpiece_2000: the vocab differs from the host BpeTrainer's")

    # (e) WordLevel (host only) on data/wordlevel.json's pipeline
    tok_wl = Tokenizer.from_str(recipe_json("wordlevel"))
    wl = WordLevelTrainer(vocab_size=30000, special_tokens=["[UNK]"])
    record("wordlevel_30000", wl, timed(lambda: tok_wl.train([CORPUS], wl)), "host")
    if tok_wl.model.vocab != json.loads(config_json("wordlevel"))["model"]["vocab"]:
        raise SystemExit("train wordlevel_30000: the vocab differs from data/wordlevel.json's")
    TRAINED["wordlevel_30000"] = (tok_wl, "wordlevel")

    for k, n in read().items():
        launches[k] += n
    if any(launches.values()):
        raise SystemExit(f"train: a kernel of csrc/ launched while training: {launches}")
    numbers["train"] = {"runs": runs, "phase_launches": launches}
    print("numbers " + json.dumps(numbers["train"]), flush=True)
    for k, s_ in stats.items():
        s_["train_path_launches"] = launches[k]


def timed_syncs(torch, fn):
    """(result, seconds, synchronizing CUDA calls) of fn(): every such call
    warns under `torch.cuda.set_sync_debug_mode("warn")` and is counted."""
    torch.cuda.synchronize()
    syncs = [0]

    def count(message, *args, **kwargs):
        syncs[0] += "synchronizing" in str(message)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = count
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t = time.perf_counter()
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, syncs[0]


def _em_sample(sentences, chunks, rng, n=2000):
    """A seeded sample of `n` of `sentences` spread over the buckets of
    `chunks` (DeviceEm's: a chunk's sentence indices are its 4th entry),
    plus 4 sentences over 512 bytes, words of the corpus joined."""
    from tokenizers_tpu_torch.ops.unigram_em_step import L_MAX

    pick = []
    by_size = sorted((c[3].cpu().numpy() for c in chunks), key=len)
    for k, idx in enumerate(by_size):  # an equal share of what is left, smallest first
        take = min(len(idx), (n - len(pick)) // (len(by_size) - k))
        pick.extend(rng.choice(idx, take, replace=False).tolist())
    out = [sentences[i] for i in sorted(pick)]
    words = [w for w, _ in sentences]
    for k in range(4):
        long = ""
        while len(long.encode("utf-8")) <= L_MAX:
            long += words[int(rng.integers(len(words)))]
        out.append((long, k + 1))
    return out


def unigram_train_path(torch, stats, counts, numbers):
    """Phase 12, Unigram EM training on the card (docstring item 12).  Adds
    each kernel's `unigram_train_launches` to `stats`."""
    import math

    import numpy as np

    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.models.unigram_lattice import Lattice
    from tokenizers_tpu_torch.ops.unigram_em_step import DeviceEm
    from tokenizers_tpu_torch.smoke_data import (
        UNIGRAM_TRAIN, build_docs, ids_digest, load_unigram_train, recipe_json, train_lines,
    )
    from tokenizers_tpu_torch.trainers import UnigramTrainer
    from tokenizers_tpu_torch.trainers.unigram_em import _make_unigram, _TrainerOps

    for c in counts.values():
        for k in c:
            c[k] = 0
    torch.cuda.reset_peak_memory_stats()
    want = load_unigram_train()
    lines = train_lines(UNIGRAM_TRAIN["chars"])

    def trainer():
        return UnigramTrainer(vocab_size=UNIGRAM_TRAIN["vocab_size"], special_tokens=["<unk>"],
                              unk_token="<unk>")

    tok = Tokenizer.from_str(recipe_json("unigram"))
    tr = trainer()
    _, secs, syncs = timed_syncs(torch, lambda: tok.train_from_iterator(lines, tr))
    st = tr.stats
    got = dict(tok.model.pieces)
    ref = dict((p, s_) for p, s_ in want["vocab"])
    if set(got) != set(ref) or len(tok.model.pieces) != len(want["vocab"]):
        raise SystemExit(f"unigram train: {len(set(got) - set(ref))} pieces not the wheel's, "
                         f"{len(set(ref) - set(got))} of the wheel's missing")
    off = [p for p in ref if not math.isclose(ref[p], got[p], rel_tol=1e-6, abs_tol=1e-4 * 16)]
    if off:
        raise SystemExit(f"unigram train: {len(off)} scores off the wheel's: {off[:5]}")
    if st["no_table_passes"]:
        raise SystemExit(f"unigram train: {st['no_table_passes']} passes had no device table")
    if tok.added != {"<unk>": 0}:
        raise SystemExit(f"unigram train: added tokens {tok.added}")
    train_launches = {k: c[k] for k, c in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9

    # the seed model's first E-step and Viterbi pass against the host lattices
    cfg = trainer()
    sentences = list(tr.words.items())
    ops = _TrainerOps(cfg, sentences)
    seed_model = _make_unigram([("<UNK>", float("nan"))] + ops.make_seed_sentence_pieces())
    (e1, z1, n1), e_s, e_syncs = timed_syncs(torch, lambda: ops.dev.e_step(seed_model))
    e2, z2, n2 = ops.dev.e_step(seed_model)
    if not (np.array_equal(e1, e2) and np.array_equal(z1, z2) and n1 == n2):
        raise SystemExit("unigram train: two E-steps of one model differ")
    sample = _em_sample(sentences, ops.dev.chunks, np.random.default_rng(0))
    dev = DeviceEm(sample)
    if len(dev.host_idx) != 4:
        raise SystemExit(f"unigram train: {len(dev.host_idx)} sample sentences on the host")
    ed, zd, nd = dev.e_step(seed_model)
    fd = dev.viterbi_freq(seed_model)
    eh = [0.0] * len(seed_model.pieces)
    fh = [0.0] * len(seed_model.pieces)
    zh, nh = [], 0
    for s_, n in sample:
        lat = Lattice(s_, seed_model.bos_id, seed_model.eos_id)
        seed_model.populate_nodes(lat)
        zh.append(lat.populate_marginal(float(n), eh))
        path = lat.viterbi()
        nh += len(path)
        for node in path:
            fh[node.id] += float(n)
    eh, zh = np.array(eh), np.array(zh)
    e_rel = float(np.max(np.abs(ed - eh) / np.maximum(np.abs(eh), 1e-300)))
    z_rel = float(np.max(np.abs(zd - zh) / np.maximum(np.abs(zh), 1e-300)))
    if e_rel > 1e-12 or z_rel > 1e-12 or nd != nh or not np.array_equal(fd, np.array(fh)):
        raise SystemExit(f"unigram train: the sample's E-step differs from the host lattices: "
                         f"expected rel {e_rel}, z rel {z_rel}, ntok {nd} vs {nh}, "
                         f"freq equal {np.array_equal(fd, np.array(fh))}")

    # the trained tokenizer encodes the 8 KB documents on the card
    docs = build_docs()
    t = time.perf_counter()
    encs = tok.encode_batch_fast(docs)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t
    bad = [i for i, (e, d) in enumerate(zip(encs, docs)) if e.ids != tok.encode_host(d).ids]
    if bad:
        raise SystemExit(f"unigram train: {len(bad)} documents unlike the host pipeline's: "
                         f"{bad[:10]}")
    launches = {k: c[k] for k, c in counts.items()}
    if any(launches.values()):
        raise SystemExit(f"unigram train: a kernel of csrc/ launched: {launches}")
    TRAINED_UNIGRAM["unigram_train"] = (tok, [ids_digest(e.ids) for e in encs])
    e_steps = st["e_step_s"]
    numbers["unigram_train"] = {
        "secs": secs, "feed_s": st["feed_s"], "words": st["words"], "pack_s": st["pack_s"],
        "chunks": st["chunks"], "seed_s": st["seed_s"], "seed_pieces": st["seed_pieces"],
        "em_rounds": st["em_rounds"], "e_steps": st["e_steps"],
        "first_e_step_s": e_steps[0], "last_e_step_s": e_steps[-1],
        "e_steps_s": sum(e_steps), "viterbi_freq_s": sum(st["viterbi_s"]),
        "viterbi_passes": len(st["viterbi_s"]), "prune_host_s": st["prune_host_s"],
        "m_step_s": st["m_step_s"], "host_sentences": st["host_sentences"],
        "no_table_passes": st["no_table_passes"], "train_syncs": syncs,
        "seed_model_e_step_s": e_s, "syncs_per_e_step": e_syncs,
        "sample": {"sentences": len(sample), "host_routed": len(dev.host_idx),
                   "expected_max_rel": e_rel, "z_max_rel": z_rel, "ntok": nd},
        "pieces_equal_wheel": True, "peak_allocated_GB": peak,
        "encode_8kb_s": enc_s, "docs_equal_host": len(docs), "train_launches": train_launches,
    }
    print("numbers " + json.dumps({"unigram_train": numbers["unigram_train"]}), flush=True)
    for k, s_ in stats.items():
        s_["unigram_train_launches"] = launches[k]


def decode_path(torch, stats, counts, numbers):
    """Phase 13, decode on the host (docstring item 13).  Adds each
    kernel's `decode_launches` to `stats`."""
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.smoke_data import (
        DECODE_CONFIGS, STREAM_CONFIGS, STREAM_DOCS, config_json, load_decode_digests,
        stream_digest, text_digest,
    )

    for c in counts.values():
        for k in c:
            c[k] = 0
    want = load_decode_digests()
    out = {}
    for name in DECODE_CONFIGS:
        ids = CARD_IDS[name]
        tok = Tokenizer.from_str(config_json(name))
        r = {}
        for key, skip in (("skip", True), ("keep", False)):
            t = time.perf_counter()
            texts = tok.decode_batch(ids, skip)
            r[f"{key}_s"] = time.perf_counter() - t
            bad = [i for i, x in enumerate(texts) if text_digest(x) != want[name][key][i]]
            if bad:
                raise SystemExit(f"decode {name} ({key} special tokens): {len(bad)} texts "
                                 f"unlike the wheel's: {bad[:10]}")
        if name in STREAM_CONFIGS:
            t = time.perf_counter()
            for i, doc_ids in enumerate(ids[:STREAM_DOCS]):
                ds = tok.decode_stream(True)
                if stream_digest(ds.step(x) for x in doc_ids) != want[name]["stream"][i]:
                    raise SystemExit(f"decode_stream {name}: document {i} unlike the wheel's")
            r["stream_s"] = time.perf_counter() - t
        r["docs"] = len(ids)
        out[name] = r
    launches = {k: c[k] for k, c in counts.items()}
    if any(launches.values()):
        raise SystemExit(f"decode: a kernel of csrc/ launched: {launches}")
    numbers["decode"] = out
    print("numbers " + json.dumps({"decode": out}), flush=True)
    for k, s_ in stats.items():
        s_["decode_launches"] = launches[k]


MULTIRANK_CONFIGS = ("gpt2", "llama3", "bert", "unigram", "char_bpe")  # llama3: llama3_128k
MULTIRANK_KERNELS = ("layout_fused", "layout_fused_wide", "keys", "merge_round_fused",
                     "merge_round_fused_wide")


def _near_tie_swaps(got, ref, tol=1.6e-3):
    """The pieces one piece list has and the other lacks, each with its
    score and whether it lies within `tol` of its list's lowest kept
    score (a near tie at the pruning's cut)."""
    out = []
    for mine, other, side in ((got, ref, "sharded only"), (ref, got, "single-rank only")):
        low = min(v for k, v in mine.items() if k != "<unk>")
        out += [{"piece": p, "score": mine[p], "side": side, "near_tie": mine[p] - low <= tol}
                for p in set(mine) - set(other)]
    return out


def multirank_rank(rank, world):
    """Phase 14's work in one of two gloo ranks sharing the card (started
    by `runtime.spawn`): `encode_batch_fast` of the 512 8 KB documents
    over the default mesh of both ranks with each of MULTIRANK_CONFIGS,
    every document against its digest, every launch of B3, B2 and B1 held
    bit for bit against its plain version in a second, checked run; then
    phase 11's train config (a) on the dense and the per-round trainer
    against the wheel's digests, and phase 12's Unigram setting against
    the wheel's pieces (the single-rank run's).  Returns the rank's
    numbers; raises on any mismatch."""
    import math

    import torch

    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.models.bpe import BPE
    from tokenizers_tpu_torch.ops import engine_base
    from tokenizers_tpu_torch.ops import layout_kernels as lk
    from tokenizers_tpu_torch.ops import merge_kernels as mk
    from tokenizers_tpu_torch.parallel import DistributedBpeTrainer, runtime
    from tokenizers_tpu_torch.parallel.bpe_train import check_replicated, train_per_round
    from tokenizers_tpu_torch.pre_tokenizers.whitespace import Whitespace
    from tokenizers_tpu_torch.smoke_data import (
        TRAIN_RUNS, UNIGRAM_TRAIN, build_docs, config_json, ids_digest, load_digests,
        load_train_digests, load_unigram_train, merges_digest, recipe_json, train_lines,
        vocab_digest,
    )
    from tokenizers_tpu_torch.trainers import BpeTrainer, UnigramTrainer

    mesh = runtime.build_mesh(("data",))
    shard = runtime.mesh_group(mesh)
    counts = {"layout_fused": lk.LAUNCHES, "layout_fused_wide": lk.LAUNCHES,
              "keys": mk.LAUNCHES, "merge_round_fused": mk.LAUNCHES,
              "merge_round_fused_wide": mk.LAUNCHES}
    out = {"rank": rank, "ranks": world, "backend": torch.distributed.get_backend(),
           "encode": {}, "train": {}}
    docs = build_docs()
    runtime.set_default_mesh(mesh)
    for config in MULTIRANK_CONFIGS:
        tok = Tokenizer.from_str(config_json(config))
        digests = load_digests(config)
        tok._get_device_engine()
        for c in counts.values():
            for k in c:
                c[k] = 0
        engine_base.STATS.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        encs = tok.encode_batch_fast(docs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {k: counts[k][k] for k in MULTIRANK_KERNELS}
        bad = [i for i, e in enumerate(encs) if ids_digest(e.ids) != digests[i]]
        if bad:
            raise SystemExit(f"multi-rank {config} (rank {rank}): {len(bad)} documents differ "
                             f"from their digests: {bad[:10]}")
        r = {"secs": secs, "launches": launches, **engine_base.STATS.snapshot()}
        if any(launches.values()):
            r["shapes"], r["max_abs_err"] = checked_again(
                torch, lambda: tok.encode_batch_fast(docs), f"multi-rank {config} rank {rank}",
                launches, lambda e: ids_digest(e.ids), digests)
        out["encode"][config] = r
    runtime.set_default_mesh(None)

    ws = Whitespace()
    want = load_train_digests()["bench_512"]
    nchars, vocab_size = TRAIN_RUNS["bench_512"]
    lines = train_lines(nchars)
    for path in ("dense", "per_round"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model = BPE({}, [])
        if path == "dense":
            tr = DistributedBpeTrainer(mesh=mesh, vocab_size=vocab_size)
            tr.feed(lines, ws.pre_tokenize)
            tr.train(model)
            st = tr.stats
        else:
            cfg = BpeTrainer(vocab_size=vocab_size)
            cfg.feed(lines, ws.pre_tokenize)
            w2i, i2w, words, wcounts = cfg.prepare(cfg.words)
            merges = train_per_round(cfg, w2i, i2w, words, wcounts, "cuda", cfg.stats, shard)
            check_replicated(merges, shard[0], "cuda")
            cfg.finalize_model(model, w2i, i2w, merges)
            st = cfg.stats
        torch.cuda.synchronize()
        got = {"merges_sha256": merges_digest(model.merges_list),
               "n_merges": len(model.merges_list), "vocab_sha256": vocab_digest(model.vocab),
               "vocab_size": len(model.vocab)}
        if got != want or st["path"] != path:
            raise SystemExit(f"multi-rank train (a) {path} (rank {rank}): {got} on the "
                             f"{st['path']} path, the single-rank run's {want}")
        out["train"][f"bench_512_{path}"] = {"secs": time.perf_counter() - t,
                                             "loop_s": st["loop_s"], "merges": st["merges"]}

    t = time.perf_counter()
    tok = Tokenizer.from_str(recipe_json("unigram"))
    tr = UnigramTrainer(vocab_size=UNIGRAM_TRAIN["vocab_size"], special_tokens=["<unk>"],
                        unk_token="<unk>", mesh=mesh)
    tok.train_from_iterator(train_lines(UNIGRAM_TRAIN["chars"]), tr)
    got = dict(tok.model.pieces)
    ref = {p: s_ for p, s_ in load_unigram_train()["vocab"]}
    swaps = _near_tie_swaps(got, ref)
    if any(not x["near_tie"] for x in swaps) or len(got) != len(ref):
        raise SystemExit(f"multi-rank unigram train (rank {rank}): pieces unlike the "
                         f"single-rank run's: {swaps[:10]}")
    off = [p for p in set(got) & set(ref)
           if not math.isclose(ref[p], got[p], rel_tol=1e-6, abs_tol=1e-4 * 16)]
    if off:
        raise SystemExit(f"multi-rank unigram train (rank {rank}): {len(off)} scores off: "
                         f"{off[:5]}")
    st = tr.stats
    out["train"]["unigram_8000"] = {
        "secs": time.perf_counter() - t, "e_steps": st["e_steps"],
        "e_steps_s": sum(st["e_step_s"]), "viterbi_freq_s": sum(st["viterbi_s"]),
        "chunks": st["chunks"], "pieces": len(got), "near_tie_swaps": swaps}
    return out


def multirank_dryrun_rank(rank, world):
    """One rank of `dryrun_multichip(2, backend="gloo")` (what it spawns,
    `entry._dryrun_rank`) under `checked_run`: every B3, B2 and B1 launch
    of its sharded encode held bit for bit against its plain version."""
    import torch

    from tokenizers_tpu_torch import entry as port_entry

    out, shapes, errs = checked_run(torch, lambda: port_entry._dryrun_rank(rank, world, None))
    return {**out, "shapes": shapes, "max_abs_err": errs}


def multirank_path(torch, stats, counts, numbers, smi):
    """Phase 14, the multi-rank runtime (docstring item 14).  Adds each
    kernel's `multirank_launches` (per rank) to `stats`."""
    import tempfile

    import numpy as np

    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch import entry as port_entry
    from tokenizers_tpu_torch.models.bpe import BPE
    from tokenizers_tpu_torch.ops.unigram_em_step import DeviceEm
    from tokenizers_tpu_torch.parallel import (
        DistributedBpeTrainer, runtime, shard_encode_batch_arrays,
    )
    from tokenizers_tpu_torch.parallel.bpe_train import train_per_round
    from tokenizers_tpu_torch.pre_tokenizers.whitespace import Whitespace
    from tokenizers_tpu_torch.smoke_data import (
        TRAIN_RUNS, build_docs, ids_digest, load_digests, load_train_digests,
        merges_digest, recipe_json, train_lines, vocab_digest,
    )
    from tokenizers_tpu_torch.trainers import BpeTrainer

    def zero():
        for c in counts.values():
            for k in c:
                c[k] = 0

    def read():
        return {k: c[k] for k, c in counts.items()}

    def key(out):  # a program's outputs, bit for bit
        return [t.cpu().numpy().tobytes() if torch.is_tensor(t) else repr(t) for t in out]

    phase = {"card": smi}
    t_phase = time.perf_counter()
    errs_a = []

    # ---- (a) a one-rank NCCL group in this process
    docs = build_docs()
    with tempfile.TemporaryDirectory(prefix="tt_store_") as d:
        t = time.perf_counter()
        runtime.initialize(f"file://{d}/store", 1, 0, backend="nccl")
        try:
            backend = torch.distributed.get_backend()
            if backend != "nccl":
                raise SystemExit(f"multi-rank: the one-rank group runs {backend}, not nccl")
            mesh = runtime.build_mesh(("data",))
            one = {"backend": backend, "ranks": 1}
            tok = Tokenizer.from_file(GPT2)
            eng = tok._get_device_engine()
            digests = load_digests("gpt2")
            zero()
            t0 = time.perf_counter()
            chunks = shard_encode_batch_arrays(eng, docs, mesh)
            torch.cuda.synchronize()
            one["shard_encode_s"] = time.perf_counter() - t0
            launches_a = read()
            _shapes, errs = checked_again(
                torch, lambda: shard_encode_batch_arrays(eng, docs, mesh),
                "multi-rank shard_encode_batch_arrays (nccl)", launches_a, key,
                [key(ch) for ch in chunks])
            errs_a.append(errs)
            flagged = matched = 0
            for ids, ntok, bad, orig in chunks:
                ids, ntok, bad = ids.cpu().numpy(), ntok.cpu().numpy(), bad.cpu().numpy()
                for r, i in enumerate(orig):
                    if bad[r]:
                        flagged += 1
                    elif ids_digest(ids[r, :ntok[r]].tolist()) != digests[i]:
                        raise SystemExit(f"multi-rank shard_encode_batch (nccl): document {i}")
                    else:
                        matched += 1
            one.update(shard_encode_docs_matched=matched, shard_encode_flagged=flagged,
                       flagged_share=flagged / len(docs))
            ws = Whitespace()
            want = load_train_digests()["bench_512"]
            nchars, vocab_size = TRAIN_RUNS["bench_512"]
            lines = train_lines(nchars)
            for path in ("dense", "per_round"):
                model = BPE({}, [])
                t0 = time.perf_counter()
                if path == "dense":
                    tr = DistributedBpeTrainer(mesh=mesh, vocab_size=vocab_size)
                    tr.feed(lines, ws.pre_tokenize)
                    tr.train(model)
                else:
                    cfg = BpeTrainer(vocab_size=vocab_size)
                    cfg.feed(lines, ws.pre_tokenize)
                    w2i, i2w, words, wcounts = cfg.prepare(cfg.words)
                    cfg.finalize_model(model, w2i, i2w, train_per_round(
                        cfg, w2i, i2w, words, wcounts, "cuda", cfg.stats,
                        runtime.mesh_group(mesh)))
                got = {"merges_sha256": merges_digest(model.merges_list),
                       "n_merges": len(model.merges_list),
                       "vocab_sha256": vocab_digest(model.vocab), "vocab_size": len(model.vocab)}
                if got != want:
                    raise SystemExit(f"multi-rank train (a) {path} (nccl): {got}, want {want}")
                one[f"train_bench_512_{path}_s"] = time.perf_counter() - t0
            # DeviceEm over the mesh against the unsharded, bit for bit at one rank
            tok_u = Tokenizer.from_str(recipe_json("unigram"))
            words = {}
            for line in train_lines(1 << 17):
                for w in tok_u.train_words(line):
                    words[w] = words.get(w, 0) + 1
            sentences = list(words.items())
            model = Tokenizer.from_file(UNIGRAM).model
            t0 = time.perf_counter()
            sharded = DeviceEm(sentences, mesh=mesh)
            got = (*sharded.e_step(model), sharded.viterbi_freq(model))
            one["device_em_s"] = time.perf_counter() - t0
            plain = DeviceEm(sentences)
            ref = (*plain.e_step(model), plain.viterbi_freq(model))
            if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit("multi-rank DeviceEm (nccl, one rank) differs from unsharded")
            fn, args = port_entry.entry()
            zero()
            e_ids, e_ntok, e_bad = fn(*args)
            launches_e = read()
            _shapes, errs = checked_again(torch, lambda: [fn(*args)],
                                          "multi-rank entry() (nccl)", launches_e, key,
                                          [key((e_ids, e_ntok, e_bad))])
            errs_a.append(errs)
            for r, n in enumerate(args[1].tolist()):
                text = bytes(args[0][r, :n].tolist()).decode("utf-8")
                if bool(e_bad[r]) or e_ids[r, :int(e_ntok[r])].tolist() != \
                        tok.encode_host(text, False).ids:
                    raise SystemExit(f"multi-rank entry(): row {r} unlike the host pipeline")
        finally:
            runtime.shutdown()
        one["secs"] = time.perf_counter() - t
    phase["nccl_one_rank"] = one
    print("multi-rank nccl one rank: " + json.dumps(one), flush=True)

    # ---- (b) two gloo ranks sharing the card
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = runtime.spawn(multirank_rank, 2, backend="gloo", timeout_s=600)
    phase["gloo_two_ranks"] = {"secs": time.perf_counter() - t, "ranks": ranks}
    for r in ranks:
        print(f"multi-rank gloo rank {r['rank']}: " + json.dumps(r), flush=True)

    # ---- (c) the dry run in two gloo ranks: `dryrun_multichip(2, backend="gloo")`
    # with every launch held against its plain version
    t = time.perf_counter()
    dry = runtime.spawn(multirank_dryrun_rank, 2, backend="gloo", timeout_s=600)
    phase["dryrun_gloo_two_ranks"] = {"secs": time.perf_counter() - t, "ranks": dry}
    print("multi-rank dryrun_multichip(2, backend='gloo'): " + json.dumps(dry), flush=True)
    phase["secs"] = time.perf_counter() - t_phase
    numbers["multirank"] = phase
    print("numbers " + json.dumps({"multirank": {k: v for k, v in phase.items()
                                                 if k != "gloo_two_ranks"}}), flush=True)
    for k, s_ in stats.items():
        per_rank = [sum(r["encode"][c]["launches"].get(k, 0) for c in MULTIRANK_CONFIGS)
                    for r in ranks]
        s_["multirank_launches"] = {"nccl_shard_encode": launches_a[k],
                                    "nccl_entry": launches_e[k],
                                    "gloo_rank0": per_rank[0], "gloo_rank1": per_rank[1],
                                    "gloo_dryrun": [sum(r["shapes"].get(k, {}).values())
                                                    for r in dry]}
        for err in errs_a + [r["max_abs_err"] for r in dry]:
            s_["max_abs_err"] = max(s_["max_abs_err"], err.get(k, 0))
        for r in ranks:
            for c in MULTIRANK_CONFIGS:
                err = r["encode"][c].get("max_abs_err", {})
                s_["max_abs_err"] = max(s_["max_abs_err"], err.get(k, 0))


RECIPE_KERNELS = ("layout_fused", "keys", "merge_round_fused")  # B3, B2, B1


def recipes_path(torch, stats, counts, numbers, smi):
    """Phase 15, the Tokenizer's full surface and the recipes (docstring
    item 15).  Adds each kernel's `recipes_launches` ((a) and (d)) and
    `to_str_launches` ((b)) to `stats`."""
    import tempfile

    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.added_vocabulary import AddedToken
    from tokenizers_tpu_torch.implementations import BertWordPieceTokenizer, ByteLevelBPETokenizer
    from tokenizers_tpu_torch.smoke_data import (
        BERT_PAIR_SETTINGS, RECIPE_EXTRA, RECIPE_SETTINGS, RECIPE_TOKEN, RECIPE_TRAIN,
        TO_STR_CONFIGS, apply_settings, bert_pairs, build_docs, config_json, ids_digest,
        load_digests, load_recipes_digests, offsets_digest, recipe_digest, text_digest,
        train_lines,
    )

    t_phase = time.perf_counter()
    want = load_recipes_digests()
    docs = build_docs()
    if any(RECIPE_TOKEN in d for d in docs):
        raise SystemExit(f"recipes: {RECIPE_TOKEN!r} lies in an 8 KB document")
    inputs = docs + RECIPE_EXTRA
    out = {}

    def zero():
        for c in counts.values():
            for k in c:
                c[k] = 0

    def read():
        return {k: c[k] for k, c in counts.items()}

    def merge_errs(errs):
        for k, e in errs.items():
            stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], e)

    def counted(name, tok, fn, digest, digests, checked_fn):
        """fn() cold on `tok` (its engine built first), counts set to 0 just
        before and read just after, every encoding against `digests`; B3, B2
        and B1 must launch; then `checked_fn` (the same run on a tokenizer
        in the same state) with every launch held against its plain
        version."""
        getattr(tok, "_tokenizer", tok)._get_device_engine()  # a recipe holds its Tokenizer
        zero()
        torch.cuda.synchronize()
        t = time.perf_counter()
        encs = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = read()
        bad = [i for i, e in enumerate(encs) if digest(e) != digests[i]]
        if bad:
            raise SystemExit(f"recipes {name}: {len(bad)} inputs differ from the wheel's "
                             f"digests: {bad[:10]}")
        missing = [k for k in RECIPE_KERNELS if launches[k] == 0]
        if missing:
            raise SystemExit(f"recipes {name}: {missing} never launched")
        shapes, errs = checked_again(torch, checked_fn, f"recipes {name}", launches, digest,
                                     digests)
        merge_errs(errs)
        r = {"secs": secs, "inputs": len(encs), "launches": launches,
             "overflowing": sum(len(e.overflowing) for e in encs), "checked_shapes": shapes}
        print("recipes " + json.dumps({"run": name, **{k: v for k, v in r.items()
                                                       if k != "checked_shapes"}}), flush=True)
        return r

    # (a) the recipe path: ByteLevelBPETokenizer from the files BPE.save writes
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recipes_")
    try:
        files = Tokenizer.from_str(config_json("gpt2")).model.save(tmp)
        vocab_txt = Tokenizer.from_str(config_json("bert")).model.save(tmp)[0]

        def slice_tokenizer():
            tok = ByteLevelBPETokenizer.from_file(*files)
            tok.add_special_tokens(["<|endoftext|>"])
            tok.add_tokens([AddedToken(RECIPE_TOKEN, lstrip=True, rstrip=True)])
            apply_settings(tok, RECIPE_SETTINGS)
            return tok

        tok, other = slice_tokenizer(), slice_tokenizer()
        a = {"fast": counted("a_fast", tok, lambda: tok.encode_batch_fast(inputs),
                             recipe_digest, want["slice_fast"],
                             lambda: other.encode_batch_fast(inputs))}
        a["offsets"] = counted("a_offsets", tok, lambda: tok.encode_batch(inputs),
                               offsets_digest, want["slice_offsets"],
                               lambda: tok.encode_batch(inputs))
        s = tok.to_str()
        if text_digest(s) != want["slice_to_str"]:
            raise SystemExit("recipes a: to_str unlike the wheel's")
        back, back2 = Tokenizer.from_str(s), Tokenizer.from_str(s)
        if back.to_str() != s:
            raise SystemExit("recipes a: from_str(to_str()) does not give to_str back")
        a["round_trip"] = counted("a_round_trip", back, lambda: back.encode_batch_fast(inputs),
                                  recipe_digest, want["slice_fast"],
                                  lambda: back2.encode_batch_fast(inputs))
        a["host_inputs"] = len(RECIPE_EXTRA)
        out["a"] = a

        # (b) to_str -> from_str on the card for every tokenizer phases 3-13 load or train
        b, b_launches = {}, {}
        sources = [(c, Tokenizer.from_str(config_json(c)), c) for c in TO_STR_CONFIGS]
        sources += [(run, tk, frozen) for run, (tk, frozen) in TRAINED.items()]
        for name, src, frozen in sources:
            t = time.perf_counter()
            s = src.to_str()
            if text_digest(s) != want["to_str"][frozen]:
                raise SystemExit(f"recipes b {name}: to_str unlike the wheel's of {frozen}")
            rt = Tokenizer.from_str(s)
            zero()
            encs, shapes, errs = checked_run(torch, lambda: rt.encode_batch_fast(docs))
            launches = read()
            merge_errs(errs)
            digests = load_digests(frozen)
            bad = [i for i, e in enumerate(encs) if ids_digest(e.ids) != digests[i]]
            if bad:
                raise SystemExit(f"recipes b {name}: {len(bad)} documents differ from the "
                                 f"{frozen} digests: {bad[:10]}")
            for k, n in launches.items():
                b_launches[k] = b_launches.get(k, 0) + n
            b[name] = {"secs": time.perf_counter() - t, "launches": launches,
                       "checked_shapes": shapes}
        out["b"] = {k: {"secs": v["secs"], "launches": v["launches"]} for k, v in b.items()}
        print("recipes " + json.dumps({"run": "b_to_str", **out["b"]}), flush=True)

        # (c) BertWordPieceTokenizer from the vocab.txt WordPiece.save writes, on pairs
        bert = BertWordPieceTokenizer(vocab_txt)
        apply_settings(bert, BERT_PAIR_SETTINGS)
        pairs = bert_pairs(docs)
        zero()
        t = time.perf_counter()
        encs = bert.encode_batch(pairs)
        fast = bert.encode_batch_fast(pairs)
        c_secs = time.perf_counter() - t
        if [recipe_digest(e) for e in encs] != want["bert_pairs"] or \
                [recipe_digest(e) for e in fast] != want["bert_pairs"]:
            raise SystemExit("recipes c: the pairs' encodings differ from the wheel's digests")
        if text_digest(bert.to_str()) != want["bert_to_str"]:
            raise SystemExit("recipes c: to_str unlike the wheel's")
        if any(read().values()):
            raise SystemExit(f"recipes c: a kernel of csrc/ launched: {read()}")
        out["c"] = {"pairs": len(pairs), "secs": c_secs,
                    "overflowing": sum(len(e.overflowing) for e in encs)}
    finally:
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)

    # (d) ByteLevelBPETokenizer trained on the card (the dense trainer)
    trained = ByteLevelBPETokenizer()
    zero()
    t = time.perf_counter()
    trained.train_from_iterator(train_lines(RECIPE_TRAIN["chars"]),
                                vocab_size=RECIPE_TRAIN["vocab_size"],
                                special_tokens=RECIPE_TRAIN["special_tokens"], show_progress=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    if any(read().values()):
        raise SystemExit(f"recipes d: a kernel of csrc/ launched while training: {read()}")
    s = trained.to_str()
    if text_digest(s) != want["trained_to_str"]:
        raise SystemExit("recipes d: the trained tokenizer's to_str unlike the wheel's")
    again = Tokenizer.from_str(s)
    d = counted("d_trained", trained, lambda: trained.encode_batch_fast(docs),
                lambda e: ids_digest(e.ids), want["trained_fast"],
                lambda: again.encode_batch_fast(docs))
    d["train_s"] = train_s
    d["vocab_size"] = trained.get_vocab_size()
    out["d"] = d

    out["phase_s"] = time.perf_counter() - t_phase
    numbers["recipes"] = out
    print("numbers " + json.dumps({"recipes": out}), flush=True)
    print(f"phase 15 (recipes): {out['phase_s']:.1f} s on {smi}", flush=True)
    for k, s_ in stats.items():
        s_["recipes_launches"] = {"a_fast": a["fast"]["launches"][k],
                                  "a_offsets": a["offsets"]["launches"][k],
                                  "d_trained": d["launches"][k]}
        s_["to_str_launches"] = b_launches[k]


HOST_PIPELINE_KERNELS = {"gpt2_ignore_merges": ("layout_fused", "keys", "merge_round_fused"),
                         "llama3_prefix": ("keys", "merge_round_fused")}


def host_pipelines_path(torch, stats, counts, numbers, smi):
    """Phase 16, the general host pipeline and the byte-level engine's new
    pipelines (docstring item 16).  Adds each kernel's
    `host_pipelines_launches` to `stats`."""
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops.bpe_engine import ByteLevelBpeEngine
    from tokenizers_tpu_torch.smoke_data import (
        ENGINE_PIPELINES, HOST_PIPELINES, host_pipeline_docs, host_pipelines, ids_digest,
        load_host_pipelines_digests, offsets_digest,
    )

    t_phase = time.perf_counter()
    blobs, want = host_pipelines(), load_host_pipelines_digests()
    out = {"a": {}, "b": {}, "c": {}}

    def zero():
        for c in counts.values():
            for k in c:
                c[k] = 0

    def read():
        return {k: c[k] for k, c in counts.items()}

    def check(name, encs, digest, digests):
        bad = [i for i, e in enumerate(encs) if digest(e) != digests[i]]
        if bad:
            raise SystemExit(f"host pipelines {name}: {len(bad)} documents differ from the "
                             f"wheel's digests: {bad[:10]}")

    # (a) the general host pipeline
    for name in HOST_PIPELINES:
        tok = Tokenizer.from_str(blobs[name])
        if tok._get_device_engine() is not None:
            raise SystemExit(f"host pipelines {name}: a device engine took it")
        docs = host_pipeline_docs(name)
        mb = sum(len(d.encode("utf-8")) for d in docs) / 1e6
        zero()
        t = time.perf_counter()
        fast = tok.encode_batch_fast(docs)
        fast_s = time.perf_counter() - t
        check(f"{name} fast", fast, lambda e: ids_digest(e.ids), want[name]["fast"])
        t = time.perf_counter()
        offs = tok.encode_batch(docs)
        offs_s = time.perf_counter() - t
        check(f"{name} offsets", offs, offsets_digest, want[name]["offsets"])
        if any(read().values()):
            raise SystemExit(f"host pipelines {name}: a kernel of csrc/ launched: {read()}")
        out["a"][name] = {"docs": len(docs), "mb": mb, "fast_s": fast_s,
                          "fast_mb_s": mb / fast_s, "offsets_s": offs_s,
                          "offsets_mb_s": mb / offs_s}
        print(f"host pipeline {name}: {len(docs)} documents, {mb:.3f} MB, encode_batch_fast "
              f"{fast_s:.3f} s ({mb / fast_s:.3f} MB/s), encode_batch {offs_s:.3f} s "
              f"({mb / offs_s:.3f} MB/s), every digest equal, on {smi}", flush=True)

    # (b) the byte-level engine's new pipelines, every launch held
    b_launches = {k: {} for k in stats}
    for name in ENGINE_PIPELINES:
        tok = Tokenizer.from_str(blobs[name])
        if not isinstance(tok._get_device_engine(), ByteLevelBpeEngine):
            raise SystemExit(f"host pipelines {name}: not on the byte-level engine")
        docs = host_pipeline_docs(name)
        runs = drive_path(torch, tok, docs, name, counts, digests=want[name]["fast"])
        cold = runs["cold"]["launches"]
        missing = [k for k in HOST_PIPELINE_KERNELS.get(name, ()) if cold[k] == 0]
        if missing:
            raise SystemExit(f"host pipelines {name}: {missing} never launched")
        other = Tokenizer.from_str(blobs[name])
        other._get_device_engine()
        zero()
        shapes, errs = checked_again(torch, lambda: other.encode_batch_fast(docs),
                                     f"host pipelines {name}", cold,
                                     lambda e: ids_digest(e.ids), want[name]["fast"])
        for k, e in errs.items():
            stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], e)
        for k in stats:
            b_launches[k][name] = cold[k]
        mb = sum(len(d.encode("utf-8")) for d in docs) / 1e6
        out["b"][name] = {r: {"secs": v["secs"], "mb_s": mb / v["secs"],
                              "program_s": v["program_s"], "launches": v["launches"],
                              "bad_row_fraction": v["bad_row_fraction"]}
                          for r, v in runs.items()}
        out["b"][name]["checked_shapes"] = shapes
        print("host pipelines " + json.dumps({"run": name, **out["b"][name]}), flush=True)

    # (c) to_str -> from_str, then one cold pass
    for name in HOST_PIPELINES + ENGINE_PIPELINES:
        s = Tokenizer.from_str(blobs[name]).to_str()
        rt = Tokenizer.from_str(s)
        if rt.to_str() != s:
            raise SystemExit(f"host pipelines {name}: from_str(to_str()) gives another to_str")
        docs = host_pipeline_docs(name)
        zero()
        torch.cuda.synchronize()
        t = time.perf_counter()
        encs = rt.encode_batch_fast(docs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        check(f"{name} round trip", encs, lambda e: ids_digest(e.ids), want[name]["fast"])
        launches = read()
        missing = [k for k in HOST_PIPELINE_KERNELS.get(name, ()) if launches[k] == 0]
        if missing:
            raise SystemExit(f"host pipelines {name} round trip: {missing} never launched")
        out["c"][name] = {"secs": secs, "launches": launches}
    print("host pipelines " + json.dumps({"run": "c_round_trip", **out["c"]}), flush=True)

    out["phase_s"] = time.perf_counter() - t_phase
    numbers["host_pipelines"] = out
    print(f"phase 16 (host pipelines): {out['phase_s']:.1f} s on {smi}", flush=True)
    for k, s_ in stats.items():
        s_["host_pipelines_launches"] = b_launches[k]


C_ABI_KERNELS = ("layout_fused", "keys", "merge_round_fused")  # B3, B2, B1
POOL_DECODE_CONFIGS = ("gpt2", "llama3")  # llama3: llama3_128k


def host_modules_path(torch, stats, counts, numbers, smi):
    """Phase 17, the last host modules (docstring item 17).  Adds each
    kernel's `c_abi_launches` to `stats`."""
    import math
    import tempfile

    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.models.unigram import Unigram
    from tokenizers_tpu_torch.native import build_c_api, build_c_driver, c_api_env
    from tokenizers_tpu_torch.smoke_data import (
        T5_SHAPE, build_docs, config_json, host_pipeline_docs, host_pipelines,
        ids_digest, load_decode_digests, load_digests, load_host_pipelines_digests,
        load_unigram_round_trip_digests, load_unigram_train, offsets_digest, recipe_json,
        text_digest,
    )
    from tokenizers_tpu_torch.utils import parallelism
    from tokenizers_tpu_torch.utils.serde_float import serde_f64

    t_phase = time.perf_counter()
    out = {"a": {}, "b": {}, "c": {}}

    def zero():
        for c in counts.values():
            for k in c:
                c[k] = 0

    def read():
        return {k: c[k] for k, c in counts.items()}

    # (a) t5_shape on the host: the default, then TOKENIZERS_PARALLELISM false and true
    tok = Tokenizer.from_str(host_pipelines()[T5_SHAPE])
    if tok._get_device_engine() is not None:
        raise SystemExit("t5_shape: a device engine took it")
    docs, want = host_pipeline_docs(T5_SHAPE), load_host_pipelines_digests()[T5_SHAPE]
    mb = sum(len(d.encode("utf-8")) for d in docs) / 1e6
    results = {}
    saved = os.environ.get(parallelism.ENV_VARIABLE)
    try:
        for run in ("default", "false", "true"):
            if run != "default":
                os.environ[parallelism.ENV_VARIABLE] = run
            if run == "true":  # the workers up and holding t5_shape: the pool's own speed
                parallelism.start_pool(wait=True)
                tok.encode_batch_fast(docs[:8])
                pool = parallelism.start_pool(wait=True)
                pool.used = False
            zero()
            t = time.perf_counter()
            fast = tok.encode_batch_fast(docs)
            fast_s = time.perf_counter() - t
            t = time.perf_counter()
            offs = tok.encode_batch(docs)
            offs_s = time.perf_counter() - t
            got = ([ids_digest(e.ids) for e in fast], [offsets_digest(e) for e in offs])
            if got != (want["fast"], want["offsets"]):
                bad = [i for i, (g, w) in enumerate(zip(got[0] + got[1],
                                                        want["fast"] + want["offsets"])) if g != w]
                raise SystemExit(f"t5_shape ({run}): {len(bad)} digests unlike the wheel's")
            if any(read().values()):
                raise SystemExit(f"t5_shape ({run}): a kernel of csrc/ launched: {read()}")
            results[run] = got
            out["a"][run] = {"fast_s": fast_s, "fast_mb_s": mb / fast_s, "offsets_s": offs_s,
                             "offsets_mb_s": mb / offs_s, "pool": parallelism.get_parallelism()}
        if results["false"] != results["true"]:
            raise SystemExit("t5_shape: the pool's results differ from the serial ones")
        if not pool.used:
            raise SystemExit("t5_shape: no worker of the host pool took a chunk")
        out["a"]["pool_up_s"] = pool.up_s
        # decode_batch at its threshold (64 sequences) and at 512: serial
        # against the pool, whose workers hold the tokenizer (one untimed call)
        dtok = Tokenizer.from_str(config_json("gpt2"))
        for n in (64, 512):
            ids = CARD_IDS["gpt2"][:n]
            for run in ("false", "true"):
                os.environ[parallelism.ENV_VARIABLE] = run
                dtok.decode_batch(ids)
                parallelism.start_pool(wait=True)
                t = time.perf_counter()
                dtok.decode_batch(ids)
                out["a"][f"decode_{n}_{run}_s"] = time.perf_counter() - t
        # decode_batch of phase 13's ids on the pool: the largest vocab and gpt2
        os.environ[parallelism.ENV_VARIABLE] = "true"
        dwant = load_decode_digests()
        t = time.perf_counter()
        for name in POOL_DECODE_CONFIGS:
            dtok = Tokenizer.from_str(config_json(name))
            texts = dtok.decode_batch(CARD_IDS[name], True)
            bad = [i for i, x in enumerate(texts) if text_digest(x) != dwant[name]["skip"][i]]
            if bad:
                raise SystemExit(f"decode {name} on the pool: {len(bad)} texts unlike the wheel's")
        out["a"]["decode_pool_s"] = time.perf_counter() - t
    finally:
        if saved is None:
            os.environ.pop(parallelism.ENV_VARIABLE, None)
        else:
            os.environ[parallelism.ENV_VARIABLE] = saved
    if not parallelism.has_used_parallelism():
        raise SystemExit("t5_shape: the host pool never ran")
    out["a"]["docs"], out["a"]["mb"] = len(docs), mb
    print("host modules " + json.dumps({"run": "a_t5_shape", **out["a"]}), flush=True)

    # (b) the C ABI: the library, both drivers, 512 gpt2 documents on the card
    gpt2_docs = build_docs()
    env = c_api_env()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        so = build_c_api(force=True)
        ours = build_c_driver(os.path.join(REPO, "tests", "c_api_torch_driver.c"),
                              os.path.join(tmp, "ours"))
        plain = build_c_driver(os.path.join(REPO, "tests", "c_api_driver.c"),
                               os.path.join(tmp, "plain"))
        out["b"]["build_s"] = time.perf_counter() - t
        path = os.path.join(tmp, "docs.bin")
        with open(path, "wb") as f:
            f.write(b"\0".join(d.encode("utf-8") for d in gpt2_docs))
        t = time.perf_counter()
        r = subprocess.run([ours, GPT2, "card", "batch", path, "--launches"], env=env,
                           capture_output=True, text=True, timeout=600)
        out["b"]["driver_s"] = time.perf_counter() - t
        if r.returncode != 0:
            raise SystemExit(f"C ABI driver: rc {r.returncode}: {r.stderr[-3000:]}")
        fields = dict(line.split(": ", 1) for line in r.stdout.splitlines() if ": " in line)
        want_ids = load_digests("gpt2")
        got = [ids_digest([int(x) for x in fields[f"ids[{i}]"].split()])
               for i in range(len(gpt2_docs))]
        bad = [i for i, (g, w) in enumerate(zip(got, want_ids)) if g != w]
        if bad or len(got) != len(want_ids):
            raise SystemExit(f"C ABI: {len(bad)} of {len(got)} documents unlike gpt2's digests")
        launches = json.loads(fields["launches"])
        missing = [k for k in C_ABI_KERNELS if launches[k] == 0]
        if missing:
            raise SystemExit(f"C ABI: {missing} never launched in the embedded interpreter")
        out["b"]["launches"] = launches
        # the JAX package's driver, unchanged, with no visible card: its
        # tokenizers_create must fail (there is no CPU fallback)
        r = subprocess.run([plain, GPT2, "Hello"], env={**env, "CUDA_VISIBLE_DEVICES": ""},
                           capture_output=True, text=True, timeout=600)
        if r.returncode == 0 or "no CUDA device" not in r.stderr:
            raise SystemExit(f"C ABI without a card: rc {r.returncode}, {r.stderr[-1000:]}")
        out["b"]["no_card"] = r.stderr.strip().splitlines()[-1]
    out["b"]["library"] = os.path.basename(so)
    print("host modules " + json.dumps({"run": "b_c_abi", **out["b"]}), flush=True)

    # (c) a trained Unigram through to_str, on the card again.  Scores read
    # back as the wheel reads them (serde_json's parse, lossy in the last
    # ulp), so ids may move.  The witness: the committed model of
    # `unigram_train.json`, held exactly, gives the wheel's ids in memory
    # and after the round trip (`data/unigram_round_trip_digests.json`, the
    # wheel's own round trip).  Phase 12's model: each score reads back as
    # serde_json parses what `to_str` wrote, and the card's ids equal the
    # round-tripped model's host pipeline; the documents that moved are
    # counted.
    wheel = load_unigram_round_trip_digests()
    committed = load_unigram_train()
    exact = Tokenizer.from_str(recipe_json("unigram"))
    exact.model = Unigram([tuple(p) for p in committed["vocab"]], committed["unk_id"])
    exact.add_special_tokens(["<unk>"])
    zero()
    for name, t_ in (("trained", exact), ("round_trip", Tokenizer.from_str(exact.to_str()))):
        got = [ids_digest(e.ids) for e in t_.encode_batch_fast(gpt2_docs)]
        bad = [i for i, (g, w) in enumerate(zip(got, wheel[name])) if g != w]
        if bad or len(got) != len(wheel[name]):
            raise SystemExit(f"unigram to_str witness ({name}): {len(bad)} documents unlike "
                             f"the wheel's: {bad[:10]}")
    if any(read().values()):
        raise SystemExit(f"unigram to_str witness: a kernel of csrc/ launched: {read()}")
    out["c"]["wheel_docs_moved"] = sum(a != b for a, b in zip(wheel["trained"],
                                                              wheel["round_trip"]))
    trained, digests = TRAINED_UNIGRAM["unigram_train"]
    s = trained.to_str()
    rt = Tokenizer.from_str(s)
    if Tokenizer.from_str(rt.to_str()).to_str() != rt.to_str():
        raise SystemExit("unigram to_str round trip: a second round trip changes to_str")
    if [p for p, _ in rt.model.pieces] != [p for p, _ in trained.model.pieces] or any(
            b != serde_f64(repr(a)) for (_, a), (_, b) in zip(trained.model.pieces,
                                                            rt.model.pieces)):
        raise SystemExit("unigram to_str round trip: pieces or scores unlike serde_json's "
                         "parse of what to_str wrote")
    out["c"]["scores_moved"] = sum(a != b for (_, a), (_, b) in zip(trained.model.pieces,
                                                                    rt.model.pieces))
    back = dict(rt.model.pieces)
    ref = dict((p, v) for p, v in committed["vocab"])
    if set(back) != set(ref) or any(
            not math.isclose(ref[p], back[p], rel_tol=1e-6, abs_tol=1e-4 * 16) for p in ref):
        raise SystemExit("unigram to_str round trip: pieces or scores unlike the wheel's")
    zero()
    t = time.perf_counter()
    encs = rt.encode_batch_fast(gpt2_docs)
    torch.cuda.synchronize()
    out["c"]["encode_s"] = time.perf_counter() - t
    if any(read().values()):
        raise SystemExit(f"unigram to_str round trip: a kernel of csrc/ launched: {read()}")
    t = time.perf_counter()
    host = parallelism.maybe_par_map(rt.encode_host, gpt2_docs)
    out["c"]["host_pool_s"] = time.perf_counter() - t
    bad = [i for i, (e, h) in enumerate(zip(encs, host)) if e.ids != h.ids]
    if bad:
        raise SystemExit(f"unigram to_str round trip: {len(bad)} documents unlike its host "
                         f"pipeline's: {bad[:10]}")
    out["c"]["docs_off_trained_ids"] = sum(ids_digest(e.ids) != d for e, d in zip(encs, digests))
    out["c"]["docs"], out["c"]["to_str_bytes"] = len(encs), len(s)
    print("host modules " + json.dumps({"run": "c_unigram_to_str", **out["c"]}), flush=True)

    out["phase_s"] = time.perf_counter() - t_phase
    numbers["host_modules"] = out
    print(f"phase 17 (host modules): {out['phase_s']:.1f} s on {smi}", flush=True)
    for k, s_ in stats.items():
        s_["c_abi_launches"] = out["b"]["launches"].get(k, 0)


JAX_API_KERNELS = ("layout_fused", "keys", "merge_round_fused")  # B3, B2, B1


def jax_api_path(torch, stats, counts, numbers, smi):
    """Phase 18, the JAX package's public API on the card (docstring item
    18).  What a user calls is written only in the JAX package's public
    names, on the port imported as `tt`, with no device named, so every
    entry point takes the card by default; the harness around it (the
    digests, the launch counts, `checked_again`) is the smoke's own.  Adds
    each kernel's `jax_api_launches` to `stats`."""
    import tokenizers_tpu_torch as tt
    from tokenizers_tpu_torch.smoke_data import (
        JAX_API_TRAIN, STREAM_DOCS, build_docs, ids_digest, jax_api_tokenizer, jax_api_tokens,
        load_digests, load_jax_api_digests, text_digest, train_lines,
    )

    t_phase = time.perf_counter()
    want = load_jax_api_digests()
    docs = build_docs()
    out = {}

    def zero():
        for c in counts.values():
            for k in c:
                c[k] = 0

    def read():
        return {k: c[k] for k, c in counts.items()}

    # (a) a byte-level BPE built and trained through JAX's names, on the card
    zero()
    t = time.perf_counter()
    trained = jax_api_tokenizer(tt, train_lines(JAX_API_TRAIN["chars"]))
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t
    if trained.device.type != "cuda":
        raise SystemExit(f"jax api: the tokenizer took {trained.device}, not the card")
    if any(read().values()):
        raise SystemExit(f"jax api: a kernel of csrc/ launched while training: {read()}")
    if text_digest(trained.to_str()) != want["trained_to_str"]:
        raise SystemExit("jax api: the model trained on the card differs from the CPU's")
    gpt2 = tt.Tokenizer.from_file(GPT2)

    # (b) encode_batch_fast of the 512 documents with both, counted and checked
    runs, ids = {}, {}
    for name, tok, digests, again in (
            ("gpt2", gpt2, load_digests("gpt2"), lambda: tt.Tokenizer.from_file(GPT2)),
            ("trained", trained, want["trained_fast"],
             lambda: tt.Tokenizer.from_str(trained.to_str()))):
        other = again()
        for t_ in (tok, other):
            t_._get_device_engine()  # the engine's tables, built before the counted run
        zero()
        torch.cuda.synchronize()
        t = time.perf_counter()
        encs = tok.encode_batch_fast(docs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = read()
        bad = [i for i, e in enumerate(encs) if ids_digest(e.ids) != digests[i]]
        if bad:
            raise SystemExit(f"jax api {name}: {len(bad)} documents differ from their "
                             f"digests: {bad[:10]}")
        missing = [k for k in JAX_API_KERNELS if launches[k] == 0]
        if missing:
            raise SystemExit(f"jax api {name}: {missing} never launched")
        shapes, errs = checked_again(torch, lambda: other.encode_batch_fast(docs),
                                     f"jax api {name}", launches, lambda e: ids_digest(e.ids),
                                     digests)
        for k, e in errs.items():
            stats[k]["max_abs_err"] = max(stats[k]["max_abs_err"], e)
        ids[name] = [e.ids for e in encs]
        runs[name] = {"secs": secs, "mb_s": sum(len(d.encode()) for d in docs) / secs / 1e6,
                      "launches": launches}

    # (c) decode_batch and DecodeStream give the documents back
    for name, tok in (("gpt2", gpt2), ("trained", trained)):
        t = time.perf_counter()
        texts = tok.decode_batch(ids[name])
        runs[name]["decode_batch_s"] = time.perf_counter() - t
        bad = [i for i, (x, d) in enumerate(zip(texts, docs)) if x != d]
        if bad:
            raise SystemExit(f"jax api {name}: decode_batch differs from {len(bad)} "
                             f"documents: {bad[:10]}")
        t = time.perf_counter()
        for i in range(STREAM_DOCS):
            stream = tt.DecodeStream(tok, True)
            if "".join(x for x in map(stream.step, ids[name][i]) if x is not None) != docs[i]:
                raise SystemExit(f"jax api {name}: DecodeStream differs from document {i}")
        runs[name]["decode_stream_s"] = time.perf_counter() - t

    # (d) Model.tokenize gives JAX's Tokens, as the same model on the CPU
    previous = tt.set_default_device("cpu")
    try:
        on_cpu = {name: tt.Tokenizer.from_str(tok.to_str())
                  for name, tok in (("gpt2", gpt2), ("trained", trained))}
    finally:
        tt.set_default_device(previous)
    if on_cpu["gpt2"].device.type != "cpu" or tt.Tokenizer.from_file(GPT2).device.type != "cuda":
        raise SystemExit("jax api: set_default_device did not move and give back the default")
    for name, tok in (("gpt2", gpt2), ("trained", trained)):
        got = jax_api_tokens(tok.model)
        if not isinstance(tok.model, tt.models.BPE) or got != jax_api_tokens(on_cpu[name].model):
            raise SystemExit(f"jax api {name}: model.tokenize differs from the model on the CPU")
    if jax_api_tokens(trained.model) != want["tokens"]:
        raise SystemExit("jax api: the trained model's tokenize differs from the CPU run's")

    # (e) a typed error of the JAX package on bad parameters
    try:
        gpt2.enable_truncation(8, strategy="bogus")
    except tt.TruncationError as e:
        out["truncation_error"] = str(e)
    else:
        raise SystemExit("jax api: enable_truncation(strategy='bogus') raised no TruncationError")

    out["runs"] = runs
    out["phase_s"] = time.perf_counter() - t_phase
    numbers["jax_api"] = out
    print("numbers " + json.dumps({"jax_api": out}), flush=True)
    print(f"phase 18 (JAX API): {out['phase_s']:.1f} s on {smi}; launches "
          + json.dumps({n: {k: r["launches"][k] for k in JAX_API_KERNELS}
                        for n, r in runs.items()}), flush=True)
    for k, s_ in stats.items():
        s_["jax_api_launches"] = {n: r["launches"][k] for n, r in runs.items()}


def stats_launches(runs, k):
    return sum(r["cold"]["launches"][k] for r in runs.values())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops import kernel_build
    from tokenizers_tpu_torch.ops import layout_kernels as lk
    from tokenizers_tpu_torch import smoke_data
    from tokenizers_tpu_torch.ops import merge_kernels as mk
    from tokenizers_tpu_torch.ops.bpe_merge2 import compact
    from tokenizers_tpu_torch.smoke_data import (
        build_docs, first_ascii_chunk, full_width_states, llama3_unique_state, unique_state,
    )
    from tokenizers_tpu_torch.tools import timing
    from tokenizers_tpu_torch.tools.timing import bound_ms, median_ms, nbytes, table_bytes
    from tokenizers_tpu_torch.tools.wide_ab import b4_times

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernel_build.build()
    print(f"nvcc build {time.perf_counter() - t0:.3f} s", flush=True)
    for src in kernel_build.SOURCES:
        print(f"== ptxas {src}\n{kernel_build.build_log(src).strip()}", flush=True)

    # ---- 2. the gpt2 path's kernels against their plain versions ----------
    tok = Tokenizer.from_file(GPT2)
    eng = tok._get_device_engine()
    T = eng.tables
    docs = build_docs()
    prepared = [eng._prepare(d) for d in docs]
    b, n, inb = first_ascii_chunk(eng, prepared)
    stats = {}

    got = lk.layout_fused(b, n)
    want = lk.layout_fused_plain(b, n)
    b3_errs = adversarial_b3(torch, lk)
    b3_errs["layout_fused"] = max(b3_errs["layout_fused"],
                                  _check_equal(torch, "layout_fused", got, want))
    # the cluster kernel takes this width too, as one CTA a cluster
    b3_errs["layout_fused_wide"] = max(b3_errs["layout_fused_wide"], _check_equal(
        torch, "layout_fused_wide", lk.layout_fused_wide(b, n), want))
    b3_smem, b3_blocks = lk.row_residency(b.shape[1])
    stats["layout_fused"] = {
        "max_abs_err": b3_errs["layout_fused"],
        "ms": median_ms(lambda: lk.layout_fused(b, n), 20),
        "plain_ms": median_ms(lambda: lk.layout_fused_plain(b, n), 2),
        "bound_ms": bound_ms(nbytes(b, n, *got)),
        "shape": list(b.shape), "smem_bytes": b3_smem, "blocks_per_sm": b3_blocks,
    }
    print(f"B3 bit-equal (tolerance 0) at {list(b.shape)}, both kernels; row kernel "
          f"{stats['layout_fused']['ms']:.5f} ms, {b3_smem} B of dynamic shared memory, "
          f"{b3_blocks} blocks per SM", flush=True)
    state0 = unique_state(eng, b, n, inb, got)
    ids, own_l, own_r, wid = state0
    rows0, rows1, seed = T["merge_rows0"], T["merge_rows1"], T["seed"]
    errs = {"keys": 0, "merge_round_fused": 0}
    for width, rows in STATES:
        if ids.shape[1] != width:
            ids, wid, _bad, (own_l, own_r) = compact(ids, wid, width, (own_l, own_r))
        st_ids, st_wid, st_l, st_r = (x[:rows].contiguous() for x in (ids, wid, own_l, own_r))
        k_got = mk.keys(st_ids, rows0, seed)
        errs["keys"] = max(errs["keys"], _check_equal(
            torch, f"keys {list(st_ids.shape)}", k_got, mk.keys_plain(st_ids, rows0, seed)))
        st = (st_ids, st_l, st_r) + tuple(k_got)
        if rows is None and width == 2048:
            args_2048 = (*st[:3], st_wid, *st[3:], rows0, rows1, seed)
        n_alive = int((st_ids >= 0).sum())
        st, err = b1_rounds(torch, mk, f"merge_round_fused {list(st_ids.shape)}", st,
                            st_wid, rows0, rows1, seed, 2)
        errs["merge_round_fused"] = max(errs["merge_round_fused"], err)
        if rows is None:
            ids, own_l, own_r = st[0], st[1], st[2]
        print(f"B1/B2 bit-equal (tolerance 0) at {list(st_ids.shape)}; alive tokens "
              f"{n_alive} -> {int((st[0] >= 0).sum())} in two rounds", flush=True)

    wide_errs = adversarial_b1(torch, mk)
    for k in ("keys", "merge_round_fused"):
        errs[k] = max(errs[k], wide_errs[k])
    # the cluster B1 at the full-width state of the chunk's first 8 rows
    args_wide = full_width_states(eng)[(8, 8192)]
    wide_errs["merge_round_fused_wide"] = max(wide_errs["merge_round_fused_wide"], full_width_rounds(
        torch, mk, args_wide, (8192, 5120)))
    print("cluster B1 bit-equal (tolerance 0) at the full-width state [8, 8192] and its 5/8 "
          "width [8, 5120]", flush=True)

    # timing at the main path's unique-buffer shape [74, 4096]
    ids, own_l, own_r, wid = state0
    keys0 = mk.keys(ids, rows0, seed)
    # the floor of a launch among back-to-back ones: an empty kernel
    empty_ms = median_ms(lambda: torch.cuda._sleep(0), 20)
    ids_tile = ids[:1, :1024].contiguous()  # one block: the launch and ramp
    stats["keys"] = {
        "max_abs_err": errs["keys"],
        "ms": median_ms(lambda: mk.keys(ids, rows0, seed), 20),
        "one_tile_ms": median_ms(lambda: mk.keys(ids_tile, rows0, seed), 20),
        "plain_ms": median_ms(lambda: mk.keys_plain(ids, rows0, seed), 2),
        "bound_ms": bound_ms(nbytes(ids, *keys0)),
        "shape": list(ids.shape),
    }
    args = (ids, own_l, own_r, wid, *keys0, rows0, rows1, seed)
    r_out = mk.merge_round_fused(*args)
    # the row kernel and the cluster one (the same body in slices) on the
    # same inputs, in turns
    b1_ms = {}
    for w, a_ in ((4096, args), (2048, args_2048)):
        for k in ("row", "wide", "wide", "row"):
            fn = mk.merge_round_fused if k == "row" else mk.merge_round_fused_wide
            b1_ms.setdefault(f"{k}_{w}", []).append(
                median_ms(lambda fn=fn, a_=a_: fn(*a_), 20))
    stats["merge_round_fused"] = {
        "max_abs_err": errs["merge_round_fused"],
        "ms": b1_ms["row_4096"][0],
        "plain_ms": median_ms(lambda: mk.merge_round_fused_plain(*args), 2),
        "bound_ms": bound_ms(nbytes(*args[:7], *r_out)
                             + table_bytes(ids, wid, *keys0[:2], rows0, rows1)),
        "shape": list(ids.shape),
        "smem_bytes": mk.smem_bytes(ids.shape[1]),
        "cluster_kernel_ms_same_shape": b1_ms["wide_4096"][0],
        "ms_runs": b1_ms,
    }
    print("B1 ms, row kernel against the cluster one in turns (row, wide, wide, row): "
          + json.dumps(b1_ms), flush=True)
    torch.cuda.synchronize()

    # ---- 3. the gpt2 path, cold then warm ---------------------------------
    counts = {"layout_fused": lk.LAUNCHES, "layout_fused_wide": lk.LAUNCHES,
              "keys": mk.LAUNCHES,
              "merge_round_fused": mk.LAUNCHES, "merge_round_fused_wide": mk.LAUNCHES,
              "merge_round_standalone": mk.LAUNCHES, "merge_round_standalone_wide": mk.LAUNCHES}
    runs = drive_path(torch, tok, docs, "gpt2", counts)
    check_eight_kb(runs, "gpt2")
    for k in ("layout_fused", "keys", "merge_round_fused"):
        stats[k]["launches"] = runs["cold"]["launches"][k]
        stats[k]["launches_from"] = "gpt2 path (8 KB documents), cold"
    numbers = {"gpt2": path_numbers(eng, docs, prepared, runs, "gpt2")}
    print("numbers " + json.dumps(numbers["gpt2"]), flush=True)

    # ---- 4. B4, the standalone merge round ---------------------------------
    t = time.perf_counter()
    tok3 = Tokenizer.from_file(LLAMA3)
    eng3 = tok3._get_device_engine()
    if eng3 is None:
        raise SystemExit("llama3_128k: no device engine")
    llama3_build_s = time.perf_counter() - t
    print(f"llama3_128k tables {llama3_build_s:.3f} s", flush=True)
    T3 = eng3.tables
    prepared3 = [eng3._prepare(d) for d in docs]
    state3 = llama3_unique_state(eng3)
    rows0, rows1, seed = T3["merge_rows0"], T3["merge_rows1"], T3["seed"]
    e4 = dict(errs, merge_round_fused_wide=wide_errs["merge_round_fused_wide"],
              merge_round_standalone=0, merge_round_standalone_wide=0)
    ids, own_l, own_r, wid = state3
    for width, rows in STATES:
        if ids.shape[1] != width:
            ids, wid, _bad, (own_l, own_r) = compact(ids, wid, width, (own_l, own_r))
        st = tuple(x[:rows].contiguous() for x in (ids, own_l, own_r))
        st_wid = wid[:rows].contiguous()
        st, f = b4_rounds(torch, mk, f"llama3 {list(st_wid.shape)}", st, st_wid, rows0, rows1,
                          seed, 2, e4)
        if rows is None:
            ids, own_l, own_r = st
        print(f"B4 bit-equal (tolerance 0) to its plain version and to B2, B1, and "
              f"B2, B1 to theirs, at {list(st_wid.shape)}; merged heads in the last round: "
              f"{int(f.sum())}", flush=True)
    for C in ADVERSARIAL_WIDTHS:
        ids, own_l, own_r, wid, r0, r1, s_ = adversarial_state(torch, C)
        b4_rounds(torch, mk, f"adversarial [12, {C}]", (ids, own_l, own_r), wid, r0, r1, s_, 3,
                  e4)
    fw = full_width_states(eng)
    for (R, C), args in fw.items():
        b4_rounds(torch, mk, f"full width [{R}, {C}]", args[:3], args[3], *args[7:], 2, e4)
    print(f"B4 bit-equal (tolerance 0) to its plain version and to B2, B1 on the adversarial "
          f"layouts at [12, C], C in {list(ADVERSARIAL_WIDTHS)} (row kernel to {mk.ROW_MAX_C}, "
          f"cluster beyond) and at the full-width states {[list(k) for k in fw]}", flush=True)
    for k in ("keys", "merge_round_fused"):
        stats[k]["max_abs_err"] = e4[k]
    wide_errs["merge_round_fused_wide"] = e4["merge_round_fused_wide"]

    # B4's own path: `_round` to completion, on the llama3 unique buffer (the
    # row kernel) and on the dense full-width state (the cluster kernel)
    rounds, b4_launches, b4_wide = round_to_completion(
        torch, mk, counts, "llama3 unique buffer", state3[:3], state3[3], rows0, rows1, seed)
    args = fw[(32, 16384)]
    rounds_w, _b4_w_all, b4_w_launches = round_to_completion(
        torch, mk, counts, "gpt2 dense full width", args[:3], args[3], *args[7:])
    if b4_wide != 0 or b4_w_launches != rounds_w:
        raise SystemExit(f"_round: cluster B4 launched {b4_wide} times at width 4096 and "
                         f"{b4_w_launches} of {rounds_w} rounds at 16384")
    b4_by = b4_times(torch, mk, eng, eng3, smoke_data, timing)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, head, n_launch, from_, cl in (
            ("merge_round_standalone", "74x4096", b4_launches,
             "its own phase: bpe_merge2._round to completion on the llama3 unique buffer", 0),
            ("merge_round_standalone_wide", "32x16384", b4_w_launches,
             "its own phase: bpe_merge2._round to completion on the gpt2 dense full-width "
             "state [32, 16384]", 1)):
        by = {x: t for x, t in b4_by.items() if (int(x.split("x")[1]) > mk.ROW_MAX_C) == cl}
        for x, at in by.items():
            R, C = (int(v) for v in x.split("x"))
            S, n = mk.cluster_geometry(R, C, sms) if cl else (C, 1)
            at.update(slice=S, cluster=n, smem_bytes=mk.smem_bytes(S))
            if cl:
                at["max_active_clusters"] = mk.max_clusters(S, n, carry=False)
        stats[k] = {
            "max_abs_err": e4[k], **{x: by[head][x] for x in ("ms", "plain_ms", "bound_ms")},
            "shape": [int(x) for x in head.split("x")], "by_shape": by,
            "launches": n_launch, "launches_from": from_,
        }
    # every (slice, cluster size) of the cluster B4 this run launched
    stats["merge_round_standalone_wide"]["max_active_clusters"] = {
        f"S={S} n={nc}": v for (_l, e, _d, S, nc, a), v in sorted(kernel_build.CLUSTERS.items())
        if (e, a) == ("tt_merge_round_max_clusters", (0,))}
    print("B4 by shape: " + json.dumps({k: stats[k]["by_shape"] for k in
                                        ("merge_round_standalone",
                                         "merge_round_standalone_wide")}), flush=True)

    # ---- 5. the llama3 path, cold then warm -------------------------------
    runs3 = drive_path(torch, tok3, docs, "llama3", counts)
    check_eight_kb(runs3, "llama3")
    numbers["llama3"] = path_numbers(eng3, docs, prepared3, runs3, "llama3")
    numbers["llama3"]["tables_s"] = llama3_build_s
    numbers["llama3"]["b4_rounds_to_completion"] = rounds
    print("numbers " + json.dumps(numbers["llama3"]), flush=True)

    # ---- 6. the gpt2 long documents -----------------------------------------
    long_path(torch, stats, b3_errs["layout_fused_wide"],
              wide_errs["merge_round_fused_wide"], counts, numbers)

    # ---- 7. the offsets path -------------------------------------------------
    offsets_path(torch, tok, tok3, stats, counts, numbers)

    # ---- 8. the bert WordPiece path -------------------------------------------
    bert_path(torch, stats, counts, numbers)

    # ---- 9. the WordLevel and char-level BPE paths -----------------------------
    char_level_path(torch, stats, counts, numbers)

    # ---- 10. the Unigram path ------------------------------------------------
    unigram_path(torch, stats, counts, numbers)

    # ---- 11. training ------------------------------------------------------------
    train_path(torch, stats, counts, numbers)

    # ---- 12. Unigram training --------------------------------------------------
    unigram_train_path(torch, stats, counts, numbers)

    # ---- 13. decode ---------------------------------------------------------------
    decode_path(torch, stats, counts, numbers)

    # ---- 14. the multi-rank runtime ------------------------------------------------
    multirank_path(torch, stats, counts, numbers, smi)

    # ---- 15. the Tokenizer's full surface and the recipes ------------------------
    recipes_path(torch, stats, counts, numbers, smi)

    # ---- 16. the general host pipeline and the engine's new pipelines ---------------
    host_pipelines_path(torch, stats, counts, numbers, smi)

    # ---- 17. the last host modules: Precompiled, the host pool, the C ABI -------------
    host_modules_path(torch, stats, counts, numbers, smi)

    # ---- 18. the JAX package's public API, in JAX's names alone ----------------------
    jax_api_path(torch, stats, counts, numbers, smi)

    # registers, spills and static shared memory of the merge kernels, from
    # ptxas's report of the build this run loaded
    usage = kernel_build.ptxas_usage(kernel_build.build_log("merge_round.cu"))
    for k, prefix in PTXAS_NAMES.items():
        found = [u for name, u in usage.items() if name.startswith(prefix)]
        if len(found) != 1 or not {"registers", "spill_store_bytes"} <= found[0].keys():
            raise SystemExit(f"ptxas report: {len(found)} entries for {k} ({prefix})")
        stats[k]["ptxas"] = found[0]
        if k in NO_SPILLS and found[0]["spill_store_bytes"] + found[0]["spill_load_bytes"]:
            raise SystemExit(f"ptxas report: {k} spills {found[0]}")
    print("kernel_numbers " + json.dumps({
        "kernel_median_ms": {k: s["ms"] for k, s in stats.items()},
        "kernel_bound_us": {k: s["bound_ms"] * 1e3 for k, s in stats.items()},
        "kernel_shapes": {k: s["shape"] for k, s in stats.items()},
        "b1_row_and_cluster_ms": stats["merge_round_fused"]["ms_runs"],
        "b1_row_smem_bytes": stats["merge_round_fused"]["smem_bytes"],
        "merge_kernels_ptxas": {k: stats[k]["ptxas"] for k in PTXAS_NAMES},
        "b3_row_smem_bytes": stats["layout_fused"]["smem_bytes"],
        "b3_row_blocks_per_sm": stats["layout_fused"]["blocks_per_sm"],
        "b2_one_tile_ms": stats["keys"]["one_tile_ms"],
        "empty_kernel_ms": empty_ms,
        "max_active_clusters": {f"{entry}{list(a) if a else ''} S={S} n={n}": v
                                for (_l, entry, _d, S, n, a), v in kernel_build.CLUSTERS.items()},
    }), flush=True)

    extra = ("own_phase_launches", "by_shape", "cluster_kernel_ms_same_shape",
             "max_active_clusters", "ptxas")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": TPU_KERNELS[k],
         "launches": s["launches"], "launches_from": s["launches_from"],
         "long_path_launches": s["long_path_launches"],
         "offsets_path_launches": s["offsets_path_launches"],
         "offsets_path_shapes": s["offsets_path_shapes"],
         "bert_path_launches": s["bert_path_launches"],
         "unigram_path_launches": s["unigram_path_launches"],
         "train_path_launches": s["train_path_launches"],
         "unigram_train_launches": s["unigram_train_launches"],
         "decode_launches": s["decode_launches"],
         "char_level_launches": s["char_level_launches"],
         "char_level_shapes": s["char_level_shapes"],
         "multirank_launches": s["multirank_launches"],
         "recipes_launches": s["recipes_launches"], "to_str_launches": s["to_str_launches"],
         "host_pipelines_launches": s["host_pipelines_launches"],
         "c_abi_launches": s["c_abi_launches"], "jax_api_launches": s["jax_api_launches"],
         "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "shape": s["shape"], **{x: s[x] for x in extra if x in s}}
        for k, s in stats.items()
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
