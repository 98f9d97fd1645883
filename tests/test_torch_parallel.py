"""The port's sharded encode on two gloo ranks of the CPU, and its dry run.

Two spawned ranks (`runtime.spawn`; they import no JAX, `torch_rank_jobs`)
encode the same inputs over a 1-D mesh of both with gpt2, llama3_128k,
bert, unigram_bf (a word of 200 bytes makes a per-word patch record),
char_bpe and wordlevel (every engine): `shard_encode_batch_arrays`,
`shard_encode_batch` and `encode_batch_fast` with the mesh as the
default; gpt2 once more over the 2-D ("hosts", "data") mesh.  Held here:

* each chunk's gathered ids, token counts and row flags, exactly, against
  the unsharded port's mesh program on the whole chunk (rows padded to the
  ranks as the sharded run pads them; a row with patch records flagged);
  both ranks return the same;
* every row the program does not flag against the JAX package's host
  pipeline, and every `encode_batch_fast` result (flagged rows re-encoded
  on the host, patches spliced) against it too.  The JAX package's own
  mesh tests hold its mesh path to that pipeline; its mesh program itself
  (GSPMD over a 2-device CPU mesh) takes minutes to compile here for gpt2
  alone, so it is not run;
* the meshes' shapes and axis names against JAX's `build_mesh` at two
  devices.

`dryrun_multichip(2, backend="gloo", device="cpu")` runs JAX's three
dry-run checks in two ranks.  About 35 s serially.
"""

import numpy as np
import pytest
import torch

from tokenizers_tpu.parallel import runtime as jrt
from tokenizers_tpu.tokenizer import Tokenizer as JTokenizer

import torch_rank_jobs as jobs
from tokenizers_tpu_torch import Tokenizer, entry, smoke_data
from tokenizers_tpu_torch.parallel import runtime

RANKS = 2


@pytest.fixture(scope="module")
def ranks():
    return runtime.spawn(jobs.parallel_job, RANKS, ({"encode": ()},), device="cpu",
                         timeout_s=300)


@pytest.fixture(scope="module")
def inputs():
    return jobs.encode_inputs()


@pytest.mark.parametrize("name", jobs.ENCODE_CONFIGS)
def test_sharded_chunks_match_unsharded(ranks, inputs, name):
    tok = Tokenizer.from_str(smoke_data.config_json(name), device="cpu")
    want = jobs.unsharded_chunks(tok._get_device_engine(), inputs, RANKS)
    for r in ranks:
        got = r["encode"][name]["arrays"]
        assert len(got) == len(want)
        for (gi, gn, gb, go), (wi, wn, wb, wo) in zip(got, want):
            assert go == wo
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gn, wn)
            np.testing.assert_array_equal(gb, wb)


@pytest.mark.parametrize("name", jobs.ENCODE_CONFIGS)
def test_sharded_ids_match_jax_host(ranks, inputs, name):
    jtok = JTokenizer.from_str(smoke_data.config_json(name))
    plain = [jtok._encode(s, None, False, "none").ids for s in inputs]
    full = [jtok._encode(s, None, True, "none").ids for s in inputs]
    for r in ranks:
        res = r["encode"][name]
        flagged = {i for _ids, _n, bad, orig in res["arrays"]
                   for row, i in enumerate(orig) if bad[row]}
        assert len(flagged) <= len(inputs) // 8
        for i, ids in enumerate(res["lists"]):
            if i not in flagged:
                assert ids == plain[i], (name, i)
        assert res["fast"] == full


def test_two_d_mesh_matches_one_d(ranks):
    for r in ranks:
        one, two = r["encode"]["gpt2"], r["encode_2d"]
        assert one["lists"] == two["lists"]
        for a, b in zip(one["arrays"], two["arrays"]):
            for x, y in zip(a[:3], b[:3]):
                np.testing.assert_array_equal(x, y)


def test_mesh_shapes_match_jax(ranks):
    import jax

    for axes, key in ((("data",), "mesh"), (("hosts", "data"), "mesh2")):
        jm = jrt.build_mesh(axes, devices=jax.devices()[:RANKS])
        for r in ranks:
            assert r[key] == (tuple(jm.devices.shape), tuple(jm.axis_names))


def test_ranks_import_no_jax(ranks):
    for r in ranks:
        assert not {"jax", "jaxlib", "regex", "tokenizers", "tokenizers_tpu"} & set(r["modules"])


def test_ranks_return_the_same(ranks):
    for name in jobs.ENCODE_CONFIGS:
        assert ranks[0]["encode"][name]["lists"] == ranks[1]["encode"][name]["lists"]
        assert ranks[0]["encode"][name]["fast"] == ranks[1]["encode"][name]["fast"]


def test_dryrun_multichip_gloo_cpu():
    out = entry.dryrun_multichip(RANKS, backend="gloo", device="cpu", timeout_s=300)
    assert [o["rank"] for o in out] == list(range(RANKS))
    for o in out:
        assert o["ranks"] == RANKS and o["bpe_merges"] == 128 and o["bpe_path"] == "dense"
        assert o["encode_rows"] == 16 * RANKS and o["encode_flagged"] <= 2 * RANKS


def test_entry_program_runs_on_cpu():
    fn, args = entry.entry("cpu")
    ids, ntok, bad = fn(*args)
    tok = Tokenizer.from_file(entry.FIXTURE, device="cpu")
    for r, n in enumerate(args[1].tolist()):
        text = bytes(args[0][r, :n].tolist()).decode("utf-8")
        assert not bool(bad[r])
        assert ids[r, : int(ntok[r])].tolist() == tok.encode_host(text, False).ids
    assert isinstance(ids, torch.Tensor)
