"""The port's C ABI (`tokenizers_tpu_torch/native/c_api.cpp`) on the CPU:
`build_c_api` builds it with g++, `tests/c_api_torch_driver.c` runs it as
an external process through `tokenizers_create_on_device(..., "cpu")`,
and its encode, pair, batch, decode and train are held against the
port's Python API and the JAX package's C ABI (its library and
`tests/c_api_driver.c`) on the gpt2 fixture.  `tests/c_api_driver.c`,
unchanged, also links against the port's library, whose
`tokenizers_create` builds on the card and so fails here."""

import json
import os
import subprocess

import pytest
from tokenizers import Tokenizer as WheelTokenizer

from tokenizers_tpu.native import build_c_api as build_jax_c_api
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.native import build_c_api, build_c_driver, c_api_env
from tokenizers_tpu_torch.trainers import BpeTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT2 = os.path.join(REPO, "tests", "fixtures", "gpt2", "tokenizer.json")
TEXTS = ["Hello world, don't stop!", "naïve café 序号123  <|endoftext|> x"]


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    d = tmp_path_factory.mktemp("capi")
    ours = build_c_driver(os.path.join(REPO, "tests", "c_api_torch_driver.c"), str(d / "ours"))
    unchanged = build_c_driver(os.path.join(REPO, "tests", "c_api_driver.c"), str(d / "plain"))
    jax_so = build_jax_c_api()
    jax = str(d / "jax")
    subprocess.run(["gcc", "-O1", os.path.join(REPO, "tests", "c_api_driver.c"), "-o", jax,
                    jax_so, f"-Wl,-rpath,{os.path.dirname(jax_so)}",
                    f"-Wl,-rpath,{os.path.dirname(build_c_api())}"], check=True)
    return {"ours": ours, "plain": unchanged, "jax": jax}


def _run(exe, *args, ok=True):
    env = c_api_env({k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([exe, *args], capture_output=True, text=True, env=env, timeout=600)
    assert (r.returncode == 0) == ok, r.stderr[-3000:]
    return r


def _fields(stdout):
    return dict(line.split(":", 1) for line in stdout.strip().split("\n") if ":" in line)


def _ints(s):
    return [int(x) for x in s.split()]


@pytest.mark.parametrize("pair", [None, "second part"], ids=["single", "pair"])
@pytest.mark.parametrize("text", TEXTS)
def test_encode_and_decode(drivers, text, pair):
    extra = [] if pair is None else [pair]
    got = _fields(_run(drivers["ours"], GPT2, "cpu", "encode", text, *extra).stdout)
    tok = Tokenizer.from_file(GPT2, device="cpu")
    exp = tok.encode(text, pair)
    assert _ints(got["ids"]) == exp.ids
    assert _ints(got["type_ids"]) == exp.type_ids
    assert _ints(got["special_tokens_mask"]) == exp.special_tokens_mask
    assert got["tokens"].split() == exp.tokens
    assert [tuple(map(int, p.split("-"))) for p in got["offsets"].split()] == exp.offsets
    assert _ints(got["word_ids"]) == [-1 if w is None else w for w in exp.word_ids]
    assert got["decode"][1:] == tok.decode(exp.ids)
    if text == TEXTS[0]:  # the JAX package's C ABI (its embedded interpreter imports jax)
        jax = _fields(_run(drivers["jax"], GPT2, text, *extra).stdout)
        for k in ("ids", "tokens", "offsets", "decode"):
            assert jax[k] == got[k], k


@pytest.mark.parametrize("name", ["gpt2", "t5_shape"])
def test_batch(drivers, tmp_path, name):
    """gpt2 on its engine (the kernels' plain versions: no launch counted),
    t5_shape on the host, on the host pool of the embedded interpreter
    (brought up, and given the tokenizer, by an uncounted batch first)."""
    from tokenizers_tpu_torch.smoke_data import host_pipelines

    with open(os.path.join(REPO, "tests", "fixtures", "corpus.txt"), encoding="utf-8") as f:
        docs = TEXTS + [line for line in f.read().splitlines() if line][:10] + ["", " "]
    path = tmp_path / "docs.bin"
    path.write_bytes(b"\0".join(d.encode("utf-8") for d in docs))
    blob = GPT2
    if name != "gpt2":
        blob = str(tmp_path / "tokenizer.json")
        with open(blob, "w", encoding="utf-8") as f:
            f.write(host_pipelines()[name])
    pool = ["--pool"] if name != "gpt2" else []
    out = _fields(_run(drivers["ours"], blob, "cpu", "batch", str(path), "--launches",
                       *pool).stdout)
    got = [_ints(out.get(f"ids[{i}]", "")) for i in range(len(docs))]
    tok = Tokenizer.from_file(blob, device="cpu")
    assert got == [e.ids for e in tok.encode_batch(docs)]
    assert got == [e.ids for e in WheelTokenizer.from_file(blob).encode_batch(docs)]
    launches = json.loads(out["launches"])
    assert set(launches) >= {"layout_fused", "keys", "merge_round_fused"}
    assert not any(launches.values())  # the plain versions ran: the tensors were on the CPU
    assert json.loads(out["pool"]) == (name != "gpt2")


def test_train(drivers, tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("hug hugs hugging pug pugs mug smug hug hugs\n" * 4)
    cfg = tmp_path / "empty_bpe.json"
    blob = json.dumps({"version": "1.0", "model": {"type": "BPE", "vocab": {}, "merges": []},
                       "pre_tokenizer": {"type": "Whitespace"}})
    cfg.write_text(blob)
    got = _fields(_run(drivers["ours"], str(cfg), "cpu", "train", str(corpus)).stdout)
    tok = Tokenizer.from_str(blob, device="cpu")
    tok.train([str(corpus)], BpeTrainer(vocab_size=40, device="cpu"))
    assert _ints(got["trained_ids"]) == tok.encode("hug").ids
    assert json.loads(got["vocab"]) == tok.get_vocab(True)
    jax = _run(drivers["jax"], str(cfg), "--train", str(corpus)).stdout
    assert f"trained_encode_len: {len(tok.encode('hug').ids)}" in jax


def test_unchanged_driver_links_and_create_needs_the_card(drivers):
    """`tokenizers_create` builds on the card: here, without one, it fails
    with the port's message (and the JAX package's driver, unchanged,
    reports it)."""
    r = _run(drivers["plain"], GPT2, "Hello", ok=False)
    assert "create failed: tokenizers_create failed: no CUDA device" in r.stderr
    r = _run(drivers["ours"], GPT2, "card", "encode", "Hello", ok=False)
    assert "no CUDA device" in r.stderr
    r = _run(drivers["ours"], GPT2, "nonsense-device", "encode", "Hello", ok=False)
    assert "create failed: tokenizers_create failed:" in r.stderr


def test_exports_every_symbol_of_jax_s_c_abi():
    """The port's library exports every `tokenizers_*` symbol of the JAX
    package's, and so every one the Node binding declares
    (`bindings/node/src/binding.cc`), plus `tokenizers_create_on_device`."""
    import re

    def exported(so):
        out = subprocess.run(["nm", "-D", "--defined-only", so], capture_output=True,
                             text=True, check=True).stdout
        return {line.split()[-1] for line in out.splitlines() if " tokenizers_" in line}

    ours, jax = exported(build_c_api()), exported(build_jax_c_api())
    assert ours == jax | {"tokenizers_create_on_device"}
    with open(os.path.join(REPO, "bindings", "node", "src", "binding.cc"), encoding="utf-8") as f:
        node = set(re.findall(r"\b(tokenizers_[a-z_]+)\(", f.read()))
    assert node and node <= ours
