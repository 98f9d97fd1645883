"""The port's host utilities on the CPU: `utils/parallelism.py` (the
TOKENIZERS_PARALLELISM switch and the host pool), `utils/log.py`
(TOKENIZERS_LOG), `utils/progress.py` (the trainers' bar) and
`utils/cache.py`.

Every test that starts a pool runs it in a fresh subprocess that has not
imported JAX (`_POOL_PROBE`): at the three sites the JAX package runs in
its pool (the batch host path, `decode_batch` from 64 sequences,
`BpeTrainer.feed` from 4,000 lines) the results with the pool on equal
those with it off, and both equal the JAX package's serial results,
computed here with its parallelism off."""

import io
import json
import os
import subprocess
import sys

import pytest

import tokenizers_tpu as tt
from tokenizers_tpu.trainers.bpe_trainer import BpeTrainer as JaxBpeTrainer
from tokenizers_tpu.utils import parallelism as jax_parallelism
from tokenizers_tpu_torch.utils import parallelism as P
from tokenizers_tpu_torch.utils.cache import Cache
from tokenizers_tpu_torch.utils.progress import ProgressBar, progress_bar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT2 = "tests/fixtures/gpt2/tokenizer.json"

_POOL_PROBE = r"""
import json, sys
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.smoke_data import T5_SHAPE, host_pipelines
from tokenizers_tpu_torch.trainers import BpeTrainer
from tokenizers_tpu_torch.utils import parallelism as P

import time
out = {}
# the first map starts the pool in the background and does not wait for it
t = time.perf_counter()
out["first"] = P.maybe_par_map(abs, list(range(-20, 20)))
out["first_s"] = time.perf_counter() - t
out["first_used"] = P.has_used_parallelism()

lines = [l for l in open("tests/fixtures/corpus.txt", encoding="utf-8").read().splitlines() if l]
t5 = Tokenizer.from_str(host_pipelines()[T5_SHAPE], device="cpu")
gpt2 = Tokenizer.from_file("tests/fixtures/gpt2/tokenizer.json", device="cpu")
texts = lines[:24]
def site(r, name, run):
    if P._pool is not None:
        P._pool.used = False
    r[name] = run()
    r.setdefault("pooled", {})[name] = P._pool is not None and P._pool.used


# the second run with the pool on finds the workers up and holding both
# tokenizers, so each site maps chunks on them
for on in (False, True, True):
    P.set_parallelism(on)
    if on:
        P.start_pool(wait=True)
    r = {}
    site(r, "encode", lambda: [[e.ids, e.tokens, e.offsets] for e in t5.encode_batch(texts)])
    site(r, "encode_fast", lambda: [e.ids for e in t5.encode_batch_fast(texts)])
    ids = [e.ids for e in gpt2.encode_batch(lines[:80])]
    site(r, "decode", lambda: gpt2.decode_batch(ids))
    trainer = BpeTrainer(device="cpu")
    site(r, "feed", lambda: trainer.feed(lines[:4500], gpt2.train_words, gpt2._count_chunks))
    r["feed"] = list(trainer.words.items())
    out["on" if on else "off"] = r
out["used"] = P.has_used_parallelism()
out["workers"] = len(P._pool) if P._pool is not None else 0

# scores that the wheel's parse (from_str, pickling) moves by an ulp, which
# turns "ab" into "a b": the workers' copy keeps them exact, so pairs on the
# pool give the serial results
from tokenizers_tpu_torch.models.unigram import Unigram
from tokenizers_tpu_torch.pre_tokenizers.whitespace import WhitespaceSplit
scores = [("<unk>", 0.0), ("a", -10.990080380310076), ("b", -10.181183809177941),
          ("ab", -21.171264189488014)]
exact = Tokenizer(Unigram(scores, unk_id=0), WhitespaceSplit(), device="cpu")
pairs = [("ab a " * (i % 4 + 1), "b ab" * (i % 3 + 1)) for i in range(12)]
r = {}
for on in (False, True):
    P.set_parallelism(on)
    if on:
        exact.encode_batch(pairs)  # the workers load it
        P.start_pool(wait=True)
    P._used_parallelism = False
    r["on" if on else "off"] = [[e.ids, e.tokens] for e in exact.encode_batch(pairs)]
    r["used" if on else "used_off"] = P.has_used_parallelism()
P.set_parallelism(False)
lossy = Tokenizer.from_str(exact.to_str(), device="cpu")
r["lossy"] = [[e.ids, e.tokens] for e in lossy.encode_batch(pairs)]
P.set_parallelism(True)
out["exact"] = r

# a worker's exception raises here, with its traceback as the cause
try:
    P.maybe_par_map(int, ["1", "x"] + [str(i) for i in range(38)])
    out["raised"] = None
except ValueError as e:
    out["raised"] = [str(e), "int" in str(e.__cause__)]
out["after_error"] = P.maybe_par_map(abs, list(range(-20, 20)))

# a worker that dies raises, and the next call starts a new pool
import os, signal
helper = P._pool.helper.pid
kids = open(f"/proc/{helper}/task/{helper}/children").read().split()
os.kill(int(kids[0]), signal.SIGKILL)
time.sleep(0.5)
try:
    P.maybe_par_map(abs, list(range(-40, 40)))
    out["died"] = None
except RuntimeError as e:
    out["died"] = str(e)
dead = P._pool
P.start_pool(wait=True)
out["new_pool"] = P._pool is not dead and len(P._pool) >= 2
out["after_death"] = P.maybe_par_map(abs, list(range(-20, 20)))

# under BPE dropout the batch stays serial: the same seed gives the serial results
import random
P._used_parallelism = False
P.set_parallelism(True)
d = json.loads(open("tests/fixtures/gpt2/tokenizer.json").read())
d["model"]["dropout"] = 0.5
d["normalizer"] = {"type": "Lowercase"}
drop = Tokenizer.from_str(json.dumps(d), device="cpu")
runs = []
for on in (True, False):
    P.set_parallelism(on)
    drop.model.rng = random.Random(7)
    runs.append([e.ids for e in drop.encode_batch(texts)])
out["dropout_equal"] = runs[0] == runs[1]
out["dropout_used_pool"] = P.has_used_parallelism()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def pool_probe():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", ENV)}
    r = subprocess.run([sys.executable, "-c", _POOL_PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert "jax" not in r.stdout
    return out


ENV = P.ENV_VARIABLE


@pytest.fixture
def jax_serial():
    saved = jax_parallelism._override
    jax_parallelism.set_parallelism(False)
    yield
    jax_parallelism._override = saved


def _lines():
    with open(os.path.join(REPO, "tests/fixtures/corpus.txt"), encoding="utf-8") as f:
        return [line for line in f.read().splitlines() if line]


@pytest.mark.parametrize("site", ["encode", "encode_fast", "decode", "feed"])
def test_pool_on_and_off_agree_and_equal_jax(pool_probe, jax_serial, site):
    from tokenizers_tpu_torch.smoke_data import T5_SHAPE, host_pipelines

    on, off = pool_probe["on"][site], pool_probe["off"][site]
    assert on == off
    assert pool_probe["used"] and pool_probe["workers"] >= 2
    assert pool_probe["on"]["pooled"][site] and not pool_probe["off"]["pooled"][site]
    lines = _lines()
    if site.startswith("encode"):
        jt = tt.Tokenizer.from_str(host_pipelines()[T5_SHAPE])
        encs = jt.encode_batch(lines[:24])
        want = ([[e.ids, e.tokens, [list(o) for o in e.offsets]] for e in encs]
                if site == "encode" else [e.ids for e in encs])
    elif site == "decode":
        jt = tt.Tokenizer.from_file(GPT2)
        want = jt.decode_batch([jt.encode(x).ids for x in lines[:80]])
    else:
        jt = tt.Tokenizer.from_file(GPT2)
        trainer = JaxBpeTrainer(show_progress=False)

        def process(seq):
            p = jt.added_vocabulary.extract_and_normalize(jt.normalizer, seq)
            jt.pre_tokenizer.pre_tokenize(p)
            return [s for s, _, _ in p.get_splits("original", "byte")]

        trainer.feed(lines[:4500], process)
        want = [list(x) for x in trainer.words.items()]
    assert on == want


def test_the_first_map_does_not_wait_for_the_pool(pool_probe):
    assert pool_probe["first"] == [abs(x) for x in range(-20, 20)]
    assert not pool_probe["first_used"] and pool_probe["first_s"] < 1.0


def test_the_workers_copy_is_exact(pool_probe):
    """A Unigram whose scores the wheel's parse moves (as a trained one's
    may be) gives the serial results on the pool, pairs included."""
    r = pool_probe["exact"]
    assert r["used"] and not r["used_off"]
    assert r["on"] == r["off"]
    assert r["lossy"] != r["off"]  # the parse that pickling uses would move them
    assert ["ab", "a"] == r["off"][0][1][:2]


def test_a_worker_error_raises(pool_probe):
    assert pool_probe["raised"] == ["invalid literal for int() with base 10: 'x'", True]
    assert pool_probe["after_error"] == [abs(x) for x in range(-20, 20)]
    assert pool_probe["died"] == "a host pool worker exited" and pool_probe["new_pool"]
    assert pool_probe["after_death"] == [abs(x) for x in range(-20, 20)]


def test_dropout_batches_stay_serial(pool_probe):
    assert pool_probe["dropout_equal"] and not pool_probe["dropout_used_pool"]


@pytest.mark.parametrize("value,want", [
    (None, None), ("", False), ("0", False), ("false", False), (" OFF ", False), ("f", False),
    ("no", False), ("N", False), ("1", True), ("true", True), ("on", True), ("yes", True),
    ("anything", True)])
def test_env_spellings(value, want):
    assert P.parse_env_bool(value) is want
    assert jax_parallelism.parse_env_bool(value) is want


def test_override_beats_the_environment(monkeypatch):
    saved = P._override
    try:
        P._override = None
        monkeypatch.delenv(ENV, raising=False)
        assert P.get_parallelism() and not P.is_parallelism_configured()
        monkeypatch.setenv(ENV, "false")
        assert not P.get_parallelism() and P.is_parallelism_configured()
        P.set_parallelism(True)
        assert P.get_parallelism()
        monkeypatch.setenv(ENV, "true")
        P.set_parallelism(False)
        assert not P.get_parallelism()
        # below the threshold, or switched off, a map stays in this process
        assert P.maybe_par_map(lambda x: x + 1, range(20)) == list(range(1, 21))
        P.set_parallelism(True)
        assert P.maybe_par_map(lambda x: x + 1, range(7)) == list(range(1, 8))
    finally:
        P._override = saved


_LOG_PROBE = """
import logging
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.utils.log import TRACE, get_logger
tok = Tokenizer.from_file("tests/fixtures/gpt2/tokenizer.json", device="cpu")
tok._get_device_engine()
d = tok.to_str()
import json
j = json.loads(d); j["normalizer"] = {"type": "Lowercase"}
Tokenizer.from_str(json.dumps(j), device="cpu")._get_device_engine()
get_logger("x").log(TRACE, "a trace line")
print(logging.getLogger("tokenizers_tpu_torch").level)
"""


@pytest.mark.parametrize("spec", ["debug", "TRACE", "warn", None])
def test_tokenizers_log(spec):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "TOKENIZERS_LOG")}
    if spec is not None:
        env["TOKENIZERS_LOG"] = spec
    r = subprocess.run([sys.executable, "-c", _LOG_PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    engine = "[DEBUG tokenizers_tpu_torch.engine] pipeline compiled to ByteLevelBpeEngine on cpu"
    none = "[DEBUG tokenizers_tpu_torch.engine] no device engine matched (model=BPE, " \
           "normalizer=Lowercase, pre_tokenizer=ByteLevel): using the host path"
    trace = "[TRACE tokenizers_tpu_torch.x] a trace line"
    shown = {"debug": (engine, none), "TRACE": (engine, none, trace)}.get(spec, ())
    for line in (engine, none, trace):
        assert (line in r.stderr) == (line in shown), (spec, r.stderr)
    assert r.stdout.split() == [{"debug": "10", "TRACE": "5", "warn": "30", None: "0"}[spec]]


def test_vocab_holes_warn_on_save(tmp_path, caplog):
    from tokenizers_tpu_torch.models.bpe import BPE

    model = BPE({"a": 0, "b": 2}, [])
    with caplog.at_level("WARNING", logger="tokenizers_tpu_torch.models"):
        model.save(str(tmp_path))
    assert "holes for indices [1]" in caplog.text


class _FakeTTY(io.StringIO):
    def isatty(self):
        return True


def test_progress_bar_off_and_on_a_tty(monkeypatch):
    plain = io.StringIO()
    monkeypatch.setattr(sys, "stderr", plain)
    bar = progress_bar(True, 10, "Compute merges")
    bar.inc(5)
    bar.finish()
    assert not bar.enabled and plain.getvalue() == "" and bar.pos == 5
    tty = _FakeTTY()
    monkeypatch.setattr(sys, "stderr", tty)
    off = progress_bar(False, 10, "Compute merges")
    off.inc(3)
    off.finish()
    assert tty.getvalue() == ""
    bar = ProgressBar(10, "Compute merges")
    bar.reset()
    for _ in range(10):
        bar.inc(1)
    bar.finish()
    out = tty.getvalue()
    assert out.startswith("\rCompute merges") and out.endswith("| 10/10\n"), out
    assert "█" * 30 in out


@pytest.mark.parametrize("path", ["dense", "per_round", "host"])
def test_trainers_draw_compute_merges(monkeypatch, path):
    from tokenizers_tpu_torch.models.bpe import BPE
    from tokenizers_tpu_torch.parallel.bpe_train import train_per_round
    from tokenizers_tpu_torch.trainers import BpeTrainer

    tty = _FakeTTY()
    monkeypatch.setattr(sys, "stderr", tty)
    words = {"hug": 10, "pug": 5, "pun": 12, "bun": 4, "hugs": 5}
    trainer = BpeTrainer(vocab_size=20, device="cpu")
    if path == "dense":
        trainer.words = dict(words)
        trainer.train(BPE())
        assert trainer.stats["path"] == "dense"
    elif path == "per_round":
        w2i, i2w, ws, counts = trainer.prepare(words)
        train_per_round(trainer, w2i, i2w, ws, counts, "cpu", {})
    else:
        trainer.do_train(words, BPE())
    out = tty.getvalue()
    assert "Compute merges" in out and out.endswith("\n"), out
    quiet = BpeTrainer(vocab_size=20, show_progress=False, device="cpu")
    monkeypatch.setattr(sys, "stderr", _FakeTTY())
    quiet.do_train(words, BPE())
    assert sys.stderr.getvalue() == ""


def test_cache():
    c = Cache(2)
    c.set("a", 1)
    c.set("b", 2)
    c.set("c", 3)  # full: not inserted
    assert (c.get("a"), c.get("b"), c.get("c"), len(c)) == (1, 2, None, 2)
    c.clear()
    assert len(c) == 0 and Cache().capacity == 10_000
    from tokenizers_tpu_torch.models.bpe import BPE
    from tokenizers_tpu_torch.models.unigram import Unigram

    assert isinstance(BPE().cache, Cache) and isinstance(Unigram([("a", 0.0)]).cache, Cache)
