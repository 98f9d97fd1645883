"""The port offers the JAX package's public API, name for name.

`test_public_name`: for every public module of `tokenizers_tpu` outside
`ops/`, `parallel/` and `native/`, each public name (its `__all__`, the
classes, functions and constants it defines, and for a package what it
imports from the package) resolves in the port's module of the same
path; a function or method takes JAX's parameters under JAX's names, in
JAX's order (the port may add parameters after them, with defaults); a
class is a class, a subpackage a module, a constant the same value.

`test_model_tokenize_gives_jax_tokens`: `Model.tokenize` of each model
family on the fixtures' vocabularies gives JAX's `Token`s (id, value,
offsets in the word's UTF-8 bytes) on the words JAX's own pipeline cuts
from the shared corpus strings, byte fallback included.

`test_set_default_device`: the explicit counterpart of JAX's
`JAX_PLATFORMS=cpu` moves every entry point given no device and gives
the previous setting back; without it the default is the card, which
raises where there is none.

`test_twin_is_the_jax_file`: each `test_torch_jax_<name>.py` is JAX's
`test_<name>.py` with `tokenizers_tpu` read as `tokenizers_tpu_torch`,
imports of a sibling test module pointing at its twin, one autouse
fixture that asks for the CPU (`set_default_device`) and puts the
previous device back, and nothing else (but `xfail(strict=True)` lines
naming a Queue C entry of ROADMAP.md, of which there are none).
"""

import ast
import importlib
import inspect
import os
import pkgutil
import re
import types
import typing

import pytest
from corpus import SHORT_STRINGS

import tokenizers_tpu
import tokenizers_tpu_torch
from tokenizers_tpu_torch.smoke_data import config_json

TESTS = os.path.dirname(os.path.abspath(__file__))
EXCLUDED = ("ops", "parallel", "native")
TWINS = ("conformance_encoding", "conformance_models", "conformance_normalizers",
         "conformance_pipeline", "conformance_pretokenizers", "conformance_trainers",
         "errors", "golden_fixtures", "python_api", "reference_vectors", "implementations")

FIXTURE = '''

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)'''
XFAIL = re.compile(r'^ *@pytest\.mark\.xfail\(strict=True, reason="ROADMAP\.md Queue C: [^"]+"\)$')


def _jax_modules():
    out = ["tokenizers_tpu"]
    for m in pkgutil.walk_packages(tokenizers_tpu.__path__, "tokenizers_tpu."):
        parts = m.name.split(".")
        if parts[1] not in EXCLUDED and not any(p.startswith("_") for p in parts[1:]):
            out.append(m.name)
    return out


def _public(mod):
    """`__all__`, the names the module's source defines at top level, and
    for a package the names it imports from inside the package."""
    names = set(getattr(mod, "__all__", ()))
    package = mod.__file__.endswith("__init__.py")
    for node in ast.parse(inspect.getsource(mod)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif package and isinstance(node, ast.ImportFrom) and node.level > 0:
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_")
                  and not isinstance(getattr(mod, n), typing.TypeVar))


def _cases():
    for name in _jax_modules():
        mod = importlib.import_module(name)
        for n in _public(mod):
            yield name, n
            v = getattr(mod, n)
            if inspect.isclass(v) and v.__module__ == name:  # members where defined
                for m in sorted(set(dir(v)) | {"__init__"}):
                    if m == "__init__" or not m.startswith("_"):
                        yield name, f"{n}.{m}"


def _resolve(obj, dotted):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _check_parameters(jax_fn, port_fn):
    P = inspect.Parameter
    try:
        js = inspect.signature(jax_fn)
    except (TypeError, ValueError):
        return
    jp, pp = list(js.parameters.values()), list(inspect.signature(port_fn).parameters.values())
    positional = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)
    jpos = [p.name for p in jp if p.kind in positional]
    ppos = [p.name for p in pp if p.kind in positional]
    assert ppos[:len(jpos)] == jpos, (jpos, ppos)
    port_kinds = {p.kind for p in pp}
    port_names = {p.name for p in pp if p.kind != P.VAR_POSITIONAL}
    for p in jp:
        if p.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD):
            assert p.kind in port_kinds, p
        elif p.kind == P.KEYWORD_ONLY:
            assert p.name in port_names or P.VAR_KEYWORD in port_kinds, p
    jax_names = {p.name for p in jp}
    for p in pp:
        assert p.name in jax_names or p.default is not P.empty or p.kind in (
            P.VAR_POSITIONAL, P.VAR_KEYWORD), f"the port's {p.name} needs a default"


@pytest.mark.parametrize("module,name", list(_cases()),
                         ids=lambda x: x.replace("tokenizers_tpu", "tt"))
def test_public_name(module, name):
    want = _resolve(importlib.import_module(module), name)
    got = _resolve(importlib.import_module(
        module.replace("tokenizers_tpu", "tokenizers_tpu_torch", 1)), name)
    if isinstance(want, types.ModuleType):
        assert isinstance(got, types.ModuleType)
        assert got.__name__ == want.__name__.replace("tokenizers_tpu", "tokenizers_tpu_torch", 1)
    elif inspect.isclass(want):
        assert inspect.isclass(got)
    elif callable(want):
        assert callable(got)
        _check_parameters(want, got)
    elif isinstance(want, (str, int, float, bool, tuple, frozenset)):
        assert got == want


FIXTURES = os.path.join(TESTS, "fixtures")
FALLBACK_VOCAB = {"<0xC3>": 0, "<0xA9>": 1, "a": 2, "b": 3, "ab": 4, "<unk>": 5}


def _models(name):
    """(JAX's model, the port's, the words JAX's pipeline gives the model)."""
    if name == "bpe_byte_fallback":
        kw = dict(byte_fallback=True, unk_token="<unk>")
        return (tokenizers_tpu.models.BPE(FALLBACK_VOCAB, [("a", "b")], **kw),
                tokenizers_tpu_torch.models.BPE(FALLBACK_VOCAB, [("a", "b")], **kw),
                ["abéa", "ééxab", "é", "bb"])
    if name == "wordlevel":
        blob = config_json("wordlevel")
        jax_tok = tokenizers_tpu.Tokenizer.from_str(blob)
        port_tok = tokenizers_tpu_torch.Tokenizer.from_str(blob, device="cpu")
    else:
        path = os.path.join(FIXTURES, name, "tokenizer.json")
        jax_tok = tokenizers_tpu.Tokenizer.from_file(path)
        port_tok = tokenizers_tpu_torch.Tokenizer.from_file(path, device="cpu")
    words = []
    for text in SHORT_STRINGS:
        if jax_tok.normalizer is not None:
            text = jax_tok.normalizer.normalize_str(text)
        words += [w for w, _ in jax_tok.pre_tokenizer.pre_tokenize_str(text)]
    return jax_tok.model, port_tok.model, words


@pytest.mark.parametrize("name", ["gpt2", "bert", "wordlevel", "unigram", "bpe_byte_fallback"])
def test_model_tokenize_gives_jax_tokens(name):
    jax_model, port_model, words = _models(name)
    assert isinstance(port_model, tokenizers_tpu_torch.models.Model)
    assert len(words) > 3
    for w in words:
        want = [(t.id, t.value, tuple(t.offsets)) for t in jax_model.tokenize(w)]
        got = port_model.tokenize(w)
        assert all(isinstance(t, tokenizers_tpu_torch.Token) for t in got)
        assert [(t.id, t.value, tuple(t.offsets)) for t in got] == want, w
        assert port_model.tokenize_ids(w) == [t[0] for t in want], w


def test_set_default_device():
    import torch

    tt = tokenizers_tpu_torch
    previous = tt.set_default_device(None)
    try:
        if torch.cuda.is_available():
            assert tt.pick_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tt.pick_device()
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tt.Tokenizer(tt.models.BPE())
        assert tt.set_default_device("cpu") is None
        assert tt.pick_device() == torch.device("cpu")
        assert tt.pick_device("meta") == torch.device("meta")  # a named device wins
        path = os.path.join(FIXTURES, "gpt2", "tokenizer.json")
        tok = tt.Tokenizer.from_file(path)
        assert tok.device.type == "cpu"
        assert tok.encode("Hello world").ids == tt.Tokenizer.from_file(
            path, device="cpu").encode("Hello world").ids
        assert tt.set_default_device(None) == torch.device("cpu")
    finally:
        tt.set_default_device(previous)


def twin_source(jax_source: str) -> str:
    """The twin of a JAX test file: the package renamed, sibling test
    modules pointing at their twins, `FIXTURE` after the imports."""
    out = re.sub(r"\btokenizers_tpu\b", "tokenizers_tpu_torch", jax_source)
    out = re.sub(r"^(\s*from )test_(%s)( import)" % "|".join(TWINS),
                 r"\1test_torch_jax_\2\3", out, flags=re.M)
    lines = out.split("\n")
    end, i = None, 0
    while i < len(lines):
        line = lines[i]
        if line.startswith(("import ", "from ")):
            while lines[i].rstrip().endswith("("):  # an import over several lines
                while not lines[i].startswith(")"):
                    i += 1
            end = i
        elif end is not None and line.strip() and not line.startswith(("#", " ")):
            break
        i += 1
    lines[end] += FIXTURE
    return "\n".join(lines)


@pytest.mark.parametrize("name", TWINS)
def test_twin_is_the_jax_file(name):
    with open(os.path.join(TESTS, f"test_{name}.py"), encoding="utf-8") as f:
        want = twin_source(f.read())
    with open(os.path.join(TESTS, f"test_torch_jax_{name}.py"), encoding="utf-8") as f:
        got = f.read()
    got = "\n".join(line for line in got.split("\n") if not XFAIL.match(line))
    assert got == want
