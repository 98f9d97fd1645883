"""Host C++ of the port: the Unigram trainer's seed enumerator and the C ABI.

`suffix_substrings(chars)` gives
every internal node of the suffix tree of a codepoint sequence as
(offset, char length, occurrence count); copy of the JAX package's
`native.suffix_substrings` (reference `models/unigram/trainer.rs:227-230`,
`esaxx_rs::suffix`).

`esaxx.cpp` is built with `g++ -O2 -shared -fPIC` at first use into the
git-ignored `_cache/` beside the package (`TOKENIZERS_TPU_TORCH_CACHE`
moves it) and called through ctypes.  It raises when it cannot build:
there is no silent fallback.  `_suffix_array_numpy` and
`_enumerate_numpy` (a doubling suffix array, Kasai's LCP and the same
interval sweep) are its plain version, which the tests hold it against.

`build_c_api()` builds the C ABI (`c_api.cpp`, the counterpart of the JAX
package's: it embeds CPython and forwards to this package) with `g++`
against the running interpreter's headers and libpython, at first use
and whenever the source is newer, into `_build/` beside the package
(`TOKENIZERS_TPU_TORCH_BUILD` moves it), and gives the library's path for
C programs to link; it raises when it cannot build.  `build_c_driver`
compiles a C program against it, and `c_api_env` gives the environment
in which such a program's embedded interpreter imports this package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import List, Tuple

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "esaxx.cpp")
_lib = None


def _build_lib():
    """The loaded library, built when missing or older than its source."""
    global _lib
    if _lib is not None:
        return _lib
    from ..ops.bert_tables import cache_dir

    sopath = os.path.join(cache_dir(), "libesaxx_v1.so")
    if not os.path.exists(sopath) or os.path.getmtime(sopath) < os.path.getmtime(SRC):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(sopath))
        os.close(fd)
        out = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", SRC, "-o", tmp],
                             capture_output=True, text=True)
        if out.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ could not build {SRC}:\n{out.stderr}")
        os.replace(tmp, sopath)  # atomic: a concurrent build never loads half a file
    lib = ctypes.CDLL(sopath)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.esaxx_enumerate.restype = ctypes.c_int64
    lib.esaxx_enumerate.argtypes = [i32p, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p,
                                    ctypes.c_int64]
    _lib = lib
    return lib


def _compact(chars: np.ndarray) -> Tuple[np.ndarray, int]:
    """The symbols remapped to 1..k-1 with a unique smallest sentinel 0
    appended, and k."""
    uniq, inv = np.unique(chars, return_inverse=True)
    s = np.concatenate([(inv + 1).astype(np.int32), np.zeros(1, np.int32)])
    return s, len(uniq) + 1


def suffix_substrings(chars: np.ndarray) -> List[Tuple[int, int, int]]:
    """All suffix-tree internal nodes of `chars` (int32 codepoints >= 0):
    a list of (offset, char_len, occurrence_count), those that span the
    end left out."""
    chars = np.asarray(chars, dtype=np.int32)
    n = len(chars)
    if n == 0:
        return []
    s, k = _compact(chars)
    lib = _build_lib()
    cap = 4 * (n + 1) + 16
    out = np.zeros((3, cap), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    cnt = lib.esaxx_enumerate(s.ctypes.data_as(i32p), np.int32(n + 1), np.int32(k),
                              out[0].ctypes.data_as(i32p), out[1].ctypes.data_as(i32p),
                              out[2].ctypes.data_as(i32p), np.int64(cap))
    if cnt > cap:
        raise RuntimeError("esaxx capacity exceeded")
    off, ln, c = out[:, : int(cnt)]
    keep = off + ln <= n  # nodes that span the sentinel are not substrings
    return list(zip(off[keep].tolist(), ln[keep].tolist(), c[keep].tolist()))


def _suffix_array_numpy(s: np.ndarray) -> np.ndarray:
    """Doubling suffix array (O(n log^2 n))."""
    n = len(s)
    rank = np.argsort(s, kind="stable")
    r = np.zeros(n, np.int64)
    sr = s[rank]
    r[rank] = np.cumsum(np.concatenate([[0], (sr[1:] != sr[:-1]).astype(np.int64)]))
    k = 1
    sa = rank
    while k < n:
        key2 = np.full(n, -1, np.int64)
        key2[: n - k] = r[k:]
        order = np.lexsort((key2, r))
        nr = np.zeros(n, np.int64)
        rr = np.stack([r[order], key2[order]], axis=1)
        neq = np.any(rr[1:] != rr[:-1], axis=1)
        nr[order] = np.cumsum(np.concatenate([[0], neq.astype(np.int64)]))
        r = nr
        sa = order
        if r[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa.astype(np.int64)


def _enumerate_numpy(s: np.ndarray) -> List[Tuple[int, int, int]]:
    """The LCP intervals of `s` (sentinel-terminated) as esaxx.cpp's sweep
    gives them."""
    n = len(s)
    sa = _suffix_array_numpy(s)
    rank = np.zeros(n, np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, np.int64)
    h = 0
    for i in range(n):
        if rank[i] > 0:
            j = sa[rank[i] - 1]
            while i + h < n and j + h < n and s[i + h] == s[j + h]:
                h += 1
            lcp[rank[i]] = h
            if h:
                h -= 1
        else:
            h = 0
    out = []
    stack = [(0, 0)]  # (lcp, left)
    for i in range(1, n + 1):
        cur = int(lcp[i]) if i < n else 0
        left = i - 1
        while stack and cur < stack[-1][0]:
            d, l0 = stack.pop()
            if d > 0:
                out.append((int(sa[l0]), d, i - l0))
            left = l0
        if not stack or cur > stack[-1][0]:
            stack.append((cur, left))
    return out


def suffix_substrings_plain(chars: np.ndarray) -> List[Tuple[int, int, int]]:
    """`suffix_substrings` by the numpy enumeration (the plain version)."""
    chars = np.asarray(chars, dtype=np.int32)
    n = len(chars)
    if n == 0:
        return []
    s, _k = _compact(chars)
    return [(o, l, c) for (o, l, c) in _enumerate_numpy(s.astype(np.int64)) if o + l <= n]


C_API_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "c_api.cpp")


def build_c_api(force: bool = False) -> str:
    """The path of `libtokenizers_tpu_torch_c.so`, built when missing or
    older than `c_api.cpp` (or with `force`)."""
    import sysconfig

    from ..ops.kernel_build import build_dir

    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    sopath = os.path.join(out_dir, "libtokenizers_tpu_torch_c.so")
    if not force and os.path.exists(sopath) and \
            os.path.getmtime(sopath) >= os.path.getmtime(C_API_SRC):
        return sopath
    libdir = sysconfig.get_config_var("LIBDIR")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", f"-I{sysconfig.get_path('include')}",
           C_API_SRC, "-o", tmp, f"-L{libdir}", f"-Wl,-rpath,{libdir}",
           f"-lpython{sysconfig.get_config_var('LDVERSION')}"]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not build {C_API_SRC}:\n{out.stderr}")
    os.replace(tmp, sopath)  # atomic: a concurrent build never loads half a file
    return sopath


def build_c_driver(source: str, out: str) -> str:
    """Compile the C program `source` with `gcc` against the C ABI
    (`build_c_api`) and libpython, both found at run time by rpath; its
    path `out`."""
    import sysconfig

    so = build_c_api()
    libdir = sysconfig.get_config_var("LIBDIR")
    cmd = ["gcc", "-O1", f"-I{sysconfig.get_path('include')}", source, "-o", out, so,
           f"-Wl,-rpath,{os.path.dirname(so)}", f"-L{libdir}", f"-Wl,-rpath,{libdir}",
           f"-lpython{sysconfig.get_config_var('LDVERSION')}"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"gcc could not build {source}:\n{res.stderr}")
    return out


def c_api_env(env=None) -> dict:
    """`env` (default: this process's) for a program that embeds the port
    through the C ABI: PYTHONPATH leads with the directory holding this
    package and this interpreter's site-packages, PATH with this
    interpreter's directory, so that the embedded interpreter imports the
    same packages as this one."""
    import site
    import sys

    env = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    paths = [root, *site.getsitepackages(), env.get("PYTHONPATH", "")]
    env["PYTHONPATH"] = os.pathsep.join(p for p in paths if p)
    env["PATH"] = os.pathsep.join(p for p in (os.path.dirname(sys.executable),
                                              env.get("PATH", "")) if p)
    return env
