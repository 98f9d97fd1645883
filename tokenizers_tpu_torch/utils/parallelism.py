"""Host-side parallelism (reference `utils/parallelism.rs:15-246`): the
`TOKENIZERS_PARALLELISM` switch with a process-wide override, and
`maybe_par_map`, which maps a function over a batch on a pool of worker
processes.  The JAX package's `utils/parallelism.py` has the same
surface; the pool differs.

*The pool.*  The JAX package forks its workers at each call.  A fork is
not safe in a process that has a CUDA context or other threads (NCCL's on
the card, JAX's in the tests), so the port's workers are forked by a
helper: a fresh interpreter that imports this package and nothing else
(no caller's `__main__`, unlike multiprocessing's `forkserver`) and forks
one worker a core from itself.  The helper is started at the first map
that could use it and kept for the life of the process.

*A map.*  The items go in chunks to the workers and to the caller, which
takes a chunk whenever no worker's reply is waiting.  So no map waits for
the pool: the helper starts in the background (its import of torch takes
seconds) while the caller works, and workers join the map as they come
up.  `fn` is pickled at each map.  An object that many maps share, such
as a tokenizer, goes as a `Shared`: pickled once, loaded by each worker
once and kept there under its key (the last two a worker used), and
passed to `fn` first; a worker is given chunks only once it holds it.  `start_pool(wait=True)` waits for
the workers and their loads.  Workers run host Python only: the helper
hides every card (`CUDA_VISIBLE_DEVICES` empty) before it imports
anything.

*Departures from the JAX package.*  A worker's exception is raised in the
caller (with the worker's traceback as its cause), and a worker or a
helper that dies raises too; the JAX package falls back to the serial
map on any failure of the pool.  Results are the same, in the same order,
as the serial map.  Callers keep serial what the workers could not
reproduce (BPE dropout; `Tokenizer._host_map`).
"""

from __future__ import annotations

import atexit
import itertools
import os
import pickle
import select
import socket
import struct
import subprocess
import sys
import threading
import time
import traceback
from collections import OrderedDict, deque
from functools import partial
from multiprocessing.connection import Connection, wait
from typing import Callable, Dict, List, Optional, Sequence

ENV_VARIABLE = "TOKENIZERS_PARALLELISM"
MIN_ITEMS = 8  # below this a batch stays serial (the JAX package's threshold)
SHARED_KEPT = 2  # shared objects (tokenizers) a worker keeps
HELPER_TIMEOUT_S = 300  # for the helper to import the package and fork its workers

_override: Optional[bool] = None
_used_parallelism = False


def parse_env_bool(val: Optional[str]) -> Optional[bool]:
    """The reference's spellings (parallelism.rs:25-38): "", off, false,
    f, no, n and 0 (any case, spaces stripped) are False, anything else
    True; None when unset."""
    if val is None:
        return None
    return val.strip().lower() not in ("", "off", "false", "f", "no", "n", "0")


def is_parallelism_configured() -> bool:
    """True when the variable or the override is set (reference
    `has_parallelism_been_set`)."""
    return _override is not None or os.environ.get(ENV_VARIABLE) is not None


def get_parallelism() -> bool:
    """The override, else the variable, else True (reference
    `get_parallelism`, parallelism.rs:41-52)."""
    if _override is not None:
        return _override
    env = parse_env_bool(os.environ.get(ENV_VARIABLE))
    return True if env is None else env


def set_parallelism(value: bool) -> None:
    """The process-wide override (reference `set_parallelism`)."""
    global _override
    _override = bool(value)


def has_used_parallelism() -> bool:
    return _used_parallelism


def cpu_count() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


class _RemoteTraceback(Exception):
    def __init__(self, tb: str):
        super().__init__(tb)
        self.tb = tb

    def __str__(self):
        return self.tb


class Shared:
    """An object that many maps pass to `fn`: `obj` in this process, and in
    a worker what `make()` gives, `(loader, args)`, loaded there once as
    `loader(*args)` and kept under this `Shared`'s key.  `make` is called at
    most once, when a worker first needs the object."""

    _keys = itertools.count()

    def __init__(self, obj, make: Callable[[], tuple]):
        self.obj = obj
        self.key = next(Shared._keys)
        self._make = make
        self._blob: Optional[bytes] = None

    @property
    def blob(self) -> bytes:
        if self._blob is None:
            self._blob = pickle.dumps(self._make(), pickle.HIGHEST_PROTOCOL)
        return self._blob


def _hold(held: "OrderedDict", key: int, obj=None) -> None:
    """`held` after loading or using `key`: the `SHARED_KEPT` last loaded
    or used.  A worker keeps its shared objects so, and the pool mirrors
    each worker's keys so, in the same order."""
    held[key] = held.pop(key, obj)
    while len(held) > SHARED_KEPT:
        held.popitem(last=False)


def _serve(conn) -> None:
    """A worker, until the pipe closes.  (None, key, pickled shared object,
    None) loads the object and answers (True, key); (pickled fn, key or
    None, None, items) answers (True, results).  A failure answers (False,
    exception, traceback).  A map's chunks carry the same pickled fn,
    unpickled once."""
    held: OrderedDict = OrderedDict()
    fn, fn_blob = None, None
    while True:
        try:
            blob, k, state, items = conn.recv()
        except EOFError:
            return
        try:
            if blob is not None and blob != fn_blob:
                fn, fn_blob = None, None
                fn, fn_blob = pickle.loads(blob), blob
            if blob is None:
                loader, args = pickle.loads(state)
                _hold(held, k, loader(*args))
                reply = (True, k)
            elif k is None:
                reply = (True, [fn(x) for x in items])
            elif k not in held:
                raise RuntimeError("a host pool worker was sent work for a shared object "
                                   "it does not hold")
            else:
                _hold(held, k)
                reply = (True, [fn(held[k], x) for x in items])
        except Exception as e:  # the caller raises it
            reply = (False, e, traceback.format_exc())
        try:
            conn.send(reply)
        except Exception as e:  # an exception or a result that does not pickle
            conn.send((False, RuntimeError(f"a host pool worker could not send its reply: "
                                           f"{e!r}"), traceback.format_exc()))


def _python_executable() -> str:
    """The interpreter the pool's helper runs: `sys.executable`, unless this
    process embeds Python (the C ABI), where it names the host program."""
    exe = sys.executable
    if exe and os.path.basename(exe).startswith("python"):
        return exe
    ver = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    for prefix in (sys.prefix, sys.base_prefix):
        cand = os.path.join(prefix, "bin", ver)
        if os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(f"the host pool found no {ver} interpreter under {sys.prefix}")


class HostPool:
    """Worker processes, each on its own pipe, forked by a helper
    interpreter that has imported this package (`_zygote`) and that
    reaps them once they exit.  The helper is started here and comes up
    in the background (`ready`)."""

    def __init__(self, workers: int):
        self.pid = os.getpid()
        self.t0 = time.time()
        self.up_s: Optional[float] = None  # from the helper's start to its workers' being up
        self.workers = workers
        self.closed = False
        self.used = False  # whether a worker has mapped a chunk
        self.conns: List[Connection] = []
        self.keys: List[OrderedDict] = []  # the `Shared`s each worker holds (`_hold`)
        self.busy: Dict[int, Optional[int]] = {}  # worker: its chunk, or None for a load
        self.sock, theirs = socket.socketpair()
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        code = (f"import sys; sys.path.insert(0, {root!r}); "
                f"from tokenizers_tpu_torch.utils.parallelism import _zygote; _zygote()")
        try:
            self.helper = subprocess.Popen(
                [_python_executable(), "-c", code, str(theirs.fileno()), str(workers)],
                pass_fds=(theirs.fileno(),), stdin=subprocess.DEVNULL)
        except BaseException:
            self.sock.close()
            self.closed = True
            raise
        finally:
            theirs.close()

    def __len__(self) -> int:
        return len(self.conns)

    def ready(self, block: bool = False) -> bool:
        """Whether the workers are up: at once, or (`block`) after waiting
        for them.  Raises if the helper exited before it started them."""
        if self.conns:
            return True
        try:
            if not block and not select.select([self.sock], [], [], 0)[0]:
                return False
            self.sock.settimeout(HELPER_TIMEOUT_S)
            msg, fds, _flags, _addr = socket.recv_fds(self.sock, 8, self.workers)
            if len(fds) != self.workers or len(msg) != 8:
                for fd in fds:
                    os.close(fd)
                raise RuntimeError("the host pool's helper exited before it started its "
                                   f"workers (exit code {self.helper.poll()})")
        except BaseException:
            self.close()
            raise
        self.up_s = struct.unpack("d", msg)[0] - self.t0  # the helper's clock at its send
        self.sock.close()
        self.conns = [Connection(fd) for fd in fds]
        self.keys = [OrderedDict() for _ in fds]
        return True

    def map(self, fn: Callable, items: Sequence, workers: int,
            shared: Optional[Shared] = None, call: Optional[Callable] = None) -> list:
        """`fn` over `items` in chunks, on up to `workers` workers and in
        the caller (`call`, the serial form of `fn`): the caller takes a
        chunk whenever no reply is waiting, so it works while the helper
        starts and while a worker loads `shared`, and a worker is given
        chunks only once it is up and holds `shared`.  The results are in
        the items' order.  A load still running at the end is left to
        finish; its reply is read at a later map or `settle`."""
        blob = pickle.dumps(fn, pickle.HIGHEST_PROTOCOL)
        key = None if shared is None else shared.key
        size = max(1, -(-len(items) // (4 * workers)))
        chunks = [items[i:i + size] for i in range(0, len(items), size)]
        results: List[Optional[list]] = [None] * len(chunks)
        todo = deque(range(len(chunks)))
        ours: List[int] = []  # the workers this map may give chunks to
        error, dead = None, False

        def give(w: int) -> None:
            nonlocal error, dead
            try:
                if key is not None and key not in self.keys[w]:
                    self.conns[w].send((None, key, shared.blob, None))
                    self.busy[w] = None
                elif todo and error is None:
                    ci = todo.popleft()
                    self.conns[w].send((blob, key, None, chunks[ci]))
                    self.busy[w] = ci
                    if key is not None:
                        _hold(self.keys[w], key)
            except OSError as e:  # its end of the pipe is closed
                dead = True
                if error is None:
                    error = RuntimeError("a host pool worker exited")
                    error.__cause__ = e

        try:
            while (todo and error is None) or any(c is not None for c in self.busy.values()):
                if not ours and self.ready():
                    ours = list(range(min(workers, len(self.conns))))
                    for w in ours:
                        if w not in self.busy:
                            give(w)
                by_conn = {self.conns[w]: w for w in self.busy}
                for conn in wait(list(by_conn), 0 if todo and error is None else None) \
                        if by_conn else ():
                    w = by_conn[conn]
                    ci = self.busy.pop(w)
                    try:
                        reply = conn.recv()
                    except (EOFError, OSError) as e:
                        dead = True
                        if error is None:
                            error = RuntimeError("a host pool worker exited")
                            error.__cause__ = e
                        continue
                    if not reply[0]:
                        if error is None:
                            error = reply[1]
                            error.__cause__ = _RemoteTraceback(reply[2])
                        continue
                    if ci is None:
                        _hold(self.keys[w], reply[1])
                    else:
                        results[ci] = reply[1]
                        self.used = True
                    if w in ours and not dead:
                        give(w)
                if todo and error is None:
                    ci = todo.pop()  # the caller takes from the back, the workers from the front
                    try:
                        results[ci] = [call(x) for x in chunks[ci]]
                    except Exception as e:
                        error = e
        except BaseException:  # an interrupt leaves replies in the pipes: start afresh
            self.close()
            raise
        if error is not None:
            if dead:
                self.close()
            raise error
        return [x for r in results for x in r]

    def settle(self) -> None:
        """Wait for the loads still running (`map`)."""
        try:
            for w in list(self.busy):
                reply = self.conns[w].recv()
                del self.busy[w]
                if reply[0]:
                    _hold(self.keys[w], reply[1])
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Close every pipe (each worker then exits) and wait for the
        helper, which reaps them; a helper still starting is killed."""
        self.closed = True
        starting = not self.conns
        for conn in self.conns:
            conn.close()
        self.conns, self.keys, self.busy = [], [], {}
        self.sock.close()
        helper = getattr(self, "helper", None)
        if helper is not None:
            if starting:
                helper.kill()
            try:
                helper.wait(timeout=30)
            except subprocess.TimeoutExpired:
                helper.kill()
                helper.wait()


def _zygote() -> None:
    """The helper: import the package once, fork the workers, hand the
    workers' ends of their pipes to the pool in one message (with the
    time it was sent), then reap the workers."""
    sock = socket.socket(fileno=int(sys.argv[1]))
    n = int(sys.argv[2])
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # before anything could touch a card
    import tokenizers_tpu_torch  # noqa: F401  (the workers fork with it imported)

    fds = []
    for _ in range(n):
        ours, theirs = socket.socketpair()
        if os.fork() == 0:
            sock.close()
            ours.close()
            for fd in fds:
                os.close(fd)
            try:
                _serve(Connection(theirs.detach()))
            finally:
                os._exit(0)
        theirs.close()
        fds.append(ours.detach())
    try:
        socket.send_fds(sock, [struct.pack("d", time.time())], fds)
    except OSError:  # the pool was closed while the workers started
        pass
    for fd in fds:
        os.close(fd)
    sock.close()
    while True:
        try:
            os.wait()
        except ChildProcessError:
            return


_pool: Optional[HostPool] = None
_lock = threading.RLock()  # a map's `fn` may map in turn


def _close_pool() -> None:
    global _pool
    if _pool is not None and _pool.pid == os.getpid():
        _pool.close()
    _pool = None


atexit.register(_close_pool)


def _started() -> HostPool:
    global _pool
    if _pool is None or _pool.pid != os.getpid() or _pool.closed:
        _pool = HostPool(cpu_count())  # a forked child never reuses its parent's pipes
    return _pool


def start_pool(wait: bool = False) -> HostPool:
    """The process's pool, started now if it is not; with `wait`, once its
    workers are up and have loaded what they were sent."""
    with _lock:
        pool = _started()
        if wait:
            pool.ready(block=True)
            pool.settle()
        return pool


def maybe_par_map(fn: Callable, items: Sequence, min_items: int = MIN_ITEMS,
                  shared: Optional[Shared] = None) -> list:
    """`[fn(x) for x in items]` (`fn(shared.obj, x)` with a `shared`
    object), on the host pool and in the caller (`HostPool.map`) when
    parallelism is on and there are at least `min_items` items (a worker
    for every `min_items` items, at least two, at most one a core); else
    serially.  `fn`, `shared` and each result must pickle; a worker's
    exception is raised here."""
    global _used_parallelism
    items = list(items)
    call = fn if shared is None else partial(fn, shared.obj)
    workers = min(cpu_count(), max(2, len(items) // max(1, min_items)))
    if len(items) < min_items or workers < 2 or not get_parallelism():
        return [call(x) for x in items]
    with _lock:
        pool = _started()
        try:
            return pool.map(fn, items, workers, shared, call)
        finally:
            _used_parallelism = _used_parallelism or pool.used
