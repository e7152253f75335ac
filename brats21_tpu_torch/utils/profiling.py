"""Profiling and tracing hooks (JAX ``brats21_tpu/utils/profiling.py``) on
``torch.profiler``.

* :func:`annotate` — the port's one span recorder: a named span around a
  phase of the pipeline, recorded while a ``torch.profiler`` runs in the
  process and otherwise a flag check and nothing else. Each :class:`Span`
  holds its id, the id of the span open around it on its thread (the one
  that caused it), its case (a patient id, inherited from that parent),
  its thread, its name, its start and end on ``time.time_ns`` (the clock
  onto which a device trace's kernels are put) and its counts. Spans go
  into a bounded buffer that :func:`spans` copies. Inside :func:`capture`
  each span is also a ``record_function`` range in the Chrome trace; under
  a profiler that the program did not start it puts nothing into that
  profiler's trace.
* :func:`capture` — a trace of the enclosed block (CPU ops, and the card's
  kernels and copies) written as a Chrome trace into a directory.
* :func:`trace_server` / :func:`maybe_enable_from_env`
  (``BRATS21_PROFILE_PORT``) — torch has no live profiler server to which
  TensorBoard could attach, as ``jax.profiler.start_server`` is. What
  stands in for it: a daemon thread serving HTTP on ``127.0.0.1:port``;
  each ``GET /capture?ms=N`` takes a ``torch.profiler`` window of N ms over
  the live process and answers with the path of the Chrome trace it wrote.
* :func:`tune_host_allocator` — glibc ``mallopt`` through ``ctypes``
  (``BRATS21_NO_MALLOC_TUNE`` opts out).

The JAX module's ``enable_compilation_cache`` and ``_cpu_fingerprint``
serve XLA's persistent compilation cache; torch compiles nothing here
(the kernels are built once into ``_build/``), so they have no
counterpart.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Deque, Dict, Iterator, List, Optional
from urllib.parse import parse_qs, urlparse

import torch
from torch.autograd import profiler as _autograd_profiler

from .. import get_logger

logger = get_logger("profiling")

_server: Optional["_TraceServer"] = None
_server_lock = threading.Lock()
# torch's profiler runs one window at a time in a process
_capture_lock = threading.Lock()
# true while capture() runs: only then does a span enter a record_function
_capturing = False

#: the spans kept: the newest this many, older ones dropped
SPANS_MAX = 1 << 16
# appended and copied by single deque calls, each atomic under the GIL: no
# lock, so that no span waits on another thread's
_spans: Deque["Span"] = deque(maxlen=SPANS_MAX)
_span_ids = itertools.count(1)
_open = threading.local()       # .stack: this thread's open spans, innermost last


def _profiler_running() -> bool:
    """Whether a ``torch.profiler`` runs anywhere in the process (the
    profiler's process-wide flag)."""
    return _autograd_profiler._is_profiler_enabled


@dataclass(eq=False, slots=True)
class Span:
    """One recorded span; ``start_ns`` and ``end_ns`` on ``time.time_ns``."""
    id: int
    parent: Optional[int]
    case: Optional[str]
    thread: str
    name: str
    start_ns: int
    end_ns: int = 0
    counts: Dict[str, int] = field(default_factory=dict)

    def count(self, key: str, n: int = 1) -> None:
        """Add ``n`` to the span's count ``key``."""
        self.counts[key] = self.counts.get(key, 0) + n


class _NoSpan:
    """What :func:`annotate` gives when nothing is recorded: a context
    manager that yields itself, and whose ``count`` does nothing."""
    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def count(self, key: str, n: int = 1) -> None:
        pass


_NO_SPAN = _NoSpan()


@dataclass
class Trace:
    """What :func:`capture` yields: the profiler, and once the block has
    ended the path of the Chrome trace it wrote."""
    profile: torch.profiler.profile
    path: Optional[str] = None


def _profile() -> torch.profiler.profile:
    """A profiler of CPU (and, with a card, CUDA) activity; of every
    thread's CPU ops where this torch can."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):       # an older torch: this thread's ops
        config = None
    return torch.profiler.profile(activities=activities, experimental_config=config)


def annotate(name: str, case: Optional[str] = None, **counts: int):
    """``with annotate(name, case=None, **counts) as span:`` a span around
    the block, recorded while a ``torch.profiler`` runs in the process; the
    block may add counts (``span.count("reads", n)``). ``case`` defaults to
    the enclosing span's. With no profiler running it costs a flag check
    and yields a span whose ``count`` does nothing."""
    if not _profiler_running():
        return _NO_SPAN
    return _Recording(name, case, counts)


class _Recording:
    """A span being recorded: on this thread's stack of open spans while
    the block runs, into the buffer when it ends."""

    __slots__ = ("span", "_range")

    def __init__(self, name: str, case: Optional[str], counts: Dict[str, int]):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        if case is None and parent is not None:
            case = parent.case
        self.span = Span(next(_span_ids), parent.id if parent is not None else None, case,
                         threading.current_thread().name, name, 0, counts=counts)
        self._range = torch.profiler.record_function(name) if _capturing else None

    def __enter__(self) -> Span:
        _open.stack.append(self.span)
        if self._range is not None:
            self._range.__enter__()
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.span.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        _open.stack.pop()
        _spans.append(self.span)
        return False


def spans(since_ns: int = 0) -> List[Span]:
    """A copy of the recorded spans that started at ``since_ns`` or later
    (``time.time_ns``), in the order they ended."""
    return [s for s in _spans.copy() if s.start_ns >= since_ns]


@contextlib.contextmanager
def capture(log_dir: str) -> Iterator[Trace]:
    """Trace the enclosed block into ``log_dir`` (a Chrome trace,
    ``trace_<pid>_<ms>.json``, whose path the yielded :class:`Trace` holds
    once the block has ended)."""
    global _capturing
    os.makedirs(log_dir, exist_ok=True)
    if not _capture_lock.acquire(blocking=False):
        raise RuntimeError("a profiler capture is already running in this process")
    try:
        trace = Trace(_profile())
        with trace.profile:
            _capturing = True
            try:
                yield trace
            finally:
                _capturing = False
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
        trace.profile.export_chrome_trace(path)
        trace.path = path
    finally:
        _capture_lock.release()
    logger.info("trace written to %s", path)


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server's name
        url = urlparse(self.path)
        try:
            if url.path != "/capture":
                raise ValueError(f"unknown path {url.path!r}: ask GET /capture?ms=N")
            ms = float(parse_qs(url.query).get("ms", ["1000"])[0])
            if not 0 < ms <= 600_000:
                raise ValueError(f"ms={ms}: want 0 < ms <= 600000")
            with capture(self.server.log_dir) as trace:
                time.sleep(ms / 1e3)
            code, body = 200, trace.path
        except Exception as e:  # noqa: BLE001 — answered to the client
            code, body = 500, f"{type(e).__name__}: {e}"
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):
        logger.info("trace server: " + fmt, *args)


class _TraceServer(HTTPServer):
    def __init__(self, port: int, log_dir: str):
        super().__init__(("127.0.0.1", port), _Handler)
        self.log_dir = log_dir
        self.thread = threading.Thread(target=self.serve_forever, name="trace-server",
                                       daemon=True)
        self.thread.start()


def trace_server(port: int = 9999, log_dir: Optional[str] = None) -> int:
    """Start the capture server once (idempotent: a later call returns the
    first server's port). ``port`` 0 takes a free port. Traces go to
    ``log_dir`` (default ``brats21_torch_traces`` in the temporary
    directory). Returns the port it listens on."""
    global _server
    with _server_lock:
        if _server is None:
            log_dir = log_dir or os.path.join(tempfile.gettempdir(), "brats21_torch_traces")
            _server = _TraceServer(int(port), log_dir)
            logger.info("profiler trace server on 127.0.0.1:%d (GET /capture?ms=N writes a "
                        "trace of the next N ms into %s and answers its path)",
                        _server.server_port, log_dir)
        return _server.server_port


def maybe_enable_from_env() -> Optional[int]:
    """``BRATS21_PROFILE_PORT`` starts :func:`trace_server` on that port
    plus ``LOCAL_RANK`` (one server a process under ``torchrun``); returns
    the port, or None when the variable is unset."""
    port = os.environ.get("BRATS21_PROFILE_PORT")
    if not port:
        return None
    return trace_server(int(port) + int(os.environ.get("LOCAL_RANK", "0")))


def tune_host_allocator(mmap_threshold: int = 1 << 30,
                        trim_threshold: int = 1 << 30) -> bool:
    """Keep big freed numpy buffers on glibc's reusable heap.

    glibc serves allocations above M_MMAP_THRESHOLD (default ≤ 32 MB) with
    fresh ``mmap`` segments that are unmapped on free, so a volumetric
    pipeline that allocates and frees ~150 MB of arrays a case pays for
    hundreds of MB of first-touch page faults a case. Raising
    M_MMAP_THRESHOLD and M_TRIM_THRESHOLD makes the heap keep and reuse the
    warm pages (at the cost of RSS up to the high-water mark of live big
    buffers). Called by the CLI entry points; ``BRATS21_NO_MALLOC_TUNE=1``
    opts out. Returns whether both thresholds were set."""
    if os.environ.get("BRATS21_NO_MALLOC_TUNE"):
        return False
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        m_trim_threshold, m_mmap_threshold = -1, -3
        ok = bool(libc.mallopt(m_mmap_threshold, int(mmap_threshold)))
        ok = bool(libc.mallopt(m_trim_threshold, int(trim_threshold))) and ok
        if ok:
            logger.info("host allocator tuned: mmap/trim thresholds -> %d MB",
                        mmap_threshold >> 20)
        return ok
    except Exception as e:  # noqa: BLE001 — non-glibc platforms
        logger.info("host allocator tuning unavailable: %s", e)
        return False
