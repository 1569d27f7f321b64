"""Tracing (counterpart of psnerf_tpu/utils/profiling.py): the program's
spans and counters, and a torch.profiler trace that writes them beside its
Chrome trace.

    with profiling.trace("out/trace"):
        runner.train(100)

writes `out/trace/trace_<pid>_<ns>.json` (the Chrome/Perfetto trace, host
and device) and appends `out/trace/spans_<pid>.jsonl`: one line per span
({name, id, cause, root, start_ns, end_ns, thread}), then one line
{"counters": {...}}. That is how an operator reads where a step, a view or
an export call spends its time.

A span (`with profiling.span("stage1.forward") as sp:`) times a region of
the program; `sp.seconds` always holds its length, so callers read their
legs from it. Spans nest per thread: each records the span that caused it
(the enclosing one, or the `cause` given for work handed to another
thread) and the root of its request (one per training step, rendered view
or export call). `profiling.count(name, n)` adds to a named counter.

Tracing is on inside `trace()` and whenever a torch.profiler session is
active (as in the benchmark's traced window). Only then does a span open
`torch.profiler.record_function` (so it shows in the profiler's trace on
the device trace's timeline), get recorded, and a counter add. Off, a span
costs a flag test and two clock reads, and no span ever synchronises the
device. Spans and counters belong to the newest tracing session: one
starts when `trace()` is entered, or when a span or count finds the
profiler on after it last found it off. `spans()` and `counters()` return
that session's records. Start and end times are `time.time_ns()`, the
Unix-epoch clock in which the profiler reports its host events and its
device events, so each device idle gap can be put down to the span the
host was in.

The JAX package's `enable_compilation_cache` (XLA's persistent program
cache) has no counterpart: the port compiles nothing per program, and its
kernels are built once into their build directories
(psnerf_torch/ops/_build, psnerf_torch/mesh/_build), which later processes
reuse.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# records a session keeps; past it a span is dropped and counted
MAX_SPANS = 1 << 20


class _Session:
    def __init__(self):
        self.spans = []
        self.counters = {}
        self.lock = threading.Lock()


_session = _Session()
_last_on = False
_new_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _new_session() -> None:
    global _session, _last_on
    _session = _Session()
    _last_on = True


def _tracing() -> bool:
    """Whether tracing is on; starts a session when it has just come on.
    The Python flag costs a fraction of torch's C query."""
    global _last_on
    if not _autograd_profiler._is_profiler_enabled:
        _last_on = False
        return False
    if not _last_on:
        with _new_lock:
            if not _last_on:
                _new_session()
    return True


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """A timed region, as a context manager yielding itself: its name, its
    id, the id of the span that caused it and of its root, and its start
    and end (time.time_ns()); ids are set only while tracing is on. cause:
    the span that handed this work over, for work run on another thread;
    default the innermost span open on this thread."""

    __slots__ = ("name", "id", "cause", "root", "start_ns", "end_ns",
                 "thread", "_given", "_rf", "_session")

    def __init__(self, name: str, cause: "Span | None" = None):
        self.name = name
        self._given = cause
        self._rf = None
        self.id = self.cause = self.root = None
        self.start_ns = self.end_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        global _last_on
        if not _autograd_profiler._is_profiler_enabled:
            _last_on = False
            self.start_ns = time.time_ns()
        elif _tracing():
            stack = _stack()
            parent = self._given or (stack[-1] if stack else None)
            self.id = next(_ids)
            self.cause = None if parent is None else parent.id
            self.root = self.id if parent is None or parent.root is None \
                else parent.root
            self.thread = threading.get_ident()
            self._session = _session
            stack.append(self)
            self.start_ns = time.time_ns()
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf = self._rf
        if rf is None:
            self.end_ns = time.time_ns()
            return False
        rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        self._rf = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        s = self._session
        with s.lock:
            if len(s.spans) < MAX_SPANS:
                s.spans.append(self)
            else:
                s.counters["spans_dropped"] = \
                    s.counters.get("spans_dropped", 0) + 1
        return False

    def record(self) -> dict:
        return {"name": self.name, "id": self.id, "cause": self.cause,
                "root": self.root, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "thread": self.thread}


span = Span


def spanned(name: str):
    """Decorator: run the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def current() -> Span | None:
    """The innermost span open on this thread while tracing, else None:
    the cause to hand to work submitted to another thread."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing is on."""
    if _tracing():
        s = _session
        with s.lock:
            s.counters[name] = s.counters.get(name, 0) + n


def to_host(x: torch.Tensor):
    """x as a host numpy array, counting its bytes as d2h_bytes (the
    program's device-to-host read-backs)."""
    count("d2h_bytes", x.nbytes)
    return x.cpu().numpy()


def spans() -> list:
    """The newest session's closed spans, in the order they ended."""
    s = _session
    with s.lock:
        return list(s.spans)


def counters() -> dict:
    """The newest session's counters."""
    s = _session
    with s.lock:
        return dict(s.counters)


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the block with torch.profiler (CPU activities, and CUDA ones
    when a card is present) in a new tracing session; write its Chrome
    trace as `logdir/trace_<pid>_<ns>.json` and append its spans and
    counters to `logdir/spans_<pid>.jsonl`. A no-op when logdir is None:

        with profiling.trace("out/trace") as prof:
            step(...)
    """
    if logdir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with _new_lock:
            _new_session()
        yield prof
    pid = os.getpid()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{pid}_{time.time_ns()}.json"))
    with open(os.path.join(logdir, f"spans_{pid}.jsonl"), "a") as f:
        for sp in spans():
            f.write(json.dumps(sp.record()) + "\n")
        f.write(json.dumps({"counters": counters()}) + "\n")
