"""Spans and counters at the port's layer boundaries, recorded while a
``torch.profiler`` session records (the JAX package has no counterpart).

``span(name)`` wraps one call into a layer: the frame function
(``evaluate.make_r2l_frame_fn``: ``frame`` and its ``frame.*`` children),
a kernel's launch wrapper (``kernel.launch``) and the pseudo-data loop
(``datagen.generate_pseudo_data``: ``datagen.*``). While tracing is on, a
span keeps one record in memory (its name, the unit it belongs to, its
parent, its thread, its start and end on ``time.perf_counter_ns``) and is
also a ``torch.profiler.record_function`` range named ``r2l.<name>``, so it
sits on the profiler's timeline, on the profiler's clock. ``count(name,
n)`` adds to a counter of the innermost open span; ``unit(id)`` names the
unit (a frame's index, a pose batch's first pose) that the spans opened
next on this thread belong to. ``records()`` and ``counters()`` hand over
what was kept and clear it.

Tracing is on exactly while a profiler session records
(``torch.autograd.profiler._is_profiler_enabled``): the CLI's
``--profile_dir`` run and the benchmark's traced slice. Off, ``span``
reads that one attribute and returns a shared null context: no range, no
clock read, no allocation. A span records only if a session was recording
when it opened. The profiler records ranges on the thread that began its
session: a span of another thread (the pseudo-data writer's) is kept in
memory only.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
import warnings
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "r2l."
MAX_RECORDS = 1 << 16   # records kept between two reads; the rest counted
# the caching allocator's counts that stand for a host-device sync
_SYNC_STATS = ("num_device_alloc", "num_device_free", "num_sync_all_streams")


class Span(NamedTuple):
    name: str
    unit: object            # the frame's index, the batch's first pose
    parent: str | None      # the innermost span open on its thread
    thread: int
    start_ns: int           # time.perf_counter_ns()
    end_ns: int


class _Store:
    """What the spans and counters kept since the last read."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: list[Span] = []
        self.counters: dict[tuple[str | None, str], int] = {}
        self.dropped = 0

    def add(self, rec: Span) -> None:
        with self.lock:
            if len(self.records) < MAX_RECORDS:
                self.records.append(rec)
            else:
                self.dropped += 1

    def count(self, key: tuple[str | None, str], n: int) -> None:
        with self.lock:
            self.counters[key] = self.counters.get(key, 0) + n


_STORE = _Store()
_NULL = contextlib.nullcontext()
_local = threading.local()     # .open: the names of the open spans; .unit


def _open() -> list[str]:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


def unit(uid) -> None:
    """The unit of the spans opened next on this thread."""
    _local.unit = uid


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (None
    outside every span) while tracing is on."""
    if _profiler._is_profiler_enabled:
        stack = _open()
        _STORE.count((stack[-1] if stack else None, name), int(n))


class _SyncWatch:
    """Host-device synchronisations over a span, counted as ``sync``: the
    synchronising operations torch flags (``set_sync_debug_mode``, its
    warnings caught and counted, not shown) and the caching allocator's
    device allocations, frees and all-stream syncs. Other warnings caught
    over the span are shown at its end."""

    def __init__(self, device: torch.device):
        self.device = device

    def start(self) -> None:
        self.mode = torch.cuda.get_sync_debug_mode()
        self.caught = warnings.catch_warnings(record=True)
        self.seen = self.caught.__enter__()
        warnings.simplefilter("always")
        self.stats = self._stats()
        torch.cuda.set_sync_debug_mode("warn")

    def stop(self) -> int:
        torch.cuda.set_sync_debug_mode(self.mode)
        after = self._stats()
        self.caught.__exit__(None, None, None)
        flagged = 0
        for w in self.seen:
            if "synchronizing" in str(w.message):
                flagged += 1
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        return flagged + sum(after[k] - self.stats[k] for k in after)

    def _stats(self) -> dict:
        s = torch.cuda.memory_stats_as_nested_dict(self.device)
        return {k: s.get(k, 0) for k in _SYNC_STATS}


class _Span:
    __slots__ = ("name", "watch", "parent", "unit", "range", "t0")

    def __init__(self, name: str, watch: _SyncWatch | None):
        self.name, self.watch = name, watch

    def __enter__(self):
        stack = _open()
        self.parent = stack[-1] if stack else None
        self.unit = getattr(_local, "unit", None)
        stack.append(self.name)
        if self.watch is not None:
            self.watch.start()
        # the profiler stamps a range at the end of its enter and of its
        # exit: the clock read after each keeps a record on its range
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        if self.watch is not None:
            count("sync", self.watch.stop())
        _open().pop()
        _STORE.add(Span(self.name, self.unit, self.parent,
                        threading.get_ident(), self.t0, t1))
        return False


def span(name: str, syncs: torch.device | None = None):
    """A context that records the span ``name`` while tracing is on, else
    a shared null context. ``syncs``: a CUDA device whose host-device
    synchronisations inside the span are counted as its ``sync`` counter
    (read before the span's start and after its end, outside its time)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    watch = (_SyncWatch(syncs) if syncs is not None and syncs.type == "cuda"
             else None)
    return _Span(name, watch)


def spanned(name: str):
    """A decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def records() -> list[Span]:
    """The spans recorded since the last call, in the order they closed;
    the store is cleared."""
    with _STORE.lock:
        out, _STORE.records = _STORE.records, []
    return out


def counters() -> dict[tuple[str | None, str], int]:
    """{(span name, counter name): total} since the last call, with
    ``(None, "dropped_spans")`` where the store was full; cleared."""
    with _STORE.lock:
        out, _STORE.counters = _STORE.counters, {}
        if _STORE.dropped:
            out[(None, "dropped_spans")] = _STORE.dropped
            _STORE.dropped = 0
    return out
