"""The port's tracer: counters, spans and the replayed frame's device time
by stage, on the clock ``torch.profiler`` traces with.

``TRACER`` is the process's one tracer, as the profiler whose trace it
writes into is the process's one profiler.  Three parts:

* **Counters** (``count``, ``wait``): plain ints by name, always on.  Each
  name is counted from one thread at a time in the program (the frame
  thread's ``vins::``, ``pairer::`` and ``wait::`` names, the loop worker's
  ``loop::`` names); a lock keeps the sums whole anyway.
* **Spans** (``span``, ``frame``, ``wait``).  With tracing on (``enable``)
  a span records (id, parent id, name, frame id, start, end, thread) with
  ``time.perf_counter_ns`` into a buffer of ``CAPACITY`` records (those
  past it are dropped and counted in ``dropped``) and opens a
  ``torch.profiler.record_function`` range of its own name, so any
  profiler trace holds the program's spans beside its kernels.  A frame's
  root span (``frame``) draws the frame id that the spans opened inside it
  on its thread carry; work done for a frame on another thread names it
  (``span(name, frame=...)``, the id ``current_frame`` gave the frame
  thread).  With tracing off (the default) a span is one attribute check
  that returns a shared null context: nothing is recorded and no range is
  opened.
* **Stage marks** (``marking``, ``mark``): the device time of the frame
  program's step (``parallel/batched_pipeline._FrameProgram``) by stage,
  ``STAGES``.  With tracing on the step arms the marks; each launches a
  one-thread kernel (``csrc/stage_mark.cu``) that reads the card's
  nanosecond clock and adds the time since the previous mark to its
  stage's sum and count in a buffer of the card's, so the step's CUDA
  graph captures them and every replay adds to the sums.  On the CPU a
  mark takes a host stamp instead and records the stage as a span
  (``stage::<name>``), so the order is testable there.  A graph captured
  with tracing off holds no marks.  The step being marked is the calling
  thread's; the marks assume one marked step runs on a card at a time.
  ``stage_sums`` reads the cards' buffers: call it after a
  synchronisation the caller makes anyway.

``snapshot`` and ``delta`` give what a window added: the spans reduced to
per-name totals over the records made since the snapshot, and the
counters and stage sums as differences.  ``export`` writes the records,
counters and stage sums as JSON; ``load`` reads them back.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Dict, Optional

import torch

from .. import native

STAGES = ("track", "init", "solve", "marg", "tail")
CAPACITY = 1 << 17  # span records kept; the ones past it are counted in ``dropped``
FIELDS = ("id", "parent", "name", "frame", "t0_ns", "t1_ns", "thread")

_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("tr", "name", "frame", "id", "parent", "t0", "range")

    def __init__(self, tr: "Tracer", name: str, frame: Optional[int]):
        self.tr, self.name, self.frame = tr, name, frame

    def __enter__(self):
        stack = self.tr._stack()
        self.parent, inherited = stack[-1] if stack else (-1, None)
        if self.frame is None:
            self.frame = inherited
        self.id = next(self.tr._ids)
        stack.append((self.id, self.frame))
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.range.__exit__(*exc)
        self.tr._stack().pop()
        self.tr._add((self.id, self.parent, self.name, self.frame, self.t0, t1,
                      threading.get_ident()))
        return False


class Tracer:
    """Counters always; spans and stage marks while ``on`` (see the module
    docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.capacity = capacity
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count()
        self._frames = itertools.count()
        self._mark_bufs: Dict[torch.device, torch.Tensor] = {}  # kept for the graphs that hold them
        self._host_marks = [0] * (2 * len(STAGES))  # the CPU's [sums, counts]
        self.reset()

    # -- the switch ------------------------------------------------------
    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def reset(self) -> None:
        """Forget every record, counter and stage sum (the cards' buffers
        are zeroed in place: a captured graph keeps its pointer to them)."""
        with self._lock:
            self.records: list = []
            self.dropped = 0
            self.counters: Dict[str, int] = {}
        self._host_marks[:] = [0] * len(self._host_marks)
        for buf in self._mark_bufs.values():
            buf.zero_()

    # -- counters ----------------------------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- spans -------------------------------------------------------------
    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _add(self, rec: tuple) -> None:
        if len(self.records) < self.capacity:
            self.records.append(rec)
        else:
            with self._lock:
                self.dropped += 1

    def span(self, name: str, frame: Optional[int] = None):
        """A span of ``name`` (a context manager); its frame id is
        ``frame``, else that of the span it opens inside."""
        if not self.on:
            return _NULL
        return _Span(self, name, frame)

    def frame(self, name: str):
        """A frame's (or a call's) root span, with a frame id of its own."""
        if not self.on:
            return _NULL
        return _Span(self, name, next(self._frames))

    def wait(self, name: str):
        """A place the calling thread blocks on the device: counted always,
        a span while tracing."""
        self.count(name)
        return self.span(name)

    def current_frame(self) -> Optional[int]:
        """The frame id of the innermost open span on this thread (None
        with tracing off or outside any frame)."""
        if not self.on:
            return None
        s = self._stack()
        return s[-1][1] if s else None

    # -- stage marks ---------------------------------------------------------
    @contextlib.contextmanager
    def marking(self, device: torch.device):
        """Around a frame program's step: with tracing on, the first mark
        at entry and the ``tail`` stage's at exit; ``mark`` ends the other
        stages inside."""
        if not self.on:
            yield
            return
        self._tls.mark_dev = torch.device(device)
        try:
            self.mark(None)
            yield
            self.mark(STAGES[-1])
        finally:
            self._tls.mark_dev = None

    def mark(self, stage: Optional[str]) -> None:
        """End ``stage`` (None: start the first) inside a step this thread
        armed; nothing elsewhere."""
        tls = self._tls
        dev = getattr(tls, "mark_dev", None)
        if dev is None:
            return
        i = -1 if stage is None else STAGES.index(stage)
        if dev.type == "cuda":
            buf = self._mark_buf(dev)
            native.launch("stage_mark_launch", dev, buf.data_ptr(), i)
            return
        now = time.perf_counter_ns()
        if i >= 0:
            with self._lock:
                self._host_marks[i] += now - tls.last_mark
                self._host_marks[len(STAGES) + i] += 1
            s = self._stack()
            self._add((next(self._ids), s[-1][0] if s else -1, "stage::" + stage,
                       s[-1][1] if s else None, tls.last_mark, now, threading.get_ident()))
        tls.last_mark = now

    def _mark_buf(self, dev: torch.device) -> torch.Tensor:
        buf = self._mark_bufs.get(dev)
        if buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the stage marks' buffer is made before a capture: "
                                   "run the step once eagerly first")
            buf = self._mark_bufs[dev] = torch.zeros(1 + 2 * len(STAGES), dtype=torch.int64,
                                                     device=dev)
        return buf

    def stage_sums(self) -> Dict[str, list]:
        """Stage -> [seconds, marks] over every card's buffer and the CPU's
        stamps (reads the cards: call after a synchronisation)."""
        n = len(STAGES)
        tot = list(self._host_marks)
        for buf in list(self._mark_bufs.values()):
            tot = [a + int(b) for a, b in zip(tot, buf[1:].tolist())]
        return {s: [1e-9 * tot[i], tot[n + i]] for i, s in enumerate(STAGES)}

    # -- windows and export ----------------------------------------------------
    def snapshot(self) -> dict:
        """Where a window starts (reads the cards' stage sums)."""
        return dict(n=len(self.records), counters=dict(self.counters),
                    stages=self.stage_sums(), dropped=self.dropped)

    def delta(self, since: Optional[dict] = None) -> dict:
        """What was traced after ``since`` (a ``snapshot``; None: since the
        last ``reset``): ``spans`` name -> [seconds, count, seconds of its
        direct children], ``counters`` and ``stages`` as differences,
        ``dropped``."""
        s0 = since or dict(n=0, counters={}, stages={}, dropped=0)
        return dict(spans=reduce_spans(self.records[s0["n"]:]),
                    counters={k: v - s0["counters"].get(k, 0) for k, v in self.counters.items()
                              if v != s0["counters"].get(k, 0)},
                    stages={k: [v[0] - s0["stages"].get(k, [0, 0])[0],
                                v[1] - s0["stages"].get(k, [0, 0])[1]]
                            for k, v in self.stage_sums().items()},
                    dropped=self.dropped - s0["dropped"])

    def export(self, path: str) -> None:
        """The records, counters and stage sums as JSON (times in
        ``perf_counter_ns``)."""
        with open(path, "w") as f:
            json.dump(dict(fields=FIELDS, records=self.records, counters=self.counters,
                           stages=self.stage_sums(), dropped=self.dropped), f)

    def report(self) -> str:
        """One line per traced span name (mean ms, count) and the counters."""
        lines = [f"{k}: {1e3 * v[0] / v[1]:.3f} ms x {v[1]}"
                 for k, v in sorted(reduce_spans(self.records).items())]
        lines += [f"{k}: {v}" for k, v in sorted(self.counters.items())]
        return "\n".join(lines)


def reduce_spans(records) -> Dict[str, list]:
    """name -> [seconds, count, seconds of its direct children]."""
    names = {r[0]: r[2] for r in records}
    out: Dict[str, list] = {}
    for r in records:
        d = 1e-9 * (r[5] - r[4])
        e = out.setdefault(r[2], [0.0, 0, 0.0])
        e[0] += d
        e[1] += 1
        if r[1] in names:
            out.setdefault(names[r[1]], [0.0, 0, 0.0])[2] += d
    return out


def load(path: str) -> dict:
    """An ``export``'s records (tuples), counters, stage sums and drops."""
    with open(path) as f:
        d = json.load(f)
    d["records"] = [tuple(r) for r in d["records"]]
    return d


TRACER = Tracer()
