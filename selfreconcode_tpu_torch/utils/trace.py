"""The port's tracing: spans at the training step's layer boundaries, host
counters, and device counters read at the step's own readback.

    with span("step.outer"): ...     a named span (a context manager)
    count("host_syncs")              a host counter, always on
    count("solve_converged", masks)  a row of device counts, tracing on only
    enable() / disable()             tracing on / off (off at import)
    read_and_clear()                 what was recorded, cleared

A span reads the host clock at its start and end (``span.seconds``; no
synchronize) and, whatever the tracing switch says, is a
``torch.profiler.record_function`` range while a profiler runs, so a
profiler's trace names host time by the span it falls in.  With tracing
on, each span is kept until read: its name, start, end, parent span and
step (the id of its outermost span, ``train_step`` in a step).  With
tracing off and no profiler running a span stores nothing and enters no
``record_function``.

Host counters: ``host_syncs`` (each host read of the device), the kernels'
launch counts, and the CUDA graphs' (``engine/graphs.py``) of the surface
solve, ``solve_graph_captures`` (a capture, at a solve of new shapes) and
``solve_graph_replays`` (a solve that replayed a graph captured earlier),
and of the outer pass's body, ``outer_graph_captures`` (a capture, at a
step function's first step and at new shapes or storage) and
``outer_graph_replays`` (a step that replayed a graph captured earlier).

A device counter is a row of sums of device tensors, kept on the device and
copied to the host by the training step's readback (``tolist``), so tracing
adds no synchronize; a row still unread is copied by ``read_and_clear``.

Spans are opened and closed on one thread (the training loop's); counters
may be added from autograd's thread while that thread waits in backward.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch


class _Recorder:
    def __init__(self):
        self.on = False
        self.spans: List[dict] = []
        self.open: List[tuple] = []      # (id, step) of each open span
        self.next_id = 0
        self.counters: Dict[str, int] = {}
        self.pending: List[tuple] = []   # (name, device row) not yet read
        self.device: Dict[str, List[list]] = {}


_R = _Recorder()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class span:
    """A named span of host time; see the module's docstring."""
    __slots__ = ("name", "start", "end", "_rf", "_id")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = None
        self._rf = self._id = None

    def __enter__(self):
        if _profiling():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        if _R.on:
            self._id = _R.next_id
            _R.next_id += 1
            _R.open.append((self._id, _R.open[0][1] if _R.open
                            else self._id))
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._id is not None:
            _, step = _R.open.pop()       # spans close innermost first
            _R.spans.append({"name": self.name, "id": self._id,
                             "parent": _R.open[-1][0] if _R.open else None,
                             "step": step, "start": self.start,
                             "end": self.end})
            self._id = None
        return False

    @property
    def seconds(self) -> float:
        """The span's host seconds, from its start to its end."""
        return self.end - self.start


def count(name: str, n=1):
    """Add n to the host counter `name`.  Where n is a sequence of device
    tensors, record instead a device counter: the row of their sums, kept
    only while tracing is on."""
    if isinstance(n, int):
        _R.counters[name] = _R.counters.get(name, 0) + n
    elif _R.on:
        _R.pending.append((name, torch.stack([t.sum() for t in n])))


def enable():
    _R.on = True


def disable():
    _R.on = False


def tolist(t: torch.Tensor) -> list:
    """t.tolist() of a 1-D tensor, with the device counters not yet read
    copied to the host in the same transfer."""
    if not _R.pending:
        return t.tolist()
    rows = [r for _, r in _R.pending]
    flat = torch.cat([t] + [r.to(t.dtype) for r in rows]).tolist()
    out, k = flat[:t.shape[0]], t.shape[0]
    for (name, _), r in zip(_R.pending, rows):
        _R.device.setdefault(name, []).append(
            [int(v) for v in flat[k:k + r.shape[0]]])
        k += r.shape[0]
    _R.pending.clear()
    return out


def read_and_clear() -> dict:
    """What was recorded since the last call, which is then cleared:
    {"spans": [{name, id, parent, step, start, end, self}], "counters":
    {name: n}, "device": {name: [row, ...]}}.  Times are host seconds
    (``time.perf_counter``); a span's self time is its duration less its
    children's read with it, so read between steps.  Spans still open stay
    open and are read later."""
    if _R.pending:
        tolist(torch.zeros(0, device=_R.pending[0][1].device))
    child: Dict[int, float] = {}
    for s in _R.spans:
        if s["parent"] is not None:
            child[s["parent"]] = (child.get(s["parent"], 0.0) + s["end"]
                                  - s["start"])
    spans = [{**s, "self": s["end"] - s["start"] - child.get(s["id"], 0.0)}
             for s in _R.spans]
    out = {"spans": spans, "counters": dict(_R.counters),
           "device": _R.device}
    _R.spans, _R.counters, _R.device = [], {}, {}
    return out
