"""Device profiling helpers, and the spans and counters of the hot paths.

Port of ``monoforce_tpu/utils/profiling.py``.  The reference's
observability is wall-clock prints (``@timing``, utils.py:32-40).  Here
``trace`` captures a ``torch.profiler`` trace of the host and the card
(CPU and CUDA activities) and writes it to ``log_dir`` as a Chrome trace,
viewable in Perfetto or ``chrome://tracing``; ``measure`` times a call with
CUDA events on the card, or on the host clock after a synchronise.

The program marks its layers with ``span(name)`` and counts work with
``count(name, n)``: the tick (``MonoForce.run``), the train step
(``make_train_step``) and the serving rollout (``planner_rollout``), at
layer boundaries only, never inside a per-step loop.  Both are off unless
a ``recording()`` block is open: then each span keeps its host start and
end, its parent and its request (the top-level span it lies in: one tick,
one train step, one rollout call), and, while a ``torch.profiler`` runs,
opens a range named ``mf.<name>``, so that the trace shows the spans on
the clock of the card's kernels.  No span or counter waits for the device.
``trace`` records while it profiles.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional

import torch

from monoforce_tpu_torch.utils.timing import _tensors, synchronize

__all__ = ["trace", "measure", "span", "count", "recording", "Recorder",
           "Span", "host_ms", "outputs_of", "staged_backward",
           "register_launches"]

# (name, object) of each kernel wrapper whose ``.launches`` a request's
# counters report; the wrappers register themselves
_counted: List[tuple] = []


def register_launches(name: str, wrapper) -> None:
    """Report the change of ``wrapper.launches`` (an int the wrapper keeps)
    in each recorded request's counters, as ``launches.<name>``."""
    _counted.append((name, wrapper))


class Span(NamedTuple):
    """One closed span: ``request`` is the id of the top-level span it lies
    in (its own id for a top-level span), ``parent`` that of the span it
    opened in (None at the top); times are ``time.perf_counter_ns``."""
    name: str
    id: int
    parent: Optional[int]
    request: int
    start_ns: int
    end_ns: int


class _Open:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "range")

    def __init__(self, name, sid, parent, request, rng):
        self.name, self.id, self.parent = name, sid, parent
        self.request, self.range = request, rng
        self.start_ns = time.perf_counter_ns()


class Recorder:
    """The spans and counters of one ``recording()`` block, kept on the
    host until ``take()`` drains them.

    Spans nest by time, across the threads of one issuing sequence (the
    autograd engine's device thread runs the backward while the caller
    waits): one sequence records at a time."""

    def __init__(self):
        self._open: List[_Open] = []
        self._spans: List[Span] = []
        self._counters: Dict[Optional[int], Dict[str, int]] = {}
        self._launches0: Dict[str, int] = {}
        self._next = 0

    def _launches(self) -> Dict[str, int]:
        return {n: v.launches for n, v in _counted}

    def open(self, name: str) -> _Open:
        """Open span ``name`` inside the innermost open one; close it with
        :meth:`close` on the thread that opened it."""
        parent = self._open[-1] if self._open else None
        sid, self._next = self._next, self._next + 1
        if parent is None:
            self._launches0 = self._launches()
        rng = None
        # a range costs ~10 us even with no profiler to see it
        if torch.autograd._profiler_enabled():
            rng = torch.autograd.profiler.record_function("mf." + name)
            rng.__enter__()
        entry = _Open(name, sid, parent.id if parent else None,
                      parent.request if parent else sid, rng)
        self._open.append(entry)
        return entry

    def close(self, entry: _Open) -> None:
        end = time.perf_counter_ns()
        if entry.range is not None:
            entry.range.__exit__(None, None, None)
        self._open.remove(entry)
        self._spans.append(Span(entry.name, entry.id, entry.parent,
                                entry.request, entry.start_ns, end))
        if entry.parent is None:
            now = self._launches()
            for n, k in now.items():
                if k != self._launches0.get(n, k):
                    self.count("launches." + n, k - self._launches0[n],
                               entry.request)

    def count(self, name: str, n: int = 1,
              request: Optional[int] = None) -> None:
        """Add ``n`` to counter ``name`` of the open request (of
        ``request`` where given; None outside any span)."""
        if request is None and self._open:
            request = self._open[-1].request
        c = self._counters.setdefault(request, {})
        c[name] = c.get(name, 0) + n

    def take(self) -> dict:
        """Drain what was recorded: ``{"spans": [Span, ...] by start,
        "counters": {request: {name: n}}}``, each request's counters with
        the change of every kernel wrapper's ``.launches`` under
        ``launches.<wrapper>``."""
        spans = sorted(self._spans, key=lambda s: (s.start_ns, s.id))
        out = {"spans": spans, "counters": self._counters}
        self._spans, self._counters = [], {}
        return out


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _SpanContext:
    __slots__ = ("rec", "name", "entry")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name, self.entry = rec, name, None

    def __enter__(self):
        self.entry = self.rec.open(self.name)
        return self.entry

    def __exit__(self, *exc):
        self.rec.close(self.entry)
        return False


_NOOP = _Noop()
# the open recording() block's recorder; None: spans and counters are off
_active: Optional[Recorder] = None


def span(name: str):
    """``with span("rollout"): ...``: a span of the layer, recorded inside
    a ``recording()`` block; otherwise one shared context that does
    nothing."""
    rec = _active
    if rec is None:
        return _NOOP
    return _SpanContext(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the open request, inside a
    ``recording()`` block; otherwise nothing."""
    rec = _active
    if rec is not None:
        rec.count(name, n)


@contextmanager
def recording():
    """``with recording() as r: ...; r.take()``: spans and counters on for
    the block.  Inside another block it yields that block's recorder."""
    global _active
    if _active is not None:
        yield _active
        return
    rec = _active = Recorder()
    try:
        yield rec
    finally:
        _active = None


def host_ms(taken: dict) -> Dict[str, float]:
    """Host milliseconds by span name, summed over ``take()``'s spans."""
    out: Dict[str, float] = {}
    for s in taken["spans"]:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return out


@contextmanager
def outputs_of(module: torch.nn.Module):
    """Inside a ``recording()`` block, the tensors that ``module``'s
    forward returns within the ``with`` block (a dict's values, a tuple's
    items) are appended to the yielded list: the boundary of a
    :func:`staged_backward`.  Outside, the list stays empty."""
    out: List[torch.Tensor] = []
    if _active is None:
        yield out
        return
    handle = module.register_forward_hook(
        lambda _module, _args, result: out.extend(_tensors(result)))
    try:
        yield out
    finally:
        handle.remove()


def staged_backward(loss, boundary, first: str, second: str) -> None:
    """``loss.backward()``, recorded as span ``first`` until the gradient
    first reaches one of the ``boundary`` tensors, then span ``second``
    to the backward's end.  The autograd engine runs the backward's nodes
    on its own thread where the graph is on the card: tensor hooks and the
    engine's final callback open and close the two spans there.  Outside a
    ``recording()`` block: a plain ``loss.backward()``."""
    rec = _active
    if rec is None:
        loss.backward()
        return
    stage: List[_Open] = []

    def enter(name):
        end()
        stage.append(rec.open(name))

    def end():
        if stage:
            rec.close(stage.pop())

    def begin(_):
        enter(first)
        torch.autograd.Variable._execution_engine.queue_callback(end)

    def reach(_):
        if stage and stage[-1].name == first:
            enter(second)

    hooks = [loss.register_hook(begin)] + [
        t.register_hook(reach) for t in boundary if t.requires_grad]
    try:
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
        end()


@contextmanager
def trace(log_dir: str = "runs/profile"):
    """Capture a trace: ``with trace('runs/profile') as prof: step()``.

    Yields the ``torch.profiler.profile`` object (``key_averages()`` sums
    the kernels by name); on leaving, the trace is written to
    ``<log_dir>/trace.json``.  The CUDA activity is traced where a card is
    visible.  Spans are recorded meanwhile: the trace shows the program's
    ``mf.*`` ranges over the kernels they launched."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, recording():
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_cuda(out) -> bool:
    return any(t.device.type == "cuda" for t in _tensors(out))


def measure(fn, *args, reps: int = 5, warmup: int = 1, transfer=False):
    """Best-of-``reps`` latency of ``fn(*args)`` in milliseconds.

    When the result holds CUDA tensors, each rep is timed between CUDA
    events recorded on the current stream (the device's time, host time
    inside the call included); otherwise on the host clock after
    synchronising the result's devices.  With ``transfer`` the result is
    copied to the host each rep, inside the timed region.
    """
    for _ in range(max(warmup, 1)):
        out = fn(*args)
        synchronize(out)
    cuda = _on_cuda(out)
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            if transfer:
                _to_host(out)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            if transfer:
                _to_host(out)
            synchronize(out)
            times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def _to_host(out):
    return [t.cpu() for t in _tensors(out)]
