"""Named host spans of the serving loop, on the profiler's clock.

``with span("serve.sample"):`` times its block by ``time.perf_counter_ns``
and adds the count (1, or ``n``) and the seconds to the process-wide sum
of its name, always.  While a ``torch.profiler`` records, the block is
also a range of that name in the profiler's timeline, with the span's
keyword arguments (request ids, a width) as the range's arguments (they
show where the profiler records shapes); nesting gives each range its
parent.  The ranges share the profiler's clock with the device trace, so
a device idle gap can be named by the span the host was in.

A span inside which a profiler started or stopped holds the profiler's
start-up or tear-down (seconds, where the span's own work takes
microseconds).  It counts in its name's sums as any other, and also in
those of ``<name>.profiler``, so that a reader of the program's own time
can take it back out.

A range is opened only where the profiler records
(``torch.autograd._profiler_enabled``): ``record_function`` costs some
10 us even with no profiler.  On the host of an H100 machine (torch
2.11) a span costs about 1.3 us with no profiler and 3.3 us while one
records.  The scheduler's span names and what each covers are listed
in ``launch/scheduler.py``.
"""
from __future__ import annotations

import time

import torch

__all__ = ["span", "sums", "since", "reset", "PROFILER"]

#: the suffix of the sums of spans inside which a profiler started or
#: stopped
PROFILER = ".profiler"

#: name -> [count, nanoseconds] over every span of the process so far
_SUMS: dict[str, list[int]] = {}

_recording = torch.autograd._profiler_enabled
#: a profiler range with keyword arguments (the one torch's own compiler
#: opens around its kernels), at about a tenth of ``record_function``'s
#: cost
_Range = torch._C._profiler._RecordFunctionFast


class span:
    """One timed block: ``name``, the count it adds (``n``, default 1)
    and, as the profiler range's arguments, ``arg`` (ints, floats, bools
    or strings: the profiler skips other values)."""

    __slots__ = ("name", "n", "arg", "rng", "t0")

    def __init__(self, name: str, n: int = 1, **arg):
        self.name, self.n, self.arg = name, n, arg

    def __enter__(self) -> "span":
        self.rng = None
        if _recording():
            self.rng = _Range(self.name, [], self.arg)
            self.rng.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self.t0
        _add(self.name, self.n, dt)
        if (self.rng is None) == _recording():
            _add(self.name + PROFILER, 1, dt)
        if self.rng is not None:
            self.rng.__exit__(*exc)
        return False


def _add(name: str, n: int, ns: int) -> None:
    s = _SUMS.get(name)
    if s is None:
        s = _SUMS[name] = [0, 0]
    s[0] += n
    s[1] += ns


def sums() -> dict[str, tuple[int, float]]:
    """name -> (count, seconds) of every span in the process so far."""
    return {k: (c, ns / 1e9) for k, (c, ns) in _SUMS.items()}


def since(before: dict[str, tuple[int, float]]
          ) -> dict[str, tuple[int, float]]:
    """The sums added since ``before`` (an earlier :func:`sums`), of the
    names that ran since."""
    out = {}
    for k, (c, s) in sums().items():
        c0, s0 = before.get(k, (0, 0.0))
        if c > c0:
            out[k] = (c - c0, s - s0)
    return out


def reset() -> None:
    """Forget every sum (for tests)."""
    _SUMS.clear()
