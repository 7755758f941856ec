"""Spans and counters of the port's prove, on the profiler's clock.

`span(name)` marks one stretch of host work at a layer boundary of a prove
(15 a request, 10 where the prove replays its recorded graph; a new Prover
adds `prover.new` and a `prover.keep` for each thing it keeps; none per
kernel launch):

- with no profiler recording it takes two `time.time_ns()` stamps and
  keeps nothing (`seconds` reads its duration);
- while torch's profiler records it also opens a profiler range of the
  same name (as `record_function` does), so the range lands on the
  profiler's timeline, and appends one `Span` to a bounded buffer that
  `recorded()` returns: its name, start and end (Unix ns, the clock of
  the profiler's host events), its id, its parent's id, its request's id
  and the change over it of `kernels.launch_counts` and `counters` (only
  the keys that moved).

A span with no recording span open is a root and opens a new request id:
`stark.prove` and `stark.serialize` on the main path.

`counters["syncs"]` is always on: +1 at each call of the prove and
serialize paths that makes the host wait for the card, each fetch to the
host (`fetch`) and each upload from pageable memory (`upload`).  A CPU
tensor takes the same calls and counts the same, so a CPU run counts what
the card would wait for.

`counters["upload_bytes"]` is always on: the bytes of each host-to-device
copy of the prove and serialize paths, added by `DeviceField.from_numpy`
(the int32 limbs it copies) and by `upload` (the tensor made), on a CPU
tensor as on the card.  A warm prove adds its trace and its input
registers' values.

`counters["trace_products"]` is always on: the Montgomery products of each
native trace, added inside its `air.trace` span (`init + step * (T - 1)`,
counted per schema at codegen by native/tracegen.py; the Python fallback
adds nothing).  It costs one integer add a trace.

`counters["graph_replays"]` is always on: +1 at each replay of a Prover's
recorded CUDA graph (protocol/prover.py `Prover.prove`, inside its
`prove.replay` span).  A replayed prove launches its kernels without their
wrappers, so it adds nothing to `kernels.launch_counts`.
"""

from __future__ import annotations

import collections
import itertools
import time

import torch
import torch.autograd.profiler as _profiler

from . import kernels

MAX_RECORDS = 1 << 16

counters = {"syncs": 0, "trace_products": 0, "upload_bytes": 0, "graph_replays": 0}

Span = collections.namedtuple("Span", "name start_ns end_ns span parent request deltas")

# The profiler's range: torch's C++ context manager where this torch has it
# (its edges within a few us of the span's; record_function's Python
# wrapper adds tens of us on either side).
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", _profiler.record_function)

_records = collections.deque(maxlen=MAX_RECORDS)
_open = []                       # (span id, request id) of the recording spans, innermost last
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


def _counts() -> dict:
    return dict(kernels.launch_counts, **counters)


class span:
    """`with span(name) as s:` ... `s.seconds`."""

    __slots__ = ("name", "start_ns", "end_ns", "_range", "_id", "_parent", "_request",
                 "_before")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
            self.start_ns = time.time_ns()
            self._parent, self._request = _open[-1] if _open else (None, next(_request_ids))
            self._id = next(_span_ids)
            _open.append((self._id, self._request))
            self._before = _counts()
        else:
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is None:
            self.end_ns = time.time_ns()
            return False
        # the bookkeeping first, so that a collection it sets off falls
        # inside both the span and the profiler's range
        after = _counts()
        deltas = {k: v - self._before[k] for k, v in after.items() if v != self._before[k]}
        _open.pop()
        self.end_ns = time.time_ns()
        self._range.__exit__(None, None, None)
        _records.append(Span(self.name, self.start_ns, self.end_ns, self._id, self._parent,
                             self._request, deltas))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def recorded() -> list:
    """Every kept `Span`, oldest first (at most MAX_RECORDS)."""
    return list(_records)


def clear() -> None:
    _records.clear()


def fetch(t: torch.Tensor) -> torch.Tensor:
    """t on the host: the host waits for the card (one sync)."""
    counters["syncs"] += 1
    return t.cpu()


def upload(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A list or an array from pageable memory on `device`: torch copies it
    and waits for the copy (one sync)."""
    counters["syncs"] += 1
    t = torch.as_tensor(values, dtype=dtype, device=device)
    counters["upload_bytes"] += t.nbytes
    return t
