"""Tracing / profiling / logging utilities (port of
psulvsb_tpu/utils/timing.py).

Equivalent of the reference's compile-time chrono + stdout macros
(teaser/include/teaser/macros.h:13-69:
TEASER_DEBUG_DECLARE/START/STOP/GET_TIMING, TEASER_DEBUG_INFO_MSG,
TEASER_INFO_MSG_THROTTLE, gated by NDEBUG/TEASER_DIAG_PRINT), rebuilt as:

- `Timer` / `timed(...)`: wall-clock spans that end with
  `torch.cuda.synchronize` on the devices of the tensors in `sync_on`
  (PyTorch returns before the card finishes, so a bare span measures the
  enqueue, not the work),
- `log` / `log_throttled`: stdlib-logging-backed equivalents of the info
  macros, enabled via PSULVSB_DIAG=1 (the TEASER_DIAG_PRINT analog). The
  logger keeps the JAX package's name, "psulvsb_tpu", so one logging
  setting serves both packages,
- the program's tracing, off unless `enable(True)` switches it on, on one
  clock: the card's `%globaltimer` (nanoseconds, shared by every SM).

Tracing. Host spans (`span(name)`) record a name, a start and an end on
`time.perf_counter_ns`, the span open around them (the parent) and a
request id that the spans of one top-level call share. Device spans are
stamps of the card's clock by a one-thread kernel (`csrc/graph_cond.cu`):
a traced plan of the fused solve keeps a `SpanRecord` whose slots its graph
opens and closes around each stage, inside the IF and WHILE bodies where no
CUDA event may go (CUPTI, which torch.profiler reads, faults the card over
those graphs); entry points stamp the card eagerly at their first and last
device operation (`device_stamp(device, "call", ...)`) and around stages of
their own. `start()` marks a window and calibrates the host clock against
the card's, `snapshot()` reads every record and calibrates again: a line
through both ends puts every span on the card's clock. On the CPU, and in a
plan without a card, a stamp reads the host clock, so the same names and
counts come out of every path. With tracing off nothing is recorded and no
stamp is captured: each span site pays a test of the switch.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import logging
import os
import statistics
import time
import weakref
from ctypes import c_char_p, c_int, c_longlong, c_void_p

import torch

from psulvsb_tpu_torch.ops._build import load_library

logger = logging.getLogger("psulvsb_tpu")
if os.environ.get("PSULVSB_DIAG", "0") == "1":
    logging.basicConfig(level=logging.INFO)
    logger.setLevel(logging.INFO)

_throttle_counts: dict[str, int] = {}


def log(msg: str) -> None:
    """TEASER_DEBUG_INFO_MSG analog (macros.h:18-28)."""
    logger.info(msg)


def log_throttled(key: str, msg: str, every: int = 10) -> None:
    """TEASER_INFO_MSG_THROTTLE analog (macros.h:42-60): logs the first of
    every `every` calls with one key."""
    c = _throttle_counts.get(key, 0)
    if c % every == 0:
        logger.info(msg)
    _throttle_counts[key] = c + 1


def _cuda_devices(tree) -> set[torch.device]:
    """The CUDA devices of the tensors in a tensor or a nest of lists,
    tuples, dicts and named tuples of them."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return set()
    devices = set()
    for leaf in tree:
        devices |= _cuda_devices(leaf)
    return devices


class Timer:
    """TEASER_DEBUG_DECLARE/START/STOP/GET_TIMING analog (macros.h:62-68),
    with device-sync semantics."""

    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed_s = 0.0
        self._t0 = None

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self, sync_on=None) -> float:
        """End the span and return the seconds accumulated so far. Each
        CUDA device that holds a tensor of `sync_on` (a tensor or a nest of
        them) is synchronised first; tensors on the host need nothing."""
        for device in _cuda_devices(sync_on):
            torch.cuda.synchronize(device)
        self.elapsed_s += time.perf_counter() - self._t0
        return self.elapsed_s

    def get_timing(self) -> float:
        return self.elapsed_s



@contextlib.contextmanager
def timed(name: str, sync_on=None):
    """Context-manager span; yields a dict that holds `elapsed_s` at exit,
    and logs it when diagnostics are enabled. `sync_on` is read at exit, so
    a caller may fill a list it passed in inside the span. With tracing on
    it is also a host span of the recorder, ending after the sync."""
    t = Timer(name).start()
    result = {}
    with span(name):
        try:
            yield result
        finally:
            result["elapsed_s"] = t.stop(sync_on=sync_on)
    log(f"[{name}] {result['elapsed_s']:.4f}s")


# -----------------------------------------------------------------------------
# Tracing: the recorder
# -----------------------------------------------------------------------------

MAX_SPANS = 1 << 20  # host spans kept in one window; later ones are counted only
CALIBRATION_TRIES = 20
# The stage slots of a plan's record, in slot order; slot 0 is the whole
# solve. The stages' names are the staged solver's `stage_s` keys under
# "solve."; a name with one more part is a span inside its stage (the scale
# peak in the init, the scale estimate in a local batch: plans that estimate
# the scale alone stamp them; the exact beta count and the rejection fill in
# the init: plans on the "exact_beta" route alone stamp them).
SOLVE_SPANS = ("solve", "solve.init", "solve.clique_seed", "solve.sample", "solve.local",
               "solve.host", "solve.self_update", "solve.finalize", "solve.init.peak",
               "solve.local.scale", "solve.init.beta", "solve.init.fill")
SOLVE_RING = 1 << 16  # solves a plan's record keeps between two reads
EVENT_LOG = 1 << 16  # stamps a plan's record logs between two reads (the trace's timeline)
STAMP_LOG = 1 << 14  # eager stamps kept on a card between two reads
# The counters a closing stamp adds to, each the pairs that the stamp's
# values (one a pair) count: inits whose reduced set outgrew the pool's fill,
# scale peaks that failed the histogram's certificate, solves whose returned
# count is not the host best's.
STAMP_COUNTERS = ("init_thinned", "init_uncertified", "count_refit")
# Words of a stamp record's head: solves, events logged, rounds, local
# batches, then STAMP_COUNTERS (csrc/graph_cond.cu gives the layout).
RECORD_HEAD = 4 + len(STAMP_COUNTERS)


class _Recorder:
    """What tracing has recorded since the last `start()`."""

    def __init__(self):
        self.on = False
        self.seq = 0  # span ids, never reused
        self.reset()

    def reset(self) -> None:
        self.spans: list[list] = []  # [id, name, start, end, parent id, request, fields]
        self.stack: list[list] = []  # the spans open now, innermost last
        self.requests = 0
        self.ops: dict[str, list[int]] = {}  # device span name -> [ns, count]
        self.solves: list[tuple] = []  # (start, end, clock, plan, index, pairs)
        self.timeline: list[tuple] = []  # (name, plan, start, end, clock): logged stamps
        self.stamps: list[tuple] = []  # (name, request, end, value, clock): eager stamps
        self.counters = {"solves": 0, "pairs": 0, "rounds": 0, "local_batches": 0,
                         **dict.fromkeys(STAMP_COUNTERS, 0), "ring_overflow": 0,
                         "log_overflow": 0, "span_overflow": 0}
        self.calibration: dict = {}


_REC = _Recorder()
_NULL = contextlib.nullcontext()
_RECORDS: "weakref.WeakSet[SpanRecord]" = weakref.WeakSet()
_LOGS: dict = {}  # torch.device -> _StampLog


def enable(on: bool = True) -> None:
    """Switch tracing on or off. Plans built while it is on are traced
    plans (their graphs stamp the card's clock), and `solver.fused.plan_for`
    keeps them apart from the others."""
    _REC.on = bool(on)


def enabled() -> bool:
    return _REC.on


class _Span:
    __slots__ = ("row",)

    def __init__(self, name: str, fields: dict):
        rec = _REC
        parent = rec.stack[-1] if rec.stack else None
        if parent is None:
            rec.requests += 1
            request = rec.requests
        else:
            request = parent[5]
        rec.seq += 1
        self.row = [rec.seq, name, time.perf_counter_ns(), None,
                    None if parent is None else parent[0], request, fields]
        rec.spans.append(self.row)
        rec.stack.append(self.row)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> None:
        self.row[3] = time.perf_counter_ns()
        stack = _REC.stack
        if stack and stack[-1] is self.row:
            stack.pop()


def span(name: str, **fields):
    """A host span around a `with` block, `fields` kept with it: a context
    manager that yields the span, or, with tracing off, a shared no-op
    context that yields None."""
    if not _REC.on:
        return _NULL
    if len(_REC.spans) >= MAX_SPANS:
        _REC.counters["span_overflow"] += 1
        return _NULL
    return _Span(name, fields)


def current_request() -> int | None:
    """The request id of the innermost open span; None outside any."""
    return _REC.stack[-1][5] if _REC.stack else None


@functools.cache
def _stamp_lib():
    """csrc/graph_cond.cu, built and loaded on first use, with the stamp's
    and the error text's types set."""
    lib = load_library("graph_cond")
    lib.graph_cond_stamp.argtypes = [c_void_p, c_int, c_int, c_int, c_longlong, c_longlong,
                                     c_void_p, c_void_p, c_void_p, c_void_p, c_longlong, c_int,
                                     c_int, c_int, c_void_p]
    lib.graph_cond_stamp.restype = c_int
    lib.graph_cond_error.argtypes = [c_int]
    lib.graph_cond_error.restype = c_char_p
    return lib


def launch_stamp(rec: torch.Tensor, slot: int, end: bool, slots: int, cap: int = 0,
                 log_cap: int = 0, rounds: torch.Tensor | None = None,
                 batches: torch.Tensor | None = None, pairs: int = 0,
                 values: torch.Tensor | None = None, fill: int = 0, counter: int = 0,
                 other: torch.Tensor | None = None) -> None:
    """Launch, or capture, on the current stream of `rec`'s card the kernel
    that stamps the card's clock into the int64 record `rec` (layout:
    `SpanRecord`; `csrc/graph_cond.cu`). A closing stamp given the pairs'
    `values` adds to the counter `STAMP_COUNTERS[counter]` the pairs whose
    value is above `fill` (int64), other than `other`'s (int64, with
    `other`) or false (bool)."""
    if rec.dtype != torch.int64 or rec.device.type != "cuda" or not rec.is_contiguous():
        raise ValueError(f"a stamp record is contiguous int64 on the card, got {rec.dtype} "
                         f"on {rec.device}")
    if not 0 <= slot < slots or rec.numel() < 3 * slots + RECORD_HEAD + 2 * (cap + log_cap):
        raise ValueError(f"slot {slot} of {slots}, rings {cap} and {log_cap}, do not fit a "
                         f"record of {rec.numel()}")
    if not 0 <= counter < len(STAMP_COUNTERS):
        raise ValueError(f"counter {counter} is not one of the {len(STAMP_COUNTERS)} counters")
    flags = values is not None and values.dtype == torch.bool
    kind = 2 if flags else 1 if other is not None else 0
    for tensor in (rounds, batches, values, other):
        if tensor is not None and (tensor.dtype != (torch.bool if tensor is values and flags
                                                    else torch.int64)
                                   or tensor.numel() < pairs or tensor.device != rec.device
                                   or not tensor.is_contiguous()):
            raise ValueError("the solve's counters are contiguous int64 (or bool flags) on the "
                             "record's card, one a pair")
    stream = torch.cuda.current_stream(rec.device)

    def pointer(tensor):
        return None if tensor is None else tensor.data_ptr()

    lib = _stamp_lib()
    code = lib.graph_cond_stamp(
        rec.data_ptr(), slot, int(bool(end)), slots, cap, log_cap, pointer(rounds),
        pointer(batches), pointer(values), pointer(other), int(fill), int(counter), kind, pairs,
        stream.cuda_stream)
    if code:
        raise RuntimeError(f"launching a stamp failed: {lib.graph_cond_error(code).decode()} "
                           f"({code})")


class _StampLog:
    """The eager stamps on one card: each writes the card's clock into the
    next word of a buffer, and the host keeps what each word is."""

    def __init__(self, device: torch.device):
        self.buf = torch.zeros(3 * STAMP_LOG + RECORD_HEAD, dtype=torch.int64, device=device)
        self.labels: list[tuple] = []  # (name, request, end)

    def stamp(self, name: str, end: bool, request) -> None:
        if len(self.labels) == STAMP_LOG:
            self.fold()
        launch_stamp(self.buf, len(self.labels), False, STAMP_LOG)
        self.labels.append((name, request, end))

    def fold(self) -> None:
        if not self.labels:
            return
        values = self.buf[:len(self.labels)].tolist()
        _REC.stamps.extend((n, r, e, v, "device") for (n, r, e), v in zip(self.labels, values))
        self.labels = []


def device_stamp(device: torch.device, name: str, end: bool) -> None:
    """Open (end False) or close the device span `name` of the current
    request with an eager stamp on `device`'s current stream: it reads the
    card's clock when the stream reaches it. A span named "call" marks a
    call's first and last device operation. On the CPU the host clock, now."""
    if not _REC.on:
        return
    request = current_request()
    if device.type != "cuda":
        _REC.stamps.append((name, request, end, time.perf_counter_ns(), "host"))
        return
    log_ = _LOGS.get(device)
    if log_ is None:
        log_ = _LOGS[device] = _StampLog(device)
    log_.stamp(name, end, request)


class SpanRecord:
    """A traced plan's spans and counters, where the solve runs: on a card
    an int64 record that the stamp kernel writes (csrc/graph_cond.cu gives
    its layout: per slot the open stamp, the ns summed and the closings;
    the solves' ring and the stamps' log), on the CPU the same kept on the
    host. `names` are the slots (slot 0 the whole solve, whose closing adds
    the solve's `rounds` and `batches`, summed over its `pairs`; a closing
    stamp given a value a pair adds how many exceed its threshold to one of
    STAMP_COUNTERS). `read()` folds it into the recorder and empties it."""

    _ids = 0

    def __init__(self, names, device: torch.device, rounds: torch.Tensor,
                 batches: torch.Tensor, pairs: int, label: str, stream=None):
        SpanRecord._ids += 1
        self.names = tuple(names)
        self.device = device
        self.rounds, self.batches, self.pairs = rounds, batches, pairs
        self.label = f"{label} #{SpanRecord._ids}"
        self.stream = stream
        self.cuda = device.type == "cuda"
        self.base = 0  # solves read before
        self.issued = 0  # solves begun on the host since the last read
        n = len(self.names)
        if self.cuda:
            self.rec = torch.zeros(3 * n + RECORD_HEAD + 2 * (SOLVE_RING + EVENT_LOG),
                                   dtype=torch.int64, device=device)
        else:
            self._host_reset()
        _RECORDS.add(self)

    @property
    def nbytes(self) -> int:
        return self.rec.numel() * self.rec.element_size() if self.cuda else 0

    def _host_reset(self) -> None:
        n = len(self.names)
        self.open, self.total, self.count = [0] * n, [0] * n, [0] * n
        self.ring: list[list[int]] = []
        self.log: list[tuple] = []
        self.solves = self.logged = self.n_rounds = self.n_batches = 0
        self.counted = [0] * len(STAMP_COUNTERS)

    def next_index(self) -> int:
        """The index the next solve's `solve` span will have."""
        self.issued += 1
        return self.base + self.issued - 1

    def stamp(self, slot: int, end: bool, values: torch.Tensor | None = None,
              fill: int = 0, counter: int = 0, other: torch.Tensor | None = None) -> None:
        """Open or close `slot` on the current stream (captured inside a
        capture), or on the host clock on the CPU. A closing stamp given
        the pairs' `values` adds to the counter STAMP_COUNTERS[counter] the
        pairs whose value is above `fill` (int64), other than `other`'s
        (int64, with `other`) or false (bool)."""
        if self.cuda:
            launch_stamp(self.rec, slot, end, len(self.names), SOLVE_RING, EVENT_LOG,
                       self.rounds, self.batches, self.pairs, values, fill, counter, other)
            return
        now = time.perf_counter_ns()
        if end:
            self.total[slot] += now - self.open[slot]
            self.count[slot] += 1
        else:
            self.open[slot] = now
        if slot == 0:
            if not end:
                self.ring.append([now, now])
            else:
                self.ring[-1][1] = now
                self.solves += 1
                self.n_rounds += int(self.rounds.sum())
                self.n_batches += int(self.batches.sum())
        if end and values is not None:
            if values.dtype == torch.bool:
                hit = ~values
            else:
                hit = values != other if other is not None else values > fill
            self.counted[counter] += int(hit.sum())
        if len(self.log) < EVENT_LOG:
            self.log.append((slot, end, now))
        self.logged += 1

    def read(self) -> None:
        """Fold the record into the recorder and empty it (one read of the
        card; the caller has let the solves end)."""
        n = len(self.names)
        if self.cuda:
            ctx = torch.cuda.stream(self.stream) if self.stream is not None else _NULL
            with ctx:
                words = self.rec.tolist()
                self.rec.zero_()
            total, count = words[n:2 * n], words[2 * n:3 * n]
            solves, logged, rounds, batches, *counted = words[3 * n:3 * n + RECORD_HEAD]
            ring_at = 3 * n + RECORD_HEAD
            ring = [words[ring_at + 2 * i:ring_at + 2 * i + 2]
                    for i in range(min(solves, SOLVE_RING))]
            log_at = ring_at + 2 * SOLVE_RING
            log_ = [(words[log_at + 2 * i] // 2, words[log_at + 2 * i] % 2,
                     words[log_at + 2 * i + 1]) for i in range(min(logged, EVENT_LOG))]
            clock = "device"
        else:
            total, count, ring, log_ = self.total, self.count, self.ring, self.log
            solves, logged, rounds, batches, counted = (
                self.solves, self.logged, self.n_rounds, self.n_batches, self.counted)
            clock = "host"
        rec = _REC
        for name, ns, k in zip(self.names, total, count):
            if k:
                op = rec.ops.setdefault(name, [0, 0])
                op[0] += ns
                op[1] += k
        rec.solves.extend((s, e, clock, self.label, self.base + i, self.pairs)
                          for i, (s, e) in enumerate(ring))
        opened: dict[int, int] = {}
        for slot, end, t in log_:
            if not end:
                opened[slot] = t
            elif slot in opened:
                rec.timeline.append((self.names[slot], self.label, opened.pop(slot), t, clock))
        c = rec.counters
        c["solves"] += solves
        c["pairs"] += solves * self.pairs
        c["rounds"] += rounds
        c["local_batches"] += batches
        for name, k in zip(STAMP_COUNTERS, counted):
            c[name] += k
        c["ring_overflow"] += max(0, solves - SOLVE_RING)
        c["log_overflow"] += max(0, logged - EVENT_LOG)
        self.base += solves
        self.issued = 0
        if not self.cuda:
            self._host_reset()


def _read_devices() -> None:
    """Let the cards finish, then fold every live record and stamp log."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for index in range(torch.cuda.device_count()):
            torch.cuda.synchronize(index)
    for record in list(_RECORDS):
        record.read()
    for log_ in _LOGS.values():
        log_.fold()


def _clock_device():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def calibrate(device=None, tries: int = CALIBRATION_TRIES) -> dict:
    """Where the host clock (`perf_counter_ns`) stands on the card's: a
    stamp launched between two host reads around a synchronise, `tries`
    times; the tightest try gives the point (its middle on the host, its
    stamp on the card) and its half-width. Without a card the host clock
    is the device clock."""
    device = _clock_device() if device is None else device
    if device is None:
        now = time.perf_counter_ns()
        return {"host_ns": now, "device_ns": now, "halfwidth_ns": 0, "tries": []}
    buf = torch.zeros(3 * tries + RECORD_HEAD, dtype=torch.int64, device=device)
    hosts = []
    for k in range(tries):
        torch.cuda.synchronize(device)
        h0 = time.perf_counter_ns()
        launch_stamp(buf, k, False, tries)
        torch.cuda.synchronize(device)
        hosts.append((h0, time.perf_counter_ns()))
    stamps = buf[:tries].tolist()
    points = [((h0 + h1) // 2, d, (h1 - h0) / 2) for (h0, h1), d in zip(hosts, stamps)]
    mid, dev, half = min(points, key=lambda p: p[2])
    return {"host_ns": mid, "device_ns": dev, "halfwidth_ns": half,
            "tries": [list(p) for p in points]}


def fit_clock(start: dict | None, end: dict) -> dict:
    """The line from the host clock to the card's through the two
    calibrations (slope 1 through `end` alone without `start`), with its
    drift in parts per million and its residual: the median distance of
    every try's middle from the line."""
    if start is None or end["host_ns"] == start["host_ns"]:
        slope = 1.0
    else:
        slope = (end["device_ns"] - start["device_ns"]) / (end["host_ns"] - start["host_ns"])
    offset = end["device_ns"] - slope * end["host_ns"]
    tries = (start or {}).get("tries", []) + end.get("tries", [])
    residual = statistics.median(abs(d - (offset + slope * h)) for h, d, _ in tries) \
        if tries else 0.0
    halves = [c["halfwidth_ns"] for c in (start, end) if c is not None]
    return {"slope": slope, "offset_ns": offset, "drift_ppm": (slope - 1.0) * 1e6,
            "residual_ns": residual, "halfwidth_ns": max(halves)}


def start() -> None:
    """Mark the window: what was recorded so far is read and dropped, and
    the host clock is calibrated against the card's."""
    _read_devices()
    _REC.reset()
    _REC.calibration["start"] = calibrate()


# -----------------------------------------------------------------------------
# Tracing: what a window shows
# -----------------------------------------------------------------------------


def _merge(intervals) -> list[list[int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(lo: int, hi: int, merged: list[list[int]], starts: list[int]) -> int:
    """ns of [lo, hi] that the merged, sorted intervals cover."""
    k = max(bisect.bisect_right(starts, lo) - 1, 0)
    got = 0
    while k < len(merged) and merged[k][0] < hi:
        got += max(0, min(hi, merged[k][1]) - max(lo, merged[k][0]))
        k += 1
    return got


def device_spans(stamps) -> list[tuple]:
    """(name, request, start, end) of the eager device spans, an opening
    stamp paired with the next closing of the same name and request."""
    opened: dict = {}
    out = []
    for name, request, end, t in stamps:
        if not end:
            opened[(name, request)] = t
        elif (name, request) in opened:
            out.append((name, request, opened.pop((name, request)), t))
    return out


def attribute_gaps(calls, spans) -> list[dict]:
    """The device's gaps between calls and the host span each is put down
    to. `calls`: (start, end) of each call's device work; a gap runs from
    one call's end to the next call's start. `spans`: host span rows (id,
    name, start, end, parent id, ...) on the same clock. A gap goes to the
    span that was innermost over most of it, or to "caller" where no span
    of the program was open over most of it."""
    ordered = sorted(calls)
    gaps = [(a[1], b[0]) for a, b in zip(ordered, ordered[1:]) if b[0] > a[1]]
    children: dict = {}
    for row in spans:
        children.setdefault(row[4], []).append(row)
    for rows in children.values():
        rows.sort(key=lambda r: r[2])
    tops = children.get(None, [])
    top_starts = [r[2] for r in tops]
    out = []
    for lo, hi in gaps:
        share: dict[str, int] = {}

        def visit(rows, starts):
            covered = 0
            k = max(bisect.bisect_right(starts, lo) - 1, 0)
            while k < len(rows) and rows[k][2] < hi:
                row = rows[k]
                k += 1
                over = max(0, min(hi, row[3]) - max(lo, row[2]))
                if not over:
                    continue
                kids = children.get(row[0], [])
                inner = visit(kids, [r[2] for r in kids]) if kids else 0
                share[row[1]] = share.get(row[1], 0) + over - inner
                covered += over
            return covered

        share["caller"] = (hi - lo) - visit(tops, top_starts)
        out.append({"start_ns": lo, "end_ns": hi, "span": max(share, key=share.get)})
    return out


def _summary(snap_ops: dict, solves, prefilters, calls) -> None:
    """Add the derived device spans: `solve.control` (the whole solve less
    its stage spans, those inside a stage not subtracted again: the
    conditional nodes, the stamps, the launch marks and the gaps between the
    chain's kernels) and `call.outside_graph` (device time inside a call
    outside every solve and pre-filter span)."""
    whole = snap_ops.get("solve")
    if whole is not None:
        stages = sum(v["ns"] for k, v in snap_ops.items()
                     if k.startswith("solve.") and k.count(".") == 1)
        snap_ops["solve.control"] = {"ns": whole["ns"] - stages, "count": whole["count"]}
    if calls:
        merged = _merge([(s, e) for s, e in solves] + [(s, e) for s, e in prefilters])
        starts = [m[0] for m in merged]
        outside = sum((e - s) - _covered(s, e, merged, starts) for s, e in calls)
        snap_ops["call.outside_graph"] = {"ns": outside, "count": len(calls)}


def snapshot() -> dict:
    """Read every record (the cached plans' and the eager stamps') and
    return the window on the card's clock, in ns: "window_ns" [start, end];
    "spans", the host spans as dicts (id, name, start_ns, end_ns, parent,
    request and their fields); "device", the device spans by name (ns summed
    and count), the derived `solve.control` and `call.outside_graph` among
    them; "solves" (start_ns, end_ns, plan, index, pairs) from the plans'
    rings; "calls" and "device_spans" from the eager stamps; "timeline",
    each logged stage span (name, plan, start_ns, end_ns); "counters"
    (solves, pairs, rounds, local batches, STAMP_COUNTERS: the pairs' solves
    whose init thinned the reduced set to the pool's fill, whose scale peak
    failed its certificate, whose returned count is not the host best's;
    overflows); "gaps", each with
    the host span it is put down to, and "gaps_by_span" (ns summed, count,
    longest); "calibration", the fit from the host clock to the card's."""
    _read_devices()
    rec = _REC
    rec.calibration["end"] = calibrate()
    fit = fit_clock(rec.calibration.get("start"), rec.calibration["end"])
    slope, offset = fit["slope"], fit["offset_ns"]

    def dev(t, clock="host"):
        return int(round(offset + slope * t)) if clock == "host" else int(t)

    spans = [[r[0], r[1], dev(r[2]), dev(r[3] if r[3] is not None else r[2]), r[4], r[5],
              r[6]] for r in rec.spans]
    stamps = [(n, q, e, dev(v, c)) for n, q, e, v, c in rec.stamps]
    eager = device_spans(stamps)
    calls = [(s, e) for n, _, s, e in eager if n == "call"]
    prefilters = [(s, e) for n, _, s, e in eager if n != "call"]
    solves = [(dev(s, c), dev(e, c), plan, index, pairs) for s, e, c, plan, index, pairs
              in rec.solves]
    ops = {name: {"ns": ns, "count": k} for name, (ns, k) in rec.ops.items()}
    for name, _, s, e in eager:
        if name != "call":
            op = ops.setdefault(name, {"ns": 0, "count": 0})
            op["ns"] += e - s
            op["count"] += 1
    _summary(ops, [(s, e) for s, e, *_ in solves], prefilters, calls)
    gaps = attribute_gaps(calls, spans)
    by_span: dict = {}
    for g in gaps:
        ns = g["end_ns"] - g["start_ns"]
        row = by_span.setdefault(g["span"], {"ns": 0, "count": 0, "longest_ns": 0})
        row["ns"] += ns
        row["count"] += 1
        row["longest_ns"] = max(row["longest_ns"], ns)
    start_cal = rec.calibration.get("start")
    if start_cal is not None:
        t0 = dev(start_cal["host_ns"])
    else:
        firsts = [s[2] for s in spans] + [s for s, *_ in solves] + [s for s, _ in calls]
        t0 = min(firsts) if firsts else fit["offset_ns"]
    return {
        "window_ns": [t0, dev(rec.calibration["end"]["host_ns"])],
        "spans": [{"id": r[0], "name": r[1], "start_ns": r[2], "end_ns": r[3], "parent": r[4],
                   "request": r[5], **r[6]} for r in spans],
        "device": ops,
        "solves": [list(s) for s in solves],
        "calls": [[q, s, e] for n, q, s, e in eager if n == "call"],
        "device_spans": [list(x) for x in eager if x[0] != "call"],
        "timeline": [(n, plan, dev(s, c), dev(e, c)) for n, plan, s, e, c in rec.timeline],
        "counters": dict(rec.counters),
        "gaps": gaps,
        "gaps_by_span": by_span,
        "calibration": {**fit, "start": _no_tries(start_cal),
                        "end": _no_tries(rec.calibration["end"])},
    }


def _no_tries(cal):
    return None if cal is None else {k: v for k, v in cal.items() if k != "tries"}


def breakdown(snap: dict) -> dict:
    """The window's device time by span ("ops": name, ms summed, count,
    sorted by time) and its gaps by the host span they are put down to
    ("gaps": name, ms summed, count, longest ms)."""
    ops = [{"name": k, "ms": v["ns"] / 1e6, "count": v["count"]}
           for k, v in snap["device"].items()]
    gaps = [{"name": k, "ms": v["ns"] / 1e6, "count": v["count"],
             "longest_ms": v["longest_ns"] / 1e6} for k, v in snap["gaps_by_span"].items()]
    return {"ops": sorted(ops, key=lambda o: -o["ms"]),
            "gaps": sorted(gaps, key=lambda g: -g["ms"])}


def chrome_events(snap: dict) -> list[dict]:
    """The window as Chrome trace events (Perfetto, chrome://tracing), in
    µs from the window's start: the host spans in process 0, on the card's
    clock; the card's spans in process 1, a thread for each plan (its
    solves and logged stage spans), one for the calls and eager spans, one
    for the gaps."""
    t0 = snap["window_ns"][0]

    def event(name, pid, tid, s, e, **args):
        return {"name": name, "ph": "X", "pid": pid, "tid": tid, "ts": (s - t0) / 1e3,
                "dur": (e - s) / 1e3, "args": args}

    out = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "host"}},
           {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "card"}}]
    for s in snap["spans"]:
        extra = {k: v for k, v in s.items() if k not in ("name", "start_ns", "end_ns")}
        out.append(event(s["name"], 0, "host", s["start_ns"], s["end_ns"], **extra))
    logged = {(plan, s) for name, plan, s, _ in snap["timeline"] if name == "solve"}
    for s, e, plan, index, pairs in snap["solves"]:
        if (plan, s) not in logged:
            out.append(event("solve", 1, plan, s, e, index=index, pairs=pairs))
    for name, plan, s, e in snap["timeline"]:
        out.append(event(name, 1, plan, s, e))
    for request, s, e in snap["calls"]:
        out.append(event("call", 1, "calls", s, e, request=request))
    for name, request, s, e in snap["device_spans"]:
        out.append(event(name, 1, "calls", s, e, request=request))
    for g in snap["gaps"]:
        out.append(event(f"gap: {g['span']}", 1, "gaps", g["start_ns"], g["end_ns"]))
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block: tracing on, a window started, and at exit a Chrome
    trace (Perfetto, chrome://tracing) of the program's host and device
    spans on the card's clock written into `log_dir` as
    trace_<pid>_<ns>.json; yields the directory. The switch is left as it
    was. (No torch.profiler: CUPTI faults the card over the plans'
    conditional graphs.)"""
    was = enabled()
    os.makedirs(log_dir, exist_ok=True)
    enable(True)
    try:
        start()
        yield log_dir
        snap = snapshot()
    finally:
        enable(was)
    with open(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"), "w") as f:
        json.dump({"traceEvents": chrome_events(snap), "displayTimeUnit": "ns",
                   "otherData": {"calibration": snap["calibration"],
                                 "counters": snap["counters"],
                                 "breakdown": breakdown(snap)}}, f)
