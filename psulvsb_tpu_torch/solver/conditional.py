"""Conditional nodes of a CUDA graph, for the one-launch solve.

JAX keeps a solve's control flow on the device: `lax.cond` and
`lax.while_loop` inside one compiled program. PyTorch releases from 2.6 on
have `CUDAGraph.begin_capture_to_if_node`; the releases this port runs on do
not all have it, so the port builds the nodes itself (`csrc/graph_cond.cu`,
loaded with ctypes): `GraphControl.when(flag)` captures its body into an IF
node, `GraphControl.repeat(flag, body)` into a WHILE node, and either
nests.

Each capture has streams of its own: one for the graph's top level and a
few for bodies, slots. A library that keeps state per stream, as cuBLAS
keeps its workspace, bakes that state into the graph, so two graphs
captured on one stream would share it when they run at once on two
streams. Bodies go to a slot: by default the slot of the
body's nesting depth (or the next one that no body around it holds), or one
the caller names, so long as no body that is open around it holds that
slot. Whatever a body allocates comes from a
private memory pool of its slot (the allocator routes one stream to one
pool, and reuses a freed block on the stream that freed it). The bodies of
one slot run one after another, so a block one body frees is reused by the
next: a slot's pool holds its largest body, not their sum, and a caller
that puts its largest bodies in one slot holds the largest of them only. A tensor that a body writes and a later part of
the graph reads must live outside the body (a plan buffer, written with
`copy_`), since an untaken body writes nothing.

Kernel launches are counted where they run, in a traced plan:
`ops._build.launch` adds to the host counts (`LAUNCHES`) when a capture
calls it, and the control turns what a region of the graph captured into
an addition to a counter on the device, captured in that region, so a
replay counts the launches it really makes. A traced plan also captures the
program's clock (`GraphControl.stamp`, `utils.timing.launch_stamp`): a
one-thread kernel that reads the card's nanosecond clock, the one source of
time that works inside IF and WHILE bodies. An untraced plan captures
neither.
"""

from __future__ import annotations

import contextlib
from ctypes import byref, c_char_p, c_int, c_ulonglong, c_void_p

import torch

from psulvsb_tpu_torch.ops._build import KERNELS, LAUNCHES, load_library

IF, WHILE = 0, 1
_FUNCS = None


def _lib():
    global _FUNCS
    if _FUNCS is None:
        lib = load_library("graph_cond")
        lib.graph_cond_set.argtypes = [c_ulonglong, c_void_p, c_void_p]
        lib.graph_cond_begin.argtypes = [c_void_p, c_void_p, c_void_p, c_int,
                                         c_void_p]
        lib.graph_cond_end.argtypes = [c_void_p, c_void_p]
        lib.graph_cond_capture_nodes.argtypes = [c_void_p, c_void_p]
        lib.graph_cond_stream_create.argtypes = [c_void_p]
        lib.graph_cond_stream_destroy.argtypes = [c_void_p]
        lib.graph_cond_error.argtypes = [c_int]
        lib.graph_cond_error.restype = c_char_p
        for fn in (lib.graph_cond_set, lib.graph_cond_begin, lib.graph_cond_end,
                   lib.graph_cond_capture_nodes, lib.graph_cond_stream_create,
                   lib.graph_cond_stream_destroy):
            fn.restype = c_int
        _FUNCS = lib
    return _FUNCS


def _check(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"{what} failed: {_lib().graph_cond_error(code).decode()} ({code})")


def _new_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A stream of its own (PyTorch's pooled streams repeat after 32, and
    a body captured on the stream that captures around it cannot begin)."""
    raw = c_void_p()
    _check(_lib().graph_cond_stream_create(byref(raw)), "making a stream")
    return torch.cuda.ExternalStream(raw.value, device=device)


def _flag_pointer(flag: torch.Tensor) -> int:
    if flag.dtype != torch.bool or flag.numel() != 1 or flag.device.type != "cuda":
        raise ValueError(f"a condition is one bool on the card, got {flag.dtype} "
                         f"{tuple(flag.shape)} on {flag.device}")
    return flag.data_ptr()


class GraphControl:
    """The conditional nodes of one capture on `device`.

    `launches` is the device counter, one int64 entry per name of
    `ops._build.KERNELS` in that order, that replays add to. `trace`, a
    traced plan's
    `utils.timing.SpanRecord`, turns on the launch marks and the stamps;
    without it neither is captured. `stamps` and `marks` count the kernel
    nodes each captured. Capture on `capture_stream`; call `close()` once
    the capture has ended; the pools then hold the bodies' memory and the
    streams stay until `release()`."""

    def __init__(self, device: torch.device, launches: torch.Tensor, trace=None):
        self.device = device
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.launches = launches
        self.trace = trace
        self.stamps = 0
        self.marks = 0
        self.marked = dict(LAUNCHES)
        self.depth = 0
        self.open: set[int] = set()  # the slots of the bodies open now
        self.nodes = 0  # nodes inside bodies
        self.conditionals = 0
        self.pools: list = []  # one a slot, from the slot's first body on
        self.capture_stream = _new_stream(self.device)
        self.streams: list[torch.cuda.ExternalStream] = []  # one a slot

    def _stream(self, slot: int) -> torch.cuda.ExternalStream:
        """The stream of a slot; from its first body in this capture on,
        what it allocates comes from the slot's pool."""
        while len(self.streams) <= slot:
            self.streams.append(_new_stream(self.device))
        while len(self.pools) <= slot:
            pool = torch.cuda.graph_pool_handle()
            with torch.cuda.stream(self.streams[len(self.pools)]):
                torch._C._cuda_beginAllocateCurrentStreamToPool(self.index, pool)
            self.pools.append(pool)
        return self.streams[slot]

    def warm(self, slots: int, fn) -> None:
        """Before the capture: run `fn` eagerly on the capture stream and
        the streams of the first `slots` slots, so that libraries which keep
        state per stream (cuBLAS's workspace) make none inside the capture."""
        while len(self.streams) < slots:
            self.streams.append(_new_stream(self.device))
        main = torch.cuda.current_stream(self.device)
        for stream in [self.capture_stream] + self.streams[:slots]:
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                fn()
            main.wait_stream(stream)

    def mark(self) -> None:
        """Capture, on the current stream, the addition to the device
        counter of the launches captured since the last mark (traced
        plans only)."""
        if self.trace is None:
            return
        now = dict(LAUNCHES)
        for i, name in enumerate(KERNELS):
            added = now[name] - self.marked[name]
            if added:
                self.launches[i].add_(added)
                self.marks += 1
        self.marked = now

    def stamp(self, slot: int, end: bool, values: torch.Tensor | None = None,
              fill: int = 0, counter: int = 0, other: torch.Tensor | None = None) -> None:
        """Capture, on the current stream, a stamp of the card's clock that
        opens (end False) or closes slot `slot` of the plan's record (a
        closing one given `values` adds to a counter: `SpanRecord.stamp`)."""
        self.trace.stamp(slot, end, values, fill, counter, other)
        self.stamps += 1

    @contextlib.contextmanager
    def _body(self, flag: torch.Tensor, kind: int, slot: int | None):
        if slot is None:  # the depth's slot, or the next one that is free
            slot = self.depth
            while slot in self.open:
                slot += 1
        if slot in self.open:
            raise ValueError(f"slot {slot} is held by a body around this one")
        parent = torch.cuda.current_stream(self.device)
        body = self._stream(slot)
        self.mark()
        handle = c_ulonglong()
        _check(_lib().graph_cond_begin(parent.cuda_stream, body.cuda_stream, _flag_pointer(flag),
                                       kind, byref(handle)), "beginning a conditional node")
        self.depth += 1
        self.open.add(slot)
        try:
            with torch.cuda.stream(body):
                yield handle.value
                self.mark()
        finally:
            self.depth -= 1
            self.open.discard(slot)
            nodes = c_ulonglong()
            _check(_lib().graph_cond_end(body.cuda_stream, byref(nodes)),
                   "ending a conditional node")
        self.nodes += nodes.value
        self.conditionals += 1

    @contextlib.contextmanager
    def when(self, flag: torch.Tensor, slot: int | None = None):
        """The body runs when the bool `flag` holds as the graph reaches it
        (an IF node: `lax.cond` with an identity branch)."""
        with self._body(flag, IF, slot):
            yield

    def repeat(self, flag: torch.Tensor, body, slot: int | None = None) -> None:
        """Run `body` while the condition holds (a WHILE node:
        `lax.while_loop`): first `flag` as the graph reaches it, then the
        flag `body` returns."""
        with self._body(flag, WHILE, slot) as handle:
            again = body()
            stream = torch.cuda.current_stream(self.device)
            _check(_lib().graph_cond_set(handle, _flag_pointer(again), stream.cuda_stream),
                   "setting a loop's condition")

    def top_nodes(self) -> int | None:
        """Nodes of the graph the current stream captures into (the top
        level, each conditional node one); None where the driver will not
        say during a capture."""
        nodes = c_ulonglong()
        stream = torch.cuda.current_stream(self.device)
        code = _lib().graph_cond_capture_nodes(stream.cuda_stream, byref(nodes))
        return None if code else nodes.value

    def close(self) -> None:
        """Stop routing the body streams' allocations to the pools."""
        for pool in self.pools:
            torch._C._cuda_endAllocateToPool(self.index, pool)

    def release(self) -> None:
        """Give the pools back (their memory returns at the next
        empty_cache) and the streams; the graph must be gone."""
        for pool in self.pools:
            torch._C._cuda_releasePool(self.index, pool)
        for stream in [self.capture_stream] + self.streams:
            _lib().graph_cond_stream_destroy(stream.cuda_stream)
        self.pools, self.streams = [], []
