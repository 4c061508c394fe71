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
- `trace(...)`: a `torch.profiler.profile` span writing a Chrome trace
  (`*.json`) into a directory,
- `log` / `log_throttled`: stdlib-logging-backed equivalents of the info
  macros, enabled via PSULVSB_DIAG=1 (the TEASER_DIAG_PRINT analog). The
  logger keeps the JAX package's name, "psulvsb_tpu", so one logging
  setting serves both packages.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

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
    a caller may fill a list it passed in inside the span."""
    t = Timer(name).start()
    result = {}
    try:
        yield result
    finally:
        result["elapsed_s"] = t.stop(sync_on=sync_on)
        log(f"[{name}] {result['elapsed_s']:.4f}s")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler span over the CPU, and the card where there is one;
    at exit it writes a Chrome trace (chrome://tracing, Perfetto) into
    `log_dir` as trace_<pid>_<ns>.json and yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )
