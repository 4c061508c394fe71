"""Exact maximum clique through the native C++ branch and bound.

Port of psulvsb_tpu/clique/pmc.py, the host-side equivalent of the PMC path
in MaxCliqueSolver::findMaxClique (graph.cc:84-124: a heuristic lower bound,
then the exact search with 12 threads and a time limit). The library's
source is native/maxclique.cpp at the root of the repository. This package
builds it itself with g++ at first use into the git-ignored
`build/psulvsb_tpu_torch/`, as `ops/_build.py` builds the CUDA kernels, under
a name that hashes the source, and loads it with ctypes. Of `native/` it
reads that one source file and nothing else, and it writes nothing there.

Only a missing source file or a missing compiler counts as "no toolchain"
(`NativeUnavailable`, which `native_available` turns into False and
remembers). A build that fails, a build directory that cannot be written and
a library that does not load are errors and raise from every entry point.

`EXACT_SEARCHES` counts the calls of `exact_max_clique` that reached the
library, so a caller can tell that the exact search ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from psulvsb_tpu_torch.ops._build import BUILD_DIR

SOURCE = BUILD_DIR.parents[1] / "native" / "maxclique.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
EXACT_SEARCHES = 0

_lock = threading.Lock()
_lib = None
_missing: str | None = None  # why there is no toolchain, once that was found


class NativeUnavailable(RuntimeError):
    """The library cannot be built here: its source or the compiler is
    missing."""


def _load():
    """Build (once a source digest) and load the library. Raises
    `NativeUnavailable` where the source or the compiler is missing, and
    whatever the build or the loader raises where they fail."""
    global _lib, _missing
    with _lock:
        if _lib is not None:
            return _lib
        if _missing is not None:
            raise NativeUnavailable(_missing)
        if not SOURCE.is_file():
            _missing = f"{SOURCE} not found"
            raise NativeUnavailable(_missing)
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"libmaxclique-{digest}.so"
        if not out.exists():
            cxx = shutil.which(os.environ.get("CXX", "g++"))
            if cxx is None:
                _missing = "g++ not found: it is needed to build native/maxclique.cpp"
                raise NativeUnavailable(_missing)
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build under a temporary name and rename, so that no process
            # loads a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True
            )
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.max_clique.restype = ctypes.c_int
        lib.max_clique.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.kcores.restype = None
        lib.kcores.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether there is a toolchain to build the library with. False only for
    a missing source or compiler; a failing build or load raises."""
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def exact_search_available(device) -> bool:
    """Whether a PMC_EXACT caller whose data lies on `device` gets the exact
    search. Without a toolchain a caller on the CPU gets False and degrades
    to the greedy, as the JAX package does; a caller on the card is never
    handed the heuristic in the exact search's name, so there it raises."""
    try:
        _load()
        return True
    except NativeUnavailable as exc:
        if torch.device(device).type != "cpu":
            raise NativeUnavailable(
                f"PMC_EXACT on {device} needs the native clique library: {exc}"
            ) from exc
        return False


def _as_bytes(adj) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(adj, np.uint8))


def exact_max_clique(
    adj: np.ndarray, time_limit_s: float = 3600.0, n_threads: int = 12
) -> list[int]:
    """Exact maximum clique of a dense symmetric (N, N) adjacency matrix on
    the host, as a sorted vertex list (the reference sorts,
    registration.cc:1025). On timeout the best clique found so far comes
    back (PMC's behaviour under in.time_limit). n_threads defaults to the
    reference's hard-coded 12 (graph.cc:38)."""
    global EXACT_SEARCHES
    adj = _as_bytes(adj)
    n = adj.shape[0]
    if n == 0:
        return []
    lib = _load()
    out = np.zeros(n, np.int32)
    size = lib.max_clique(
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        float(time_limit_s),
        int(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    EXACT_SEARCHES += 1
    return sorted(out[: abs(int(size))].tolist())


def native_core_numbers(adj: np.ndarray) -> np.ndarray:
    """Core numbers of a dense symmetric (N, N) adjacency matrix by the
    library's bucket peeling; (N,) int32."""
    adj = _as_bytes(adj)
    n = adj.shape[0]
    lib = _load()
    out = np.zeros(n, np.int32)
    lib.kcores(
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out


def exact_max_clique_mask(adj, active=None, time_limit_s: float = 3600.0) -> np.ndarray:
    """`exact_max_clique` of the graph among the active vertices, as an (N,)
    bool mask (numpy in, numpy out)."""
    adj_np = np.asarray(adj, bool)
    n = adj_np.shape[0]
    if active is not None:
        act = np.asarray(active, bool)
        adj_np = adj_np & act[None, :] & act[:, None]
    mask = np.zeros(n, bool)
    mask[exact_max_clique(adj_np, time_limit_s)] = True
    return mask
