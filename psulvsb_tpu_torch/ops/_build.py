"""Build and load the port's CUDA kernels.

Each kernel is one `csrc/<name>.cu` file with a plain C entry point, which
may include headers that lie under `csrc/` too. At first use it is compiled
by nvcc for Hopper (sm_90a) into a shared library under
`build/psulvsb_tpu_torch/` beside the package, named by a hash of the source
and of every header under `csrc/` it includes, so an edited kernel or header
is rebuilt, and loaded with ctypes. Nothing is built when a module is
imported.

The kernels are named here once (`KERNELS`): each is the C entry point
`<name>_launch` of csrc/<name>.cu, or of the library `_LIBRARY` names. Every
launch goes through `launch`, which counts it in `LAUNCHES`. Adding a kernel
takes its `.cu` file, its name here and the op module that calls `launch`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "psulvsb_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)

KERNELS = ("gnc_batch", "pair_ratio_hist", "pair_beta_count", "consistency_degree",
           "dense_init", "local_pick", "local_accept", "finalize_fit")
_LIBRARY = {"local_pick": "local_batch", "local_accept": "local_batch"}
# name -> the launches made so far: every call of `launch`, a capture's too;
# a traced plan adds those its graph's replays make (solver/fused.py).
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

_LOADED: dict[str, ctypes.CDLL] = {}
# name -> its C entry point, its result and argument types set
_LAUNCHERS: dict[str, ctypes._CFuncPtr] = {}
# name -> {"seconds": build time (0.0 when the library was already built),
# "log": nvcc's output, including ptxas's register and shared-memory report}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def source_files(name: str) -> list[Path]:
    """csrc/<name>.cu and the files under csrc/ that it includes with
    `#include "..."`, directly or through one another."""
    todo = [CSRC_DIR / f"{name}.cu"]
    found: list[Path] = []
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [
            CSRC_DIR / inc for inc in _INCLUDE.findall(path.read_text())
            if (CSRC_DIR / inc).is_file()
        ]
    return found


def source_digest(name: str) -> str:
    """Hash of everything under csrc/ that csrc/<name>.cu is compiled from."""
    h = hashlib.sha256()
    for path in sorted(source_files(name)):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu on first use and return the loaded library."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    src = CSRC_DIR / f"{name}.cu"
    digest = source_digest(name)
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    info = {"seconds": 0.0, "log": ""}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build into a temporary name and rename, so concurrent processes
        # never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        info = {
            "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr,
        }
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed to build {src}:\n{info['log']}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = lib
    BUILD_INFO[name] = info
    return lib


def launch(name: str, argtypes: list, device: torch.device, *args) -> None:
    """Launch kernel `name` of `KERNELS` on the current stream of `device`:
    its C entry point `<name>_launch` (built, loaded and given its int result
    and `argtypes` on first use) is called with `args` and the stream's
    handle; a non-zero result raises, and a launch made adds one to
    `LAUNCHES[name]`."""
    if name not in KERNELS:
        raise ValueError(f"{name!r} is not one of the kernels {KERNELS}")
    fn = _LAUNCHERS.get(name)
    if fn is None:
        fn = getattr(load_library(_LIBRARY.get(name, name)), f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _LAUNCHERS[name] = fn
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
