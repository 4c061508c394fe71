"""Pair-grid sweeps of the init stage: the ratio histogram
(`csrc/pair_ratio_hist.cu`) and the known-scale window count
(`csrc/pair_beta_count.cu`), each with its plain PyTorch version, and
`exact_peak_bin`, the two-pass exact histogram peak.

The functions keep the signatures of the JAX package's front doors
(psulvsb_tpu/ops/pallas_hist.py): points as (3, C), an optional (C,)
active mask, pairs i < j with both ends active. Distances come from direct
differences (s_j - s_i), the squares summed x, y, z; the kernels compute
them bit for bit as the plain versions do, so counts are equal, and exact
64-bit integers (the Pallas kernels accumulate in float32).

Which version runs is decided by where the tensors lie: CPU tensors take
the plain versions; CUDA tensors launch the kernels or raise. Each launch
adds one to `KERNEL_LAUNCHES[name]`.
"""

from __future__ import annotations

import ctypes

import torch

from psulvsb_tpu_torch.ops._build import load_library

MAX_BINS = 512  # the histogram kernel keeps its bins in shared memory
KERNEL_LAUNCHES = {"pair_ratio_hist": 0, "pair_beta_count": 0}
_FINE_CAP = float(1 << 30)  # fine bins past 2^30 fall outside every window
_ROW_CHUNK = 1024  # rows per step of the plain versions' sweep


def _check(src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor | None) -> torch.Tensor:
    """Validate (3, C) inputs; return the (C,) bool active mask."""
    if src.dim() != 2 or src.shape[0] != 3 or tuple(dst.shape) != tuple(src.shape):
        raise ValueError(
            f"src and dst must both be (3, C), got {tuple(src.shape)} and {tuple(dst.shape)}"
        )
    c = src.shape[1]
    if active is None:
        return torch.ones(c, dtype=torch.bool, device=src.device)
    if tuple(active.shape) != (c,):
        raise ValueError(f"active must be ({c},), got {tuple(active.shape)}")
    for name, t in (("dst", dst), ("active", active)):
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, expected {src.device}")
    return active.to(torch.bool)


def _pair_sweep(src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor):
    """Yield (v1, v2, valid) over row blocks of the pair grid: source and
    destination distances of rows [r0, r1) against columns [r0, C), and the
    mask of active pairs i < j. Distances are sqrt((dx dx + dy dy) + dz dz)
    of direct differences, in float32."""
    c = src.shape[1]
    s = src.to(torch.float32)
    d = dst.to(torch.float32)
    cols = torch.arange(c, device=src.device)

    def dist(p, r0, r1):
        e = p[:, None, r0:] - p[:, r0:r1, None]  # (3, rows, cols): p_j - p_i
        return torch.sqrt((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2])

    for r0 in range(0, c, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, c)
        rows = cols[r0:r1]
        valid = (rows[:, None] < cols[None, r0:]) & active[r0:r1, None] & active[None, r0:]
        yield dist(s, r0, r1), dist(d, r0, r1), valid


def _bin_indices(v1, v2, bins_per_unit, lo, stride, num_bins):
    """(window bin clamped into [0, num_bins), in-window mask) of each pair
    ratio: fine = max(floor(ratio * bins_per_unit), 0), bin =
    floor((fine - lo) / stride)."""
    ratio = v2 / torch.where(v1 > 0, v1, torch.ones_like(v1))
    f = torch.floor(ratio * float(bins_per_unit))
    fine = torch.clamp(f, 0.0, _FINE_CAP).to(torch.int64)
    idx = torch.div(fine - lo, stride, rounding_mode="floor")
    inside = (idx >= 0) & (idx < num_bins)
    return torch.clamp(idx, 0, num_bins - 1), inside


def _check_window(num_bins: int, stride: int) -> None:
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins must be in [1, {MAX_BINS}], got {num_bins}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")


def pair_ratio_histogram_reference(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor | None = None,
    bins_per_unit: int = 20,
    num_bins: int = 512,
    lo_bin: int | torch.Tensor = 0,
    stride: int = 1,
    clamp_overflow: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of `pair_ratio_histogram`."""
    active = _check(src, dst, active)
    _check_window(num_bins, stride)
    lo = torch.as_tensor(lo_bin, device=src.device).to(torch.int64)
    counts = torch.zeros(num_bins + 1, dtype=torch.int64, device=src.device)
    for v1, v2, valid in _pair_sweep(src, dst, active):
        idx, inside = _bin_indices(v1, v2, bins_per_unit, lo, stride, num_bins)
        counted = valid if clamp_overflow else valid & inside
        # Pairs that do not count go to a spare bin past the window.
        slot = torch.where(counted, idx, torch.full_like(idx, num_bins))
        counts.scatter_add_(0, slot.reshape(-1), torch.ones_like(slot).reshape(-1))
    return counts[:num_bins]


def pair_beta_count_reference(
    src: torch.Tensor,
    dst: torch.Tensor,
    beta: float,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of `pair_beta_count`."""
    active = _check(src, dst, active)
    beta32 = torch.tensor(beta, dtype=torch.float32, device=src.device)
    total = torch.zeros((), dtype=torch.int64, device=src.device)
    for v1, v2, valid in _pair_sweep(src, dst, active):
        total = total + ((torch.abs(v1 - v2) <= beta32) & valid).sum()
    return total


def _cuda_inputs(src, dst, active):
    f32 = torch.float32
    return (
        src.to(f32).contiguous(),
        dst.to(f32).contiguous(),
        active.to(torch.uint8).contiguous(),
    )


def pair_ratio_histogram(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor | None = None,
    bins_per_unit: int = 20,
    num_bins: int = 512,
    lo_bin: int | torch.Tensor = 0,
    stride: int = 1,
    clamp_overflow: bool = True,
) -> torch.Tensor:
    """Exact windowed histogram of |d_j - d_i| / |s_j - s_i| over the
    active pairs i < j. Bin b counts fine bins [lo_bin + b stride,
    lo_bin + (b+1) stride), a fine bin spanning 1 / bins_per_unit of ratio.
    clamp_overflow=True folds out-of-window ratios into the edge bins
    (coarse pass); False drops them (fine pass). `lo_bin` may be a 0-d
    tensor on the device, read there without a host sync. Returns counts
    (num_bins,) int64. CPU tensors run the plain version; CUDA tensors the
    kernel (no fallback)."""
    if not src.is_cuda:
        return pair_ratio_histogram_reference(
            src, dst, active, bins_per_unit, num_bins, lo_bin, stride, clamp_overflow
        )
    active = _check(src, dst, active)
    _check_window(num_bins, stride)
    dev = src.device
    s, d, a = _cuda_inputs(src, dst, active)
    lo = torch.as_tensor(lo_bin, device=dev).to(torch.int32).reshape(1)
    window = torch.cat([lo, torch.full((1,), stride, dtype=torch.int32, device=dev)])
    counts = torch.zeros(num_bins, dtype=torch.int64, device=dev)
    lib = load_library("pair_ratio_hist")
    fn = lib.pair_ratio_hist_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p] + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            s.data_ptr(), d.data_ptr(), a.data_ptr(), s.shape[1], float(bins_per_unit),
            window.data_ptr(), num_bins, int(bool(clamp_overflow)), counts.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_ratio_hist kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES["pair_ratio_hist"] += 1
    return counts


def pair_beta_count(
    src: torch.Tensor,
    dst: torch.Tensor,
    beta: float,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exact number of active pairs i < j with
    | |s_j - s_i| - |d_j - d_i| | <= beta (the known-scale reduced-set test,
    registration.cc:753-767), beta rounded to float32. Returns () int64.
    CPU tensors run the plain version; CUDA tensors the kernel (no
    fallback)."""
    if not src.is_cuda:
        return pair_beta_count_reference(src, dst, beta, active)
    active = _check(src, dst, active)
    dev = src.device
    s, d, a = _cuda_inputs(src, dst, active)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = load_library("pair_beta_count")
    fn = lib.pair_beta_count_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    ]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            s.data_ptr(), d.data_ptr(), a.data_ptr(), s.shape[1], float(beta),
            count.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"pair_beta_count kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES["pair_beta_count"] += 1
    return count[0]


def _exact_peak_bin(hist, src, dst, active, bins_per_unit, num_bins, stride):
    """exact_peak_bin over the histogram function `hist`."""
    coarse = hist(
        src, dst, active, bins_per_unit=bins_per_unit, num_bins=num_bins,
        lo_bin=0, stride=stride, clamp_overflow=True,
    )
    cpeak = torch.argmax(coarse)
    # Fine window: the coarse argmax bin ±1, aligned down to the stride.
    lo = torch.clamp(cpeak - 1, min=0) * stride
    fine = hist(
        src, dst, active, bins_per_unit=bins_per_unit, num_bins=3 * stride,
        lo_bin=lo, stride=1, clamp_overflow=False,
    )
    fpeak = torch.argmax(fine)
    peak_count = fine.index_select(0, fpeak.reshape(1))[0]
    # Certificate: every fine bin under coarse bin k counts at most
    # coarse[k]. The last coarse bin holds the whole clamped tail, so it
    # bounds no single fine bin: it is never "inside the window", and a
    # coarse argmax on it is never certified.
    ar = torch.arange(num_bins, device=coarse.device)
    in_window = (torch.abs(ar - cpeak) <= 1) & (ar < num_bins - 1)
    outside_max = torch.where(in_window, torch.zeros_like(coarse), coarse).max()
    certified = (outside_max < torch.clamp(peak_count, min=1)) & (cpeak < num_bins - 1)
    return lo + fpeak, peak_count, certified


def exact_peak_bin(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor | None = None,
    bins_per_unit: int = 20,
    num_bins: int = 128,
    stride: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact global-argmax fine bin from a coarse pass (num_bins bins of
    `stride` fine bins, tail clamped) and a fine pass over the coarse
    argmax ±1 (rules of pallas_hist.py:317-344). Returns (peak fine bin,
    its count, certified): `certified` is false when a coarse bin outside
    the refined window could hold a larger fine bin, or the coarse argmax
    is the clamp bin; the caller then falls back. All three are 0-d
    tensors on the input's device; nothing is read on the host."""
    return _exact_peak_bin(
        pair_ratio_histogram, src, dst, active, bins_per_unit, num_bins, stride
    )


def exact_peak_bin_reference(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor | None = None,
    bins_per_unit: int = 20,
    num_bins: int = 128,
    stride: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`exact_peak_bin` over the plain histogram on any device."""
    return _exact_peak_bin(
        pair_ratio_histogram_reference, src, dst, active, bins_per_unit, num_bins, stride
    )
