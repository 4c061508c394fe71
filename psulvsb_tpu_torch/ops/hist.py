"""Pair-grid sweeps of the init stage: the ratio histogram
(`csrc/pair_ratio_hist.cu`) and the known-scale window count
(`csrc/pair_beta_count.cu`), each with its plain PyTorch version, and
`exact_peak_bin`, the two-pass exact histogram peak read off one
full-resolution pass (on the card, one launch of the histogram kernel).

The functions keep the signatures of the JAX package's front doors
(psulvsb_tpu/ops/pallas_hist.py): points as (3, C), an optional (C,)
active mask, pairs i < j with both ends active. Distances come from direct
differences (s_j - s_i), the squares summed x, y, z; the kernels compute
them bit for bit as the plain versions do, so counts are equal, and exact
64-bit integers (the Pallas kernels accumulate in float32).

Each front door also takes a pair axis, (P, 3, C) clouds and a (P, C)
mask, for P pairs at once: one launch, one zero fill and each pair's result
(its window's counts, its count, or its (peak, count, certified)). Each is
a PyTorch custom operator with a vmap rule that moves the vmapped axis into
that pair axis (ops/_axis.py), so `torch.func.vmap` over a solve
(solver/fused.py's batched plan) makes one launch for all its pairs, as
`jax.vmap` over the JAX package's front doors does.

Which version runs is decided by where the tensors lie: CPU tensors take
the plain versions; CUDA tensors launch the kernels (`ops._build.launch`)
or raise.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_longlong, c_void_p

import torch

from psulvsb_tpu_torch.ops._axis import (
    as_pairs,
    check_active,
    join_args,
    join_pairs,
    kernel_clouds,
    register_pair_vmap,
    split_pairs,
)
from psulvsb_tpu_torch.ops._build import launch

MAX_BINS = 4096  # the histogram kernel keeps its bins in 16 KB of shared memory
MAX_COARSE_BINS = 2048  # exact_peak_bin's coarse counts reuse that memory as int64
_FINE_CAP = float(1 << 30)  # fine bins past 2^30 fall outside every window
_ROW_CHUNK = 1024  # rows per step of the plain versions' sweep
# pair_ratio_hist_launch: src, dst, mask (null: all active), C,
# bins_per_unit, lo pointer (null: lo_imm), lo_imm, lo step (0: one lo for
# every pair, 1: a lo a pair), stride, num_bins, clamp, pairs, the words
# between two pairs' counts, counts, block counter, coarse bins, coarse
# stride, peak out, count out, certified out, stream.
_HIST_ARGTYPES = (
    [c_void_p] * 3 + [c_int, c_float, c_void_p, c_longlong] + [c_int] * 5 + [c_longlong]
    + [c_void_p] * 2 + [c_int] * 2 + [c_void_p] * 4
)
# pair_beta_count_launch: src, dst, mask (null: all active), C, pairs, beta,
# counts, stream.
_BETA_ARGTYPES = [c_void_p] * 3 + [c_int, c_int, c_float, c_void_p, c_void_p]


def _pair_sweep(src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor):
    """Yield (v1, v2, valid) over row blocks of the pair grid of (..., 3, C)
    clouds: source and destination distances of rows [r0, r1) against
    columns [r0, C), and the mask of active pairs i < j, each (..., rows,
    cols). Distances are sqrt((dx dx + dy dy) + dz dz) of direct
    differences, in float32."""
    c = src.shape[-1]
    s = src.to(torch.float32)
    d = dst.to(torch.float32)
    cols = torch.arange(c, device=src.device)

    def dist(p, r0, r1):
        e = p[..., None, r0:] - p[..., r0:r1, None]  # (..., 3, rows, cols): p_j - p_i
        x, y, z = e.unbind(-3)
        return torch.sqrt((x * x + y * y) + z * z)

    for r0 in range(0, c, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, c)
        rows = cols[r0:r1]
        valid = ((rows[:, None] < cols[None, r0:]) & active[..., r0:r1, None]
                 & active[..., None, r0:])
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
    """Plain PyTorch version of `pair_ratio_histogram`; (P, 3, C) clouds and
    a (P, C) mask give (P, num_bins) counts, a pair's row what its call
    alone gives (`lo_bin` one for all, or a (P,) tensor, a lo a pair)."""
    active = check_active(src, dst, active, pairs=src.dim() == 3)
    _check_window(num_bins, stride)
    lo = torch.as_tensor(lo_bin, device=src.device).to(torch.int64)
    lo = lo.reshape(lo.shape + (1, 1))  # against (..., rows, cols)
    lead = src.shape[:-2]
    counts = torch.zeros(lead + (num_bins + 1,), dtype=torch.int64, device=src.device)
    for v1, v2, valid in _pair_sweep(src, dst, active):
        idx, inside = _bin_indices(v1, v2, bins_per_unit, lo, stride, num_bins)
        counted = valid if clamp_overflow else valid & inside
        # Pairs that do not count go to a spare bin past the window.
        slot = torch.where(counted, idx, torch.full_like(idx, num_bins)).reshape(lead + (-1,))
        counts.scatter_add_(-1, slot, torch.ones_like(slot))
    return counts[..., :num_bins]


def pair_beta_count_reference(
    src: torch.Tensor,
    dst: torch.Tensor,
    beta: float,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of `pair_beta_count`; (P, 3, C) clouds give (P,)
    counts."""
    active = check_active(src, dst, active, pairs=src.dim() == 3)
    beta32 = torch.full((), beta, dtype=torch.float32, device=src.device)
    total = torch.zeros(src.shape[:-2], dtype=torch.int64, device=src.device)
    for v1, v2, valid in _pair_sweep(src, dst, active):
        total = total + ((torch.abs(v1 - v2) <= beta32) & valid).sum((-2, -1))
    return total


def _check_lo(lo: torch.Tensor, pairs: int) -> None:
    """A window's lo on the device is one for all pairs (0-d) or one a pair
    ((pairs,)); any other shape raises, on the CPU as on a card."""
    if lo.dim() != 0 and tuple(lo.shape) != (pairs,):
        raise ValueError(f"lo_bin is a 0-d tensor or one a pair, ({pairs},), "
                         f"got shape {tuple(lo.shape)}")


def _launch_hist(src, dst, active, bins_per_unit, num_bins, lo_bin, stride, clamp_overflow,
                 counts, peak=None, pairs=1, row=0):
    """One launch of csrc/pair_ratio_hist.cu adding into `counts`; `peak`:
    device addresses and window of exact_peak_bin's full pass (block
    counter, coarse bins, coarse stride, peak out, count out, certified
    out), or None. With `pairs` > 1 the clouds are (pairs, 3, C), the mask
    (pairs, C), and each pair's counts and counter lie `row` words after the
    previous pair's; a (pairs,) `lo_bin` tensor gives each pair its lo."""
    dev = src.device
    s, d, a = kernel_clouds(src, dst, active, src.dim() == 3)
    lo_step = 0
    if isinstance(lo_bin, torch.Tensor):
        _check_lo(lo_bin, pairs)
        lo = lo_bin.to(device=dev, dtype=torch.int64).contiguous()
        lo_ptr, lo_imm, lo_step = lo.data_ptr(), 0, int(lo.dim() == 1)
    else:
        lo_ptr, lo_imm = None, int(lo_bin)
    done, coarse_bins, coarse_stride, out, count, cert = peak or (None, 0, 0, None, None, None)
    launch(
        "pair_ratio_hist", _HIST_ARGTYPES, dev,
        s.data_ptr(), d.data_ptr(), None if a is None else a.data_ptr(), s.shape[-1],
        float(bins_per_unit), lo_ptr, lo_imm, lo_step, stride, num_bins,
        int(bool(clamp_overflow)),
        pairs, row, counts.data_ptr(), done, coarse_bins, coarse_stride, out, count, cert,
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
    kernel (no fallback).

    A pair axis: (P, 3, C) clouds and an optional (P, C) mask give
    (P, num_bins) counts from one launch, with one lo for all or a (P,)
    `lo_bin`, a lo a pair (`torch.func.vmap` over the (3, C) form comes
    here too, through the operator's vmap rule)."""
    _check_window(num_bins, stride)
    src, dst, active, single = as_pairs(src, dst, active)
    lo = lo_bin if isinstance(lo_bin, torch.Tensor) else None
    counts = torch.ops.psulvsb_tpu_torch.pair_ratio_histogram(
        src, dst, active, float(bins_per_unit), int(num_bins), lo,
        0 if lo is not None else int(lo_bin), int(stride), bool(clamp_overflow))
    return counts[0] if single else counts


@torch.library.custom_op("psulvsb_tpu_torch::pair_ratio_histogram", mutates_args=())
def _pair_ratio_histogram_pairs(
    src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor | None, bins_per_unit: float,
    num_bins: int, lo: torch.Tensor | None, lo_imm: int, stride: int, clamp_overflow: bool,
) -> torch.Tensor:
    """`pair_ratio_histogram` over (P, 3, C) clouds, the window from `lo`
    (() or (P,), on the device) or else `lo_imm`: the plain version on the
    CPU, one launch of the kernel for the P pairs on a card."""
    lo_bin = lo_imm if lo is None else lo
    if lo is not None:
        _check_lo(lo, src.shape[0])
    if not src.is_cuda:
        return pair_ratio_histogram_reference(
            src, dst, active, bins_per_unit, num_bins, lo_bin, stride, clamp_overflow
        )
    p = src.shape[0]
    counts = torch.zeros((p, num_bins), dtype=torch.int64, device=src.device)
    _launch_hist(src, dst, active, bins_per_unit, num_bins, lo_bin, stride, clamp_overflow,
                 counts, pairs=p, row=num_bins)
    return counts


@_pair_ratio_histogram_pairs.register_vmap
def _pair_ratio_histogram_vmap(info, in_dims, src, dst, active, bins_per_unit, num_bins, lo,
                               lo_imm, stride, clamp_overflow):
    """ops/_axis.py's rule, and a vmapped lo becomes a lo a pair, which the
    kernel reads per pair."""
    n = info.batch_size
    src, dst, active = join_args((src, dst, active), in_dims, n)
    if lo is not None:
        if in_dims[5] is None:
            if lo.dim() == 1:  # a lo a pair, the same for every vmapped call
                lo = join_pairs(lo, None, n)
        elif lo.dim() == 1:  # a lo for each vmapped call, shared by its pairs
            lo = lo[:, None].expand(n, src.shape[0] // n).flatten()
        else:
            lo = join_pairs(lo, in_dims[5], n)
    counts = _pair_ratio_histogram_pairs(src, dst, active, bins_per_unit, num_bins, lo, lo_imm,
                                         stride, clamp_overflow)
    return split_pairs(counts, n)


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
    fallback).

    A pair axis: (P, 3, C) clouds and an optional (P, C) mask give (P,)
    counts from one launch and one zero fill (`torch.func.vmap` over the
    (3, C) form comes here too, through the operator's vmap rule)."""
    src, dst, active, single = as_pairs(src, dst, active)
    count = torch.ops.psulvsb_tpu_torch.pair_beta_count(src, dst, active, float(beta))
    return count[0] if single else count


@torch.library.custom_op("psulvsb_tpu_torch::pair_beta_count", mutates_args=())
def _pair_beta_count_pairs(
    src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor | None, beta: float,
) -> torch.Tensor:
    """`pair_beta_count` over (P, 3, C) clouds: the plain version on the CPU,
    one launch of the kernel for the P pairs on a card."""
    if not src.is_cuda:
        return pair_beta_count_reference(src, dst, beta, active)
    dev = src.device
    s, d, a = kernel_clouds(src, dst, active, pairs=True)
    p = s.shape[0]
    counts = torch.zeros(p, dtype=torch.int64, device=dev)
    launch("pair_beta_count", _BETA_ARGTYPES, dev,
           s.data_ptr(), d.data_ptr(), None if a is None else a.data_ptr(), s.shape[-1], p,
           float(beta), counts.data_ptr())
    return counts


register_pair_vmap(_pair_beta_count_pairs, 3)


def _check_peak_window(num_bins: int, stride: int) -> int:
    """Validate exact_peak_bin's window; return the bins of its full pass,
    (num_bins + 1) stride + 1."""
    full = (num_bins + 1) * stride + 1
    if num_bins < 2 or stride < 1 or num_bins > MAX_COARSE_BINS or full > MAX_BINS:
        raise ValueError(
            f"exact_peak_bin needs 2 <= num_bins <= {MAX_COARSE_BINS}, stride >= 1 and "
            f"(num_bins + 1) stride + 1 <= {MAX_BINS}, got num_bins={num_bins}, stride={stride}"
        )
    return full


def _peak_rule(coarse, fine_from, num_bins, stride):
    """exact_peak_bin's rule (pallas_hist.py:317-344) from the (..., num_bins)
    coarse counts and fine_from(lo), the (..., 3 stride) fine counts from
    fine bin lo."""
    cpeak = torch.argmax(coarse, dim=-1)
    # Fine window: the coarse argmax bin ±1, aligned down to the stride.
    lo = torch.clamp(cpeak - 1, min=0) * stride
    fine = fine_from(lo)
    fpeak = torch.argmax(fine, dim=-1)
    peak_count = fine.gather(-1, fpeak[..., None])[..., 0]
    # Certificate: every fine bin under coarse bin k counts at most
    # coarse[k]. The last coarse bin holds the whole clamped tail, so it
    # bounds no single fine bin: it is never "inside the window", and a
    # coarse argmax on it is never certified.
    ar = torch.arange(num_bins, device=coarse.device)
    in_window = (torch.abs(ar - cpeak[..., None]) <= 1) & (ar < num_bins - 1)
    outside_max = torch.where(in_window, torch.zeros_like(coarse), coarse).amax(-1)
    certified = (outside_max < torch.clamp(peak_count, min=1)) & (cpeak < num_bins - 1)
    return lo + fpeak, peak_count, certified


def peak_from_full_histogram(
    full: torch.Tensor, num_bins: int = 128, stride: int = 16
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """exact_peak_bin's (peak, count, certified) from one full-resolution
    histogram (lo 0, stride 1, tail clamped, (num_bins + 1) stride + 1
    bins), or from (P, bins) histograms, one row a pair: coarse bin k <
    num_bins - 1 sums full bins [k stride, (k + 1) stride), the last coarse
    bin sums the rest, and the fine window, which ends at most at
    (num_bins + 1) stride, is read off the full bins. The plain version of
    the derivation the kernel's last block makes."""
    head = (num_bins - 1) * stride
    lead = full.shape[:-1]
    coarse = torch.cat([full[..., :head].reshape(lead + (num_bins - 1, stride)).sum(-1),
                        full[..., head:].sum(-1)[..., None]], dim=-1)
    offsets = torch.arange(3 * stride, device=full.device)
    return _peak_rule(coarse, lambda lo: full.gather(-1, lo[..., None] + offsets), num_bins,
                      stride)


def exact_peak_bin(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor | None = None,
    bins_per_unit: int = 20,
    num_bins: int = 128,
    stride: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact global-argmax fine bin by the two-pass rule of
    pallas_hist.py:317-344 (a coarse pass of num_bins bins of `stride` fine
    bins, tail clamped, then a fine pass over the coarse argmax ±1), read
    off one full-resolution pass (`peak_from_full_histogram`). Returns
    (peak fine bin, its count, certified): `certified` is false when a
    coarse bin outside the refined window could hold a larger fine bin, or
    the coarse argmax is the clamp bin; the caller then falls back. All
    three are 0-d tensors on the input's device; nothing is read on the
    host. CPU tensors run the plain full pass and derivation; CUDA tensors
    one kernel launch, whose last block derives the three (no fallback).

    A pair axis: (P, 3, C) clouds and an optional (P, C) mask give the three
    as (P,) tensors, each pair's what its call alone gives, from one launch
    (`torch.func.vmap` over the (3, C) form comes here too, through the
    operator's vmap rule)."""
    _check_peak_window(num_bins, stride)
    src, dst, active, single = as_pairs(src, dst, active)
    peak, count, certified = torch.ops.psulvsb_tpu_torch.exact_peak_bin(
        src, dst, active, int(bins_per_unit), int(num_bins), int(stride))
    if single:
        return peak[0], count[0], certified[0]
    return peak, count, certified


@torch.library.custom_op("psulvsb_tpu_torch::exact_peak_bin", mutates_args=())
def _exact_peak_bin_pairs(
    src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor | None, bins_per_unit: int,
    num_bins: int, stride: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`exact_peak_bin` over (P, 3, C) clouds: the plain full pass and
    derivation on the CPU, one launch of the histogram kernel on a card."""
    full_bins = _check_peak_window(num_bins, stride)
    if not src.is_cuda:
        full = pair_ratio_histogram_reference(
            src, dst, active, bins_per_unit, full_bins, 0, 1, clamp_overflow=True
        )
        return peak_from_full_histogram(full, num_bins, stride)
    dev = src.device
    p = src.shape[0]
    # A row a pair: its full counts, then its block counter (a uint32 in an
    # int64 slot); one zero fill for every pair.
    buf = torch.zeros((p, full_bins + 1), dtype=torch.int64, device=dev)
    peak = torch.empty(p, dtype=torch.int64, device=dev)
    count = torch.empty(p, dtype=torch.int64, device=dev)
    certified = torch.empty(p, dtype=torch.bool, device=dev)
    _launch_hist(
        src, dst, active, bins_per_unit, full_bins, 0, 1, True, buf,
        peak=(buf.data_ptr() + 8 * full_bins, num_bins, stride, peak.data_ptr(),
              count.data_ptr(), certified.data_ptr()),
        pairs=p, row=full_bins + 1,
    )
    return peak, count, certified


register_pair_vmap(_exact_peak_bin_pairs, 3)


def exact_peak_bin_reference(
    src: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor | None = None,
    bins_per_unit: int = 20,
    num_bins: int = 128,
    stride: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-pass exact_peak_bin over the plain histogram, on any device:
    a coarse pass and a fine pass."""
    _check_peak_window(num_bins, stride)
    coarse = pair_ratio_histogram_reference(
        src, dst, active, bins_per_unit=bins_per_unit, num_bins=num_bins,
        lo_bin=0, stride=stride, clamp_overflow=True,
    )

    def fine_from(lo):
        return pair_ratio_histogram_reference(
            src, dst, active, bins_per_unit=bins_per_unit, num_bins=3 * stride,
            lo_bin=lo, stride=1, clamp_overflow=False,
        )

    return _peak_rule(coarse, fine_from, num_bins, stride)
