"""The dense init's reduced pool: the CUDA kernel `csrc/dense_init.cu` and
its plain PyTorch version.

`dense_init` is the membership test and compaction of the solver's dense
init (solver/psulvsb.py `_init_stage_dense`, the JAX package's
psulvsb_tpu/solver/psulvsb.py:320): over every pair i < j of points whose
keep is 1, the known-scale test |v1 - v2| <= beta, or, given the histogram
`peak`, the estimated-scale test (ratio bin within 1 of it), with v the
pair's distance from ‖a-b‖² = ‖a‖² + ‖b‖² - 2ab in float32; then the top k =
min(fill, C²) members by the float32 of a uint32 hash of the flat position
i C + j seeded by the two constants `ab`, in pool slots padded with zeros
to pool_cap. Returns (red_i (pool_cap,), red_j (pool_cap,), red_count (),
pool_count ()): red_count = min(members, reduced_cap), pool_count =
min(members, k).

The plain version builds the (C, C) grid (two matrix products, the hash in
int64, a top-k over C² priorities); the kernel holds no (C, C) array: it
recomputes the test from the points in each pass, finds from a histogram of
the members' hashes a threshold that keeps every member of the top k and
at most 2047 others, and ranks those by (priority descending, position
ascending), the order of lax.top_k. The two agree but
for pairs at the window's edge (the card's matrix product sums in another
order) and the order inside a run of equal priorities, which the plain
version's top-k leaves open.

A pair axis, as the other kernels have one: (P, 3, C) clouds, (P, C) keep,
(P, 2) hash constants and a (P,) peak give P pools from one launch. The
front door calls a PyTorch custom operator whose vmap rule moves the
vmapped axis into that pair axis (ops/_axis.py), so `torch.func.vmap` over
the init (solver/fused.py's batched plan) makes one launch for all its
pairs.

Which version runs is decided by where the tensors lie: CPU tensors take
the plain version; CUDA tensors launch the kernel (`ops._build.launch`) or
raise.
"""

from __future__ import annotations

import functools
from ctypes import c_float, c_int, c_longlong, c_void_p

import torch

from psulvsb_tpu_torch.ops._axis import check_clouds, over_pairs, register_pair_vmap
from psulvsb_tpu_torch.ops._build import launch, load_library
from psulvsb_tpu_torch.solver.config import DENSE_INIT_MAX_C as MAX_C
from psulvsb_tpu_torch.solver.config import DENSE_INIT_MAX_FILL as MAX_FILL
from psulvsb_tpu_torch.utils.precision import mm

# dense_init_launch: src, dst, keep, ab, peak (null: known scale), C, pairs,
# beta, bins_per_unit, num_bins, k, pool_cap, reduced_cap, workspace, its
# words a pair, red_i, red_j, red_count, pool_count, stream.
_ARGTYPES = (
    [c_void_p] * 5 + [c_int, c_int, c_float, c_int, c_int, c_int, c_int, c_longlong, c_void_p,
                      c_longlong] + [c_void_p] * 5
)
_HASH_MUL = 0x45D9F3B
_M32 = 0xFFFFFFFF


def pdist(points: torch.Tensor) -> torch.Tensor:
    """(C, C) distances of the (3, C) points from ‖a-b‖² = ‖a‖² + ‖b‖² - 2ab
    with one float32 matmul, the form the JAX package takes."""
    m = points.T.to(torch.float32)
    n = (m * m).sum(1)
    g = mm(m, m.T)
    return torch.sqrt(torch.clamp(n[:, None] + n[None, :] - 2.0 * g, min=0.0))


def float_bins(x: torch.Tensor, num_bins: int) -> torch.Tensor:
    """clip(int(floor(x)), 0, num_bins - 1), clipped in float first so that
    the integer cast never overflows (the JAX cast saturates, which lands
    in the same edge bin)."""
    return torch.clamp(torch.floor(x), -1.0, float(num_bins)).to(torch.int64).clamp(0, num_bins - 1)


def pool_size(c: int, fill: int) -> int:
    """k: the members the pool takes at most, min(fill, C²)."""
    return min(fill, c * c)


def hash_priority(pos: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """The float32 priority of int64 flat positions i C + j: their uint32
    hash seeded by the constants `ab`, computed in int64 with a 32-bit mask
    after each multiply."""
    ab = ab.to(device=pos.device, dtype=torch.int64)
    h = (pos * (ab[0] | 1) + ab[1]) & _M32
    h = h ^ (h >> 16)
    h = (h * _HASH_MUL) & _M32
    h = h ^ (h >> 16)
    return h.to(torch.float32)


def dense_init_reference(
    src: torch.Tensor,
    dst: torch.Tensor,
    keep: torch.Tensor,
    ab: torch.Tensor,
    peak: torch.Tensor | None,
    beta: float,
    bins_per_unit: int,
    num_bins: int,
    fill: int,
    pool_cap: int,
    reduced_cap: int,
):
    """Plain PyTorch version of `dense_init` for one (3, C) pair, over the
    dense (C, C) grid."""
    c = src.shape[1]
    dev = src.device
    active = keep == 1
    v1 = pdist(src)
    v2 = pdist(dst)
    iu = torch.arange(c, device=dev)
    valid = (iu[:, None] < iu[None, :]) & active[:, None] & active[None, :]
    if peak is not None:
        ratio = v2 / torch.where(v1 > 0, v1, torch.ones_like(v1))
        bins = float_bins(ratio * bins_per_unit, num_bins)
        member = (torch.abs(bins - peak) <= 1) & valid
    else:
        member = (torch.abs(v1 - v2) <= beta) & valid
    red_count = torch.clamp(member.sum(), max=reduced_cap)

    pri = torch.where(member, hash_priority(iu[:, None] * c + iu[None, :], ab), -1.0).reshape(-1)
    k = pool_size(c, fill)
    vals, idx = torch.topk(pri, k, sorted=True)
    if k < pool_cap:
        vals = torch.cat([vals, vals.new_full((pool_cap - k,), -1.0)])
        idx = torch.cat([idx, idx.new_zeros(pool_cap - k)])
    ok = vals >= 0.0
    zero = torch.zeros_like(idx)
    red_i = torch.where(ok, idx // c, zero)
    red_j = torch.where(ok, idx % c, zero)
    return red_i, red_j, red_count, ok.sum()


def dense_init(
    src: torch.Tensor,
    dst: torch.Tensor,
    keep: torch.Tensor,
    ab: torch.Tensor,
    peak: torch.Tensor | None,
    beta: float,
    bins_per_unit: int,
    num_bins: int,
    fill: int,
    pool_cap: int,
    reduced_cap: int,
):
    """The dense init's pool (module docstring) of a (3, C) pair: keep (C,)
    (members need keep == 1 at both ends), ab (2,) hash constants, peak a
    0-d int64 bin (estimated scale) or None (known scale, the beta test).
    CPU tensors run the plain version; CUDA tensors the kernel (no
    fallback), which takes C <= 2^16 and k <= 2^15.

    A pair axis: (P, 3, C) clouds, (P, C) keep, (P, 2) ab and a (P,) peak
    give (P, pool_cap) indices and (P,) counts from one launch
    (`torch.func.vmap` over the (3, C) form comes here too, through the
    operator's vmap rule)."""
    single = src.dim() == 2
    check_clouds(src, dst, pairs=not single)
    lead = src.shape[:-2]
    if tuple(keep.shape) != tuple(lead) + (src.shape[-1],) or keep.device != src.device:
        raise ValueError(f"keep must be {tuple(lead) + (src.shape[-1],)} on {src.device}, got "
                         f"{tuple(keep.shape)} on {keep.device}")
    if tuple(ab.shape) != tuple(lead) + (2,):
        raise ValueError(f"ab must be {tuple(lead) + (2,)}, got {tuple(ab.shape)}")
    if peak is not None and tuple(peak.shape) != tuple(lead):
        raise ValueError(f"peak must be {tuple(lead)}, got {tuple(peak.shape)}")
    if fill < 1 or pool_cap < fill:
        raise ValueError(f"the pool needs 1 <= fill <= pool_cap, got {fill} and {pool_cap}")
    if single:
        src, dst, keep, ab = src[None], dst[None], keep[None], ab[None]
        peak = None if peak is None else peak[None]
    out = torch.ops.psulvsb_tpu_torch.dense_init(
        src, dst, keep, ab, peak, float(beta), int(bins_per_unit), int(num_bins), int(fill),
        int(pool_cap), int(reduced_cap))
    return tuple(t[0] for t in out) if single else out


@functools.cache
def _workspace_words(k: int) -> int:
    fn = load_library("dense_init").dense_init_workspace_words
    fn.restype = c_longlong
    fn.argtypes = [c_int]
    return int(fn(k))


@torch.library.custom_op("psulvsb_tpu_torch::dense_init", mutates_args=())
def _dense_init_pairs(
    src: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor, ab: torch.Tensor,
    peak: torch.Tensor | None, beta: float, bins_per_unit: int, num_bins: int, fill: int,
    pool_cap: int, reduced_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`dense_init` over P pairs: the plain version on the CPU (vmapped
    over the pairs), one launch of the kernel for the P pairs on a card."""
    p, _, c = src.shape
    if not src.is_cuda:
        one = functools.partial(
            dense_init_reference, beta=beta, bins_per_unit=bins_per_unit, num_bins=num_bins,
            fill=fill, pool_cap=pool_cap, reduced_cap=reduced_cap)
        return over_pairs(one, p, src, dst, keep, ab, peak)
    k = pool_size(c, fill)
    if c > MAX_C or k > MAX_FILL:
        raise ValueError(f"the dense init kernel takes C <= {MAX_C} and a fill of at most "
                         f"{MAX_FILL} members, got C = {c} and {k}")
    dev = src.device
    i64 = torch.int64
    s = src.to(torch.float32).contiguous()
    d = dst.to(torch.float32).contiguous()
    kp = keep.to(i64).contiguous()
    a = ab.to(device=dev, dtype=i64).contiguous()
    pk = None if peak is None else peak.to(device=dev, dtype=i64).contiguous()
    words = _workspace_words(k)
    ws = torch.empty(p * words, dtype=torch.int32, device=dev)
    red_i = torch.empty((p, pool_cap), dtype=i64, device=dev)
    red_j = torch.empty((p, pool_cap), dtype=i64, device=dev)
    red_count = torch.empty(p, dtype=i64, device=dev)
    pool_count = torch.empty(p, dtype=i64, device=dev)
    launch(
        "dense_init", _ARGTYPES, dev,
        s.data_ptr(), d.data_ptr(), kp.data_ptr(), a.data_ptr(),
        None if pk is None else pk.data_ptr(), c, p, float(beta), int(bins_per_unit),
        int(num_bins), k, int(pool_cap), int(reduced_cap), ws.data_ptr(), words,
        red_i.data_ptr(), red_j.data_ptr(), red_count.data_ptr(), pool_count.data_ptr(),
    )
    return red_i, red_j, red_count, pool_count


register_pair_vmap(_dense_init_pairs, 5)
