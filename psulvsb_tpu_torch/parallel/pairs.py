"""Many registration pairs in one call (counterpart of
psulvsb_tpu/parallel/pairs.py).

The reference solves its dataset sweeps pair by pair (1623 3DMatch pairs,
555 KITTI pairs, teaser_cpp_ply_main.cc:244-795). One pair fits one card
and no pair talks to another, so the scaling axis is the pair batch:

- `register_batch`, one device. By default the pairs run in order through
  one plan of the one-dispatch solve on one stream (`lax.map` in the JAX
  package): for each pair its inputs and draws are staged, the plan's graph
  launched once and the solution copied into the batch's row, with no host
  synchronization from the first pair to the return. `vectorized=True` is
  the counterpart of its `vmap`, for every setting: the pairs in chunks of
  P, each chunk one batched program (a plan with a pair axis,
  `ReplayPlan(pairs=P)`: one graph launch a chunk, its kernels one launch
  for the P pairs). `_register_in_flight` keeps a third form to compare
  with: PAIRS_IN_FLIGHT single-pair plan instances, each with a CUDA stream
  of its own, the pairs dealt to them in turn;
- `register_batch_sharded`, several devices: the batch split evenly over
  them, and the totals summed as the JAX package's `psum` sums them.
"""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.solver.config import SolverParams
from psulvsb_tpu_torch.solver.fused import (
    as_generator,
    plan_bytes,
    plan_for,
    resolve_device,
    stage_inputs,
)
from psulvsb_tpu_torch.solver.solution import RegistrationSolution
from psulvsb_tpu_torch.utils import timing
from psulvsb_tpu_torch.utils.precision import pin_float32

PAIRS_IN_FLIGHT = 4  # plan instances (and streams) of the concurrent form
MAX_CHUNK = 32  # most pairs of one batched program
# The share of the card's memory one batched plan may take, by the estimate
# solver.fused.plan_bytes (plan_for drops cached plans to make room for it).
PLAN_MEMORY_SHARE = 0.5


def pairs_per_chunk(c: int, b: int, device: torch.device, params: SolverParams) -> int:
    """P of the batched form: on a card the largest power of two up to
    min(B, MAX_CHUNK) whose plan, by `plan_bytes` of its route, stays within
    PLAN_MEMORY_SHARE of the card's memory (at least 1); on the CPU the
    whole batch."""
    if device.type != "cuda":
        return b
    budget = PLAN_MEMORY_SHARE * torch.cuda.get_device_properties(device).total_memory
    p = 1
    while 2 * p <= min(b, MAX_CHUNK) and plan_bytes(params, c, 2 * p) <= budget:
        p *= 2
    return p


def make_pair_mesh(devices=None) -> list[torch.device]:
    """The devices a sharded batch is split over: the given ones, or every
    CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_pair_mesh() lists the CUDA devices, and torch.cuda.is_available() is "
                "false; name the devices (for example ['cpu', 'cpu']) to run elsewhere"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("a pair mesh needs at least one device")
    return mesh


def _empty_solution(b: int, device: torch.device) -> RegistrationSolution:
    return RegistrationSolution(
        valid=torch.zeros(b, dtype=torch.bool, device=device),
        scale=torch.zeros(b, dtype=torch.float32, device=device),
        rotation=torch.zeros((b, 3, 3), dtype=torch.float32, device=device),
        translation=torch.zeros((b, 3), dtype=torch.float32, device=device),
        final_inlier_count=torch.zeros(b, dtype=torch.int64, device=device),
    )


def register_batch(
    src_batch,  # (B, 3, C)
    dst_batch,  # (B, 3, C)
    keep_batch,  # (B, C)
    seeds_or_generators,  # B ints or torch.Generators
    params: SolverParams,
    vectorized: bool = False,
    device="cuda",
    graphs: bool = True,
) -> RegistrationSolution:
    """One device's batch of one-dispatch solves; a RegistrationSolution
    whose fields have a leading B. Each pair's result is what
    `psulvsb_register` gives for that pair alone with the same seed, in both
    forms.

    The inputs are staged on the device once for the batch and the results
    written into the batch's tensors there: on a card the host waits for
    nothing before it returns (a plan's first solve captures its graph,
    which synchronizes). vectorized: chunks of `pairs_per_chunk` pairs, each
    one launch of a batched plan (a last, short chunk filled up with
    padding-only pairs, which come back invalid and are dropped), for every
    setting, as JAX's vmap takes any; a plan of the exact clique callback
    runs its batched solve eagerly, as its single-pair plan does. On the CPU
    the chunk is the whole batch.

    With tracing on (`utils.timing`) the call is the host span "batch",
    its parts "batch.stage" and, for each pair or chunk, "batch.solve" (the
    draws and the launch) and "batch.copy" (the solution into the batch's
    rows); the card is stamped at the call's first and last device
    operation (device span "call")."""
    if vectorized not in (False, True):
        raise ValueError(f"vectorized is a bool, got {vectorized!r}")
    form = "batched" if vectorized else "in_order"
    return _register(src_batch, dst_batch, keep_batch, seeds_or_generators, params, form,
                     device, graphs)


def _register_in_flight(src_batch, dst_batch, keep_batch, seeds_or_generators,
                        params: SolverParams, device="cuda", graphs: bool = True):
    """The pair batch in a third form, kept to compare the two others with:
    up to PAIRS_IN_FLIGHT single-pair plan instances, each on its own
    stream, the pairs dealt to them in turn (on the CPU in turn)."""
    return _register(src_batch, dst_batch, keep_batch, seeds_or_generators, params,
                     "in_flight", device, graphs)


def _register(src_batch, dst_batch, keep_batch, seeds_or_generators, params, form, device,
              graphs):
    """The pair batch in `form`: "in_order", "in_flight" or "batched"."""
    device = resolve_device(device)
    pin_float32()
    params.check_port_supported()
    with timing.span("batch", form=form):
        with timing.span("batch.stage"):
            timing.device_stamp(device, "call", False)
            src, dst, keep = stage_inputs(src_batch, dst_batch, keep_batch, device)
        out = _solve_pairs(src, dst, keep, seeds_or_generators, params, form, device, graphs)
        timing.device_stamp(device, "call", True)
        return out


def _solve_pairs(src, dst, keep, seeds_or_generators, params, form, device, graphs):
    """`_register`'s pairs, staged on the device: the solves and the
    solutions' copies."""
    if src.dim() != 3:
        raise ValueError(f"register_batch takes (B, 3, C) clouds, got {tuple(src.shape)}")
    b, _, c = src.shape
    seeds = list(seeds_or_generators)
    if len(seeds) != b:
        raise ValueError(f"{b} pairs need {b} seeds or generators, got {len(seeds)}")
    gens = [as_generator(s, device) for s in seeds]
    out = _empty_solution(b, device)
    if form == "batched":
        p = pairs_per_chunk(c, b, device, params)
        plan = plan_for(params, c, device, graphs, pairs=p)
        for start in range(0, b, p):
            n = min(p, b - start)
            rows = slice(start, start + n)
            s, d, k, g = src[rows], dst[rows], keep[rows], gens[rows]
            if n < p:  # padding-only pairs: keep -2 everywhere
                s = torch.cat([s, s.new_zeros((p - n,) + s.shape[1:])])
                d = torch.cat([d, d.new_zeros((p - n,) + d.shape[1:])])
                k = torch.cat([k, k.new_full((p - n, c), -2)])
                g = g + [as_generator(0, device) for _ in range(p - n)]
            with timing.span("batch.solve", pairs=n):
                plan.solve(s, d, k, g)
            with timing.span("batch.copy"):
                plan.solution(out, start, n)
        return out
    if form == "in_order":
        plans = [plan_for(params, c, device, graphs)]
    else:
        plans = [plan_for(params, c, device, graphs, instance=1 + k)
                 for k in range(min(PAIRS_IN_FLIGHT, b))]
    ready = torch.cuda.current_stream(device) if device.type == "cuda" else None
    side = [plan.stream for plan in plans if plan.stream is not None]
    for stream in side:
        stream.wait_stream(ready)  # the staged inputs and `out`
    for i in range(b):
        plan = plans[i % len(plans)]
        with timing.span("batch.solve", pairs=1):
            plan.solve(src[i], dst[i], keep[i], gens[i])
        with timing.span("batch.copy"):
            plan.solution(out, i)
    for stream in side:
        ready.wait_stream(stream)
    return out


def register_batch_sharded(
    mesh,
    src_batch,
    dst_batch,
    keep_batch,
    seeds_or_generators,
    params: SolverParams,
    vectorized: bool = False,
    graphs: bool = True,
):
    """Split the pair batch evenly over the devices of `mesh`
    (`make_pair_mesh`); each device solves its shard with `register_batch`.

    Returns (per-pair solutions, gathered on the first device, and a
    summary dict with the totals over all shards: "valid_pairs" and
    "inlier_sum", the recall aggregation that the JAX package reduces with
    `psum`). Seeds, not generators, when the devices differ in kind from the
    generators'."""
    mesh = make_pair_mesh(mesh)
    src = torch.as_tensor(src_batch)
    dst = torch.as_tensor(dst_batch)
    keep = torch.as_tensor(keep_batch)
    seeds = list(seeds_or_generators)
    b = src.shape[0]
    if b % len(mesh) != 0:
        raise ValueError(f"{b} pairs do not split evenly over {len(mesh)} devices")
    per = b // len(mesh)
    shards = []
    for k, dev in enumerate(mesh):
        rows = slice(k * per, (k + 1) * per)
        shards.append(register_batch(
            src[rows], dst[rows], keep[rows], seeds[rows], params, vectorized=vectorized,
            device=dev, graphs=graphs,
        ))
    home = shards[0].valid.device
    sols = RegistrationSolution(
        *(torch.cat([field.to(home) for field in fields]) for fields in zip(*shards))
    )
    totals = torch.stack([
        torch.stack([s.valid.sum(), s.final_inlier_count.sum()]).to(home) for s in shards
    ]).sum(0)
    return sols, {"valid_pairs": totals[0], "inlier_sum": totals[1]}
