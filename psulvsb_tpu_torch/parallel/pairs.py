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
  the counterpart of its `vmap` on one card: the same on PAIRS_IN_FLIGHT
  plan instances, each with a CUDA stream of its own, the pairs dealt to
  them in turn, so that several solves share the card;
- `register_batch_sharded`, several devices: the batch split evenly over
  them, and the totals summed as the JAX package's `psum` sums them.
"""

from __future__ import annotations

import torch

from psulvsb_tpu_torch.solver.config import SolverParams
from psulvsb_tpu_torch.solver.fused import as_generator, plan_for, resolve_device, stage_inputs
from psulvsb_tpu_torch.solver.solution import RegistrationSolution
from psulvsb_tpu_torch.utils.precision import pin_float32

PAIRS_IN_FLIGHT = 4  # plan instances (and streams) of the concurrent form


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
    which synchronizes). vectorized: deal the pairs to up to PAIRS_IN_FLIGHT
    plan instances, each on its own stream. On the CPU the pairs simply run
    in turn."""
    device = resolve_device(device)
    pin_float32()
    params.check_port_supported()
    src, dst, keep = stage_inputs(src_batch, dst_batch, keep_batch, device)
    if src.dim() != 3:
        raise ValueError(f"register_batch takes (B, 3, C) clouds, got {tuple(src.shape)}")
    b, _, c = src.shape
    seeds = list(seeds_or_generators)
    if len(seeds) != b:
        raise ValueError(f"{b} pairs need {b} seeds or generators, got {len(seeds)}")
    gens = [as_generator(s, device) for s in seeds]
    out = _empty_solution(b, device)
    if not vectorized:
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
        plan.solve(src[i], dst[i], keep[i], gens[i])
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
