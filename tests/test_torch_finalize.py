"""The finalize of a solve (psulvsb_tpu_torch/ops/finalize.py).

On the CPU the plain chain (`solver.psulvsb._finalize_counted`, whose body
lives in ops/finalize.py) runs on host states recorded from the JAX
package (`tests/data/finalize/states.npz`, written by
`tools/record_finalize_states.py`: the state after each of three host
rounds, at known and estimated scale, and the last one with its final
inliers cut to the sampled best's best column, where the gate stays closed,
and emptied). Its rotation and translation are held to JAX's
`_finalize_stage` on each, its gate equal to JAX's, at both eigen-solvers
("eigh" and the "jacobi" sweeps a CUDA graph holds), which agree with each
other. The count is held to the returned pose's consensus where the refit
is kept, else the host best's count (the JAX package returns the host
best's count always, so no count is compared with it). The front door on
CPU tensors is the plain chain, its pair axis through vmap equals single
calls, malformed inputs raise, and the solver's route takes the chain
wherever the tensors lie on the CPU.

The CUDA cases hold the kernel (csrc/finalize_fit.cu) to the plain chain
on the card at the cells' buckets, C = 2048, 4096, 6144 (5000 real) and
8192, one pair and P = 8 through vmap, at known and estimated scale:
rotations within 1e-6, translations within 1e-6 relative, the gate equal
but where the two RMSEs agree to float32 rounding, counts equal but by
columns whose residual lies within rounding of the threshold (each such
case counted and printed); and a traced plan launches the kernel once a
refined solve. They skip here and need no JAX (`python -m pytest
tests/test_torch_finalize.py -m cuda --noconftest`).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from psulvsb_tpu_torch import SolverParams, psulvsb_register
from psulvsb_tpu_torch.core.metrics import masked_rmse
from psulvsb_tpu_torch.ops import finalize
from psulvsb_tpu_torch.ops._build import LAUNCHES
from psulvsb_tpu_torch.solver import fused
from psulvsb_tpu_torch.solver import psulvsb as ps
from psulvsb_tpu_torch.solver.basic import WarmState

STATES = Path(__file__).parent / "data" / "finalize" / "states.npz"
CASES = ("known_r0", "known_r1", "known_r2", "known_closed", "known_empty",
         "scaled_r0", "scaled_r1", "scaled_r2", "scaled_closed", "scaled_empty")
F32, I64 = torch.float32, torch.int64


@pytest.fixture(scope="module")
def states():
    with np.load(STATES) as data:
        return {k: torch.as_tensor(v) for k, v in data.items()}


def _state(states, name, device="cpu"):
    """(src, dst, HostState, sampled best, thr, JAX's (rotation, translation,
    better)) of a recorded case."""
    r = {k.split("/", 1)[1]: v.to(device) for k, v in states.items()
         if k.startswith(name + "/")}
    false = torch.zeros((), dtype=torch.bool, device=device)
    best = WarmState(r["best_scale"].to(F32), r["best_rotation"].to(F32),
                     r["best_translation"].to(F32), false)
    sampled = WarmState(r["sampled_scale"].to(F32), r["sampled_rotation"].to(F32),
                        r["sampled_translation"].to(F32), false)
    hs = ps.HostState.initial(r["src"].shape[1], r["keep_mask"])._replace(
        inlier_counter=r["inlier_counter"].to(I64), final_inliers=r["final_inliers"].to(I64),
        best=best, best_count=r["best_count"].to(I64))
    jax_out = (r["jax_rotation"], r["jax_translation"], bool(r["jax_better"]))
    return r["src"].to(F32), r["dst"].to(F32), hs, sampled, r["thr"].to(F32), jax_out


def _consensus(src, dst, hs, rotation, translation, thr):
    res = torch.linalg.vector_norm(dst - hs.best.scale * (rotation @ src + translation[:, None]),
                                   dim=0)
    return int(((res <= thr) & (hs.keep_mask > -2)).sum())


def _fit_args(src, dst, hs, sampled, thr):
    return (src, dst, hs.inlier_counter, hs.final_inliers, hs.keep_mask, sampled, hs.best,
            hs.best_count, thr)


@pytest.mark.parametrize("name", CASES)
def test_plain_chain_against_jax(states, name):
    """Both eigen-solvers' chains give JAX's pose and gate; they agree with
    each other; the count is the returned pose's where the refit is kept,
    else the host best's; an empty mask keeps the host best's pose."""
    src, dst, hs, sampled, thr, (j_rot, j_trans, j_better) = _state(states, name)
    params = SolverParams.preset_3dmatch()
    got = {m: ps._finalize_counted(src, dst, hs, sampled, thr, params, rot_method=m)
           for m in ("eigh", "jacobi")}
    for method, (rot, trans, count, refined, rescued) in got.items():
        assert bool(refined) == j_better, method
        assert not bool(rescued)
        np.testing.assert_allclose(rot.numpy(), j_rot.numpy(), atol=1e-4)
        np.testing.assert_allclose(trans.numpy(), j_trans.numpy(), atol=1e-4)
        if bool(refined):
            assert int(count) == _consensus(src, dst, hs, rot, trans, thr)
        else:
            assert int(count) == int(hs.best_count)
            assert torch.equal(rot, hs.best.rotation) and torch.equal(trans, hs.best.translation)
    (r_e, t_e, *_), (r_j, t_j, *_) = got["eigh"], got["jacobi"]
    assert float((r_e - r_j).abs().max()) <= 1e-5
    assert float((t_e - t_j).abs().max()) <= 1e-5 * max(1.0, float(t_e.abs().max()))
    if name.endswith("empty"):
        mask = hs.final_inliers == 1
        assert math.isinf(float(masked_rmse(src, dst, mask, r_j, t_j)))


def test_closed_gate_returns_the_host_best_count(states):
    """Where the refit is not kept, the count is the host best's even when
    its pose's consensus differs."""
    for name in ("known_closed", "scaled_closed"):
        src, dst, hs, sampled, thr, _ = _state(states, name)
        hs = hs._replace(best_count=hs.best_count + 7)
        out = finalize.finalize_fit(*_fit_args(src, dst, hs, sampled, thr))
        assert not bool(out.refined) and int(out.count) == int(hs.best_count)


@pytest.mark.parametrize("name", CASES)
def test_front_door_on_cpu_is_the_plain_chain(states, name):
    src, dst, hs, sampled, thr, _ = _state(states, name)
    params = SolverParams.preset_3dmatch()
    want = ps._finalize_counted(src, dst, hs, sampled, thr, params, rot_method="jacobi")
    got = finalize.finalize_fit(*_fit_args(src, dst, hs, sampled, thr))
    for g, w in zip(got, want[:4]):
        assert torch.equal(g, w)
    # The solver's route on CPU tensors: the chain, with or without the rescue.
    for rescue in (False, True):
        p = dataclasses.replace(params, translation_rescue=rescue)
        chain = ps._finalize_counted(src, dst, hs, sampled, thr, p, rot_method="jacobi")[:3]
        for g, w in zip(ps._finalize_pose(src, dst, hs, sampled, thr, p, rot_method="jacobi"),
                        chain):
            assert torch.equal(g, w)


@pytest.mark.parametrize("tag", ["known", "scaled"])
def test_pair_axis_through_vmap_equals_single_calls(states, tag):
    cases = [_state(states, n) for n in CASES if n.startswith(tag)]
    singles = [finalize.finalize_fit(*_fit_args(*c[:5])) for c in cases]

    def stack(get):
        return torch.stack([get(c) for c in cases])

    args = (stack(lambda c: c[0]), stack(lambda c: c[1]), stack(lambda c: c[2].inlier_counter),
            stack(lambda c: c[2].final_inliers), stack(lambda c: c[2].keep_mask),
            stack(lambda c: c[3].scale), stack(lambda c: c[3].rotation),
            stack(lambda c: c[3].translation), stack(lambda c: c[2].best.scale),
            stack(lambda c: c[2].best.rotation), stack(lambda c: c[2].best.translation),
            stack(lambda c: c[2].best_count), stack(lambda c: c[4]))

    def one(s, d, cnt, fin, kp, ss, sr, st, bs, br, bt, bc, th):
        false = torch.zeros((), dtype=torch.bool)
        return tuple(finalize.finalize_fit(s, d, cnt, fin, kp, WarmState(ss, sr, st, false),
                                           WarmState(bs, br, bt, false), bc, th))

    # The plain version under vmap takes batched float32 products, whose
    # sums may round otherwise: the pose within 1e-6, the rest equal.
    batched = torch.func.vmap(one)(*args)
    direct = one(*args)  # the (P, ...) form of the front door
    for q, single in enumerate(singles):
        for k, z in enumerate(single):
            for x in (batched[k][q], direct[k][q]):
                if k < 2:
                    assert float((x - z).abs().max()) <= 1e-6
                else:
                    assert torch.equal(x, z)


def test_malformed_inputs_raise(states):
    src, dst, hs, sampled, thr, _ = _state(states, "known_r2")
    args = list(_fit_args(src, dst, hs, sampled, thr))
    bad = [(1, dst[:, :-1]), (2, hs.inlier_counter[:-1]), (4, hs.keep_mask[None]),
           (5, sampled._replace(rotation=sampled.rotation[:2])),
           (6, hs.best._replace(translation=hs.best.translation[None])),
           (7, hs.best_count[None]), (8, thr[None])]
    for i, value in bad:
        broken = list(args)
        broken[i] = value
        with pytest.raises(ValueError):
            finalize.finalize_fit(*broken)
    with pytest.raises(ValueError):
        finalize.finalize_fit(src[:2], *args[1:])


# ---- on the card ----------------------------------------------------------------

BUCKETS = [(2048, 2048), (4096, 4096), (6144, 5000), (8192, 8192)]  # (C, real points)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _card_state(c, real, seed, device, scaled, closed=False):
    from chip_smoke import finalize_inputs

    return finalize_inputs(c, real, seed, device, scaled, closed)


def _near_threshold(args, rotation, translation):
    """Real columns whose residual under the returned pose lies within
    float32 rounding of thr."""
    src, dst, _, _, keep, _, best, _, thr = args
    res = torch.linalg.vector_norm(dst - best.scale * (rotation @ src + translation[:, None]),
                                   dim=0)
    return int(((res - thr).abs() <= 1e-5 * thr.abs() + 1e-6)[keep > -2].sum())


def _agree(got, want, args) -> tuple[int, int]:
    """Hold the kernel's result to the chain's; (gate cases decided within
    rounding, count cases off by columns within rounding of thr)."""
    src, dst, _, final, _, sampled, _, _, _ = args
    if bool(got.refined) != bool(want.refined):
        s = torch.where(sampled.scale > 0, sampled.scale, torch.ones_like(sampled.scale))
        mask = final == 1
        adj = masked_rmse(src, dst, mask, got.rotation if bool(got.refined) else
                             want.rotation, got.translation if bool(got.refined) else
                             want.translation, scale=s)
        ori = masked_rmse(src, dst, mask, sampled.rotation, sampled.translation, scale=s)
        assert abs(float(adj) - float(ori)) <= 1e-5 * float(ori) + 1e-7, (float(adj), float(ori))
        return 1, 0
    assert float((got.rotation - want.rotation).abs().max()) <= 1e-6
    scale = max(1.0, float(want.translation.abs().max()))
    assert float((got.translation - want.translation).abs().max()) <= 1e-6 * scale
    if int(got.count) != int(want.count):
        near = _near_threshold(args, got.rotation, got.translation)
        assert abs(int(got.count) - int(want.count)) <= near
        return 0, 1
    return 0, 0


@pytest.mark.cuda
@pytest.mark.parametrize("c,real", BUCKETS)
@pytest.mark.parametrize("scaled", [False, True])
def test_cuda_kernel_matches_the_plain_chain(cuda_device, c, real, scaled):
    gates = counts = refined = 0
    before = LAUNCHES["finalize_fit"]
    cases = 12
    for k in range(cases):
        args = _card_state(c, real, 100 * c + k, cuda_device, scaled, closed=k % 4 == 3)
        got = finalize.finalize_fit(*args)
        want = finalize.finalize_fit_reference(*args)
        g, n = _agree(got, want, args)
        gates, counts, refined = gates + g, counts + n, refined + bool(want.refined)
    torch.cuda.synchronize()
    assert LAUNCHES["finalize_fit"] == before + cases
    print(f"C={c} ({real} real) scaled={scaled}: {refined} of {cases} refits kept; {gates} gates "
          f"decided within rounding, {counts} counts off by columns within rounding of thr")
    assert gates + counts <= 2
    assert refined >= cases // 2  # the refit's pose, not only the host best's, is compared


@pytest.mark.cuda
@pytest.mark.parametrize("c,real", BUCKETS)
@pytest.mark.parametrize("scaled", [False, True])
def test_cuda_pair_axis_through_vmap(cuda_device, c, real, scaled):
    p = 8
    cases = [_card_state(c, real, 7 * c + q, cuda_device, scaled, closed=q % 4 == 3)
             for q in range(p)]
    flat = [[a for x in case for a in (x[:3] if isinstance(x, WarmState) else (x,))]
            for case in cases]
    args = [torch.stack(col) for col in zip(*flat)]

    def one(s, d, cnt, fin, kp, ss, sr, st, bs, br, bt, bc, th):
        false = torch.zeros((), dtype=torch.bool, device=s.device)
        return tuple(finalize.finalize_fit(s, d, cnt, fin, kp, WarmState(ss, sr, st, false),
                                           WarmState(bs, br, bt, false), bc, th))

    before = LAUNCHES["finalize_fit"]
    batched = torch.func.vmap(one)(*args)
    assert LAUNCHES["finalize_fit"] == before + 1
    gates = counts = refined = 0
    for q, case in enumerate(cases):
        single = finalize.finalize_fit(*case)
        for x, y in zip(batched, single):
            assert torch.equal(x[q], y)  # a pair's block is the same in any launch
        want = finalize.finalize_fit_reference(*case)
        g, n = _agree(single, want, case)
        gates, counts, refined = gates + g, counts + n, refined + bool(want.refined)
    print(f"P={p} C={c} scaled={scaled}: {refined} refits kept; {gates} gates, {counts} counts "
          f"within rounding")
    assert gates + counts <= 2 and refined >= p // 2


@pytest.mark.cuda
def test_cuda_captured_launch_equals_eager(cuda_device):
    args = _card_state(6144, 5000, 3, cuda_device, True)
    eager = finalize.finalize_fit(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            captured = finalize.finalize_fit(*args)
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(captured, eager):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_traced_plan_launches_once_a_refined_solve(cuda_device):
    """A traced plan counts its graph's launches on the device: one
    finalize_fit a solve whose best count is not 0, none beside; its graph
    holds the one launch."""
    from psulvsb_tpu_torch.utils import timing

    from chip_smoke import dense_inputs

    params = SolverParams.preset_3dmatch(sampled_cap=2048, basic_cap=256, hypothesis_batch=4)
    src, dst, keep, _ = dense_inputs(4096, 3500, 11, cuda_device)
    traced = timing.enabled()
    timing.enable(True)
    try:
        psulvsb_register(src, dst, keep, 0, params, device=cuda_device)  # builds the plan
        fused.flush_launch_counts()
        before = LAUNCHES["finalize_fit"]
        refined = 0
        for seed in range(1, 4):
            sol = psulvsb_register(src, dst, keep, seed, params, device=cuda_device)
            refined += bool(sol.valid)
        fused.flush_launch_counts()
        captured = fused.plan_for(params, 4096, cuda_device).captured_launches
    finally:
        timing.enable(traced)
    assert refined == 3
    assert LAUNCHES["finalize_fit"] == before + refined
    assert captured["finalize_fit"] == 1  # the graph holds the kernel in place of the chain
