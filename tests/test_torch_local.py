"""The local batch's pick and accept (psulvsb_tpu_torch/ops/local.py).

On the CPU the two front doors run their plain versions, which are the
solver's code as it stood around the GNC kernel: `tests/data/local_batch/
steps.npz` holds `_local_round` steps recorded from the solver before the
batch moved into ops/local.py (commit 399e9e3), on recorded Gumbel keys and
scale uniforms: at known and estimated scale, from a cold and from a warm
state, ending by an early accept, by confidence and by stagnation, with the
stage masks tracked and not. The step of today, and the plain pick and
accept composed by hand around the rotation, must give every recorded
field bit for bit. The pair axis through the operators' vmap rules must
equal single calls, malformed inputs raise, and the route (the endpoint
batches only, the kernels only for CUDA tensors) is held here too.

The CUDA cases hold the kernels (csrc/local_batch.cu) to the plain
versions on the card, at the buckets of the solve paths (2048 to 8192
points, the benchmark's caps 2048 / 256 / 4) and at the default caps
(4096 / 2048 / 16): the basic sets equal, the batch's state equal but where
a score differs by a point within float32 rounding of the threshold (each
such batch counted and printed), the pose within 1e-5; P = 8 through vmap
against eight launches; a captured launch against an eager one; and a
plain plan on the card dispatching at most 12 operations a local batch.
They skip here and need no JAX (`python -m pytest tests/test_torch_local.py
-m cuda --noconftest`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from psulvsb_tpu_torch import SolverParams, psulvsb_register
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud
from psulvsb_tpu_torch.ops import local
from psulvsb_tpu_torch.ops._build import LAUNCHES
from psulvsb_tpu_torch.solver import fused
from psulvsb_tpu_torch.solver import psulvsb as ps
from psulvsb_tpu_torch.solver.basic import WarmState, rotation_batch

STEPS = Path(__file__).parent / "data" / "local_batch" / "steps.npz"
CAPS = dict(sampled_cap=64, basic_cap=16, hypothesis_batch=4)
# name: (estimated scale, stage masks tracked, parameter overrides), as recorded
CASES = {
    "known_first_track": (False, True, dict(local_confidence=0.999999)),
    "known_first_plain": (False, False, dict(local_confidence=0.999999)),
    "known_warm_track": (False, True, dict(local_confidence=0.999999)),
    "known_warm_far_plain": (False, False, dict(local_confidence=0.999999)),
    "known_accept_early": (False, True, dict(rotation_similar=0.5)),
    "known_stop_confidence": (False, True, dict(local_confidence=0.05)),
    "known_stop_stagnation": (False, True, dict(local_max_iter=1, stagnation_min_pro_local=1.0,
                                                local_confidence=1.0, rotation_similar=-1.0)),
    "scaled_first_track": (True, True, dict(local_confidence=0.999999)),
    "scaled_warm_plain": (True, False, dict(local_confidence=0.999999)),
    "scaled_accept_early": (True, True, dict(rotation_similar=0.5)),
}
EXTRAS = ("b_i", "b_j", "scale_inliers", "rotation_inliers", "translation_inliers",
          "translation_points")
FIELDS = ("best_count", "local_r", "pro_local", "hypotheses", "escalate", "done", "extras_valid")


@pytest.fixture(scope="module")
def steps():
    with np.load(STEPS) as data:
        return {k: torch.as_tensor(v) for k, v in data.items()}


def _recorded(steps, name):
    """(params, inputs, warm, batches) of a recorded case; batches is a list
    of (g, u, expected fields)."""
    scaled, _, over = CASES[name]
    params = dataclasses.replace(SolverParams.preset_anchor(), estimate_scaling=scaled, **CAPS,
                                 **over)
    rec = {k.split("/", 1)[1]: v for k, v in steps.items() if k.startswith(name + "/")}
    warm = WarmState(rec["warm_scale"], rec["warm_rotation"], rec["warm_translation"],
                     rec["warm_first_time"])
    batches = []
    for k in range(3):
        if f"g{k}" not in rec:
            break
        want = {f: v for f, v in rec.items() if f.startswith(f"out{k}.")}
        batches.append((rec[f"g{k}"], rec.get(f"u{k}"), {f.split(".", 1)[1]: v
                                                          for f, v in want.items()}))
    return params, rec, warm, batches


def _round(params, rec, warm, track, **kw):
    return ps._local_round(rec["src"], rec["dst"], rec["s_i"], rec["s_j"], rec["s_ok"],
                           rec["s_count"], rec["s_pts"], 0.5, False, rec["host_r"], warm,
                           rec["thr"], params, track_extras=track, **kw)


def _fields(state) -> dict:
    out = {f: getattr(state, f) for f in FIELDS}
    out.update({f"best.{f}": v for f, v in zip(("scale", "rotation", "translation"),
                                                state.best[:3])})
    if state.extras is not None:
        out.update({f"extras.{f}": v for f, v in zip(EXTRAS, state.extras)})
    return out


def _check(got: dict, want: dict):
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def _composed(params, rec, warm, track):
    """The batch as `ops.local`'s plain pick and accept around the rotation,
    written out by hand: the step of the endpoint route."""
    bcap = min(params.basic_cap, rec["s_i"].shape[0])
    rule = local.AcceptRule.of(params)
    nb = torch.full((), params.inner_noise_bound)
    cb2 = torch.full((), params.inner_cbar2)

    def step(st, g, u):
        w = st.best
        choose = local.basic_choose_of(rec["s_count"], 0.5, bcap, False)
        pk = local.local_pick_reference(g, rec["s_i"], rec["s_j"], rec["s_ok"], choose,
                                        rec["src"], rec["dst"], bcap, w.first_time,
                                        params.inner_noise_bound, params.inner_cbar2,
                                        not params.estimate_scaling)
        if params.estimate_scaling:
            scale, sc_inl, _ = ps.solve_scale_tls(
                pk.src_t, pk.dst_t, nb, cb2, active=pk.sel_ok, warm_scale=w.scale,
                use_warm=pk.use_warm, max_draws=params.scale_max_draws,
                estimator=params.scale_estimator, u=u)
            inv = 1.0 / torch.clamp(scale, min=1e-30)
            rots, rot_inl = rotation_batch(pk.src_t, pk.dst_t * inv[:, None, None], sc_inl,
                                           nb * 2.0 * inv, w.rotation, pk.use_warm, params)
        else:
            scale, sc_inl = pk.scale, pk.sc_inl
            rots, rot_inl = rotation_batch(pk.src_t, pk.dst_t, pk.sel_ok, pk.noise, w.rotation,
                                           pk.use_warm, params)
        acc = local.local_accept_reference(rec["src"], rec["dst"], rec["s_pts"], pk.b_i, pk.b_j,
                                           rot_inl, rots, scale, w, st, rec["host_r"],
                                           rec["thr"], rule, sc_inl, track)
        return st._replace(best=acc.best, best_count=acc.best_count, local_r=acc.local_r,
                           pro_local=acc.pro_local, hypotheses=acc.hypotheses,
                           escalate=acc.escalate, done=acc.done, extras_valid=acc.extras_valid,
                           extras=ps.HypExtras(*acc.extras) if track else st.extras)

    return step


@pytest.mark.parametrize("form", ["step", "composed"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_batch_equals_the_recorded_step(steps, name, form):
    params, rec, warm, batches = _recorded(steps, name)
    track = CASES[name][1]
    state, step = _round(params, rec, warm, track)
    if form == "composed":
        step = _composed(params, rec, warm, track)
    state = state._replace(best=warm)
    for g, u, want in batches:
        state = step(state, g, u)
        _check(_fields(state), want)
    assert bool(state.done) == bool(batches[-1][2]["done"])


def test_the_recorded_cases_end_every_way(steps):
    """The fixture spans every way a batch ends: an early accept
    (local_r bumped past the hypotheses), a stop by confidence, a stop by
    stagnation (escalate), and batches that run on."""
    ends = set()
    for name in CASES:
        _, _, _, batches = _recorded(steps, name)
        for _, _, out in batches:
            if not bool(out["done"]):
                ends.add("runs on")
            elif bool(out["escalate"]):
                ends.add("stagnation")
            elif int(out["local_r"]) > int(out["hypotheses"]):
                ends.add("early accept")
            else:
                ends.add("confidence or early accept")
    assert ends == {"runs on", "stagnation", "early accept", "confidence or early accept"}


@pytest.mark.parametrize("name", ["known_warm_track", "scaled_first_track"])
def test_draws_give_the_keys_they_stand_for(steps, name):
    """The one-launch solve hands the pick int64 draws; their keys are
    gumbel_of(uniform_of(draws)), and a step on the draws equals a step on
    those keys bit for bit."""
    params, rec, warm, _ = _recorded(steps, name)
    draws = torch.randint(0, ps.DRAW_SPAN, (4, rec["s_i"].shape[0]),
                          generator=torch.Generator().manual_seed(2))
    keys = local.gumbel_of(local.uniform_of(draws))
    assert torch.equal(local.keys_of(draws), keys)
    u = torch.rand((4, params.scale_max_draws), generator=torch.Generator().manual_seed(3))
    state, step = _round(params, rec, warm, True)
    a, b = step(state, draws, u), step(state, keys, u)
    for x, y in zip(_fields(a).values(), _fields(b).values()):
        assert torch.equal(x, y)


def _pair_inputs(steps, names):
    """Stacked pick and accept inputs of recorded cases (one pair each)."""
    out = []
    for name in names:
        params, rec, warm, batches = _recorded(steps, name)
        out.append((params, rec, warm, batches[0][0]))
    return out


@pytest.mark.parametrize("scaled", [False, True])
def test_pair_axis_through_vmap_equals_single_calls(steps, scaled):
    names = ["scaled_first_track", "scaled_warm_plain", "scaled_accept_early"] if scaled else \
        ["known_first_track", "known_warm_track", "known_warm_far_plain"]
    cases = _pair_inputs(steps, names)
    params = cases[0][0]
    bcap = min(params.basic_cap, cases[0][1]["s_i"].shape[0])
    known = not scaled

    def pick(g, si, sj, ok, cnt, src, dst, ft):
        pk = local.local_pick(g, si, sj, ok, cnt, 0.5, src, dst, bcap, ft,
                              params.inner_noise_bound, params.inner_cbar2, known)
        return tuple(t for t in pk[:9] if t is not None)

    def stack(key):
        return torch.stack([c[1][key] for c in cases])

    g = torch.stack([c[3] for c in cases])
    ft = torch.stack([torch.as_tensor(c[2].first_time) for c in cases])
    args = (g, stack("s_i"), stack("s_j"), stack("s_ok"), stack("s_count"), stack("src"),
            stack("dst"), ft)
    batched = torch.func.vmap(pick)(*args)
    for q in range(len(cases)):
        one = pick(*(a[q] for a in args))
        for x, y in zip(batched, one):
            assert torch.equal(x[q], y)

    # The accept on each pair's pick, with the rotation of the plain loop.
    rule = local.AcceptRule.of(params)
    picks = [pick(*(a[q] for a in args)) for q in range(len(cases))]
    rots = []
    for (_, rec, warm, _), pk in zip(cases, picks):
        noise = pk[7] if known else torch.full((4,), 2 * params.inner_noise_bound)
        rots.append(rotation_batch(pk[3], pk[4], pk[2], noise, warm.rotation, pk[-1], params))
    zero_i = torch.zeros((), dtype=torch.int64)
    false = torch.zeros((), dtype=torch.bool)
    st = local._State(zero_i, zero_i, zero_i, false, false, None)

    def accept(src, dst, pts, bi, bj, ri, R, s, ws, wr, wt, ft, hr, thr):
        got = local.local_accept(src, dst, pts, bi, bj, ri, R, s, WarmState(ws, wr, wt, ft), st,
                                 hr, thr, rule)
        return (*got.best[:3], *got[1:8])

    ones = torch.ones(4)
    acc_args = [stack("src"), stack("dst"), stack("s_pts"),
                torch.stack([pk[0] for pk in picks]), torch.stack([pk[1] for pk in picks]),
                torch.stack([r[1] for r in rots]), torch.stack([r[0] for r in rots]),
                torch.stack([pk[5] if known else ones for pk in picks]),
                torch.stack([c[2].scale for c in cases]),
                torch.stack([c[2].rotation for c in cases]),
                torch.stack([c[2].translation for c in cases]), ft, stack("host_r"),
                stack("thr")]
    batched = torch.func.vmap(accept)(*acc_args)
    for q in range(len(cases)):
        one = accept(*(a[q] for a in acc_args))
        for x, y in zip(batched, one):
            assert torch.equal(x[q], y)


def _one_pick_args(steps):
    params, rec, warm, batches = _recorded(steps, "known_warm_track")
    return dict(keys=batches[0][0], s_i=rec["s_i"], s_j=rec["s_j"], s_ok=rec["s_ok"],
                sampled_count=rec["s_count"], b_rate=0.5, src=rec["src"], dst=rec["dst"],
                bcap=16, first_time=warm.first_time, noise_bound=params.inner_noise_bound,
                cbar2=params.inner_cbar2, known_scale=True)


@pytest.mark.parametrize("bad", ["keys_shape", "keys_dtype", "s_ok_dtype", "s_j_shape",
                                 "dst_shape", "bcap_zero", "bcap_over_s"])
def test_pick_refuses_malformed_inputs(steps, bad):
    kw = _one_pick_args(steps)
    if bad == "keys_shape":
        kw["keys"] = kw["keys"][:, :-1]
    elif bad == "keys_dtype":
        kw["keys"] = kw["keys"].double()
    elif bad == "s_ok_dtype":
        kw["s_ok"] = kw["s_ok"].long()
    elif bad == "s_j_shape":
        kw["s_j"] = kw["s_j"][:-1]
    elif bad == "dst_shape":
        kw["dst"] = kw["dst"][:, :-1]
    elif bad == "bcap_zero":
        kw["bcap"] = 0
    else:
        kw["bcap"] = kw["s_i"].shape[0] + 1
    with pytest.raises(ValueError):
        local.local_pick(**kw)


@pytest.mark.parametrize("bad", ["b_j", "rots", "scale", "s_pts", "rot_inl_dtype", "track"])
def test_accept_refuses_malformed_inputs(steps, bad):
    params, rec, warm, batches = _recorded(steps, "known_warm_track")
    pk = local.local_pick(**_one_pick_args(steps))
    rots = torch.eye(3).expand(4, 3, 3).clone()
    rot_inl = pk.sel_ok.clone()
    zero_i = torch.zeros((), dtype=torch.int64)
    false = torch.zeros((), dtype=torch.bool)
    st = local._State(zero_i, zero_i, zero_i, false, false, None)
    kw = dict(src=rec["src"], dst=rec["dst"], s_pts=rec["s_pts"], b_i=pk.b_i, b_j=pk.b_j,
              rot_inl=rot_inl, rots=rots, scale=pk.scale, warm=warm, st=st, host_r=rec["host_r"],
              thr=rec["thr"], rule=local.AcceptRule.of(params))
    local.local_accept(**kw)  # sound
    if bad == "b_j":
        kw["b_j"] = pk.b_j[:, :-1]
    elif bad == "rots":
        kw["rots"] = rots[:, :2]
    elif bad == "scale":
        kw["scale"] = pk.scale[:-1]
    elif bad == "s_pts":
        kw["s_pts"] = rec["s_pts"][:-1]
    elif bad == "rot_inl_dtype":
        kw["rot_inl"] = rot_inl.long()
    else:
        kw.update(track=True)  # no scale inliers, no state masks
    with pytest.raises(ValueError):
        local.local_accept(**kw)


@pytest.mark.parametrize("case", ["endpoints", "b_rate_one", "small_c"])
def test_the_route_takes_the_endpoint_batches_only(steps, monkeypatch, case):
    """`local_pick` and `local_accept` run for the endpoint batches (not the
    b_rate == 1.0 round, and 2 bcap < C), and on CPU tensors launch
    nothing."""
    params, rec, warm, batches = _recorded(steps, "known_warm_track")
    calls = []
    for name in ("local_pick", "local_accept"):
        real = getattr(ps, name)
        monkeypatch.setattr(ps, name, lambda *a, _f=real, _n=name, **k: calls.append(_n)
                            or _f(*a, **k))
    if case == "small_c":  # 2 bcap >= C: the full translation
        params = dataclasses.replace(params, basic_cap=rec["s_i"].shape[0])
        rec = dict(rec, src=rec["src"][:, :100], dst=rec["dst"][:, :100],
                   s_pts=rec["s_pts"][:100], s_i=rec["s_i"] % 100, s_j=rec["s_j"] % 100)
    b_one = case == "b_rate_one"
    before = dict(LAUNCHES)
    state, step = ps._local_round(rec["src"], rec["dst"], rec["s_i"], rec["s_j"], rec["s_ok"],
                                  rec["s_count"], rec["s_pts"], 1.0 if b_one else 0.5, b_one,
                                  rec["host_r"], warm, rec["thr"], params)
    step(state._replace(best=warm), batches[0][0], None)
    assert calls == (["local_pick", "local_accept"] if case == "endpoints" else [])
    assert LAUNCHES == before


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _card_batch(c, dev, scaled=False, caps=(2048, 256, 4), seed=0, pairs=None):
    """A sampled set of a 3DMatch-like pair of C points on the card: params,
    clouds, the sample stage's outputs, a warm state near the truth, thr."""
    s_cap, b_cap, hb = caps
    params = SolverParams.preset_3dmatch(estimate_scaling=scaled, sampled_cap=s_cap,
                                         basic_cap=b_cap, hypothesis_batch=hb)
    rng = np.random.default_rng(seed + c)
    kw = dict(outlier_mode="mismatch", test_scale=2.5) if scaled else {}
    pair = make_synthetic_pair(rng, synthetic_cloud(c, seed=seed + c), 0.01, 0.9, **kw)
    src = torch.as_tensor(np.asarray(pair.src), dtype=torch.float32, device=dev)
    dst = torch.as_tensor(np.asarray(pair.dst), dtype=torch.float32, device=dev)
    keep = torch.ones(c, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layout = ps.DrawLayout(params, c, 1)
    draws = layout.fill(gen, dev)
    red = ps._init_stage(src, dst, keep, params, None, layout.init_draws(draws))
    s = ps._sample_stage(*red, 0.5, params, c, None,
                         local.gumbel_of(layout.uniform(draws, "u_sample", 0)))
    R = torch.as_tensor(np.asarray(pair.transform.rotation), dtype=torch.float32, device=dev)
    t = torch.as_tensor(np.asarray(pair.transform.translation), dtype=torch.float32, device=dev)
    warm = WarmState(torch.tensor(float(pair.transform.scale), device=dev), R, t + 0.01,
                     torch.tensor(False, device=dev))
    thr = torch.tensor(params.pr_noise * 2.0, dtype=torch.float32, device=dev)
    return params, src, dst, s, warm, thr


def _margin(src, dst, pts, s, R, t, thr):
    """The smallest |residual - thr| / thr over the sampled points, float64."""
    d = dst.double() - s.double() * (R.double() @ src.double() + t.double()[:, None])
    res = torch.linalg.vector_norm(d, dim=0)
    return float((torch.abs(res - thr.double()) / thr.double())[pts].min())


def _both(params, src, dst, s, warm, thr, g, u, first):
    """One batch through the kernels and through the plain versions on the
    card, from the same state and keys: (kernel pick, plain pick, kernel
    state, plain state, the rotation's inputs)."""
    s_i, s_j, s_ok, s_count, s_pts = s
    bcap = min(params.basic_cap, s_i.shape[0])
    known = not params.estimate_scaling
    w = warm._replace(first_time=torch.full((), first, dtype=torch.bool, device=src.device))
    pk = local.local_pick(g, s_i, s_j, s_ok, s_count, 0.5, src, dst, bcap, w.first_time,
                          params.inner_noise_bound, params.inner_cbar2, known)
    choose = local.basic_choose_of(s_count, 0.5, bcap, False)
    pp = local.local_pick_reference(g, s_i, s_j, s_ok, choose, src, dst, bcap, w.first_time,
                                    params.inner_noise_bound, params.inner_cbar2, known)
    if known:
        scale, sc_inl, noise = pk.scale, pk.sc_inl, pk.noise
    else:
        nb = torch.full((), params.inner_noise_bound, device=src.device)
        cb2 = torch.full((), params.inner_cbar2, device=src.device)
        scale, sc_inl, _ = ps.solve_scale_tls(pk.src_t, pk.dst_t, nb, cb2, active=pk.sel_ok,
                                              warm_scale=w.scale, use_warm=pk.use_warm,
                                              max_draws=params.scale_max_draws, u=u)
        noise = nb * 2.0 / torch.clamp(scale, min=1e-30)
    dst_r = pk.dst_t / torch.clamp(scale, min=1e-30)[:, None, None]
    rots, rot_inl = rotation_batch(pk.src_t, dst_r, pk.sel_ok if known else sc_inl, noise,
                                   w.rotation, pk.use_warm, params)
    rule = local.AcceptRule.of(params)
    zero_i = torch.zeros((), dtype=torch.int64, device=src.device)
    false = torch.zeros((), dtype=torch.bool, device=src.device)
    st = local._State(zero_i, zero_i, zero_i, false, false, None)
    host_r = torch.full((), 2, dtype=torch.int64, device=src.device)
    got = local.local_accept(src, dst, s_pts, pk.b_i, pk.b_j, rot_inl, rots, scale, w, st,
                             host_r, thr, rule, ticket=pk.ticket)
    want = local.local_accept_reference(src, dst, s_pts, pk.b_i, pk.b_j, rot_inl, rots, scale,
                                        w, st, host_r, thr, rule)
    return pk, pp, got, want, (rots, scale, w)


def _agree(got, want, src, dst, s_pts, thr, rots, scale, warm) -> bool:
    """The two states equal (poses within 1e-5), or else a score that a
    point within float32 rounding of the threshold decides (True)."""
    same = all(bool(torch.equal(getattr(got, f), getattr(want, f)))
               for f in ("best_count", "local_r", "hypotheses", "escalate", "done",
                         "extras_valid"))
    same = same and torch.equal(got.best.rotation, want.best.rotation)
    if same:
        torch.testing.assert_close(got.best.translation, want.best.translation, atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(got.pro_local, want.pro_local, atol=1e-6, rtol=0)
        return False
    margins = [_margin(src, dst, s_pts, sc, R, t, thr)
               for sc, R, t in ((got.best.scale, got.best.rotation, got.best.translation),
                                (want.best.scale, want.best.rotation, want.best.translation))]
    assert min(margins) < 1e-5, f"the states differ with no point near the threshold: {margins}"
    return True


CUDA_BUCKETS = [2048, 4096, 6144, 8192]


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("c", CUDA_BUCKETS)
def test_cuda_kernels_match_plain(cuda_device, c, scaled):
    params, src, dst, s, warm, thr = _card_batch(c, cuda_device, scaled)
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    before = dict(LAUNCHES)
    near, batches = 0, 12
    for k in range(batches):
        g = torch.randint(0, ps.DRAW_SPAN, (params.hypothesis_batch, s[0].shape[0]),
                          generator=gen, device=cuda_device)
        u = torch.rand((params.hypothesis_batch, params.scale_max_draws), generator=gen,
                       device=cuda_device)
        pk, pp, got, want, (rots, scale, w) = _both(params, src, dst, s, warm, thr, g, u,
                                                    first=k % 3 == 0)
        for x, y in zip(pk[:5], pp[:5]):
            assert torch.equal(x, y)
        if not scaled:
            assert torch.equal(pk.scale, pp.scale) and torch.equal(pk.noise, pp.noise)
            assert int((pk.sc_inl != pp.sc_inl).sum()) <= 1
        near += _agree(got, want, src, dst, s[4], thr, rots, scale, w)
    assert LAUNCHES["local_pick"] == before["local_pick"] + batches
    assert LAUNCHES["local_accept"] == before["local_accept"] + batches
    print(f"C={c} scaled={scaled}: {near} of {batches} batches decided by a point within "
          "float32 rounding of the threshold")
    assert near <= 2


@pytest.mark.cuda
def test_cuda_default_caps_run(cuda_device):
    """sampled_cap 4096, basic_cap 2048, hypothesis_batch 16 (the defaults):
    the sort in shared memory at its largest; equal to the plain version."""
    params, src, dst, s, warm, thr = _card_batch(8192, cuda_device, caps=(4096, 2048, 16))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    g = torch.randint(0, ps.DRAW_SPAN, (16, s[0].shape[0]), generator=gen, device=cuda_device)
    pk, pp, got, want, (rots, scale, w) = _both(params, src, dst, s, warm, thr, g, None, False)
    for x, y in zip(pk[:5], pp[:5]):
        assert torch.equal(x, y)
    _agree(got, want, src, dst, s[4], thr, rots, scale, w)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 8])
def test_cuda_pair_axis_through_vmap_equals_single_launches(cuda_device, p):
    cases = [_card_batch(4096, cuda_device, seed=q) for q in range(p)]
    params = cases[0][0]
    bcap = params.basic_cap
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g = torch.randint(0, ps.DRAW_SPAN, (p, 4, cases[0][3][0].shape[0]), generator=gen,
                      device=cuda_device)

    def stack(i, j=None):
        return torch.stack([c[i] if j is None else c[i][j] for c in cases])

    ft = torch.zeros(p, dtype=torch.bool, device=cuda_device)

    def pick(g, si, sj, ok, cnt, src, dst, ft):
        return tuple(local.local_pick(g, si, sj, ok, cnt, 0.5, src, dst, bcap, ft,
                                      params.inner_noise_bound, params.inner_cbar2, True))

    args = (g, stack(3, 0), stack(3, 1), stack(3, 2), stack(3, 3), stack(1), stack(2), ft)
    before = dict(LAUNCHES)
    batched = torch.func.vmap(pick)(*args)
    assert LAUNCHES["local_pick"] == before["local_pick"] + 1
    singles = [pick(*(a[q] for a in args)) for q in range(p)]
    for q in range(p):
        for x, y in zip(batched[:9], singles[q][:9]):
            assert torch.equal(x[q], y)
    rule = local.AcceptRule.of(params)
    rots = [rotation_batch(pk[3], pk[4], pk[2], pk[7], c[4].rotation, pk[8], params)
            for pk, c in zip(singles, cases)]
    zero_i = torch.zeros((), dtype=torch.int64, device=cuda_device)
    false = torch.zeros((), dtype=torch.bool, device=cuda_device)
    st = local._State(zero_i, zero_i, zero_i, false, false, None)

    def accept(src, dst, pts, bi, bj, ri, R, s, ws, wr, wt, ft, thr):
        got = local.local_accept(src, dst, pts, bi, bj, ri, R, s, WarmState(ws, wr, wt, ft), st,
                                 zero_i, thr, rule)
        return (*got.best[:3], *got[1:8])

    acc = (stack(1), stack(2), stack(3, 4), torch.stack([pk[0] for pk in singles]),
           torch.stack([pk[1] for pk in singles]), torch.stack([r[1] for r in rots]),
           torch.stack([r[0] for r in rots]), torch.stack([pk[5] for pk in singles]),
           torch.stack([c[4].scale for c in cases]), torch.stack([c[4].rotation for c in cases]),
           torch.stack([c[4].translation for c in cases]), ft, stack(5))
    before = dict(LAUNCHES)
    batched = torch.func.vmap(accept)(*acc)
    assert LAUNCHES["local_accept"] == before["local_accept"] + 1
    for q in range(p):
        for x, y in zip(batched, accept(*(a[q] for a in acc))):
            assert torch.equal(x[q], y)


@pytest.mark.cuda
def test_cuda_captured_launch_equals_eager(cuda_device):
    params, src, dst, s, warm, thr = _card_batch(6144, cuda_device)
    g = torch.randint(0, ps.DRAW_SPAN, (4, s[0].shape[0]),
                      generator=torch.Generator(device=cuda_device).manual_seed(3),
                      device=cuda_device)

    def run():
        pk, _, got, _, _ = _both(params, src, dst, s, warm, thr, g, None, False)
        return (*pk[:5], *got.best[:3], *got[1:8])

    eager = run()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        run()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)


class _CountOps(TorchDispatchMode):
    """Operations dispatched, views left out."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_cuda_plain_plan_dispatches_a_dozen_operations_a_batch(cuda_device, monkeypatch):
    """The plan's plain version (graphs=False) on the card: a local batch on
    the endpoint route dispatches at most 12 operations (about 260 before
    the kernels), the two kernels among them once each."""
    params, src, dst, _, _, _ = _card_batch(4096, cuda_device)
    keep = torch.ones(4096, dtype=torch.int64, device=cuda_device)
    counts = []
    real = fused.ReplayPlan._local_step

    def counted(self, ctl, b, r, k, b_one):
        mode = _CountOps()
        with mode:
            real(self, ctl, b, r, k, b_one)
        counts.append((b_one, mode.ops))

    monkeypatch.setattr(fused.ReplayPlan, "_local_step", counted)
    psulvsb_register(src, dst, keep, 0, params, device=cuda_device, graphs=False)
    route = [ops for b_one, ops in counts if not b_one]
    assert route, "no batch took the endpoint route"
    for ops in route:
        assert len(ops) <= 12, ops
        assert sum("local_pick" in o for o in ops) == 1
        assert sum("local_accept" in o for o in ops) == 1
    print(f"{len(route)} endpoint batches, {max(len(o) for o in route)} operations at most: "
          f"{route[0]}")
