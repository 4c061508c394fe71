"""The one-dispatch PSULVSB solve: segments of fixed shape, captured once as
CUDA graphs and replayed.

Counterpart of psulvsb_tpu/solver/fused.py (`fused_scan_rounds`,
`psulvsb_register`). There `jax.jit` turns the whole solve into one compiled
program, cached by its static `params` and its shapes. On an NVIDIA card the
counterpart is a replay plan: the solve is cut into segments whose shapes the
caps fix (the prologue with init, threshold, GROR and the eager seed; a
round's sample stage; one local batch; the round's host stage; the
self-update; the lazy seed; the finalize), each segment is captured once as a
`torch.cuda.CUDAGraph` and replayed, and plans are cached by `params`, the
padded C and the device. Inside a segment the host issues one graph launch
and every decision is a select on the device.

PyTorch exposes no conditional graph node, so the early exits that JAX keeps
on the device (`lax.while_loop` over batches, `lax.cond` on a round) stay at
segment boundaries: after a local batch the host reads one word (`done`),
after a round one (`pro_host`, `escalate`, the number of newly admitted
points, the best count), through a pinned buffer that the graph's last node
fills. Nothing else is read, with one exception that the caller asks for:
under `exact_clique_callback` with PMC_EXACT the local batches of the
b_rate == 1.0 round run eagerly, not from a graph, because each copies its
hypotheses' graphs to the host for the native exact clique search
(`solver.psulvsb.exact_clique_points`) and a captured graph cannot call the
host. Likewise `gnc_rot_method="eigh"` and FGR run inside the captured
segments in their forms that read nothing (`sync_free`: Jacobi sweeps for the
4x4 eigenvector, every iteration run masked).

Every random draw is made eagerly from the caller's generator, in
`psulvsb_solve`'s order, into a segment's input buffer before its replay, so
one seed gives one solution: replayed, run eagerly (`graphs=False`, the
plain version of this module) and through the staged `psulvsb_solve`.

As in the JAX module, no clock is read: the reference's wall-clock budget
(registration.cc:1475) is a projection made when the plan is built, a cap of
`fused_scan_rounds(params)` host rounds.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import OrderedDict

import torch

from psulvsb_tpu_torch.clique import pmc
from psulvsb_tpu_torch.clique.kcore import max_clique_size_for_edges
from psulvsb_tpu_torch.gror.gror import _gror_core
from psulvsb_tpu_torch.ops import gnc as _gnc_ops
from psulvsb_tpu_torch.ops import hist as _hist_ops
from psulvsb_tpu_torch.ops import pairs as _pairs_ops
from psulvsb_tpu_torch.pairs.tims import _KEY_SPAN
from psulvsb_tpu_torch.solver.basic import WarmState
from psulvsb_tpu_torch.solver.config import RATE_SCHEDULE, InlierSelectionMode, SolverParams
from psulvsb_tpu_torch.solver.psulvsb import (
    HostState,
    InitDraws,
    LocalState,
    _clique_seed_stage,
    _draw_pairs,
    _finalize_stage,
    _host_stage,
    _init_stage,
    _local_round,
    _sample_stage,
    _self_update_pairs,
    init_route,
    local_max_batches,
)
from psulvsb_tpu_torch.solver.solution import RegistrationSolution
from psulvsb_tpu_torch.utils.precision import pin_float32
from psulvsb_tpu_torch.utils.scalars import as_generator, device_flag

_F32 = torch.float32
_F64 = torch.float64
_I64 = torch.int64
_WORD = 4  # float64 values of the word the host reads at a boundary

PLAN_CACHE_SIZE = 8  # plans kept, least recently used first out
_PLANS: "OrderedDict[tuple, ReplayPlan]" = OrderedDict()


def fused_scan_rounds(params: SolverParams) -> int:
    """Host-round count of the one-dispatch solve: `max_host_rounds` capped
    by the projected wall-clock budget, value for value what the JAX
    function gives.

    The staged solver checks the host clock between rounds
    (registration.cc:1475); a replayed plan does not. The budget is applied
    when the plan is built: at most time_budget_s / fused_round_ceiling_s
    rounds run, the ceiling being a pessimistic bound on one round's time
    (config.py). At the reference caps it never binds."""
    rounds = params.max_host_rounds
    if (
        params.fused_round_ceiling_s > 0
        and params.time_budget_s > 0
        and math.isfinite(params.time_budget_s)
    ):
        rounds = min(rounds, max(1, int(params.time_budget_s / params.fused_round_ceiling_s)))
    return rounds


# -----------------------------------------------------------------------------
# Kernel launch counts: a replay launches the kernels its graph captured
# without calling their wrappers, so the plan adds them to the wrappers' counts.
# -----------------------------------------------------------------------------


def _launch_counts() -> dict[str, int]:
    return {
        "gnc_batch": _gnc_ops.KERNEL_LAUNCHES,
        "consistency_degree": _pairs_ops.KERNEL_LAUNCHES,
        **_hist_ops.KERNEL_LAUNCHES,
    }


def _set_launch_counts(counts: dict[str, int]) -> None:
    _gnc_ops.KERNEL_LAUNCHES = counts["gnc_batch"]
    _pairs_ops.KERNEL_LAUNCHES = counts["consistency_degree"]
    for name in _hist_ops.KERNEL_LAUNCHES:
        _hist_ops.KERNEL_LAUNCHES[name] = counts[name]


def _add_launch_counts(launches: dict[str, int]) -> None:
    counts = _launch_counts()
    _set_launch_counts({name: n + launches.get(name, 0) for name, n in counts.items()})


# -----------------------------------------------------------------------------
# State trees <-> the plan's flat buffers
# -----------------------------------------------------------------------------

_NESTED = {
    HostState: {"best": WarmState},
    LocalState: {"best": WarmState},
}
# LocalState fields the plan does not carry: the host counts batches itself,
# and the winning hypothesis' stage masks back getters that the one-dispatch
# solve does not have.
_LOCAL_SKIP = ("iterations", "host_syncs", "extras")


def _flatten(prefix: str, tree, out: dict, skip=()) -> dict:
    for name, value in zip(tree._fields, tree):
        if name in skip:
            continue
        key = f"{prefix}.{name}"
        if isinstance(value, torch.Tensor):
            out[key] = value
        else:
            _flatten(key, value, out)
    return out


def _load(cls, prefix: str, bufs: dict, **given):
    nested = _NESTED.get(cls, {})
    kw = {}
    for name in cls._fields:
        key = f"{prefix}.{name}"
        if name in given:
            kw[name] = given[name]
        elif name in nested:
            kw[name] = _load(nested[name], key, bufs)
        else:
            kw[name] = bufs[key]
    return cls(**kw)


def _gumbel_of(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel keys from uniforms, as psulvsb._gumbel forms them."""
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(_F32).tiny)))


def _select_warm(ok: torch.Tensor, new: WarmState, old: WarmState) -> WarmState:
    """`new` where ok, else `old`; a warm state adopted is no longer the
    first (fused.py:174-181, :216-224 of the JAX module)."""
    return WarmState(
        scale=torch.where(ok, new.scale, old.scale),
        rotation=torch.where(ok, new.rotation, old.rotation),
        translation=torch.where(ok, new.translation, old.translation),
        first_time=old.first_time & ~ok,
    )


class _Segment:
    __slots__ = ("graph", "launches")

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = launches


class ReplayPlan:
    """The buffers and captured segments of one (params, C, device).

    `bufs` holds every tensor that outlives a segment at a fixed address:
    the inputs (`src`, `dst`, `keep`), the draws, and the solve's state under
    dotted names ("hs.best.rotation"). A segment is a pure function of
    `bufs` that returns the entries it replaces; captured, its graph ends by
    copying them into place (and, for a segment the host reads, by copying
    the word into pinned memory). With `graphs` off the same functions run
    eagerly and the entries are rebound.

    One plan runs one solve at a time, on `stream` when it has one (the
    batch's concurrent form gives each instance its own)."""

    def __init__(self, params: SolverParams, c: int, device: torch.device, graphs: bool,
                 stream=None):
        self.params = params
        self.c = c
        self.device = device
        self.graphs = graphs
        self.stream = stream
        self.rounds = fused_scan_rounds(params)
        self.max_batches = local_max_batches(params)
        self.route = init_route(params, c)
        self.scale_draws = params.estimate_scaling and params.scale_estimator == "ransac1pt"
        # Jacobi sweeps read nothing on the host, which torch.linalg.eigh does
        # (it cannot be captured); on the CPU, where nothing is captured, the
        # staged solver's eigh keeps the two solvers equal to the last bit.
        self.rot_method = "jacobi" if device.type == "cuda" else "eigh"
        # The same choice for an "eigh" or FGR rotation inside a segment.
        self.sync_free = device.type == "cuda"
        self.exact_clique = (
            params.resolve_inlier_selection() == InlierSelectionMode.PMC_EXACT
            and params.exact_clique_callback
        )
        self.segments: dict = {}
        self.build_s = 0.0
        self.pool_bytes = 0
        self.stats: dict = {}
        self._replays = 0
        self._reads = 0
        self._refined = False
        cuda = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if graphs else None
        self.event = torch.cuda.Event() if cuda else None
        self.word_host = torch.zeros(_WORD, dtype=_F64, pin_memory=cuda)
        with self._on_stream():
            self.bufs = self._input_buffers()

    # ---- buffers ------------------------------------------------------------

    def _input_buffers(self) -> dict:
        p, c, dev = self.params, self.c, self.device

        def f32(*shape):
            return torch.zeros(shape, dtype=_F32, device=dev)

        def i64(*shape):
            return torch.zeros(shape, dtype=_I64, device=dev)

        pool_cap = min(p.pool_cap, p.reduced_cap)
        s_cap = min(p.sampled_cap, pool_cap)
        bufs = {
            "src": f32(3, c), "dst": f32(3, c), "keep": i64(c),
            "u_sample": f32(pool_cap),
            "u_local": f32(p.hypothesis_batch, s_cap),
            "u_host": f32(c),
        }
        if self.scale_draws:
            bufs["u_scale"] = f32(p.hypothesis_batch, p.scale_max_draws)
            bufs["u_seed"] = f32(p.scale_max_draws)
        if self.route == "dense":
            bufs["ab"] = i64(2)
        elif self.route == "exact":
            bufs["exact_keys"] = i64(c * (c - 1) // 2)
        else:
            bufs["fill_a"] = i64(p.init_reject_budget)
            bufs["fill_b"] = i64(p.init_reject_budget)
            bufs["fill_keys"] = i64(p.init_reject_budget)
        if p.estimate_scaling and self.route != "exact":
            bufs["peak_a"] = i64(p.init_peak_sample)
            bufs["peak_b"] = i64(p.init_peak_sample)
        return bufs

    @property
    def nbytes(self) -> int:
        """Device bytes the plan holds: its buffers and its graphs' pool."""
        own = sum(t.numel() * t.element_size() for t in self.bufs.values() if t.device == self.device)
        return own + self.pool_bytes

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    # ---- running a segment --------------------------------------------------

    def run(self, key, fn, read: bool = False, eager: bool = False) -> None:
        """Run segment `key` (the pure function `fn` of the buffers): eagerly,
        or by replaying its graph, captured at first use. With `read` the
        segment's "word" goes to the host's pinned buffer behind it. `eager`
        runs this segment eagerly in a plan of graphs too (it calls the
        host); its results are copied into place, where the other segments'
        graphs read them."""
        with self._on_stream():
            if not self.graphs:
                out = fn(self.bufs)
                self.bufs.update(out)
                if read:
                    self.word_host.copy_(out["word"], non_blocking=True)
            elif eager:
                out = fn(self.bufs)
                for name, value in out.items():
                    if name in self.bufs:
                        self.bufs[name].copy_(value)
                    else:
                        self.bufs[name] = value.clone()
                if read:
                    self.word_host.copy_(self.bufs["word"], non_blocking=True)
            else:
                seg = self.segments.get(key)
                if seg is None:
                    seg = self.segments[key] = self._capture(fn, read)
                seg.graph.replay()
                if seg.launches:
                    _add_launch_counts(seg.launches)
                self._replays += 1
            if read:
                self._reads += 1
                if self.event is not None:
                    self.event.record()

    def _capture(self, fn, read: bool) -> _Segment:
        """Capture `fn` into a graph of the plan's pool. A first eager run
        (its results are dropped: `fn` is pure) builds the kernels, warms the
        libraries and gives the shapes of the entries the segment adds. A
        capture that fails raises: there is no other way on the card."""
        dev = self.device
        t0 = time.perf_counter()
        out = fn(self.bufs)
        for name, value in out.items():
            if name not in self.bufs:
                self.bufs[name] = torch.empty(value.shape, dtype=value.dtype, device=dev)
        del out
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out = fn(self.bufs)
            for name, value in out.items():
                self.bufs[name].copy_(value)
            if read:
                self.word_host.copy_(self.bufs["word"], non_blocking=True)
        del out
        after = _launch_counts()
        _set_launch_counts(before)  # a capture launches nothing
        torch.cuda.synchronize(dev)
        self.pool_bytes += max(0, torch.cuda.memory_reserved(dev) - reserved)
        self.build_s += time.perf_counter() - t0
        return _Segment(graph, {k: after[k] - before[k] for k in after if after[k] != before[k]})

    def read(self) -> list[float]:
        """The word of the last `run(..., read=True)`, once the device has
        written it."""
        if self.event is not None:
            self.event.synchronize()
        return self.word_host.tolist()

    # ---- draws --------------------------------------------------------------

    def uniform(self, name: str, gen: torch.Generator) -> None:
        """torch.rand's next draws of the buffer's shape, into the buffer."""
        with self._on_stream():
            self.bufs[name].uniform_(generator=gen)

    def integers(self, name: str, low: int, high: int, gen: torch.Generator) -> None:
        """torch.randint's next draws of the buffer's shape, into the buffer."""
        with self._on_stream():
            self.bufs[name].random_(low, high, generator=gen)

    def _draw_init(self, gen: torch.Generator) -> None:
        """The init stage's draws in `_init_stage`'s order."""
        p, c = self.params, self.c
        if self.route == "exact":
            self.integers("exact_keys", 0, _KEY_SPAN, gen)
            return
        if p.estimate_scaling:
            self.integers("peak_a", 0, c, gen)
            self.integers("peak_b", 0, max(c - 1, 1), gen)
        if self.route == "dense":
            self.integers("ab", 1, 2**31 - 1, gen)
        else:
            self.integers("fill_a", 0, c, gen)
            self.integers("fill_b", 0, max(c - 1, 1), gen)
            self.integers("fill_keys", 0, _KEY_SPAN, gen)

    # ---- the segments ---------------------------------------------------------

    def _seg_prologue(self, b: dict) -> dict:
        p, c, dev = self.params, self.c, self.device
        src, dst, keep = b["src"], b["dst"], b["keep"]
        peak = _draw_pairs(b["peak_a"], b["peak_b"]) if "peak_a" in b else None
        draws = InitDraws(
            ab=b.get("ab"),
            peak_pairs=peak,
            fill_pairs=_draw_pairs(b["fill_a"], b["fill_b"]) if "fill_a" in b else None,
            fill_keys=b.get("fill_keys"),
            exact_keys=b.get("exact_keys"),
        )
        red_i, red_j, red_count, red_pool = _init_stage(src, dst, keep, p, None, draws)
        # adoptive_thr_multiplier = 1 + |reduced| / |ori| (registration.cc:669),
        # in float64 and rounded once, as the staged solver's host arithmetic.
        n_reduced = (keep == 1).sum().to(_F64)
        n_real = torch.clamp((keep >= -1).sum(), min=1).to(_F64)
        thr = (p.pr_noise * (1.0 + n_reduced / n_real)).to(_F32)

        warm = WarmState.initial(dev)
        if p.gror_init:
            # GROR's alignment seeds the warm state over every real
            # correspondence; fewer than 3 inliers leave the cold start.
            g = _gror_core(
                src, dst, keep > -2, float(p.gror_resolution), int(p.gror_k_optimal),
                rot_method=self.rot_method,
            )
            seed = WarmState(torch.ones((), dtype=_F32, device=dev), g.rotation,
                             g.translation, warm.first_time)
            warm = _select_warm(g.inliers.sum() >= 3, seed, warm)
        out = {"red_i": red_i, "red_j": red_j, "red_count": red_count, "red_pool": red_pool,
               "thr": thr}
        if p.clique_eager:  # a successful seed wins over GROR's
            sw, ok, _ = _clique_seed_stage(
                src, dst, red_i, red_j, red_pool, p, keep == 1, None,
                scale_u=b.get("u_seed"), max_steps=max(c - 1, 0), sync_free=self.sync_free,
            )
            warm = _select_warm(ok, sw, warm)
        _flatten("hs", HostState.initial(c, keep), out)
        _flatten("warm", warm, out)
        _flatten("best_sampled", warm, out)
        return out

    def _local_round(self, b: dict, rate_idx: int):
        _, b_rate = RATE_SCHEDULE[rate_idx]
        # A hypothesis' graph at the b_rate == 1.0 round has at most basic_cap
        # edges, which bounds its clique, so a fixed step count is exact.
        bcap = min(self.params.basic_cap, b["s_i"].shape[0])
        return _local_round(
            b["src"], b["dst"], b["s_i"], b["s_j"], b["s_ok"], b["s_count"], b["s_pts"],
            b_rate, b_rate >= 1.0, b["hs.host_r"], _load(WarmState, "warm", b), b["thr"],
            self.params, clique_max_steps=max_clique_size_for_edges(bcap), track_extras=False,
            sync_free=self.sync_free,
        )

    def _seg_sample(self, b: dict, rate_idx: int) -> dict:
        l_rate, _ = RATE_SCHEDULE[rate_idx]
        s_i, s_j, s_ok, s_count, s_pts = _sample_stage(
            b["red_i"], b["red_j"], b["red_count"], b["red_pool"], l_rate, self.params,
            self.c, gumbel=_gumbel_of(b["u_sample"]),
        )
        out = {"s_i": s_i, "s_j": s_j, "s_ok": s_ok, "s_count": s_count, "s_pts": s_pts}
        start, _ = self._local_round({**b, **out}, rate_idx)
        return _flatten("local", start, out, skip=_LOCAL_SKIP)

    def _seg_local(self, b: dict, rate_idx: int) -> dict:
        start, step = self._local_round(b, rate_idx)
        state = _load(LocalState, "local", b, iterations=0, host_syncs=0, extras=start.extras)
        state = step(state, _gumbel_of(b["u_local"]), b.get("u_scale"))
        out = _flatten("local", state, {}, skip=_LOCAL_SKIP)
        out["word"] = torch.cat([state.done.to(_F64).reshape(1), torch.zeros(
            _WORD - 1, dtype=_F64, device=self.device)])
        return out

    def _seg_host(self, b: dict, b_one: bool) -> dict:
        dev = self.device
        hs = _load(HostState, "hs", b)
        best_sampled = _load(WarmState, "local.best", b)
        hs, new_corr, _ = _host_stage(
            b["src"], b["dst"], hs, best_sampled, b["local.local_r"], b_one, b["thr"],
            self.params, u=b["u_host"],
        )
        out = _flatten("hs", hs, {"new_corr": new_corr})
        _flatten("best_sampled", best_sampled, out)
        _flatten("warm", hs.best._replace(first_time=device_flag(False, dev)), out)
        out["word"] = torch.stack([
            hs.pro_host.to(_F64), b["local.escalate"].to(_F64),
            new_corr.sum().to(_F64), hs.best_count.to(_F64),
        ])
        return out

    def _seg_self_update(self, b: dict) -> dict:
        red_i, red_j, red_count, red_pool = _self_update_pairs(
            b["red_i"], b["red_j"], b["red_count"], b["red_pool"], b["new_corr"],
            b["hs.inl_kept"], self.params,
        )
        return {"red_i": red_i, "red_j": red_j, "red_count": red_count, "red_pool": red_pool}

    def _seg_lazy_seed(self, b: dict) -> dict:
        sw, ok, _ = _clique_seed_stage(
            b["src"], b["dst"], b["red_i"], b["red_j"], b["red_pool"], self.params,
            b["hs.keep_mask"] == 1, None, scale_u=b.get("u_seed"),
            max_steps=max(self.c - 1, 0), sync_free=self.sync_free,
        )
        return _flatten("warm", _select_warm(ok, sw, _load(WarmState, "warm", b)), {})

    def _seg_finalize(self, b: dict) -> dict:
        rotation, translation, _, _ = _finalize_stage(
            b["src"], b["dst"], _load(HostState, "hs", b), _load(WarmState, "best_sampled", b),
            self.params, rot_method=self.rot_method,
        )
        return {"sol.rotation": rotation, "sol.translation": translation}

    # ---- one solve ------------------------------------------------------------

    def load(self, src: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor) -> None:
        """Stage one pair's inputs into the plan's buffers."""
        with self._on_stream():
            self.bufs["src"].copy_(src, non_blocking=True)
            self.bufs["dst"].copy_(dst, non_blocking=True)
            self.bufs["keep"].copy_(keep, non_blocking=True)

    def steps(self, gen: torch.Generator):
        """The solve as a generator: it yields wherever the host must wait
        for the device before it can go on, so that a caller with several
        plans in flight can turn to another meanwhile. Mirrors
        `psulvsb_solve`'s loop and its order of draws."""
        p = self.params
        self._replays = self._reads = 0
        searches_before = pmc.EXACT_SEARCHES
        last = len(RATE_SCHEDULE) - 1
        self._draw_init(gen)
        if p.clique_eager and self.scale_draws:
            self.uniform("u_seed", gen)
        self.run("prologue", self._seg_prologue)
        rate_idx = 0
        longholi = False
        lazy_pending = p.clique_lazy
        best_count = 0.0
        rounds = batches = 0
        for _ in range(self.rounds):
            rounds += 1
            r = rate_idx
            self.uniform("u_sample", gen)
            self.run(("sample", r), lambda b: self._seg_sample(b, r))
            # The exact clique round searches on the host: no graph.
            on_host = self.exact_clique and RATE_SCHEDULE[r][1] >= 1.0
            for _ in range(self.max_batches):
                batches += 1
                self.uniform("u_local", gen)
                if self.scale_draws:
                    self.uniform("u_scale", gen)
                self.run(("local", r), lambda b: self._seg_local(b, r), read=True, eager=on_host)
                yield
                if self.read()[0]:
                    break
            b_one = RATE_SCHEDULE[r][1] >= 1.0
            self.uniform("u_host", gen)
            self.run(("host", b_one), lambda b: self._seg_host(b, b_one), read=True)
            yield
            pro_host, escalate, n_new, best_count = self.read()
            # Stop checks at the host boundary (registration.cc:1475-1484).
            if pro_host > p.host_confidence or longholi:
                break
            if rate_idx == last:
                longholi = True
            if escalate and rate_idx < last:
                rate_idx += 1
            if n_new > 0:
                self.run("self_update", self._seg_self_update)
            if lazy_pending and escalate:
                lazy_pending = False
                if self.scale_draws:
                    self.uniform("u_seed", gen)
                self.run("lazy_seed", self._seg_lazy_seed)
        self._refined = bool(p.enable_refinement and best_count != 0)
        if self._refined:
            self.run("finalize", self._seg_finalize)
        self.stats = {
            "rounds": rounds, "local_batches": batches, "host_reads": self._reads,
            "graph_replays": self._replays,
            "exact_clique_searches": pmc.EXACT_SEARCHES - searches_before,
        }

    def capture_all(self, gen: torch.Generator) -> int:
        """Capture every segment a solve of this plan can take and has not
        taken yet, so that no later solve pays for a capture: the sample and
        local segments of every rate of the ladder, both host segments, the
        self-update, the lazy seed and the finalize. To be called after one
        solve of a real pair through the plan (its state gives the captures
        valid inputs); the replays that follow each capture overwrite that
        state, which the next solve's prologue resets. A plan without
        graphs has nothing to capture. Returns the number of new captures."""
        if not self.graphs:
            return 0
        if "prologue" not in self.segments:
            raise RuntimeError("capture_all needs one solve through the plan first")
        p = self.params
        before = len(self.segments)
        for r, (_, b_rate) in enumerate(RATE_SCHEDULE):
            b_one = b_rate >= 1.0
            if ("sample", r) not in self.segments:
                self.uniform("u_sample", gen)
                self.run(("sample", r), lambda b, r=r: self._seg_sample(b, r))
            if ("local", r) not in self.segments and not (self.exact_clique and b_one):
                self.uniform("u_local", gen)
                self.run(("local", r), lambda b, r=r: self._seg_local(b, r), read=True)
            if ("host", b_one) not in self.segments:
                if "local.best.scale" not in self.bufs:
                    continue
                self.run(("host", b_one), lambda b, o=b_one: self._seg_host(b, o), read=True)
        if "self_update" not in self.segments:
            self.run("self_update", self._seg_self_update)
        if p.clique_lazy and "lazy_seed" not in self.segments:
            self.run("lazy_seed", self._seg_lazy_seed)
        if p.enable_refinement and "finalize" not in self.segments:
            self.run("finalize", self._seg_finalize)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(self.segments) - before

    def solution(self, out: RegistrationSolution | None = None, index: int | None = None):
        """The finished solve's solution: fresh tensors, or written into row
        `index` of the batch solution `out`."""
        b = self.bufs
        pose = "sol" if self._refined else "hs.best"
        with self._on_stream():
            fields = RegistrationSolution(
                valid=b["hs.best_count"] > 0,
                scale=b["hs.best.scale"],
                rotation=b[f"{pose}.rotation"],
                translation=b[f"{pose}.translation"],
                final_inlier_count=b["hs.best_count"],
            )
            if out is None:
                return RegistrationSolution(*(t.clone() for t in fields))
            for dest, value in zip(out, fields):
                dest[index].copy_(value, non_blocking=True)
        return out


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises (no
    silent CPU run)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "psulvsb_tpu_torch runs on a CUDA device unless device='cpu' is asked for, "
                "and torch.cuda.is_available() is false"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def plan_for(params: SolverParams, c: int, device, graphs: bool = True,
             instance: int = 0) -> ReplayPlan:
    """The cached plan of (params, C, device), built at first use; `graphs`
    holds on CUDA devices only. Instances beyond 0 are further plans of the
    same key on streams of their own, for solves in flight at once."""
    device = resolve_device(device)
    graphs = bool(graphs) and device.type == "cuda"
    key = (params, int(c), device, graphs, int(instance))
    plan = _PLANS.get(key)
    if plan is None:
        stream = torch.cuda.Stream(device) if instance and device.type == "cuda" else None
        plan = ReplayPlan(params, int(c), device, graphs, stream)
        _PLANS[key] = plan
        while len(_PLANS) > PLAN_CACHE_SIZE:
            _PLANS.popitem(last=False)
    else:
        _PLANS.move_to_end(key)
    return plan


def clear_plan_cache() -> None:
    """Drop every cached plan, and with it its graphs and their memory."""
    _PLANS.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def stage_inputs(src, dst, keep_mask, device: torch.device):
    """(src, dst) float32 and keep_mask int64 tensors on `device` from
    tensors or numpy arrays, with any leading batch dimension."""
    src = torch.as_tensor(src).to(device=device, dtype=_F32)
    dst = torch.as_tensor(dst).to(device=device, dtype=_F32)
    keep = torch.as_tensor(keep_mask).to(device=device, dtype=_I64)
    if src.shape != dst.shape or src.shape[-2] != 3 or keep.shape != src.shape[:-2] + src.shape[-1:]:
        raise ValueError(
            f"need (..., 3, C) clouds and a (..., C) keep mask, got {tuple(src.shape)}, "
            f"{tuple(dst.shape)}, {tuple(keep.shape)}"
        )
    return src, dst, keep


def psulvsb_register(
    ori_src,
    ori_dst,
    keep_mask,
    generator_or_seed,
    params: SolverParams,
    device="cuda",
    graphs: bool = True,
) -> RegistrationSolution:
    """One-dispatch PSULVSB solve of (3, C) correspondences (tensors or
    numpy), on the card unless `device="cpu"` is asked for. The semantics of
    `psulvsb_solve` with the round cap of `fused_scan_rounds` in place of
    the clock check; the same seed gives `psulvsb_solve`'s solution.

    keep_mask: (C,) in {1, 0, -1} from the pre-filter, -2 on padding.
    generator_or_seed: a torch.Generator on the device, or an int seed.
    graphs: replay captured CUDA graphs (the default on a card; a capture or
    a launch that fails raises); False, and any CPU device, runs the same
    segments eagerly, this module's plain version.

    Returns the solution alone; `plan_for(params, C, device).stats` holds the
    last solve's rounds, local batches, host reads, graph replays and native
    exact clique searches."""
    device = resolve_device(device)
    pin_float32()
    params.check_port_supported()
    src, dst, keep = stage_inputs(ori_src, ori_dst, keep_mask, device)
    if src.dim() != 2:
        raise ValueError(f"psulvsb_register solves one (3, C) pair, got {tuple(src.shape)}")
    plan = plan_for(params, src.shape[1], device, graphs)
    plan.load(src, dst, keep)
    for _ in plan.steps(as_generator(generator_or_seed, device)):
        pass
    return plan.solution()
