"""The one-dispatch PSULVSB solve: one CUDA graph launch a solve.

Counterpart of psulvsb_tpu/solver/fused.py (`fused_scan_rounds`,
`psulvsb_register`). There `jax.jit` turns the whole solve into one compiled
program: the host rounds are a `lax.scan` whose body is
`lax.cond(done, identity, run)`, the local batches a `lax.while_loop`, the
lazy clique seed a `lax.cond`, its greedy clique a `lax.while_loop`. On an
NVIDIA card the counterpart is a plan of (params, padded C, device): fixed
buffers for the inputs, the draws and the solve's state (JAX's carry, on the
device), and one CUDA graph, captured at the plan's first solve, whose
control flow is conditional nodes (solver/conditional.py), IF for a
`lax.cond` and WHILE for a `lax.while_loop`:

    IF (always): init, threshold, GROR, the eager seed (its greedy a WHILE)
    fused_scan_rounds(params) times, IF not done:
        sample stage, the rates read on the device (l_rates[rate_idx])
        [a round that can reach the last rate: IF it is the last / IF not,
         around the batches and the host stage, whose work differs there]
        WHILE the local loop is not done, at most local_max_batches(params)
        times: one local batch of hypothesis_batch hypotheses (an FGR or
        "eigh" rotation loop inside it a WHILE too)
        host stage, and the carry: rate, longholi, done, seeded
        IF points were admitted: the self-update
        IF this round escalated, no seed ran and not done: the lazy seed
            (its greedy clique a WHILE node, chunks while candidates are left)
    the solution (the host best), and IF the best count is not 0: finalize
        (the refinement, and the count of the pose it returns: one launch
        of ops/finalize.py's kernel unless the translation rescue is on)
    a stats word: rounds, local batches, whether a seed ran, greedy steps

A solve stages its inputs and its draws (one call on the caller's generator
into the plan's buffer, `solver.psulvsb.DrawLayout`) and launches the graph
once; the host reads nothing until the caller reads the solution. In a
traced plan the kernel launches a replay makes are counted on the device and
added to the kernels' counts (`ops._build.LAUNCHES`) when the plan's `stats`
or `flush_launch_counts` read them.

The plain version of this module (`graphs=False`, and any CPU device) runs
the same description eagerly: each IF is decided on the host from the words
it reads after each local batch (whether the loop is done) and after each
round (the carry's flags), rounds + batches reads in all, as the staged
`psulvsb_solve` makes them. On the CPU its greedy cliques run a fixed number
of steps (C - 1 for a seed) and its FGR and "eigh" loops every iteration
masked; on a card those loops read their flag on the host once a body.
The graph, the plain version and `psulvsb_solve`
take the same draws from the same layout, so one seed gives one solution in
all three.

One setting keeps the plain version on the card: `exact_clique_callback`
with PMC_EXACT, whose b_rate == 1.0 batches copy their graphs to the host
for the native exact clique search (`solver.psulvsb.exact_clique_points`),
as the JAX package's `pure_callback` does; a graph cannot call the host.
`gnc_rot_method="eigh"` and FGR run inside the graph in their forms that
read nothing (`sync_free`: Jacobi sweeps for the 4x4 eigenvector, every
iteration run masked).

As in the JAX module, no clock is read: the reference's wall-clock budget
(registration.cc:1475) is a projection made when the plan is built, a cap of
`fused_scan_rounds(params)` host rounds.

A plan built while tracing is on (`utils.timing.enable`) is a traced plan,
kept apart from the others in the cache: its graph stamps the card's clock
into the plan's `SpanRecord` around the whole solve and around each stage
(the names of `timing.SOLVE_SPANS`: the init with GROR, the clique seeds,
the sample stage, each local batch, the host stage, the self-update, the
solution with the refinement; where the scale is estimated, the scale peak
inside the init and the scale estimate inside each local batch; on the
"exact_beta" route, the exact beta count and the rejection fill inside the
init), the closing stamps add to the record's counters (the solve's rounds
and local batches; inits thinned to the pool's fill, scale peaks that
failed their certificate, returned counts that are not the host best's:
`timing.STAMP_COUNTERS`), and the kernels' launches are counted on the
device. An untraced plan captures none of it.
With a pair axis the stamps time the P pairs together.

A plan with `pairs=P` is `jax.vmap` of the solve over P pairs
(parallel/pairs.py's `vectorized=True`), for every setting: one program
whose every per-pair buffer has a leading P, and each stage runs once for
all P through `torch.func.vmap` (the kernels take that axis through
their operators' vmap rules: one launch for the P pairs). Every IF and
WHILE above runs while ANY pair's flag holds, and the pairs whose own flag
does not hold are frozen: a stage writes only the rows of the pairs inside
every IF and loop around it (`torch.where` on the pair masks, JAX's select
under vmap), so each pair gets what its solve alone gives. The two IFs of
the last rate both run, each on its own pairs; the clique seed runs when
some pair wants it, its greedy over every pair's graph at once with the
others' emptied. A loop inside a vmapped stage (the FGR and "eigh" rotation
loops) runs while any pair inside the current mask has a problem left
(`_any_pair_live`), each pair's problems frozen once done; the exact clique
round's host search runs once for each graph of the pairs inside it.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import OrderedDict

import torch

from psulvsb_tpu_torch.clique import pmc
from psulvsb_tpu_torch.clique.kcore import (
    greedy_clique,
    max_clique_size_for_edges,
    triangle_scores,
)
from psulvsb_tpu_torch.gror.gror import _gror_core
from psulvsb_tpu_torch.ops._build import KERNELS, LAUNCHES
from psulvsb_tpu_torch.solver.basic import WarmState
from psulvsb_tpu_torch.solver.config import (
    RATE_SCHEDULE,
    InlierSelectionMode,
    SolverParams,
)
from psulvsb_tpu_torch.solver.psulvsb import (
    DrawLayout,
    HostState,
    InitPeak,
    LocalState,
    _clique_seed_stage,
    _finalize_pose,
    _host_stage,
    _init_peak,
    _init_stage,
    _init_stage_exact_beta,
    _local_round,
    _sample_stage,
    _seed_from_clique,
    _seed_graph,
    _self_update_pairs,
    beta_count,
    fused_scan_rounds,
    gumbel_of,
    init_route,
    local_max_batches,
    peak_apart,
)
from psulvsb_tpu_torch.solver.solution import RegistrationSolution
from psulvsb_tpu_torch.utils import timing
from psulvsb_tpu_torch.utils.precision import pin_float32
from psulvsb_tpu_torch.utils.scalars import as_generator, device_flag, pick

_F32 = torch.float32
_F64 = torch.float64
_I64 = torch.int64
_LAST = len(RATE_SCHEDULE) - 1
# The slot (solver/conditional.py) of the bodies that hold (C, C) and
# (B, C, C) temporaries: the init, the clique seeds and the clique round's
# batches. Sharing one slot, they share one pool: the plan holds the
# largest of them, not their sum. It lies past the default slots of the
# deepest nesting (round, last-rate branch, batch loop).
HEAVY = 3
# What the plain version reads after a round: the carry's flags and rate.
_ROUND_WORD = ("flag.run", "flag.update", "flag.seed", "flag.refine", "carry.rate_idx")
_STATS = ("stat.rounds", "stat.batches", "carry.seeded", "stat.greedy_steps")

PLAN_CACHE_SIZE = 8  # plans kept, least recently used first out
# Device bytes a plan holds a pair (`plan_bytes`). Where a (C, C) body exists
# (the dense or gather-based init, a clique seed, the b_rate == 1.0 clique
# round), for each C^2: the (C, C) temporaries of the init and of the clique
# seed, and the (hypothesis batch, C, C) graphs of the clique round; batched
# plans measured 87 to 93 bytes a C^2 a pair on the card at C = 1889 to 8192
# (single-pair plans 55 to 121), rounded up.
PLAN_BYTES_PER_C2 = 128
# Every plan, for each byte of its draws' buffer: the buffer and the init's
# temporaries of the same sizes (the fill's pairs, window tests and sort).
# The batched exact_beta and exact_hist plans at C = 12000 measured 4.61 and
# 4.62 on the card at P = 8, rounded up.
PLAN_BYTES_PER_DRAW_BYTE = 5
_PLANS: "OrderedDict[tuple, ReplayPlan]" = OrderedDict()
# Buffers a batched plan keeps once for all its pairs; every other buffer has
# a leading pair axis. "ctl." buffers are the pair masks of the IFs and loops.
_SHARED = frozenset({"l_rates", "b_rates", "launches", "loop.index"})
_MAX_DEPTH = 6  # nesting of the solve's IFs and loops, the top level included


def plan_bytes(params: SolverParams, c: int, pairs: int | None = None) -> int:
    """Estimated device bytes of the plan of (params, C) with `pairs` pairs
    (one when None), from what its route holds: the draws' buffer and the
    init's temporaries beside it, and a (C, C) body where one exists."""
    layout = DrawLayout(params, c, fused_scan_rounds(params))
    per_pair = PLAN_BYTES_PER_DRAW_BYTE * 8 * layout.size
    clique = (params.clique_eager or params.clique_lazy
              or params.resolve_inlier_selection() != InlierSelectionMode.NONE)
    if init_route(params, c) in ("dense", "exact") or clique:
        per_pair += PLAN_BYTES_PER_C2 * c * c
    return per_pair * (pairs or 1)


@torch.library.custom_op("psulvsb_tpu_torch::any_pair_live", mutates_args=())
def _any_pair_live(flag: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Whether any pair holds both its flag and its mask bit, (P,) each: a
    loop's flag under the batched plan's vmap, where each pair's flag is
    one value of a vmapped stage (`_pair_repeat`). A 0-d flag is every
    pair's."""
    if flag.dim() == 0:
        return flag & mask.any()
    return (flag.reshape(mask.shape[0], -1).any(1) & mask).any()


@_any_pair_live.register_vmap
def _any_pair_live_vmap(info, in_dims, flag, mask):
    """The vmapped axis is the pair axis: the result is ONE flag for every
    pair, not a flag a pair (out_dims None), as `lax.while_loop` under
    `jax.vmap` tests any() of the batched predicate."""
    n = info.batch_size
    flag = flag.movedim(in_dims[0], 0) if in_dims[0] is not None else flag.expand(n, *flag.shape)
    mask = mask.movedim(in_dims[1], 0) if in_dims[1] is not None else mask
    return _any_pair_live(flag, mask), None


# -----------------------------------------------------------------------------
# State trees <-> the plan's flat buffers
# -----------------------------------------------------------------------------

_NESTED = {
    HostState: {"best": WarmState},
    LocalState: {"best": WarmState},
}
# LocalState fields the plan does not carry: batches are counted on the
# device, and the winning hypothesis' stage masks back getters that the
# one-dispatch solve does not have.
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


def _select_warm(ok: torch.Tensor, new: WarmState, old: WarmState) -> WarmState:
    """`new` where ok, else `old`; a warm state adopted is no longer the
    first (fused.py:174-181, :216-224 of the JAX module)."""
    return WarmState(
        scale=torch.where(ok, new.scale, old.scale),
        rotation=torch.where(ok, new.rotation, old.rotation),
        translation=torch.where(ok, new.translation, old.translation),
        first_time=old.first_time & ~ok,
    )


# -----------------------------------------------------------------------------
# The two controls of one description of the solve
# -----------------------------------------------------------------------------


class _Eager:
    """The plain version's control: an IF is decided on the host from the
    last word read, and a word is read where `read` is called. With
    `host_loops` (on a card) the graph's loops run their bodies while the
    flag holds, read on the host once a body (counted among the reads);
    without, the greedy cliques run their fixed step counts and the
    rotation loops their masked iterations, the same results."""

    def __init__(self, bufs: dict, host_loops: bool = False, trace=None):
        self.bufs = bufs
        self.trace = trace
        self.known: dict[str, float] = {"flag.always": 1.0, "flag.run": 1.0,
                                        "flag.refine": 0.0, "carry.rate_idx": 0.0}
        self.reads = 0
        self.repeat = self._repeat if host_loops else None

    def stamp(self, slot: int, end: bool, values=None, fill: int = 0, counter: int = 0,
              other=None) -> None:
        self.trace.stamp(slot, end, values, fill, counter, other)

    def _repeat(self, flag: torch.Tensor, body, slot: int | None = None) -> None:
        while bool(flag):
            self.reads += 1
            flag = body()
        self.reads += 1

    def loop(self, name: str, count: int, body, slot: int | None = None) -> None:
        """body(k) for k = 0, 1, ... while the flag holds, at most `count`
        times, the flag read after each."""
        for k in range(count):
            if not self.known[name]:
                break
            body(k)
            self.read(name)

    def when_flag(self, flag: torch.Tensor, slot: int | None = None):
        """An IF decided on the host from the flag's value, read now."""
        self.reads += 1
        if bool(flag):
            yield

    def when(self, name: str, slot: int | None = None):
        if name == "flag.round_last":
            taken = self.known["carry.rate_idx"] == _LAST
        elif name == "flag.round_not_last":
            taken = self.known["carry.rate_idx"] != _LAST
        else:
            taken = bool(self.known[name])
        if taken:
            yield

    def know(self, name: str, value: bool) -> None:
        self.known[name] = float(value)

    def read(self, *names: str) -> None:
        word = torch.stack([self.bufs[n].to(_F64).reshape(()) for n in names]).tolist()
        self.known.update(zip(names, word))
        self.reads += 1


class _Captured:
    """The graph's control: an IF is a conditional node on the flag's
    buffer, and nothing is read."""

    def __init__(self, bufs: dict, control):
        self.bufs = bufs
        self.control = control
        self.repeat = control.repeat
        self.trace = control.trace
        self.stamp = control.stamp

    def when(self, name: str, slot: int | None = None):
        with self.control.when(self.bufs[name], slot):
            yield

    def when_flag(self, flag: torch.Tensor, slot: int | None = None):
        with self.control.when(flag, slot):
            yield

    def loop(self, name: str, count: int, body, slot: int | None = None) -> None:
        """A WHILE node: body(k), k a counter on the device, while the flag
        holds and k < count (`lax.while_loop`)."""
        k = self.bufs["loop.index"]
        k.zero_()
        flag = self.bufs[name]

        def step():
            body(k)
            k.add_(1)
            return flag & (k < count)

        self.control.repeat(flag & (k < count), step, slot)

    def know(self, name: str, value: bool) -> None:
        pass

    def read(self, *names: str) -> None:
        pass


def _warm_libraries(device: torch.device) -> None:
    """Library calls whose state is kept per stream (cuBLAS's workspace)."""
    a = torch.ones((4, 8, 8), device=device)
    torch.bmm(a, a)
    a[0] @ a[0]


# -----------------------------------------------------------------------------
# The plan
# -----------------------------------------------------------------------------


class ReplayPlan:
    """The buffers and the graph of one (params, C, device), or of P pairs
    at once with `pairs=P` (module docstring).

    `bufs` holds every tensor that outlives a stage at a fixed address: the
    inputs (`src`, `dst`, `keep`), the draws, the rate tables, the solve's
    state under dotted names ("hs.best.rotation"), the carry and the flags
    ("carry.done", "flag.run"), the stats and the solution ("sol.rotation").
    A stage is a pure function of `bufs` that returns the entries it
    replaces, which `_apply` copies into place; the graph captures that.
    With a pair axis the stage runs under `torch.func.vmap` and `_apply`
    writes only the rows of the pairs that the IFs and loops around it let
    through.

    One plan runs one solve at a time, on `stream` when it has one (the
    batch's concurrent form gives each instance its own). `traced`: the
    plan keeps a `timing.SpanRecord` (`trace`) that its solves stamp. Where
    the scale is estimated on a route of `peak_apart`, the init computes the
    scale peak first (`_peak`, a span of its own in a traced plan) and hands
    it to the rest of the init (`_prologue`); on the "exact_beta" route
    (`beta_apart`) it computes the exact beta count (`_beta`) and then the
    rejection fill (`_fill`), a span each, and hands the reduced set to the
    solve's start (`_start`)."""

    def __init__(self, params: SolverParams, c: int, device: torch.device, graphs: bool,
                 stream=None, pairs: int | None = None, traced: bool = False):
        self.params = params
        self.c = c
        self.device = device
        self.stream = stream
        self.pairs = pairs
        if pairs is not None and pairs < 1:
            raise ValueError(f"a plan with a pair axis needs pairs >= 1, got {pairs}")
        self.rounds = fused_scan_rounds(params)
        self.max_batches = local_max_batches(params)
        self.layout = DrawLayout(params, c, self.rounds)
        cuda = device.type == "cuda"
        self.exact_clique = (
            params.resolve_inlier_selection() == InlierSelectionMode.PMC_EXACT
            and params.exact_clique_callback
        )
        # The exact clique round calls the host: that plan runs eagerly.
        self.graphs = graphs and cuda and not self.exact_clique
        # Jacobi sweeps read nothing on the host, which torch.linalg.eigh does
        # (it cannot be captured); on the CPU, where nothing is captured, the
        # staged solver's eigh keeps the two solvers equal to the last bit.
        self.rot_method = "jacobi" if cuda else "eigh"
        # The same choice for an "eigh" or FGR rotation inside the graph.
        self.sync_free = cuda
        self.graph = None
        self.control = None
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self.build_s = 0.0  # the first solve: its eager run, capture, instantiate
        self.capture_s = 0.0
        self.instantiate_s: float | None = 0.0  # None: inside capture_s (older releases)
        self.pool_bytes = 0
        self.graph_nodes: int | None = None
        self.conditional_nodes = 0
        self.stamp_nodes = 0  # the graph's stamp kernels (traced plans)
        self.mark_nodes = 0  # the graph's launch-count additions (traced plans)
        self.captured_launches: dict[str, int] = {}  # kernel -> its launches in the graph
        self.solves = 0
        self.graph_launches = 0  # replays of the graph, every solve so far
        self._stats: dict = {}
        self._host_stats: dict = {}
        self._pending = False
        self._masks: list[torch.Tensor] = []  # the pair masks of the IFs and loops open now
        with self._on_stream():
            self.bufs = self._fixed_buffers()
            self.trace = timing.SpanRecord(
                timing.SOLVE_SPANS, device, self.bufs["stat.rounds"], self.bufs["stat.batches"],
                pairs or 1, f"C={c}" + (f" P={pairs}" if pairs else ""), stream,
            ) if traced else None
        self._slots = {name: k for k, name in enumerate(timing.SOLVE_SPANS)}
        self.peak_apart = peak_apart(params, c)
        self._peak_out: tuple = ()  # the init's scale peak (`_peak`), inside the init span
        self.beta_apart = init_route(params, c) == "exact_beta"

    # ---- buffers ------------------------------------------------------------

    def _fixed_buffers(self) -> dict:
        c, dev = self.c, self.device
        lead = () if self.pairs is None else (self.pairs,)
        bufs = {
            "src": torch.zeros(lead + (3, c), dtype=_F32, device=dev),
            "dst": torch.zeros(lead + (3, c), dtype=_F32, device=dev),
            "keep": torch.zeros(lead + (c,), dtype=_I64, device=dev),
            "draws": torch.zeros(lead + (self.layout.size,), dtype=_I64, device=dev),
            "l_rates": torch.tensor([r[0] for r in RATE_SCHEDULE], dtype=_F32).to(dev),
            "b_rates": torch.tensor([r[1] for r in RATE_SCHEDULE], dtype=_F32).to(dev),
            "launches": torch.zeros(len(KERNELS), dtype=_I64, device=dev),
            "carry.seeded": torch.zeros(lead, dtype=torch.bool, device=dev),
            "flag.always": torch.ones(lead, dtype=torch.bool, device=dev),
            "loop.index": torch.zeros((), dtype=_I64, device=dev),
        }
        for name in ("stat.rounds", "stat.batches", "stat.greedy_steps"):
            bufs[name] = torch.zeros(lead, dtype=_I64, device=dev)
        if self.pairs is not None:
            for d in range(_MAX_DEPTH):
                bufs[f"ctl.mask{d}"] = torch.ones(lead, dtype=torch.bool, device=dev)
                bufs[f"ctl.any{d}"] = torch.ones((), dtype=torch.bool, device=dev)
        return bufs

    @property
    def nbytes(self) -> int:
        """Device bytes the plan holds: its buffers and its graph's pools."""
        own = sum(t.numel() * t.element_size() for t in self.bufs.values())
        return own + self.pool_bytes + (self.trace.nbytes if self.trace is not None else 0)

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _apply(self, out: dict) -> None:
        """Copy a stage's results into their buffers (a first result makes
        its buffer): one multi-tensor copy for each pair of types, in place
        of a copy a buffer. A result that is itself a buffer written here is
        copied out first, so the order of the copies does not matter. With a
        pair axis a buffer takes the new rows of the pairs in the innermost
        mask and keeps the others (`torch.where`, JAX's select under vmap)."""
        bufs = self.bufs
        mask = self._masks[-1] if self._masks else None
        written = {bufs[n].data_ptr() for n in out if n in bufs}
        groups: dict[tuple, tuple[list, list]] = {}
        for name, value in out.items():
            dest = bufs.get(name)
            if dest is None:
                bufs[name] = value.clone()
            elif dest is not value:
                if mask is not None:
                    value = torch.where(mask.view((-1,) + (1,) * (dest.dim() - 1)), value, dest)
                elif value.data_ptr() in written:
                    value = value.clone()
                dests, values = groups.setdefault((dest.dtype, value.dtype), ([], []))
                dests.append(dest)
                values.append(value)
        for dests, values in groups.values():
            torch._foreach_copy_(dests, values)

    def _vmap(self, fn, b: dict, *per_pair):
        """fn(b, *per_pair) for every pair: as it is on a single pair, or
        once for all under torch.func.vmap over the pair axis (b's shared
        buffers unmapped). An operation without a batching rule, which vmap
        would run pair by pair, raises: the batched form is one program."""
        if self.pairs is None:
            return fn(b, *per_pair)
        dims = {k: None if k in _SHARED or k.startswith("ctl.") else 0 for k in b}
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            return torch.func.vmap(fn, in_dims=(dims,) + (0,) * len(per_pair),
                                   randomness="error")(b, *per_pair)

    # ---- the stages -----------------------------------------------------------

    def _peak(self, b: dict) -> tuple:
        """The init's scale peak (`solver.psulvsb._init_peak`): its tensors,
        an `InitPeak` without the fields it leaves None."""
        peak = _init_peak(b["src"], b["dst"], b["keep"], self.params,
                          self.layout.pairs(b["draws"], "peak"))
        return tuple(t for t in peak if t is not None)

    def _beta(self, b: dict) -> torch.Tensor:
        """The "exact_beta" init's exact reduced-set size
        (`solver.psulvsb.beta_count`, the pair_beta_count kernel)."""
        return beta_count(b["src"], b["dst"], b["keep"], self.params)

    def _fill(self, b: dict, red_exact: torch.Tensor) -> tuple:
        """The "exact_beta" init's reduced set around its exact size: the
        rejection fill and its compaction (red_i, red_j, red_count, pool)."""
        return _init_stage_exact_beta(b["src"], b["dst"], b["keep"], self.params,
                                      self.layout.init_draws(b["draws"]), red_exact)

    def _prologue(self, b: dict, *peak: torch.Tensor) -> dict:
        """The init's reduced set, around the scale peak `peak` where there
        is one, and the solve's start (`_start`)."""
        peak = InitPeak(*peak, *(None,) * (len(InitPeak._fields) - len(peak))) if peak else None
        return self._start(b, *_init_stage(b["src"], b["dst"], b["keep"], self.params, None,
                                           self.layout.init_draws(b["draws"]), peak))

    def _start(self, b: dict, red_i: torch.Tensor, red_j: torch.Tensor, red_count: torch.Tensor,
               red_pool: torch.Tensor) -> dict:
        """The solve's start from the init's reduced set: the threshold,
        GROR and the initial state."""
        p, c, dev = self.params, self.c, self.device
        src, dst, keep = b["src"], b["dst"], b["keep"]
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
        _flatten("hs", HostState.initial(c, keep), out)
        _flatten("warm", warm, out)
        _flatten("best_sampled", warm, out)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        out.update({
            "carry.rate_idx": torch.zeros((), dtype=_I64, device=dev),
            "carry.longholi": false, "carry.done": false, "carry.seeded": false,
            "flag.run": ~false, "flag.refine": false,
        })
        return out

    def _seed(self, b: dict, active: str, ctl, prefixes: tuple[str, ...]) -> dict:
        """The clique seed over the pool and the points whose `active`
        buffer is 1: its greedy runs on the device until no candidate is left
        (graph) or a fixed C - 1 steps (plain version). A seed that holds
        enough members replaces the warm state, written under each of
        `prefixes`. With a pair axis the greedy runs once over every pair's
        graph, those of the pairs outside the current mask emptied."""
        p = self.params
        max_steps = None if ctl.repeat else max(self.c - 1, 0)

        def seed_warm(bb, warm_seed, ok):
            out = {}
            for prefix in prefixes:
                _flatten(prefix, _select_warm(ok, warm_seed, _load(WarmState, "warm", bb)), out)
            return out

        if self.pairs is None:
            sw, ok, _ = _clique_seed_stage(
                b["src"], b["dst"], b["red_i"], b["red_j"], b["red_pool"], p, b[active] == 1,
                None, scale_u=self.layout.seed_u(b["draws"]), max_steps=max_steps,
                sync_free=self.sync_free, repeat=ctl.repeat, steps_run=b["stat.greedy_steps"],
            )
            return seed_warm(b, sw, ok)
        adj = self._vmap(lambda bb: _seed_graph(
            bb["src"], bb["dst"], bb["red_i"], bb["red_j"], bb["red_pool"], p, bb[active] == 1), b)
        wants = self._masks[-1][:, None].expand(adj.shape[:-1])
        clique, _ = greedy_clique(adj, wants, order_scores=triangle_scores(adj),
                                  max_steps=max_steps, repeat=ctl.repeat,
                                  steps_run=b["stat.greedy_steps"])

        repeat = self._pair_repeat(ctl)

        def finish(bb, cl):
            sw, ok = _seed_from_clique(bb["src"], bb["dst"], cl, p, None,
                                       self.layout.seed_u(bb["draws"]), self.sync_free, repeat)
            return seed_warm(bb, sw, ok)

        return self._vmap(finish, b, clique)

    def _local_round(self, b: dict, b_rate, b_one: bool, repeat=None, live=None,
                     scale_span=contextlib.nullcontext, with_start: bool = True):
        # A hypothesis' graph at the b_rate == 1.0 round has at most basic_cap
        # edges, which bounds its clique, so a fixed step count is exact.
        bcap = min(self.params.basic_cap, b["s_i"].shape[0])
        return _local_round(
            b["src"], b["dst"], b["s_i"], b["s_j"], b["s_ok"], b["s_count"], b["s_pts"],
            b_rate, b_one, b["hs.host_r"], _load(WarmState, "warm", b), b["thr"],
            self.params, clique_max_steps=max_clique_size_for_edges(bcap), track_extras=False,
            sync_free=self.sync_free, repeat=repeat, clique_live=live, scale_span=scale_span,
            with_start=with_start,
        )

    def _sample(self, b: dict, r: int) -> dict:
        rate_idx = b["carry.rate_idx"]
        s_i, s_j, s_ok, s_count, s_pts = _sample_stage(
            b["red_i"], b["red_j"], b["red_count"], b["red_pool"], pick(b["l_rates"], rate_idx),
            self.params, self.c, gumbel=gumbel_of(self.layout.uniform(b["draws"], "u_sample", r)),
        )
        out = {"s_i": s_i, "s_j": s_j, "s_ok": s_ok, "s_count": s_count, "s_pts": s_pts}
        start, _ = self._local_round({**b, **out}, pick(b["b_rates"], rate_idx), False)
        _flatten("local", start, out, skip=_LOCAL_SKIP)
        last = rate_idx == _LAST
        out.update({"flag.batch": ~start.done, "flag.round_last": last,
                    "flag.round_not_last": ~last, "stat.rounds": b["stat.rounds"] + 1})
        return out

    def _local(self, b: dict, r: int, k, b_one: bool, repeat=None, live=None,
               scale_span=contextlib.nullcontext) -> dict:
        b_rate = 1.0 if b_one else pick(b["b_rates"], b["carry.rate_idx"])
        _, step = self._local_round(b, b_rate, b_one, repeat, live, scale_span, with_start=False)
        # The plan carries no stage masks (_LOCAL_SKIP), so the state has none.
        state = _load(LocalState, "local", b, iterations=0, host_syncs=0, extras=None)
        # The batch's raw draws: the pick takes their Gumbel keys itself.
        draws = b["draws"]
        state = step(state, self.layout.view(draws, "u_local", r, k),
                     self.layout.scale_u(draws, r, k))
        out = _flatten("local", state, {}, skip=_LOCAL_SKIP)
        out.update({"flag.batch": ~state.done, "stat.batches": b["stat.batches"] + 1})
        return out

    def _host(self, b: dict, r: int, b_one: bool) -> dict:
        p, dev = self.params, self.device
        hs = _load(HostState, "hs", b)
        best_sampled = _load(WarmState, "local.best", b)
        hs, new_corr, _ = _host_stage(
            b["src"], b["dst"], hs, best_sampled, b["local.local_r"], b_one, b["thr"],
            p, u=self.layout.uniform(b["draws"], "u_host", r),
        )
        out = _flatten("hs", hs, {"new_corr": new_corr})
        _flatten("best_sampled", best_sampled, out)
        _flatten("warm", hs.best._replace(first_time=device_flag(False, dev)), out)
        # The carry (fused.py:160-199 of the JAX module); the stop checks of
        # registration.cc:1475-1484, pro_host compared in float64 as the
        # staged solver compares it on the host.
        rate_idx, longholi = b["carry.rate_idx"], b["carry.longholi"]
        escalate, seeded = b["local.escalate"], b["carry.seeded"]
        stop = (hs.pro_host.to(_F64) > p.host_confidence) | longholi
        want = escalate & ~seeded & ~stop if p.clique_lazy else torch.zeros_like(stop)
        out.update({
            "carry.done": stop,
            "carry.longholi": longholi | (rate_idx == _LAST),
            "carry.rate_idx": torch.where(escalate & (rate_idx < _LAST), rate_idx + 1, rate_idx),
            "carry.seeded": seeded | want,
            "flag.run": ~stop, "flag.update": new_corr.any() & ~stop, "flag.seed": want,
            "flag.refine": hs.best_count != 0,
        })
        return out

    def _self_update(self, b: dict) -> dict:
        red_i, red_j, red_count, red_pool = _self_update_pairs(
            b["red_i"], b["red_j"], b["red_count"], b["red_pool"], b["new_corr"],
            b["hs.inl_kept"], self.params,
        )
        return {"red_i": red_i, "red_j": red_j, "red_count": red_count, "red_pool": red_pool}

    def _solution(self, b: dict) -> dict:
        return {"sol.valid": b["hs.best_count"] > 0, "sol.scale": b["hs.best.scale"],
                "sol.rotation": b["hs.best.rotation"],
                "sol.translation": b["hs.best.translation"],
                "sol.count": b["hs.best_count"]}

    def _finalize(self, b: dict) -> dict:
        """The refinement, and the count of the pose it returns: on a card
        one launch of the finalize kernel unless the translation rescue is
        on (`solver.psulvsb._finalize_pose`)."""
        rotation, translation, count = _finalize_pose(
            b["src"], b["dst"], _load(HostState, "hs", b), _load(WarmState, "best_sampled", b),
            b["thr"], self.params, rot_method=self.rot_method,
        )
        return {"sol.rotation": rotation, "sol.translation": translation, "sol.count": count}

    def _local_batch(self, ctl, b: dict, r: int, k, b_one: bool) -> dict:
        """One local batch. With a pair axis its rotation loops test any pair
        inside the loop's mask (`_pair_repeat`), and the exact clique round
        searches the graphs of those pairs alone (each pair's flag `live`).
        A traced plan stamps its scale estimate (`solve.local.scale`)."""
        def span():
            return self._span(ctl, "solve.local.scale")

        if self.pairs is None:
            return self._local(b, r, k, b_one, ctl.repeat, scale_span=span)
        repeat = self._pair_repeat(ctl)
        if self.exact_clique and b_one:
            return self._vmap(lambda bb, live: self._local(bb, r, k, b_one, repeat, live, span),
                              b, self._masks[-1])
        return self._vmap(lambda bb: self._local(bb, r, k, b_one, repeat, scale_span=span), b)

    # ---- the control flow, one pair or a pair axis ---------------------------

    def _pair_repeat(self, ctl):
        """`ctl.repeat` for a loop inside a vmapped stage: the loop's flag, a
        value a pair there, becomes one flag, whether any pair inside the
        current mask holds it (`lax.while_loop` under `jax.vmap`). A pair
        that no longer holds it changes nothing as the loop goes on (each
        loop freezes its own finished problems), and the rows of pairs
        outside the mask are dropped by `_apply`."""
        mask = self._masks[-1]

        def repeat(flag, body, slot=None):
            ctl.repeat(_any_pair_live(flag, mask), lambda: _any_pair_live(body(), mask), slot)

        return repeat

    def _when(self, ctl, name: str, slot: int | None = None):
        """The body runs when the flag holds (an IF). With a pair axis: when
        it holds for any pair inside the current mask, the body's mask those
        pairs, taken as the IF is reached."""
        if self.pairs is None:
            yield from ctl.when(name, slot)
            return
        b, depth = self.bufs, len(self._masks)
        mask, taken = b[f"ctl.mask{depth}"], b[f"ctl.any{depth}"]
        torch.logical_and(b[name], self._masks[-1], out=mask)
        torch.any(mask, dim=0, out=taken)
        for _ in ctl.when_flag(taken, slot):
            self._masks.append(mask)
            try:
                yield
            finally:
                self._masks.pop()

    def _loop(self, ctl, name: str, count: int, body, slot: int | None = None) -> None:
        """body(k), k = 0, 1, ... while the flag holds, at most `count` times
        (a WHILE). With a pair axis: while it holds for any pair inside the
        current mask, each run's mask those pairs, taken before it."""
        if self.pairs is None:
            ctl.loop(name, count, body, slot)
            return
        b, depth = self.bufs, len(self._masks)
        outer = self._masks[-1]
        mask, again = b[f"ctl.mask{depth}"], b[f"ctl.any{depth}"]
        k = b["loop.index"]
        k.zero_()

        def refresh():
            torch.logical_and(b[name], outer, out=mask)
            torch.logical_and(mask.any(), k < count, out=again)
            return again

        def step():
            body(k)
            k.add_(1)
            return refresh()

        self._masks.append(mask)
        try:
            ctl.repeat(refresh(), step, slot)
        finally:
            self._masks.pop()

    # ---- the solve, described once for both controls -------------------------

    def _span(self, ctl, name: str, counter: str | None = None):
        """Stamps around a stage where the control traces (a traced plan's
        graph and its plain version), else nothing. A control without a
        `trace` traces nothing. `counter`, one of `timing.STAMP_COUNTERS`:
        the closing stamp adds the pairs it counts (`_counted`)."""
        if getattr(ctl, "trace", None) is None:
            return contextlib.nullcontext()
        return self._stamped(ctl, self._slots[name], counter)

    def _counted(self, counter: str) -> tuple:
        """(values, fill, other) that a closing stamp reads for `counter`,
        from what the graph holds as the span closes, so that counting adds
        no buffer and no operation: `init_thinned`, the pairs whose reduced
        set (`red_count`, the init's) outgrew the pool's fill, so that the
        init's priority, not membership alone, chose the pool;
        `init_uncertified`, the pairs whose scale peak failed the
        histogram's certificate; `count_refit`, the pairs whose returned
        count is not the host best's."""
        b = self.bufs
        if counter == "init_thinned":
            return b["red_count"], self.params.pool_fill, None
        if counter == "init_uncertified":
            return self._peak_out[1], 0, None  # InitPeak.certified
        return b["sol.count"], 0, b["hs.best_count"]

    @contextlib.contextmanager
    def _stamped(self, ctl, slot: int, counter: str | None = None):
        ctl.stamp(slot, False)
        yield
        if counter is None:
            ctl.stamp(slot, True)
        else:
            values, fill, other = self._counted(counter)
            ctl.stamp(slot, True, values, fill, timing.STAMP_COUNTERS.index(counter), other)

    def _local_step(self, ctl, b: dict, r: int, k, b_one: bool) -> None:
        with self._span(ctl, "solve.local"):
            self._apply(self._local_batch(ctl, b, r, k, b_one))

    def _solve(self, ctl) -> None:
        """Mirrors `psulvsb_solve`'s loop; `ctl` decides each IF (module
        docstring)."""
        p, b = self.params, self.bufs
        batched = self.pairs is not None
        with self._span(ctl, "solve"):
            for name in ("stat.rounds", "stat.batches", "stat.greedy_steps"):
                b[name].zero_()
            self._masks = [b["flag.always"]] if batched else []
            for _ in self._when(ctl, "flag.always", HEAVY):
                with self._span(ctl, "solve.init", "init_thinned"):
                    if self.beta_apart:
                        with self._span(ctl, "solve.init.beta"):
                            red_exact = self._vmap(self._beta, b)
                        with self._span(ctl, "solve.init.fill"):
                            reduced = self._vmap(self._fill, b, red_exact)
                        self._apply(self._vmap(self._start, b, *reduced))
                    else:
                        if self.peak_apart:
                            with self._span(ctl, "solve.init.peak", "init_uncertified"):
                                self._peak_out = self._vmap(self._peak, b)
                        self._apply(self._vmap(self._prologue, b, *self._peak_out))
                        self._peak_out = ()
                if p.clique_eager:  # a successful seed wins over GROR's
                    with self._span(ctl, "solve.clique_seed"):
                        self._apply(self._seed(b, "keep", ctl, ("warm", "best_sampled")))
            for r in range(self.rounds):
                self._round(ctl, r)
            with self._span(ctl, "solve.finalize", "count_refit"):
                self._apply(self._vmap(self._solution, b))
                if p.enable_refinement:
                    for _ in self._when(ctl, "flag.refine"):
                        self._apply(self._vmap(self._finalize, b))

    def _round(self, ctl, r: int) -> None:
        """Host round r of the solve, inside the IF of whether it runs."""
        p, b = self.params, self.bufs
        for _ in self._when(ctl, "flag.run"):
            with self._span(ctl, "solve.sample"):
                self._apply(self._vmap(lambda bb: self._sample(bb, r), b))
            ctl.know("flag.batch", True)
            # Only from round _LAST on can the rate be the last one.
            branches = [(False, "flag.round_not_last"), (True, "flag.round_last")]
            for b_one, flag in (branches if r >= _LAST else branches[:1]):
                for _ in (self._when(ctl, flag) if r >= _LAST else [None]):
                    self._loop(ctl, "flag.batch", self.max_batches,
                               lambda k, b_one=b_one: self._local_step(ctl, b, r, k, b_one),
                               HEAVY if b_one else None)
                    with self._span(ctl, "solve.host"):
                        self._apply(self._vmap(lambda bb, b_one=b_one: self._host(bb, r, b_one),
                                               b))
            if self.pairs is None:
                ctl.read(*_ROUND_WORD)
            for _ in self._when(ctl, "flag.update"):
                with self._span(ctl, "solve.self_update"):
                    self._apply(self._vmap(self._self_update, b))
            if p.clique_lazy:
                for _ in self._when(ctl, "flag.seed", HEAVY):
                    with self._span(ctl, "solve.clique_seed"):
                        self._apply(self._seed(b, "hs.keep_mask", ctl, ("warm",)))

    def _capture(self) -> None:
        """Capture the whole solve into one graph. The plain version runs
        once first, on the staged inputs: it builds the kernels, warms the
        libraries and makes the buffers; the launch that follows the capture
        overwrites its results. A capture that fails raises: there is no
        other way on the card."""
        from psulvsb_tpu_torch.solver.conditional import GraphControl

        dev = self.device
        t0 = time.perf_counter()
        self._solve(_Eager(self.bufs, host_loops=True))
        control = GraphControl(dev, self.bufs["launches"], self.trace)
        control.warm(HEAVY + 2, lambda: _warm_libraries(dev))
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = dict(LAUNCHES)
        try:
            graph, separate = torch.cuda.CUDAGraph(keep_graph=True), True
        except TypeError:  # a release without keep_graph instantiates at capture_end
            graph, separate = torch.cuda.CUDAGraph(), False
        t_capture = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=control.capture_stream):
                control.marked = dict(LAUNCHES)
                self._solve(_Captured(self.bufs, control))
                control.mark()
                top = control.top_nodes()
        finally:
            control.close()
            self.captured_launches = {k: LAUNCHES[k] - before[k] for k in KERNELS
                                      if LAUNCHES[k] > before[k]}
            LAUNCHES.update(before)  # a capture launches nothing
        t1 = time.perf_counter()
        self.capture_s = t1 - t_capture
        if separate:
            graph.instantiate()
            torch.cuda.synchronize(dev)
        self.instantiate_s = time.perf_counter() - t1 if separate else None
        self.pool_bytes = max(0, torch.cuda.memory_reserved(dev) - reserved)
        self.graph_nodes = None if top is None else top + control.nodes
        self.conditional_nodes = control.conditionals
        self.stamp_nodes, self.mark_nodes = control.stamps, control.marks
        self.graph, self.control = graph, control
        self.build_s = time.perf_counter() - t0

    # ---- one solve ------------------------------------------------------------

    def _run(self) -> None:
        """The solve on the staged buffers: one graph launch, or the plain
        version."""
        if self.graphs:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.graph_launches += 1
            self._host_stats = {"host_reads": 0, "graph_launches": 1,
                                "exact_clique_searches": 0}
        else:
            # The batched plain version runs its loops while any pair's flag
            # holds, read on the host once a body.
            ctl = _Eager(self.bufs, host_loops=self.device.type == "cuda" or bool(self.pairs),
                         trace=self.trace)
            searches = pmc.EXACT_SEARCHES
            self._solve(ctl)
            self._host_stats = {"host_reads": ctl.reads, "graph_launches": 0,
                                "exact_clique_searches": pmc.EXACT_SEARCHES - searches}
        self.solves += 1
        self._pending = True

    def solve(self, src: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
              generator) -> None:
        """Stage one pair and its draws into the plan's buffers and run the
        solve: one graph launch, or the plain version. With a pair axis:
        (P, 3, C) clouds, a (P, C) keep mask and P generators, row p's
        draws from generator p (each pair draws what its solve alone
        draws). A traced plan's host span "plan.solve" carries the index
        of the solve's device span."""
        index = self.trace.next_index() if self.trace is not None else None
        with self._on_stream(), timing.span("plan.solve", index=index, c=self.c):
            self.bufs["src"].copy_(src, non_blocking=True)
            self.bufs["dst"].copy_(dst, non_blocking=True)
            self.bufs["keep"].copy_(keep, non_blocking=True)
            if self.pairs is None:
                self.layout.fill(generator, self.device, out=self.bufs["draws"])
            else:
                if len(generator) != self.pairs:
                    raise ValueError(f"{self.pairs} pairs need {self.pairs} generators, "
                                     f"got {len(generator)}")
                for row, gen in zip(self.bufs["draws"], generator):
                    self.layout.fill(gen, self.device, out=row)
            self._run()

    def flush_launches(self) -> None:
        """Add the launches counted on the device to the kernels' counts
        (a traced plan's graph counts them)."""
        if not self.graphs or self.trace is None:
            return
        with self._on_stream():
            launches = self.bufs["launches"].tolist()
            self.bufs["launches"].zero_()
        for name, added in zip(KERNELS, launches):
            LAUNCHES[name] += added

    @property
    def stats(self) -> dict:
        """The last solve's rounds, local batches, whether a clique seed ran,
        the steps its device-loop greedy took, host reads, graph launches and
        native exact clique searches; {} before the first solve. With a pair
        axis the first four are lists, one entry a pair. Reading it after a
        solve reads the device (and flushes the launch counts)."""
        if self._pending:
            with self._on_stream():
                word = torch.stack([self.bufs[n].to(_I64) for n in _STATS]).tolist()
            rounds, batches, seeded, steps = word
            seeded = [bool(s) for s in seeded] if self.pairs else bool(seeded)
            self._stats = {"rounds": rounds, "local_batches": batches, "seeded": seeded,
                           "seed_greedy_steps": steps, **self._host_stats}
            self._pending = False
            self.flush_launches()
        return self._stats

    @stats.setter
    def stats(self, value: dict) -> None:
        self._stats = dict(value)
        self._pending = False

    def solution(self, out: RegistrationSolution | None = None, index: int | None = None,
                 count: int | None = None):
        """The finished solve's solution: fresh tensors, or written into row
        `index` of the batch solution `out`. With a pair axis, the first
        `count` pairs' (all by default) into rows index, index + 1, ..."""
        b = self.bufs
        with self._on_stream():
            fields = RegistrationSolution(
                valid=b["sol.valid"], scale=b["sol.scale"], rotation=b["sol.rotation"],
                translation=b["sol.translation"], final_inlier_count=b["sol.count"],
            )
            if self.pairs is not None:
                count = self.pairs if count is None else count
                fields = RegistrationSolution(*(t[:count] for t in fields))
            if out is None:
                return RegistrationSolution(*(t.clone() for t in fields))
            rows = index if self.pairs is None else slice(index, index + count)
            for dest, value in zip(out, fields):
                dest[rows].copy_(value, non_blocking=True)
        return out

    def release(self) -> None:
        """Drop the graph and give its memory back; the launch counts and
        the span record are read first."""
        self.flush_launches()
        if self.trace is not None:
            self.trace.read()
        self.graph = None
        if self.control is not None:
            self.control.release()
            self.control = None


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
             instance: int = 0, pairs: int | None = None) -> ReplayPlan:
    """The cached plan of (params, C, device), built at first use; `graphs`
    holds on CUDA devices only. Instances beyond 0 are further plans of the
    same key on streams of their own, for solves in flight at once. `pairs`:
    the plan of P pairs at once (the batched form). While tracing is on
    (`utils.timing`) the plan is a traced plan, cached apart."""
    device = resolve_device(device)
    graphs = bool(graphs) and device.type == "cuda"
    traced = timing.enabled()
    key = (params, int(c), device, graphs, int(instance), pairs, traced)
    plan = _PLANS.get(key)
    if plan is None:
        if device.type == "cuda":
            _make_room(device, plan_bytes(params, c, pairs))
        stream = torch.cuda.Stream(device) if instance and device.type == "cuda" else None
        plan = ReplayPlan(params, int(c), device, graphs, stream, pairs, traced)
        _PLANS[key] = plan
        while len(_PLANS) > PLAN_CACHE_SIZE:
            _PLANS.popitem(last=False)[1].release()
    else:
        _PLANS.move_to_end(key)
    return plan


def _make_room(device: torch.device, nbytes: int) -> None:
    """Drop the cached plans of `device`, least recently used first, until
    the card has `nbytes` free for a new plan (or none is left): a plan
    holds up to C^2 bytes a pair (`plan_bytes`), so the cache's count alone
    does not bound its memory. Work still queued ends first; memory the
    allocator caches and no tensor holds goes back before each look."""
    torch.cuda.synchronize(device)
    while True:
        torch.cuda.empty_cache()
        if torch.cuda.mem_get_info(device)[0] >= nbytes:
            return
        old = next((key for key in _PLANS if key[2] == device), None)
        if old is None:
            return
        _PLANS.pop(old).release()


def flush_launch_counts() -> None:
    """Add every cached plan's launches, counted on the device, to the
    kernels' counts (one read of the device a plan with a graph)."""
    for plan in _PLANS.values():
        plan.flush_launches()


def clear_plan_cache() -> None:
    """Drop every cached plan, and with it its graph and their memory."""
    while _PLANS:
        _PLANS.popitem(last=False)[1].release()
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
    graphs: one launch of the plan's CUDA graph (the default on a card; a
    capture or a launch that fails raises); False, and any CPU device, runs
    the same solve eagerly, this module's plain version.

    Returns the solution alone, without waiting for the device;
    `plan_for(params, C, device).stats` holds the last solve's rounds, local
    batches, host reads, graph launches and native exact clique searches."""
    device = resolve_device(device)
    pin_float32()
    params.check_port_supported()
    src, dst, keep = stage_inputs(ori_src, ori_dst, keep_mask, device)
    if src.dim() != 2:
        raise ValueError(f"psulvsb_register solves one (3, C) pair, got {tuple(src.shape)}")
    plan = plan_for(params, src.shape[1], device, graphs)
    plan.solve(src, dst, keep, as_generator(generator_or_seed, device))
    return plan.solution()
