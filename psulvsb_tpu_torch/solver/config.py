"""Solver configuration: one frozen dataclass with the same fields, defaults,
presets and enum values as `psulvsb_tpu.solver.config`, so a configuration
moves between the two packages field by field (see `convert.params_from_jax`).

Field-by-field parity with teaser::RobustRegistrationSolver::Params
(registration.h:378-473) plus the constants the reference hard-codes in
registration.cc (noise bounds, loop limits, the rate schedule, the 60 s
budget). Every setting of the solver runs; `check_port_supported` is kept
for its callers and validates `clique_init` only.
"""

from __future__ import annotations

import dataclasses
import enum


class RotationEstimationAlgorithm(enum.IntEnum):
    """registration.h:343-346."""

    GNC_TLS = 0
    FGR = 1


class InlierSelectionMode(enum.IntEnum):
    """registration.h:356-361."""

    PMC_EXACT = 0
    PMC_HEU = 1
    KCORE_HEU = 2
    NONE = 3


class InlierGraphFormulation(enum.IntEnum):
    """registration.h:370-373."""

    CHAIN = 0
    COMPLETE = 1


# Rate escalation ladder: (L_sampled_rate, b_sampled_rate) —
# registration.cc:776-777 initial values and :1377-1388 transitions.
RATE_SCHEDULE = ((0.1, 0.3), (0.2, 0.3), (0.5, 0.3), (1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class SolverParams:
    # --- teaser::RobustRegistrationSolver::Params parity -------------------
    noise_bound: float = 0.01
    cbar2: float = 1.0
    estimate_scaling: bool = True
    rotation_estimation_algorithm: RotationEstimationAlgorithm = (
        RotationEstimationAlgorithm.GNC_TLS
    )
    rotation_gnc_factor: float = 1.4
    rotation_max_iterations: int = 100
    rotation_cost_threshold: float = 1e-6
    rotation_tim_graph: InlierGraphFormulation = InlierGraphFormulation.CHAIN
    inlier_selection_mode: InlierSelectionMode = InlierSelectionMode.PMC_EXACT
    kcore_heuristic_threshold: float = 0.5
    # Route the escalated clique round through the native exact clique
    # solver on the host (clique/pmc.py) instead of the greedy heuristic.
    exact_clique_callback: bool = False
    use_max_clique: bool = True  # deprecated upstream; kept for parity
    max_clique_exact_solution: bool = True  # deprecated upstream
    max_clique_time_limit: float = 3600.0

    # --- dataset-level constants (compile-time macros in the reference) ----
    # PrNoise = 2 * NOISE_BOUND (registration.cc:36).
    noise_bound_dataset: float = 0.01

    # --- PSULVSB loop constants (hard-coded in the reference) --------------
    inner_noise_bound: float = 0.05  # registration.cc:938
    inner_cbar2: float = 1.0  # registration.cc:939
    inner_rotation_max_iterations: int = 100  # registration.cc:941
    inner_rotation_gnc_factor: float = 1.4  # registration.cc:942
    inner_rotation_cost_threshold: float = 0.005  # registration.cc:945
    rotation_similar: float = 0.01  # registration.cc:48
    local_max_iter: int = 10  # registration.cc:49
    local_confidence: float = 0.99  # Tpro_local, registration.cc:898
    host_confidence: float = 0.99  # Tpro_host, registration.cc:772
    max_host_rounds: int = 5  # qr_round_bound_limit, registration.cc:781
    time_budget_s: float = 60.0  # registration.cc:1475
    # Per-round ceiling of the JAX package's fused one-program solver. The
    # port's solve loop reads the host clock between rounds instead, so this
    # field is carried for parity and not read.
    fused_round_ceiling_s: float = 0.02
    stagnation_min_pro_local: float = 0.2  # registration.cc:1361

    # Histogram (registration.cc:687-688).
    hist_max_scale: float = 10000.0
    hist_bins_per_unit: int = 20

    # --- GROR initial alignment (registration_artificial.cc:571-576) -------
    gror_init: bool = False
    gror_resolution: float = 0.1  # cloud resolution; thresholds are 2x this
    gror_k_optimal: int = 800  # registration_artificial.cc:536

    # --- clique-seeded warm start -------------------------------------------
    # "auto" seeds lazily on the first escalation, "eager" (or True) before
    # round 0, "off" (or False) never.
    clique_init: str | bool = "auto"
    clique_cap: int = 256  # max clique members compacted for the seed solve
    clique_seed_min_size: int = 4  # below this the seed is discarded

    # --- algorithm-variant switches ----------------------------------------
    # registration_best.cc == both on; registration_WT.cc == both off; the
    # nested 2025-07-30 registration.cc == self-update off.
    enable_self_update: bool = True
    enable_refinement: bool = True

    # --- global-translation rescue ------------------------------------------
    # Re-stab translation over all correspondences under the final rotation,
    # adopted only on a strict global-support gain.
    translation_rescue: bool = False

    # Reduced-set construction: "dense" (exact membership over the (C, C)
    # pair grid, hashed-priority top-k compaction), "exact", "exact_hist",
    # "exact_beta", "sampled", or "auto" ("dense" up to dense_init_max_c).
    init_mode: str = "auto"
    dense_init_max_c: int = 8192  # largest C the dense init materializes
    init_peak_sample: int = 1 << 20  # pairs used to locate the peak bin
    init_reject_budget: int = 1 << 21  # pair draws for reduced-set filling
    exact_hist_bins: int = 512  # windowed-bin count of the histogram kernel

    # --- capacity knobs (static shapes replacing dynamic resizes) ----------
    # Upper bound on the |reduced| count driving the floor(|reduced| * rate)
    # sample-size rule.
    reduced_cap: int = 131072
    # Slots of the materialized reduced pool the rounds sample from; an
    # over-cap reduced set is thinned uniformly.
    pool_cap: int = 16384
    # Pool slots the init fill leaves free for self-update appends.
    # Effective reserve = min(pool_reserve, pool // 8).
    pool_reserve: int = 2048
    # Caps on points admitted per self-update round and on the kept-inlier
    # member list the new TIMs pair against (registration.cc:803-827).
    self_update_new_cap: int = 64
    self_update_member_cap: int = 512
    # Upper bound on TIM indices kept in the sampled set per host round.
    sampled_cap: int = 4096
    # Upper bound on TIMs per basic (hypothesis) set.
    basic_cap: int = 2048
    # Hypotheses evaluated together per local batch; local_r advances by
    # the number of hypotheses consumed.
    hypothesis_batch: int = 16
    # Hard ceiling on local batches per host round, as a multiple of
    # local_max_iter.
    local_batch_ceiling_factor: int = 4
    # Draws for the 1-point RANSAC scale consensus.
    scale_max_draws: int = 256
    # Scale estimator: "ransac1pt" (registration.cc:67-119) or "vote"
    # (registration.cc:206-320).
    scale_estimator: str = "ransac1pt"
    # Rotation-from-correlation method inside the GNC loop: "power"
    # (shifted power iteration) or "eigh" (exact 4x4 eigendecomposition).
    gnc_rot_method: str = "power"
    # GNC execution switch of the JAX package ("xla" | "pallas" | "auto").
    # The port always runs the GNC loop through ops.gnc.gnc_batch, so this
    # field is carried for parity and not read.
    gnc_impl: str = "auto"

    @property
    def pr_noise(self) -> float:
        """PrNoise = 2 * dataset noise bound (registration.cc:36)."""
        return 2.0 * self.noise_bound_dataset

    def _check_clique_init(self) -> None:
        if self.clique_init not in (True, False, "eager", "auto", "off"):
            raise ValueError(
                f"clique_init must be 'auto'|'eager'|'off' (or a bool), "
                f"got {self.clique_init!r}"
            )

    def resolve_inlier_selection(self) -> InlierSelectionMode:
        """Deprecated-field handling (registration.cc:628-637)."""
        mode = self.inlier_selection_mode
        if not self.use_max_clique:
            mode = InlierSelectionMode.NONE
        elif not self.max_clique_exact_solution:
            mode = InlierSelectionMode.PMC_HEU
        return mode

    @property
    def clique_eager(self) -> bool:
        """Seed before round 0 (clique_init="eager"; True is an alias)."""
        self._check_clique_init()
        return self.clique_init in (True, "eager")

    @property
    def clique_lazy(self) -> bool:
        """Seed once, in-loop, on the first escalation (clique_init="auto")."""
        self._check_clique_init()
        return self.clique_init == "auto"

    def effective_clique_algorithm(self) -> str:
        """What the clique stage really runs, which the enum alone does not
        say: PMC_EXACT without `exact_clique_callback` runs the greedy on the
        device (docs/CLIQUE_AUDIT.md), not the exact search. Harness
        fingerprints record it."""
        mode = self.resolve_inlier_selection()
        if mode == InlierSelectionMode.NONE:
            return "none"
        if mode == InlierSelectionMode.KCORE_HEU:
            return "kcore-heuristic"
        if mode == InlierSelectionMode.PMC_EXACT and self.exact_clique_callback:
            return "native-exact-callback"
        return "greedy-kcore (exact-audited)"

    def check_port_supported(self) -> None:
        """Every setting of the solver runs in this package, so nothing is
        refused; an invalid `clique_init` raises ValueError, as it does
        wherever it is read."""
        self._check_clique_init()

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)

    # Dataset presets replacing the reference's compile-time #define blocks
    # (registration.cc:32-35, PSULVSB.cc:24, registration_WT.cc:33).
    # Keyword overrides win over the preset values.
    @staticmethod
    def preset_3dmatch(**kw) -> "SolverParams":
        return SolverParams(**{"noise_bound": 0.01, "noise_bound_dataset": 0.01, **kw})

    @staticmethod
    def preset_kitti(**kw) -> "SolverParams":
        return SolverParams(**{"noise_bound": 0.1, "noise_bound_dataset": 0.1, **kw})

    @staticmethod
    def preset_artificial(**kw) -> "SolverParams":
        return SolverParams(
            **{
                "noise_bound": 0.05,
                "noise_bound_dataset": 0.05,
                "estimate_scaling": False,
                **kw,
            }
        )

    @staticmethod
    def preset_artificial_gror(**kw) -> "SolverParams":
        """Artificial-data variant with GROR initial alignment
        (registration_artificial.cc:571-576)."""
        return SolverParams.preset_artificial(
            **{"gror_init": True, "gror_resolution": 0.05, **kw}
        )

    @staticmethod
    def preset_whu_tls(**kw) -> "SolverParams":
        return SolverParams(**{"noise_bound": 0.15, "noise_bound_dataset": 0.15, **kw})

    @staticmethod
    def preset_cransac_wt(**kw) -> "SolverParams":
        """registration_WT.cc: prior C-RANSAC baseline — NOISE_BOUND 0.05,
        no self-update, no weighted-SVD refinement."""
        return SolverParams(
            **{
                "noise_bound": 0.05,
                "noise_bound_dataset": 0.05,
                "enable_self_update": False,
                "enable_refinement": False,
                **kw,
            }
        )

    @staticmethod
    def preset_psulvsb_2025_07(**kw) -> "SolverParams":
        """Nested 2025-07-30 registration.cc: self-update off, outer bound
        from ransac_max_iterations = 5."""
        return SolverParams(
            **{"enable_self_update": False, "max_host_rounds": 5, **kw}
        )

    @staticmethod
    def preset_anchor(**kw) -> "SolverParams":
        """The bench anchor's executed program: the artificial preset at caps
        (sampled 2048, basic 256, 4 hypotheses per batch), clique stages
        off — the known-scale slice this package runs end to end."""
        return SolverParams.preset_artificial(
            **{
                "sampled_cap": 2048,
                "basic_cap": 256,
                "hypothesis_batch": 4,
                "clique_init": "off",
                "inlier_selection_mode": InlierSelectionMode.NONE,
                **kw,
            }
        )
