"""The port's SolverParams against the JAX package's: same fields, defaults
and presets, a lossless conversion, every setting runs (the three that were
refused until the classic slice now solve a small pair), the honest name of
the clique stage, and an import of the port with JAX made unimportable."""

import dataclasses
import enum
import subprocess
import sys
from pathlib import Path

import pytest

from psulvsb_tpu.solver import config as jcfg
from psulvsb_tpu_torch.convert import params_from_jax
from psulvsb_tpu_torch.solver import config as tcfg

REPO = Path(__file__).resolve().parents[1]
PRESETS = [
    "preset_3dmatch",
    "preset_kitti",
    "preset_artificial",
    "preset_artificial_gror",
    "preset_whu_tls",
    "preset_cransac_wt",
    "preset_psulvsb_2025_07",
]


def _plain(v):
    return int(v) if isinstance(v, enum.Enum) else v


def _as_dict(p):
    return {f.name: _plain(getattr(p, f.name)) for f in dataclasses.fields(p)}


def test_same_fields_and_defaults():
    jf = dataclasses.fields(jcfg.SolverParams)
    tf = dataclasses.fields(tcfg.SolverParams)
    assert [f.name for f in jf] == [f.name for f in tf]
    assert _as_dict(jcfg.SolverParams()) == _as_dict(tcfg.SolverParams())
    assert jcfg.RATE_SCHEDULE == tcfg.RATE_SCHEDULE


@pytest.mark.parametrize(
    "name", ["RotationEstimationAlgorithm", "InlierSelectionMode", "InlierGraphFormulation"]
)
def test_same_enum_values(name):
    j = {m.name: int(m) for m in getattr(jcfg, name)}
    t = {m.name: int(m) for m in getattr(tcfg, name)}
    assert j == t


@pytest.mark.parametrize("preset", PRESETS)
def test_same_presets(preset):
    jp = getattr(jcfg.SolverParams, preset)(sampled_cap=1024)
    tp = getattr(tcfg.SolverParams, preset)(sampled_cap=1024)
    assert _as_dict(jp) == _as_dict(tp)
    assert params_from_jax(jp) == tp


def test_preset_anchor_is_the_bench_anchor_without_cliques():
    jp = jcfg.SolverParams.preset_artificial(
        sampled_cap=2048, basic_cap=256, hypothesis_batch=4, clique_init="off",
        inlier_selection_mode=jcfg.InlierSelectionMode.NONE,
    )
    anchor = tcfg.SolverParams.preset_anchor()
    assert params_from_jax(jp) == anchor
    anchor.check_port_supported()


def test_params_from_jax_maps_enums_by_value():
    jp = jcfg.SolverParams(
        rotation_estimation_algorithm=jcfg.RotationEstimationAlgorithm.FGR,
        inlier_selection_mode=jcfg.InlierSelectionMode.KCORE_HEU,
        rotation_tim_graph=jcfg.InlierGraphFormulation.COMPLETE,
        noise_bound=0.123, pool_cap=777, clique_init="eager",
    )
    tp = params_from_jax(jp)
    assert tp.rotation_estimation_algorithm is tcfg.RotationEstimationAlgorithm.FGR
    assert tp.inlier_selection_mode is tcfg.InlierSelectionMode.KCORE_HEU
    assert tp.rotation_tim_graph is tcfg.InlierGraphFormulation.COMPLETE
    assert _as_dict(tp) == _as_dict(jp)
    assert tp.resolve_inlier_selection() == jp.resolve_inlier_selection()


FORMERLY_REFUSED = [
    {"inlier_selection_mode": tcfg.InlierSelectionMode.PMC_EXACT, "exact_clique_callback": True,
     "clique_init": "auto"},
    {"rotation_estimation_algorithm": tcfg.RotationEstimationAlgorithm.FGR},
    {"gnc_rot_method": "eigh"},
]


@pytest.mark.parametrize("kw", FORMERLY_REFUSED)
def test_formerly_refused_settings_run(kw):
    """check_port_supported refuses nothing, and a 150-point pair at 80%
    displaced outliers solves (RE < 5 deg, TE < 0.3) under the setting."""
    import numpy as np

    from psulvsb_tpu_torch import RobustRegistrationSolver
    from psulvsb_tpu_torch.eval.synthetic import (
        make_synthetic_pair,
        registration_errors,
        synthetic_cloud,
    )

    p = tcfg.SolverParams.preset_anchor(**{"sampled_cap": 512, "basic_cap": 64, **kw})
    p.check_port_supported()
    pair = make_synthetic_pair(np.random.default_rng(1), synthetic_cloud(150, seed=2), 0.05, 0.8)
    sol = RobustRegistrationSolver(p, seed=0, device="cpu").solve(pair.src, pair.dst)
    re, te, _ = registration_errors(pair, sol.scale, sol.rotation, sol.translation)
    assert bool(sol.valid) and re < 5.0 and te < 0.3


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"exact_clique_callback": True},
        {"use_max_clique": False},
        {"max_clique_exact_solution": False, "exact_clique_callback": True},
        {"inlier_selection_mode": "KCORE_HEU"},
        {"inlier_selection_mode": "PMC_HEU"},
    ],
)
def test_effective_clique_algorithm_matches_jax(kw):
    """The name the harness fingerprints record for the clique stage."""
    def build(cfg):
        kw2 = dict(kw)
        if "inlier_selection_mode" in kw2:
            kw2["inlier_selection_mode"] = cfg.InlierSelectionMode[kw2["inlier_selection_mode"]]
        return cfg.SolverParams(**kw2)

    assert build(tcfg).effective_clique_algorithm() == build(jcfg).effective_clique_algorithm()


def test_invalid_clique_init_still_raises():
    with pytest.raises(ValueError):
        tcfg.SolverParams(clique_init="sometimes").check_port_supported()


SUPPORTED = [
    {},
    {"clique_init": False, "init_mode": "dense"},
    {"use_max_clique": False, "clique_init": "off"},
    {"enable_self_update": False, "enable_refinement": False},
    # Queue 1 item 9: scale estimation and every init mode at any C.
    {"estimate_scaling": True},
    {"init_mode": "sampled"},
    {"init_mode": "exact"},
    {"init_mode": "exact_hist", "estimate_scaling": True},
    {"init_mode": "exact_beta"},
    {"dense_init_max_c": 1000},  # C = 1889 leaves the dense window
    {"estimate_scaling": True, "scale_estimator": "vote"},
    # Queue 1 items 10 and 14: the clique stages, GROR and the rescue.
    {"clique_init": "auto"},
    {"clique_init": "eager"},
    {"clique_init": True},
    {"inlier_selection_mode": tcfg.InlierSelectionMode.PMC_EXACT},
    {"max_clique_exact_solution": False},  # resolves to PMC_HEU
    {"gror_init": True},
    {"translation_rescue": True},
    # The callback only routes PMC_EXACT; other modes ignore it.
    {"inlier_selection_mode": tcfg.InlierSelectionMode.KCORE_HEU, "exact_clique_callback": True},
    # The native exact clique round, FGR and the "eigh" rotation, together too.
    {"inlier_selection_mode": tcfg.InlierSelectionMode.PMC_EXACT, "exact_clique_callback": True},
    {"rotation_estimation_algorithm": tcfg.RotationEstimationAlgorithm.FGR,
     "exact_clique_callback": True, "estimate_scaling": True},
    {"gnc_rot_method": "eigh", "gror_init": True},
]


@pytest.mark.parametrize("kw", SUPPORTED)
def test_supported_variants_do_not_raise(kw):
    tcfg.SolverParams.preset_anchor(**kw).check_port_supported()


def test_gror_presets_run_unmodified():
    """Both presets that turn GROR on pass at their own defaults (clique
    "auto", PMC_EXACT on the greedy, the rescue on the front-end preset)."""
    from psulvsb_tpu.eval.frontend_protocol import frontend_solver_params as jax_frontend
    from psulvsb_tpu_torch.eval.frontend_protocol import NOISE_BOUND, frontend_solver_params

    tcfg.SolverParams.preset_artificial_gror().check_port_supported()
    tp = frontend_solver_params()
    tp.check_port_supported()
    assert params_from_jax(jax_frontend()) == tp
    assert tp.gror_init and tp.translation_rescue and tp.noise_bound == NOISE_BOUND == 0.3
    assert tp.clique_lazy and not tp.clique_eager
    assert tcfg.SolverParams(clique_init=True).clique_eager


@pytest.mark.parametrize("preset", ["preset_3dmatch", "preset_kitti", "preset_whu_tls"])
def test_estimate_scaling_preset_round_trip(preset):
    """The unknown-scale presets without the clique stages (bench.py:437-443)
    convert losslessly and run."""
    kw = dict(
        estimate_scaling=True, sampled_cap=2048, basic_cap=256, hypothesis_batch=4,
        clique_init="off",
    )
    jp = getattr(jcfg.SolverParams, preset)(
        inlier_selection_mode=jcfg.InlierSelectionMode.NONE, **kw
    )
    tp = getattr(tcfg.SolverParams, preset)(
        inlier_selection_mode=tcfg.InlierSelectionMode.NONE, **kw
    )
    assert params_from_jax(jp) == tp
    assert tp.estimate_scaling
    tp.check_port_supported()


def test_port_imports_without_jax():
    """Every module of the port, found by walking the package (so a new
    module is covered without being listed), imports with JAX made
    unimportable and loads nothing of JAX or of the JAX package."""
    code = (
        "import importlib, pkgutil, sys; sys.modules['jax'] = None\n"
        "import psulvsb_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(psulvsb_tpu_torch.__path__,\n"
        "                                               'psulvsb_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'psulvsb_tpu_torch.cli', 'psulvsb_tpu_torch.utils.timing',\n"
        "        'psulvsb_tpu_torch.examples.benchmark_3dmatch'} <= set(names), names\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'psulvsb_tpu.'))"
        " or m == 'psulvsb_tpu' for m in sys.modules if sys.modules[m] is not None)\n"
        "print(len(names), 'ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith(" ok")
