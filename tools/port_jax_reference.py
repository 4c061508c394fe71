"""JAX-package reference figures that chip_smoke.py prints beside the
PyTorch port's, computed on the CPU.

    JAX_PLATFORMS=cpu python tools/port_jax_reference.py [hostile|frontend ...]

- hostile: the hostile pair of chip_smoke.py's clique phase (the anchor
  protocol, C = 1889, 99% displaced outliers, data seed 5, made with the
  port's numpy generator) through the bench anchor's program
  (`preset_artificial` at chip_smoke's caps, clique "auto"), one key per
  solve seed of that phase; success is valid, RE < 5 deg, TE < 0.3;
- frontend: the two committed real pairs of tests/data/frontend_aliasing/
  through `frontend_solver_params` at the same caps, 5 keys each; success
  is the KITTI gates, RE < 5 deg, TE < 0.6.

The pairs, caps and seeds are chip_smoke.py's own.

Each solve is the JAX package's `psulvsb_solve`; each line gives its
errors, and each case its recall. Like the tests, it imports both
packages; the port and chip_smoke.py import no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from psulvsb_tpu.eval.frontend_protocol import frontend_solver_params  # noqa: E402
from psulvsb_tpu.solver.config import SolverParams  # noqa: E402
from psulvsb_tpu.solver.psulvsb import psulvsb_solve  # noqa: E402
from psulvsb_tpu_torch.core.metrics import angular_error_deg_np  # noqa: E402


def _recall(tag, params, case, keys, re_max, te_max) -> None:
    src, dst, (rot_true, t_true, _) = case
    ok = 0
    for k in keys:
        sol, info = psulvsb_solve(
            jnp.asarray(src), jnp.asarray(dst), jnp.ones((src.shape[1],), jnp.int32), params,
            jax.random.PRNGKey(k),
        )
        re = angular_error_deg_np(rot_true, np.asarray(sol.rotation, np.float64))
        te = float(np.linalg.norm(np.asarray(sol.translation, np.float64) - t_true))
        good = bool(sol.valid) and re < re_max and te < te_max
        ok += good
        print(f"{tag} key {k}: valid={bool(sol.valid)} RE={re:.4f} deg TE={te:.5f} "
              f"rounds={info['rounds']} success={good}", flush=True)
    print(f"JAX CPU recall, {tag}: {ok}/{len(keys)}", flush=True)


def hostile() -> None:
    case = smoke.anchor_case(rate=smoke.HOSTILE_RATE, data_seed=smoke.HOSTILE_DATA_SEED)
    _recall("hostile", SolverParams.preset_artificial(**smoke.CAPS), case,
            smoke.HOSTILE_SOLVE_SEEDS, *smoke.LIMITS[:2])


def frontend() -> None:
    for tag in smoke.FRONTEND_TAGS:
        _recall(tag, frontend_solver_params(**smoke.CAPS), smoke.frontend_case(tag),
                range(smoke.N_TIMED_SOLVES), *smoke.KITTI_LIMITS[:2])


def main() -> None:
    cases = {"hostile": hostile, "frontend": frontend}
    for name in sys.argv[1:] or list(cases):
        cases[name]()


if __name__ == "__main__":
    main()
