"""JAX-package reference figures that chip_smoke.py prints beside the
PyTorch port's, computed on the CPU.

    JAX_PLATFORMS=cpu python tools/port_jax_reference.py \
        [hostile|frontend|frontend_unknown|demo|audit ...]

- hostile: the hostile pair of chip_smoke.py's clique phase (the anchor
  protocol, C = 1889, 99% displaced outliers, data seed 5, made with the
  port's numpy generator) through the bench anchor's program
  (`preset_artificial` at chip_smoke's caps, clique "auto"), one key per
  solve seed of that phase; success is valid, RE < 5 deg, TE < 0.3;
- frontend: the two committed real pairs of tests/data/frontend_aliasing/
  through `frontend_solver_params` at the same caps, 5 keys each; success
  is the KITTI gates, RE < 5 deg, TE < 0.6;
- frontend_unknown: the front-end sweep scene of chip_smoke.py's phase 21
  (`write_frontend_benchmark` of FE_SWEEP_PAIRS pairs, seed 11, written by
  the port on the CPU) at unknown scale, ddtime 1, KITTI criteria, through
  the JAX package's `run_benchmark_batched` and, on the same files, the
  port's on the CPU; each harness's recall;
- audit: the worst case of the port's clique audit on the card
  (docs/CLIQUE_AUDIT_torch.md: C = 2000, 95% clustered outliers, ratio
  window, seed 2095), on the port's own numpy pair: the JAX package's
  `dense_consistency_adjacency` and its core- and triangle-ordered
  `greedy_clique` beside the port's, on the CPU, and the native exact size;
- demo: the synthetic protocol of `psulvsb_demo` at its defaults (a 500-point
  `synthetic_cloud`, 10 trials, 90% outliers, noise 0.05,
  `preset_artificial()`) through the JAX package's `run_protocol`; recall is
  the share of trials with RE < 5 deg and TE < 0.3.

The pairs, caps and seeds are chip_smoke.py's own.

Each solve is the JAX package's `psulvsb_solve`; each line gives its
errors, and each case its recall. Like the tests, it imports both
packages; the port and chip_smoke.py import no JAX.
"""

from __future__ import annotations

import csv
import os
import sys
import tempfile
import time
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


def frontend_unknown() -> None:
    from psulvsb_tpu.eval import batch_harness as jax_harness
    from psulvsb_tpu_torch.eval import batch_harness
    from psulvsb_tpu_torch.eval import frontend_protocol as fp

    with tempfile.TemporaryDirectory(prefix="psulvsb_fe_ref_") as root:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        fp.write_frontend_benchmark(data, ["fe"], n_pairs=smoke.FE_SWEEP_PAIRS, seed=11,
                                    device="cpu")
        print(f"scene written on the CPU in {time.perf_counter() - t0:.1f} s", flush=True)
        runs = {
            "JAX": lambda out: jax_harness.run_benchmark_batched(
                data, out, dataset="kitti", scenes=["fe"],
                params=frontend_solver_params(**smoke.CAPS), ddtime=1, unknown_scale=True),
            "port": lambda out: batch_harness.run_benchmark_batched(
                data, out, dataset="kitti", scenes=["fe"],
                params=fp.frontend_solver_params(**smoke.CAPS), ddtime=1, unknown_scale=True,
                device="cpu"),
        }
        for name, run in runs.items():
            out = os.path.join(root, name)
            t0 = time.perf_counter()
            stats = run(out)["fe"]
            with open(os.path.join(out, "fe_fpfh_1.csv")) as f:
                for row in list(csv.reader(f))[1:]:
                    print(f"{name} {row}", flush=True)
            print(f"{name} CPU recall, front-end sweep at unknown scale (ddtime 1): "
                  f"{stats['recall']} of {stats['pairs']} pairs "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


def audit() -> None:
    from psulvsb_tpu.clique.kcore import greedy_clique, triangle_scores
    from psulvsb_tpu.solver.psulvsb import dense_consistency_adjacency
    from psulvsb_tpu_torch.clique.pmc import exact_max_clique
    from tools import clique_scale_audit_torch as audit_tool

    c, rate, mode = 2000, 0.95, "clustered"
    pair = audit_tool.case_pair(c, rate, mode, seed=c + int(rate * 100))
    port_adj = audit_tool.case_adjacency(pair, True, "cpu")
    port = audit_tool.greedy_sizes(port_adj)
    params = SolverParams.preset_3dmatch(estimate_scaling=True, sampled_cap=2048, basic_cap=256,
                                         hypothesis_batch=4)
    inl = np.where(~pair.outlier_mask)[0]
    adj = dense_consistency_adjacency(
        jnp.asarray(pair.src), jnp.asarray(pair.dst), jnp.asarray(inl[:-1], jnp.int32),
        jnp.asarray(inl[1:], jnp.int32), jnp.asarray(inl.size - 1, jnp.int32), params,
        jnp.ones((c,), bool),
    )
    core = int(np.asarray(greedy_clique(adj)).sum())
    tri = int(np.asarray(greedy_clique(adj, order_scores=triangle_scores(adj))).sum())
    flipped = int((np.asarray(adj) != port_adj.numpy()).sum())
    exact = len(exact_max_clique(np.asarray(adj), time_limit_s=600.0))
    print(f"audit case C={c} {rate} {mode} ratio window, the port's pair: JAX graph "
          f"{int(np.asarray(adj).sum()) // 2} edges ({flipped} entries flipped against the "
          f"port's), JAX greedy core {core} tri {tri}; port greedy core {port['core_greedy']} "
          f"tri {port['tri_greedy']}; exact {exact} (native, on JAX's graph)", flush=True)


def demo() -> None:
    from psulvsb_tpu.eval.protocol import run_protocol
    from psulvsb_tpu.eval.synthetic import synthetic_cloud

    with tempfile.TemporaryDirectory(prefix="psulvsb_demo_ref_") as out:
        run_protocol({"synthetic": synthetic_cloud(500, seed=0)}, SolverParams.preset_artificial(),
                     out, trials=10, noise_bound=0.05, outlier_rate=0.9)
        with open(os.path.join(out, "synthetic.csv")) as f:
            rows = list(csv.DictReader(f))
    ok = sum(float(r["AngleError"]) < 5.0 and float(r["TransError"]) < 0.3 for r in rows)
    print(f"JAX CPU recall, psulvsb_demo at its defaults: {ok}/{len(rows)}", flush=True)


def main() -> None:
    cases = {"hostile": hostile, "frontend": frontend, "frontend_unknown": frontend_unknown,
             "demo": demo, "audit": audit}
    for name in sys.argv[1:] or list(cases):
        cases[name]()


if __name__ == "__main__":
    main()
