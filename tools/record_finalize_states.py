"""Record host states and the JAX package's finalize on them, for
tests/test_torch_finalize.py.

    JAX_PLATFORMS=cpu python tools/record_finalize_states.py

Runs the JAX package's stages on the CPU (init, then three host rounds of
sample, local and host stages, as tests/test_torch_stages.py chains them) on
a 300-point pair at known scale (the artificial preset, displaced outliers)
and at estimated scale (the 3DMatch preset, mismatch outliers, the target
stretched by 2.7), keeps the host state and the round's sampled best after
every round, and adds two states made from the last one: the final inliers
cut to the one column the sampled best fits best (so its RMSE beats the
refit: the gate stays closed) and emptied (both RMSEs +inf). On each state
it runs psulvsb_tpu's `_finalize_stage` and writes the inputs and its
rotation, translation and gate to tests/data/finalize/states.npz, keyed
"<case>/<field>".
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from psulvsb_tpu.solver import psulvsb as jps
from psulvsb_tpu.solver.config import InlierSelectionMode, SolverParams
from psulvsb_tpu_torch.eval.synthetic import make_synthetic_pair, synthetic_cloud

OUT = Path(__file__).resolve().parents[1] / "tests" / "data" / "finalize" / "states.npz"
C = 300
F32 = jnp.float32
ROUNDS = ((0.1, 0.3), (0.2, 0.3), (1.0, 1.0))  # (l_rate, b_rate)


def params_for(scaled: bool) -> SolverParams:
    kw = dict(sampled_cap=512, basic_cap=64, hypothesis_batch=4, pool_cap=16384,
              clique_init="off", inlier_selection_mode=InlierSelectionMode.NONE)
    if scaled:
        return SolverParams.preset_3dmatch(estimate_scaling=True, **kw)
    return SolverParams.preset_artificial(**kw)


def chain(scaled: bool):
    """(src, dst, thr, [(host state, sampled best) after each round])."""
    params = params_for(scaled)
    src = synthetic_cloud(C, seed=3)
    if scaled:
        pair = make_synthetic_pair(np.random.default_rng(5), src, 0.01, 0.7,
                                   outlier_mode="mismatch", test_scale=2.7)
    else:
        pair = make_synthetic_pair(np.random.default_rng(5), src, 0.05, 0.9)
    keep = np.ones(C, np.int32)
    keep[np.random.default_rng(6).permutation(C)[: C // 5]] = 0
    sj, dj, kj = jnp.asarray(pair.src), jnp.asarray(pair.dst), jnp.asarray(keep)
    red_i, red_j, red_count, pool = jps._init_stage(sj, dj, kj, params, jax.random.PRNGKey(11))
    thr = jnp.asarray(params.pr_noise * (1.0 + int(np.sum(keep == 1)) / C), F32)
    hs = jps.HostState.initial(C, kj, F32)
    warm = jps.WarmState.initial(F32)
    states = []
    for r, (l_rate, b_rate) in enumerate(ROUNDS):
        k_samp, k_local, k_host = jax.random.split(jax.random.PRNGKey(100 + r), 3)
        s_i, s_j, s_ok, s_count, s_pts = jps._sample_stage(
            red_i, red_j, red_count, pool, jnp.asarray(l_rate, F32), params, k_samp,
            num_points=C)
        b_one = b_rate >= 1.0
        local = jps._local_stage(sj, dj, s_i, s_j, s_ok, s_count, s_pts, jnp.asarray(b_rate, F32),
                                 jnp.asarray(b_one), hs.host_r, warm, thr, params, k_local)
        hs, _, _ = jps._host_stage(sj, dj, hs, local.best, local.local_r, jnp.asarray(b_one), thr,
                                   params, k_host)
        warm = jps.WarmState(hs.best.scale, hs.best.rotation, hs.best.translation,
                             jnp.zeros((), bool))
        states.append((hs, local.best))
    return params, sj, dj, thr, states


def record(out: dict, name: str, params, sj, dj, thr, hs, sampled) -> bool:
    rotation, translation, better = jps._finalize_stage(sj, dj, hs, sampled, params)
    fields = {
        "src": sj, "dst": dj, "thr": thr, "inlier_counter": hs.inlier_counter,
        "final_inliers": hs.final_inliers, "keep_mask": hs.keep_mask,
        "best_count": hs.best_count, "best_scale": hs.best.scale,
        "best_rotation": hs.best.rotation, "best_translation": hs.best.translation,
        "sampled_scale": sampled.scale, "sampled_rotation": sampled.rotation,
        "sampled_translation": sampled.translation, "jax_rotation": rotation,
        "jax_translation": translation, "jax_better": better,
    }
    for k, v in fields.items():
        out[f"{name}/{k}"] = np.asarray(v)
    return bool(better)


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    out: dict = {}
    for scaled in (False, True):
        tag = "scaled" if scaled else "known"
        params, sj, dj, thr, states = chain(scaled)
        for r, (hs, sampled) in enumerate(states):
            record(out, f"{tag}_r{r}", params, sj, dj, thr, hs, sampled)
        hs, sampled = states[-1]
        moved = sampled.scale * (sampled.rotation @ sj + sampled.translation[:, None])
        res = jnp.linalg.norm(dj - moved, axis=0)
        fit = jnp.zeros(C, hs.final_inliers.dtype).at[jnp.argmin(res)].set(1)
        if record(out, f"{tag}_closed", params, sj, dj, thr, hs._replace(final_inliers=fit),
                  sampled):
            raise AssertionError(f"{tag}_closed: the refit beat the sampled best's own column")
        empty = jnp.zeros_like(hs.final_inliers)
        if record(out, f"{tag}_empty", params, sj, dj, thr, hs._replace(final_inliers=empty),
                  sampled):
            raise AssertionError(f"{tag}_empty: an empty mask kept the refit")
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    cases = sorted({k.split("/")[0] for k in out})
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes): " + ", ".join(
        f"{c} better={bool(out[c + '/jax_better'])}" for c in cases))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
