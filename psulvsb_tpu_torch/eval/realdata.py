"""Real-data benchmark harness: 3DMatch / 3DLoMatch / KITTI (port of
psulvsb_tpu/eval/realdata.py).

Equivalent of the nested benchmark program
(teaser_cpp_ply_main.cc:244-795):

- per scene: a pair-label list; per pair: a correspondence text file
  ("sx sy sz tx ty tz" per line, `cloud_bin_A+cloud_bin_B@corr.txt` for
  fpfh / `@corr_fcgf.txt` for fcgf) and a 4x4 ground-truth matrix
  (`@GTmat.txt` / `@GTmat_fcgf.txt`),
- optional random unknown-scale injection (tgt *= 1 + 4*U(0,1)),
- best-of-`ddtime` repeats kept by RMSE,
- success criteria: 3DMatch/3DLoMatch scale err <= 0.1, RE <= 15 deg,
  TE <= 0.3 m, time <= 60 s (line 424); KITTI RE <= 5 deg, TE <= 0.6 m
  (line 714),
- per-scene CSVs + average CSV with registration recall.

This module is the SERIAL harness (one solve at a time through
`eval.pipeline.solve_with_prefilter`, faithful per-pair wall times,
checkpoint and resume). The scaling path, all (pair, retry) solves of a
bucket group through `register_batch`, is eval/batch_harness.py. Both take
their seeds and test scales from `retry_seed` and `pair_test_scale` here, so
with the same arguments they give the same result for every pair apart from
its time.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from psulvsb_tpu_torch.core.metrics import angular_error_deg_np
from psulvsb_tpu_torch.eval.pipeline import pad_bucket, solve_with_prefilter
from psulvsb_tpu_torch.eval.reporting import append_jsonl, write_csv
from psulvsb_tpu_torch.solver.classic import solve_decoupled
from psulvsb_tpu_torch.solver.config import SolverParams
from psulvsb_tpu_torch.solver.fused import plan_for, resolve_device

THREEDMATCH_SCENES = [
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
]
CSV_HEADER = ["pair", "ScaleError", "AngleError", "TransError", "RMSE", "Time", "Success"]
# Retry indices beyond any ddtime: the untimed warm-up solves, the classic
# fallback's draws and the unknown-scale factor.
_WARM_RETRY, _WARM_DECOUPLED_RETRY, _FALLBACK_RETRY, _SCALE_RETRY = (
    0x7FFFFFFF, 0x7FFFFFFE, 0x5EED, 0x7FFFFFF7,
)


class SuccessCriteria(NamedTuple):
    max_scale_err: float
    max_angle_err_deg: float
    max_trans_err: float
    max_time_s: float

    @staticmethod
    def threedmatch() -> "SuccessCriteria":
        return SuccessCriteria(0.1, 15.0, 0.3, 60.0)  # main.cc:424

    @staticmethod
    def kitti() -> "SuccessCriteria":
        return SuccessCriteria(0.1, 5.0, 0.6, 60.0)  # main.cc:714

    @staticmethod
    def whu_tls() -> "SuccessCriteria":
        """No reference criteria exist for the WHU-TLS regime (the reference
        ships only the commented noise-bound preset, registration.cc:35);
        derived from KITTI's ratios scaled to noise bound 0.15: trans
        0.6 * 0.15/0.1 = 0.9 m at the same 5 deg angle gate."""
        return SuccessCriteria(0.1, 5.0, 0.9, 60.0)

    @staticmethod
    def for_dataset(dataset: str) -> "SuccessCriteria":
        if dataset == "kitti":
            return SuccessCriteria.kitti()
        if dataset == "whu_tls":
            return SuccessCriteria.whu_tls()
        return SuccessCriteria.threedmatch()


def default_params(dataset: str) -> SolverParams:
    """The solver preset of a dataset name."""
    if dataset == "kitti":
        return SolverParams.preset_kitti()
    if dataset == "whu_tls":
        return SolverParams.preset_whu_tls()
    return SolverParams.preset_3dmatch()


def pair_salt(a: int, b: int) -> int:
    """The integer that names pair (a, b) in every seed derivation."""
    return a * 100003 + b


def retry_seed(seed: int, salt: int, t: int) -> int:
    """The solve seed of retry t of the pair named `salt` under the run's
    `seed`: one integer, derived on the host, the same in the serial and
    the batched harness."""
    state = np.random.SeedSequence([seed, salt, t]).generate_state(1, np.uint64)
    return int(state[0] >> 2)


def pair_test_scale(seed: int, salt: int) -> float:
    """The unknown-scale protocol's factor of a pair, 1 + 4 U(0, 1)
    (teaser_cpp_ply_main.cc:319), from the same derivation."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, salt, _SCALE_RETRY]))
    return 1.0 + 4.0 * float(rng.uniform())


def _rmse_key(r) -> float:
    """Best-of-retry ordering key: a NaN RMSE sorts worst. Comparisons with
    float('nan') are all False, so `r.rmse < best.rmse` would freeze a
    retry-0 NaN (a collapsed solve) as the running best and mask every
    later good retry."""
    return r.rmse if math.isfinite(r.rmse) else math.inf


def read_corr_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """'sx sy sz tx ty tz' per line -> ((3, C) src, (3, C) dst)."""
    data = np.atleast_2d(np.loadtxt(path, dtype=np.float64))
    return data[:, 0:3].T.copy(), data[:, 3:6].T.copy()


def read_gt_mat(path: str) -> np.ndarray:
    m = np.loadtxt(path, dtype=np.float64)
    assert m.shape == (4, 4), f"{path}: expected 4x4 GT matrix"
    return m


def read_pair_labels(path: str) -> list[tuple[int, int]]:
    """Pair list file: two integers per line (the fragment ids)."""
    pairs = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if len(tok) >= 2:
                try:
                    pairs.append((int(tok[0]), int(tok[1])))
                except ValueError:
                    continue
    return pairs


def read_gt_log(path: str) -> dict[tuple[int, int], np.ndarray]:
    """Standard 3DMatch gt.log: blocks of 'id0 id1 total' followed by a 4x4
    transform (teaser_cpp_ply_main.cc:246-263). Returns {(id0, id1): 4x4}."""
    out: dict[tuple[int, int], np.ndarray] = {}
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    i = 0
    while i + 4 <= len(lines):
        hdr = lines[i]
        if len(hdr) < 2:
            i += 1
            continue
        a, b = int(hdr[0]), int(hdr[1])
        out[(a, b)] = np.array([[float(x) for x in lines[i + r][:4]] for r in range(1, 5)])
        i += 5
    return out


def pair_files(scene_dir: str, a: int, b: int, descriptor: str = "fpfh") -> tuple[str, str]:
    """(correspondence file, ground-truth file) of pair (a, b) of a scene."""
    stem = os.path.join(scene_dir, f"cloud_bin_{a}+cloud_bin_{b}")
    if descriptor == "fpfh":
        return stem + "@corr.txt", stem + "@GTmat.txt"
    return stem + "@corr_fcgf.txt", stem + "@GTmat_fcgf.txt"


def retry_uses_prefilter(t: int, ddtime: int, use_prefilter: bool) -> bool:
    """Which of the best-of-ddtime retries consult the normal-angle
    pre-filter mask: ONE rule shared by the serial and the batched harness.

    The reference program filters every retry (main.cc:337) and relies on
    self-update re-admission (keep == 0 -> 1, registration.cc:1399-1488) to
    recover mis-filtered inliers. That recovery cannot start when the
    filter's kept set holds no inlier at all, which happens on 95%-outlier
    mismatch pairs (docs/FULLSCALE.md). Retries are best-of by RMSE and a
    raw solve runs the same plan as a filtered one (the mask is an input,
    not a shape), so alternating filtered and raw retries dominates the
    all-filtered rule for recall while keeping the filter's benefit where it
    helps. A documented divergence from the reference (README): even retries
    filtered, odd retries raw; ddtime == 1 keeps the reference's single
    filtered solve."""
    if not use_prefilter:
        return False
    return t % 2 == 0


class PairResult(NamedTuple):
    scale_error: float
    angle_error_deg: float
    trans_error: float
    rmse: float
    time_s: float
    success: bool


def score_pose(src64, gt, scale, rotation, translation, test_scale, time_s,
               upstream_translation: bool = False) -> PairResult:
    """One solve against its ground truth, in numpy float64 (main.cc:330-422):
    the RMSE against the GT placement over all correspondences in the
    unscaled frame, and the three errors. The solver's convention is
    s (R p + t); `upstream_translation` scores the classic solve's
    s R p + t (solver/classic.py). `success` is left False."""
    gt_r = np.asarray(gt[:3, :3], np.float64)
    gt_t = np.asarray(gt[:3, 3], np.float64)
    s_f = float(scale)
    r64 = np.asarray(rotation, np.float64)
    t64 = np.asarray(translation, np.float64)
    t_unit = t64 if upstream_translation else t64 * s_f  # the translation in dst units
    gt_pts = gt_r @ src64 + gt_t[:, None]
    est_pts = s_f * (r64 @ src64) + t_unit[:, None]
    rmse = float(np.sqrt(np.mean(np.sum((gt_pts - est_pts / test_scale) ** 2, axis=0))))
    return PairResult(
        scale_error=abs(s_f - test_scale),
        angle_error_deg=angular_error_deg_np(gt_r, r64),
        trans_error=float(np.linalg.norm(t_unit / test_scale - gt_t)),
        rmse=rmse,
        time_s=time_s,
        success=False,
    )


def meets(r: PairResult, criteria: SuccessCriteria, time_s: float) -> bool:
    """The reference's success definition with `time_s` charged."""
    return bool(
        r.scale_error <= criteria.max_scale_err
        and r.angle_error_deg <= criteria.max_angle_err_deg
        and r.trans_error <= criteria.max_trans_err
        and time_s <= criteria.max_time_s
    )


def evaluate_pair(
    src: np.ndarray,
    dst: np.ndarray,
    gt: np.ndarray,
    params: SolverParams,
    criteria: SuccessCriteria,
    seed: int,
    salt: int,
    ddtime: int = 10,
    test_scale: float = 1.0,
    use_prefilter: bool = True,
    decoupled_fallback: bool = False,
    device="cuda",
) -> PairResult:
    """Best-of-ddtime evaluation of one pair (main.cc:330-422): repeat the
    full pipeline, keep the lowest-RMSE run, apply the success criteria.
    Retry t solves with `retry_seed(seed, salt, t)`.

    The pre-filter is deterministic, so when it mis-discards inliers every
    filtered retry fails the same way (true of the reference too); odd
    retries run without it when use_prefilter is on (retry_uses_prefilter).

    decoupled_fallback adds ONE extra retry through the classic decoupled
    path (solver/classic.py: scale -> max-clique -> rotation -> translation)
    kept under the same lowest-RMSE rule. The clique stage prunes before
    rotation, which carries the >= 97%-outlier low-overlap pairs where the
    PSULVSB loop plateaus. Off by default: the reference's harness has no
    such retry."""
    device = resolve_device(device)
    src32 = np.asarray(src, np.float32)
    dst32 = np.asarray(dst * test_scale, np.float32)
    src64 = np.asarray(src, np.float64)

    def decoupled(t):
        gen = torch.Generator(device=device).manual_seed(retry_seed(seed, salt, t))
        return solve_decoupled(
            torch.as_tensor(src32, device=device), torch.as_tensor(dst32, device=device),
            params, gen,
        )

    if not plan_for(params, pad_bucket(src32.shape[1]), device).stats:
        # No solve has gone through the bucket's replay plan yet (it is new,
        # or was rebuilt after leaving the plan cache, which is the one
        # record of this). Untimed, so that a pair's time_s never includes
        # the kernels' build and the plan's capture: the C++ reference has no
        # such step, and its 60 s success budget (main.cc:424) would
        # otherwise be eaten by it on a bucket's first pair. A raw solve
        # replays the same plan as a filtered one.
        solve_with_prefilter(
            src32, dst32, params, retry_seed(seed, salt, _WARM_RETRY),
            use_prefilter=use_prefilter, device=device,
        )
        if decoupled_fallback:
            decoupled(_WARM_DECOUPLED_RETRY)

    best: PairResult | None = None
    for t in range(ddtime):
        res = solve_with_prefilter(
            src32, dst32, params, retry_seed(seed, salt, t),
            use_prefilter=retry_uses_prefilter(t, ddtime, use_prefilter), device=device,
        )
        sol = res.solution
        # ONE readback per retry, then numpy scoring.
        pose = torch.cat([sol.scale.reshape(1), sol.rotation.reshape(9), sol.translation]).cpu().numpy()
        r = score_pose(src64, gt, pose[0], pose[1:10].reshape(3, 3), pose[10:], test_scale,
                       res.elapsed_s)
        if best is None or _rmse_key(r) < _rmse_key(best):
            best = r
    # The fallback only when the kept result has clearly failed (an RMSE far
    # beyond the noise bound, or NaN): the best-of rule consults the GT RMSE
    # already, so this gate opens no new channel of information.
    if decoupled_fallback and not (best.rmse <= 5.0 * params.noise_bound_dataset):
        t0 = time.monotonic()
        dsol, _ = decoupled(_FALLBACK_RETRY)
        pose = torch.cat([dsol.scale.reshape(1), dsol.rotation.reshape(9), dsol.translation]).cpu().numpy()
        elapsed = time.monotonic() - t0
        # Upstream convention: dst = s * R * src + t (solver/classic.py).
        r = score_pose(src64, gt, pose[0], pose[1:10].reshape(3, 3), pose[10:], test_scale,
                       elapsed, upstream_translation=True)
        if _rmse_key(r) < _rmse_key(best):
            best = r
    return best._replace(success=meets(best, criteria, best.time_s))


def scene_stats(results: list[PairResult]) -> dict:
    """A scene's aggregate: recall, and the averages over its successes."""
    succ = [r for r in results if r.success]
    n_s = max(len(succ), 1)
    return {
        "pairs": len(results),
        "recall": len(succ) / max(len(results), 1),
        "avg_scale_error": sum(r.scale_error for r in succ) / n_s,
        "avg_angle_error_deg": sum(r.angle_error_deg for r in succ) / n_s,
        "avg_trans_error": sum(r.trans_error for r in succ) / n_s,
        "avg_rmse": sum(r.rmse for r in succ) / n_s,
        "avg_time_s": sum(r.time_s for r in succ) / n_s,
    }


def csv_row(tag: str, r: PairResult) -> list:
    return [tag, r.scale_error, r.angle_error_deg, r.trans_error, r.rmse, r.time_s,
            int(r.success)]


def run_scene(
    scene_dir: str,
    label_file: str,
    params: SolverParams,
    criteria: SuccessCriteria,
    out_csv: str,
    descriptor: str = "fpfh",
    ddtime: int = 10,
    unknown_scale: bool = False,
    seed: int = 0,
    resume: bool = True,
    decoupled_fallback: bool = False,
    use_prefilter: bool = True,
    device="cuda",
) -> dict:
    """Evaluate one scene directory; returns aggregate stats incl. recall.

    Checkpoint and resume (the reference has none): per-pair results append
    to `<out_csv>.progress.jsonl`; on restart, completed pairs are skipped,
    so a 1623-pair sweep survives interruption."""
    pairs = read_pair_labels(label_file)
    progress_path = out_csv + ".progress.jsonl"
    done: dict[str, PairResult] = {}
    if resume and os.path.exists(progress_path):
        with open(progress_path) as f:
            for line in f:
                rec = json.loads(line)
                done[rec["pair"]] = PairResult(**{k: rec[k] for k in PairResult._fields})

    rows = []
    results: list[PairResult] = []
    for a, b in pairs:
        tag = f"{a}+{b}"
        if tag in done:
            r = done[tag]
        else:
            corr_path, gt_path = pair_files(scene_dir, a, b, descriptor)
            src, dst = read_corr_file(corr_path)
            salt = pair_salt(a, b)
            r = evaluate_pair(
                src, dst, read_gt_mat(gt_path), params, criteria, seed, salt, ddtime,
                pair_test_scale(seed, salt) if unknown_scale else 1.0,
                use_prefilter=use_prefilter, decoupled_fallback=decoupled_fallback,
                device=device,
            )
            append_jsonl(progress_path, {"pair": tag, **r._asdict()})
        results.append(r)
        rows.append(csv_row(tag, r))

    write_csv(out_csv, CSV_HEADER, rows)
    return scene_stats(results)


def sweep_setup(data_root, dataset, scenes, params, unknown_scale):
    """(params, criteria, scenes) of a dataset sweep, shared by the serial
    and the batched harness.

    The reference program ties scale estimation to the unknown-scale protocol
    (params.estimate_scaling = unknownScale, main.cc:319): the standard runs
    solve at known scale through the beta-window reduced set
    (registration.cc:753-767). Applied whatever the caller's params say: the
    rule is the protocol's, not the preset's, so params with other caps must
    not silently turn scale estimation back on."""
    if params is None:
        params = default_params(dataset)
    params = params.replace(estimate_scaling=unknown_scale)
    if scenes is None:
        scenes = (
            THREEDMATCH_SCENES
            if dataset in ("3dmatch", "3dlomatch")
            else sorted(os.listdir(data_root))
        )
    return params, SuccessCriteria.for_dataset(dataset), scenes


def write_average_csv(out_dir: str, dataset: str, descriptor: str, summary: dict) -> None:
    """Average_<dataset>_<descriptor>.csv: one row a scene, the stats' scalar
    entries in sorted key order (the batched harness's `split` dict is not a
    column)."""
    def columns(stats):
        return sorted(k for k, v in stats.items() if not isinstance(v, dict))

    header = ["scene"] + (columns(next(iter(summary.values()))) if summary else [])
    write_csv(
        os.path.join(out_dir, f"Average_{dataset}_{descriptor}.csv"), header,
        [[scene] + [stats[k] for k in columns(stats)] for scene, stats in summary.items()],
    )


def run_benchmark(
    data_root: str,
    out_dir: str,
    dataset: str = "3dmatch",
    scenes: list[str] | None = None,
    params: SolverParams | None = None,
    descriptor: str = "fpfh",
    ddtime: int = 10,
    unknown_scale: bool = False,
    seed: int = 0,
    decoupled_fallback: bool = False,
    device="cuda",
) -> dict:
    """Dataset sweep: per-scene CSVs + averages CSV. Layout mirrors the
    reference: <data_root>/<scene>/ holds the corr/GT files and a
    `pairs.txt` label list. `estimate_scaling` follows `unknown_scale`
    whatever the caller's params say (`sweep_setup`)."""
    params, criteria, scenes = sweep_setup(data_root, dataset, scenes, params, unknown_scale)
    os.makedirs(out_dir, exist_ok=True)
    summary = {}
    for scene in scenes:
        scene_dir = os.path.join(data_root, scene)
        summary[scene] = run_scene(
            scene_dir,
            os.path.join(scene_dir, "pairs.txt"),
            params,
            criteria,
            os.path.join(out_dir, f"{scene}_{descriptor}_{int(unknown_scale)}.csv"),
            descriptor=descriptor,
            ddtime=ddtime,
            unknown_scale=unknown_scale,
            seed=seed,
            decoupled_fallback=decoupled_fallback,
            device=device,
        )
    write_average_csv(out_dir, dataset, descriptor, summary)
    return summary
