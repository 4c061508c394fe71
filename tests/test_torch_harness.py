"""The evaluation harnesses of the port (eval/reporting.py, synthetic.py's
structured_scene, protocol.py, make_dataset.py, realdata.py,
batch_harness.py) against the JAX package's.

Formats are held exactly: the port's readers on files the JAX `write_scene`
wrote and the JAX readers on files the port wrote give the same arrays (the
text holds 8 and 10 decimals), CSV headers and fingerprint keys are JAX's
(plus "backend"). `structured_scene` is the same numpy code: equal arrays.
The sweep itself is distributional, the random streams differ: on one
JAX-written scene at tier-1 size (3 pairs of 500 correspondences, 70-90%
mismatch outliers, ddtime 2) the port's batched harness must reach the JAX
batched harness's recall, and its median and worst RE, TE and RMSE over the
pairs at most twice JAX's plus a floor (0.5 deg, 0.01, 0.01). Inside the
port the serial and the batched harness get their seeds from one function,
so their per-pair results are equal apart from `time_s`, at known and at
unknown scale.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from psulvsb_tpu.eval import batch_harness as jbh
from psulvsb_tpu.eval import make_dataset as jmd
from psulvsb_tpu.eval import protocol as jproto
from psulvsb_tpu.eval import realdata as jrd
from psulvsb_tpu.eval import reporting as jrep
from psulvsb_tpu.eval.synthetic import structured_scene as jax_structured_scene
from psulvsb_tpu.solver.config import SolverParams as JParams
from psulvsb_tpu_torch import SolverParams
from psulvsb_tpu_torch.convert import params_from_jax
from psulvsb_tpu_torch.eval import batch_harness as bh
from psulvsb_tpu_torch.eval import make_dataset as md
from psulvsb_tpu_torch.eval import protocol as proto
from psulvsb_tpu_torch.eval import realdata as rd
from psulvsb_tpu_torch.eval import reporting as rep
from psulvsb_tpu_torch.eval.synthetic import structured_scene, synthetic_cloud
from psulvsb_tpu_torch.solver.fused import plan_for

JPARAMS = JParams.preset_3dmatch(
    estimate_scaling=False, sampled_cap=1024, basic_cap=512, hypothesis_batch=8
)  # tests/test_batch_harness.py's
PARAMS = params_from_jax(JPARAMS)
RATES = (0.7, 0.85, 0.9)
FLOORS = {"angle_error_deg": 0.5, "trans_error": 0.01, "rmse": 0.01}


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_scene"))
    jmd.write_scene(root, n_pairs=3, n_corr=500, outlier_rates=RATES, seed=3)
    return root


@pytest.fixture(scope="module")
def port_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_scene"))
    labels = md.write_scene(root, n_pairs=4, n_corr=(500, 200), outlier_rates=RATES, seed=3)
    assert labels == [(0, 1), (1, 2), (2, 3), (3, 4)]
    return root


def _labels(scene):
    return os.path.join(scene, "pairs.txt")


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


# ---- formats -----------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_readers_agree_on_each_others_files(writer, jax_scene, port_scene):
    scene = jax_scene if writer == "jax" else port_scene
    assert rd.read_pair_labels(_labels(scene)) == jrd.read_pair_labels(_labels(scene))
    log_t = rd.read_gt_log(os.path.join(scene, "gt.log"))
    log_j = jrd.read_gt_log(os.path.join(scene, "gt.log"))
    assert list(log_t) == list(log_j) == rd.read_pair_labels(_labels(scene))
    for a, b in rd.read_pair_labels(_labels(scene)):
        corr, gt = rd.pair_files(scene, a, b)
        for got, want in zip(rd.read_corr_file(corr), jrd.read_corr_file(corr)):
            np.testing.assert_array_equal(got, want)
            assert got.shape[0] == 3 and got.dtype == np.float64
        np.testing.assert_array_equal(rd.read_gt_mat(gt), jrd.read_gt_mat(gt))
        np.testing.assert_array_equal(log_t[(a, b)], log_j[(a, b)])
        np.testing.assert_allclose(log_t[(a, b)], rd.read_gt_mat(gt), atol=1e-10)
    assert rd.pair_files(scene, 1, 2, "fcgf")[0].endswith("cloud_bin_1+cloud_bin_2@corr_fcgf.txt")


def test_written_scene_has_the_reference_layout(port_scene, jax_scene):
    """Same file names and row formats as the JAX generator's; sizes cycle
    with the extra step per rate cycle (pair 3 is the second cycle's first);
    the ground truth is a rigid motion that places the inliers."""
    assert sorted(f for f in os.listdir(jax_scene)) == sorted(
        f for f in os.listdir(port_scene) if "cloud_bin_3+" not in f)
    sizes = []
    for i, (a, b) in enumerate(rd.read_pair_labels(_labels(port_scene))):
        corr, gt_path = rd.pair_files(port_scene, a, b)
        with open(corr) as f:
            first = f.readline().split()
        assert len(first) == 6 and all(len(tok.split(".")[1]) == 8 for tok in first)
        with open(gt_path) as f:
            assert all(len(tok.split(".")[1]) == 10 for tok in f.readline().split())
        src, dst = rd.read_corr_file(corr)
        gt = rd.read_gt_mat(gt_path)
        sizes.append(src.shape[1])
        np.testing.assert_allclose(gt[:3, :3] @ gt[:3, :3].T, np.eye(3), atol=1e-6)
        resid = np.linalg.norm(gt[:3, :3] @ src + gt[:3, 3:4] - dst, axis=0)
        inlier_share = (resid <= np.sqrt(3) * 0.01 + 1e-6).mean()
        assert abs(inlier_share - (1 - md.pair_outlier_rate(i, RATES))) < 0.03
    assert sizes == [500, 200, 500, 500]  # (i + i // 3) % 2


def test_write_benchmark_dataset_presets(tmp_path):
    for dataset, scale in (("kitti", 20.0), ("whu_tls", 30.0), ("3dlomatch", 1.0)):
        root = str(tmp_path / dataset)
        md.write_benchmark(root, ["a", "b"], dataset=dataset, n_pairs={"a": 2, "b": 1}, n_corr=64)
        assert len(rd.read_pair_labels(os.path.join(root, "a", "pairs.txt"))) == 2
        assert len(rd.read_pair_labels(os.path.join(root, "b", "pairs.txt"))) == 1
        src, _ = rd.read_corr_file(rd.pair_files(os.path.join(root, "a"), 0, 1)[0])
        assert 0.5 * scale < np.abs(src).max() < 1.6 * scale
    a0 = rd.read_corr_file(rd.pair_files(os.path.join(root, "a"), 0, 1)[0])[0]
    b0 = rd.read_corr_file(rd.pair_files(os.path.join(root, "b"), 0, 1)[0])[0]
    assert not np.array_equal(a0, b0)  # a scene a seed


@pytest.mark.parametrize("n,seed", [(500, 0), (3000, 4)])
def test_structured_scene_matches_jax(n, seed):
    got = structured_scene(n, seed=seed)
    np.testing.assert_array_equal(got, jax_structured_scene(n, seed=seed))
    assert got.shape == (3, n) and got.dtype == np.float32


def test_reporting_matches_jax(tmp_path):
    rows = [["a", 1.5, 2], ["b", float("nan"), 3]]
    rep.write_csv(str(tmp_path / "t" / "x.csv"), ["k", "v", "n"], rows)
    jrep.write_csv(str(tmp_path / "j" / "x.csv"), ["k", "v", "n"], rows)
    assert (tmp_path / "t" / "x.csv").read_bytes() == (tmp_path / "j" / "x.csv").read_bytes()
    for mod, name in ((rep, "t"), (jrep, "j")):
        mod.append_jsonl(str(tmp_path / name / "p.jsonl"), {"pair": "0+1", "rmse": 0.25})
        mod.append_jsonl(str(tmp_path / name / "p.jsonl"), {"pair": "1+2", "rmse": 0.5})
    assert (tmp_path / "t" / "p.jsonl").read_bytes() == (tmp_path / "j" / "p.jsonl").read_bytes()
    for values in ([1.0, 2.0, 4.0], [], [3.0]):
        assert rep.mean_std(values) == jrep.mean_std(values)


@pytest.mark.parametrize("t,ddtime,use", [(0, 10, True), (1, 10, True), (4, 5, True),
                                          (0, 1, True), (0, 10, False), (3, 10, False)])
def test_retry_uses_prefilter_matches_jax(t, ddtime, use):
    assert rd.retry_uses_prefilter(t, ddtime, use) == jrd.retry_uses_prefilter(t, ddtime, use)


def test_rmse_key_and_success_criteria_match_jax():
    for rmse in (0.5, float("nan"), float("inf"), 0.0):
        r = rd.PairResult(0.0, 0.0, 0.0, rmse, 0.0, False)
        assert rd._rmse_key(r) == jrd._rmse_key(r) == bh._rmse_key(r)
    assert rd.PairResult._fields == jrd.PairResult._fields
    for name in ("threedmatch", "kitti", "whu_tls"):
        assert tuple(getattr(rd.SuccessCriteria, name)()) == tuple(
            getattr(jrd.SuccessCriteria, name)())
    assert rd.SuccessCriteria.for_dataset("kitti") == rd.SuccessCriteria.kitti()
    assert rd.SuccessCriteria.for_dataset("3dlomatch") == rd.SuccessCriteria.threedmatch()
    assert rd.THREEDMATCH_SCENES == jrd.THREEDMATCH_SCENES
    ok = rd.PairResult(0.05, 10.0, 0.2, 0.1, 1.0, False)
    assert rd.meets(ok, rd.SuccessCriteria.threedmatch(), 59.0)
    assert not rd.meets(ok, rd.SuccessCriteria.threedmatch(), 61.0)
    assert not rd.meets(ok, rd.SuccessCriteria.kitti(), 1.0)


def test_seed_derivation_is_shared_and_distinct():
    seeds = {rd.retry_seed(s, rd.pair_salt(a, b), t)
             for s in (0, 1) for a, b in ((0, 1), (1, 2)) for t in range(3)}
    assert len(seeds) == 12 and all(0 <= v < 2**62 for v in seeds)
    assert rd.retry_seed(0, 100004, 1) == rd.retry_seed(0, rd.pair_salt(1, 1), 1)
    scales = [rd.pair_test_scale(0, rd.pair_salt(i, i + 1)) for i in range(50)]
    assert all(1.0 <= v < 5.0 for v in scales) and np.std(scales) > 0.5
    assert rd.pair_test_scale(0, 7) == rd.pair_test_scale(0, 7) != rd.pair_test_scale(1, 7)


def test_score_pose_conventions():
    """The solver's s (R p + t) and the classic solve's s R p + t score the
    same placement alike, in the unscaled frame."""
    rng = np.random.default_rng(0)
    src = rng.normal(size=(3, 40))
    gt = np.eye(4)
    gt[:3, :3] = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    gt[:3, 3] = [0.3, -0.2, 0.5]
    s = 2.5
    ours = rd.score_pose(src, gt, s, gt[:3, :3], gt[:3, 3], s, 0.1)
    upstream = rd.score_pose(src, gt, s, gt[:3, :3], gt[:3, 3] * s, s, 0.1,
                             upstream_translation=True)
    for r in (ours, upstream):
        assert r.rmse < 1e-12 and r.trans_error < 1e-12 and r.angle_error_deg < 1e-6
        assert r.scale_error == 0.0 and r.time_s == 0.1 and r.success is False
    off = rd.score_pose(src, gt, s, gt[:3, :3], gt[:3, 3] + [0.1, 0, 0], s, 0.1)
    np.testing.assert_allclose(off.trans_error, 0.1, rtol=1e-9)
    np.testing.assert_allclose(off.rmse, 0.1, rtol=1e-9)


def test_fingerprint_keys_are_jax_plus_backend():
    crit_j, crit_t = jrd.SuccessCriteria.threedmatch(), rd.SuccessCriteria.threedmatch()
    fp_j = jbh._scene_fingerprint(JPARAMS, 2, False, "fpfh", 0, True, 3, crit_j)
    fp_t = bh._scene_fingerprint(PARAMS, 2, False, "fpfh", 0, True, 3, crit_t)
    assert set(fp_t) == set(fp_j) | {"backend"}
    assert fp_t["backend"] == "torch" and fp_t != fp_j
    same = ("clique_algorithm", "ddtime", "unknown_scale", "descriptor", "seed",
            "use_prefilter", "n_pairs", "criteria", "time_gate", "certify")
    assert {k: fp_t[k] for k in same} == {k: fp_j[k] for k in same}
    from psulvsb_tpu_torch import __version__

    assert fp_t["version"] == __version__
    other = bh._scene_fingerprint(PARAMS.replace(exact_clique_callback=True), 2, False, "fpfh",
                                  0, True, 3, crit_t)
    assert other["clique_algorithm"] == "native-exact-callback"


# ---- the sweeps ----------------------------------------------------------------


def _pair_results(path):
    return {r[0]: rd.PairResult(*(float(x) for x in r[1:6]), bool(int(r[6])))
            for r in _rows(path)[1:]}


def test_batched_harness_matches_jax_harness(jax_scene, tmp_path):
    """Recall and error quantiles against the JAX batched harness on the
    JAX-written scene; the CSVs share their header."""
    crit = jrd.SuccessCriteria.threedmatch()
    jax_csv = str(tmp_path / "jax.csv")
    want = jbh.run_scene_batched(jax_scene, _labels(jax_scene), JPARAMS, crit, jax_csv, ddtime=2)
    port_csv = str(tmp_path / "port.csv")
    got = bh.run_scene_batched(jax_scene, _labels(jax_scene), PARAMS,
                               rd.SuccessCriteria.threedmatch(), port_csv, ddtime=2,
                               device="cpu")
    assert _rows(port_csv)[0] == _rows(jax_csv)[0] == rd.CSV_HEADER
    assert got["pairs"] == want["pairs"] == 3
    assert got["recall"] >= want["recall"] == 1.0
    assert set(got) == set(want) | {"split"} and got["timing"] == want["timing"] == "amortized-batch"
    assert got["time_gate"] == want["time_gate"] and got["pairs_per_s"] > 0
    res_t, res_j = _pair_results(port_csv), _pair_results(jax_csv)
    assert list(res_t) == ["0+1", "1+2", "2+3"] and set(res_j) == set(res_t)
    for field, floor in FLOORS.items():
        for q in (0.5, 1.0):
            port_q = np.quantile([getattr(r, field) for r in res_t.values()], q)
            jax_q = np.quantile([getattr(r, field) for r in res_j.values()], q)
            assert port_q <= 2.0 * jax_q + floor, (field, q, port_q, jax_q)
    split = got["split"]
    assert split["solves"] == 6 and got["pairs_per_s"] == 3 / split["wall_s"]
    parts = ("prefilter_s", "flatten_s", "solve_s", "readback_s")
    assert abs(sum(split[k] for k in parts) - split["wall_s"]) < 1e-3  # the parts make the wall


@pytest.mark.parametrize("unknown_scale", [False, True])
def test_serial_equals_batched_apart_from_time(port_scene, tmp_path, unknown_scale):
    """Two buckets (512 and 256), ddtime 3 (filtered, raw, filtered): every
    pair's PairResult is equal but for time_s; the serial harness resumes
    from its progress file."""
    crit = rd.SuccessCriteria.threedmatch()
    params = PARAMS.replace(estimate_scaling=unknown_scale)
    kw = dict(ddtime=3, unknown_scale=unknown_scale, seed=5, device="cpu")
    b_csv, s_csv = str(tmp_path / "b.csv"), str(tmp_path / "s.csv")
    batched = bh.run_scene_batched(port_scene, _labels(port_scene), params, crit, b_csv, **kw)
    serial = rd.run_scene(port_scene, _labels(port_scene), params, crit, s_csv, **kw)
    res_b, res_s = _pair_results(b_csv), _pair_results(s_csv)
    assert list(res_b) == list(res_s) == ["0+1", "1+2", "2+3", "3+4"]
    for tag in res_b:
        assert res_b[tag]._replace(time_s=0.0) == res_s[tag]._replace(time_s=0.0), tag
    for key in ("pairs", "recall", "avg_scale_error", "avg_angle_error_deg", "avg_trans_error",
                "avg_rmse"):
        assert batched[key] == pytest.approx(serial[key], rel=1e-12), key
    assert batched["recall"] >= 0.75
    if unknown_scale:
        assert all(r.scale_error > 0 for r in res_b.values())
    # Resume: the progress file answers, nothing is solved again.
    with open(s_csv + ".progress.jsonl") as f:
        assert [json.loads(ln)["pair"] for ln in f] == list(res_s)
    bucket_plan = plan_for(params, 512, "cpu")
    bucket_plan.stats = {}
    again = rd.run_scene(port_scene, _labels(port_scene), params, crit, s_csv, **kw)
    assert again == serial and bucket_plan.stats == {}


def test_resume_and_fingerprint_mismatch(port_scene, tmp_path):
    root, out = os.path.dirname(port_scene), str(tmp_path / "out")
    scene = os.path.basename(port_scene)
    kw = dict(scenes=[scene], params=PARAMS, ddtime=2, device="cpu")
    first = bh.run_benchmark_batched(root, out, **kw)
    assert first[scene]["timing"] == "amortized-batch"
    meta = json.load(open(os.path.join(out, f"{scene}_fpfh_0.csv.meta.json")))
    assert meta["fingerprint"]["backend"] == "torch" and meta["stats"] == first[scene]
    assert not os.path.exists(os.path.join(out, f"{scene}_fpfh_0.csv.meta.json.tmp"))
    again = bh.run_benchmark_batched(root, out, resume=True, **kw)
    assert again[scene]["timing"] == "resumed"
    assert {k: v for k, v in again[scene].items() if k != "timing"} == {
        k: v for k, v in first[scene].items() if k != "timing"}
    avg = _rows(os.path.join(out, "Average_3dmatch_fpfh.csv"))
    assert avg[0] == ["scene"] + sorted(k for k in first[scene] if k != "split")
    assert avg[1][0] == scene
    # Another protocol, a sidecar of the JAX package, a missing CSV: all re-run.
    other = bh.run_benchmark_batched(root, out, resume=True, **{**kw, "ddtime": 1})
    assert other[scene]["timing"] == "amortized-batch"
    path = os.path.join(out, f"{scene}_fpfh_0.csv.meta.json")
    meta = json.load(open(path))
    del meta["fingerprint"]["backend"]
    json.dump(meta, open(path, "w"))
    assert bh.run_benchmark_batched(root, out, resume=True, **{**kw, "ddtime": 1})[scene][
        "timing"] == "amortized-batch"
    os.remove(os.path.join(out, f"{scene}_fpfh_0.csv"))
    assert bh.run_benchmark_batched(root, out, resume=True, **{**kw, "ddtime": 1})[scene][
        "timing"] == "amortized-batch"


def test_run_benchmark_ties_scale_estimation_to_the_protocol(port_scene, tmp_path):
    """estimate_scaling = unknown_scale whatever the caller's params say
    (main.cc:319), in both harnesses; the serial sweep writes the average
    CSV with JAX's header."""
    root, scene = os.path.dirname(port_scene), os.path.basename(port_scene)
    params, crit, scenes = rd.sweep_setup(root, "3dmatch", [scene],
                                          PARAMS.replace(estimate_scaling=True), False)
    assert not params.estimate_scaling and crit == rd.SuccessCriteria.threedmatch()
    assert rd.sweep_setup(root, "kitti", None, None, True)[0] == SolverParams.preset_kitti()
    assert rd.sweep_setup(root, "whu_tls", None, None, True)[1] == rd.SuccessCriteria.whu_tls()
    out = str(tmp_path / "serial")
    summary = rd.run_benchmark(root, out, scenes=[scene],
                               params=PARAMS.replace(estimate_scaling=True), ddtime=1,
                               device="cpu")
    assert summary[scene]["pairs"] == 4 and summary[scene]["avg_scale_error"] == 0.0
    avg = _rows(os.path.join(out, "Average_3dmatch_fpfh.csv"))
    assert avg[0] == ["scene"] + sorted(k for k in summary[scene] if k != "split")
    assert _rows(os.path.join(out, f"{scene}_fpfh_0.csv"))[0] == rd.CSV_HEADER


def test_decoupled_fallback_rescues_a_failed_pair(tmp_path):
    """max_host_rounds=0 leaves the PSULVSB result at the identity (a failed
    RMSE), so the fallback retry runs the classic solve, whose upstream
    translation convention is scored as such at a test scale of 2."""
    scene = str(tmp_path / "scene")
    md.write_scene(scene, n_pairs=1, n_corr=150, outlier_rates=(0.5,), seed=2)
    corr, gt_path = rd.pair_files(scene, 0, 1)
    src, dst = rd.read_corr_file(corr)
    params = SolverParams.preset_3dmatch(max_host_rounds=0, sampled_cap=512, basic_cap=64)
    crit = rd.SuccessCriteria.threedmatch()
    args = (src, dst, rd.read_gt_mat(gt_path), params, crit, 0, rd.pair_salt(0, 1))
    plain = rd.evaluate_pair(*args, ddtime=1, test_scale=2.0, device="cpu")
    assert not plain.success and plain.rmse > 0.05
    rescued = rd.evaluate_pair(*args, ddtime=1, test_scale=2.0, decoupled_fallback=True,
                               device="cpu")
    assert rescued.success and rescued.rmse < 0.05 and rescued.trans_error < 0.05
    assert rescued.scale_error < 0.05


def test_certify_raises_naming_the_roadmap_item(port_scene, tmp_path):
    with pytest.raises(NotImplementedError, match="item 13"):
        bh.run_scene_batched(port_scene, _labels(port_scene), PARAMS,
                             rd.SuccessCriteria.threedmatch(), str(tmp_path / "c.csv"),
                             certify=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        bh.run_benchmark_batched(os.path.dirname(port_scene), str(tmp_path / "o"),
                                 scenes=[os.path.basename(port_scene)], certify=True,
                                 device="cpu")


def test_warm_scene_builds_a_plan_a_bucket(port_scene):
    from psulvsb_tpu_torch.solver import fused

    params = PARAMS.replace(sampled_cap=777)  # plans of its own
    bh.warm_scene(port_scene, params, device="cpu")
    keys = [k for k in fused._PLANS if k[0] == params]
    assert sorted(k[1] for k in keys) == [256, 512]
    assert all(plan_for(params, b, "cpu").stats for b in (256, 512))  # a solve went through each
    assert plan_for(params, 512, "cpu").capture_all(torch.Generator()) == 0  # no graphs here
    # The plan cache is the one record of what is warm: plans rebuilt after
    # the cache was emptied are warmed again.
    fused.clear_plan_cache()
    assert not plan_for(params, 512, "cpu").stats
    bh.warm_scene(port_scene, params, device="cpu")
    assert all(plan_for(params, b, "cpu").stats for b in (256, 512))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            bh.warm_scene(port_scene, params)


# ---- the synthetic protocol ------------------------------------------------------


def test_protocol_matches_jax_headers_and_passes(tmp_path):
    """Three trials on a 300-point cloud at 50% displaced outliers (the
    pre-filter is on, and displaced points have no surface normals): the CSV headers
    are JAX's, the trials pass the synthetic protocol's criteria, and a
    trial is a function of its seed."""
    params = SolverParams.preset_artificial(sampled_cap=512, basic_cap=128, hypothesis_batch=4)
    cloud = synthetic_cloud(300, seed=1)
    out = str(tmp_path / "proto")
    agg = proto.run_protocol({"blob": cloud}, params, out, trials=3, outlier_rate=0.5,
                             device="cpu")
    assert proto.TrialResult._fields == jproto.TrialResult._fields
    assert _rows(os.path.join(out, "blob.csv"))[0] == [
        "trial", "ScaleError", "AngleError", "TransError", "RMSE", "Time"]
    avg = _rows(os.path.join(out, "Average.csv"))
    assert avg[0] == ["cloud"] + [f"{f}_{s}" for f in jproto.TrialResult._fields
                                  for s in ("mean", "std")]
    assert avg[1][0] == "blob" and len(_rows(os.path.join(out, "blob.csv"))) == 4
    assert set(agg["blob"]) == set(proto.TrialResult._fields)
    assert agg["blob"]["angle_error_deg"][0] < 5.0 and agg["blob"]["trans_error"][0] < 0.3
    assert agg["blob"]["scale_error"] == (0.0, 0.0)
    one = proto.run_trial((0, 1, 2), cloud, params, outlier_rate=0.5, device="cpu")
    two = proto.run_trial((0, 1, 2), cloud, params, outlier_rate=0.5, device="cpu")
    assert one._replace(time_s=0.0) == two._replace(time_s=0.0)
    assert one._replace(time_s=0.0) != proto.run_trial(
        (0, 1, 3), cloud, params, outlier_rate=0.5, device="cpu")._replace(time_s=0.0)
