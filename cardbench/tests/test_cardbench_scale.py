"""The yardstick at a test scale (the reference's unknownScale protocol,
teaser_cpp_ply_main.cc:319): what the known-scale cells read is what they
read before the scale was added (pool digests and judge readings pinned
from the commit before it), the stretched pool is the port's stretch, the
similarity fit recovers a noiseless pose, the judge holds each answer to its
pair's own scale, and a tiny unknown-scale cell added as files is correct
when sound and not with the control or a fault."""

import hashlib
import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cardbench import harness, probe
from cardbench.reference import generator, judge, oracle
from cardbench.traffic_base import PairTraffic
from conftest import ROOT
from psulvsb_tpu_torch.eval import synthetic

CFG = {n: json.loads((ROOT / f"cardbench/configs/{n}.json").read_text())
       for n in ("3dmatch", "kitti")}
WORKLOADS = {n: json.loads((ROOT / f"cardbench/workloads/{n}.json").read_text())
             for n in ("3dmatch.inorder", "kitti.online")}
TINY = [200, 300]
SEEDS = [2**32 + 17, 5]
RUN_SEED = 9180000001
TEST_SCALE = {"low": 1.0, "high": 5.0}
# The judge's readings of the commit before the test scale; later keys are left out.
JUDGED = ("finite", "orth_err", "scale_err", "filtered", "missed", "count_off", "rot_gap_deg",
          "trans_gap", "recall")
# sha256 of each reading below, taken on the commit before the test scale (805616332efe).
PINNED = {
    "pool.3dmatch.tiny.4294967313":
        "abb300016113d8a712d8cea809131e0d08ba88f774f86b375cc7c8b9e9dffe65",
    "pool.3dmatch.tiny.5": "09e378c4015279b05b80f08a6a9ed63282de335b6e5dc276a0ee681b9742f594",
    "pool.kitti.tiny.4294967313":
        "7ee75fe0384bd9592dcb319f74e75d97f9f30ee7ad220249d86ca087df5be15d",
    "pool.kitti.tiny.5": "3819bf7d72969f1fac8ff79895d3b53408131b0623a517073fd71c7ef44743e4",
    "pool.3dmatch.inorder": "75ce31db7e03a54e6ab078b1bf9b182709c2bb6c36a6eea9975e3ce1f374aab8",
    "pool.3dmatch.vectorized": "5558e11f9164bb722ed32c85c6f226efebca4cfa3dfaad9fcc831abb82b17eae",
    "pool.kitti": "94fe2c8379e880c86a186dd84ca13e167174b909ba3e1b7f3584d9a59f169113",
    "judge.3dmatch.4294967313": "b73d15b1ca50ccd6861974c6be8fa5642b34fb9b375f766aee518d763ec3f415",
    "judge.3dmatch.5": "d269dd840818a4885f932f7eac140a1827fb802eb2c392e60a6a3ce17d351116",
    "judge.kitti.4294967313": "84b9e5d678ca0993063a606255e9ae6b6385601d297526052d56c7b2b95b915e",
    "judge.kitti.5": "8b24ed35785f4d76343b811b212a784cb6a1e3735da6a9642194a43c3004521c",
    "window.3dmatch.inorder": "59070056b666168cf729ff08b586b4b815282e0d4051cb63cddab61a7558cf37",
    "window.kitti.online": "ea28e7622bb68f3eab938e4423f1acc9c67a2850dad4db8e16998597cdbf238f",
}
POOLS = {  # pin: (configuration, seed, sizes, pairs a size)
    **{f"pool.{name}.tiny.{seed}": (name, seed, TINY, 4) for name in CFG for seed in SEEDS},
    "pool.3dmatch.inorder": ("3dmatch", RUN_SEED, [3500, 5000, 6500], 48),
    "pool.3dmatch.vectorized": ("3dmatch", RUN_SEED, [5000], 64),
    "pool.kitti": ("kitti", RUN_SEED, [1500, 2500], 48),
}


def canon(x):
    """Readings as JSON with every float exact (hex)."""
    if isinstance(x, dict):
        return {k: canon(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return canon(x.tolist())
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x).hex()
    return x


def digest(readings) -> str:
    return hashlib.sha256(json.dumps(canon(readings)).encode()).hexdigest()


def pool_digest(config, seed, sizes, per_size) -> str:
    h = hashlib.sha256()
    pool = generator.make_pool(config, seed, sizes, per_size)
    for n in sizes:
        for p in pool[n]:
            assert p.scale == 1.0
            for a in (p.src, p.dst, p.rotation, p.translation, p.outlier_mask):
                h.update(np.ascontiguousarray(a).tobytes())
                h.update(str(a.dtype).encode())
    return h.hexdigest()


def _turn(angle_deg):
    return generator.rodrigues([0.3, -0.5, 0.8], np.radians(angle_deg))


def answers(pair, thr, fit, nb):
    """A fixed set of answers to a known-scale pair: the truth, the fit, and
    the truth turned, moved, miscounted, invalid, scaled, not finite."""
    r = np.asarray(pair.rotation, np.float64)
    t = np.asarray(pair.translation, np.float64)
    cons = judge.consensus(pair.src, pair.dst, 1.0, r, t, thr)
    base = {"valid": True, "scale": 1.0, "rotation": r, "translation": t, "count": cons}
    return [
        base,
        dict(fit),
        {**base, "rotation": _turn(0.5) @ r, "translation": t + 0.3 * nb},
        {**base, "translation": t + 40 * nb},
        {**base, "count": cons // 2},
        {**base, "valid": False},
        {**base, "scale": 1.001},
        {**base, "rotation": np.full((3, 3), np.nan)},
        {**base, "rotation": _turn(20.0) @ r, "count": cons + 3},
    ]


def judge_readings(name, seed) -> list:
    """The truth's residuals, the float64 fit, both controls and the judge's
    readings of `answers` with and without a pre-filter."""
    config = CFG[name]
    nb = config["noise_bound"]
    pool = generator.make_pool(config, seed, TINY, 4)
    out = []
    for n in TINY:
        for pair in pool[n]:
            thr = judge.inlier_threshold(nb, np.ones(n))
            res = judge.residuals(pair.src, pair.dst, 1.0, pair.rotation, pair.translation)
            explained = int((res <= thr).sum())
            fit = oracle.oracle_answer(pair, thr, torch.float64)
            out.append({"thr": thr, "res": res, "fit": fit,
                        "ctl": oracle.oracle_answer(pair, thr, torch.bfloat16),
                        "ctl32": oracle.oracle_answer(pair, thr, torch.bfloat16, torch.float32)})
            for a in answers(pair, thr, fit, nb):
                for kept in (None, explained, int(0.4 * explained)):
                    r = judge.judge(pair, a, thr, explained, config["criteria"], fit, kept)
                    out.append({k: r[k] for k in JUDGED})
    return out


def window_checks(name, cell, seed) -> dict:
    """harness.judge_window over a run whose records hold `answers`, two a
    record (and keep masks, where the cell checks them)."""
    config = CFG[name]
    nb = config["noise_bound"]
    traffic = SimpleNamespace(pool=generator.make_pool(config, seed, TINY, 4))
    traffic.pair = lambda key: PairTraffic.pair(traffic, key)
    traffic.answers = lambda rec: PairTraffic.answers(traffic, rec)
    records = []
    for n in TINY:
        for j, pair in enumerate(traffic.pool[n]):
            thr = judge.inlier_threshold(nb, np.ones(n))
            alts = answers(pair, thr, oracle.oracle_answer(pair, thr, torch.float64), nb)
            picked = [alts[(2 * j + k) % len(alts)] for k in (0, 1)]
            rec = {"size": n, "idx": [j, j],
                   "answers": tuple(np.stack([np.asarray(a[f], np.float64) for a in picked])
                                    for f in ("valid", "scale", "rotation", "translation",
                                              "count"))}
            if "keep_off_share" in WORKLOADS[cell]["limits"]:
                keep = np.ones(n, np.int64)
                keep[j::7] = -1
                rec["keep"] = [keep, np.ones(n, np.int64)]
            records.append(rec)
    run = SimpleNamespace(config=config, workload=WORKLOADS[cell], records=records,
                          traffic=traffic, judged=[], seed=seed,
                          cell=SimpleNamespace(name=cell))
    return harness.judge_window(run)


@pytest.mark.parametrize("pin", sorted(POOLS))
def test_known_scale_pools_are_unchanged(pin):
    name, seed, sizes, per_size = POOLS[pin]
    assert pool_digest(CFG[name], seed, sizes, per_size) == PINNED[pin]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CFG))
def test_known_scale_judge_readings_are_unchanged(name, seed):
    assert digest(judge_readings(name, seed)) == PINNED[f"judge.{name}.{seed}"]


@pytest.mark.parametrize("name,cell", [("3dmatch", "3dmatch.inorder"),
                                       ("kitti", "kitti.online")])
def test_known_scale_window_checks_are_unchanged(name, cell):
    checks = window_checks(name, cell, SEEDS[0])
    assert digest(checks) == PINNED[f"window.{cell}"], checks


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CFG))
def test_at_known_scale_every_pair_is_clean(name, seed):
    """The pose gaps' medians are over the answers to clean pairs; at known
    scale every true inlier lies within sqrt(3) nb of the truth, inside the
    smallest threshold, 2 nb, so those medians are over every hit."""
    config = CFG[name]
    nb = config["noise_bound"]
    for n, pairs in generator.make_pool(config, seed, TINY, 4).items():
        for pair in pairs:
            res = judge.residuals(pair.src, pair.dst, pair.scale, pair.rotation,
                                  pair.translation)[~pair.outlier_mask]
            assert res.max() <= np.sqrt(3.0) * nb * (1 + 1e-4) < 2 * nb


def test_a_window_without_clean_answers_fails():
    """Where no answer is to a clean pair, the pose gaps' medians read inf
    (not 0), so such a window compares nothing and is not correct."""
    config = {**CFG["3dmatch"], "test_scale": {"low": 4.0, "high": 5.0}}
    nb = config["noise_bound"]
    traffic = SimpleNamespace(pool=generator.make_pool(config, SEEDS[0], TINY, 4))
    traffic.pair = lambda key: PairTraffic.pair(traffic, key)
    traffic.answers = lambda rec: PairTraffic.answers(traffic, rec)
    records = []
    for n in TINY:
        thr = judge.inlier_threshold(nb, np.ones(n))
        for j, pair in enumerate(traffic.pool[n]):
            t = np.asarray(pair.translation, np.float64)
            cons = judge.consensus(pair.src, pair.dst, pair.scale, pair.rotation, t, thr)
            records.append({"size": n, "idx": [j], "answers": (
                np.array([1.0]), np.array([pair.scale]), np.asarray(pair.rotation)[None],
                t[None], np.array([cons]))})
    run = SimpleNamespace(config=config, workload=WORKLOADS["3dmatch.inorder"], records=records,
                          traffic=traffic, judged=[], seed=SEEDS[0],
                          cell=SimpleNamespace(name="3dmatch.inorder"))
    checks = harness.judge_window(run)
    assert not any(r["clean"] for r in run.judged)
    assert checks["missed_share"]["value"] == 0.0 and checks["scale_err"]["value"] == 0.0
    assert checks["rot_gap_deg_p50"]["value"] == checks["trans_gap_p50"]["value"] == np.inf


def stretched(config):
    return {**config, "test_scale": TEST_SCALE}


@pytest.mark.parametrize("seed", [3, 2**40 + 5])
def test_a_stretched_pool_is_the_ports_stretch(seed):
    """The pool with a test scale is the pool without it, each dst then
    stretched as the port's eval/realdata.py:278 stretches it (the float32
    dst times the scale, in float32), and close to the port's synthetic
    pair at that test scale; the scales are the strata's midpoints."""
    plain = generator.make_pool(CFG["3dmatch"], seed, TINY, 6)
    pool = generator.make_pool(stretched(CFG["3dmatch"]), seed, TINY, 6)
    for n in TINY:
        for j, (p, q) in enumerate(zip(plain[n], pool[n])):
            sigma = generator.pool_scale(j, 6, TEST_SCALE)
            assert q.scale == sigma and p.scale == 1.0
            for field in ("src", "rotation", "translation", "outlier_mask"):
                assert np.array_equal(getattr(p, field), getattr(q, field))
            assert q.dst.dtype == np.float32
            assert np.array_equal(q.dst, np.asarray(p.dst * sigma, np.float32))
        assert sorted(q.scale for q in pool[n]) == pytest.approx(
            [1.0 + 4.0 * (i + 0.5) / 6 for i in range(6)], abs=1e-12)
    cloud = generator.synthetic_cloud(500, seed=seed % 1000)
    ours = generator.make_synthetic_pair(np.random.default_rng(seed), cloud, 0.01, 0.9, 2.0,
                                         "mismatch")
    port = synthetic.make_synthetic_pair(np.random.default_rng(seed), cloud, 0.01, 0.9, 2.0,
                                         outlier_mode="mismatch", test_scale=3.7)
    np.testing.assert_allclose(np.asarray(ours.dst * 3.7, np.float32), port.dst, rtol=0,
                               atol=3.7e-5)


def test_scales_follow_neither_the_angle_nor_the_outlier_rate():
    """At 48 pairs a size every outlier rate of the 6-rate cycle meets
    scales from each quarter of [1, 5), and so does each quarter of the
    angles."""
    scales = np.array([generator.pool_scale(j, 48, TEST_SCALE) for j in range(48)])
    angles = np.array([generator.pool_angle(j, 48) for j in range(48)])
    quarter = ((scales - 1.0) // 1.0).astype(int)
    for rate in range(6):
        assert set(quarter[rate::6]) == {0, 1, 2, 3}
    for q in range(4):
        assert set(quarter[(angles >= q * np.pi / 4) & (angles < (q + 1) * np.pi / 4)]) == {
            0, 1, 2, 3}


def noiseless(sigma):
    """A float64 pair at scale sigma with a quarter of wrong matches."""
    rng = np.random.default_rng(4)
    src = rng.uniform(-1.0, 1.0, (3, 400))
    rot = generator.rodrigues(rng.uniform(-1.0, 1.0, 3), 2.0)
    trans = rng.uniform(-1.0, 1.0, 3)
    dst = sigma * (rot @ src + trans[:, None])
    wrong = np.zeros(400, bool)
    wrong[::4] = True
    dst[:, wrong] = rng.uniform(-3.0, 3.0, (3, int(wrong.sum())))
    return generator.Pair(src, dst, rot, trans, wrong, sigma)


def test_the_similarity_fit_recovers_a_noiseless_pose():
    pair = noiseless(3.3)
    fit = oracle.oracle_answer(pair, 0.01, torch.float64, similarity=True)
    assert abs(fit["scale"] - 3.3) < 1e-9
    np.testing.assert_allclose(fit["rotation"], pair.rotation, rtol=0, atol=1e-9)
    np.testing.assert_allclose(fit["translation"], pair.translation, rtol=0, atol=1e-9)
    assert fit["count"] == 300
    one = noiseless(1.0)
    rigid = oracle.oracle_answer(one, 0.01, torch.float64)
    similar = oracle.oracle_answer(one, 0.01, torch.float64, similarity=True)
    assert rigid["scale"] == 1.0 and abs(similar["scale"] - 1.0) < 1e-9
    for key in ("rotation", "translation"):
        np.testing.assert_allclose(similar[key], rigid[key], rtol=0, atol=1e-9)
    assert similar["count"] == rigid["count"] == 300


def test_the_judge_holds_an_answer_to_its_pairs_scale():
    """At sigma != 1 the truth's own (sigma, R, t) passes; s = 1 fails
    scale_err and recall; t multiplied by sigma fails recall."""
    config = stretched(CFG["3dmatch"])
    criteria = {**config["criteria"], "max_scale_err": 0.1}
    pool = generator.make_pool(config, SEEDS[0], TINY, 4)
    pair = max(pool[300], key=lambda p: (p.scale - 1.0) * np.linalg.norm(p.translation))
    sigma, t = pair.scale, np.asarray(pair.translation, np.float64)
    assert sigma > 2.0 and (sigma - 1.0) * np.linalg.norm(t) > 2 * criteria["max_trans"]
    thr = judge.inlier_threshold(config["noise_bound"], np.ones(300))
    explained = int((judge.residuals(pair.src, pair.dst, sigma, pair.rotation, t) <= thr).sum())
    assert explained > 0.5 * (~pair.outlier_mask).sum()
    fit = oracle.oracle_answer(pair, thr, torch.float64, similarity=True)
    truth = {"valid": True, "scale": sigma, "rotation": pair.rotation, "translation": t,
             "count": explained}

    def read(**change):
        return judge.judge(pair, {**truth, **change}, thr, explained, criteria, fit)
    sound = read()
    assert sound["scale_err"] == 0.0 and sound["recall"] and not sound["missed"]
    assert not sound["count_off"] and abs(fit["scale"] - sigma) < 1e-3 * sigma
    unscaled = read(scale=1.0)
    assert unscaled["scale_err"] == pytest.approx(sigma - 1.0) and not unscaled["recall"]
    assert unscaled["count_off"]
    assert not read(translation=t * sigma)["recall"]


UNKNOWN = "3dmatch_unknown.inorder"
# Limits of the tiny cell, from CPU readings at this size (seeds 5, 7 and
# 2**32 + 17; the card's cell sets its own): sound orth 2e-7 to 5e-7,
# scale_err 0.015-0.030, count_off 0-0.31, rot gap (pairs whose true inliers
# all lie within the threshold) 4e-6 to 8e-6 deg, trans gap 3e-4 to 2e-3;
# control orth 3.5e-3, rot gap 0.11; control_f32
# rot gap 0.053-0.059; stale and unscaled scale_err 2.0 and 3.5; half orth 1;
# altered count_off 1.
TINY_LIMITS = {"orth_err": 1e-4, "scale_err": 0.1, "count_off_share": 0.5, "missed_share": 0.6,
               "rot_gap_deg_p50": 0.005, "trans_gap_p50": 0.1}


@pytest.fixture(scope="module")
def unknown_root(tiny_root, tmp_path_factory):
    """The tiny tree with an unknown-scale configuration and cell added as
    files: 3dmatch estimating its scale, each pair stretched by a test
    scale in [1, 5), success within 0.1 of it (main.cc:319)."""
    root = tmp_path_factory.mktemp("unknown")
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    cfg = json.loads((root / "cardbench/configs/3dmatch.json").read_text())
    cfg.update(name="3dmatch_unknown", test_scale=TEST_SCALE)
    cfg["solver"]["estimate_scaling"] = True
    cfg["criteria"]["max_scale_err"] = 0.1
    (root / "cardbench/configs/3dmatch_unknown.json").write_text(json.dumps(cfg))
    work = json.loads((root / "cardbench/workloads/3dmatch.inorder.json").read_text())
    work["limits"] = TINY_LIMITS
    (root / f"cardbench/workloads/{UNKNOWN}.json").write_text(json.dumps(work))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "3dmatch_unknown", "source": "https://example.org/u",
                             "file": "cardbench/configs/3dmatch_unknown.json", "reduced": [],
                             "why": "unknown scale"})
    bench["workloads"].append({"name": UNKNOWN, "config": "3dmatch_unknown",
                               "traffic": "inorder", "chips": 1, "why": "unknown scale"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("mode", ["sound", "control", "control_f32", "stale", "half", "altered",
                                  "unscaled"])
def test_an_unknown_scale_cell_added_as_files_is_judged(unknown_root, mode):
    line = probe.probe(UNKNOWN, [SEEDS[0]], 2.0, [mode], torch.device("cpu"),
                       root=unknown_root)[0]
    assert set(line["checks"]) == set(TINY_LIMITS)
    assert line["correct"] == (mode == "sound"), line
