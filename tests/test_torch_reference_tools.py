"""The port's reference-scale tools on the CPU at toy size:
tools/fullscale_sweep_torch.py (the full-cardinality dataset sweep),
tools/clique_scale_audit_torch.py (greedy against exact clique on the
solver's graphs) and tools/cap_sweep_torch.py (the static caps).

The audit's graph is held to the JAX package's `dense_consistency_adjacency`
on JAX's own pair within 0.01% flipped entries (ROADMAP Queue 3: the
‖a‖²+‖b‖²-2ab form sums in another order), and its greedy sizes to JAX's
`greedy_clique` exactly. The tools' runs on the card are chip_smoke.py's
phase 23 and the committed FULLSCALE_h100/, docs/CLIQUE_AUDIT_torch.md and
docs/CAP_SWEEP_torch.md.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.clique.kcore import greedy_clique as j_greedy_clique
from psulvsb_tpu.clique.kcore import triangle_scores as j_triangle_scores
from psulvsb_tpu.eval.synthetic import make_synthetic_pair as j_make_synthetic_pair
from psulvsb_tpu.eval.synthetic import synthetic_cloud as j_synthetic_cloud
from psulvsb_tpu.solver.config import SolverParams as JSolverParams
from psulvsb_tpu.solver.psulvsb import dense_consistency_adjacency as j_adjacency
from psulvsb_tpu_torch.clique.pmc import native_available
from psulvsb_tpu_torch.eval import batch_harness
from psulvsb_tpu_torch.eval.synthetic import SyntheticPair
from tools import cap_sweep_torch, clique_scale_audit_torch, fullscale_sweep_torch

JAX_SUMMARY_KEYS = {"dataset", "pairs", "pairs_expected", "ddtime", "recall", "per_scene_recall",
                    "sweep_wall_s", "swept_this_run", "caps", "n_corr"}
TOY_SCENES = ["7-scenes-redkitchen", "sun3d-home_at-home_at_scan1_2013_jan_1"]
FLIPPED_MAX = 1e-4  # share of the (C, C) entries
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def toy_protocol(monkeypatch):
    """2 scenes x 2 pairs of 64 and 96 correspondences."""
    monkeypatch.setattr(fullscale_sweep_torch, "THREEDMATCH_PAIRS", {s: 2 for s in TOY_SCENES})
    monkeypatch.setattr(fullscale_sweep_torch, "N_CORR", {"3dmatch": (64, 96)})


def test_fullscale_sweep_writes_jax_summary_and_resumes(tmp_path, toy_protocol, monkeypatch):
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    agg = fullscale_sweep_torch.sweep("3dmatch", data, out, 1, "cpu", scenes=TOY_SCENES)
    assert JAX_SUMMARY_KEYS <= set(agg)
    assert agg["pairs"] == agg["pairs_expected"] == 4
    assert agg["swept_this_run"] == 4 and agg["solves"] == 4
    assert set(agg["per_scene_recall"]) == set(TOY_SCENES)
    assert agg["card"] == "cpu" and agg["caps"] == fullscale_sweep_torch.CAPS
    assert agg["n_corr"] == [64, 96] and agg["ddtime"] == 1
    with open(os.path.join(out, "walls.json")) as f:
        walls = json.load(f)
    assert agg["sweep_wall_s"] == round(sum(walls.values()), 1) > 0
    assert os.path.exists(os.path.join(out, "Average_3dmatch_fpfh.csv"))

    def no_solve(*args, **kwargs):
        raise AssertionError("a resumed scene was solved again")

    monkeypatch.setattr(batch_harness, "run_scene_batched", no_solve)
    again = fullscale_sweep_torch.sweep("3dmatch", data, out, 1, "cpu", scenes=TOY_SCENES)
    assert again["swept_this_run"] == 0
    assert again["sweep_wall_s"] == agg["sweep_wall_s"]  # the first call's walls, kept
    assert again["per_scene_recall"] == agg["per_scene_recall"]


def test_fullscale_scene_alone_is_the_whole_sweeps_scene(tmp_path, toy_protocol):
    """A sweep of one scene writes the pairs that scene has in the whole
    dataset's sweep (its seed comes from its place in the scene list)."""
    both, alone = str(tmp_path / "both"), str(tmp_path / "alone")
    fullscale_sweep_torch.generate("3dmatch", both, TOY_SCENES, {s: 2 for s in TOY_SCENES},
                                   (64, 96))
    fullscale_sweep_torch.generate("3dmatch", alone, TOY_SCENES[1:], {TOY_SCENES[1]: 2}, (64, 96))
    name = os.path.join(TOY_SCENES[1], "cloud_bin_1+cloud_bin_2@corr.txt")
    with open(os.path.join(both, name)) as f, open(os.path.join(alone, name)) as g:
        assert f.read() == g.read()


def test_tools_run_on_the_card_unless_asked(tmp_path, capsys):
    """Without --device cpu each tool asks for the card; with none it exits
    1 at once and says why, having written nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run on it")
    out = str(tmp_path / "out")
    assert fullscale_sweep_torch.main(["--out", out, "--data", str(tmp_path / "d")]) == 1
    assert clique_scale_audit_torch.main(["--out", str(tmp_path / "a.md")]) == 1
    assert cap_sweep_torch.main(["--out", str(tmp_path / "c.md")]) == 1
    err = capsys.readouterr().err
    assert err.count("--device cpu") == 3
    assert not os.listdir(tmp_path)


def test_tools_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from tools import cap_sweep_torch, clique_scale_audit_torch, fullscale_sweep_torch\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'psulvsb_tpu.'))"
        " or m == 'psulvsb_tpu' for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _jax_pair(c, rate, mode, seed):
    base = jnp.asarray(j_synthetic_cloud(c, seed=seed), jnp.float32)
    pair = j_make_synthetic_pair(jax.random.PRNGKey(seed * 7919 + 13), base, noise_bound=0.01,
                                 outlier_rate=rate, max_translation=2.0, outlier_mode=mode)
    return pair, SyntheticPair(src=np.asarray(pair.src), dst=np.asarray(pair.dst), transform=None,
                               outlier_mask=np.asarray(pair.outlier_mask))


@pytest.mark.parametrize("rate,mode,estimate_scaling", [
    (0.9, "mismatch", False), (0.9, "clustered", True)])
def test_audit_graph_and_greedy_match_jax(rate, mode, estimate_scaling):
    c, seed = 256, 256 + int(rate * 100)
    jpair, pair = _jax_pair(c, rate, mode, seed)
    adj = clique_scale_audit_torch.case_adjacency(pair, estimate_scaling, torch.device("cpu"))
    params = JSolverParams.preset_3dmatch(estimate_scaling=estimate_scaling, sampled_cap=2048,
                                          basic_cap=256, hypothesis_batch=4)
    if estimate_scaling:
        inl = np.where(~pair.outlier_mask)[0]
        ri, rj = jnp.asarray(inl[:-1], jnp.int32), jnp.asarray(inl[1:], jnp.int32)
        rp = jnp.asarray(ri.shape[0], jnp.int32)
    else:
        ri = rj = jnp.zeros((1,), jnp.int32)
        rp = jnp.asarray(0, jnp.int32)
    want = j_adjacency(jpair.src, jpair.dst, ri, rj, rp, params, jnp.ones((c,), bool))
    want_np = np.asarray(want)
    flipped = int((adj.numpy() != want_np).sum())
    assert flipped <= FLIPPED_MAX * c * c, flipped
    assert want_np.sum() > 0
    sizes = clique_scale_audit_torch.greedy_sizes(torch.as_tensor(want_np.copy()))
    assert sizes["core_greedy"] == int(np.asarray(j_greedy_clique(want)).sum())
    assert sizes["tri_greedy"] == int(
        np.asarray(j_greedy_clique(want, order_scores=j_triangle_scores(want))).sum())


def test_audit_case_row_and_clustered_outliers_collude():
    """audit_case gives the JAX audit's fields; the port's clustered outliers
    form rival near-cliques in the beta graph as JAX's do (outlier-outlier
    edges within 20% of a JAX pair's of the same size; three times those of
    mismatch outliers)."""
    row = clique_scale_audit_torch.audit_case(256, 0.9, "clustered", False, seed=7,
                                              time_limit_s=30.0, device="cpu")
    assert {"C", "rate", "mode", "window", "inliers", "core_greedy", "tri_greedy", "exact",
            "ratio", "t_tri_s", "t_exact_s", "edges"} <= set(row)
    assert row["window"] == "beta" and row["inliers"] == 26
    if native_available():
        assert not row["exact_timed_out"] and row["exact"] >= row["tri_greedy"] > 0
    def outlier_edges(pair):
        adj = clique_scale_audit_torch.case_adjacency(pair, False, torch.device("cpu")).numpy()
        out = pair.outlier_mask
        return int(adj[np.ix_(out, out)].sum()) // 2

    edges = {mode: outlier_edges(clique_scale_audit_torch.case_pair(256, 0.9, mode, seed=7))
             for mode in ("clustered", "mismatch")}
    jax_edges = outlier_edges(_jax_pair(256, 0.9, "clustered", 7)[1])
    assert abs(edges["clustered"] - jax_edges) <= 0.2 * jax_edges, (edges, jax_edges)
    assert edges["clustered"] > 2 * edges["mismatch"], edges
    doc = clique_scale_audit_torch.render([row], "cpu", 30.0)
    assert "| 256 | 0.9 | clustered | beta |" in doc and "below JAX's 600 s" in doc


def test_cap_sweep_point_on_the_cpu():
    row = cap_sweep_torch.sweep_point(cap_sweep_torch.SHIPPED, 1, "cpu")
    assert row["caps"] == list(cap_sweep_torch.SHIPPED)
    for name in ("easy90", "hard95"):
        assert {"ms", "ok", "re", "te", "rounds", "batches"} <= set(row[name])
        assert row[name]["ms"] > 0 and row[name]["batches"] >= row[name]["rounds"] > 0
    assert row["easy90"]["ok"], row
    rows = cap_sweep_torch.merge([[row], [row]])
    assert rows[0]["easy90"]["ms"] == [row["easy90"]["ms"]] * 2
    doc = cap_sweep_torch.render(rows, "cpu", 1, torch.device("cpu"))
    assert "**(2048, 256, 4, 8192)** (shipped)" in doc and "not a card figure" in doc


@pytest.mark.slow
def test_triangle_greedy_matches_exact_on_ratio_window_at_scale():
    """The port's counterpart of tests/test_clique.py::TestGreedyVsExactAtScale
    at C = 2048 (93% mismatch, ratio window), on the port's own pair."""
    if not native_available():
        pytest.skip("the native exact clique library cannot be built here")
    row = clique_scale_audit_torch.audit_case(2048, 0.93, "mismatch", True, seed=2093,
                                              time_limit_s=600.0, device="cpu")
    assert row["exact"] > 0 and not row["exact_timed_out"]
    assert row["ratio"] >= 0.95, row
