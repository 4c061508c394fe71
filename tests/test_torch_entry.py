"""The port's entry layer against the JAX package's on the CPU: the last
core helpers, `write_iteration_stats`, `utils.timing`, the CLI behind the
MATLAB bridge, `matlab/torch/teaser_solve.m` as text, and the generated
API reference.

Inputs come from numpy seeds and go through both packages. Tolerances:
1e-6 on the float32 helpers (the same expression in both), 1e-4 on the
decoupled CLI solve (float32 sums in another order across a whole solve),
the recovery gates of tests/test_cli.py on the PSULVSB solve, whose random
streams differ between the packages; equality on the host-side helpers and
on the stats file."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu import cli as jcli
from psulvsb_tpu.core import linalg as jl
from psulvsb_tpu.core import metrics as jm
from psulvsb_tpu.core import se3 as jse3
from psulvsb_tpu.solver import psulvsb as jsolver
from psulvsb_tpu_torch import cli as tcli
from psulvsb_tpu_torch.core import linalg as tl
from psulvsb_tpu_torch.core import metrics as tm
from psulvsb_tpu_torch.core import se3 as tse3
from psulvsb_tpu_torch.solver import psulvsb as tsolver
from psulvsb_tpu_torch.utils import timing

from test_cli import _make_problem, _parse_solution, _write_cloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ATOL = 1e-6
SOLVE_TOL = 1e-4
KEYS = ["scale", "rotation", "rotation", "rotation", "translation", "time_ms", "valid"]


# --- core helpers ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rodrigues_matches_jax(seed):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3).astype(np.float32)
    angle = np.float32(rng.uniform(0, np.pi))
    want = np.asarray(jse3.rodrigues(jnp.asarray(axis), jnp.asarray(angle)))
    got = tse3.rodrigues(torch.as_tensor(axis), angle)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    got64 = tse3.rodrigues(torch.as_tensor(axis, dtype=torch.float64), float(angle))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), want, atol=ATOL)


def test_compose_srt_matches_jax():
    rng = np.random.default_rng(3)
    r_out = tse3.rodrigues(torch.as_tensor(rng.normal(size=3)), 0.7).float().numpy()
    r_in = tse3.rodrigues(torch.as_tensor(rng.normal(size=3)), 1.9).float().numpy()
    t_out = rng.normal(size=3).astype(np.float32)
    t_in = rng.normal(size=3).astype(np.float32)
    scale = np.float32(1.7)
    want = jse3.compose_srt(jnp.asarray(r_out), jnp.asarray(t_out),
                            jse3.SE3(jnp.asarray(scale), jnp.asarray(r_in), jnp.asarray(t_in)))
    got = tse3.compose_srt(torch.as_tensor(r_out), torch.as_tensor(t_out),
                           tse3.SE3(torch.as_tensor(scale), torch.as_tensor(r_in),
                                    torch.as_tensor(t_in)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL)


def test_translation_error_matches_jax():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(2, 3)).astype(np.float32)
    want = float(jm.translation_error(jnp.asarray(a), jnp.asarray(b)))
    got = tm.translation_error(torch.as_tensor(a), torch.as_tensor(b))
    assert abs(float(got) - want) < ATOL
    batch = tm.translation_error(torch.as_tensor(np.stack([a, b])), torch.as_tensor(b))
    np.testing.assert_allclose(batch.numpy(), [want, 0.0], atol=ATOL)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_host_helpers_equal_jax(as_tensor):
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=17) < 0.4
    arr = rng.normal(size=(3, 17))
    cols = [0, 4, 16]
    wrap = torch.as_tensor if as_tensor else (lambda x: x)
    elements = list(range(100, 117))
    assert tl.mask_vector(wrap(mask), elements) == jl.mask_vector(mask, elements)
    assert tl.find_nonzero(wrap(mask)) == jl.find_nonzero(mask)
    np.testing.assert_array_equal(tl.remove_columns(wrap(arr), cols),
                                  jl.remove_columns(arr, cols))


@pytest.mark.parametrize("n,k", [(10, 10), (50, 7), (1, 1)])
def test_random_sample_distinct_in_range(n, k):
    gen = torch.Generator().manual_seed(n + k)
    idx = tl.random_sample(gen, n, k)
    assert idx.shape == (k,) and idx.dtype == torch.int64
    assert len(set(idx.tolist())) == k
    assert 0 <= int(idx.min()) and int(idx.max()) < n


@pytest.mark.parametrize("vectors", [True, False])
def test_batched_eigh_in_chunks_equals_one_call(vectors, monkeypatch):
    """The front end's chunked eigen-solve (cuSOLVER refuses batches of
    32767 or more on the card) gives what one call gives."""
    rng = np.random.default_rng(9)
    a = torch.as_tensor(rng.normal(size=(50, 3, 3)))
    a = a @ a.transpose(1, 2)
    whole = tl.batched_eigh(a, vectors)
    monkeypatch.setattr(tl, "EIGH_BATCH", 7)
    chunked = tl.batched_eigh(a, vectors)
    for got, want in zip(*(x if vectors else (x,) for x in (chunked, whole))):
        assert torch.equal(got, want)


def test_write_iteration_stats_byte_equal(tmp_path):
    """The stats file from a port solve's own info equals the JAX writer's."""
    from psulvsb_tpu_torch import RobustRegistrationSolver, SolverParams

    rng = np.random.default_rng(6)
    src, dst, *_ = _make_problem(rng, n=80)
    solver = RobustRegistrationSolver(
        SolverParams.preset_artificial(sampled_cap=256, basic_cap=128, hypothesis_batch=4,
                                       estimate_scaling=True),
        seed=0, device="cpu")
    solver.solve(src.astype(np.float32), dst.astype(np.float32))
    info = solver._info
    tsolver.write_iteration_stats(str(tmp_path / "port.txt"), info)
    jsolver.write_iteration_stats(str(tmp_path / "jax.txt"), info)
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    assert got.decode().split() == [str(info["rounds"]), str(info["total_local_batches"]),
                                    str(info["total_hypotheses"])]


# --- utils.timing ---------------------------------------------------------


def test_timer_timed_and_throttle(caplog):
    t = timing.Timer("x").start()
    assert t.stop(sync_on=[torch.zeros(2), {"a": (torch.ones(1),)}]) >= 0
    assert t.get_timing() == t.elapsed_s
    with timing.timed("span", sync_on=torch.zeros(1)) as r:
        pass
    assert r["elapsed_s"] >= 0
    caplog.set_level("INFO", logger="psulvsb_tpu")
    timing._throttle_counts.pop("k", None)
    for i in range(25):
        timing.log_throttled("k", f"msg {i}", every=10)
    logged = [rec.getMessage() for rec in caplog.records if rec.name == "psulvsb_tpu"]
    assert logged == ["msg 0", "msg 10", "msg 20"]
    # The JAX package's logger name: one logging setting serves both.
    assert timing.logger.name == "psulvsb_tpu"


def test_trace_writes_chrome_trace(tmp_path):
    with timing.trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(d) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# --- the CLI --------------------------------------------------------------


def test_parser_defaults_equal_jax():
    """Flag for flag, JAX's --platform becoming --device (default cuda)."""
    argv = ["--src", "s", "--dst", "d"]
    want = vars(jcli.build_parser().parse_args(argv))
    got = vars(tcli.build_parser().parse_args(argv))
    assert want.pop("platform") is None
    assert got.pop("device") == "cuda"
    assert got == want

    def flags(parser):
        return [s for a in parser._actions for s in a.option_strings if s not in ("-h", "--help")]

    jflags = flags(jcli.build_parser())
    jflags[jflags.index("--platform")] = "--device"
    assert flags(tcli.build_parser()) == jflags


def test_reads_both_orientations(tmp_path):
    pts = np.random.default_rng(7).normal(size=(3, 40))
    _write_cloud(tmp_path / "a.csv", pts)
    _write_cloud(tmp_path / "b.txt", pts.T, fmt="txt")
    for name in ("a.csv", "b.txt"):
        np.testing.assert_array_equal(tcli._read_points(str(tmp_path / name)),
                                      jcli._read_points(str(tmp_path / name)))
        np.testing.assert_allclose(tcli._read_points(str(tmp_path / name)), pts)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """tests/test_cli.py's problem (n = 150) as CSVs: src 3xN, dst Nx3."""
    d = tmp_path_factory.mktemp("cli")
    src, dst, s_gt, r_gt, t_gt = _make_problem(np.random.default_rng(12345))
    _write_cloud(d / "src.csv", src)
    _write_cloud(d / "dst.txt", dst.T, fmt="txt")
    return d, (s_gt, r_gt, t_gt)


def _argv(d, pipeline):
    return ["--src", str(d / "src.csv"), "--dst", str(d / "dst.txt"), "--noise-bound", "0.02",
            "--pipeline", pipeline]


@pytest.fixture(scope="module")
def jax_outputs(problem):
    """One in-process JAX CLI run per pipeline (the CPU)."""
    d, _ = problem
    out = {}
    for pipeline in ("decoupled", "psulvsb"):
        path = d / f"jax_{pipeline}.txt"
        assert jcli.main(_argv(d, pipeline) + ["--out", str(path)]) == 0
        out[pipeline] = path.read_text()
    return out


def _port_output(d, pipeline):
    path = d / f"port_{pipeline}.txt"
    assert tcli.main(_argv(d, pipeline) + ["--device", "cpu", "--out", str(path)]) == 0
    return path.read_text()


def _keys(text):
    return [ln.split()[0] for ln in text.strip().splitlines()]


def test_cli_decoupled_equals_jax(problem, jax_outputs):
    d, _ = problem
    text = _port_output(d, "decoupled")
    assert _keys(text) == _keys(jax_outputs["decoupled"]) == KEYS
    s, r, t, ms, valid = _parse_solution(text)
    js, jr, jt, _, jvalid = _parse_solution(jax_outputs["decoupled"])
    assert valid == jvalid == 1 and ms > 0
    assert abs(s - js) < SOLVE_TOL
    np.testing.assert_allclose(r, jr, atol=SOLVE_TOL)
    np.testing.assert_allclose(t, jt, atol=SOLVE_TOL)


def _recovers(text, truth):
    """tests/test_cli.py:86-93's gates."""
    s_gt, r_gt, t_gt = truth
    s, r, t, ms, valid = _parse_solution(text)
    cos = (np.trace(r_gt.T @ r) - 1) / 2
    return (valid == 1 and abs(s - s_gt) < 0.05 and ms > 0
            and np.degrees(np.arccos(np.clip(cos, -1, 1))) < 5
            and np.linalg.norm(t - t_gt) < 0.3)


def test_cli_psulvsb_recovers_in_both(problem, jax_outputs):
    d, truth = problem
    text = _port_output(d, "psulvsb")
    assert _keys(text) == _keys(jax_outputs["psulvsb"]) == KEYS
    assert _recovers(jax_outputs["psulvsb"], truth)
    assert _recovers(text, truth)


def test_cli_stdout(problem, capsys):
    d, truth = problem
    assert tcli.main(_argv(d, "decoupled") + ["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert _keys(text) == KEYS
    assert all(re.fullmatch(r"-?[0-9.e+-]+", v) for ln in text.splitlines()
               for v in ln.split()[1:])


def test_cli_without_card_exits_nonzero(problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device solves there")
    d, _ = problem
    with pytest.raises(SystemExit) as e:
        tcli.main(_argv(d, "psulvsb"))
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)


@pytest.mark.slow
def test_cli_subprocess(problem):
    """The process boundary MATLAB's system() crosses."""
    d, truth = problem
    proc = subprocess.run(
        [sys.executable, "-m", "psulvsb_tpu_torch.cli", *_argv(d, "psulvsb"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert _recovers(proc.stdout, truth)


# --- matlab/torch/teaser_solve.m ------------------------------------------


def _read(path):
    with open(os.path.join(REPO, path)) as f:
        return f.read()


def _struct_defaults(m_text):
    body = re.search(r"opts = struct\((.*?)\);", m_text, re.S).group(1)
    return re.findall(r"'(\w+)', ([^,\s]+)", body.replace("...", ""))


def test_matlab_bridge_mirrors_the_cli():
    m = _read("matlab/torch/teaser_solve.m")
    jax_m = _read("matlab/teaser_solve.m")
    # Same signature and name/value defaults as the JAX package's wrapper.
    signature = "function [s, R, t, time_taken] = teaser_solve(src, dst, varargin)"
    assert m.splitlines()[0] == jax_m.splitlines()[0] == signature
    assert _struct_defaults(m) == _struct_defaults(jax_m)
    # It calls the port's CLI, with flags the port's parser accepts ...
    call = re.search(r"cmd = sprintf\(\[(.*?)\], \.\.\.(.*?)\);", m, re.S)
    fmt, args = call.group(1), call.group(2)
    assert '-m psulvsb_tpu_torch.cli ' in fmt
    flags = re.findall(r"(--[a-z0-9-]+) ", fmt)
    parser = tcli.build_parser()
    known = {s for a in parser._actions for s in a.option_strings}
    assert set(flags) <= known
    # ... set from its defaults, which equal the parser's.
    fields = re.findall(r"opts\.(\w+)", args)
    value_flags = flags[3:]  # after --src, --dst, --out: the opts, in order
    assert len(fields) == len(value_flags) == 9
    defaults = dict(_struct_defaults(m))
    parsed = parser.parse_args(["--src", "s", "--dst", "d"])
    for field, flag in zip(fields, value_flags):
        value = {"true": 1.0, "false": 0.0}.get(defaults[field], None)
        value = float(defaults[field]) if value is None else value
        assert getattr(parsed, flag[2:].replace("-", "_")) == value, flag
    # It reads the seven lines in the order the CLI writes them.
    keys = re.search(r"keys = \{(.*?)\};", m).group(1)
    assert re.findall(r"'(\w+)'", keys) == KEYS


def test_matlab_bridge_files():
    assert "teaser_solve(src, dst" in _read("matlab/torch/teaser_solve_test.m")
    assert "addpath('matlab/torch')" in _read("matlab/torch/README.md")


# --- the API reference ----------------------------------------------------


def test_api_reference_is_current():
    spec = importlib.util.spec_from_file_location(
        "gen_api_docs_torch", os.path.join(REPO, "tools", "gen_api_docs_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert gen.render() == _read("docs/API_torch.md"), (
        "docs/API_torch.md is stale: run python tools/gen_api_docs_torch.py")
    assert all(mod.startswith("psulvsb_tpu_torch") for _, mod, _ in gen.SECTIONS)
