"""The front-end modules of the port (frontend/fpfh.py, iss.py, matcher.py,
icp.py, voxel.py, io/ply.py, core/geometry.py) against the JAX package's.

Inputs are numpy arrays made from a seed, at a few hundred to 1024 points.
Tolerances:
- voxel_downsample, PLY reads and writes, PointCloud: exact;
- pair_features: 1e-5 absolute on the same (points, normals);
- compute_fpfh given JAX's normals, on a generic cloud (random points and
  random normals, 40 of 600 inactive): every feature within 1e-2 (4e-3 at
  most was measured; the port expands distances in float64, JAX in
  float32, which moves the 1/d^2 weights); iss_keypoints there: equal;
- the same on a voxelized structured scene (extent 40, the front-end
  protocol's) padded to 1024: FPFH's swap rule (|n1.d| < |n2.d|) is a tie
  for neighbours on one plane or a curved surface, and the k = 64 cap and
  the radius test cut through dense neighbourhoods, so a rounding
  difference moves a neighbour's lane to another bin or out of the set and
  the pooling spreads it to the rows around it: at most 5% of the rows off
  by more than 1e-2 (1.2-2.4% measured), at most 2.5% of the points with
  another keypoint label (0.7-1.7% measured);
- FPFHEstimation estimates its own normals, which on a generic cloud are
  ill-conditioned (isotropic neighbourhoods): at most 35% of the rows off by
  more than 1e-2 against JAX's (17-25% measured), and exactly the port's
  estimate_normals + compute_fpfh;
- match_features: equal with the tuple test off (cross-check on and off),
  and equal with the tuple test on when JAX's own triads are fed in;
- icp_point_to_point: R and t within 1e-4, the same number of iterations.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psulvsb_tpu.core.geometry import PointCloud as JPointCloud
from psulvsb_tpu.frontend import fpfh as jfpfh
from psulvsb_tpu.frontend import icp as jicp
from psulvsb_tpu.frontend import iss as jiss
from psulvsb_tpu.frontend import matcher as jmatcher
from psulvsb_tpu.frontend.normals import estimate_normals as jax_normals
from psulvsb_tpu.frontend.voxel import voxel_downsample as jax_voxel
from psulvsb_tpu.io import ply as jply
from psulvsb_tpu_torch.core.geometry import PointCloud
from psulvsb_tpu_torch.eval.synthetic import structured_scene
from psulvsb_tpu_torch.frontend import fpfh, icp, iss, matcher
from psulvsb_tpu_torch.frontend.knn import knn
from psulvsb_tpu_torch.frontend.voxel import voxel_downsample
from psulvsb_tpu_torch.io import ply

FEATURE_TOL = 1e-2
STRUCTURED_ROWS_OFF = 0.05
STRUCTURED_KEYPOINTS_OFF = 0.025
FACADE_ROWS_OFF = 0.35
LEAF = 0.3  # the front-end protocol's voxel leaf and noise bound


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def padded_cloud():
    """A voxelized structured scene, 900 points strided into a 1024 bucket
    (the active mask marks them), with JAX's normals."""
    scene = structured_scene(6000, seed=1, extent=40.0)
    scene = scene + np.random.default_rng(1).normal(size=scene.shape) * 0.02
    down = voxel_downsample(scene.astype(np.float64), LEAF).astype(np.float32)
    m = 900
    pts = np.zeros((3, 1024), np.float32)
    pts[:, :m] = down[:, np.linspace(0, down.shape[1] - 1, m).astype(int)]
    active = np.arange(1024) < m
    normals = np.asarray(jax_normals(jnp.asarray(pts), k=20, active=jnp.asarray(active)))
    return pts, active, normals


def test_pair_features_match_jax():
    rng = np.random.default_rng(0)
    p1, p2 = rng.normal(size=(2, 200, 3))
    n1, n2 = rng.normal(size=(2, 200, 3))
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=1, keepdims=True)
    p2[:3] = p1[:3]  # zero distance: invalid lanes
    want = jfpfh.pair_features(*(jnp.asarray(x, jnp.float32) for x in (p1, n1, p2, n2)))
    got = fpfh.pair_features(*(torch.as_tensor(x, dtype=torch.float32) for x in (p1, n1, p2, n2)))
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert not got[4][:3].any()


def _generic_cloud(seed=0):
    """600 random points in a 4-wide cube with random unit normals, the last
    40 inactive: no plane, no tie in the swap rule, sparse neighbourhoods."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 4, size=(3, 600)).astype(np.float32)
    normals = rng.normal(size=(3, 600))
    normals = (normals / np.linalg.norm(normals, axis=0)).astype(np.float32)
    return pts, np.arange(600) < 560, normals


def _fpfh_pair(pts, active, normals, radius):
    want = np.asarray(jfpfh.compute_fpfh(jnp.asarray(pts), jnp.asarray(normals), radius, k=64,
                                         active=jnp.asarray(active)))
    got = fpfh.compute_fpfh(_t(pts), _t(normals), radius, k=64, active=_t(active)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert not got[~active].any()
    sums = got[active].reshape(-1, 3, 11).sum(2)  # 100 a block, or 0 with no neighbour
    assert np.all(np.isclose(sums, 100.0, rtol=1e-4) | (sums == 0.0))
    return np.abs(got - want).max(1)


def test_compute_fpfh_matches_jax_on_a_generic_cloud():
    off = _fpfh_pair(*_generic_cloud(), radius=0.6)
    assert off.max() <= FEATURE_TOL, off.max()


def test_compute_fpfh_on_a_structured_scene(padded_cloud):
    off = _fpfh_pair(*padded_cloud, radius=5 * LEAF) > FEATURE_TOL
    assert off.mean() <= STRUCTURED_ROWS_OFF, off.mean()


@pytest.mark.parametrize("cloud", ["generic", "structured"])
def test_iss_keypoints_match_jax(cloud, padded_cloud):
    pts, active, _ = _generic_cloud() if cloud == "generic" else padded_cloud
    radii = (0.9, 0.6) if cloud == "generic" else (6 * LEAF, 4 * LEAF)
    want = np.asarray(jiss.iss_keypoints(jnp.asarray(pts), *radii, k=64,
                                         active=jnp.asarray(active)))
    got = iss.iss_keypoints(_t(pts), *radii, k=64, active=_t(active)).numpy()
    assert got.dtype == bool and not got[~active].any()
    assert got.sum() > 50
    allowed = 0 if cloud == "generic" else STRUCTURED_KEYPOINTS_OFF * active.sum()
    assert (got != want).sum() <= allowed, (got != want).sum()


def test_fpfh_estimation_facade():
    from psulvsb_tpu_torch.frontend.normals import estimate_normals

    pts, _, _ = _generic_cloud(1)
    got = fpfh.FPFHEstimation().computeFPFHFeatures(pts, 0.6, 0.6, device="cpu")
    assert got.shape == (600, 33)
    normals = estimate_normals(_t(pts), k=20, radius=0.6, solve_dtype=torch.float64)
    assert torch.equal(got, fpfh.compute_fpfh(_t(pts), normals, 0.6, k=64))
    want = np.asarray(jfpfh.FPFHEstimation().computeFPFHFeatures(pts, 0.6, 0.6))
    off = np.abs(got.numpy() - want).max(1) > FEATURE_TOL
    assert off.mean() <= FACADE_ROWS_OFF, off.mean()


def test_voxel_downsample_equals_jax():
    rng = np.random.default_rng(3)
    cloud = rng.uniform(-5, 5, size=(3, 4000))
    for dtype in (np.float64, np.float32):
        got = voxel_downsample(cloud.astype(dtype), 0.7)
        want = jax_voxel(cloud.astype(dtype), 0.7)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, want)
    assert voxel_downsample(np.zeros((3, 0)), 0.5).shape == (3, 0)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trips_both_ways(tmp_path, binary):
    pts = np.random.default_rng(4).normal(size=(3, 57)).astype(np.float32)
    ours, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    ply.write_ply(ours, pts, binary=binary)
    jply.write_ply(theirs, pts, binary=binary)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (ours, theirs):
        np.testing.assert_array_equal(ply.read_ply(path), jply.read_ply(path))
        if binary:
            np.testing.assert_array_equal(ply.read_ply(path), pts)
        else:  # ASCII keeps 8 significant digits
            np.testing.assert_allclose(ply.read_ply(path), pts, rtol=1e-7, atol=0)
    np.testing.assert_array_equal(ply.read_ply(ours, dtype=np.float64),
                                  jply.read_ply(ours, dtype=np.float64))


def test_ply_double_extra_properties_and_faces(tmp_path):
    path = str(tmp_path / "mesh.ply")
    verts = np.array([(1.5, -2.0, 3.25, 7, 0.5), (0.0, 1.0, -1.0, 9, 0.25)],
                     dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8"), ("red", "u1"),
                            ("w", "<f4")])
    header = ("ply\nformat binary_little_endian 1.0\ncomment made by a test\n"
              "element vertex 2\nproperty double x\nproperty double y\nproperty double z\n"
              "property uchar red\nproperty float w\n"
              "element face 1\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(verts.tobytes())
        f.write(np.array([3], "u1").tobytes() + np.array([0, 1, 0], "<i4").tobytes())
    got = ply.read_ply(path, dtype=np.float64)
    np.testing.assert_array_equal(got, jply.read_ply(path, dtype=np.float64))
    np.testing.assert_array_equal(got, [[1.5, 0.0], [-2.0, 1.0], [3.25, -1.0]])
    bad = str(tmp_path / "bad.ply")
    with open(bad, "wb") as f:
        f.write(b"OFF\n3 1 0\n")
    with pytest.raises(ValueError, match="not a PLY"):
        ply.read_ply(bad)
    with pytest.raises(ValueError):
        ply.write_ply(str(tmp_path / "x.ply"), np.zeros((2, 4)))


def test_point_cloud_matches_jax():
    ours, theirs = PointCloud(), JPointCloud()
    for cloud in (ours, theirs):
        cloud.push_back({"x": 1.0, "y": 2.0, "z": 3.0})
        cloud.append((4.0, 5.0, 6.0))
        cloud.reserve(10)
    assert len(ours) == ours.size() == 2 and ours[1] == theirs[1]
    np.testing.assert_array_equal(ours.asarray(), theirs.asarray())
    arr = np.random.default_rng(5).normal(size=(3, 6))
    np.testing.assert_array_equal(PointCloud(arr).asarray(), JPointCloud(arr).asarray())
    ours.clear()
    assert ours.size() == 0 and ours.asarray().shape == (3, 0)


def test_knn_single_neighbour_takes_the_first_of_ties():
    """k = 1 returns the lowest index of tied minima, as XLA's top_k does."""
    pts = np.array([[0.0, 1.0, -1.0, 1.0]], np.float32)  # 1, 2 and 3 tie for the query 0.5
    q = np.full((1, 1), 0.5, np.float32)
    _, want = jax.lax.top_k(-jnp.asarray([0.25, 2.25, 0.25]), 1)
    idx, d2 = knn(_t(q), _t(pts[:, 1:]), k=1)
    assert int(idx[0, 0]) == int(want[0]) == 0 and float(d2[0, 0]) == 0.25
    idx, _ = knn(_t(q), _t(pts), k=1, point_active=_t([False, False, True, True]))
    assert int(idx[0, 0]) == 3


def _match_inputs(seed, n_src=420, n_dst=380):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-3, 3, size=(3, n_src))
    dst = rng.uniform(-3, 3, size=(3, n_dst))
    fs = rng.uniform(0, 100, size=(n_src, 33)).astype(np.float32)
    fd = rng.uniform(0, 100, size=(n_dst, 33)).astype(np.float32)
    fd[: n_dst // 2] = fs[: n_dst // 2] + rng.normal(size=(n_dst // 2, 33)).astype(np.float32)
    return src, dst, fs, fd


@pytest.mark.parametrize("crosscheck", [True, False])
@pytest.mark.parametrize("swapped", [False, True])
def test_match_features_equal_without_the_tuple_test(crosscheck, swapped):
    src, dst, fs, fd = _match_inputs(6)
    if swapped:  # the larger cloud is the target: the matcher swaps the roles
        src, dst, fs, fd = dst, src, fd, fs
    kw = dict(use_crosscheck=crosscheck, use_tuple_test=False)
    want = jmatcher.match_features(src, dst, fs, fd, **kw)
    got = matcher.match_features(src, dst, fs, fd, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] > 100


def _jax_triads(ncorr, seed, chunk):
    key = jax.random.PRNGKey(seed)
    out = []
    for start in range(0, ncorr * 100, chunk):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (min(chunk, ncorr * 100 - start), 3),
                                                 0, ncorr)))
    return out


def test_tuple_test_with_jax_triads_equals_jax():
    rng = np.random.default_rng(7)
    n = 300
    pts_i = rng.uniform(-1, 1, size=(3, n)).astype(np.float32)
    pts_j = pts_i.copy()
    pts_j[:, n // 2:] = rng.uniform(-1, 1, size=(3, n - n // 2))  # half are wrong
    corres = np.stack([np.arange(n), rng.permutation(n)], 1)
    corres[: n // 2, 1] = np.arange(n // 2)
    chunk = 7000  # several batches
    want = jmatcher._tuple_test(corres, pts_i, pts_j, 0.95, seed=3, chunk=chunk)
    got = matcher._tuple_test(corres, pts_i, pts_j, 0.95, _jax_triads(n, 3, chunk))
    np.testing.assert_array_equal(got, want)
    assert n // 4 < got.shape[0] < n


def test_match_features_with_the_tuple_test_keeps_a_subset():
    src, dst, fs, fd = _match_inputs(8)
    plain = matcher.match_features(src, dst, fs, fd, use_tuple_test=False, device="cpu")
    tested = matcher.match_features(src, dst, fs, fd, seed=1, device="cpu")
    again = matcher.Matcher().calculateCorrespondences(src, dst, fs, fd, seed=1, device="cpu")
    np.testing.assert_array_equal(tested, again)
    assert {tuple(r) for r in tested} <= {tuple(r) for r in plain}
    assert 0 < tested.shape[0] < plain.shape[0]
    triads = matcher.draw_triads(50, seed=2, device="cpu", chunk=1200)
    assert [t.shape for t in triads] == [(1200, 3)] * 4 + [(200, 3)]


def _icp_case():
    rng = np.random.default_rng(9)
    src = rng.uniform(-2, 2, size=(3, 600)).astype(np.float32)
    angle = 0.1
    r = np.array([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                  [0, 0, 1]], np.float32)
    t = np.array([0.05, -0.03, 0.02], np.float32)
    dst = (r @ src + t[:, None] + rng.normal(size=src.shape) * 0.003).astype(np.float32)
    return src, dst


@pytest.mark.parametrize("gate", [0.3, 1e-6])
def test_icp_matches_jax(gate):
    src, dst = _icp_case()
    active = np.arange(600) < 560
    want = jicp.icp_point_to_point(jnp.asarray(src), jnp.asarray(dst),
                                   max_correspondence_distance=gate, max_iterations=40,
                                   src_active=jnp.asarray(active))
    got = icp.icp_point_to_point(src, dst, max_correspondence_distance=gate, max_iterations=40,
                                 src_active=active, device="cpu")
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-4)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-4)
    if gate < 1e-3:  # nothing within range: diverged, inf RMSE, no update
        assert got.iterations == 1 and np.isinf(float(got.rmse))
        np.testing.assert_array_equal(got.rotation.numpy(), np.eye(3))
    else:
        assert float(got.rmse) == pytest.approx(float(want.rmse), abs=1e-5)
        assert float(got.rmse) < 0.01


@pytest.mark.parametrize("entry", ["fpfh", "match", "icp"])
def test_numpy_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    src, dst, fs, fd = _match_inputs(6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "fpfh":
            fpfh.FPFHEstimation().computeFPFHFeatures(src.astype(np.float32), 0.6, 1.5)
        elif entry == "match":
            matcher.match_features(src, dst, fs, fd)
        else:
            icp.icp_point_to_point(src, src)
    # Tensors run where they lie.
    res = icp.icp_point_to_point(_t(src).float(), _t(src).float(), max_iterations=2)
    assert res.rotation.device.type == "cpu"

