"""The benchmark's copy of the pair generator makes the pairs the port's
own generator makes for the same seed."""

import numpy as np
import pytest

from cardbench.reference import generator
from psulvsb_tpu_torch.eval import synthetic


@pytest.mark.parametrize("mode", ["mismatch", "displace"])
@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_copied_generator_equals_the_ports(mode, seed):
    cloud = synthetic.synthetic_cloud(1500, seed=seed % 1000) * np.float32(20.0)
    assert np.array_equal(cloud, generator.synthetic_cloud(1500, seed=seed % 1000)
                          * np.float32(20.0))
    ours = generator.make_synthetic_pair(np.random.default_rng(seed), cloud, 0.1, 0.9, 10.0,
                                         mode)
    port = synthetic.make_synthetic_pair(np.random.default_rng(seed), cloud, 0.1, 0.9, 10.0,
                                         outlier_mode=mode)
    assert np.array_equal(ours.outlier_mask, port.outlier_mask)
    np.testing.assert_allclose(ours.rotation, port.transform.rotation, rtol=0, atol=1e-7)
    np.testing.assert_allclose(ours.translation, port.transform.translation, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.dst, port.dst, rtol=0, atol=1e-5)
    assert ours.dst.dtype == port.dst.dtype == np.float32


def test_a_pool_is_the_same_for_a_seed_and_keeps_its_sizes_and_rates():
    cfg = {"outlier_rates": [0.6, 0.9], "scene_scale": 1.0, "noise_bound": 0.01,
           "max_translation": 2.0, "outlier_mode": "mismatch"}
    a = generator.make_pool(cfg, 2**33 + 1, [300, 500], 4)
    b = generator.make_pool(cfg, 2**33 + 1, [300, 500], 4)
    c = generator.make_pool(cfg, -5, [300, 500], 4)
    for n in (300, 500):
        for pa, pb, pc in zip(a[n], b[n], c[n]):
            assert np.array_equal(pa.dst, pb.dst)
            assert pa.src.shape == pc.src.shape == (3, n)
        assert [int(p.outlier_mask.sum()) for p in a[n]] == [
            int(p.outlier_mask.sum()) for p in c[n]]


def test_a_vehicle_pose_is_a_short_yawing_step_the_same_for_every_seed():
    """A configuration's `pose` of kind "vehicle": yaws on fixed strata of
    [-yaw_deg, yaw_deg], roll and pitch within tilt_deg, steps in step_m."""
    spec = {"kind": "vehicle", "yaw_deg": 10.0, "tilt_deg": 1.0, "step_m": [10.0, 11.0],
            "climb_m": 0.3}
    cfg = {"outlier_rates": [0.6, 0.9], "scene_scale": 20.0, "noise_bound": 0.1,
           "outlier_mode": "mismatch", "pose": spec}

    def yaws(seed):
        pool = generator.make_pool(cfg, seed, [300], 6)[300]
        out = []
        for p in pool:
            r = p.rotation.astype(np.float64)
            angle = np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
            assert angle <= np.hypot(10.0, np.hypot(1.0, 1.0)) + 1e-3
            assert 10.0 - 1e-4 <= np.linalg.norm(p.translation[:2]) <= np.hypot(11.0, 0.3)
            assert abs(p.translation[2]) <= 0.3 + 1e-6
            out.append(round(float(np.degrees(np.arctan2(r[1, 0], r[0, 0]))), 0))
        return sorted(out)

    assert yaws(5) == yaws(2**35 + 9)
    assert max(map(abs, yaws(5))) > 5.0
    with pytest.raises(ValueError):
        generator.make_pool({**cfg, "pose": {**spec, "kind": "orbit"}}, 1, [300], 2)
