"""The inputs come from the seed alone, and the path moves keep the waypoint
stride and every shape."""
import numpy as np
import pytest

import inputs
import registry
from conftest import TINY_CONFIG

SEEDS = [0, 1, 2 ** 31 + 5, 4_294_967_311, -7]


@pytest.mark.parametrize("seed", SEEDS)
def test_moves_are_seeded_and_rigid(seed):
    reg = registry.Registry()
    traffic = reg.traffic("node30")
    for generated in (False, True):
        cfg = dict(reg.config("cloud10"), **(TINY_CONFIG if generated else {}))
        ref = reg.reference(cfg["reference"])
        base = inputs.path(cfg["path"], reg.root)
        a = inputs.moved_paths(base, traffic["moves"], seed)
        b = inputs.moved_paths(base, traffic["moves"], seed)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (traffic["moves"]["pool"],) + base.shape and a.dtype == np.float32
        seg = lambda p: np.linalg.norm(np.diff(p.astype(np.float64), axis=-2), axis=-1)  # noqa: E731
        np.testing.assert_allclose(seg(a), np.broadcast_to(seg(base), seg(a).shape), atol=1e-4)
        stride = ref.stride(base, 0.5)
        assert all(ref.stride(p, 0.5) == stride for p in a)
        np.testing.assert_allclose(a[..., 2], np.broadcast_to(base[:, 2], a[..., 2].shape),
                                   atol=1e-5)
        shift = np.abs(a.mean(axis=1) - base.astype(np.float64).mean(axis=0))
        assert shift[:, :2].max() <= traffic["moves"]["max_offset_xy_m"] + 1e-4


def test_seeds_differ_and_clouds_repeat():
    reg = registry.Registry()
    cfg, traffic = dict(reg.config("cloud10"), **TINY_CONFIG), reg.traffic("node30")
    base = inputs.path(cfg["path"], reg.root)
    assert not np.array_equal(inputs.moved_paths(base, traffic["moves"], 1),
                              inputs.moved_paths(base, traffic["moves"], 2))
    small = dict(cfg["cloud"], n=1000)
    np.testing.assert_array_equal(inputs.cloud(small, 2 ** 33, reg.root),
                                  inputs.cloud(small, 2 ** 33, reg.root))
    c = inputs.cloud(small, 3, reg.root)
    assert c.shape == (1000, 3) and np.abs(c).max() <= small["half_extent_m"]
    cloud10 = inputs.cloud(reg.config("cloud10")["cloud"], 3, reg.root)
    assert cloud10.shape == (40452, 3)
    order = inputs.sample_order(9, 100)
    assert sorted(order) == list(range(100))
    np.testing.assert_array_equal(order, inputs.sample_order(9, 100))
