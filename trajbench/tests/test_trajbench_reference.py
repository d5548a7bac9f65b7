"""The plain reference agrees with the port's CPU route at a tiny size, and
imports nothing of the program."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import inputs
import registry
from conftest import BENCH_DIR, ROOT, TINY_CONFIG


def _tiny():
    reg = registry.Registry()
    cfg = dict(reg.config("cloud10"), **TINY_CONFIG)
    ref = reg.reference(cfg["reference"])
    pts = inputs.cloud(cfg["cloud"], 11, reg.root)
    path = inputs.moved_paths(inputs.path(cfg["path"], reg.root), reg.traffic("node30")["moves"],
                              11)[0]
    return cfg, ref, ref.Settings.from_config(cfg), pts, path


def _port(cfg):
    from trajectory_optimization_tpu_torch.api import TrajectoryOptimizer

    s = cfg["settings"]
    return TrajectoryOptimizer(smoothness_weight=s["smoothness_weight"], lr_pose=s["lr_pose"],
                               lr_quat=s["lr_quat"], device="cpu")


def test_forward_matches_port(one_thread):
    from trajectory_optimization_tpu_torch.models.traj import TrajProblem, traj_forward
    from trajectory_optimization_tpu_torch.utils.data import pad_points

    cfg, ref, st, pts, path = _tiny()
    rng = np.random.default_rng(0)
    poses = (path + rng.normal(0, 0.3, path.shape)).astype(np.float32)
    quats = np.tile([1.0, 0.0, 0.0, 0.0], (len(path), 1)) + rng.normal(0, 0.1, (len(path), 4))
    quats = quats.astype(np.float32)
    ev = ref.evaluate(pts, path, poses, quats, st)
    padded, valid = pad_points(pts)
    s = cfg["settings"]
    prob = TrajProblem(img_width=st.width, img_height=st.height,
                       smoothness_weight=s["smoothness_weight"], length_weight=s["length_weight"],
                       wps_step=ref.stride(path, st.vis_wps_dist), backend="torch")
    K = torch.tensor([[st.fx, 0, st.cx], [0, st.fy, st.cy], [0, 0, 1]], dtype=torch.float32)
    loss, aux = traj_forward({"poses": torch.as_tensor(poses), "quats": torch.as_tensor(quats)},
                             torch.as_tensor(padded), K, torch.as_tensor(path),
                             torch.as_tensor(quats), prob, valid=torch.as_tensor(valid))
    np.testing.assert_allclose(aux["rewards"].numpy()[: len(pts)], ev["rewards"], atol=1e-5)
    assert abs(float(loss) - ev["loss"]) <= 1e-5 * ev["loss"]


def test_solve_and_follow_match_port(one_thread):
    cfg, ref, st, pts, path = _tiny()
    opt = _port(cfg)
    res = opt.optimize(pts, path, n_steps=5)
    ev = ref.evaluate(pts, path, res.poses, res.quats_wxyz, st)
    assert np.abs(res.rewards - ev["rewards"]).max() < 1e-5
    assert abs(res.visibility_gain / ev["visibility_gain"] - 1) < 1e-5
    start = (res.poses.astype(np.float32), res.quats_wxyz.astype(np.float32))
    out = opt.optimize(pts, path, n_steps=3, warm_start={"poses": start[0], "quats": start[1]})
    follow = ref.solve(pts, path, 3, st, start=start)
    assert np.abs(out.poses - follow.poses).max() < 1e-4
    assert np.abs(follow.poses - start[0]).max() > 0.1  # three steps move the path
    # five steps from the path: the reference in float64 stays near the port
    sol = ref.solve(pts, path, 5, st)
    assert np.abs(sol.poses - res.poses).max() < 1e-2


@pytest.mark.parametrize("mod", ["reference/traj.py", "control.py"])
def test_reference_imports_nothing_of_the_program(mod):
    code = (f"import runpy, sys; sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]; "
            f"runpy.run_path({str(BENCH_DIR / mod)!r}, run_name='not_main'); "
            "import registry; reg = registry.Registry(); cfg = reg.config('cloud10'); "
            "reg.driver(cfg['driver']).Cell(cfg, reg.traffic('node30'), 1, 'cpu', reg, "
            "system=False); "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'trajectory_optimization_tpu', 'trajectory_optimization_tpu_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
