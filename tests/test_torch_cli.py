"""The port's shell entry point against the JAX package's:
``python -m trajectory_optimization_tpu_torch`` (``__main__.main``) with
``--device cpu`` beside ``trajectory_optimization_tpu.__main__.main``.

Held: ``info`` and ``filter`` print the same text and return the same
codes, rc 1 on a missing file included; ``eval`` prints the same observed
counts and mean rewards within 1e-4, without and with ``--optimize 3``;
the ``pose_optimization``, ``trajectory_optimization --play ... --record
...`` (pipeline depth 3 with one pair: the in-flight result is still
counted), ``voxels_filtering`` and ``play_bag`` presets print the same
``<topic>: N msgs`` summary lines, and the recordings read back to the
same topics; ``play_bag`` without ``--play`` exits; a subprocess ``python
-m trajectory_optimization_tpu_torch info`` on a golden bag prints what the
JAX ``main`` prints; the CLI's device defaults to ``cuda``; the viewer
(``bus.ViewerNode``, the presets' ``viewer=True``) serves the JAX viewer's
state and the same PNG.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from trajectory_optimization_tpu.__main__ import main as jmain  # noqa: E402
from trajectory_optimization_tpu.bus import messages as jmsgs  # noqa: E402
from trajectory_optimization_tpu.bus import rosbag as jbag  # noqa: E402
from trajectory_optimization_tpu_torch.__main__ import main as tmain  # noqa: E402
from trajectory_optimization_tpu_torch.bus import rosbag as tbag  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "rosbag_golden" / "golden_indexed.bag"
CPU = ["--device", "cpu"]


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _summary(out):
    """The ``<topic>: N msgs`` lines of a preset's run."""
    return sorted(line for line in out.splitlines() if re.fullmatch(r"\S+: \d+ msgs", line))


def _session(tmp_path, cloud10, path10):
    q = np.zeros((len(path10), 4))
    q[:, 3] = 1.0
    hdr = jmsgs.Header(stamp=1.0, frame_id="map")
    bag = str(tmp_path / "cli.bag")
    jbag.write_bag(bag, [("/pc", jmsgs.CloudMsg(hdr, cloud10[::16])),
                         ("/path", jmsgs.PathMsg(hdr, path10, q))])
    return bag


def test_info_and_filter_print_what_the_jax_cli_prints(tmp_path, capsys, cloud10, path10):
    bag = _session(tmp_path, cloud10, path10)
    for argv in (["info", bag], ["info", str(GOLDEN)], ["info", str(tmp_path / "missing.bag")]):
        t, j = _run(tmain, argv, capsys), _run(jmain, argv, capsys)
        assert t == j and t[0] == (1 if "missing" in argv[1] else 0), (t, j)
    for dst_name, extra in (("a", ["--topics", "/pc"]), ("b", ["--compression", "lz4"]),
                            ("c", ["--start", "0.5", "--end", "2"])):
        t_dst, j_dst = str(tmp_path / f"t{dst_name}.bag"), str(tmp_path / f"j{dst_name}.bag")
        t = _run(tmain, ["filter", bag, t_dst, *extra], capsys)
        j = _run(jmain, ["filter", bag, j_dst, *extra], capsys)
        assert (t[0], t[1].replace(t_dst, "DST")) == (j[0], j[1].replace(j_dst, "DST"))
        assert Path(t_dst).read_bytes() == Path(j_dst).read_bytes()
    argv = ["filter", str(tmp_path / "nope.bag"), str(tmp_path / "x.bag")]
    t, j = _run(tmain, argv, capsys), _run(jmain, argv, capsys)
    assert t == j and t[0] == 1 and t[2].startswith("filter:")


def _census(out):
    """(tag, observed, mean reward) of each ``eval`` report line."""
    rows = re.findall(r"^(\w+)\s*: observed (\d+)/\d+ .*?mean reward ([0-9.]+)", out, re.M)
    return [(tag, int(n), float(r)) for tag, n, r in rows]


@pytest.mark.parametrize("optimize", [0, 3])
def test_eval_prints_the_jax_census(tmp_path, capsys, cloud10, path10, optimize):
    np.savez(tmp_path / "cloud.npz", pts=cloud10[::16])
    np.savez(tmp_path / "path.npz", poses=path10)
    argv = ["eval", str(tmp_path / "cloud.npz"), str(tmp_path / "path.npz"),
            "--optimize", str(optimize)]
    t, j = _run(tmain, argv + CPU, capsys), _run(jmain, argv, capsys)
    assert t[0] == j[0] == 0
    tc, jc = _census(t[1]), _census(j[1])
    assert len(tc) == len(jc) == (2 if optimize else 1), (t[1], j[1])
    for (ttag, tn, tr), (jtag, jn, jr) in zip(tc, jc):
        assert ttag == jtag and tn == jn
        assert abs(tr - jr) <= 1e-4, (tr, jr)
    missing = ["eval", str(tmp_path / "missing.npz"), str(tmp_path / "path.npz")]
    assert _run(tmain, missing + CPU, capsys)[0] == _run(jmain, missing, capsys)[0] == 1


def test_presets_print_the_jax_summaries(tmp_path, capsys, cloud10, path10):
    np.savez(tmp_path / "point_cloud_10.npz", pts=cloud10[::16])
    bag = _session(tmp_path, cloud10, path10)
    runs = [
        ["pose_optimization", "opt_steps=6", "num_pub_samples=2", "--steps", "1",
         "--data-dir", str(tmp_path)],
        ["trajectory_optimization", "pc_topic=/pc", "path_topic=/path", "opt_steps=4",
         "pipeline_depth=3", "--play", bag, "--record", "{rec}", "--echo", "/path/optimized"],
        ["voxels_filtering", "input_topic=/pc", "output_topic=/vox", "leaf_size=0.3",
         "--play", bag],
        ["play_bag", "--play", bag, "--echo", "/pc", "/path"],
    ]
    for argv in runs:
        recs = [str(tmp_path / f"{k}_rec.bag") for k in ("t", "j")]
        t = _run(tmain, [a.format(rec=recs[0]) for a in argv] + CPU, capsys)
        j = _run(jmain, [a.format(rec=recs[1]) for a in argv], capsys)
        assert t[0] == j[0] == 0, (argv, t, j)
        assert _summary(t[1]) == _summary(j[1]) and _summary(t[1]), (argv, t[1], j[1])
        if "--record" in argv:
            assert "/path/optimized: 1 msgs" in t[1]
            assert ({topic for _, topic, _ in tbag.read_bag(recs[0])}
                    == {topic for _, topic, _ in jbag.read_bag(recs[1])}
                    >= {"/pc", "/path", "/path/optimized"})
    with pytest.raises(SystemExit):
        tmain(["play_bag"])  # requires --play


def test_module_entry_point_in_a_subprocess(capsys):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "trajectory_optimization_tpu_torch", "info",
                           str(GOLDEN)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _run(jmain, ["info", str(GOLDEN)], capsys)[1]


def test_the_device_defaults_to_the_card():
    import inspect

    from trajectory_optimization_tpu_torch.bus import launch, remote

    for fn in (launch.launch_trajectory_optimization, launch.launch_pose_optimization,
               launch.launch_pointcloud_processor, remote.NodeProcess):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    src = (ROOT / "trajectory_optimization_tpu_torch" / "__main__.py").read_text()
    assert src.count('"--device", default="cuda"') == 2


def test_viewer_serves_the_jax_viewers_scene():
    import json
    import urllib.request

    from trajectory_optimization_tpu.bus.core import Bus as JBus
    from trajectory_optimization_tpu.bus.viewer import ViewerNode as JViewer
    from trajectory_optimization_tpu.utils.config import ViewerConfig as JViewerConfig
    from trajectory_optimization_tpu_torch.bus import Bus, ViewerNode, messages as tmsgs
    from trajectory_optimization_tpu_torch.bus import launch
    from trajectory_optimization_tpu_torch.utils.config import ViewerConfig

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    rewards = np.concatenate([pts, rng.uniform(size=(300, 1)).astype(np.float32)], axis=1)
    path = np.stack([np.linspace(0, 3, 5), np.zeros(5), np.zeros(5)], 1)
    quat = np.tile([0.0, 0.0, 0.0, 1.0], (5, 1))
    nodes = []
    for M, bus, node_cls, cfg_cls in ((tmsgs, Bus(), ViewerNode, ViewerConfig),
                                      (jmsgs, JBus(), JViewer, JViewerConfig)):
        node = node_cls(bus, cfg_cls(pc_topic="/pts", path_topic="/path", port=0))
        h = M.Header(stamp=1.0, frame_id="world", seq=1)
        bus.publish("/pts", M.CloudMsg(h, pts))
        bus.publish("/pts/rewards", M.CloudMsg(h, rewards))
        bus.publish("/path", M.PathMsg(h, path, quat))
        nodes.append(node)
    try:
        states = []
        for node in nodes:
            with urllib.request.urlopen(node.url + "state.json", timeout=10) as r:
                states.append(json.loads(r.read()))
        assert states[0] == states[1] == {"seq": 3, "counts": {"cloud": 1, "rewards": 1,
                                                               "path": 1}}
        png = nodes[0].render_png(20.0, 30.0)
        assert png.startswith(b"\x89PNG") and png == nodes[1].render_png(20.0, 30.0)
    finally:
        for node in nodes:
            node.close()
    h = launch.launch_trajectory_optimization(viewer=True, viewer_port=0, device="cpu")
    try:
        assert h.nodes["viewer"].url.startswith("http://127.0.0.1:")
    finally:
        h.close()  # closes the viewer's server too
