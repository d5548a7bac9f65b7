"""Launch presets: assemble node graphs matching the reference launch files.

Each ``launch_*`` mirrors one reference launch configuration (SURVEY.md §2
#26): it builds the nodes on a shared bus with that launch file's parameter
values and returns a :class:`Launch` handle. Drive it deterministically with
``step()`` (one feeder tick) or run threaded with ``spin(duration)``.

Twin of ``trajectory_optimization_tpu/bus/launch.py``. Every preset whose
nodes compute takes ``device`` (the card unless the caller asks for the
CPU) and hands it to each node it builds, in-process or through
:class:`bus.remote.NodeProcess`; the voxel filter is a host node. The JAX
twin's ``enable_compilation_cache`` serves XLA only and is not ported.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from trajectory_optimization_tpu_torch.bus.core import Bus
from trajectory_optimization_tpu_torch.bus.nodes import (
    CloudFeederNode,
    PoseFeederNode,
    PoseOptNode,
    TrajOptNode,
    VoxelFilterNode,
    PointsProcessorNode,
)
from trajectory_optimization_tpu_torch.utils.config import (
    CloudFeederConfig,
    PointsProcessorConfig,
    PoseFeederConfig,
    PoseOptNodeConfig,
    TrajOptNodeConfig,
    VoxelFilterConfig,
)


@dataclasses.dataclass
class Launch:
    bus: Bus
    nodes: Dict[str, object]
    feeders: List[object]
    # set when the graph runs cross-process (processes=True presets):
    broker: Optional[object] = None    # bus.remote.BusBroker
    bridge: Optional[object] = None    # parent-side bus.remote.BusBridge

    def step(self) -> None:
        """One deterministic cycle: tick every feeder (callbacks fire inline)."""
        for f in self.feeders:
            f.tick()

    def close(self) -> None:
        """Flush/close in-process nodes, then tear down cross-process
        transport and node processes (transport part is a no-op for
        in-process graphs)."""
        from trajectory_optimization_tpu_torch.bus.remote import NodeProcess

        for node in self.nodes.values():
            # e.g. TrajOptNode.close() publishes any pipelined in-flight
            # results — must run before the summary a caller prints
            if not isinstance(node, NodeProcess) and hasattr(node, "close"):
                node.close()
        if self.bridge is not None:
            self.bridge.close()
        if self.broker is not None:
            self.broker.close()
        for node in self.nodes.values():
            if isinstance(node, NodeProcess):
                node.terminate()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def spin(self, duration: float, rate: float = 1.0) -> None:
        """Threaded replay at ``rate`` Hz for ``duration`` seconds."""
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                self.step()
                time.sleep(1.0 / rate)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        time.sleep(duration)
        stop.set()
        t.join()


def _attach_process_graph(bus, broker, procs, n_clients: int):
    """Bridge the parent bus to a broker and wait for worker readiness;
    on ANY failure tear everything down (broker threads, UDS file, bridge
    socket, spawned processes) before re-raising — otherwise a worker that
    crashes on import leaks all of them with no handle to close them by."""
    from trajectory_optimization_tpu_torch.bus.remote import BusBridge

    bridge = None
    try:
        bridge = BusBridge(bus, broker.address, name="launch-parent")
        # 120 s budget: before its HELLO each worker imports torch and this
        # package, opens a CUDA context and loads the kernel library,
        # seconds normally but more on an oversubscribed host. Wait in short slices and check
        # worker liveness so a crashed worker (bad import, missing
        # __main__ guard in the caller's script) fails promptly instead of
        # burning the whole budget.
        deadline = time.monotonic() + 120.0
        while not broker.wait_for_clients(n_clients, timeout=2.0):
            dead = [p.name for p in procs if not p.alive()]
            if dead:
                raise RuntimeError(
                    f"node process(es) died before attaching: {dead} "
                    "(spawn scripts need an `if __name__ == '__main__'` "
                    "guard; set TRAJOPT_NODE_DEBUG=<path> for a worker log)")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "node processes did not attach to the broker")
        return bridge
    except BaseException:
        if bridge is not None:
            bridge.close()
        for p in procs:
            p.terminate()
        broker.close()
        raise


def default_trajopt_config() -> TrajOptNodeConfig:
    """The `trajectory_optimization.launch` parameter set (subt-sim topics,
    `launch/trajectory_optimization.launch:44-49`) — the single source for
    both the preset and the CLI."""
    return TrajOptNodeConfig(
        pc_topic="/X1/local_map",
        path_topic="/X1/path",
        opt_steps=30,
        smooth_weight=28.0,
        lr_pose=0.12,
        lr_quat=0.05,
        publish_rewards_cloud=True,
    )


def default_poseopt_config() -> PoseOptNodeConfig:
    """The `pose_optimization.launch` optimizer parameters
    (`launch/pose_optimization.launch:55-59`)."""
    return PoseOptNodeConfig(pc_topic="/pts", pose_topic="/pose",
                             opt_steps=200, lr_pose=0.02, lr_quat=0.02)


def launch_trajectory_optimization(
    *,
    data_dir: str = "data/points",
    overrides: Optional[TrajOptNodeConfig] = None,
    processes: bool = False,
    viewer: bool = False,
    viewer_port: Optional[int] = 8123,
    device: str = "cuda",
) -> Launch:
    """`launch/trajectory_optimization.launch`: trajectory optimizer wired to
    cloud + path topics (subt-sim values: opt_steps 30, smooth_weight 28,
    lr 0.12/0.05, `launch/trajectory_optimization.launch:44-49`).

    ``processes=True`` runs the optimizer as its own OS process bridged over
    a unix socket (the reference's node-per-process runtime shape); the
    returned handle's ``bus`` stays in the caller's process — publish inputs
    and subscribe outputs there as usual, and ``close()`` when done.

    ``viewer=True`` adds the live HTTP scene viewer (bus.viewer.ViewerNode,
    the reference's rviz-in-the-launch-file role) subscribed to the same
    topics; the URL is printed and available as
    ``launch.nodes['viewer'].url``."""
    bus = Bus()
    cfg = overrides or default_trajopt_config()
    nodes = {}
    if viewer:
        from trajectory_optimization_tpu_torch.bus.viewer import ViewerNode
        from trajectory_optimization_tpu_torch.utils.config import ViewerConfig

        nodes["viewer"] = ViewerNode(bus, ViewerConfig(
            pc_topic=cfg.pc_topic, path_topic=cfg.path_topic,
            port=viewer_port, title="trajectory optimization"))
        if nodes["viewer"].url:
            print(f"[launch] viewer at {nodes['viewer'].url}")
    if processes:
        from trajectory_optimization_tpu_torch.bus.remote import BusBroker, NodeProcess

        broker = BusBroker().start()
        node = NodeProcess("TrajOptNode", cfg, broker.address, device=device)
        bridge = _attach_process_graph(bus, broker, [node], 2)
        return Launch(bus, {"traj_opt": node, **nodes}, [], broker=broker,
                      bridge=bridge)
    node = TrajOptNode(bus, cfg, device=device)
    return Launch(bus, {"traj_opt": node, **nodes}, [])


def launch_pose_optimization(
    *, data_dir: str = "data/points", processes: bool = False,
    overrides: Optional[PoseOptNodeConfig] = None,
    viewer: bool = False, viewer_port: Optional[int] = 8123,
    device: str = "cuda",
) -> Launch:
    """`launch/pose_optimization.launch`: cloud feeder + pose feeder + voxel
    filter + pose optimizer (opt_steps 200, lr 0.02/0.02,
    `launch/pose_optimization.launch:55-59`).

    ``processes=True`` reproduces the reference runtime shape — the voxel
    filter and the optimizer each run as their own OS process
    (launch/pose_optimization.launch:13-60 starts one process per
    ``<node>``), bridged through a :class:`bus.remote.BusBroker`. Feeders
    stay in the caller's process so ``Launch.step()`` still drives the whole
    graph deterministically; optimized outputs arrive on the caller's bus.
    Call ``close()`` (or use the handle as a context manager) to tear down.
    """
    bus = Bus()
    opt_cfg = overrides or default_poseopt_config()
    extra_nodes = {}
    if viewer:
        from trajectory_optimization_tpu_torch.bus.viewer import ViewerNode
        from trajectory_optimization_tpu_torch.utils.config import ViewerConfig

        extra_nodes["viewer"] = ViewerNode(bus, ViewerConfig(
            pc_topic=opt_cfg.pc_topic, path_topic="/path",
            port=viewer_port, title="pose optimization"))
        if extra_nodes["viewer"].url:
            print(f"[launch] viewer at {extra_nodes['viewer'].url}")
    # feeders/filter follow the optimizer's topic overrides so a CLI
    # `pc_topic=...` rewires the whole chain, not just the subscription
    feeder_c = CloudFeederNode(bus, CloudFeederConfig(
        output_topic="/pts_raw", data_dir=data_dir))
    feeder_p = PoseFeederNode(bus, PoseFeederConfig(
        output_topic=opt_cfg.pose_topic))
    filt_cfg = VoxelFilterConfig(
        input_topic="/pts_raw", output_topic=opt_cfg.pc_topic,
        leaf_size=0.15)
    if processes:
        from trajectory_optimization_tpu_torch.bus.remote import BusBroker, NodeProcess

        broker = BusBroker().start()
        filt = NodeProcess("VoxelFilterNode", filt_cfg, broker.address)
        node = NodeProcess("PoseOptNode", opt_cfg, broker.address, device=device)
        bridge = _attach_process_graph(bus, broker, [filt, node], 3)
        return Launch(bus, {"pose_opt": node, "voxel_filter": filt,
                            **extra_nodes},
                      [feeder_c, feeder_p], broker=broker, bridge=bridge)
    filt = VoxelFilterNode(bus, filt_cfg)
    node = PoseOptNode(bus, opt_cfg, device=device)
    return Launch(
        bus,
        {"pose_opt": node, "voxel_filter": filt, **extra_nodes},
        [feeder_c, feeder_p],
    )


def launch_pointcloud_processor(
    cam_info_topics=("/viz/camera_0/camera_info",),
    *,
    processes: bool = False,
    overrides: Optional[PointsProcessorConfig] = None,
    device: str = "cuda",
) -> Launch:
    """`launch/pointcloud_processor.launch`: multi-camera visibility
    processor (frustum cull → HPR → render per camera).
    ``processes=True`` runs the processor as its own OS process (see
    :func:`launch_pose_optimization`)."""
    bus = Bus()
    cfg = overrides or PointsProcessorConfig(
        cam_info_topics=tuple(cam_info_topics))
    if processes:
        from trajectory_optimization_tpu_torch.bus.remote import BusBroker, NodeProcess

        broker = BusBroker().start()
        node = NodeProcess("PointsProcessorNode", cfg, broker.address, device=device)
        bridge = _attach_process_graph(bus, broker, [node], 2)
        return Launch(bus, {"pc_processor": node}, [], broker=broker,
                      bridge=bridge)
    node = PointsProcessorNode(bus, cfg, device=device)
    return Launch(bus, {"pc_processor": node}, [])


def launch_voxels_filtering(
    *,
    input_topic: str = "/local_map",
    output_topic: str = "/local_map/voxels",
    leaf_size: float = 0.15,
    z_limits=None,
) -> Launch:
    """`launch/voxels_filtering.launch`: the PCL VoxelGrid stage as a bus
    node (leaf 0.1–0.2 m with optional z pass-through, matching the nodelet
    parameters)."""
    bus = Bus()
    node = VoxelFilterNode(
        bus,
        VoxelFilterConfig(
            input_topic=input_topic, output_topic=output_topic,
            leaf_size=leaf_size, z_limits=z_limits,
        ),
    )
    return Launch(bus, {"voxel_filter": node}, [])


def launch_play_bag(bag_dir: str, nodes_launch: Launch, *, realtime: bool = False,
                    rate: float = 1.0, loop: int = 1, start: float = 0.0,
                    duration=None) -> int:
    """`launch/play_bag.launch`: replay a recording into an existing node
    graph's bus (the 'multi-node without a robot' workflow). Accepts either
    an npz recording directory (bus.replay) or a real ROS1 ``.bag`` file
    (bus.rosbag). ``loop``/``start``/``duration`` mirror
    ``rosbag play -l/-s/-u`` (the reference replays its session with
    ``rosbag play --clock -r 5 -k``, launch/play_bag.launch:11-12; sim-time
    /clock is unnecessary here — nodes consume message stamps directly)."""
    from trajectory_optimization_tpu_torch.bus.rosbag import open_player

    # streaming: session bags are GB-scale; record order = chunk time order
    return open_player(bag_dir, streaming=True).play(
        nodes_launch.bus, realtime=realtime, rate=rate,
        loop=loop, start=start, duration=duration,
    )
