"""Record / replay: the rosbag equivalent for the scene bus.

Copy of ``trajectory_optimization_tpu/bus/replay.py``; a tensor payload
is copied to the host where it is recorded (``messages.host_image``).

The reference exercises its multi-camera pipeline by replaying a recorded
15 GB rosbag (`launch/play_bag.launch`, SURVEY.md §4.4). Here a recording is
a directory of npz files (one per message, self-describing) plus an index;
replay re-publishes them in stamp order, optionally respecting original
inter-message timing. Works with every bus message type.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from trajectory_optimization_tpu_torch.bus.core import Bus
from trajectory_optimization_tpu_torch.bus.messages import (
    CameraInfoMsg,
    CloudMsg,
    Header,
    ImageMsg,
    OdometryMsg,
    PathMsg,
    PoseMsg,
    TransformMsg,
    host_image,
)

_TYPES = {
    "CloudMsg": CloudMsg,
    "PoseMsg": PoseMsg,
    "PathMsg": PathMsg,
    "CameraInfoMsg": CameraInfoMsg,
    "OdometryMsg": OdometryMsg,
    "ImageMsg": ImageMsg,
    "TransformMsg": TransformMsg,
}


def _encode(msg) -> Dict:
    arrays, scalars = {}, {}
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if f.name == "header":
            scalars["header"] = {"stamp": v.stamp, "frame_id": v.frame_id, "seq": v.seq}
        elif isinstance(v, np.ndarray) or hasattr(v, "__array__"):
            # __array__ covers tensor payloads, e.g. the renderer's
            # ImageMsg.data on the card — recording forces the host copy,
            # by design (host_image: .cpu(), then numpy)
            arrays[f.name] = host_image(v)
        else:
            scalars[f.name] = list(v) if isinstance(v, tuple) else v
    return {"type": type(msg).__name__, "scalars": scalars, "arrays": arrays}


def _decode(meta: Dict, arrays: Dict) -> object:
    cls = _TYPES[meta["type"]]
    kwargs = dict(meta["scalars"])
    h = kwargs.pop("header")
    kwargs["header"] = Header(stamp=h["stamp"], frame_id=h["frame_id"], seq=h["seq"])
    for k in [f.name for f in dataclasses.fields(cls)]:
        if k in arrays:
            kwargs[k] = arrays[k]
        elif k in kwargs and isinstance(kwargs[k], list):
            kwargs[k] = tuple(kwargs[k])
    return cls(**kwargs)


class Recorder:
    """Record selected topics to a bag directory."""

    def __init__(self, bus: Bus, topics: Sequence[str], out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._index: List[Dict] = []
        self._n = 0
        self._subs = [
            bus.subscribe(t, self._make_cb(t), latch=False) for t in topics
        ]

    def _make_cb(self, topic):
        def cb(msg):
            enc = _encode(msg)
            fname = f"msg_{self._n:08d}.npz"
            np.savez(os.path.join(self.out_dir, fname), **enc["arrays"])
            self._index.append(
                {
                    "file": fname,
                    "topic": topic,
                    "stamp": msg.header.stamp,
                    "type": enc["type"],
                    "scalars": enc["scalars"],
                }
            )
            self._n += 1

        return cb

    def close(self) -> str:
        for s in self._subs:
            s.unsubscribe()
        index_path = os.path.join(self.out_dir, "index.json")
        with open(index_path, "w") as f:
            json.dump({"messages": self._index}, f)
        return index_path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Player:
    """Replay a bag directory onto a bus in stamp order."""

    def __init__(self, bag_dir: str):
        self.bag_dir = bag_dir
        with open(os.path.join(bag_dir, "index.json")) as f:
            self.index = sorted(json.load(f)["messages"], key=lambda m: m["stamp"])

    def __len__(self):
        return len(self.index)

    def messages(self, *, start: float = 0.0, duration=None):
        """Yield (topic, message) in stamp order, optionally windowed to
        bag-time offsets [start, start+duration] (rosbag play -s/-u
        semantics). Skipped messages are never loaded from disk — the
        index stamp decides."""
        t0 = self.index[0]["stamp"] if self.index else 0.0
        for meta in self.index:
            off = meta["stamp"] - t0
            if off < start:
                continue
            if duration is not None and off > start + duration:
                break
            with np.load(os.path.join(self.bag_dir, meta["file"])) as data:
                arrays = {k: data[k] for k in data.files}
            yield meta["topic"], _decode(meta, arrays)

    def play(self, bus: Bus, *, realtime: bool = False, rate: float = 1.0,
             loop: int = 1, start: float = 0.0, duration=None) -> int:
        """Publish every message; with ``realtime`` sleep to preserve original
        inter-message gaps (scaled by 1/rate). ``loop``/``start``/``duration``
        mirror ``rosbag play -l/-s/-u`` (each pass restarts its clock)."""
        n = 0
        for _ in range(max(1, int(loop))):
            prev_stamp = None
            for topic, msg in self.messages(start=start, duration=duration):
                if realtime and prev_stamp is not None:
                    gap = max(msg.header.stamp - prev_stamp, 0.0) / rate
                    if gap > 0:
                        time.sleep(min(gap, 10.0))
                prev_stamp = msg.header.stamp
                bus.publish(topic, msg)
                n += 1
        return n
