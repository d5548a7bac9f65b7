"""Frame graph: the TF-tree equivalent.

Copy of ``trajectory_optimization_tpu/bus/frames.py`` (float64 numpy host
math, no framework); the port keeps its own copy so that it imports nothing
of the JAX package.

The reference leans on ROS TF for frame bookkeeping: broadcasting optimized
camera poses (`src/tools.py:234-249`) and looking up cloud→camera transforms
(`src/pc_processor.py:161-162`, `lookupTransform(..., rospy.Time(0))` =
latest). This is a small explicit graph of stamped rigid transforms with path
composition — no background threads, no global state.

Like the TF buffer, every edge keeps a stamped history (default 100 entries);
``lookup(..., time=...)`` interpolates the edge at the requested time (lerp
for translation, slerp for rotation — TF2's interpolation), clamping outside
the recorded range. ``time=None`` means latest, the reference's Time(0)
behavior. This matters for replayed bags with a moving robot, where cloud and
camera-info stamps differ.
"""
from __future__ import annotations

import bisect
import collections
import threading
from typing import Dict, Optional, Tuple

import numpy as np


def _quat_to_mat_xyzw(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _mat_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def _slerp_xyzw(q0: np.ndarray, q1: np.ndarray, alpha: float) -> np.ndarray:
    """Spherical interpolation between unit quaternions (shortest arc)."""
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:  # nearly parallel: lerp avoids sin(θ)→0 division
        q = q0 + alpha * (q1 - q0)
    else:
        theta = np.arccos(np.clip(d, -1.0, 1.0))
        q = (np.sin((1.0 - alpha) * theta) * q0 + np.sin(alpha * theta) * q1) / np.sin(theta)
    return q / np.linalg.norm(q)


class FrameGraph:
    """Graph of rigid transforms between named frames.

    ``set_transform(parent, child, t, q_xyzw, stamp)`` records T_parent_child
    (the pose of ``child`` expressed in ``parent``) into the edge's stamped
    history. ``lookup(target, source, time=...)`` returns (t, q_xyzw) of
    T_target_source — the transform that maps points in ``source`` coordinates
    into ``target`` coordinates — matching TF's ``lookupTransform(target,
    source, time)``; ``time=None`` is the latest transform (rospy.Time(0)).
    """

    def __init__(self, history: int = 100):
        # per-edge stamped history: (parent, child) → deque[(stamp, t, q)]
        self._hist: Dict[Tuple[str, str], collections.deque] = {}
        self._history_len = int(history)
        self._lock = threading.RLock()

    def set_transform(self, parent: str, child: str, translation, q_xyzw, stamp: float = 0.0):
        t = np.asarray(translation, np.float64).reshape(3)
        q = np.asarray(q_xyzw, np.float64).reshape(4)
        q = q / np.linalg.norm(q)
        with self._lock:
            hist = self._hist.get((parent, child))
            if hist is None:
                hist = self._hist[(parent, child)] = collections.deque(
                    maxlen=self._history_len
                )
            entry = (float(stamp), t, q)
            # stamps normally arrive monotonically; tolerate out-of-order
            if hist and hist[-1][0] > entry[0]:
                items = sorted(list(hist) + [entry], key=lambda e: e[0])
                hist.clear()
                hist.extend(items[-self._history_len:])
            else:
                hist.append(entry)

    def listen(self, bus, topics: Tuple[str, ...] = ("/tf", "/tf_static")) -> None:
        """Subscribe this graph to TransformMsg traffic — the
        tf.TransformListener role (the reference's nodes construct one at
        startup, `src/pc_processor.py:57`), so replayed bags with a moving
        robot populate the time-indexed buffer without manual set_transform
        calls. ``/tf_static`` entries get stamp 0.0 so they resolve at any
        query time (TF static semantics)."""

        def make_cb(static: bool):
            def cb(msg):
                self.set_transform(
                    msg.header.frame_id,
                    msg.child_frame_id,
                    msg.translation,
                    msg.rotation_xyzw,
                    stamp=0.0 if static else msg.header.stamp,
                )

            return cb

        for t in topics:
            bus.subscribe(t, make_cb("static" in t))

    def _neighbors(self, frame):
        for (p, c) in self._hist:
            if p == frame:
                yield c
            elif c == frame:
                yield p

    def _edge_at(self, key, time: Optional[float]):
        """(t, q) of a stored edge at the requested time (interpolated;
        clamped outside the recorded range; latest when time is None)."""
        hist = self._hist[key]
        if time is None or len(hist) == 1:
            _, t, q = hist[-1]
            return t, q
        stamps = [e[0] for e in hist]
        if time <= stamps[0]:
            return hist[0][1], hist[0][2]
        if time >= stamps[-1]:
            return hist[-1][1], hist[-1][2]
        i = bisect.bisect_right(stamps, time)
        s0, t0, q0 = hist[i - 1]
        s1, t1, q1 = hist[i]
        a = (time - s0) / max(s1 - s0, 1e-12)
        return t0 + a * (t1 - t0), _slerp_xyzw(q0, q1, a)

    def _edge_matrix(self, a: str, b: str, time: Optional[float] = None) -> np.ndarray:
        """4x4 T_a_b for a stored edge in either direction."""
        with self._lock:
            if (a, b) in self._hist:
                t, q = self._edge_at((a, b), time)
                M = np.eye(4)
                M[:3, :3] = _quat_to_mat_xyzw(q)
                M[:3, 3] = t
                return M
            t, q = self._edge_at((b, a), time)
            M = np.eye(4)
            M[:3, :3] = _quat_to_mat_xyzw(q)
            M[:3, 3] = t
            return np.linalg.inv(M)

    def lookup_matrix(
        self, target: str, source: str, time: Optional[float] = None
    ) -> np.ndarray:
        """4x4 T_target_source via BFS over the frame graph."""
        if target == source:
            return np.eye(4)
        with self._lock:
            frames = set()
            for p, c in self._hist:
                frames.add(p)
                frames.add(c)
        if target not in frames or source not in frames:
            raise KeyError(f"unknown frame in lookup({target!r}, {source!r})")
        # BFS from target to source
        prev = {target: None}
        queue = [target]
        while queue:
            f = queue.pop(0)
            if f == source:
                break
            for n in self._neighbors(f):
                if n not in prev:
                    prev[n] = f
                    queue.append(n)
        if source not in prev:
            raise KeyError(f"frames {target!r} and {source!r} are not connected")
        # walk back source → target, composing
        chain = []
        f = source
        while prev[f] is not None:
            chain.append((prev[f], f))
            f = prev[f]
        M = np.eye(4)
        for a, b in reversed(chain):
            M = M @ self._edge_matrix(a, b, time)
        return M

    def lookup(
        self, target: str, source: str, time: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(translation, quaternion_xyzw) of T_target_source."""
        M = self.lookup_matrix(target, source, time)
        return M[:3, 3].copy(), _mat_to_quat_xyzw(M[:3, :3])

    def transform_points(
        self, points: np.ndarray, target: str, source: str, time: Optional[float] = None
    ) -> np.ndarray:
        """Map (N, 3) points from ``source`` coordinates to ``target``."""
        M = self.lookup_matrix(target, source, time)
        pts = np.asarray(points, np.float64)
        return (pts @ M[:3, :3].T + M[:3, 3]).astype(points.dtype)
