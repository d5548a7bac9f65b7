"""In-process scene bus: topics, pub/sub, approximate-time pairing.

Twin of ``trajectory_optimization_tpu/bus/core.py``, copied. Publish delivers
synchronously to subscribers (deterministic for tests and replay), latches
the last message per topic and, under the default ``error_policy='isolate'``,
records a subscriber's exception instead of raising it to the publisher.
:class:`ApproximateTimeSynchronizer` reproduces the reference's
``message_filters`` slop-window pairing (queue 10, slop 0.5).
"""
from __future__ import annotations

import collections
import itertools
import threading
from typing import Callable, Dict, List, Sequence

from trajectory_optimization_tpu_torch.bus.messages import Header


class Subscription:
    def __init__(self, bus: "Bus", topic: str, callback: Callable, queue_size: int):
        self.bus = bus
        self.topic = topic
        self.callback = callback
        self.queue_size = queue_size

    def unsubscribe(self):
        self.bus._remove(self)


class Bus:
    """Topic-based pub/sub. Thread-safe; delivery is synchronous.

    Failure isolation: with ``error_policy='isolate'`` a subscriber exception
    is recorded (``bus.errors``, plus an event on the ``/__errors__`` topic)
    and does NOT propagate to the publisher. Use ``error_policy='raise'`` in
    tests to surface bugs immediately."""

    INTERNAL_TOPIC_PREFIX = "/__"
    ERROR_TOPIC = "/__errors__"

    def __init__(self, error_policy: str = "isolate", history: int = 0):
        """``history`` > 0 retains that many messages per topic for
        :meth:`history` — a debug feature, OFF by default: retained on-card
        images and large clouds would pin their memory."""
        if error_policy not in ("isolate", "raise"):
            raise ValueError(f"unknown error_policy {error_policy!r}")
        self.error_policy = error_policy
        self.errors: List[dict] = []
        self._subs: Dict[str, List[Subscription]] = collections.defaultdict(list)
        self._latched: Dict[str, object] = {}
        self._lock = threading.RLock()
        self._history_len = int(history)
        self._history: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=self._history_len)
        )
        self._taps: List[Callable] = []

    def subscribe(
        self, topic: str, callback: Callable, *, queue_size: int = 1, latch: bool = True
    ) -> Subscription:
        sub = Subscription(self, topic, callback, queue_size)
        with self._lock:
            self._subs[topic].append(sub)
            latched = self._latched.get(topic)
        if latch and latched is not None:
            callback(latched)
        return sub

    def add_tap(self, fn: Callable) -> Callable:
        """Register ``fn(topic, msg)`` to observe EVERY publish. Returns
        ``fn`` for later :meth:`remove_tap`. Tap exceptions follow the bus
        error policy."""
        with self._lock:
            self._taps.append(fn)
        return fn

    def remove_tap(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._taps:
                self._taps.remove(fn)

    def publish(self, topic: str, msg) -> None:
        with self._lock:
            self._latched[topic] = msg
            if self._history_len:
                self._history[topic].append(msg)
            subs = list(self._subs.get(topic, ()))
            taps = list(self._taps)
        for tap in taps:
            try:
                tap(topic, msg)
            except Exception as e:  # noqa: BLE001 — isolation boundary
                if self.error_policy == "raise":
                    raise
                event = {"topic": topic, "error": repr(e), "callback": repr(tap)}
                self.errors.append(event)
        for sub in subs:
            try:
                sub.callback(msg)
            except Exception as e:  # noqa: BLE001 — isolation boundary
                if self.error_policy == "raise" or topic == self.ERROR_TOPIC:
                    raise
                event = {"topic": topic, "error": repr(e), "callback": repr(sub.callback)}
                self.errors.append(event)
                self.publish(self.ERROR_TOPIC, event)

    def latest(self, topic: str):
        with self._lock:
            return self._latched.get(topic)

    def history(self, topic: str) -> list:
        with self._lock:
            return list(self._history[topic])

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(set(self._subs) | set(self._latched))

    def _remove(self, sub: Subscription):
        with self._lock:
            if sub in self._subs.get(sub.topic, ()):
                self._subs[sub.topic].remove(sub)


class ApproximateTimeSynchronizer:
    """Pair messages from several topics whose stamps agree within ``slop``.

    Reference semantics (message_filters, `src/pose_optimization.py:58-62`):
    keep per-topic queues of the last ``queue_size`` messages; whenever a
    message arrives, search the queues for the combination (one message per
    topic) minimizing max-stamp − min-stamp, fire the callback if that span is
    ≤ slop, and consume the fired messages (plus anything older on their
    topics, so a message never participates in two firings).

    Unlike a greedy newest-per-topic pick, the search finds an older in-window
    pair even when one topic has run ahead past the slop. The search is the
    cartesian product of the queues — exponential in the number of topics, but
    the node graphs here pair 2 (clouds+poses/paths) with queues ≤ 10.
    """

    def __init__(
        self,
        bus: Bus,
        topics: Sequence[str],
        callback: Callable,
        *,
        queue_size: int = 10,
        slop: float = 0.5,
    ):
        self.topics = list(topics)
        self.callback = callback
        self.slop = slop
        self._queues = {t: collections.deque(maxlen=queue_size) for t in self.topics}
        self._lock = threading.Lock()
        self._subs = [
            bus.subscribe(t, self._make_cb(t), queue_size=queue_size, latch=False)
            for t in self.topics
        ]

    def _make_cb(self, topic):
        def cb(msg):
            self._add(topic, msg)

        return cb

    @staticmethod
    def _stamp(msg) -> float:
        h = getattr(msg, "header", None)
        return h.stamp if isinstance(h, Header) else float(getattr(msg, "stamp", 0.0))

    def _add(self, topic, msg):
        fire = None
        with self._lock:
            self._queues[topic].append(msg)
            if all(self._queues[t] for t in self.topics):
                # best combination: minimal stamp span; ties → newest pair
                best_key, best = None, None
                for combo in itertools.product(*(self._queues[t] for t in self.topics)):
                    stamps = [self._stamp(m) for m in combo]
                    span = max(stamps) - min(stamps)
                    if span > self.slop:
                        continue
                    key = (span, -min(stamps))
                    if best_key is None or key < best_key:
                        best_key, best = key, combo
                if best is not None:
                    fire = list(best)
                    # consume fired messages and everything with an older
                    # stamp on their topic — by STAMP, not queue position:
                    # arrival order need not be stamp order, and a front-only
                    # pop would let an out-of-order message fire twice
                    for t, m in zip(self.topics, fire):
                        q = self._queues[t]
                        s = self._stamp(m)
                        kept = [x for x in q if self._stamp(x) > s]
                        q.clear()
                        q.extend(kept)
        if fire is not None:
            self.callback(*fire)

    def close(self):
        for s in self._subs:
            s.unsubscribe()
