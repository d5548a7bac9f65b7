"""In-process scene bus: topics and pub/sub.

Twin of ``Bus`` and ``Subscription`` in
``trajectory_optimization_tpu/bus/core.py``, copied. Publish delivers
synchronously to subscribers (deterministic for tests and replay), latches
the last message per topic and, under the default ``error_policy='isolate'``,
records a subscriber's exception instead of raising it to the publisher.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List


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
