"""Bounded MPMC queue with Block/Drop overflow (reference core/BoundedQueue.hpp:14-95).

Block: producers wait for space (lossless file path backpressure).
Drop: evict the oldest and count it (camera path; hardware can't be stalled).
stop() unblocks every waiter; frames may be skipped, never reordered.
"""

from __future__ import annotations

import collections
import enum
import threading
from typing import Deque, Generic, Optional, TypeVar

T = TypeVar("T")


class OverflowPolicy(enum.Enum):
    BLOCK = "block"
    DROP = "drop"


class BoundedQueue(Generic[T]):
    def __init__(self, capacity: int, policy: OverflowPolicy = OverflowPolicy.BLOCK):
        self._capacity = max(1, capacity)
        self._policy = policy
        self._items: Deque[T] = collections.deque()
        self._mutex = threading.Lock()
        self._not_empty = threading.Condition(self._mutex)
        self._not_full = threading.Condition(self._mutex)
        self._stopped = False
        self._drops = 0

    def set_policy(self, policy: OverflowPolicy) -> None:
        with self._mutex:
            self._policy = policy

    def push(self, item: T) -> bool:
        """Returns False if the queue is stopped (item not enqueued)."""
        with self._mutex:
            if self._policy is OverflowPolicy.BLOCK:
                while len(self._items) >= self._capacity and not self._stopped:
                    self._not_full.wait()
                if self._stopped:
                    return False
            else:
                if self._stopped:
                    return False
                while len(self._items) >= self._capacity:
                    dropped = self._items.popleft()
                    self._drops += 1
                    self._release(dropped)
            self._items.append(item)
            self._not_empty.notify()
            return True

    def pop(self, timeout: Optional[float] = None) -> Optional[T]:
        """Blocks for an item; returns None when stopped (or timed out)."""
        with self._mutex:
            if timeout is None:
                while not self._items and not self._stopped:
                    self._not_empty.wait()
            else:
                deadline_ok = self._not_empty.wait_for(
                    lambda: self._items or self._stopped, timeout
                )
                if not deadline_ok:
                    return None
            if not self._items:
                return None
            item = self._items.popleft()
            self._not_full.notify()
            return item

    def stop(self) -> None:
        """Unblock all producers and consumers (teardown ordering depends on this
        running BEFORE thread joins — reference PlaybackController.cpp:316-331)."""
        with self._mutex:
            self._stopped = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def reset(self) -> None:
        with self._mutex:
            for item in self._items:
                self._release(item)
            self._items.clear()
            self._stopped = False
            self._drops = 0

    @property
    def drops(self) -> int:
        with self._mutex:
            return self._drops

    def depth(self) -> int:
        with self._mutex:
            return len(self._items)

    @staticmethod
    def _release(item) -> None:
        release = getattr(item, "release", None)
        if callable(release):
            release()
