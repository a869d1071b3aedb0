"""RCU-style live configuration (reference core/AtomicConfig.hpp:10-32).

The GUI/CLI publishes an immutable snapshot; the processing worker reads the
pointer once per frame. A slider change never locks against the frame loop
(invariant 5).
"""

from __future__ import annotations

import threading
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class AtomicConfig(Generic[T]):
    def __init__(self, initial: Optional[T] = None):
        self._lock = threading.Lock()
        self._snapshot: Optional[T] = initial

    def publish(self, snapshot: T) -> None:
        """snapshot must be immutable (frozen dataclass)."""
        with self._lock:
            self._snapshot = snapshot

    def read(self) -> Optional[T]:
        with self._lock:
            return self._snapshot
