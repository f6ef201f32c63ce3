"""Fixed-capacity telemetry ring (a copy of ``repro.service.ring``): O(1)
lock-held push, exact drop counts.

The dispatch loop's side of the telemetry contract: ``push`` never waits
on a consumer (the critical section is one list store and an increment),
so a stalled or absent exporter can never block a segment boundary.  The
consumer's side: samples carry monotonically increasing sequence numbers,
and ``drain(cursor)`` reports *exactly* how many samples between the
cursor and the current head were overwritten before the consumer got to
them — losses are counted, never silent (the service's "lossless or
exactly counted" telemetry criterion).
"""

from __future__ import annotations

import threading


class TelemetryRing:
    """Bounded ring of telemetry samples with monotonic sequence numbers.

    One producer lock serializes writers (multiple campaign workers push
    concurrently); consumers never hold it for longer than a bounded copy
    of at most ``capacity`` references.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"ring capacity {capacity} must be >= 1")
        self._capacity = capacity
        self._buf: list = [None] * capacity
        self._head = 0  # total samples ever pushed == next sequence number
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def head(self) -> int:
        """Total samples pushed so far (the next sample's sequence number)."""
        with self._lock:
            return self._head

    def push(self, sample) -> int:
        """Append ``sample``; returns its sequence number.

        O(1) under the lock — never blocks on consumers.  Overwrites the
        oldest sample when full; the overwrite is what ``drain`` counts.
        """
        with self._lock:
            seq = self._head
            self._buf[seq % self._capacity] = sample
            self._head = seq + 1
            return seq

    def drain(self, cursor: int) -> tuple[list, int, int]:
        """Samples with sequence >= ``cursor`` still in the ring.

        Returns ``(samples, new_cursor, dropped)``: ``new_cursor`` is the
        head at drain time (pass it to the next ``drain``), ``dropped`` is
        exactly the number of samples in ``[cursor, head)`` that were
        overwritten before this drain — ``max(0, head - capacity - cursor)``.
        """
        with self._lock:
            head = self._head
            dropped = max(0, head - self._capacity - cursor)
            start = max(cursor, head - self._capacity, 0)
            samples = [
                self._buf[i % self._capacity] for i in range(start, head)
            ]
        return samples, head, dropped

    def snapshot(self, n: int | None = None) -> list:
        """The most recent ``min(n, available)`` samples, oldest first.

        Cursor-free read for the API's live-telemetry endpoint; does not
        interact with any consumer's drain position.
        """
        with self._lock:
            head = self._head
            avail = min(head, self._capacity)
            if n is not None:
                avail = min(avail, max(n, 0))
            return [
                self._buf[i % self._capacity]
                for i in range(head - avail, head)
            ]
