"""Admission schedulers, port of ``repro.serving.scheduler``.

Once per step the engine shows the scheduler how many queued requests have
arrived and how many slots are free; the scheduler answers how many to
admit. A scheduler may define ``order(arrived) -> permutation`` to choose
WHICH arrived requests enter (the engine admits the first ``admit(...)``
entries of the permutation); without it admission is FIFO.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ContinuousScheduler:
    """Admit every arrived request a free slot can take, immediately."""

    name: str = "continuous"

    def admit(self, n_arrived: int, n_free: int, n_active: int) -> int:
        return min(n_arrived, n_free)


@dataclasses.dataclass(frozen=True)
class StaticBatchScheduler:
    """Wave batching: admit a fresh batch only when all slots are free."""

    name: str = "static"

    def admit(self, n_arrived: int, n_free: int, n_active: int) -> int:
        if n_active:
            return 0  # the wave must drain completely first
        return min(n_arrived, n_free)


@dataclasses.dataclass(frozen=True)
class BucketedScheduler:
    """Continuous admission in prompt-length-sorted order.

    Same admission count as :class:`ContinuousScheduler`; ``order`` sorts
    arrived requests by prompt length (stable: equal lengths stay FIFO), so
    the paged engine's bucketed prefill sees same-bucket requests adjacently
    and batches them into one padded prefill call.
    """

    name: str = "bucketed"

    def admit(self, n_arrived: int, n_free: int, n_active: int) -> int:
        return min(n_arrived, n_free)

    def order(self, arrived) -> list[int]:
        return sorted(
            range(len(arrived)), key=lambda i: int(arrived[i].prompt.size)
        )
