"""repro_torch.serving -- continuous-batching serving over one programmed chip.

Counterpart of ``repro.serving`` for the single-chip path:
:class:`ServingConfig`, :class:`Request`/:func:`poisson_trace`, the
continuous, static and bucketed schedulers, the paged KV cache's
:class:`PageAllocator` and prefill buckets, and :class:`ServingEngine` with
its :class:`EngineRun` stepping surface, :class:`ServeReport` and the
drift lifecycle (:class:`DriftPolicy`, :class:`ChipClock`).
"""

from repro_torch.serving.config import DriftPolicy, ServingConfig  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    ChipClock,
    EngineRun,
    ServeReport,
    ServingEngine,
)
from repro_torch.serving.paging import PageAllocator, bucket_for, default_buckets  # noqa: F401
from repro_torch.serving.requests import Request, RequestRecord, poisson_trace  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    BucketedScheduler,
    ContinuousScheduler,
    StaticBatchScheduler,
)
