"""repro_torch.serving -- continuous-batching serving over programmed chips.

Counterpart of ``repro.serving``: :class:`ServingConfig`,
:class:`Request`/:func:`poisson_trace`, the continuous, static and bucketed
schedulers, the paged KV cache's :class:`PageAllocator` and prefill
buckets, :class:`ServingEngine` with its :class:`EngineRun` stepping
surface, :class:`ServeReport` and the drift lifecycle
(:class:`DriftPolicy`, :class:`ChipClock`); and N chips behind one router:
:class:`FleetRouter` (:class:`FleetConfig`, :class:`FleetReport`,
:class:`FleetRecord`) and its threaded front end :class:`AsyncFleetRouter`
(:class:`AsyncConfig`, :class:`AdmissionQueue`, :class:`QueueFull`,
:class:`TokenStream`), one worker and, on a card, one CUDA stream per chip.
"""

from repro_torch.serving.async_fleet import (  # noqa: F401
    AdmissionQueue,
    AsyncFleetRouter,
    QueueFull,
    TokenStream,
)
from repro_torch.serving.config import (  # noqa: F401
    AsyncConfig,
    DriftPolicy,
    FleetConfig,
    ServingConfig,
)
from repro_torch.serving.engine import (  # noqa: F401
    ChipClock,
    EngineRun,
    ServeReport,
    ServingEngine,
)
from repro_torch.serving.fleet import FleetRecord, FleetReport, FleetRouter  # noqa: F401
from repro_torch.serving.paging import PageAllocator, bucket_for, default_buckets  # noqa: F401
from repro_torch.serving.requests import Request, RequestRecord, poisson_trace  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    BucketedScheduler,
    ContinuousScheduler,
    StaticBatchScheduler,
)
