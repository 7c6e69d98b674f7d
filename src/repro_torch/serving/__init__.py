"""repro_torch.serving -- continuous-batching serving over one programmed chip.

Counterpart of ``repro.serving`` for the non-paged, non-fused, single-chip
path: :class:`ServingConfig`, :class:`Request`/:func:`poisson_trace`, the
continuous and static schedulers, and :class:`ServingEngine` with its
:class:`EngineRun` stepping surface and :class:`ServeReport`.
"""

from repro_torch.serving.config import ServingConfig  # noqa: F401
from repro_torch.serving.engine import EngineRun, ServeReport, ServingEngine  # noqa: F401
from repro_torch.serving.requests import Request, RequestRecord, poisson_trace  # noqa: F401
from repro_torch.serving.scheduler import ContinuousScheduler, StaticBatchScheduler  # noqa: F401
