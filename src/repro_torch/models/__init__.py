"""Models of the port (counterpart of ``repro.models``): the dense LM."""

from repro_torch.models.common import ModelConfig  # noqa: F401
from repro_torch.models.lm import (  # noqa: F401
    LMParams,
    init_lm_cache,
    lm_forward,
    lm_init,
)
