"""Training (counterpart of ``repro.training``): the paper's two-stage loop,
its optimizers and gradient compression."""

from repro_torch.training.loop import TrainConfig, run_two_stage  # noqa: F401
from repro_torch.training.optim import OptimizerConfig, init, update  # noqa: F401
