"""Request-level serving primitives, port of ``repro.serving.requests``.

A :class:`Request` is what a client submits (prompt, token budget, optional
EOS, arrival time relative to the run's start); the engine fills in a
:class:`RequestRecord` when it retires. :func:`poisson_trace` builds the
synthetic workload from a threefry key through the RNG bridge: the same key
gives the reference's trace.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request; ``prompt`` is a 1-D int token array."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_t: float = 0.0
    features: Optional[dict] = None
    first_token_t: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(
            self, "prompt", np.asarray(self.prompt, np.int32).reshape(-1)
        )
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")


@dataclasses.dataclass
class RequestRecord:
    """What the engine hands back when a request retires."""

    rid: int
    slot: int
    tokens: np.ndarray  # generated token ids, first token from prefill
    n_prompt: int
    admit_step: int
    finish_step: int
    arrival_t: float
    admit_t: float  # seconds since run start
    finish_t: float
    finished_by: str  # "eos" | "max_tokens"

    @property
    def latency_s(self) -> float:
        """Queueing + service time: arrival to retirement."""
        return self.finish_t - self.arrival_t

    @property
    def ttft_s(self) -> float:
        """Time to first token: arrival to the end of the admitting prefill."""
        return self.admit_t - self.arrival_t

    @property
    def n_new(self) -> int:
        return int(self.tokens.size)


def poisson_trace(
    key: torch.Tensor,
    n: int,
    *,
    vocab: int,
    rate: Optional[float] = None,
    prompt_lens: tuple[int, ...] = (8, 16, 24, 32),
    new_tokens: tuple[int, int] = (8, 128),
    eos_id: Optional[int] = None,
) -> list[Request]:
    """Variable-length request trace with Poisson arrivals, drawn from the
    threefry ``key`` as the reference draws it.

    ``rate=None`` (or <= 0) queues every request at t=0. Prompt lengths are
    drawn from ``prompt_lens``, tokens uniform over the vocabulary, budgets
    uniform in the inclusive ``new_tokens`` range.
    """
    k_len, k_tok, k_new, k_arr = prng.split(key.cpu(), 4)
    lens = prng.choice(k_len, torch.tensor(prompt_lens), (n,)).numpy()
    budgets = prng.randint(k_new, (n,), new_tokens[0], new_tokens[1] + 1).numpy()
    if rate and rate > 0:
        gaps = prng.exponential(k_arr, (n,)).numpy() / float(rate)
        arrivals = np.cumsum(gaps)
        arrivals[0] = 0.0  # the first request starts the clock
    else:
        arrivals = np.zeros(n)
    return [
        Request(
            rid=i,
            prompt=prng.randint(prng.fold_in(k_tok, i), (int(lens[i]),), 0, vocab).numpy(),
            max_new_tokens=int(budgets[i]),
            eos_id=eos_id,
            arrival_t=float(arrivals[i]),
        )
        for i in range(n)
    ]
