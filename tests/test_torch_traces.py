"""The fixed request traces the port-vs-reference serving tests share.

:func:`numpy_trace` draws a trace from ``numpy.random.default_rng(seed)``
(prompt lengths, budgets, Poisson gaps, tokens), independent of either
package's trace generator. The serving parity files import it from here;
the tests below pin what it draws.
"""

import numpy as np

from repro_torch import serving as tserving


def numpy_trace(seed, n, *, vocab, rate=None, prompt_lens, new_tokens):
    """``n`` requests drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    lens = rng.choice(np.asarray(prompt_lens), size=n)
    budgets = rng.integers(new_tokens[0], new_tokens[1] + 1, size=n)
    arrivals = np.zeros(n)
    if rate:
        arrivals = np.cumsum(rng.exponential(1.0 / float(rate), size=n))
        arrivals[0] = 0.0
    return [tserving.Request(rid=i, prompt=rng.integers(0, vocab, size=int(lens[i])),
                             max_new_tokens=int(budgets[i]), arrival_t=float(arrivals[i]))
            for i in range(n)]


def test_numpy_trace_is_a_fixed_function_of_its_seed():
    kw = dict(vocab=256, rate=400.0, prompt_lens=(4, 9, 16), new_tokens=(3, 10))
    a, b = numpy_trace(1, 7, **kw), numpy_trace(1, 7, **kw)
    assert [r.rid for r in a] == list(range(7))
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.arrival_t) == (y.max_new_tokens, y.arrival_t)
        assert len(x.prompt) in kw["prompt_lens"] and 3 <= x.max_new_tokens <= 10
        assert x.prompt.min() >= 0 and x.prompt.max() < 256
    assert a[0].arrival_t == 0.0
    assert all(p.arrival_t < q.arrival_t for p, q in zip(a, a[1:]))
    assert all(r.arrival_t == 0.0 for r in numpy_trace(1, 3, **{**kw, "rate": None}))
