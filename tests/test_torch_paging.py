"""Port parity: page allocation, prefill buckets and the bucketed scheduler.

All three are plain Python in both packages, so the port must decide
bitwise as the reference does:

* ``PageAllocator`` against the reference's over one seeded storm of
  allocations and frees (including exhaustion, double frees, the scratch
  page and out-of-range ids): the same ids, the same ``peak_in_use``, the
  same errors (type and message);
* ``default_buckets`` and ``bucket_for`` equal for every length up to s_max;
* ``BucketedScheduler`` admits and orders as the reference's.
"""

import numpy as np
import pytest

from repro import serving as jserving
from repro.serving import paging as jpaging
from repro_torch import serving as tserving
from repro_torch.serving import paging as tpaging


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("n_pages", [2, 9, 40])
def test_allocator_storm_matches_reference(n_pages):
    rng = np.random.default_rng(n_pages)
    j, t = jpaging.PageAllocator(n_pages), tpaging.PageAllocator(n_pages)
    held: list[int] = []
    for _ in range(400):
        op = rng.integers(0, 5)
        if op <= 1:
            n = int(rng.integers(-1, n_pages // 2 + 2))
            a, b = _outcome(j.alloc, n), _outcome(t.alloc, n)
            if a[0] == "ok":
                held += a[1]
        elif op == 2 and held:
            k = int(rng.integers(1, len(held) + 1))
            pick = [held.pop(int(rng.integers(0, len(held)))) for _ in range(k)]
            a, b = _outcome(j.free, pick), _outcome(t.free, pick)
        else:  # a bad free: double free, the scratch page, out of range
            bad = [int(rng.choice([0, n_pages, n_pages + 3, -1] + held[:1] * 2))]
            if bad[0] in held:
                held.remove(bad[0])
                bad = bad * 2
            a, b = _outcome(j.free, bad), _outcome(t.free, bad)
        assert a == b
        assert (j.n_free, j.n_in_use, j.peak_in_use) == (t.n_free, t.n_in_use, t.peak_in_use)
        assert t.n_free + t.n_in_use == n_pages - 1
    assert _outcome(jpaging.PageAllocator, 1) == _outcome(tpaging.PageAllocator, 1)


@pytest.mark.parametrize("s_max,base", [(1, 32), (48, 32), (512, 32), (384, 16), (100, 7)])
def test_buckets_match_reference(s_max, base):
    jb, tb = jpaging.default_buckets(s_max, base), tpaging.default_buckets(s_max, base)
    assert jb == tb
    for length in range(1, s_max + 2):
        assert _outcome(jpaging.bucket_for, length, jb) == _outcome(tpaging.bucket_for, length, tb)
    for bad in ((0, base), (s_max, 0)):
        assert _outcome(jpaging.default_buckets, *bad) == _outcome(tpaging.default_buckets, *bad)


def test_bucketed_scheduler_matches_reference():
    rng = np.random.default_rng(0)
    j, t = jserving.BucketedScheduler(), tserving.BucketedScheduler()
    assert j.name == t.name == "bucketed"
    for n in (0, 1, 5, 17):
        lens = rng.integers(1, 40, size=n)
        jreq = [jserving.Request(rid=i, prompt=np.arange(m), max_new_tokens=2)
                for i, m in enumerate(lens)]
        treq = [tserving.Request(rid=i, prompt=np.arange(m), max_new_tokens=2)
                for i, m in enumerate(lens)]
        assert j.order(jreq) == t.order(treq)
        for free in range(0, 6):
            assert j.admit(n, free, 3) == t.admit(n, free, 3)
