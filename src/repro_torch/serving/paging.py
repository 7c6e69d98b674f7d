"""Page allocation and prefill bucketing, port of ``repro.serving.paging``.

The paged KV cache (``models.attention.PagedKVCache``) replaces each slot's
worst-case rectangle with a pool of fixed-size pages shared by every slot,
all attention layers using one page-id space:

* page id 0 is the reserved *scratch* page -- never handed out; unused
  page-table entries point at it and retired slots write their dead decode
  tokens into it;
* a page is owned by at most one slot at a time;
* every allocated page is freed exactly once (the free list is conserved).

:class:`PageAllocator` is a plain-Python free list (only the page tables
live on the device); its decisions are bitwise the reference's.

Bucketed prefill: prompts are right-padded to a small geometric grid of
lengths (:func:`default_buckets`), so prefill runs at most one shape per
bucket. Right-padding is inert because the prefill attention is
shape-stable (``models.attention.chunked_attention``).
"""

from __future__ import annotations


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages that hold ``n_tokens`` tokens: ceil(n_tokens / page_size)."""
    return -(-int(n_tokens) // int(page_size))


class PageAllocator:
    """Free-list allocator over page ids ``1 .. n_pages-1`` (0 = scratch).

    Pages go out lowest id first; ``free`` raises on a double free, on the
    scratch page and on out-of-range ids. ``peak_in_use`` is the high-water
    mark, which times the bytes per page is the run's resident KV footprint.
    Invariant: ``n_free + n_in_use == n_pages - 1``.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(
                f"need at least 2 pages (scratch + 1 usable), got {n_pages}"
            )
        self.n_pages = int(n_pages)
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() -> 1, 2, ..
        self._in_use: set[int] = set()
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return len(self._in_use)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` pages off the free list. Raises if fewer remain."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"free of {self.n_pages - 1}"
            )
        out = [self._free.pop() for _ in range(n)]
        self._in_use.update(out)
        self.peak_in_use = max(self.peak_in_use, len(self._in_use))
        return out

    def free(self, pages) -> None:
        """Return pages to the free list. Each must be currently in use."""
        for p in pages:
            p = int(p)
            if p not in self._in_use:
                raise ValueError(
                    f"page {p} is not allocated "
                    "(double free, scratch page, or out of range)"
                )
            self._in_use.remove(p)
            self._free.append(p)


def default_buckets(s_max: int, base: int = 32) -> tuple[int, ...]:
    """Geometric prefill-length grid: ``base * 2^k`` capped at ``s_max``.

    ``s_max`` is always the last bucket, so every admissible prompt has a
    bucket and prefill runs at most ``len(buckets)`` shapes.
    """
    if s_max < 1:
        raise ValueError(f"s_max must be >= 1, got {s_max}")
    if base < 1:
        raise ValueError(f"bucket base must be >= 1, got {base}")
    out = []
    b = base
    while b < s_max:
        out.append(b)
        b *= 2
    out.append(s_max)
    return tuple(out)


def bucket_for(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= ``length`` (prompts are right-padded up to it)."""
    for b in sorted(buckets):
        if length <= b:
            return b
    raise ValueError(
        f"prompt length {length} exceeds the largest prefill bucket "
        f"{max(buckets)}"
    )


def prefill_rows(buckets: tuple[int, ...], prefill_batch: int) -> dict[int, int]:
    """Rows of the one ``(rows, bucket)`` prefill shape of each bucket: a
    constant prefill TOKEN budget, ``prefill_batch`` rows at the smallest
    bucket and fewer as buckets grow (at least 1)."""
    budget = int(prefill_batch) * min(buckets)
    return {b: max(1, min(int(prefill_batch), budget // b)) for b in buckets}
