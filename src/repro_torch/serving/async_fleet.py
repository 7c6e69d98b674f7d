"""Async fleet front end: overlapped decode, streaming tokens, backpressure.

Port of ``repro.serving.async_fleet``. ``FleetRouter.run`` serves N chips
correctly but *synchronously*: every chip's admit+decode happens inside one
router tick on one thread, so N chips give N-fold capacity with zero
wall-clock overlap. This module is the concurrent front end over the same
fleet:

* **One worker per chip** (:class:`_ChipWorker`): each chip's
  :class:`~repro_torch.serving.engine.EngineRun` is driven by its owning
  worker thread on its own cadence -- admit, decode, evict. On a card each
  worker owns one CUDA stream, and everything it runs for its chips is
  enqueued there, so the chips' kernels can overlap on the device; on the
  host the workers overlap only where PyTorch's ops and the kernels'
  ``ctypes`` launches release the interpreter lock (each op dispatch, not
  a whole step as XLA does). The thread-safety story is *exclusive
  ownership* (the actor discipline RL006 lints for): only the owner
  mutates a run; everyone else -- the coordinator included -- talks to it
  through the owner's command queue, and reads at most GIL-atomic
  counters.
* **A coordinator** (the router's bookkeeping brain): dispatch, health
  windows, staggered drain/migrate/refresh, and the conservation
  accounting all stay on one thread, fed by an event queue the workers
  post to. The fleet's invariants survive concurrency: every rid retires
  exactly once fleet-wide, serving never records a programming event
  outside a refresh, and the SLO windows keep covering outages.
* **Backpressure** (:class:`AdmissionQueue`): ``submit``/``submit_stream``
  measure fleet-wide queued work against ``AsyncConfig.queue_cap`` and
  either block until capacity frees or shed with :class:`QueueFull`,
  per ``AsyncConfig.shed_policy``.
* **Streaming** (:class:`TokenStream`): tokens reach the caller per
  request as the owning chip emits them (the engine's ``on_token`` hook),
  not only in the final report. Eviction does *not* close a stream --
  migration is invisible to the consumer, who sees the bit-identical
  stitched sequence the final
  :class:`~repro_torch.serving.fleet.FleetRecord` carries.
* **Deterministic mode** (``deterministic=True``): the same worker and
  coordinator code driven by a single thread in the synchronous router's
  exact tick order, under an injected
  :class:`~repro_torch.clock.VirtualClock` (each chip's calls still on its
  worker's stream). Chaos tests replay bit-identically;
  ``FleetRouter.run`` is a thin wrapper over this mode.

Cross-stream hand-offs are host values only: evicted tokens, continuation
prompts and the refresh key (built on the host from the router's host key).
A worker's stream first waits for the work enqueued before the session
(the chips' programs, the engines' setup), and the caller's stream waits
for every worker's at the end.
"""

from __future__ import annotations

import contextlib
import queue as queue_lib
import threading
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import clock as clock_lib
from repro_torch import prng
from repro_torch.core import engine as engine_mod
from repro_torch.serving.config import AsyncConfig, DriftPolicy, FleetConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.fleet import FleetRecord, FleetReport, FleetRouter
from repro_torch.serving.requests import Request
from repro_torch.serving.scheduler import BucketedScheduler, ContinuousScheduler


class QueueFull(RuntimeError):
    """Backpressure verdict: the fleet's queued work is at cap and the
    policy said shed (or a blocking submit timed out)."""


class TokenStream:
    """Per-request token delivery: iterate to receive tokens as the fleet
    emits them; iteration ends when the request retires.

    The producer side is the owning chip's worker thread (via the
    engine's ``on_token``/``on_retire`` hooks); the consumer is any
    caller thread. Migration never closes a stream -- eviction is not
    retirement -- so a consumer sees one uninterrupted sequence equal to
    the request's stitched fleet record. After the stream is ``done``,
    ``record`` holds the retiring chip's
    :class:`~repro_torch.serving.requests.RequestRecord`.
    """

    def __init__(self, rid: int):
        self.rid = rid
        self.record = None
        self._cond = threading.Condition()
        self._toks: list[int] = []
        self._read = 0
        self._done = False

    # producer side (worker threads) --------------------------------------
    def _push(self, tok: int) -> None:
        with self._cond:
            self._toks.append(int(tok))
            self._cond.notify_all()

    def _close(self, record=None) -> None:
        with self._cond:
            self._done = True
            self.record = record
            self._cond.notify_all()

    # consumer side --------------------------------------------------------
    @property
    def done(self) -> bool:
        """The request retired: no more tokens will arrive (already
        emitted ones remain iterable)."""
        with self._cond:
            return self._done

    def tokens(self) -> list[int]:
        """Snapshot of everything emitted so far (does not consume)."""
        with self._cond:
            return list(self._toks)

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> int:
        with self._cond:
            while self._read >= len(self._toks) and not self._done:
                self._cond.wait(0.05)
            if self._read < len(self._toks):
                tok = self._toks[self._read]
                self._read += 1
                return tok
            raise StopIteration


class AdmissionQueue:
    """Bounded fleet-wide intake; backpressure happens here.

    ``put`` accepts a request while ``len(queue) + external_work()`` is
    below ``cap``; at cap the ``"shed"`` policy raises
    :class:`QueueFull` immediately and the ``"block"`` policy waits for
    capacity (bounded by ``timeout_s`` when set). ``external_work``
    counts accepted-but-unadmitted work beyond this queue -- the chips'
    engine queues plus dispatched-but-unprocessed submissions.
    """

    def __init__(
        self,
        cap: int,
        policy: str,
        *,
        timeout_s: Optional[float] = None,
        now_fn=None,
    ):
        self.cap = cap
        self.policy = policy
        self.timeout_s = timeout_s
        self.now_fn = now_fn or clock_lib.SYSTEM.now
        self._cond = threading.Condition()
        self._items: deque[Request] = deque()
        self.accepted = 0
        self.shed = 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def put(self, req: Request, external_work) -> None:
        with self._cond:
            if len(self._items) + external_work() < self.cap:
                self._items.append(req)
                self.accepted += 1
                return
            if self.policy == "shed":
                self.shed += 1
                raise QueueFull(
                    f"request {req.rid}: fleet queued work is at "
                    f"cap={self.cap} and the policy is 'shed'"
                )
            start = self.now_fn()
            while len(self._items) + external_work() >= self.cap:
                if (
                    self.timeout_s is not None
                    and self.now_fn() - start >= self.timeout_s
                ):
                    self.shed += 1
                    raise QueueFull(
                        f"request {req.rid}: blocked submit waited "
                        f"{self.timeout_s}s at cap={self.cap}"
                    )
                self._cond.wait(0.005)
            self._items.append(req)
            self.accepted += 1

    def drain(self) -> list[Request]:
        with self._cond:
            items = list(self._items)
            self._items.clear()
            self._cond.notify_all()  # capacity freed: wake blocked submits
            return items


class _ChipWorker:
    """Exclusive owner of one or more chips' ``EngineRun``s.

    Every EngineRun mutation in this module happens in a method of this
    class (the RL006 actor discipline). In threaded mode each worker's
    :meth:`loop` runs on its own thread, pumping the coordinator's
    per-chip command queues between decode ticks; in deterministic mode
    the single driving thread calls the same methods directly, so both
    modes execute identical chip-side code. On a card the worker owns one
    CUDA stream, and every owner-side method runs under it.
    """

    def __init__(self, core: "_FleetCore", chips: list[int], device: torch.device):
        self.core = core
        self.chips = list(chips)
        self.paused = {c: False for c in chips}
        self._cmds: dict[int, queue_lib.SimpleQueue] = {
            c: queue_lib.SimpleQueue() for c in chips
        }
        self.thread: Optional[threading.Thread] = None
        self.stream = None
        if device.type == "cuda":
            # created on the coordinator's thread: it first waits for what
            # the caller enqueued before the session (programs, engines)
            self.stream = torch.cuda.Stream(device)
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def on_stream(self):
        """Context that makes this worker's stream current (no-op off a card)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def join_stream(self) -> None:
        """Make the calling thread's stream wait for this worker's."""
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)

    # coordinator side -----------------------------------------------------
    def enqueue(self, c: int, cmd: tuple) -> None:
        self._cmds[c].put(cmd)

    # owner side -----------------------------------------------------------
    def tick_chip(self, c: int) -> bool:
        """One admit+decode tick -- the exact per-chip step of the
        synchronous router loop. Returns whether the chip decoded."""
        run = self.core.runs[c]
        with self.on_stream():
            run.admit_arrived()
            if run.n_active:
                run.decode_step()
                return True
        return False

    def submit_now(self, c: int, reqs: list[Request]) -> None:
        self.core.runs[c].submit(reqs)

    def refresh_now(self, c: int, key) -> int:
        with self.on_stream():
            return self.core.runs[c].refresh_chip(key)

    def drain_now(self, c: int) -> tuple[list, list]:
        """Evict every live slot (capturing its admission time for the
        first-token carry-through) and empty the chip's queue."""
        run = self.core.runs[c]
        evicted = []
        with self.on_stream():
            for slot, req, tokens in run.live():
                admit_t = run.slots[slot].admit_t
                run.evict(slot)
                evicted.append((req, tokens, admit_t))
        requeued = []
        while run.queue:
            requeued.append(run.queue.popleft())
        return evicted, requeued

    def _pump_cmds(self, c: int) -> None:
        core = self.core
        while True:
            try:
                cmd = self._cmds[c].get_nowait()
            except queue_lib.Empty:
                return
            kind = cmd[0]
            if kind == "submit":
                self.submit_now(c, cmd[1])
                with core.lock:
                    core.pending_submits[c] -= len(cmd[1])
            elif kind == "drain":
                evicted, requeued = self.drain_now(c)
                self.paused[c] = True
                core.events_q.put(("drained", c, evicted, requeued, cmd[1], cmd[2]))
            elif kind == "refresh":
                consumed = self.refresh_now(c, cmd[1])
                run = core.runs[c]
                self.paused[c] = False
                core.events_q.put(
                    ("rejoined", c, consumed, (run.agree_sum, run.decisions))
                )

    def loop(self) -> None:
        """Thread target: pump commands, tick owned chips, idle-poll."""
        core = self.core
        try:
            with self.on_stream():
                while not core.stop_flag.is_set():
                    progressed = False
                    for c in self.chips:
                        self._pump_cmds(c)
                        if self.paused[c]:
                            continue
                        progressed |= self.tick_chip(c)
                    if not progressed:
                        core.clock.sleep(core.async_cfg.poll_s)
        except BaseException as e:  # propagate to the coordinator
            core.worker_error = e
            core.stop_flag.set()


class _FleetCore:
    """One serving session's coordinator state (either mode).

    Holds everything the synchronous router loop used to keep in locals:
    the runs, the down/draining bookkeeping, migration prefixes, health
    windows, the event log, and the conservation inputs. The driving
    methods -- :meth:`drive_deterministic` (single thread, exact
    synchronous tick order) and :meth:`drive_threaded` (coordinator loop
    over live workers) -- share every bookkeeping step; only the
    transport to the chip owners differs (direct call vs command queue).
    """

    def __init__(
        self,
        router: "AsyncFleetRouter",
        requests: list[Request],
        *,
        scheduler: Any,
        policies: list[Optional[DriftPolicy]],
        force_refresh: dict[int, int],
        clock: clock_lib.Clock,
        max_ticks: Optional[int],
        threaded: bool,
    ):
        cfg = router.fleet_cfg
        n = cfg.n_chips
        self.router = router
        self.cfg = cfg
        self.async_cfg = router.async_cfg
        self.n = n
        self.clock = clock
        self.max_ticks = max_ticks
        self.threaded = threaded
        self.force_refresh = dict(force_refresh)
        self.deferred: dict[int, int] = {}  # tick -> chip, re-queued drains

        self.lock = threading.Lock()
        self.stop_flag = threading.Event()
        self.worker_error: Optional[BaseException] = None
        self.events_q: queue_lib.SimpleQueue = queue_lib.SimpleQueue()
        self.pending_submits = [0] * n
        self.n_retired = 0

        self.events0 = engine_mod.program_event_count()
        self.allowed_events = 0
        self.t0 = clock.now()

        workers = self.async_cfg.workers or n
        w_count = min(workers, n)
        self.workers = [
            _ChipWorker(self, [c for c in range(n) if c % w_count == w],
                        router.engines[0].device)
            for w in range(w_count)
        ]
        self.worker_of: list[_ChipWorker] = [None] * n  # type: ignore
        for w in self.workers:
            for c in w.chips:
                self.worker_of[c] = w

        self.runs = []
        for c, e in enumerate(router.engines):
            # a run's caches are allocated on its owner's stream
            with self.worker_of[c].on_stream():
                self.runs.append(e.start_run(
                    scheduler=scheduler,
                    drift_policy=policies[c],
                    clock=clock,
                    track_events=False,  # the coordinator accounts fleet-wide
                    on_token=router._make_on_token(),
                    on_retire=self._make_on_retire(),
                ))
        self.pending = deque(sorted(requests, key=lambda r: r.arrival_t))
        self.accepted: list[Request] = list(requests)
        self.down = [0] * n  # ticks left out of rotation (0 = serving)
        self.draining: set[int] = set()  # threaded: drain/refresh in flight
        self.prefix: dict[int, list[int]] = {}  # rid -> tokens pre-migration
        self.chips_of: dict[int, list[int]] = {r.rid: [] for r in requests}
        self.base_agree = [0.0] * n
        self.base_dec = [0] * n
        self.health: list[Optional[float]] = [None] * n
        self.events: list[dict] = []
        self.windows: list[dict] = []
        self.window_saw_down = False
        self.ticks = 0
        # batch mode closes at quiescence; an open streaming session
        # (start()/join()) clears this until join
        self.closing = True

    def _make_on_retire(self):
        router = self.router

        def on_retire(rec):
            with self.lock:
                self.n_retired += 1
            stream = router._stream(rec.rid)
            if stream is not None:
                stream._close(rec)

        return on_retire

    # -- dispatch ----------------------------------------------------------

    def _n_down(self) -> int:
        return sum(
            1 for c in range(self.n) if self.down[c] or c in self.draining
        )

    def load(self, c: int) -> int:
        return (
            self.runs[c].n_active
            + len(self.runs[c].queue)
            + self.pending_submits[c]
        )

    def queued_work(self) -> int:
        """Accepted-but-unadmitted work beyond the admission queue."""
        with self.lock:
            ps = sum(self.pending_submits)
        return sum(len(r.queue) for r in self.runs) + ps + len(self.pending)

    def pick_chip(self, exclude: Optional[int] = None) -> int:
        cfg = self.cfg
        up = [
            c for c in range(self.n)
            if not self.down[c] and c not in self.draining and c != exclude
        ]
        if not up:
            raise RuntimeError(
                "no chip available for dispatch -- max_refreshing "
                "must leave at least one chip serving"
            )
        ok = [
            c for c in up
            if cfg.agreement_slo is None
            or self.health[c] is None
            or self.health[c] >= cfg.agreement_slo
        ]
        pool = ok or up  # never deadlock traffic on the SLO
        return min(pool, key=lambda c: (self.load(c), c))

    def dispatch(self, req: Request, exclude: Optional[int] = None) -> int:
        c = self.pick_chip(exclude)
        self.chips_of.setdefault(req.rid, []).append(c)
        if self.threaded:
            with self.lock:
                self.pending_submits[c] += 1
            self.worker_of[c].enqueue(c, ("submit", [req]))
        else:
            self.worker_of[c].submit_now(c, [req])
        return c

    # -- drain / migrate / rejoin -----------------------------------------

    def _migrate(self, c: int, evicted: list, requeued: list) -> int:
        """Turn a drained chip's work into sibling dispatches.

        Live slots become lossless continuations: the generated stream so
        far becomes prompt suffix, the budget shrinks by what was already
        produced, and -- the latency bookkeeping -- the continuation keeps
        the request's ORIGINAL ``arrival_t`` (migration is not a new
        arrival) and carries the first chip's first-token time, so the
        retiring record's ``latency_s``/``ttft_s`` span every chip.
        """
        migrated = 0
        for req, tokens, admit_t in evicted:
            self.prefix.setdefault(req.rid, []).extend(tokens)
            cont = Request(
                rid=req.rid,
                prompt=np.concatenate(
                    [req.prompt, np.asarray(tokens, np.int32)]
                ),
                max_new_tokens=req.max_new_tokens - len(tokens),
                eos_id=req.eos_id,
                arrival_t=req.arrival_t,
                features=req.features,
                first_token_t=(
                    req.first_token_t
                    if req.first_token_t is not None
                    else admit_t
                ),
            )
            self.dispatch(cont, exclude=c)
            migrated += 1
        for req in requeued:
            # queued-but-unadmitted requests re-dispatch unchanged
            self.chips_of[req.rid].remove(c)
            self.dispatch(req, exclude=c)
            migrated += 1
        return migrated

    def drain(self, c: int, trigger: str, top1) -> None:
        cfg = self.cfg
        self.window_saw_down = True  # even a refresh_steps=0 blink counts
        if self.threaded:
            self.draining.add(c)
            self.worker_of[c].enqueue(c, ("drain", trigger, top1))
            if cfg.refresh_steps == 0:
                self._send_refresh(c)
            else:
                self.down[c] = cfg.refresh_steps
            return
        evicted, requeued = self.worker_of[c].drain_now(c)
        migrated = self._migrate(c, evicted, requeued)
        self.events.append(
            {
                "kind": "drain", "tick": self.ticks, "chip": c,
                "trigger": trigger, "top1": top1, "migrated": migrated,
            }
        )
        if cfg.refresh_steps == 0:
            self._rejoin_sync(c)
        else:
            self.down[c] = cfg.refresh_steps

    def _refresh_key(self, c: int):
        # on the host (the router keeps its key there): the worker gets a
        # host value, never a tensor of the coordinator's stream
        return prng.fold_in(
            prng.fold_in(self.router.rng, 8_000_000 + self.ticks), c
        )

    def _send_refresh(self, c: int) -> None:
        self.worker_of[c].enqueue(c, ("refresh", self._refresh_key(c)))

    def _rejoin_bookkeeping(self, c: int, consumed: int, agree, dec) -> None:
        # the chip returns with a clean slate: its degradation window
        # described the OLD programming
        self.allowed_events += consumed
        self.base_agree[c] = agree
        self.base_dec[c] = dec
        self.health[c] = None
        self.events.append(
            {
                "kind": "reprogram", "tick": self.ticks, "chip": c,
                "t_device": self.router.engines[c].program.t_seconds,
            }
        )

    def _rejoin_sync(self, c: int) -> None:
        consumed = self.worker_of[c].refresh_now(c, self._refresh_key(c))
        self._rejoin_bookkeeping(
            c, consumed, self.runs[c].agree_sum, self.runs[c].decisions
        )

    # -- shared per-tick bookkeeping ---------------------------------------

    def _tick_down_counters(self) -> None:
        """The write-latency clock runs on coordinator ticks, progress or
        not -- a down chip must eventually rejoin."""
        for c in range(self.n):
            if self.down[c]:
                self.down[c] -= 1
                if self.down[c] == 0:
                    if self.threaded:
                        self._send_refresh(c)
                    else:
                        self._rejoin_sync(c)

    def _tick_forced_refresh(self) -> None:
        """Fire (or re-queue) this tick's forced drain.

        A forced refresh that cannot fire -- its chip is already down or
        the stagger cap is saturated -- is deferred to the next tick with
        no entry rather than silently dropped, and the run does not end
        while a deferral is outstanding.
        """
        c = self.deferred.pop(self.ticks, None)
        if c is None:
            c = self.force_refresh.pop(self.ticks, None)
        if c is None:
            return
        if (
            not self.down[c]
            and c not in self.draining
            and self._n_down() < self.cfg.max_refreshing
        ):
            self.drain(c, "forced", None)
        else:
            t = self.ticks + 1
            while t in self.deferred or t in self.force_refresh:
                t += 1
            self.deferred[t] = c

    def _health_check(self) -> None:
        cfg = self.cfg
        win_agree, win_dec = 0.0, 0
        tops: list[tuple[int, float]] = []
        for c in range(self.n):
            agree, dec = self.runs[c].agree_sum, self.runs[c].decisions
            wa = agree - self.base_agree[c]
            wd = dec - self.base_dec[c]
            self.base_agree[c] = agree
            self.base_dec[c] = dec
            win_agree += wa
            win_dec += wd
            if wd > 0:
                self.health[c] = wa / wd
                if not self.down[c] and c not in self.draining:
                    tops.append((c, wa / wd))
        if win_dec > 0:
            self.windows.append(
                {
                    "tick": self.ticks,
                    "top1": win_agree / win_dec,
                    "decisions": win_dec,
                    "any_down": self.window_saw_down,
                }
            )
        self.window_saw_down = any(self.down) or bool(self.draining)
        if cfg.refresh_below is not None:
            # worst chip first; stagger: never exceed the down cap
            for c, top1 in sorted(tops, key=lambda t: t[1]):
                if top1 >= cfg.refresh_below:
                    break
                if self._n_down() >= cfg.max_refreshing:
                    break
                self.drain(c, "agreement", top1)

    def _check_max_ticks(self) -> None:
        if self.max_ticks is not None and self.ticks >= self.max_ticks:
            raise RuntimeError(
                f"fleet run exceeded max_ticks={self.max_ticks} with "
                f"{len(self.pending)} pending and "
                f"{sum(r.n_active for r in self.runs)} live requests"
            )

    # -- drivers -----------------------------------------------------------

    def drive_deterministic(self) -> None:
        """Single-threaded driver: the synchronous router's exact tick
        order (dispatch, per-chip admit+decode, down clocks, forced
        refresh, health window, idle wait) over the same worker code the
        threads run."""
        n = self.n
        while (
            self.pending
            or any(r.has_work for r in self.runs)
            or any(self.down)
            or self.deferred
        ):
            now = self.clock.now() - self.t0
            while self.pending and self.pending[0].arrival_t <= now:
                self.dispatch(self.pending.popleft())

            progressed = False
            for c in range(n):
                if self.down[c]:
                    continue
                if self.worker_of[c].tick_chip(c):
                    progressed = True
            self.ticks += 1

            self._tick_down_counters()
            self._tick_forced_refresh()
            if any(self.down):
                self.window_saw_down = True
            if self.ticks % self.cfg.check_every == 0:
                self._health_check()

            if not progressed and self.pending and not any(self.down):
                wait = self.pending[0].arrival_t - (self.clock.now() - self.t0)
                self.clock.sleep(max(min(wait, 0.01), 1e-4))
            self._check_max_ticks()

    def _pump_events(self) -> None:
        while True:
            try:
                ev = self.events_q.get_nowait()
            except queue_lib.Empty:
                return
            if ev[0] == "drained":
                _, c, evicted, requeued, trigger, top1 = ev
                migrated = self._migrate(c, evicted, requeued)
                self.events.append(
                    {
                        "kind": "drain", "tick": self.ticks, "chip": c,
                        "trigger": trigger, "top1": top1,
                        "migrated": migrated,
                    }
                )
            elif ev[0] == "rejoined":
                _, c, consumed, (agree, dec) = ev
                self._rejoin_bookkeeping(c, consumed, agree, dec)
                self.draining.discard(c)

    def intake(self, req: Request) -> None:
        """Coordinator-side acceptance of a live submission."""
        self.accepted.append(req)
        self.chips_of.setdefault(req.rid, [])
        merged = sorted(
            list(self.pending) + [req], key=lambda r: r.arrival_t
        )
        self.pending = deque(merged)

    def quiescent(self) -> bool:
        with self.lock:
            ps = sum(self.pending_submits)
            retired = self.n_retired
        return (
            not self.pending
            and ps == 0
            and retired == len(self.accepted)
            and not any(self.down)
            and not self.draining
            and not self.deferred
            and self.events_q.empty()
        )

    def drive_threaded(self, admission: AdmissionQueue) -> None:
        """Coordinator loop over live workers: intake, dispatch, down
        clocks, forced refresh, health windows -- the chips decode on
        their own threads the whole time."""
        for w in self.workers:
            w.thread = threading.Thread(target=w.loop, daemon=True)
            w.thread.start()
        try:
            while True:
                if self.worker_error is not None:
                    raise self.worker_error
                self._pump_events()
                for req in admission.drain():
                    self.intake(req)
                now = self.clock.now() - self.t0
                while self.pending and self.pending[0].arrival_t <= now:
                    self.dispatch(self.pending.popleft())
                self.ticks += 1

                self._tick_down_counters()
                self._tick_forced_refresh()
                if any(self.down) or self.draining:
                    self.window_saw_down = True
                if self.ticks % self.cfg.check_every == 0:
                    self._health_check()

                if self.closing and len(admission) == 0 and self.quiescent():
                    break
                self._check_max_ticks()
                self.clock.sleep(self.async_cfg.poll_s)
        finally:
            self.stop_flag.set()
            for w in self.workers:
                if w.thread is not None:
                    w.thread.join()
        self._pump_events()

    # -- finalize ----------------------------------------------------------

    def finalize(self) -> FleetReport:
        """Conservation checks + the stitched fleet report (the exact
        accounting the synchronous router did)."""
        for w in self.workers:
            w.join_stream()
        requests = self.accepted
        rids = [r.rid for r in requests]
        per_chip = [r.finish() for r in self.runs]

        # conservation: every submitted request retired exactly once,
        # fleet-wide -- migration must neither lose nor duplicate
        seen: dict[int, Any] = {}
        for rep in per_chip:
            for rec in rep.records:
                if rec.rid in seen:
                    raise RuntimeError(
                        f"request {rec.rid} retired on more than one chip "
                        "-- migration duplicated it"
                    )
                seen[rec.rid] = rec
        lost = sorted(set(rids) - set(seen))
        if lost:
            raise RuntimeError(
                f"requests {lost} were admitted but never retired -- "
                "migration lost them"
            )

        by_rid = {r.rid: r for r in requests}
        records = []
        for rid in rids:
            rec = seen[rid]
            toks = self.prefix.get(rid, []) + list(np.asarray(rec.tokens))
            records.append(
                FleetRecord(
                    rid=rid,
                    tokens=np.asarray(toks, np.int32),
                    n_prompt=int(by_rid[rid].prompt.size),
                    chips=tuple(self.chips_of[rid]),
                    arrival_t=by_rid[rid].arrival_t,
                    finish_t=rec.finish_t,
                    finished_by=rec.finished_by,
                    first_token_t=rec.admit_t,
                )
            )

        delta = engine_mod.program_event_count() - self.events0
        if delta != self.allowed_events:
            raise RuntimeError(
                f"fleet run recorded {delta} programming events but "
                f"refreshes account for {self.allowed_events} -- serving "
                "must never rewrite a chip outside a router-driven refresh"
            )
        counters = None
        if self.router.engines[0]._ref:
            agree = sum(r.agree_sum for r in self.runs)
            dec = sum(r.decisions for r in self.runs)
            counters = {
                "top1": agree / max(dec, 1),
                "decisions": dec,
            }
        return FleetReport(
            records=records,
            per_chip=per_chip,
            events=self.events,
            windows=self.windows,
            counters=counters,
            n_chips=self.n,
            n_ticks=self.ticks,
            wall=self.clock.now() - self.t0,
            program_events_delta=delta - self.allowed_events,
        )


class AsyncFleetRouter(FleetRouter):
    """Threaded (or deterministic single-threaded) front end over a fleet.

    Construction mirrors :class:`~repro_torch.serving.fleet.FleetRouter`
    (same ``build``/``from_program`` classmethods) plus an
    :class:`~repro_torch.serving.config.AsyncConfig`. Two ways to serve:

    * **Batch**: :meth:`serve` takes a request list and returns the
      :class:`~repro_torch.serving.fleet.FleetReport` -- threaded by default,
      bit-reproducible with ``deterministic=True`` under a virtual clock.
    * **Streaming session**: :meth:`start`, then :meth:`submit` /
      :meth:`submit_stream` (backpressured per the config), then
      :meth:`join` for the final report.
    """

    def __init__(
        self,
        engines: list[ServingEngine],
        fleet_cfg: FleetConfig,
        async_cfg: Optional[AsyncConfig] = None,
        *,
        rng: Optional[torch.Tensor] = None,
        deterministic: bool = False,
    ):
        super().__init__(engines, fleet_cfg, rng=rng)
        self.async_cfg = async_cfg or AsyncConfig()
        self.deterministic = deterministic
        self._streams: dict[int, TokenStream] = {}
        self._streams_lock = threading.Lock()
        self._core: Optional[_FleetCore] = None
        self._admission: Optional[AdmissionQueue] = None
        self._coord: Optional[threading.Thread] = None
        self._coord_error: Optional[BaseException] = None
        self._session_kwargs: Optional[dict] = None
        self._inbox: list[Request] = []
        self._seen_rids: set[int] = set()

    # -- streaming plumbing -------------------------------------------------

    def _stream(self, rid: int) -> Optional[TokenStream]:
        with self._streams_lock:
            return self._streams.get(rid)

    def _make_on_token(self):
        def on_token(rid, tok):
            stream = self._stream(rid)
            if stream is not None:
                stream._push(tok)

        return on_token

    # -- validation ---------------------------------------------------------

    def _resolve_policies(
        self, drift_policies
    ) -> list[Optional[DriftPolicy]]:
        n = self.fleet_cfg.n_chips
        if drift_policies is None:
            policies: list[Optional[DriftPolicy]] = [None] * n
        elif isinstance(drift_policies, DriftPolicy):
            policies = [drift_policies] * n
        else:
            policies = list(drift_policies)
            if len(policies) != n:
                raise ValueError(
                    f"need one drift policy per chip ({n}), "
                    f"got {len(policies)}"
                )
        for p in policies:
            if p is not None and p.refresh_below is not None:
                raise ValueError(
                    "per-chip DriftPolicy.refresh_below is engine-local "
                    "(it rewrites mid-flight); fleet refresh must drain "
                    "and migrate -- set FleetConfig.refresh_below instead"
                )
        return policies

    def _validate_refresh(self, force_refresh: dict[int, int]) -> None:
        cfg = self.fleet_cfg
        if force_refresh and cfg.max_refreshing >= cfg.n_chips:
            raise ValueError(
                f"force_refresh with max_refreshing={cfg.max_refreshing} "
                f">= n_chips={cfg.n_chips} could drain the last serving "
                "chip mid-flight -- max_refreshing must leave at least "
                "one chip up"
            )
        refresh_enabled = (
            cfg.refresh_below is not None or bool(force_refresh)
        )
        if refresh_enabled:
            for c, e in enumerate(self.engines):
                if e.program is None or e.src_params is None:
                    raise ValueError(
                        f"chip {c}: refresh needs a compiled program and "
                        "src_params on every engine"
                    )
        if cfg.refresh_below is not None and not self.engines[0]._ref:
            raise ValueError(
                "the agreement refresh trigger needs the reference "
                "counters: build the engines with ref_params (and "
                "ref_check on)"
            )

    def _default_scheduler(self, scheduler):
        if scheduler is not None:
            return scheduler
        return (
            BucketedScheduler()
            if self.engines[0].paged
            else ContinuousScheduler()
        )

    def _validate_fits(self, req: Request) -> None:
        eng = self.engines[0]
        if req.prompt.size + req.max_new_tokens > eng.s_max:
            raise ValueError(
                f"request {req.rid}: prompt ({req.prompt.size}) + budget "
                f"({req.max_new_tokens}) exceeds the fleet's s_max="
                f"{eng.s_max}"
            )

    # -- batch serving ------------------------------------------------------

    def serve(
        self,
        requests: list[Request],
        *,
        scheduler: Any = None,
        drift_policies: Optional[list[Optional[DriftPolicy]]] = None,
        force_refresh: Optional[dict[int, int]] = None,
        clock: Optional[clock_lib.Clock] = None,
        max_ticks: Optional[int] = None,
        deterministic: Optional[bool] = None,
    ) -> FleetReport:
        """Serve ``requests`` across the fleet to completion.

        ``deterministic=None`` takes the router's construction-time mode.
        ``force_refresh`` maps coordinator tick -> chip index to drain at
        that tick regardless of agreement (the chaos hook); a forced
        drain that cannot fire yet (chip already down, stagger cap
        saturated) is re-queued to the next eligible tick.
        """
        if self._core is not None or self._session_kwargs is not None:
            raise RuntimeError(
                "serve() cannot run during an open start()/join() session"
            )
        deterministic = (
            self.deterministic if deterministic is None else deterministic
        )
        clock = clock or clock_lib.SYSTEM
        force_refresh = dict(force_refresh or {})
        policies = self._resolve_policies(drift_policies)
        self._validate_refresh(force_refresh)
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request rids must be unique fleet-wide")

        core = _FleetCore(
            self,
            requests,
            scheduler=self._default_scheduler(scheduler),
            policies=policies,
            force_refresh=force_refresh,
            clock=clock,
            max_ticks=max_ticks,
            threaded=not deterministic,
        )
        if deterministic:
            core.drive_deterministic()
        else:
            admission = AdmissionQueue(
                self.async_cfg.queue_cap,
                self.async_cfg.shed_policy,
                timeout_s=self.async_cfg.submit_timeout_s,
                now_fn=clock.now,
            )
            core.drive_threaded(admission)
        return core.finalize()

    # -- streaming session --------------------------------------------------

    def start(
        self,
        *,
        scheduler: Any = None,
        drift_policies: Optional[list[Optional[DriftPolicy]]] = None,
        clock: Optional[clock_lib.Clock] = None,
        max_ticks: Optional[int] = None,
    ) -> None:
        """Open a streaming session: requests enter via :meth:`submit` /
        :meth:`submit_stream`, :meth:`join` closes it.

        In threaded mode the workers and the coordinator launch here and
        serve live; in deterministic mode submissions accumulate and
        :meth:`join` drives the whole session single-threaded (streams
        fill during the drive and read back afterwards).
        """
        if self._core is not None or self._session_kwargs is not None:
            raise RuntimeError("a session is already open")
        clock = clock or clock_lib.SYSTEM
        policies = self._resolve_policies(drift_policies)
        self._validate_refresh({})
        self._seen_rids = set()
        self._inbox = []
        self._coord_error = None
        kwargs = dict(
            scheduler=self._default_scheduler(scheduler),
            policies=policies,
            clock=clock,
            max_ticks=max_ticks,
        )
        self._admission = AdmissionQueue(
            self.async_cfg.queue_cap,
            self.async_cfg.shed_policy,
            timeout_s=self.async_cfg.submit_timeout_s,
            now_fn=clock.now,
        )
        if self.deterministic:
            self._session_kwargs = kwargs
            return
        core = _FleetCore(
            self, [], force_refresh={}, threaded=True, **kwargs
        )
        core.closing = False
        self._core = core

        def coordinate():
            try:
                core.drive_threaded(self._admission)
            except BaseException as e:
                self._coord_error = e
                core.stop_flag.set()

        self._coord = threading.Thread(target=coordinate, daemon=True)
        self._coord.start()

    def submit(self, req: Request) -> None:
        """Accept one request, applying backpressure at the queue cap
        (block or shed per the config)."""
        if self._admission is None:
            raise RuntimeError("no open session -- call start() first")
        if req.rid in self._seen_rids:
            raise ValueError("request rids must be unique fleet-wide")
        self._validate_fits(req)
        if self.deterministic:
            work = len(self._inbox)
            if work >= self.async_cfg.queue_cap:
                if self.async_cfg.shed_policy == "shed":
                    self._admission.shed += 1
                    raise QueueFull(
                        f"request {req.rid}: fleet queued work is at "
                        f"cap={self.async_cfg.queue_cap} and the policy "
                        "is 'shed'"
                    )
            self._inbox.append(req)
            self._seen_rids.add(req.rid)
            return
        core = self._core
        self._admission.put(req, core.queued_work)
        self._seen_rids.add(req.rid)

    def submit_stream(self, req: Request) -> TokenStream:
        """:meth:`submit` plus a live :class:`TokenStream` for the
        request's generation."""
        stream = TokenStream(req.rid)
        with self._streams_lock:
            self._streams[req.rid] = stream
        try:
            self.submit(req)
        except BaseException:
            with self._streams_lock:
                self._streams.pop(req.rid, None)
            raise
        return stream

    def join(self) -> FleetReport:
        """Close the session: serve out everything accepted, stop the
        threads, and return the conservation-checked fleet report."""
        if self._admission is None:
            raise RuntimeError("no open session -- call start() first")
        try:
            if self.deterministic:
                kwargs = self._session_kwargs
                core = _FleetCore(
                    self, list(self._inbox), force_refresh={},
                    threaded=False, **kwargs,
                )
                core.drive_deterministic()
                return core.finalize()
            core = self._core
            core.closing = True
            self._coord.join()
            if self._coord_error is not None:
                raise self._coord_error
            return core.finalize()
        finally:
            self._core = None
            self._admission = None
            self._coord = None
            self._session_kwargs = None
            self._inbox = []
