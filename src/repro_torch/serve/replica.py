"""One replicated BCNN engine stepped on its own thread (counterpart of
``repro/serve/replica.py``).

The fleet tier (``serve/router.py``) scales the paper's §6.3 online-request
scenario *across* engines: N replicas of the streaming ``BCNNEngine``
(``serve/bcnn_engine.py``), each stepped continuously on a dedicated
worker thread, fed by a router that owns admission and scheduling. This
module is the per-replica half of that split:

* **single-owner engine** — the wrapped engine is touched ONLY by the
  replica's worker thread (or, in the deterministic non-threaded mode, by
  whoever calls ``pump()``), so none of the engine's single-driver
  contracts change;
* **ordered work stream** — work items and control commands (weight swaps)
  live in ONE FIFO inbox: a swap executes exactly between engine flushes,
  so every request is served by a well-defined weight epoch and the
  replica can report that epoch with each result;
* **load accounting** — ``load`` counts accepted-but-not-completed
  *images* (a bulk micro-chunk counts its size), the quantity the
  router's least-loaded dispatch compares;
* **epoch stamping** — ``epoch`` starts at the constructor's ``epoch``
  (0 for a seed-fleet replica; the fleet's current weight epoch for one
  spawned by ``serve/autoscale.py``-driven scale-up) and increments per
  executed swap; completion callbacks receive it, which is how the
  router's rolling swap proves "bit-exact logits per weight epoch" under
  live traffic (tests/test_torch_router.py).

Threading contract: ``enqueue``/``request_swap``/``stop`` may be called
from any thread; everything else that touches the engine runs on the
worker thread (``threaded=True``) or inside ``pump()`` (``threaded=False``
— the mode the injected-clock unit tests drive deterministically). On the
card the worker thread makes its engine's device and stream current
(``BCNNEngine.on_stream``) before it steps: each step is one CUDA-graph
replay on that stream, so replicas on one card overlap instead of
serialising their launches.

Death detection (the fault-injection soak hook, tests/test_torch_soak.py):
if the worker crashes — a real exception out of ``_process``, or one
forced by ``inject_fault()`` — the replica marks itself dead (``alive``
False),
conservatively treats every accepted-but-unfinished work item as an
*orphan*, fails pending swap tickets, and reports the orphans through the
``on_death(replica, orphans)`` callback so the router can requeue them
(no request is silently lost) and the autoscaler can respawn capacity
(``serve/autoscale.py`` treats a fleet below ``min_replicas`` as an
immediate, cooldown-exempt scale-up).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable

import numpy as np


def _item_size(item: Any) -> int:
    """Images carried by a work item: 1 for a single ``(H, W, C)`` image,
    k for a ``(k, H, W, C)`` bulk micro-chunk."""
    img = item.image
    return 1 if img.ndim == 3 else int(img.shape[0])


class SwapTicket:
    """Handle for an enqueued weight swap: ``wait()`` blocks until the
    replica thread executed it (or re-raises the failure, e.g. an
    incompatible replacement rejected by ``assert_swap_compatible``)."""

    def __init__(self):
        self._event = threading.Event()
        self._error: BaseException | None = None

    def _resolve(self, error: BaseException | None = None) -> None:
        self._error = error
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> None:
        if not self._event.wait(timeout):
            raise TimeoutError("swap not executed within timeout")
        if self._error is not None:
            raise self._error


class _SwapCmd:
    __slots__ = ("packed", "ticket")

    def __init__(self, packed, ticket: SwapTicket):
        self.packed = packed
        self.ticket = ticket


class EngineReplica:
    """A ``BCNNEngine`` plus its worker thread and FIFO work inbox.

    ``on_done(replica, item, logits, epoch)`` is invoked (on the worker
    thread) once per completed work item — the router uses it to stamp
    completion and resolve the caller's future. ``item`` is whatever
    ``enqueue`` was given; the replica only requires ``item.image`` to be
    the ``(H, W, C)`` float32 array to classify — or, for a co-scheduled
    bulk micro-chunk, a ``(k, H, W, C)`` stack whose completion logits are
    the matching ``(k, n_classes)`` stack. ``epoch`` seeds the weight
    epoch: a replica spawned by a scale-up after N fleet-wide rolling
    swaps starts at N, so its result stamps agree with the rest of the
    fleet.
    """

    def __init__(self, engine, *, replica_id: int = 0, threaded: bool = True,
                 on_done: Callable[["EngineReplica", Any, np.ndarray, int],
                                   None] | None = None,
                 on_death: Callable[["EngineReplica", list], None]
                 | None = None,
                 epoch: int = 0):
        self.engine = engine
        self.id = replica_id
        self.on_done = on_done
        self.on_death = on_death
        self._inbox: deque[Any] = deque()     # work items + _SwapCmds, FIFO
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._inflight = 0                    # accepted images, not completed
        self._served = 0
        self._epoch = epoch
        self._stopping = False
        self._fault = False                   # armed by inject_fault()
        self._dead = False
        self._death_error: BaseException | None = None
        self._threaded = threaded
        self._thread: threading.Thread | None = None
        if threaded:
            self._thread = threading.Thread(
                target=self._loop, name=f"bcnn-replica-{replica_id}",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ api
    @property
    def load(self) -> int:
        """Accepted-but-not-completed images (inbox + in-engine; a bulk
        micro-chunk counts its size). The router's least-loaded dispatch
        key; 0 means fully drained."""
        with self._lock:
            return self._inflight

    @property
    def served(self) -> int:
        """Total images completed over the replica's lifetime."""
        with self._lock:
            return self._served

    @property
    def epoch(self) -> int:
        """Weight epoch: the construction seed (0 for a seed-fleet
        replica), +1 per executed swap."""
        with self._lock:
            return self._epoch

    @property
    def step_cache_size(self) -> int:
        """The engine's captured-step count (contract: stays 1)."""
        return self.engine.step_cache_size

    @property
    def alive(self) -> bool:
        """False once the worker died (crash or ``inject_fault``). A dead
        replica rejects new work; its orphans were already reported via
        ``on_death``."""
        with self._lock:
            return not self._dead

    @property
    def death_error(self) -> BaseException | None:
        return self._death_error

    def inject_fault(self) -> None:
        """Arm a deterministic worker death: the NEXT processing pass
        raises before touching any item — the whole accepted backlog
        becomes the orphan set, exactly the worst-case mid-traffic thread
        death the fault-injection soak tier replays."""
        with self._wake:
            self._fault = True
            self._wake.notify()

    def enqueue(self, item: Any) -> None:
        """Hand one work item (``item.image`` is the input — a single
        ``(H, W, C)`` image or a ``(k, H, W, C)`` bulk micro-chunk) to the
        replica. Thread-safe; the worker picks it up at its next
        iteration."""
        with self._wake:
            if self._stopping or self._dead:
                raise RuntimeError(f"replica {self.id} is "
                                   f"{'dead' if self._dead else 'stopped'}")
            self._inbox.append(item)
            self._inflight += _item_size(item)
            self._wake.notify()

    def request_swap(self, new_packed) -> SwapTicket:
        """Enqueue a weight swap into the FIFO work stream. It executes
        after every item enqueued before it — the router drains the
        replica first, so in the rolling-swap walk the swap runs on an
        idle engine. Returns a ``SwapTicket`` to wait on."""
        ticket = SwapTicket()
        with self._wake:
            if self._stopping or self._dead:
                raise RuntimeError(f"replica {self.id} is "
                                   f"{'dead' if self._dead else 'stopped'}")
            self._inbox.append(_SwapCmd(new_packed, ticket))
            self._wake.notify()
        return ticket

    def stop(self, timeout: float | None = 30.0) -> None:
        """Stop the worker thread after it finishes the remaining inbox,
        then close the engine (its graphs and stream). A worker still
        running at ``timeout`` keeps its engine open."""
        with self._wake:
            self._stopping = True
            self._wake.notify()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return
        self.engine.close()

    def pump(self) -> int:
        """Non-threaded mode: process the whole current inbox on the
        calling thread. Returns the number of work items completed. The
        deterministic sibling of one worker-loop iteration — unit tests
        drive it with injected clocks."""
        if self._threaded:
            raise RuntimeError("pump() is for threaded=False replicas; "
                               "a threaded replica's worker owns the engine")
        with self._lock:
            if self._dead:
                return 0
            items = list(self._inbox)
            self._inbox.clear()
        return self._run(items)

    # ------------------------------------------------------------- internals
    def _loop(self) -> None:
        with self.engine.on_stream():
            self._serve()

    def _serve(self) -> None:
        while True:
            with self._wake:
                while (not self._inbox and not self._stopping
                        and not self._fault):
                    self._wake.wait()
                if self._dead or (not self._inbox and self._stopping):
                    return
                items = list(self._inbox)
                self._inbox.clear()
            self._run(items)
            if self._death_error is not None:
                return                        # worker died; loop ends here

    def _run(self, items: list) -> int:
        """One processing pass with crash containment: a raise out of
        ``_process`` (or the armed ``inject_fault``) kills the worker —
        every accepted-but-unfinished item becomes an orphan handed to
        ``on_death`` for router-side requeue."""
        done: list = []
        try:
            if self._fault:
                raise RuntimeError(
                    f"injected fault: replica {self.id} worker died")
            return self._process(items, done)
        except BaseException as e:
            self._die(e, items, done)
            return len(done)

    def _die(self, error: BaseException, items: list, done: list) -> None:
        done_ids = {id(it) for it in done}
        with self._wake:
            self._dead = True
            leftovers = list(self._inbox)     # raced in after the drain
            self._inbox.clear()
            self._wake.notify_all()
        orphans = []
        for it in list(items) + leftovers:
            if isinstance(it, _SwapCmd):
                if not it.ticket.done:       # executed pre-crash: keep result
                    it.ticket._resolve(RuntimeError(
                        f"replica {self.id} died before the swap: {error!r}"))
            elif id(it) not in done_ids:
                orphans.append(it)
        with self._lock:
            self._inflight -= sum(_item_size(i) for i in orphans)
        self._death_error = error
        self.engine.close()             # a dead replica never steps again
        if self.on_death is not None:
            self.on_death(self, orphans)

    def _process(self, items: list, done: list | None = None) -> int:
        """Run the FIFO item stream: consecutive work items are flushed
        through the engine together (they share steps, exactly like
        co-arriving requests on a lone engine); a swap command forms an
        epoch boundary between flushes."""
        completed = 0
        batch: list = []
        for item in items:
            if isinstance(item, _SwapCmd):
                completed += self._flush(batch, done)
                batch = []
                try:
                    self.engine.swap_packed(item.packed)
                except BaseException as e:   # reject ≠ die: report via ticket
                    item.ticket._resolve(e)
                else:
                    with self._lock:
                        self._epoch += 1
                    item.ticket._resolve()
            else:
                batch.append(item)
        return completed + self._flush(batch, done)

    def _flush(self, batch: list, done: list | None = None) -> int:
        if not batch:
            return 0
        # one engine rid per image; a multi-image chunk fans out into
        # consecutive slot submissions and folds back into stacked logits
        rids: list[tuple[Any, list[int]]] = []
        n_images = 0
        for item in batch:
            img = item.image
            rows = img if img.ndim == 4 else img[None]
            rids.append((item, [self.engine.submit(r) for r in rows]))
            n_images += len(rows)
        out = self.engine.run()
        epoch = self._epoch
        with self._lock:
            self._inflight -= n_images
            self._served += n_images
        if self.on_done is not None:
            for item, item_rids in rids:
                logits = (out[item_rids[0]] if item.image.ndim == 3
                          else np.stack([out[r] for r in item_rids]))
                self.on_done(self, item, logits, epoch)
                if done is not None:
                    done.append(item)
        elif done is not None:
            done.extend(item for item, _ in rids)
        return len(batch)
