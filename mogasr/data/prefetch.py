"""Prefetching input pipeline: overlap host work with device compute.

The production input-loading shape for an accelerator pipeline: the host stages the
NEXT batch (audio decode, framing dispatch, optional ``jax.device_put``)
while the device is still busy with the current one.  Python threads are
the right tool here — the host side is IO/NumPy (releases the GIL) and
jax dispatch is async anyway, so a bounded-queue producer thread gives
genuine overlap without processes.

- ``prefetch(iterable, depth)``: order-preserving bounded lookahead; the
  producer thread runs ``depth`` items ahead.  Exceptions raised by the
  producer re-raise at the consumer's ``next()`` — failures are never
  swallowed (tested).
- ``device_put_batches(batches)``: commits each FeatBatch's arrays to the
  default device ahead of use, so the consumer's first op on a batch pays
  no host->device transfer stall.
- ``pipeline.featurize_iter``: the lazy generator the above compose with
  (``featurize`` is ``list(featurize_iter(...))``).

Usage (the eval-sweep shape)::

    batches = prefetch(device_put_batches(featurize_iter(corpus, fcfg, bcfg)))
    metrics = evaluate(batches, gmm, lex, topo, dcfg)   # single pass

No reference implementation exists for this capability (the
/root/reference mount is empty — SURVEY.md §0).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield from ``iterable`` with a background thread running ``depth``
    items ahead.  Order-preserving; producer exceptions re-raise here."""
    if depth <= 0:
        yield from iterable
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def worker():
        try:
            for item in iterable:
                # timed puts so an abandoned consumer (generator closed
                # early) releases this thread instead of pinning it — and
                # the rest of the iterable — forever on a full queue
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            err.append(e)
        finally:
            # the sentinel must arrive reliably (a full queue just means
            # the consumer has not drained yet) — same timed-put loop, so
            # an abandoned consumer still releases this thread via stop
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                t.join()
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def device_put_batches(batches: Iterable) -> Iterator:
    """Commit each FeatBatch's device arrays ahead of consumption."""
    import dataclasses

    import jax

    for fb in batches:
        yield dataclasses.replace(
            fb,
            feats=jax.device_put(fb.feats),
            n_frames=jax.device_put(fb.n_frames),
        )
