"""Host-side parallel map with retry (role of reference RunCmdsMP.py).

The reference drives everything through multiprocessing pools and shell-job
queues with a retry loop and `.completed` journals (RunCmdsMP.py:38-577).
In this framework the compute runs on device, so the host side only needs a
thread pool for IO-bound work (FASTA parsing, file writing) plus the same
failure-retry semantics for flaky tasks.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from typing import Callable, Iterable, Sequence

from subphaser_torch.utils.log import logger


def ncpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def pool_map(
    fn: Callable,
    items: Sequence,
    workers: int | None = None,
    ordered: bool = True,
):
    """Thread-pool map (IO-bound host work)."""
    workers = workers or ncpus()
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        if ordered:
            return list(ex.map(fn, items))
        futs = [ex.submit(fn, x) for x in items]
        return [f.result() for f in cf.as_completed(futs)]


def run_tasks(
    fn: Callable,
    items: Sequence,
    workers: int | None = None,
    retry: int = 3,
    backoff: float = 1.0,
):
    """Map with per-item retry; only failed items are re-run (the reference's
    run_tasks semantics, RunCmdsMP.py:173-217). Raises after ``retry``
    attempts, listing the failing items."""
    remaining = list(enumerate(items))
    results: dict[int, object] = {}
    last_err: dict[int, Exception] = {}
    for attempt in range(retry):
        if not remaining:
            break
        failed = []

        def one(pair):
            i, x = pair
            try:
                return i, x, fn(x), None
            except Exception as e:  # noqa: BLE001 — retry semantics
                return i, x, None, e

        for i, x, res, err in pool_map(one, remaining, workers):
            if err is None:
                results[i] = res
            else:
                failed.append((i, x))
                last_err[i] = err
        if failed:
            logger.warning(
                "%d/%d tasks failed on attempt %d/%d; retrying",
                len(failed), len(items), attempt + 1, retry,
            )
            time.sleep(backoff * (attempt + 1))
        remaining = failed
    if remaining:
        raise RuntimeError(
            f"{len(remaining)} tasks failed after {retry} attempts: "
            f"{[str(last_err[i]) for i, _ in remaining[:3]]}"
        )
    return [results[i] for i in range(len(items))]
