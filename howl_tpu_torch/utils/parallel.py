"""Host-side ETL worker pools.

The reference parallelizes its offline ETL through ``multiprocessing.Pool``
(ref: howl/data/dataset/dataset_writer.py:97-100 clip re-encode,
howl/data/dataset/dataset.py:175-194 dataset statistics,
howl/dataset/aligned_audio_dataset_generator.py:98-116 TextGrid ingestion),
all sized by ``SETTINGS.resource.cpu_count``. This module provides the same
capability with two deliberate differences:

  * ``thread`` mode (the default) uses a thread pool: audio decode/encode is
    stdlib ``wave`` + numpy + scipy whose hot loops release the GIL, and a
    thread pool is safe in a process that has already initialized CUDA —
    ``fork`` after device init is not.
  * ``process`` mode uses a SPAWN-context process pool (never fork) for
    pure-Python CPU-bound work (TextGrid parsing). Spawn starts a fresh
    interpreter, so it is also safe after CUDA init; workers must receive a
    picklable module-level callable.

Results are always returned in input order, so parallel and sequential runs
produce bit-identical downstream artifacts (the golden ETL tests assert this).
"""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def resolve_num_workers(num_workers: Optional[int] = None) -> int:
    """None -> SETTINGS.resource.cpu_count (ref howl/settings.py:9-12)."""
    if num_workers is not None:
        return max(int(num_workers), 1)
    from howl_tpu_torch.settings import SETTINGS

    return max(int(SETTINGS.resource.cpu_count), 1)


def parallel_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    num_workers: Optional[int] = None,
    mode: str = "thread",
) -> List[R]:
    """Ordered map over ``items`` with up to ``num_workers`` workers.

    Falls back to a plain loop when one worker (the container default on this
    1-CPU host) or fewer than two items — same results, no pool overhead.
    """
    items = items if isinstance(items, Sequence) else list(items)
    workers = min(resolve_num_workers(num_workers), max(len(items), 1))
    if workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    if mode == "thread":
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(fn, items))
    if mode == "process":
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        chunksize = max(len(items) // (workers * 4), 1)
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
            return list(ex.map(fn, items, chunksize=chunksize))
    raise ValueError(f"unknown parallel_map mode: {mode!r} (expected 'thread' or 'process')")
