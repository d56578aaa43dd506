"""The process group the port's phases 2 and 3 run in (one process a
rank, SPMD): world size and rank, and the steps that keep the ranks in
step over one store.

Every rank calls the same entry point inside the default
``torch.distributed`` group its caller set up; without a group, or in a
group of one, every function here is the single-process behaviour.
:func:`broadcast` hands every rank rank 0's object (a serving tick's
descriptor); :func:`gather` hands every rank every rank's (a tick's
outcome). :func:`on_rank0` runs a step (a store write, phase 1) on rank 0 alone and
makes every rank wait for it, so the next read on any rank sees what rank
0 wrote; :func:`agree` makes every rank raise when the ranks' plans
differ, before a collective that only some of them would enter;
:func:`refuse_in_group` makes a path with no merge across ranks raise
instead of running on one rank's view. The merge itself is
:mod:`repro_torch.core.distributed`'s. This module imports no kernel, so
the engine imports it at module level.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, List, Sequence, Tuple

import torch.distributed as dist


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world_size() -> int:
    """The default process group's size; 1 when no group is up."""
    return dist.get_world_size() if _grouped() else 1


def _rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return dist.get_rank() if _grouped() else 0


# (collective, seconds) of the latest collective calls since the last
# collective_times(reset=True); read by chip_smoke.py, not by the engine
_TIMES: "collections.deque[Tuple[str, float]]" = collections.deque(
    maxlen=4096)


def collective_times(reset: bool = False) -> List[Tuple[str, float]]:
    """``(name, host seconds)`` of each collective this process entered
    since the last reset, in call order (a wait for slower ranks counts
    in)."""
    out = list(_TIMES)
    if reset:
        _TIMES.clear()
    return out


def _timed(name: str, fn: Callable[[], Any]) -> Any:
    t0 = time.perf_counter()
    out = fn()
    _TIMES.append((name, time.perf_counter() - t0))
    return out


def broadcast(obj: Any = None) -> Any:
    """Rank 0's ``obj`` on every rank (picklable; one
    ``broadcast_object_list``); the other ranks' arguments are ignored.
    Without a group of more than one rank, just ``obj``."""
    if _world_size() == 1:
        return obj
    box = [obj if _rank() == 0 else None]
    _timed("broadcast", lambda: dist.broadcast_object_list(box, src=0))
    return box[0]


def gather(obj: Any, name: str = "gather") -> List[Any]:
    """Every rank's ``obj`` (picklable), in rank order, on every rank
    (one all-gather, timed under ``name``). Without a group of more than
    one rank, ``[obj]``."""
    world = _world_size()
    if world == 1:
        return [obj]
    got: List[Any] = [None] * world
    _timed(name, lambda: dist.all_gather_object(got, obj))
    return got


def agree(what: str, fields: Sequence[Any]) -> None:
    """Every rank must pass equal ``fields`` (picklable; one all-gather):
    if any rank's differ, every rank raises ``RuntimeError`` here, before
    a collective that only some of them would enter. A no-op without a
    group of more than one rank."""
    if _world_size() == 1:
        return
    got = gather(list(fields), "agree")
    if any(g != got[0] for g in got):
        raise RuntimeError(
            f"the ranks' {what} differ: "
            + "; ".join(f"rank {r}: {str(g)[:200]}"
                        for r, g in enumerate(got)))


def refuse_in_group(what: str) -> None:
    """Raise inside a group of P > 1 ranks: ``what`` has no merge across
    ranks (every rank would scan and write the store alone), and nothing
    quietly falls back to one rank."""
    world = _world_size()
    if world > 1:
        raise RuntimeError(
            f"{what} runs at world size 1 only, not in this group of "
            f"{world} ranks: the torch backend's own producer merges "
            "across ranks (ROADMAP.md)")


def on_rank0(fn: Callable[[], Any], what: str) -> Any:
    """Run ``fn`` on rank 0 alone (a store write, phase 1), then wait on
    every rank until it has finished (one all-gather, a barrier), so that
    the next read on any rank sees what rank 0 wrote (a rank's
    ``TraceStore`` memos are checked against the files' stats at every
    read, so none serves what it held before the barrier, not even a
    query service's store, held across its ticks). Returns ``fn``'s
    result on every rank (it must pickle). If ``fn`` raised, rank 0
    re-raises it and every other rank raises ``RuntimeError``. Without a
    group of more than one rank, just ``fn()``."""
    if _world_size() == 1:
        return fn()
    err, res, exc = None, None, None
    if _rank() == 0:
        try:
            res = fn()
        except Exception as e:       # noqa: BLE001 - re-raised below
            exc, err = e, f"{type(e).__name__}: {e}"
    got = gather((err, res), "on_rank0")
    if exc is not None:
        raise exc
    if got[0][0] is not None:
        raise RuntimeError(f"{what} failed on rank 0: {got[0][0]}")
    return got[0][1]
