"""Bit-faithful nvprof- and Nsight-schema SQLite fixture writers.

Real profiler exports need a profiled GPU run; instead these writers
serialize a synthetic :class:`~repro_torch.core.events.RankTrace` into
the SAME SQLite layouts nvprof and Nsight Systems emit (table names,
column sets, string-table spellings, ``_id_`` INTEGER PRIMARY KEYs that
alias rowid). That gives tests and benches a ground truth with no GPU
in the loop: ingesting a fixture through
:mod:`repro_torch.ingest.cupti_sqlite` must build a store
bit-identical to the direct synthetic build of the same dataset.

Faithfulness notes (what is real vs. simplified):

  * nvprof kernels land in ``CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL``
    with the full nvprof column set; the ``name`` column references
    ``StringTable (_id_, value)``. A ``CUPTI_ACTIVITY_KIND_RUNTIME``
    table is populated with one plausible launch-API row per kernel —
    the adapter must *tolerate* runtime activity, it never ingests it.
  * Nsight kernels land in ``CUPTI_ACTIVITY_KIND_KERNEL`` with
    ``shortName`` / ``demangledName`` referencing ``StringIds (id,
    value)`` and extra Nsight columns the native schema lacks, so the
    sniffer classifies the fixture as a real Nsight export, not as the
    repo's own format.
  * Both flavors optionally carry the native ``memoryStall`` REAL
    column (``with_stall=True``, the default) — without it a real
    export has no stall metric and ingests zeros, which can never be
    bit-identical to a synthetic build with stalls.
  * Device inventories use TEXT names (Nsight style). Real nvprof
    routes device names through ``StringTable`` too; the adapter
    handles that (``device_name_is_ref``) but the fixture keeps the
    string table purely kernel-named so manifest ``kernel_names`` match
    the native build exactly.
  * ``drop_name_ids`` omits chosen ids from the string table — a lossy
    export; ingest falls back to ``kernel_{id}`` names for them.

Events are inserted in array order (synthetic traces are sorted by
start), one row per event, so rowids replicate the native writer's
insertion order — chunked rowid-paged ingest then yields the exact row
order ``read_rank_db`` produces, which bit-identity requires.
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Dict, Iterable, List, Sequence

from repro_torch.core.events import RankTrace, SyntheticDataset

__all__ = ["write_nvprof_rank_db", "write_nsys_rank_db",
           "write_fixture_dbs", "append_fixture_rank_db"]

_FLAVORS = ("nvprof", "nsys")


def _nvprof_schema(conn: sqlite3.Connection, with_stall: bool) -> None:
    stall = ", memoryStall REAL" if with_stall else ""
    conn.execute(
        "CREATE TABLE IF NOT EXISTS CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL ("
        "_id_ INTEGER PRIMARY KEY, cacheConfigRequested INTEGER, "
        "cacheConfigExecuted INTEGER, completed INTEGER, contextId INTEGER, "
        "correlationId INTEGER, deviceId INTEGER, "
        "dynamicSharedMemory INTEGER, end INTEGER, gridId INTEGER, "
        "gridX INTEGER, gridY INTEGER, gridZ INTEGER, blockX INTEGER, "
        "blockY INTEGER, blockZ INTEGER, localMemoryPerThread INTEGER, "
        "localMemoryTotal INTEGER, name INTEGER, "
        "registersPerThread INTEGER, staticSharedMemory INTEGER, "
        f"start INTEGER, streamId INTEGER{stall})")
    conn.execute(
        "CREATE TABLE IF NOT EXISTS CUPTI_ACTIVITY_KIND_MEMCPY ("
        "_id_ INTEGER PRIMARY KEY, bytes INTEGER, contextId INTEGER, "
        "copyKind INTEGER, correlationId INTEGER, deviceId INTEGER, "
        "dstKind INTEGER, end INTEGER, flags INTEGER, srcKind INTEGER, "
        "start INTEGER, streamId INTEGER)")
    conn.execute(
        "CREATE TABLE IF NOT EXISTS CUPTI_ACTIVITY_KIND_RUNTIME ("
        "_id_ INTEGER PRIMARY KEY, cbid INTEGER, start INTEGER, "
        "end INTEGER, processId INTEGER, threadId INTEGER, "
        "correlationId INTEGER, returnValue INTEGER)")
    conn.execute(
        "CREATE TABLE IF NOT EXISTS CUPTI_ACTIVITY_KIND_DEVICE ("
        "_id_ INTEGER PRIMARY KEY, computeCapabilityMajor INTEGER, "
        "computeCapabilityMinor INTEGER, globalMemoryBandwidth INTEGER, "
        "globalMemorySize INTEGER, id INTEGER, name TEXT, "
        "numMultiprocessors INTEGER)")
    conn.execute("CREATE TABLE IF NOT EXISTS StringTable ("
                 "_id_ INTEGER PRIMARY KEY, value TEXT)")


def _nsys_schema(conn: sqlite3.Connection, with_stall: bool) -> None:
    stall = ", memoryStall REAL" if with_stall else ""
    conn.execute(
        "CREATE TABLE IF NOT EXISTS CUPTI_ACTIVITY_KIND_KERNEL ("
        "start INTEGER, end INTEGER, deviceId INTEGER, contextId INTEGER, "
        "streamId INTEGER, correlationId INTEGER, globalPid INTEGER, "
        "gridX INTEGER, gridY INTEGER, gridZ INTEGER, blockX INTEGER, "
        "blockY INTEGER, blockZ INTEGER, staticSharedMemory INTEGER, "
        "dynamicSharedMemory INTEGER, localMemoryPerThread INTEGER, "
        "localMemoryTotal INTEGER, gridId INTEGER, "
        "registersPerThread INTEGER, launchType INTEGER, "
        f"shortName INTEGER, demangledName INTEGER{stall})")
    conn.execute(
        "CREATE TABLE IF NOT EXISTS CUPTI_ACTIVITY_KIND_MEMCPY ("
        "start INTEGER, end INTEGER, deviceId INTEGER, contextId INTEGER, "
        "streamId INTEGER, correlationId INTEGER, globalPid INTEGER, "
        "bytes INTEGER, copyKind INTEGER, srcKind INTEGER, "
        "dstKind INTEGER)")
    conn.execute(
        "CREATE TABLE IF NOT EXISTS TARGET_INFO_GPU ("
        "id INTEGER, name TEXT, busLocation TEXT, uuid TEXT, "
        "globalMemoryBandwidth INTEGER, globalMemorySize INTEGER, "
        "smCount INTEGER, computeCapabilityMajor INTEGER, "
        "computeCapabilityMinor INTEGER)")
    conn.execute("CREATE TABLE IF NOT EXISTS StringIds ("
                 "id INTEGER PRIMARY KEY, value TEXT)")


def _insert_nvprof_events(conn: sqlite3.Connection, trace: RankTrace,
                          with_stall: bool) -> None:
    k = trace.kernels
    nk = len(k)
    corr = list(range(1, nk + 1))
    base = zip(k.start.tolist(), k.end.tolist(), k.device.tolist(),
               k.stream.tolist(), k.name_id.tolist(), corr)
    stall = k.memory_stall.tolist()
    cols = ("cacheConfigRequested, cacheConfigExecuted, completed, "
            "contextId, correlationId, deviceId, dynamicSharedMemory, "
            "end, gridId, gridX, gridY, gridZ, blockX, blockY, blockZ, "
            "localMemoryPerThread, localMemoryTotal, name, "
            "registersPerThread, staticSharedMemory, start, streamId")
    if with_stall:
        sql = ("INSERT INTO CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL ("
               f"{cols}, memoryStall) VALUES "
               "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)")
        rows: Iterable[tuple] = (
            (0, 0, 1, 1, corr_i, d, 0, e, i + 1, 256, 1, 1, 128, 1, 1,
             0, 0, nid, 32, 0, s, st, stall[i])
            for i, (s, e, d, st, nid, corr_i) in enumerate(base))
    else:
        sql = ("INSERT INTO CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL ("
               f"{cols}) VALUES "
               "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)")
        rows = ((0, 0, 1, 1, corr_i, d, 0, e, i + 1, 256, 1, 1, 128, 1, 1,
                 0, 0, nid, 32, 0, s, st)
                for i, (s, e, d, st, nid, corr_i) in enumerate(base))
    conn.executemany(sql, rows)
    # one plausible launch-API runtime row per kernel (cbid 211 ==
    # cudaLaunchKernel) — present in every real nvprof export; the
    # adapter must skip it, never ingest it
    conn.executemany(
        "INSERT INTO CUPTI_ACTIVITY_KIND_RUNTIME ("
        "cbid, start, end, processId, threadId, correlationId, "
        "returnValue) VALUES (211, ?, ?, 4242, 4243, ?, 0)",
        ((max(int(s) - 5_000, 0), max(int(s) - 1_000, 1), c)
         for s, c in zip(trace.kernels.start.tolist(), corr)))
    m = trace.memcpys
    conn.executemany(
        "INSERT INTO CUPTI_ACTIVITY_KIND_MEMCPY ("
        "bytes, contextId, copyKind, correlationId, deviceId, dstKind, "
        "end, flags, srcKind, start, streamId) "
        "VALUES (?,1,?,?,?,0,?,0,0,?,?)",
        zip(m.bytes.tolist(), m.copy_kind.tolist(),
            range(nk + 1, nk + 1 + len(m)), m.device.tolist(),
            m.end.tolist(), m.start.tolist(), m.stream.tolist()))


def _insert_nsys_events(conn: sqlite3.Connection, trace: RankTrace,
                        with_stall: bool) -> None:
    k = trace.kernels
    base = zip(k.start.tolist(), k.end.tolist(), k.device.tolist(),
               k.stream.tolist(), k.name_id.tolist(),
               range(1, len(k) + 1))
    if with_stall:
        sql = ("INSERT INTO CUPTI_ACTIVITY_KIND_KERNEL ("
               "start, end, deviceId, contextId, streamId, correlationId, "
               "globalPid, gridX, gridY, gridZ, blockX, blockY, blockZ, "
               "staticSharedMemory, dynamicSharedMemory, "
               "localMemoryPerThread, localMemoryTotal, gridId, "
               "registersPerThread, launchType, shortName, demangledName, "
               "memoryStall) VALUES "
               "(?,?,?,1,?,?,281474976710656,256,1,1,128,1,1,0,0,0,0,?,"
               "32,0,?,?,?)")
        stall = k.memory_stall.tolist()
        rows: Iterable[tuple] = (
            (s, e, d, st, c, c, nid, nid, stall[i])
            for i, (s, e, d, st, nid, c) in enumerate(base))
    else:
        sql = ("INSERT INTO CUPTI_ACTIVITY_KIND_KERNEL ("
               "start, end, deviceId, contextId, streamId, correlationId, "
               "globalPid, gridX, gridY, gridZ, blockX, blockY, blockZ, "
               "staticSharedMemory, dynamicSharedMemory, "
               "localMemoryPerThread, localMemoryTotal, gridId, "
               "registersPerThread, launchType, shortName, demangledName) "
               "VALUES (?,?,?,1,?,?,281474976710656,256,1,1,128,1,1,0,0,"
               "0,0,?,32,0,?,?)")
        rows = ((s, e, d, st, c, c, nid, nid)
                for s, e, d, st, nid, c in base)
    conn.executemany(sql, rows)
    m = trace.memcpys
    conn.executemany(
        "INSERT INTO CUPTI_ACTIVITY_KIND_MEMCPY ("
        "start, end, deviceId, contextId, streamId, correlationId, "
        "globalPid, bytes, copyKind, srcKind, dstKind) "
        "VALUES (?,?,?,1,?,?,281474976710656,?,?,0,0)",
        zip(m.start.tolist(), m.end.tolist(), m.device.tolist(),
            m.stream.tolist(), range(1, len(m) + 1), m.bytes.tolist(),
            m.copy_kind.tolist()))


def _insert_names(conn: sqlite3.Connection, names: Dict[int, str],
                  flavor: str, drop_name_ids: Sequence[int] = ()) -> None:
    table, id_col = (("StringTable", "_id_") if flavor == "nvprof"
                     else ("StringIds", "id"))
    drop = {int(i) for i in drop_name_ids}
    conn.executemany(
        f"INSERT OR REPLACE INTO {table} ({id_col}, value) VALUES (?,?)",
        [(int(i), str(n)) for i, n in sorted(names.items())
         if int(i) not in drop])


def _insert_gpus(conn: sqlite3.Connection, trace: RankTrace,
                 flavor: str) -> None:
    if flavor == "nvprof":
        conn.executemany(
            "INSERT INTO CUPTI_ACTIVITY_KIND_DEVICE ("
            "computeCapabilityMajor, computeCapabilityMinor, "
            "globalMemoryBandwidth, globalMemorySize, id, name, "
            "numMultiprocessors) VALUES (?,?,?,?,?,?,?)",
            [(g.cc_major, g.cc_minor, g.bandwidth, g.memory, g.id,
              g.name, g.sm_count) for g in trace.gpus])
    else:
        conn.executemany(
            "INSERT INTO TARGET_INFO_GPU (id, name, busLocation, uuid, "
            "globalMemoryBandwidth, globalMemorySize, smCount, "
            "computeCapabilityMajor, computeCapabilityMinor) "
            "VALUES (?,?,?,?,?,?,?,?,?)",
            [(g.id, g.name, f"0000:{g.id:02x}:00.0",
              f"GPU-0000-0000-0000-{g.id:012x}", g.bandwidth, g.memory,
              g.sm_count, g.cc_major, g.cc_minor) for g in trace.gpus])


def _write_fixture(path: str, trace: RankTrace, flavor: str,
                   with_stall: bool, drop_name_ids: Sequence[int]) -> None:
    if flavor not in _FLAVORS:
        raise ValueError(f"unknown fixture flavor {flavor!r} "
                         f"(expected one of {_FLAVORS})")
    if os.path.exists(path):
        os.remove(path)
    conn = sqlite3.connect(path)
    try:
        if flavor == "nvprof":
            _nvprof_schema(conn, with_stall)
            _insert_nvprof_events(conn, trace, with_stall)
        else:
            _nsys_schema(conn, with_stall)
            _insert_nsys_events(conn, trace, with_stall)
        _insert_gpus(conn, trace, flavor)
        _insert_names(conn, trace.names, flavor, drop_name_ids)
        conn.commit()
    finally:
        conn.close()


def write_nvprof_rank_db(path: str, trace: RankTrace, *,
                         with_stall: bool = True,
                         drop_name_ids: Sequence[int] = ()) -> None:
    """Serialize one rank trace as an nvprof-schema SQLite export."""
    _write_fixture(path, trace, "nvprof", with_stall, drop_name_ids)


def write_nsys_rank_db(path: str, trace: RankTrace, *,
                       with_stall: bool = True,
                       drop_name_ids: Sequence[int] = ()) -> None:
    """Serialize one rank trace as an Nsight-Systems-schema export."""
    _write_fixture(path, trace, "nsys", with_stall, drop_name_ids)


def write_fixture_dbs(ds: SyntheticDataset, out_dir: str,
                      flavor: str = "nsys", *, with_stall: bool = True,
                      drop_name_ids: Sequence[int] = ()) -> List[str]:
    """One profiler-schema SQLite per rank (mirrors
    :func:`~repro_torch.core.events.write_synthetic_dbs`'s layout and
    ground-truth JSON, with profiler-style filenames)."""
    os.makedirs(out_dir, exist_ok=True)
    ext = "sqlite" if flavor == "nvprof" else "nsys-rep.sqlite"
    paths = []
    for tr in ds.traces:
        p = os.path.join(out_dir, f"rank{tr.rank}.{ext}")
        _write_fixture(p, tr, flavor, with_stall, drop_name_ids)
        paths.append(p)
    with open(os.path.join(out_dir, "ground_truth.json"), "w") as f:
        json.dump({"anomaly_windows": ds.anomaly_windows.tolist(),
                   "flavor": flavor}, f, indent=2)
    return paths


def append_fixture_rank_db(path: str, trace: RankTrace,
                           flavor: str = "nsys", *,
                           with_stall: bool = True,
                           drop_name_ids: Sequence[int] = ()) -> None:
    """Append ``trace``'s events to an EXISTING fixture — a live
    profiler flushing another activity-buffer batch. Appended rows get
    fresh larger rowids (nvprof's ``_id_`` PRIMARY KEY aliases rowid),
    which is exactly what the streaming plane's rowid watermarks tail;
    the string table is upserted like the native append path."""
    if flavor not in _FLAVORS:
        raise ValueError(f"unknown fixture flavor {flavor!r} "
                         f"(expected one of {_FLAVORS})")
    conn = sqlite3.connect(path)
    try:
        if flavor == "nvprof":
            _insert_nvprof_events(conn, trace, with_stall)
        else:
            _insert_nsys_events(conn, trace, with_stall)
        _insert_names(conn, trace.names, flavor, drop_name_ids)
        conn.commit()
    finally:
        conn.close()
