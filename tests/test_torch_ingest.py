"""The port's profiler ingestion frontend (``repro_torch.ingest``: the
schema sniffer, the rowid-windowed reader and the nvprof / Nsight fixture
writers) against the JAX package's, on the CPU.

The reference's ingest scenarios (tests/test_ingest.py) run through the
port, all but the process-backend one (the port has no process backend);
the streaming tail rides a ``torch`` service with ``device="cpu"`` and the
diff runs on both backends. Beside them, each fixture flavour written by
both packages holds the same rows (every table, ``ORDER BY rowid``) and
ingests into a store whose shard files equal, byte for byte, those the
reference builds from its own fixture.
"""

import filecmp
import os
import sqlite3
import time

import numpy as np
import pytest

import repro.core as ref
import repro.ingest as ref_ingest
from repro_torch.core import (GenerationConfig, PipelineConfig, Query,
                              SyntheticSpec, TraceStore, VariabilityPipeline,
                              generate_synthetic, inject_slowdown,
                              run_aggregation, run_append, run_generation,
                              trace_remainder, truncate_trace,
                              write_synthetic_dbs)
from repro_torch.core.events import read_kernel_names
from repro_torch.ingest import (IngestError, SqliteTraceSource,
                                append_fixture_rank_db, as_trace_source,
                                rowid_watermark, sniff_schema,
                                write_fixture_dbs, write_nsys_rank_db,
                                write_nvprof_rank_db)

_NS = 1_000_000_000
SUITE_QUERY = Query(metrics=("k_stall", "m_duration"), group_by="src_rank",
                    reducers=("moments", "quantile"))


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    """One synthetic workload written three ways by the port: native
    rank DBs plus nvprof- and Nsight-schema fixture exports."""
    root = tmp_path_factory.mktemp("torch_ingest_trio")
    ds = generate_synthetic(SyntheticSpec(
        n_ranks=2, kernels_per_rank=3000, memcpys_per_rank=400,
        duration_s=16.0, n_anomaly_windows=2, seed=11))
    native = write_synthetic_dbs(ds, str(root / "native"))
    nvprof = write_fixture_dbs(ds, str(root / "nvprof"), flavor="nvprof")
    nsys = write_fixture_dbs(ds, str(root / "nsys"), flavor="nsys")
    return ds, native, nvprof, nsys, root


@pytest.fixture(scope="module")
def native_store(trio):
    _, native, _, _, root = trio
    out = str(root / "store_native")
    run_generation(native, out, n_ranks=2)
    return out


def _assert_stores_bit_identical(a_dir, b_dir):
    sa, sb = TraceStore(a_dir), TraceStore(b_dir)
    ma, mb = sa.read_manifest(), sb.read_manifest()
    assert (ma.t_start, ma.t_end, ma.n_shards) == \
        (mb.t_start, mb.t_end, mb.n_shards)
    assert ma.extra["kernel_names"] == mb.extra["kernel_names"]
    for s in range(ma.n_shards):
        ca, cb = sa.read_shard(s), sb.read_shard(s)
        assert set(ca) == set(cb)
        for col in ca:
            np.testing.assert_array_equal(ca[col], cb[col])


def _rows(path):
    """Every table's rows in rowid order."""
    conn = sqlite3.connect(path)
    try:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "ORDER BY name")]
        return {t: conn.execute(
            f"SELECT * FROM {t} ORDER BY rowid").fetchall() for t in tables}
    finally:
        conn.close()


# --- schema sniffing --------------------------------------------------------

def test_sniff_classifies_all_three_dialects(trio):
    _, native, nvprof, nsys, _ = trio
    s = sniff_schema(native[0])
    assert s.kind == "native"
    assert s.kernel_table == "CUPTI_ACTIVITY_KIND_KERNEL"
    assert s.name_col == "shortName" and s.string_table == "StringIds"
    assert s.stall_col == "memoryStall"

    s = sniff_schema(nvprof[0])
    assert s.kind == "nvprof"
    assert s.kernel_table == "CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL"
    assert s.name_col == "name" and s.string_table == "StringTable"
    assert s.string_id_col == "_id_"
    assert s.device_table == "CUPTI_ACTIVITY_KIND_DEVICE"
    assert s.has_runtime

    s = sniff_schema(nsys[0])
    assert s.kind == "nsys"
    assert s.kernel_table == "CUPTI_ACTIVITY_KIND_KERNEL"
    assert s.name_col == "shortName" and s.string_table == "StringIds"
    assert s.device_table == "TARGET_INFO_GPU"


def test_sniff_rejects_malformed_inputs(tmp_path):
    with pytest.raises(IngestError, match="does not exist"):
        sniff_schema(str(tmp_path / "nope.sqlite"))

    garbage = tmp_path / "garbage.sqlite"
    garbage.write_bytes(b"this is not a sqlite file" * 100)
    with pytest.raises(IngestError, match="not a readable SQLite"):
        sniff_schema(str(garbage))

    empty = tmp_path / "empty.sqlite"
    conn = sqlite3.connect(str(empty))
    conn.execute("CREATE TABLE unrelated (x INTEGER)")
    conn.commit()
    conn.close()
    with pytest.raises(IngestError, match="no CUPTI kernel activity"):
        sniff_schema(str(empty))

    partial = tmp_path / "partial.sqlite"
    conn = sqlite3.connect(str(partial))
    conn.execute("CREATE TABLE CUPTI_ACTIVITY_KIND_KERNEL (start INTEGER)")
    conn.commit()
    conn.close()
    with pytest.raises(IngestError, match="missing required column"):
        sniff_schema(str(partial))


def test_truncated_database_fails_loudly(trio, tmp_path):
    ds, _, _, _, _ = trio
    p = str(tmp_path / "trunc.sqlite")
    write_nvprof_rank_db(p, ds.traces[0])
    src = as_trace_source(p)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    with pytest.raises(IngestError):
        src.read(rank=0)


# --- fixture -> ingest -> store bit-identity --------------------------------

@pytest.mark.parametrize("flavor", ["nvprof", "nsys"])
def test_fixture_ingest_bit_identical_serial(trio, native_store, flavor):
    _, _, nvprof, nsys, root = trio
    paths = nvprof if flavor == "nvprof" else nsys
    out = str(root / f"store_{flavor}_serial")
    rep = run_generation(paths, out, n_ranks=2)
    assert rep.ingest_rows_read > 0 and rep.ingest_rows_skipped == 0
    _assert_stores_bit_identical(native_store, out)
    man = TraceStore(out).read_manifest()
    assert set(man.extra["source_kinds"].values()) == {flavor}


@pytest.mark.parametrize("flavor", ["nvprof", "nsys"])
def test_fixtures_equal_reference_rows_and_store_bytes(trio, tmp_path,
                                                       flavor):
    """A fixture the port writes holds the reference's rows, table for
    table in rowid order; the port's phase 1 over it writes shard files
    byte-equal to the reference's phase 1 over the reference's fixture."""
    ds, _, nvprof, nsys, _ = trio
    mine = nvprof if flavor == "nvprof" else nsys
    theirs = ref_ingest.write_fixture_dbs(ds, str(tmp_path / "ref"),
                                          flavor=flavor)
    for a, b in zip(mine, theirs):
        assert _rows(a) == _rows(b)
    run_generation(mine, str(tmp_path / "store_port"), n_ranks=2)
    ref.run_generation(theirs, str(tmp_path / "store_ref"), n_ranks=2)
    n = TraceStore(str(tmp_path / "store_port")).read_manifest().n_shards
    names = [f"shard_{s:06d}.npz" for s in range(n)]
    match, mismatch, errors = filecmp.cmpfiles(
        str(tmp_path / "store_port"), str(tmp_path / "store_ref"), names,
        shallow=False)
    assert match == names and not mismatch and not errors


def test_chunked_reads_match_oneshot(trio, native_store):
    _, _, nvprof, _, root = trio
    out = str(root / "store_chunked")
    run_generation(nvprof, out, n_ranks=2,
                   cfg=GenerationConfig(chunk_rows=7))
    _assert_stores_bit_identical(native_store, out)


# --- ingest-time predicate pushdown -----------------------------------------

def test_pushdown_matches_posthoc_filter_oracle(trio, native_store):
    _, _, nvprof, _, root = trio
    man = TraceStore(native_store).read_manifest()
    lo, hi = man.t_start, man.t_end
    q = Query(metrics=("k_stall",),
              time_window=(lo + (hi - lo) // 4, lo + (hi - lo) // 2),
              kernel_names=tuple(range(8)))

    out = str(root / "store_pushdown")
    store = TraceStore(out)
    rep = run_generation(nvprof, out, n_ranks=2,
                         cfg=GenerationConfig(pushdown=q), store=store)
    assert rep.ingest_rows_skipped > 0
    assert store.io_counts["ingest_rows_skipped"] == rep.ingest_rows_skipped
    assert store.io_counts["ingest_rows_read"] == rep.ingest_rows_read
    man_sel = TraceStore(out).read_manifest()
    assert man_sel.extra["ingest_pushdown"] == q.to_spec()
    assert (man_sel.t_start, man_sel.t_end, man_sel.n_shards) == \
        (man.t_start, man.t_end, man.n_shards)

    a = run_aggregation(native_store, query=q)
    b = run_aggregation(out, query=q)
    for f in ("count", "sum", "sumsq", "min", "max"):
        np.testing.assert_array_equal(getattr(a.stats, f),
                                      getattr(b.stats, f))


def test_ranks_pushdown_skips_whole_sources(trio):
    _, _, nvprof, _, root = trio
    full = SqliteTraceSource.open(nvprof[1])
    in_range = full.count_range()
    out = str(root / "store_ranks")
    store = TraceStore(out)
    rep = run_generation(nvprof, out, n_ranks=1,
                         cfg=GenerationConfig(pushdown=Query(ranks=(0,))),
                         store=store)
    assert rep.ingest_rows_skipped == in_range
    man = TraceStore(out).read_manifest()
    st = TraceStore(out)
    for s in range(man.n_shards):
        cols = st.read_shard(s)
        assert not np.any(cols["src_rank"] == 1.0)


def test_append_reapplies_recorded_pushdown(trio, tmp_path):
    ds, _, _, _, _ = trio
    t0 = int(ds.traces[0].kernels.start.min())
    cutoff = (t0 // _NS) * _NS + 8 * _NS
    paths = [str(tmp_path / f"rank{tr.rank}.sqlite") for tr in ds.traces]
    for tr, p in zip(ds.traces, paths):
        write_nvprof_rank_db(p, truncate_trace(tr, cutoff))
    q = Query(kernel_names=tuple(range(8)))
    out = str(tmp_path / "store")
    run_generation(paths, out, n_ranks=2, cfg=GenerationConfig(pushdown=q))
    for tr, p in zip(ds.traces, paths):
        append_fixture_rank_db(p, trace_remainder(tr, cutoff),
                               flavor="nvprof")
    store = TraceStore(out)
    run_append(paths, out, store=store)
    assert store.io_counts["ingest_rows_skipped"] > 0
    man = store.read_manifest()
    assert man.extra["ingest_pushdown"] == q.to_spec()
    for s in range(man.n_shards):
        names = store.read_shard(s)["k_name"]
        assert names.size == 0 or names.max() < 8


# --- name-table spelling tolerance ------------------------------------------

def test_read_kernel_names_tolerates_both_spellings(trio):
    _, native, nvprof, nsys, _ = trio
    for p in (native[0], nvprof[0], nsys[0]):
        names = read_kernel_names(p)
        assert len(names) == 64
        assert all(isinstance(v, str) and v for v in names.values())
    assert read_kernel_names(native[0]) == read_kernel_names(nvprof[0])


@pytest.mark.parametrize("flavor", ["nvprof", "nsys"])
def test_missing_name_rows_fall_back_to_kernel_id(trio, tmp_path, flavor):
    ds, _, _, _, _ = trio
    writer = (write_nvprof_rank_db if flavor == "nvprof"
              else write_nsys_rank_db)
    p = str(tmp_path / f"lossy_{flavor}.sqlite")
    writer(p, ds.traces[0], drop_name_ids=(3, 5))
    names = SqliteTraceSource.open(p).kernel_names()
    assert names[3] == "kernel_3" and names[5] == "kernel_5"
    assert names[0] != "kernel_0"
    out = str(tmp_path / f"store_{flavor}")
    run_generation([p], out, n_ranks=1)
    man = TraceStore(out).read_manifest()
    assert man.extra["kernel_names"]["3"] == "kernel_3"


def test_rowid_watermark_dialect_aware(trio):
    _, native, nvprof, nsys, _ = trio
    wms = {rowid_watermark(p[0]) for p in (native, nvprof, nsys)}
    assert len(wms) == 1
    assert next(iter(wms)) > (0, 0)


# --- streaming tail of a live-written Nsight export -------------------------

def test_streaming_tail_of_live_nsys_export(tmp_path):
    from repro_torch.serve import IngestConfig, QueryService, ServiceConfig
    ds = generate_synthetic(SyntheticSpec(
        n_ranks=2, kernels_per_rank=3000, memcpys_per_rank=400,
        duration_s=16.0, n_anomaly_windows=2, seed=13))
    t0 = int(ds.traces[0].kernels.start.min())
    cutoff = (t0 // _NS) * _NS + 8 * _NS
    paths = [str(tmp_path / f"rank{tr.rank}.nsys-rep.sqlite")
             for tr in ds.traces]
    for tr, p in zip(ds.traces, paths):
        write_nsys_rank_db(p, truncate_trace(tr, cutoff))
    store_dir = str(tmp_path / "store")
    run_generation(paths, store_dir, n_ranks=2)

    svc = QueryService(store_dir, ServiceConfig(tick_ms=1.0, device="cpu"))
    ing = svc.ensure_ingestor(IngestConfig())
    ing.attach(paths)
    assert ing.poll_once() == []
    for tr, p in zip(ds.traces, paths):
        append_fixture_rank_db(p, trace_remainder(tr, cutoff),
                               flavor="nsys")
    assert sorted(ing.poll_once()) == sorted(ing.attached())
    p = ing.submit(t_detect=time.monotonic())
    assert svc.drain_once(block_s=0.0) == 1
    assert p.error is None
    assert p.tick_info["ingest"]["rows_ingested"] > 0
    assert ing.poll_once() == []

    cold = str(tmp_path / "cold")
    run_generation(paths, cold, n_ranks=2)
    a = run_aggregation(store_dir, query=SUITE_QUERY)
    b = run_aggregation(cold, query=SUITE_QUERY)
    for f in ("count", "sum", "sumsq", "min", "max"):
        np.testing.assert_array_equal(getattr(a.grouped, f),
                                      getattr(b.grouped, f))
    np.testing.assert_array_equal(a.reduced["quantile"].counts,
                                  b.reduced["quantile"].counts)


# --- diff engine over two ingested real traces ------------------------------

@pytest.mark.parametrize("backend", ["serial", "torch"])
def test_diff_of_two_ingested_traces(tmp_path, backend):
    common = dict(n_ranks=2, kernels_per_rank=3000, memcpys_per_rank=300,
                  duration_s=12.0, seed=7)
    ds_a = generate_synthetic(SyntheticSpec(**common, name_variant=0))
    ds_b = generate_synthetic(SyntheticSpec(**common, name_variant=1))
    ds_c = inject_slowdown(ds_b, 1.6, (3, 24, 45))
    stores = {}
    for tag, ds in (("a", ds_a), ("b", ds_b), ("c", ds_c)):
        dbs = write_fixture_dbs(ds, str(tmp_path / f"dbs_{tag}"),
                                flavor="nsys")
        out = str(tmp_path / f"store_{tag}")
        run_generation(dbs, out, n_ranks=2)
        stores[tag] = out
    pipe = VariabilityPipeline(PipelineConfig(n_ranks=2, backend=backend,
                                              device="cpu"))
    clean = pipe.diff(stores["a"], stores["b"])
    assert clean.verdict != "regressed"
    bad = pipe.diff(stores["a"], stores["c"])
    assert bad.verdict == "regressed"
