"""The paper's pipeline on a torch device: a sharded, collaboratively
reduced GPU performance-variability analysis.

Layout (one module per paper concept, as in :mod:`repro.core`):
  events        CUPTI-shaped schema, SQLite I/O, synthetic generator
  tracestore    columnar shard files + manifest + the two-level derived
                cache: per-shard partials + merged summaries (same
                on-disk format as the reference package)
  sharding      time partitioner, block/cyclic rank assignment, append-mode
                plan re-derivation (``ShardPlan.extended_to``)
  generation    phase 1: extract -> window left-join -> shard files;
                append-mode ingest (``run_append``) extends a live store
  reducers      mergeable statistics: "moments" (BinStats) and "quantile"
                (log-bucket QuantileSketch) per (bin, group, metric) cell
  query         declarative Query API; QueryPlan compiles a batch into one
                fused scan with predicate pushdown
  aggregation   phase 2, incremental on both backends: per-shard partial
                producer (exact host scan, or the torch device producer
                over the binstats/histbin kernels) -> clean/dirty
                classification -> suite-generic merge -> covered summary
  anomaly       phase 3: IQR fences through the iqr kernel, top-k
                anomalous shards; sketch-vs-sketch shift scores
  diff          trace diff & regression engine: fuzzy kernel-name
                alignment across stores, per-(bin, group) distribution
                shift off the cached sketches, ranked DiffReport with a
                pass/regressed verdict CI can gate on
  distributed   device entry points over the kernels (world size 1)
  pipeline      end-to-end driver (serial | torch backends) with the
                append -> delta-aggregate -> re-fence loop, the two-store
                diff, and the query service / streaming plane facades
"""

from .events import (EventTable, GpuInfo, RankTrace, SyntheticSpec,
                     SyntheticDataset, append_rank_db, generate_synthetic,
                     inject_slowdown, read_kernel_names,
                     synthetic_kernel_names,
                     trace_remainder, truncate_trace, write_synthetic_dbs,
                     read_rank_db, write_rank_db)
from .sharding import (ShardPlan, assignment, block_assignment,
                       cyclic_assignment, owner_of_shards)
from .tracestore import StoreManifest, TraceStore
from .generation import (AppendReport, GenerationConfig, GenerationReport,
                         recover_append, run_append, run_generation,
                         union_kernel_names, window_left_join)
from .reducers import (MergeableReducer, QuantileSketch, get_reducer,
                       normalize_reducers, register_reducer,
                       REDUCER_REGISTRY, QUANTILE_REL_ERR)
from .query import (LanePlan, Query, QueryPlan, QueryResult,
                    SUMMARY_VERSION, diff_cache_key, diff_from_spec,
                    diff_query, diff_spec, is_quantile_score)
from .aggregation import (AggregationResult, BinStats, GroupedPartial,
                          ShardPartial, bin_samples, bin_samples_grouped,
                          classify_shards, compute_lane_partials_torch,
                          compute_shard_partial, execute_plan,
                          load_rank_partials, round_robin_merge,
                          run_aggregation, run_incremental, run_queries,
                          DEFAULT_METRIC)
from .anomaly import (IQRReport, anomalous_bins, iqr_detect, recovered,
                      report_for_query, sketch_shift)
from .diff import (DiffReport, DiffThresholds, GroupDiff, MatchResult,
                   NameMatch, diff_results, kernel_name_tokens,
                   match_kernel_names, normalize_kernel_name)
from .pipeline import PipelineConfig, PipelineResult, VariabilityPipeline
