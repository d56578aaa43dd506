#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--ranks 8] [--duration 120]

Phases, each of which raises (and the script exits non-zero) on failure:

1. card    — name and power limit, as nvidia-smi reports them;
2. build   — compile every CUDA source of the port with nvcc, one process
             per source, all started together (each library's seconds are
             printed), beside a second compile of flashattn.cu, ssd.cu,
             binstats.cu, histbin.cu, iqr.cu and rolling.cu with -Xptxas
             -v; print the counts of HGMMA (wgmma) and UTMALDG (TMA load)
             instructions in the flashattn and ssd libraries' SASS
             (cuobjdump -sass) and the registers and spill bytes of each
             tensor-core instantiation (flash_fwd_wgmma, ssd_wgmma) and of
             the other kernels; fail if a count is 0 or a tensor-core
             instantiation spills;
3. kernels — every kernel entry point against its plain PyTorch version
             on the card at edge shapes (ragged N, all rows invalid, n_seg
             not a multiple of 128 with empty segments, M = 1 and 3; ssd
             with S not a multiple of the chunk, G == H and G < H, P/N
             8/16, 64/16 and 64/128,
             chunks 8, 16 and 128, bfloat16 and float32 B/C with float32
             x, and bfloat16 x, B and C, whose chunk-128 shapes must run
             the tensor-core kernel;
             flash_attention with S not a multiple of the tile, causal
             with window 0, windows of 1, 8 and 16 and one above S,
             non-causal, H / Hkv = 1, 4, 5, 7, 8 and 12 (7 and 12: a
             rank's heads of qwen2-vl and starcoder2 at T = 4), hd 8, 32,
             64, 80 and 128 (hd 80, zero-filled to the hd-128
             instantiation, causal with 32 query over 8 KV heads, with
             window 4,096 passed by S = 4,200, and non-causal 16 / 16),
             S = 37 with window 8,
             whose padded query rows see no key, and MLA's split head
             dims: q and k 192 with v 128 (the (192, 128) instantiation)
             causal at S = 300 and S = 130 (a partial last tile) and
             non-causal, q and k 160 with v 96 (zero-filled to it) over
             grouped KV heads with a window, and the smoke deepseek's 16 /
             8 (zero-filled to (16, 16)), in bfloat16 and float32;
             binstats_flat with one segment holding every row, with
             50,000 mostly empty segments and with one segment far
             longer than a lane group's stride, and
             unordered rows, which must leave a NaN count and raise in
             BinStats.device_reduce; histbin_flat with one segment holding
             every row, 50,000 mostly empty segments, ids below 0 and at
             or above n_seg, no valid row, and unordered rows, which must
             leave NaN counts and raise in QuantileSketch.device_reduce;
             binstats at 1 bin and 12,000 bins
             (1 and 3 metrics); iqr_fences in float32 at n = 1, 1,000,
             4,096, 5,000 with no occupied bin, 12,000, 16,384, 32,768,
             32,769, 40,000 and 100,000, in float64 at n = 1, 2, 3, 4,096,
             12,000, 16,384, 16,385, 40,000 and 120,000 (one cluster
             launch up to 16,384 keys, the tile-and-merge path above),
             tables of ties, negatives and -0.0, all scores equal and no
             occupied bin at 12,000 and 40,000 in both types, and the
             1e8-ns table of tests/test_torch_fences.py, each equal to the
             plain version exactly; rolling_stats at n = 1 with window
             1, window 16 above n = 5, n = 1,000 with window 100, window
             = n = 1,024, a ragged n = 2,049 with window 64, window 1,500
             above the 1,024-output tile at n = 3,000, and window 1 at
             n = 100, on normal and lognormal(10, 1) stall-like values);
4. micro   — the calls of the reference's kernel micro-bench
             (benchmarks/kernels_bench.py), with its seed, through the
             port's entry points: binstats over 65,536 events into 512
             bins, iqr_fences over 4,096 scores, rolling_stats over 32,768
             values with window 64. The counters are zeroed just before
             and read just after; each of the three must launch, and each
             is held against its plain version on those tensors;
5. main    — the paper's pipeline through ``VariabilityPipeline.run`` on a
             Table-1-sized synthetic trace (8 ranks x 105k kernels + 13.4k
             memcpys, 120 s, 10 ms bins x 4 devices, 3 metrics, moments +
             quantile sketch, p99 fences), backend "torch", its phase 1 on
             the rank pool (one worker process a rank; more than one pid
             required), printed beside the serial backend's in-process
             loop on the same DBs. The launch
             counters are zeroed just before and read just after; the
             run must launch binstats_flat, histbin_flat and iqr_fences,
             recover the injected anomaly windows and agree with the
             exact "serial" backend on the same store. The inputs each
             wrapper received are kept, and every kernel is then held
             against its plain version on exactly those tensors;
6. stall   — rolling_stats with window 1,024 over each source rank's
             memory-stall series of the main phase's trace, in start
             order (8 ranks x 105,000 values): the series a Fig-1a user
             smooths. The counters are zeroed just before and read just
             after (8 launches); each call is held against the plain
             version. The float32 drift of the reference oracle's formula
             (one float32 prefix over the whole series) is printed beside;
7. delta   — a store grown by an append: the delta aggregation on the card
             must equal a cold one bit for bit (two cache-free copies of
             the store before the append are kept for the collective
             phase);
8. diff    — ``VariabilityPipeline.diff`` of the main phase's store (A)
             against store B, the same Table-1 inventory with the kernel
             names respecialized (name variant 1) and the layer_norm family
             (ids 3, 24, 45) slowed 1.5x, built by the port's phase 1; the
             query is k_stall at 100 ms bins, grouped by kernel name
             (about 1,200 bins x 64 names a side). The counters are
             zeroed just before the cold torch diff and read just after:
             binstats_flat and histbin_flat launch once a side; both are
             held against their plain versions on side B's inputs. The
             verdict must be regressed with the injected family ranked
             first, a self-diff must pass, and the serial backend's diff
             (no caches) must give the same verdict and ranked groups with
             scores within RTOL. A summary-warm repeat reads no shard and
             launches nothing; a third call loads the persisted report;
9. service — ``VariabilityPipeline.serve`` of store A on the torch
             backend: 16 client threads send 8 distinct queries (each
             twice) at once through ``QueryClient`` — no grouping and each
             group column, moments alone and with the sketch, mean / p95 /
             p99 scores, 10 ms / 100 ms / 1 s bins, one time window. Every
             response must be 200, a tick must fuse two or more requests,
             one answer must be an in-flight or summary hit, the three
             kernels must launch, and each answer must equal a serial
             service's on a copy of the store (counts and fence flags
             exactly, min/max in float32, means within RTOL); tick latency
             percentiles from ``/v1/stats`` and request wall times are
             printed. The answers are kept for the collective phase;
10. stream — the Table-1 trace's rank DBs cut at 90 s and their store;
             ``VariabilityPipeline.stream`` tails them (poll 25 ms) while
             the remaining 30 s arrive in three 10 s batches; a
             ``QueryClient.fences`` long poll receives each batch's events
             and the plane is quiesced before the next. The counters are
             zeroed before the first batch and read after the last: the
             three kernels must launch, with no ingest error. The same
             batches are appended to a copy of the DBs and ingested by
             ``run_append`` without the service: the rows ingested must
             equal its rows batch for batch, and the shard files its
             files byte for byte. The fence state (flags, top windows)
             and the fence query's moments and sketch must equal a cold
             torch run over a cache-free copy of the same shards exactly.
             A from-scratch phase 1 of the final DBs is built for the
             record: its joined-row count and the shard files it differs
             in are printed (phase 1 joins no committed kernel with a
             memcpy appended later, ROADMAP Queue 3); event-to-fence
             p50/p99 are printed;
11. ranks  — the paper's Fig 1c on the card's machine: the main phase's
             DBs at 1 and 8 ranks (capped at the usable CPUs, which
             are printed first) through the "process" backend (one OS
             process a rank for phase 1, the work-stealing process pool
             for the exact scan, fences on the card) and the "serial"
             backend, and the "torch" backend's phases 2+3 on the process
             store. Each rank count prints phase 1 and phases 2+3 seconds,
             the phase-1 and scan worker pids (more than one required
             above 1 rank), the most shards a rank owns, the joined rows,
             and the peak RSS of this process so far and of the largest
             worker; the process shard files must equal the
             serial ones byte for byte, its moments, sketch counts, flags
             and top bins exactly, torch must equal serial under the main
             phase's tolerances, and each backend must launch
             iqr_fences. A fresh interpreter that never touches CUDA first
             times the process backend's phase 1 at the largest rank count
             under the fork and the forkserver start methods;
12. collective — the paper's collaborative merge across ranks:
             COLLECTIVE_RANKS (4) rank processes (this script with
             --collective-rank), all on cuda:0, in a gloo group with a
             timeout, the kernels already built by this process. Every
             rank runs ``VariabilityPipeline.query`` on the torch backend
             over a cache-free copy of the main phase's store (its section
             of each shard's rows through binstats_flat and histbin_flat
             on the card, the tables merged across ranks, the fences on
             every rank), then the delta phase's append onto a copy of
             that phase's store as it was before its append (a first P =
             4 run fills the P = 4 partial cache; phase 1 on rank 0) and a
             cold rerun. The counters are zeroed just before and read just
             after each run: every rank must launch binstats_flat,
             histbin_flat and iqr_fences, and holds each against its plain
             version on its own inputs. Every rank's result must be equal;
             the P = 4 result must equal the main phase's P = 1 one
             (counts, min, max, sketch counts, flags and top windows
             exactly, sums within RTOL), and the delta its cold rerun bit
             for bit. Then, on the same ranks, serving and streaming
             across ranks: every rank calls ``VariabilityPipeline.serve``
             on another cache-free copy of the main store
             (``pipeline_depth=4``; rank 0 holds the HTTP port, admits and
             broadcasts each tick, every rank executes it) while 16 client
             threads on rank 0 send the service phase's 8 queries, each
             twice: every response 200, a tick fusing two or more
             requests, an in-flight or summary hit, each answer equal to
             the service phase's P = 1 one (its tolerances), every rank's
             digests of the tick descriptors and answers equal; then every
             rank calls ``VariabilityPipeline.stream`` on the second copy
             of the delta phase's store, tailing its grown DBs (the tailer
             on rank 0): a fence event read over HTTP, no ingest error,
             and the fence state and the fence query's moments and sketch
             equal to a cold P = 4 run over a cache-free copy of the
             resulting shards bit for bit. The counters are zeroed just
             before each and read just after: every rank must launch
             binstats_flat, histbin_flat and iqr_fences, each held against
             its plain version on the rank's own inputs. Each rank's
             seconds and the seconds of each collective call are printed
             (for the service and the stream: calls, total and largest
             seconds by collective), with request wall times, fused
             widths, tick p50/p95/p99 and event-to-fence p50/p99;
13. serve  — mamba2-370m at full width and depth (48 layers, d_model
             1024, vocab 50280) in bfloat16, random weights drawn on the
             card from --seed, through ``ServeEngine.generate``: 8
             requests of 2048 prompt tokens, 32 new tokens each. The
             counters are zeroed just before and read just after; the
             prefill must launch ssd_fused once per layer, every launch on
             the tensor-core kernel (48 of 48). The kernel is
             held against its plain version on the first layer's own
             inputs, and a prefill and a generation through the plain
             version must give the same last-token logits (within the
             bfloat16 tolerance below) and first tokens. Device kernel
             time by name for one prefill and 8 decode steps is read
             with torch.profiler;
14. serve-hymba — hymba-1.5b at full width and depth (32 hybrid layers,
             3 global and 29 with window 1024, d_model 1600, vocab 32001,
             128 meta tokens) in bfloat16, random weights drawn on the card
             from --seed, through ``ServeEngine.generate``: 8 requests of
             2048 prompt tokens, 32 new tokens each. The prefill must
             launch flash_attention and ssd_fused once per layer, every
             launch of both on its tensor-core kernel (32 of 32 each). The
             kernels are held against their plain versions on the path's
             own first global and first window layer's attention inputs
             and first layer's SSD inputs; a prefill and a generation
             through the plain versions must agree with the kernels' as
             in the serve phase; prefill(N - 1) + one decode step must
             give prefill(N)'s logits at batch 2 with a prompt longer than
             the window (the meta-token and ring bookkeeping). Device
             kernel time by name is read as in the serve phase;
15. families — the eight families without an SSM layer at full width and (but
             deepseek) depth in bfloat16, random weights drawn on the card from
             --seed, one model on the card at a time, each parameter count
             equal to the reference's: stablelm-3b (32 layers, hd 80, partial
             RoPE, qkv biases), h2o-danube-1.8b (24 layers, hd 80, window
             4,096), nemotron-4-15b (32 layers, squared ReLU, untied head),
             starcoder2-15b (40 layers, layernorm, GELU), granite-moe-1b-a400m
             (24 MoE layers, 32 experts, top 8) and qwen2-vl-7b (28 layers,
             M-RoPE; a 16 x 16 grid of random patch embeddings before the text,
             ids (0, row, col) for a patch and (i, i, i) for the text token at
             position i) and deepseek-v2-236b (MLA: 128 heads, qk 128 nope + 64
             rope, v 128, latents of 1,536 and 512; its dense first layer and 4
             of its 59 MoE layers of 160 experts top 6 with 2 shared, depth cut
             to fit the card: 16,750,740,480 parameters, the reference's count
             for that cut) served through ``ServeEngine.generate``: 4 requests
             of 2,048 prompt positions (qwen2-vl: 256 patches + 1,792 text
             tokens), 16 new tokens each; then hubert-xlarge's encoder forward
             (48 non-causal layers, hd 80) through ``loss_fn`` under inference
             mode on the data pipeline's 4 x 4,096 frames. The counters are
             zeroed just before and read just after: flash_attention must
             launch once an attention layer, all on the tensor-core kernel (32,
             24, 32, 40, 24, 28, 5, 48), deepseek's all in the (192, 128)
             instantiation; the kernel is held against its plain version on the
             path's own first-layer inputs; the last-token logits against a
             plain-version prefill and the first tokens as in the serve phase
             (granite's plain prefill takes the kernel run's expert choices, as
             deepseek's does, and the free-running gap, the dropped share and
             the tokens whose top-k differs are printed beside); danube also
             decodes past its window (batch 1, a prompt of 4,200); hubert's
             loss within 0.05 of the plain version's. Peak memory, prefill ms,
             the decode median and one profile of prefill and of 8 decode steps
             (hubert: of the forward) are printed, and the peak through the
             plain prefill;
15b. tp    — tensor-parallel serving: 4 rank processes (chip_smoke.py
             --rank-role tp --collective-rank R, started by the phase), all
             on cuda:0 in a gloo group, each draw h2o-danube-1.8b,
             hymba-1.5b, mamba2-370m, granite-moe-1b-a400m and
             deepseek-v2-236b (its dense layer and 1 MoE layer;
             TP_DEPTH_CUTS) whole at full width from --seed, and serve 1
             request of 2,048 prompt tokens (after hymba's 128 meta
             tokens) + 8 new through ``ServeEngine(...,
             mesh=make_host_mesh(model=4))``: each rank keeps its shards
             (its parameter bytes must equal ``bytes_per_device``; the
             MoE's expert tables by expert), runs flash_attention on its
             query and KV heads (24 launches a prefill for danube, 24 for
             granite, 2 for deepseek's MLA in the (192, 128)
             instantiation, all tensor-core) or ssd_fused on its 8 SSM
             heads (48), hymba's 25 query and 5 KV heads and 50 SSM heads
             whole (32 + 32), the MoE's ep path in prefill (two
             all_to_alls a layer) and its replicated path in decode, and
             adds the partials with ordered sums over gloo; where the
             cache's length is cut (hymba's KV heads; deepseek's latent)
             each rank holds its block of the slots and decode merges the
             blocks' softmax partials (tp_softmax). For hymba each rank's
             prefill cache blocks are held against P = 1's slices (layer
             0's k and v bit-equal, the largest gap printed) and the rank
             that wrote each decoded slot is printed. Rank 0 then runs the
             same function at P = 1 on the whole tree, drawn again: decode
             teacher-forced on the TP tokens, and for an MoE model each
             prefill MoE call on the 4 sequence blocks as separate calls
             (the ep path's capacity) under the TP run's expert choices;
             the TP prefill and decode logits must agree with P = 1's
             within the serving gates, every rank's logits, tokens and
             dropped share must be equal bit for bit,
             and each rank's kernel calls are held against the plain
             versions; prefill ms, decode ms a token, peak GiB and each
             collective kind's calls and seconds (tp_all_to_all on a line
             of its own) are printed a rank, the dropped shares at TP, at
             P = 1 and free-running, the free-running gap and the tokens
             whose own top-k differs from the TP choice, with whether gloo
             takes bfloat16 CUDA tensors as they are (the port sends
             16-bit floats as uint8 views either way). Then the step
             dp-granite (DP_SPEC): the same 4 ranks draw
             granite-moe-1b-a400m whole at full width and depth and serve
             2 requests of 2,048 prompt tokens + 8 new through
             ``ServeEngine(..., mesh=make_host_mesh(model=2))``, a (2, 2)
             mesh: each rank holds its FSDP and tensor shards (the fsdp
             dims cut over data, gathered a layer at use; bytes ==
             bytes_per_device) and serves its data rank's request, the
             MoE on ep in prefill (24 a prefill) and replicated in decode;
             then 8 decode steps under ``make_ctx(mesh, inference=True)``
             over the inference layout (``shard_params``: the expert
             tables' F cut over data, bytes == bytes_per_device),
             teacher-forced on the served tokens over the served caches,
             on the weights-stationary branch (24 a step) under the
             replicated steps' expert choices (gathered from the data
             ranks), against the replicated steps' logits (the 8th one
             decoded after the engine's 7) within the serving gates. 24
             flash_attention launches a prefill on every rank, all
             tensor-core, each rank's call held against the plain
             version; the ranks of a data row bit-equal, every rank's
             tokens and dropped share equal; rank 0's P = 1 run as
             above, its prefill MoE calls on the 4 (request, sequence
             block) blocks and its decode under both data ranks' expert
             choices. Printed a rank: prefill ms, decode ms a token on
             both decode paths, peak GiB, each collective kind's calls
             and seconds in the generate and in the stationary steps
             (tp_* the model axis, dp_* the data axis, mesh_* the whole
             mesh), the P = 1 and replicated-decode gaps. Then the
             steps tp-train-granite, tp-train-mamba2 and tp-train-hymba
             (TP_TRAIN_SPECS): the same 4 ranks train granite-moe-1b-a400m
             and mamba2-370m at full width, 4 layers each, and
             hymba-1.5b at full width, one global and one window-1,024
             layer (TP_TRAIN_DEPTH_CUTS; its 25 query, 5 KV and 50 SSM
             heads whole on every rank, 128 meta tokens before the 2,048,
             each whole tensor's gradient summed once over the tensor
             axis), on make_host_mesh(model=4) = (1, 4)
             through ``make_train_step(cfg, tcfg, mesh)``: each rank
             draws the whole float32 tree from --seed and keeps its
             blocks of the weights and of both moments (bytes ==
             bytes_per_device, moments twice that), takes the whole batch
             of 1 x 2,048 tokens from make_batch, runs the forward on its
             heads, experts (ep) or SSM heads and vocabulary block, the
             backward through every collective, remat "full"; one
             warm-up step and 2 timed ones at the peak lr of
             TRAIN_SPECS, the counters zeroed just before the timed ones:
             2 launches of each of the step's kernels a layer a step
             (forward and recompute) on the tensor cores (hymba: 8
             flash_attention, in the (64, 64) instantiation, and 8
             ssd_fused). Every rank's losses, grad norms and updated
             whole leaves bit-equal; every rank's first-step gradient
             blocks go to rank 0, which runs the same steps at P = 1 (the
             MoE on the 4 sequence blocks' capacity under the mesh run's
             expert choices): each step's loss within 0.05, each matrix
             gradient block's cosine >= 0.98. Printed a rank: step ms,
             tokens/s, peak GiB, the seconds of the step's parts (the
             first includes the process's first non-reentrant checkpoint
             call, ~9-12 s), collectives by kind with the backward's
             (``*_bwd``) apart. Then the step dp-train-granite (the same
             ranks, processes and spec list): granite-moe-1b-a400m, 4
             layers, on make_host_mesh(model=2) = (2, 2), a batch of 2 x
             2,048 tokens, one row a data rank: each rank holds its FSDP
             and tensor blocks of the weights and moments, gathers a
             layer's fsdp leaves at use (and again in the recompute), the
             backward reduce-scatters their gradients over data
             (dp_fsdp_bwd) and adds the data-whole leaves' over data
             (dp_sum_bwd); the same gates against rank 0's P = 1 run of
             the 2 rows (the MoE on the 4 (row, sequence block) blocks),
             and the two data ranks' copies of each model block bit-equal;
             the dp_* collectives on a line of their own;
16. times  — each kernel, its plain version and a one-call PyTorch
             yardstick where one exists, at the main path's shapes, beside
             the kernel's bound: a wrapper call by CUDA events, the
             yardstick by CUDA events, then the device time of a call under
             torch.profiler (after a warm-up cycle of 20 calls and a 1 ms
             spin kernel, so every watched call is kept), split into the
             row's own kernels (those of its .cu source, by name) and the
             wrapper's other device work; the
             whole read twice in turn ("ms" is the first event reading);
             binstats' timestamp form and rolling_stats at the micro
             phase's calls, rolling_stats also at one rank's stall series
             (105,000 values, window 1,024), binstats also at the Table-1
             rows, iqr_fences at the main path's float64 call, at the
             same scores in float32, at the micro phase's float32 call and
             at 120,000 seeded float64 scores (80% occupied), each with
             torch.quantile as the yardstick; the profiler's own-kernel
             count must be 1 a call up to 16,384 keys and at most 16 at
             120,000 (a reading that saw fewer kernels than calls lost
             profiler events and is taken again, up to 4 more times);
             it runs before the tp phase (in the wake of its training
             steps the profiler lost the short iqr_fences calls' events),
             and flash_attention and ssd_fused at rank 0's calls of the tp
             phase (its per-rank shapes, the tp-train steps' too) are
             timed the same way just after the tp phase;
17. host trace — time.perf_counter_ns around each step of the
             rolling_stats, binstats, binstats_flat, histbin_flat and
             iqr_fences wrappers (checks, allocations, library lookup,
             stream lookup, binding call and launch, result check) over
             10,000 calls at their path shapes, nothing synchronised
             inside a call; today's steps (the C++ operator), the same C
             entries through lean ctypes steps (not for iqr_fences), and
             the earlier ctypes wrapper's steps replayed, each beside the
             whole wrapper call; then core.anomaly.iqr_detect at the main
             path's call over 2,000 calls, split into host prep, upload,
             kernel call, the two device-to-host reads and host ranking;
18. train  — mamba2-370m trained at full width, its depth cut to 24 of
             48 layers for time (TRAIN_DEPTH_CUTS; d_model 1024, vocab
             50280) through ``Trainer.run``: float32
             master weights drawn on the card from --seed, a bfloat16
             working copy, remat "full", sequences of 4096 (the
             reference's train_4k) from the port's ``make_batch``,
             microbatch 4 x grad_accum 2, 6 steps, an asynchronous
             checkpoint at step 4, the straggler monitor every 3 steps.
             First the first microbatch's loss and gradients with the
             kernels against the same under the plain versions (loss
             within 0.05, each matrix gradient's cosine >= 0.98, the
             worst leaf printed) and each kernel on its first-layer
             inputs. The counters are zeroed just before the run and read
             just after: ssd_fused must launch 24 + 24 (forward and remat
             recompute) a microbatch, every launch on the tensor-core
             kernel, and iqr_fences at least once an analysis. Losses
             finite, the mean of the last 3 below the first 3's. A second
             Trainer resumes from the step-4 checkpoint alone: its losses
             within 1e-3 relative of the run's. The run's telemetry DB
             goes through ``VariabilityPipeline`` (torch backend), and a
             recorder of 8 hosts, one 3x slower, must be flagged by
             ``StragglerMonitor`` on the card as numpy's fences flag it.
             Step ms (median, min, max), tokens/s and peak memory (no
             profiled step since the tp phase came: ROADMAP lists the
             device-time split it gave as lost);
19. train-hymba — hymba-1.5b likewise (32 hybrid layers, 3 global and
             29 with window 1024, 128 meta tokens): sequences of 2048
             (2176 positions, past the window), microbatch 2 x grad_accum
             2, 6 steps, no checkpoint; flash_attention and ssd_fused
             must each launch 32 + 32 a microbatch on their tensor-core
             kernels; the plain-version check and losses as in train;
20. train-<family> — the eight families without an SSM layer trained
             through ``Trainer.run`` at full width, one on the card at a
             time, micro 1 x grad_accum 2 (granite 2 x 2) of 2,048
             positions, 6 steps, no checkpoint, the monitor every 3 steps:
             stablelm-3b (32 layers), h2o-danube-1.8b (24, sequences of
             4,200 past its 4,096 window), nemotron-4-15b (1 of 32 layers,
             its untied 256,000 x 6,144 embedding and head 3.15 B of its
             3.54 B parameters), starcoder2-15b (4 of 40), granite-moe
             (24 MoE layers), qwen2-vl-7b (8 of 28; 256 patches and 1,792
             text tokens), hubert-xlarge (48 non-causal layers, 4,096
             frames, the loss on the masked frames) and deepseek-v2-236b
             (its dense first layer), each cut (TRAIN_DEPTH_CUTS) to the
             most layers whose 20 B a parameter of training state fits the
             card, each count the reference's. The first-microbatch check
             runs on the bfloat16 working copy alone (deepseek's on its
             dense layer and one MoE layer of 160 experts, whose training
             state would take 97 GB), the plain pass of an MoE model
             under the kernel pass's expert choices (the free-running
             plain loss and the moved tokens printed beside) and its
             kernel pass run twice, equal bit for bit (granite, deepseek).
             flash_attention must launch once a layer a microbatch and
             once more in its remat recompute, every launch on the
             tensor-core kernel in the family's instantiation ((128, 128)
             for hd 80 and 128, (64, 64) for granite, (192, 128) for
             MLA); losses falling, the monitor's launches, step ms, tokens
             a second and peak memory beside the reckoned state as in
             train. Then the training calls are timed as in times
             (ssd_fused at mamba2's and hymba's first-layer calls,
             flash_attention at hymba's first window call and each
             family's first-layer call, iqr_fences at the monitor's
             largest table). The training phases come after times and
             host trace: in their wake the profiler lost the device
             events of short calls;
21. reap   — stop the rank pools' forkserver and resource tracker
             (core.pipeline.stop_rank_pool_server) and fail if a process
             this script started, or one started below it, still runs.

Tolerances: counts, min, max, flags and iqr outputs (sorted table,
flags, stats) exact; float32 sums
rtol 1e-5 (atomics and summation order differ), and for the edge cases
whose cells sum tens of thousands of rows (one segment, one long
segment, one bin) each sum within float32's worst-case summation bound
(n_c + 2) * 2^-24 * sum|term| of the float64 sum; histogram totals exact
with at most 0.1% of rows one bucket over (float32 log2 on a bucket edge);
ssd float32 outputs rtol = atol = 1e-4 (the reference's own), bfloat16
outputs one rounding step (rtol 2^-7); flash_attention float32 outputs
rtol = atol = 2e-4 (the reference's own), bfloat16 one rounding step;
serving logits, computed in bfloat16 through every layer of the model
(24 to 48), max |kernel - plain| <= 0.5 and mean <= 0.05 (and so |TP -
P = 1| in the tp phase, whose sums add float32 partials in rank order,
and |stationary - replicated| in its dp-granite step), and each
request's first token equal unless the plain logits' top-2 gap is below
0.5; the same logits bound for the decode continuations (hymba, danube);
for granite-moe and deepseek the plain prefill takes the kernel run's
expert choices
(top-k routing is discrete: a rounding step moves tokens near a tie to
other experts, and the moved tokens compound over the layers); hubert's
loss within 0.05 of the plain version's; rolling_stats, both
columns, rtol 1e-4 and atol 1e-4 * max(1, max|x|) (the reference's
rtol = atol = 1e-4, scaled for stall-magnitude values); training, whose
forward runs in bfloat16 through every layer and whose backward is the
plain recompute either way: loss within 0.05 of the plain versions' and
each matrix gradient's cosine >= 0.98 (granite's and deepseek's plain
pass under the kernel pass's expert choices); resumed losses within 1e-3
relative (the same kernels on the same data, only their float order);
the monitor's fences and flagged hosts equal to numpy's exactly.

The last two lines of standard output are a JSON ``kernels`` record and
``{"ok": true, "device": {...}}``. Needs one CUDA card and the ``src/``
tree of this repository; exits non-zero without either.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bfloat16 tensor cores, dense
METRICS = ("k_stall", "m_duration", "m_bytes")
RTOL = 1e-5
SSD_TOL = 1e-4
FLASH_TOL = 2e-4
ROLLING_TOL = 1e-4
BF16_RTOL = 2 ** -7
LOGIT_MAX_TOL = 0.5
LOGIT_MEAN_TOL = 0.05
# one spec a serving phase, each model at full width and depth: batch,
# prompt tokens (after the meta tokens and, for the VLM, a grid x grid
# image of patches), new tokens, and the (batch, prompt) of the decode
# continuation past the attention window (None: no window to pass)
SERVE_SPECS = {
    "serve": dict(arch="mamba2-370m", batch=8, prompt=2048, new=32),
    "serve-hymba": dict(arch="hymba-1.5b", batch=8, prompt=2048, new=32,
                        cont=(2, 1100)),    # 128 meta + 1100 > 1024
    "serve-stablelm": dict(arch="stablelm-3b", batch=4, prompt=2048,
                           new=16),
    "serve-danube": dict(arch="h2o-danube-1.8b", batch=4, prompt=2048,
                         new=16, cont=(1, 4200)),     # 4200 > 4096
    "serve-nemotron": dict(arch="nemotron-4-15b", batch=4, prompt=2048,
                           new=16),
    "serve-starcoder2": dict(arch="starcoder2-15b", batch=4, prompt=2048,
                             new=16),
    "serve-granite": dict(arch="granite-moe-1b-a400m", batch=4,
                          prompt=2048, new=16),
    "serve-qwen2-vl": dict(arch="qwen2-vl-7b", batch=4, prompt=1792,
                           new=16, grid=16),    # 256 patches + 1792 text
    # DEPTH_CUTS; every attention call in the split-dim instantiation
    "serve-deepseek": dict(arch="deepseek-v2-236b", batch=4, prompt=2048,
                           new=16, flash_instance=(192, 128)),
}
# the layers of each segment of a model served with its depth cut:
# deepseek-v2-236b's dense first layer and 4 of its 59 MoE layers (7.4 GiB
# each in bfloat16) leave room beside its weights for the plain version's
# dense (4, 128, 2048, 2048) float32 softmax
DEPTH_CUTS = {"deepseek-v2-236b": (1, 4)}
# hubert-xlarge's encoder forward (loss_fn) on the pipeline's frames
ENCODE_SPEC = dict(arch="hubert-xlarge", batch=4, frames=4096)
# the phases of the families without an SSM layer, in their order
FAMILY_PHASES = ("serve-stablelm", "serve-danube", "serve-nemotron",
                 "serve-starcoder2", "serve-granite", "serve-qwen2-vl",
                 "serve-deepseek", "encode-hubert")
# the reference's counts (jax.eval_shape of its init_params, on the config
# cut as DEPTH_CUTS says), which tests/test_torch_families.py checks
PARAM_COUNTS = {
    "mamba2-370m": 368_338_432,
    "hymba-1.5b": 1_590_080_320,
    "stablelm-3b": 2_666_744_320,
    "h2o-danube-1.8b": 1_749_281_280,
    "nemotron-4-15b": 15_628_376_064,
    "starcoder2-15b": 15_956_127_744,
    "granite-moe-1b-a400m": 1_334_628_352,
    "qwen2-vl-7b": 7_620_204_032,
    "hubert-xlarge": 945_912_320,
    "deepseek-v2-236b": 16_750_740_480,
}
# b, s, H, P, G, N, chunk
SSD_EDGE_SHAPES = ((2, 37, 4, 8, 2, 16, 8), (1, 64, 2, 16, 1, 32, 16),
                   (2, 16, 8, 8, 8, 8, 16), (1, 300, 32, 64, 1, 128, 128),
                   (1, 256, 4, 64, 1, 16, 128))
# b, s, H, Hkv, hd, hdv, causal, window
FLASH_EDGE_SHAPES = ((2, 37, 4, 4, 8, 8, True, 0),
                     (2, 37, 5, 1, 64, 64, True, 8),
                     (1, 300, 10, 2, 64, 64, True, 16),
                     (1, 300, 8, 1, 128, 128, False, 0),
                     (1, 300, 4, 2, 32, 32, True, 500),
                     (1, 130, 4, 4, 16, 16, True, 1),
                     (1, 1100, 5, 5, 64, 64, True, 1024),
                     # hd 80 (stablelm, danube, hubert) in the hd-128
                     # instantiation: causal GQA 32/8, danube's window
                     # 4096 passed by S, non-causal 16/16
                     (1, 300, 32, 8, 80, 80, True, 0),
                     (1, 4200, 32, 8, 80, 80, True, 4096),
                     (2, 300, 16, 16, 80, 80, False, 0),
                     # a rank's heads at T = 4: qwen2-vl's 7 query heads
                     # and starcoder2's 12 over one KV head, hd 128
                     (1, 300, 7, 1, 128, 128, True, 0),
                     (1, 300, 12, 1, 128, 128, True, 0),
                     # MLA's split head dims in the (192, 128)
                     # instantiation: deepseek's qk 192 / v 128 causal,
                     # with a partial last tile, non-causal; 160 / 96
                     # zero-filled to it over grouped heads with a window;
                     # the smoke deepseek's 16 / 8 zero-filled to (16, 16)
                     (1, 300, 8, 8, 192, 128, True, 0),
                     (1, 130, 8, 8, 192, 128, True, 0),
                     (1, 300, 4, 4, 192, 128, False, 0),
                     (1, 200, 4, 2, 160, 96, True, 64),
                     (2, 37, 4, 4, 16, 8, True, 0))
# n, window
ROLLING_EDGE_SHAPES = ((1, 1), (5, 16), (1000, 100), (1024, 1024),
                       (2049, 64), (3000, 1500), (100, 1))
MICRO_EVENTS, MICRO_BINS, MICRO_SCORES = 65_536, 512, 4_096
MICRO_SERIES, MICRO_WINDOW = 32_768, 64
STALL_WINDOW = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


# --- comparisons ------------------------------------------------------------

def moments_err(got, want) -> float:
    """Raise unless two (..., 5) moment tables agree (counts/min/max
    exact, sums rtol 1e-5); return the largest absolute difference."""
    import torch
    g, w = got.double().cpu(), want.double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    for ch in (0, 3, 4):
        if not torch.equal(g[..., ch], w[..., ch]):
            raise AssertionError(f"moments channel {ch} differs")
    diff = (g[..., 1:3] - w[..., 1:3]).abs()
    if bool((diff > RTOL * w[..., 1:3].abs() + 1e-30).any()):
        raise AssertionError(f"sums differ beyond rtol {RTOL}: "
                             f"max abs {float(diff.max())}")
    return float((g - w).abs().max()) if g.numel() else 0.0


def summation_err(got, want, idx, vals, valid) -> float:
    """Raise unless two (..., n_cells, 5) moment tables of cells that sum
    thousands of rows agree: counts, min and max exact; each float32 sum
    within the worst-case bound of float32 summation in any order,
    (n_c + 2) * 2^-24 * sum|term| over the cell's n_c rows, of the float64
    sum of the same terms (a relative tolerance between two float32 sums
    in different orders holds for short cells only). Returns the largest
    absolute difference from the plain version."""
    import torch
    g, w = got.double().cpu(), want.double().cpu()
    n_cells = g.shape[-2]
    g, w = g.reshape(-1, n_cells, 5), w.reshape(-1, n_cells, 5)
    for ch in (0, 3, 4):
        if not torch.equal(g[..., ch], w[..., ch]):
            raise AssertionError(f"moments channel {ch} differs")
    idx = idx.long().clamp(0, n_cells - 1).cpu()
    x = vals.double().cpu().reshape(g.shape[0], -1)
    ok = valid.double().cpu()
    rows = torch.zeros(n_cells, dtype=torch.float64).index_add_(
        0, idx, torch.ones_like(ok))
    for j in range(g.shape[0]):
        for ch, terms in ((1, x[j] * ok), (2, x[j] * x[j] * ok)):
            exact = torch.zeros(n_cells, dtype=torch.float64).index_add_(
                0, idx, terms)
            mass = torch.zeros(n_cells, dtype=torch.float64).index_add_(
                0, idx, terms.abs())
            bound = (rows + 2) * 2.0 ** -24 * mass
            if bool(((g[j, :, ch] - exact).abs() > bound).any()):
                raise AssertionError(f"channel {ch} beyond the float32 "
                                     "summation bound")
    return float((g - w).abs().max())


def hist_err(got, want) -> float:
    """Raise unless two (..., 384) count tables agree (totals exact, at
    most 0.1% of rows moved, each one bucket over)."""
    import torch
    g, w = got.double().cpu(), want.double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.equal(g.sum(-1), w.sum(-1)):
        raise AssertionError("histogram totals differ")
    d = g - w
    moved = float(d.abs().sum()) / 2
    if float(d.cumsum(-1).abs().sum()) != moved:
        raise AssertionError("a row moved more than one bucket")
    if moved > 1e-3 * max(float(w.sum()), 1.0):
        raise AssertionError(f"{moved} rows changed bucket")
    return float(d.abs().max()) if d.numel() else 0.0


def ssd_err(got, want) -> float:
    """Raise unless two (y, state) pairs agree: float32 within rtol =
    atol = 1e-4, a bfloat16 y within one rounding step; return the
    largest absolute difference."""
    import torch
    worst = 0.0
    for name, g, w in (("y", got[0], want[0]), ("state", got[1], want[1])):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"ssd {name}: {g.dtype}{tuple(g.shape)} != "
                                 f"{w.dtype}{tuple(w.shape)}")
        rtol = BF16_RTOL if g.dtype == torch.bfloat16 else SSD_TOL
        g, w = g.double().cpu(), w.double().cpu()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd {name}: non-finite values")
        diff = (g - w).abs()
        if bool((diff > SSD_TOL + rtol * w.abs()).any()):
            raise AssertionError(f"ssd {name} differs: max abs "
                                 f"{float(diff.max())}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def flash_err(got, want) -> float:
    """Raise unless two attention outputs agree: float32 within rtol =
    atol = 2e-4, bfloat16 within one rounding step; return the largest
    absolute difference."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else FLASH_TOL
    g, w = got.double().cpu(), want.double().cpu()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("flash: non-finite values")
    diff = (g - w).abs()
    if bool((diff > FLASH_TOL + rtol * w.abs()).any()):
        raise AssertionError(f"flash differs: max abs {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def rolling_err(got, want, x) -> float:
    """Raise unless two (N, 2) rolling (mean, std) tables agree within
    rtol 1e-4 and atol 1e-4 * max(1, max|x|); return the largest absolute
    difference."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"rolling: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.double().cpu(), want.double().cpu()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("rolling: non-finite values")
    atol = ROLLING_TOL * max(1.0, float(x.abs().max()))
    diff = (g - w).abs()
    if bool((diff > atol + ROLLING_TOL * w.abs()).any()):
        raise AssertionError(f"rolling differs: max abs {float(diff.max())}"
                             f" (atol {atol})")
    return float(diff.max())


def iqr_err(got, want) -> float:
    import torch
    for key in ("sorted", "flags", "stats"):
        if not torch.equal(got[key].cpu(), want[key].cpu()):
            raise AssertionError(f"iqr {key} differs")
    return 0.0


# --- phases -----------------------------------------------------------------

def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out[0].strip()


# kernels whose registers and spills the build phase prints, by a piece
# of their mangled name: the tensor-core attention and SSD kernels'
# instantiations (a spill there fails the run) and the binstats, histbin,
# iqr, rolling and CUDA-core SSD kernels
PTXAS_SOURCES = ("flashattn", "ssd", "binstats", "histbin", "iqr", "rolling")
TENSOR_CORE = ("flash_fwd_wgmma", "ssd_wgmma")
PTXAS_KERNELS = (("flash_fwd_wgmmaILi16ELi16E", "flash_fwd_wgmma<16, 16>"),
                 ("flash_fwd_wgmmaILi32ELi32E", "flash_fwd_wgmma<32, 32>"),
                 ("flash_fwd_wgmmaILi64ELi64E", "flash_fwd_wgmma<64, 64>"),
                 ("flash_fwd_wgmmaILi128ELi128E",
                  "flash_fwd_wgmma<128, 128>"),
                 ("flash_fwd_wgmmaILi192ELi128E",
                  "flash_fwd_wgmma<192, 128>"),
                 ("flash_fwd_f32ILi192ELi128E", "flash_fwd_f32<192, 128>"),
                 ("ssd_wgmmaILi16E", "ssd_wgmma<16>"),
                 ("ssd_wgmmaILi32E", "ssd_wgmma<32>"),
                 ("ssd_wgmmaILi64E", "ssd_wgmma<64>"),
                 ("ssd_wgmmaILi128E", "ssd_wgmma<128>"),
                 ("ssd_scan_kernelIfE", "ssd_scan_kernel<float>"),
                 ("ssd_scan_kernelI13__nv_bfloat16E",
                  "ssd_scan_kernel<bf16>"),
                 ("histbin_seg_kernel", "histbin_seg_kernel"),
                 ("binstats_seg_kernel", "binstats_seg_kernel"),
                 ("binstats_ts_cluster_kernel", "binstats_ts_cluster_kernel"),
                 ("iqr_cluster_kernelIfLi0E",
                  "iqr_cluster_kernel<float, single>"),
                 ("iqr_cluster_kernelIdLi0E",
                  "iqr_cluster_kernel<double, single>"),
                 ("iqr_cluster_kernelIdLi1E",
                  "iqr_cluster_kernel<double, tile>"),
                 ("iqr_cluster_kernelIdLi2E",
                  "iqr_cluster_kernel<double, finish>"),
                 ("iqr_merge_kernelIdLi3E", "iqr_merge_kernel<double, 3>"),
                 ("iqr_output_kernelIdE", "iqr_output_kernel<double>"),
                 ("rolling_kernel", "rolling_kernel"))


def _ptxas_report(build):
    """Start a second compile of each of PTXAS_SOURCES with ``-Xptxas -v``
    (beside the build, into a temporary directory); the returned function
    waits for them and returns {kernel: (registers, spill bytes)} for the
    kernels of PTXAS_KERNELS."""
    import re
    out = tempfile.mkdtemp(prefix="ptxas_")
    procs = [subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out, f"{src}.so"), str(build.CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PTXAS_SOURCES]

    def wait():
        report = {}
        for proc in procs:
            log_text, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc -Xptxas -v failed:\n{log_text}")
            name, spill = None, 0
            for line in log_text.splitlines():
                m = re.search(r"Function properties for (\S+)", line)
                if m:
                    name = m.group(1)
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    spill = int(m.group(1)) + int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    for piece, label in PTXAS_KERNELS:
                        if piece in name:
                            report[label] = (int(m.group(1)), spill)
        shutil.rmtree(out, ignore_errors=True)
        return report
    return wait


def _sass_counts(lib_path, build, ops=("HGMMA", "UTMALDG")):
    """How many SASS instructions of each kind the library holds
    (cuobjdump -sass)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout.splitlines()
    return {op: sum(op in line for line in sass) for op in ops}


def phase_kernels(dev):
    """Every entry point against its plain version at edge shapes."""
    import numpy as np
    import torch

    from repro_torch.kernels.binstats import ops as bs
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.kernels.histbin import ops as hb
    from repro_torch.kernels.iqr import ops as iq
    from repro_torch.kernels.rolling import ops as ro
    from repro_torch.kernels.ssd import ops as sd

    rng = np.random.default_rng(1)
    worst = {}

    def rows(n, m, n_seg, invalid=False):
        vals = rng.lognormal(8.0, 2.0, (m, n)).astype(np.float32)
        vals[:, ::13] = -1.5
        seg = np.sort(rng.integers(0, max(n_seg - 7, 1), n)).astype(np.int32)
        ts = rng.uniform(-1e7, 1.01e9, n).astype(np.float32)
        valid = (np.zeros(n, bool) if invalid else rng.random(n) > 0.1)
        return [torch.from_numpy(x).to(dev) for x in (seg, vals, valid, ts)]

    def note(name, err):
        worst[name] = max(worst.get(name, 0.0), err)

    for n, m, n_seg, invalid in ((1001, 1, 1000, False),
                                 (1001, 3, 1000, True),
                                 (70_001, 3, 4097, False),
                                 (1, 1, 5, False)):
        seg, vals, valid, ts = rows(n, m, n_seg, invalid)
        note("binstats_flat", moments_err(
            bs.binstats_flat(seg, vals, n_seg, valid),
            bs.binstats_flat_plain(seg, vals, n_seg, valid)))
        note("histbin_flat", hist_err(
            hb.histbin_flat(seg, vals, n_seg, valid),
            hb.histbin_flat_plain(seg, vals, n_seg, valid)))
        kw = dict(total_ns=1e9, n_bins=n_seg)
        note("binstats", moments_err(bs.binstats(ts, vals, valid, **kw),
                                     bs.binstats_plain(ts, vals, valid,
                                                       **kw)))
        note("histbin", hist_err(hb.histbin(ts, vals, valid, **kw),
                                 hb.histbin_plain(ts, vals, valid, **kw)))
    # binstats_flat: one segment holding every row, mostly empty segments,
    # one segment far longer than a lane group's stride; the timestamp
    # form at 1 bin and at 12,000 bins (1 and 3 metrics: the cluster
    # kernel, then the three-launch path for a table above 227 KB)
    for n, m, n_seg, long_seg in ((70_001, 2, 1, False),
                                  (1_001, 1, 50_000, False),
                                  (70_001, 3, 64, True)):
        seg, vals, valid, ts = rows(n, m, n_seg)
        if long_seg:
            seg = torch.sort(torch.where(
                (torch.arange(n, device=dev) % 7) > 0,
                torch.full_like(seg, 3), seg)).values
        got = bs.binstats_flat(seg, vals, n_seg, valid)
        want = bs.binstats_flat_plain(seg, vals, n_seg, valid)
        note("binstats_flat", summation_err(got, want, seg, vals, valid)
             if n_seg == 1 or long_seg else moments_err(got, want))
    for n_bins, m in ((1, 1), (12_000, 1), (12_000, 3)):
        seg, vals, valid, ts = rows(65_536, m, n_bins)
        kw = dict(total_ns=1e9, n_bins=n_bins)
        got = bs.binstats(ts, vals, valid, **kw)
        want = bs.binstats_plain(ts, vals, valid, **kw)
        note("binstats", moments_err(got, want) if n_bins > 1 else
             summation_err(got, want, bs._ts_bins(ts, 1e9, n_bins), vals,
                           valid))
    # histbin_flat: one segment holding every row, mostly empty segments,
    # ids below 0 and at or above n_seg (dropped), no valid row
    for n, m, n_seg, lo, hi, invalid in ((70_001, 2, 1, 0, 1, False),
                                         (1_001, 1, 50_000, 0, 50_000,
                                          False),
                                         (9_000, 3, 300, -40, 340, False),
                                         (999, 3, 30, 0, 30, True)):
        seg = torch.from_numpy(np.sort(rng.integers(lo, hi, n))
                               .astype(np.int32)).to(dev)
        _, vals, valid, _ = rows(n, m, n_seg, invalid)
        note("histbin_flat", hist_err(
            hb.histbin_flat(seg, vals, n_seg, valid),
            hb.histbin_flat_plain(seg, vals, n_seg, valid)))
    # unordered rows: NaN counts in the table, and the main path's
    # reducers raise on them
    seg, vals, valid, _ = rows(1001, 3, 1000)
    flipped = seg.flip(0).contiguous()
    if not bs.disordered(bs.binstats_flat(flipped, vals, 1000, valid)
                         .cpu()):
        raise AssertionError("binstats_flat did not flag unordered rows")
    if not hb.disordered(hb.histbin_flat(flipped, vals, 1000, valid)
                         .cpu()):
        raise AssertionError("histbin_flat did not flag unordered rows")
    from repro_torch.core.reducers import BinStats, QuantileSketch
    for reducer in (BinStats, QuantileSketch):
        try:
            reducer.device_reduce(flipped, vals, 1000, dev, valid)
        except ValueError:
            pass
        else:
            raise AssertionError(f"unordered rows did not raise in "
                                 f"{reducer.__name__}.device_reduce")
    # iqr: float32 (the TPU kernel's contract) and float64 (the analysis
    # path's) against their plain versions exactly, one cluster launch up
    # to 16,384 keys and the tile-and-merge path above, at ragged n, no
    # occupied bin, all scores equal, ties, negatives and -0.0
    def iqr_case(s, occ):
        s = torch.from_numpy(s).to(dev)
        occ = torch.from_numpy(occ).to(dev)
        note("iqr_fences", iqr_err(iq.iqr_fences(s, occ),
                                   iq.iqr_fences_plain(s, occ)))
    for n, frac in ((1, 1.0), (1_000, 0.8), (4_096, 0.8), (12_000, 0.7),
                    (5_000, 0.0), (16_384, 0.8), (32_768, 0.8),
                    (32_769, 0.8), (40_000, 0.8), (100_000, 0.6)):
        iqr_case(rng.lognormal(3.0, 0.6, n).astype(np.float32),
                 rng.random(n) < frac)
    for n in (1, 2, 3, 4_096, 12_000, 16_384, 16_385, 40_000, 120_000):
        iqr_case(np.clip(rng.lognormal(np.log(1e7), 0.8, n), 1e6, 1e8),
                 rng.random(n) < 0.8)
    for dtype in (np.float32, np.float64):
        for n in (12_000, 40_000):
            ties = (rng.integers(-40, 40, n) / 4).astype(dtype)
            ties[rng.random(n) < 0.05] = -0.0
            iqr_case(ties, rng.random(n) < 0.8)
            iqr_case(np.full(n, 7.5, dtype), rng.random(n) < 0.8)
            iqr_case(ties, np.zeros(n, bool))
    # the 1e8-ns table of tests/test_torch_fences.py
    iqr_case(np.array([1e8, 1e8 + 4, 1e8 + 8, 1e8 + 12, 1e8 + 16, 1e8 + 40]),
             np.ones(6, bool))
    # ssd: float32 x with float32 and bfloat16 B/C (the CUDA-core kernel),
    # and bfloat16 x, B and C (the tensor-core kernel where chunk, P and N
    # allow it: held to the tensor-core count)
    tc_before = sd.ssd_fused.wgmma_launches
    tc_want = 0
    for b, s, H, P, G, N, chunk in SSD_EDGE_SHAPES:
        for x_dtype, bc in ((torch.float32, torch.float32),
                            (torch.float32, torch.bfloat16),
                            (torch.bfloat16, torch.bfloat16)):
            args = _ssd_inputs(rng, (b, s, H, P, G, N), bc, dev, x_dtype)
            tc_want += (x_dtype == torch.bfloat16 and chunk == 128
                        and P % 16 == 0 and P <= 64 and N % 16 == 0)
            note("ssd_fused", ssd_err(sd.ssd_fused(*args, chunk=chunk),
                                      sd.ssd_fused_plain(*args,
                                                         chunk=chunk)))
    if sd.ssd_fused.wgmma_launches - tc_before != tc_want:
        raise AssertionError(f"{sd.ssd_fused.wgmma_launches - tc_before} "
                             f"tensor-core ssd launches, expected {tc_want}")
    for b, s, H, Hkv, hd, hdv, causal, window in FLASH_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, d))
                                        .astype(np.float32)).to(dev, dtype)
                       for n, d in ((H, hd), (Hkv, hd), (Hkv, hdv)))
            kw = dict(causal=causal, window=window)
            note("flash_attention", flash_err(
                fa.flash_attention(q, k, v, **kw),
                fa.flash_attention_plain(q, k, v, **kw)))
    for n, window in ROLLING_EDGE_SHAPES:
        for x in (rng.normal(0, 1, n), rng.lognormal(10, 1, n)):
            x = torch.from_numpy(x.astype(np.float32)).to(dev)
            note("rolling_stats", rolling_err(
                ro.rolling_stats(x, window=window),
                ro.rolling_stats_plain(x, window=window), x))
    torch.cuda.synchronize()
    return worst


def micro_inputs(dev):
    """The reference micro-bench's inputs (benchmarks/kernels_bench.py),
    with its seed and draws in its order: (ts, vals, valid, scores, occ,
    x) on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a).to(dev)
    ts = t(rng.uniform(0, 1e9, MICRO_EVENTS).astype(np.float32))
    vals = t(rng.normal(100, 20, MICRO_EVENTS).astype(np.float32))
    valid = torch.ones(MICRO_EVENTS, dtype=torch.bool, device=dev)
    scores = t(np.abs(rng.normal(10, 4, MICRO_SCORES)).astype(np.float32))
    occ = scores != 0
    x = t(rng.normal(0, 1, MICRO_SERIES).astype(np.float32))
    return ts, vals, valid, scores, occ, x


def iqr_table(dev, n, seed):
    """A float64 per-bin score table of nanosecond sums between 1e6 and
    1e8, 80% of the bins occupied: (scores, occupied) on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    s = np.clip(rng.lognormal(np.log(1e7), 0.8, n), 1e6, 1e8)
    occ = rng.random(n) < 0.8
    return torch.from_numpy(s).to(dev), torch.from_numpy(occ).to(dev)


def phase_micro(dev):
    """The reference micro-bench's calls (benchmarks/kernels_bench.py),
    with its seed and draws in its order, through the port's entry points;
    returns (launches, |kernel - plain| by kernel, the calls' tensors)."""
    import torch

    import repro_torch.kernels as K

    ts, vals, valid, scores, occ, x = micro_inputs(dev)
    bs_kw = {"total_ns": 1e9, "n_bins": MICRO_BINS}
    counters = _launch_counters()
    torch.cuda.synchronize()
    _zero(counters)
    moments = K.binstats(ts, vals, valid, **bs_kw)
    fences = K.iqr_fences(scores, occ)
    stats = K.rolling_stats(x, window=MICRO_WINDOW)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"micro: launches {launches}")
    for name in ("binstats", "iqr_fences", "rolling_stats"):
        if launches[name] != 1:
            raise AssertionError(f"the micro-bench call of {name} launched "
                                 f"it {launches[name]} times, expected 1")
    if moments.shape != (MICRO_BINS, 5) or int(moments[:, 0].sum()) != \
            MICRO_EVENTS:
        raise AssertionError("binstats: bad shape or lost events")
    errs = {"binstats": moments_err(moments,
                                    K.binstats_plain(ts, vals, valid,
                                                     **bs_kw)),
            "iqr_fences": iqr_err(fences, K.iqr_fences_plain(scores, occ)),
            "rolling_stats": rolling_err(
                stats, K.rolling_stats_plain(x, window=MICRO_WINDOW), x)}
    log(f"micro: binstats {MICRO_EVENTS} events x {MICRO_BINS} bins, "
        f"iqr_fences {MICRO_SCORES} scores (q1 {float(fences['q1']):.6f}, "
        f"q3 {float(fences['q3']):.6f}, {int(fences['flags'].sum())} "
        f"flags), rolling_stats {MICRO_SERIES} values window "
        f"{MICRO_WINDOW}; largest |kernel - plain| {errs}")
    shapes = {"binstats": ((ts, vals, valid), bs_kw),
              "rolling_stats": (x, MICRO_WINDOW),
              "iqr_fences/micro": ((scores, occ), {})}
    return launches, errs, shapes


def _oracle_f32(x, window):
    """The reference oracle's formula as it computes it: one float32
    prefix over the whole series (only to show its drift)."""
    import torch
    n = x.shape[0]
    zero = x.new_zeros(1)
    cs = torch.cat([zero, torch.cumsum(x, 0)])
    cs2 = torch.cat([zero, torch.cumsum(x * x, 0)])
    i = torch.arange(n, device=x.device)
    lo = (i - window + 1).clamp_min(0)
    n_eff = (i + 1).clamp_max(window).to(torch.float32)
    mean = (cs[i + 1] - cs[lo]) / n_eff
    var = ((cs2[i + 1] - cs2[lo]) / n_eff - mean * mean).clamp_min(0.0)
    return torch.stack([mean, var.sqrt()], dim=1)


def phase_stall(dev, stalls):
    """rolling_stats(window=1024) over each rank's stall series; returns
    (launches, |kernel - plain|, the first rank's call)."""
    import torch

    import repro_torch.kernels as K

    xs = [torch.from_numpy(s).to(dev) for s in stalls]
    counters = _launch_counters()
    torch.cuda.synchronize()
    _zero(counters)
    outs = [K.rolling_stats(x, window=STALL_WINDOW) for x in xs]
    torch.cuda.synchronize()
    launches = counters["rolling_stats"].launches
    if launches != len(xs):
        raise AssertionError(f"{len(xs)} stall series launched rolling_stats"
                             f" {launches} times")
    err, drift = 0.0, [0.0, 0.0]
    for x, out in zip(xs, outs):
        want = K.rolling_stats_plain(x, window=STALL_WINDOW)
        err = max(err, rolling_err(out, want, x))
        d = (_oracle_f32(x, STALL_WINDOW) - want).abs().amax(0) / \
            x.abs().max()
        drift = [max(a, float(b)) for a, b in zip(drift, d)]
    log(f"stall: rolling_stats window {STALL_WINDOW} over {len(xs)} ranks x "
        f"{xs[0].shape[0]} stall values (max {float(max(x.max() for x in xs))}"
        f" ns), {launches} launches; largest |kernel - plain| {err}; the "
        f"oracle's float32 formula drifts by max |dmean| / max|x| "
        f"{drift[0]:.3e}, max |dstd| / max|x| {drift[1]:.3e}")
    return launches, err, (xs[0], STALL_WINDOW)


def _ssd_inputs(rng, shape, bc_dtype, dev, x_dtype=None):
    """Model-layout inputs of ssd_fused: x in ``x_dtype`` (float32 by
    default), dt in [0.01, 0.1]."""
    import torch
    b, s, H, P, G, N = shape

    def t(a, dtype=torch.float32):
        return torch.from_numpy(a.astype("float32")).to(dev, dtype)
    return (t(rng.normal(size=(b, s, H, P)), x_dtype or torch.float32),
            t(rng.uniform(0.01, 0.1, (b, s, H))), t(rng.uniform(-1, 1, H)),
            t(rng.normal(size=(b, s, G, N)), bc_dtype),
            t(rng.normal(size=(b, s, G, N)), bc_dtype),
            t(rng.normal(size=H)))


class Capture:
    """Keeps the arguments of the first call each wrapper receives on a
    path (by replacing the module attributes the path looks up), so the
    kernels can afterwards be held against their plain versions — and
    timed — on exactly the path's tensors. ``targets`` lists (module,
    attribute) pairs; a call is kept under the attribute's name, or under
    ``key(name, kwargs)`` when that is given."""

    def __init__(self, targets, key=None):
        self.calls = {}
        self._restore = []
        self._key = key or (lambda name, kwargs: name)
        for mod, name in targets:
            fn = getattr(mod, name)
            self._restore.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            self.calls.setdefault(self._key(name, kwargs), (args, kwargs))
            return fn(*args, **kwargs)
        return wrapper

    def close(self):
        for mod, attr, fn in self._restore:
            setattr(mod, attr, fn)


def _cfg(args, backend, n_ranks=None):
    from repro_torch.core import PipelineConfig
    return PipelineConfig(
        n_ranks=n_ranks or args.ranks, backend=backend, device="cuda",
        metrics=METRICS,
        group_by="k_device", reducers=("moments", "quantile"),
        anomaly_score="p99", agg_interval_ns=10_000_000)


def _spec(args):
    from repro_torch.core import SyntheticSpec
    return SyntheticSpec(n_ranks=args.ranks, kernels_per_rank=105_000,
                         memcpys_per_rank=13_400,
                         duration_s=float(args.duration), seed=args.seed)


def _launch_counters():
    from repro_torch.kernels.binstats import ops as bs
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.kernels.histbin import ops as hb
    from repro_torch.kernels.iqr import ops as iq
    from repro_torch.kernels.rolling import ops as ro
    from repro_torch.kernels.ssd import ops as sd
    return {"binstats_flat": bs.binstats_flat, "binstats": bs.binstats,
            "histbin_flat": hb.histbin_flat, "histbin": hb.histbin,
            "iqr_fences": iq.iqr_fences, "ssd_fused": sd.ssd_fused,
            "flash_attention": fa.flash_attention,
            "rolling_stats": ro.rolling_stats}


def _zero(counters):
    """Set every launch count to 0, the tensor-core counts of
    flash_attention and ssd_fused and flash_attention's counts by
    instantiation too."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "wgmma_launches"):
            fn.wgmma_launches = 0
        if hasattr(fn, "instances"):
            fn.instances.clear()


def _assert_torch_close(agg, anomalies, ser_agg, ser_anomalies):
    """The torch backend's result against the exact serial one: counts,
    min/max (in float32), sketch totals and fence flags exactly, sums
    within RTOL."""
    import numpy as np
    a, b = agg.grouped, ser_agg.grouped
    occ = b.count > 0
    np.testing.assert_array_equal(a.count, b.count)
    for f in ("min", "max"):
        np.testing.assert_array_equal(
            np.where(occ, getattr(a, f), 0.0),
            np.where(occ, getattr(b, f).astype(np.float32), 0.0))
    for f in ("sum", "sumsq"):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                   rtol=RTOL)
    np.testing.assert_array_equal(agg.reduced["quantile"].counts.sum(-1),
                                  ser_agg.reduced["quantile"].counts.sum(-1))
    np.testing.assert_array_equal(anomalies.flags, ser_anomalies.flags)


def phase_main(args, work):
    import numpy as np
    import torch

    from repro_torch.core import (VariabilityPipeline, generate_synthetic,
                                  recovered, write_synthetic_dbs)
    from repro_torch.core.aggregation import producer_stats

    ds = generate_synthetic(_spec(args))
    paths = write_synthetic_dbs(ds, os.path.join(work, "dbs"))
    store = os.path.join(work, "store")
    from repro_torch.core import anomaly, distributed
    from repro_torch.kernels.iqr import ops as iq
    counters = _launch_counters()
    cap = Capture(((distributed, "binstats_flat"),
                   (distributed, "histbin_flat"), (anomaly, "iqr_fences")))
    try:
        _zero(counters)
        t0 = time.perf_counter()
        res = VariabilityPipeline(_cfg(args, "torch")).run(paths, store)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        cap.close()
    gen = res.generation
    log(f"main: {len(paths)} rank DBs, rows per table {gen.rows_per_table},"
        f" {gen.joined_rows} joined rows, {gen.n_shards} shards; "
        f"phase 1 {gen.seconds:.3f}s, phase 2+3 "
        f"{wall - gen.seconds:.3f}s, total {wall:.3f}s")
    log(f"main: device batch {producer_stats()}")
    log(f"main: launches {launches}; iqr_fences launches through "
        f"torch.ops.{iq._operator()}")
    for name in ("binstats_flat", "histbin_flat", "iqr_fences"):
        if launches[name] < 1:
            raise AssertionError(f"main path never launched {name}")
    frac = recovered(ds.anomaly_windows, res.anomaly_windows,
                     tol_ns=1_000_000_000)
    log(f"main: injected windows recovered {frac * 100:.0f}% "
        f"(top bins {res.anomalies.top_idx.tolist()})")
    if frac < 1.0:
        raise AssertionError("injected anomaly windows not recovered")

    ser = VariabilityPipeline(_cfg(args, "serial")).run(
        paths, os.path.join(work, "store_serial"))
    pids = sorted({w["pid"] for w in gen.workers})
    log(f"main: phase 1 {gen.seconds:.3f}s on the rank pool ({len(pids)} "
        f"worker processes, pids {pids}), {ser.generation.seconds:.3f}s in "
        f"the serial backend's in-process loop; {len(pids)} of "
        f"{args.ranks} ranks on their own process")
    if args.ranks > 1 and len(pids) < 2:
        raise AssertionError("the torch backend's phase 1 ran on one process")
    _assert_torch_close(res.aggregation, res.anomalies, ser.aggregation,
                        ser.anomalies)
    log(f"main: torch == serial (counts/min/max exact, sums rtol {RTOL}, "
        f"sketch totals exact, {int(res.anomalies.flags.sum())} flags "
        "equal)")
    if not np.isfinite(res.anomalies.scores).all():
        raise AssertionError("non-finite anomaly scores")

    errs = {}
    args_bs, _ = cap.calls["binstats_flat"]
    errs["binstats_flat"] = moments_err(
        counters["binstats_flat"](*args_bs),
        _plain("binstats_flat")(*args_bs))
    args_hb, _ = cap.calls["histbin_flat"]
    errs["histbin_flat"] = hist_err(counters["histbin_flat"](*args_hb),
                                    _plain("histbin_flat")(*args_hb))
    args_iq, kw_iq = cap.calls["iqr_fences"]
    errs["iqr_fences"] = iqr_err(counters["iqr_fences"](*args_iq, **kw_iq),
                                 _plain("iqr_fences")(*args_iq, **kw_iq))
    n_bins = int(res.aggregation.plan.n_shards)
    ts_args = _ts_inputs(args_bs, n_bins)
    errs["binstats"] = moments_err(counters["binstats"](*ts_args[0],
                                                        **ts_args[1]),
                                   _plain("binstats")(*ts_args[0],
                                                      **ts_args[1]))
    errs["histbin"] = hist_err(counters["histbin"](*ts_args[0],
                                                   **ts_args[1]),
                               _plain("histbin")(*ts_args[0],
                                                 **ts_args[1]))
    torch.cuda.synchronize()
    shapes = {"binstats_flat": args_bs, "histbin_flat": args_hb,
              "iqr_fences": (args_iq, kw_iq), "ts": ts_args}
    # each source rank's kernel memory-stall durations (float32 ns) in
    # start order, for the stall phase
    stalls = [tr.kernels.memory_stall[np.argsort(tr.kernels.start,
                                                 kind="stable")]
              for tr in ds.traces]
    return launches, errs, shapes, stalls, paths, res


class _Plain:
    """Within the block the model's SSD scan and attention call the plain
    versions of their kernels (the attributes ``ssm_forward`` and
    ``attn_forward`` look up are replaced)."""

    def __enter__(self):
        from repro_torch.models import attention, ssm
        self._fns = ((ssm, "ssd_fused", ssm.ssd_fused),
                     (attention, "flash_attention",
                      attention.flash_attention))
        for mod, name, _ in self._fns:
            setattr(mod, name, _plain(name))

    def __exit__(self, *exc):
        for mod, name, fn in self._fns:
            setattr(mod, name, fn)


class _Routing:
    """The MoE layers' expert choices of one run, replayed in another.

    Inside ``record()`` every ``moe._route`` call keeps its top-k expert
    indices; inside ``replay()`` the calls, in the same order, take those
    indices, with routing weights from their own router probabilities,
    and count the tokens whose own top-k set differs (``flips``, one
    count a call). Top-k routing is discrete: a rounding step of
    difference in a layer's input moves a token whose k-th and (k+1)-th
    experts are near a tie to another expert, and the moved tokens
    compound over the layers, so two bfloat16 runs that differ only in
    their attention's rounding are compared under the same choices."""

    def __init__(self):
        self.chosen, self.flips = [], []

    @contextlib.contextmanager
    def _patched(self, fn):
        from repro_torch.models import moe
        self._real = moe._route
        moe._route = fn
        try:
            yield self
        finally:
            moe._route = self._real

    def record(self):
        return self._patched(self._record)

    def replay(self):
        self.flips = []
        return self._patched(self._replay)

    def _record(self, router_w, tokens, cfg):
        out = self._real(router_w, tokens, cfg)
        self.chosen.append(out[1])
        return out

    def _replay(self, router_w, tokens, cfg):
        import torch
        _, own, aux = self._real(router_w, tokens, cfg)
        top_i = self.chosen[len(self.flips)]
        self.flips.append(int((own.sort(-1).values != top_i.sort(-1).values
                               ).any(-1).sum()))
        top_w = torch.softmax(tokens.float() @ router_w.float(), -1).gather(
            -1, top_i)
        if cfg.renorm_weights:
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        return top_w, top_i, aux


def _flash_key(name, kwargs):
    """Capture key: the first global and the first window layer's
    attention calls are kept apart."""
    if name != "flash_attention":
        return name
    return f"{name}/{'window' if kwargs.get('window') else 'global'}"


def _expected_launches(cfg):
    """One ssd_fused per SSM or hybrid layer and one flash_attention per
    attention or hybrid layer, in one prefill."""
    n = {"ssd_fused": 0, "flash_attention": 0}
    for spec, count in cfg.plan:
        n["ssd_fused"] += count * (spec.kind in ("ssm", "hybrid"))
        n["flash_attention"] += count * (spec.kind in ("attn", "hybrid"))
    return n


def _serve_batch(cfg, seed, b, prompt, grid=0):
    """numpy inputs of ``b`` requests of ``prompt`` random text tokens
    from ``seed``, after a ``grid`` x ``grid`` image of random patches and
    their M-RoPE ids for the VLM (``launch/serve.py``'s rule)."""
    import numpy as np

    from repro_torch.launch.serve import vlm_inputs
    rng = np.random.default_rng(seed)
    batch = vlm_inputs(cfg, rng, b, grid, prompt) if grid else {}
    batch["tokens"] = rng.integers(0, cfg.vocab, (b, prompt))
    return batch


def _head(batch, n):
    """The first ``n`` text tokens of a serving batch (and their
    positions)."""
    p = batch["patches"].shape[1] if "patches" in batch else 0
    return {k: (v[:, :n] if k == "tokens" else v[..., :p + n]
                if k == "positions3" else v) for k, v in batch.items()}


def cut_depth(cfg, counts):
    """``cfg`` with segment i cut to ``counts[i]`` layers, a segment cut
    to 0 left out (``counts`` None: ``cfg`` as it is)."""
    import dataclasses
    if counts is None:
        return cfg
    return dataclasses.replace(cfg, plan=tuple(
        (spec, n) for (spec, _), n in zip(cfg.plan, counts, strict=True)
        if n))


def _init_model(arch, args, dev, tag):
    """``arch``'s full config, its depth cut as DEPTH_CUTS says, and its
    random bfloat16 parameters drawn on the card, their count held to the
    reference's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model

    cfg = cut_depth(get_config(arch), DEPTH_CUTS.get(arch))
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    log(f"{tag}: {cfg.name}, {cfg.n_layers} layers "
        f"{[n for _, n in cfg.plan]}, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {cfg.meta_tokens} meta tokens, {n_params} "
        f"parameters in {cfg.dtype}, drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s; "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated, "
        f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    if n_params != PARAM_COUNTS[arch]:
        raise AssertionError(f"{n_params} parameters, the reference has "
                             f"{PARAM_COUNTS[arch]}")
    return cfg, params


def _check_launches(cfg, launches, tc, tag):
    """One launch of each kernel a layer runs, every one on its
    tensor-core kernel."""
    log(f"{tag}: launches {launches}; on the tensor-core kernels {tc}")
    for name, want in _expected_launches(cfg).items():
        if launches[name] != want:
            raise AssertionError(f"{tag} launched {name} {launches[name]} "
                                 f"times, expected one per layer that runs "
                                 f"it ({want})")
        if tc[name] != launches[name]:
            raise AssertionError(f"{launches[name]} {name} launches, "
                                 f"{tc[name]} of them on the tensor-core "
                                 "kernel: every bfloat16 call of the path "
                                 "should be")


def _captured_errs(calls, tag):
    """Each captured call's kernel against its plain version on the
    path's own inputs: the largest |kernel - plain| by kernel."""
    errs = {}
    for key, (c_args, c_kw) in calls.items():
        name = key.split("/")[0]
        check = ssd_err if name == "ssd_fused" else flash_err
        err = check(_launch_counters()[name](*c_args, **c_kw),
                    _plain(name)(*c_args, **c_kw))
        log(f"{tag}: {key} on the path's own inputs "
            f"{[tuple(a.shape) for a in c_args if hasattr(a, 'shape')]} "
            f"{c_kw}: largest |kernel - plain| {err}")
        errs[name] = max(errs.get(name, 0.0), err)
    return errs


def _log_profile(tag, name, prof, per):
    wall, busy, top = prof
    if busy is None:
        log(f"{tag} profile {name}: device time not measured (the "
            "profiler saw no CUDA kernel)")
        return
    log(f"{tag} profile {name}: device kernels {busy / per:.3f} ms per "
        f"step, host wall {wall / per:.3f} ms per step under the "
        f"profiler; largest: " + "; ".join(
            f"{n} {ms / per:.3f} ms x{c // per}" for n, ms, c in top))


def phase_serve(args, dev, tag):
    """``SERVE_SPECS[tag]``'s model served at full width and depth through
    the port's engine; returns (launches, |kernel - plain| on the path's
    tensors by kernel, the captured calls)."""
    import numpy as np
    import torch

    from repro_torch.models import attention, model, ssm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.telemetry import KIND_DECODE, KIND_PREFILL

    spec = SERVE_SPECS[tag]
    b, n_prompt, n_new = spec["batch"], spec["prompt"], spec["new"]
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params = _init_model(spec["arch"], args, dev, tag)
    host = _serve_batch(cfg, args.seed, b, n_prompt, spec.get("grid", 0))
    prefix = cfg.meta_tokens + spec.get("grid", 0) ** 2
    max_len = prefix + n_prompt + n_new
    scfg = ServeConfig(max_len=max_len, max_new_tokens=n_new,
                       cache_dtype=cfg.dtype)
    # warm-up at a short prompt: library handles, the kernels' attributes
    ServeEngine(cfg, params, ServeConfig(max_len=max_len, max_new_tokens=2),
                device=dev).generate(_head(host, 128))
    engine = ServeEngine(cfg, params, scfg, device=dev)
    counters = _launch_counters()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cap = Capture(((ssm, "ssd_fused"), (attention, "flash_attention")),
                  key=_flash_key)
    try:
        _zero(counters)
        tokens = engine.generate(host)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        tc = {k: counters[k].wgmma_launches
              for k in ("flash_attention", "ssd_fused")}
        insts = dict(counters["flash_attention"].instances)
    finally:
        cap.close()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = engine.telemetry.steps
    pre_ms = [(e.end_ns - e.start_ns) / 1e6 for e in steps
              if e.kind == KIND_PREFILL]
    dec_ms = [(e.end_ns - e.start_ns) / 1e6 for e in steps
              if e.kind == KIND_DECODE]
    _check_launches(cfg, launches, tc, tag)
    if "flash_instance" in spec:
        want = {spec["flash_instance"]: launches["flash_attention"]}
        log(f"{tag}: flash_attention launches by instantiation {insts}")
        if insts != want:
            raise AssertionError(f"flash_attention ran in {insts}, "
                                 f"expected {want}")
    if tokens.shape != (b, n_new) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"bad tokens {tokens.shape}")
    errs = _captured_errs(cap.calls, tag)

    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    moe_cfg = next((sp.moe for sp, _ in cfg.plan if sp.moe is not None),
                   None)
    torch.cuda.reset_peak_memory_stats(dev)
    routing = _Routing()
    with torch.inference_mode():
        with routing.record():
            lg_k, _, _ = model.prefill(cfg, params, batch, max_len,
                                       cfg.dtype)
        with _Plain():
            lg_p, _, _ = model.prefill(cfg, params, batch, max_len,
                                       cfg.dtype)
        if moe_cfg is not None:
            # the plain prefill under the kernel run's expert choices
            # (``_Routing``): the gate below holds it to the kernel's; the
            # free-running gap and the moved tokens are printed beside
            free = _logit_gap(lg_k, lg_p)
            with _Plain(), routing.replay():
                lg_p, _, _ = model.prefill(cfg, params, batch, max_len,
                                           cfg.dtype)
            _, _, m, _ = model.forward_hidden(cfg, params, batch, "prefill")
            log(f"{tag}: prefill dropped share {float(m['dropped']):.6f} "
                f"(mean over the layers), aux loss "
                f"{float(m['aux_loss']):.6f}; plain prefill free-running: "
                f"last-token logits |kernel - plain| max {free[0]:.6f}, "
                f"mean {free[1]:.6f}; by layer, the tokens (of "
                f"{b * (prefix + n_prompt)}) whose own top-"
                f"{moe_cfg.top_k} experts in the plain prefill "
                f"differ from the kernel run's choice: {routing.flips}")
            del m
    log(f"{tag}: peak memory through the prefills with the kernels and "
        f"the plain versions "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    with _Plain():
        tokens_p = ServeEngine(cfg, params, scfg, device=dev).generate(host)
    if not (bool(torch.isfinite(lg_k).all()) and
            tuple(lg_k.shape) == (b, cfg.vocab)):
        raise AssertionError("kernel logits not finite or misshapen")
    d_max, d_mean = _logit_gap(lg_k, lg_p)
    top2 = lg_p.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    first_k, first_p = lg_k.argmax(-1).cpu().numpy(), \
        lg_p.argmax(-1).cpu().numpy()
    if not np.array_equal(first_k, tokens[:, 0]):
        raise AssertionError("the engine's first tokens differ from its "
                             "own prefill's")
    bad = (first_k != first_p) & (gap >= LOGIT_MAX_TOL)
    log(f"{tag}: last-token logits |kernel - plain| max {d_max:.6f}, mean "
        f"{d_mean:.6f} (tolerance {LOGIT_MAX_TOL} / {LOGIT_MEAN_TOL}); "
        f"plain top-2 gaps {np.round(gap, 4).tolist()}")
    if d_max > LOGIT_MAX_TOL or d_mean > LOGIT_MEAN_TOL or bad.any():
        raise AssertionError("kernel and plain prefill disagree")
    agree = int((tokens == tokens_p).sum())
    log(f"{tag}: batch {b} x ({prefix} meta and patch + {n_prompt} prompt)"
        f" + {n_new} new tokens; prefill {pre_ms[0]:.3f} ms, "
        f"decode median {float(np.median(dec_ms)):.3f} ms/token "
        f"(min {min(dec_ms):.3f}, max {max(dec_ms):.3f}, "
        f"{len(dec_ms)} steps); peak memory "
        f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB live "
        f"before); first tokens equal {int((first_k == first_p).sum())}"
        f"/{b}; kernel and plain generations agree on "
        f"{agree}/{tokens.size} tokens")
    if "cont" in spec:
        _continuation(cfg, params, dev, args.seed, tag, *spec["cont"])

    # where the serving time goes on the device: kernel time by name under
    # torch.profiler, for one prefill and for 8 decode steps
    with torch.inference_mode():
        pre = _device_profile(lambda: model.prefill(
            cfg, params, batch, max_len, cfg.dtype))
        lg, caches, index = model.prefill(cfg, params, batch, max_len,
                                          cfg.dtype)
        tok = [lg.argmax(-1)[:, None]]

        def decode(n=8):
            for t in range(n):
                lg_t, _ = model.decode_step(cfg, params, tok[0], caches,
                                            index + t)
                tok[0] = lg_t.argmax(-1)[:, None]
        dec = _device_profile(decode)
        del caches
    _log_profile(tag, "prefill", pre, 1)
    _log_profile(tag, "decode", dec, 8)
    return launches, errs, cap.calls


def phase_encode(args, dev, tag="encode-hubert"):
    """hubert-xlarge's encoder forward at full width and depth:
    ``loss_fn`` under inference mode on the data pipeline's frames batch
    (``ENCODE_SPEC``), with the kernel and with the plain version; returns
    (launches, |kernel - plain| by kernel, the captured calls)."""
    import torch

    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import attention, model, ssm
    from repro_torch.train.step import batch_to

    spec = ENCODE_SPEC
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, params = _init_model(spec["arch"], args, dev, tag)
    batch = batch_to(make_batch(cfg, DataConfig(
        batch=spec["batch"], seq=spec["frames"], seed=args.seed), 0), dev)
    with torch.inference_mode():
        model.loss_fn(cfg, params, {k: v[:, :128] for k, v in
                                    batch.items()})      # warm-up
    counters = _launch_counters()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cap = Capture(((ssm, "ssd_fused"), (attention, "flash_attention")),
                  key=_flash_key)
    try:
        _zero(counters)
        t0 = time.perf_counter()
        with torch.inference_mode():
            loss_k, m_k = model.loss_fn(cfg, params, batch)
            loss_k = float(loss_k)
        fwd_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: fn.launches for k, fn in counters.items()}
        tc = {k: counters[k].wgmma_launches
              for k in ("flash_attention", "ssd_fused")}
    finally:
        cap.close()
    peak = torch.cuda.max_memory_allocated(dev)
    _check_launches(cfg, launches, tc, tag)
    errs = _captured_errs(cap.calls, tag)
    with torch.inference_mode(), _Plain():
        loss_p = float(model.loss_fn(cfg, params, batch)[0])
    gap = abs(loss_k - loss_p)
    log(f"{tag}: batch {spec['batch']} x {spec['frames']} frames of "
        f"{cfg.frontend_dim}; loss {loss_k:.6f} (ce {float(m_k['ce']):.6f}),"
        f" plain {loss_p:.6f}, |kernel - plain| {gap:.6f} (tolerance "
        f"{TRAIN_LOSS_TOL}); forward {fwd_ms:.3f} ms; peak memory "
        f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB live before)")
    if not math.isfinite(loss_k) or gap > TRAIN_LOSS_TOL:
        raise AssertionError("kernel and plain encoder forward disagree")
    with torch.inference_mode():
        prof = _device_profile(lambda: model.loss_fn(cfg, params, batch))
    _log_profile(tag, "forward", prof, 1)
    return launches, errs, cap.calls


# the training phases' depth cuts: the layers kept of each segment and the
# reference's parameter count of the cut config (jax.eval_shape of its
# init_params; tests/test_torch_train_families.py checks them). A step
# holds 20 B a parameter (float32 master weights, Adam's m and v, the
# bfloat16 working copy and gradients, the float32 accumulator), so each
# cut is the most layers whose state fits one 80 GB card; mamba2's (24 of
# 48, 3.9 GiB) is for the time limit instead: at full depth the script
# took 1201.2 s on one H100 80GB HBM3 at 700 W with a slow host, its train
# phase 202.5 s of it
TRAIN_DEPTH_CUTS = {
    "mamba2-370m": ((24,), 209_913_088),
    "nemotron-4-15b": ((1,), 3_535_816_704),      # 65.9 GiB: the head is
    "starcoder2-15b": ((4,), 2_139_205_632),      # 3.15 B of it; 39.8 GiB
    "qwen2-vl-7b": ((8,), 2_959_048_192),         # 55.1 GiB
    "deepseek-v2-236b": ((1, 0), 862_274_560),    # the dense layer, 16.1 GiB
}
# deepseek's MoE layers under training: 4.83 B parameters with one MoE
# layer (97 GB of training state) fit no card, so its gradient check runs
# on the dense layer and one MoE layer in the bfloat16 working copy with no
# optimizer state (27 GiB for the weights and the two gradient sets)
DEEPSEEK_MOE_CHECK = ((1, 1), 4_834_391_040)
# one spec a training phase: the architecture at full width (and depth but
# for TRAIN_DEPTH_CUTS), the sequence (hymba's 128 meta tokens come on top;
# qwen2-vl's ``patches`` image patches are part of it), microbatch, grad
# accumulation, steps, the asynchronous checkpoint's step (None: no
# checkpoint, no resume), the monitor's period, the peak learning rate (2
# warm-up steps; hymba's loss rose over 6 steps at 1e-3 and at 3e-4; at
# 3e-4 so did stablelm's, danube's, nemotron's, starcoder2's and
# qwen2-vl's, whose first update moves every weight by the same lr: the
# wider the model, the lower the rate its loss falls at), the
# flash_attention instantiation every launch must take. mamba2's 6 steps
# with the checkpoint at step 4 (cut from 12 and 9, then from 8 and 6), its
# 24 layers and no profiled training step leave the time limit room for the
# eight families' phases, the collective phase and the tp phase (at 6 steps
# the means of the first 3 and of the last 3 losses share no step)
TRAIN_SPECS = {
    "train": dict(arch="mamba2-370m", seq=4096, micro=4, accum=2,
                  steps=6, ckpt=4, monitor=3, lr=1e-3),
    "train-hymba": dict(arch="hymba-1.5b", seq=2048, micro=2, accum=2,
                        steps=6, ckpt=None, monitor=3, lr=1e-4,
                        flash_instance=(64, 64)),
    "train-stablelm": dict(arch="stablelm-3b", seq=2048, micro=1, accum=2,
                           steps=6, ckpt=None, monitor=3, lr=1e-5,
                           flash_instance=(128, 128)),
    "train-danube": dict(arch="h2o-danube-1.8b", seq=4200, micro=1,
                         accum=2, steps=6, ckpt=None, monitor=3, lr=3e-5,
                         flash_instance=(128, 128)),   # past its 4096 window
    "train-nemotron": dict(arch="nemotron-4-15b", seq=2048, micro=1,
                           accum=2, steps=6, ckpt=None, monitor=3, lr=3e-6,
                           flash_instance=(128, 128)),
    "train-starcoder2": dict(arch="starcoder2-15b", seq=2048, micro=1,
                             accum=2, steps=6, ckpt=None, monitor=3,
                             lr=3e-6, flash_instance=(128, 128)),
    "train-granite": dict(arch="granite-moe-1b-a400m", seq=2048, micro=2,
                          accum=2, steps=6, ckpt=None, monitor=3, lr=1e-3,
                          flash_instance=(64, 64)),
    "train-qwen2-vl": dict(arch="qwen2-vl-7b", seq=2048, patches=256,
                           micro=1, accum=2, steps=6, ckpt=None, monitor=3,
                           lr=5e-6, flash_instance=(128, 128)),
    "train-hubert": dict(arch="hubert-xlarge", seq=4096, micro=1, accum=2,
                         steps=6, ckpt=None, monitor=3, lr=3e-4,
                         flash_instance=(128, 128)),
    "train-deepseek": dict(arch="deepseek-v2-236b", seq=2048, micro=1,
                           accum=2, steps=6, ckpt=None, monitor=3, lr=3e-4,
                           flash_instance=(192, 128),
                           check=DEEPSEEK_MOE_CHECK),
}
# the training calls of flash_attention timed in train times
TRAIN_FLASH_ROWS = tuple(f"flash_attention/{tag}" for tag, spec in
                         TRAIN_SPECS.items() if "flash_instance" in spec)
TRAIN_LOSS_TOL = 0.05         # |loss with kernels - loss with plain|
TRAIN_COSINE = 0.98           # each matrix gradient, kernels vs plain
RESUME_RTOL = 1e-3            # resumed losses against the uninterrupted
STATE_BYTES = 20              # a parameter's training state in a step
STRAGGLER_HOSTS, STRAGGLER_SLOW = 8, 3.0


def _train_launches(cfg, microbatches):
    """ssd_fused and flash_attention launches of ``microbatches``
    forward + backward passes under remat="full": each layer's forward
    and its recompute (the backward's plain recompute launches
    nothing)."""
    return {k: 2 * microbatches * n
            for k, n in _expected_launches(cfg).items()}


def _leaf_names(params):
    from repro_torch.train.optim import leaves_with_paths
    return ["/".join(str(p) for p in path)
            for path, _ in leaves_with_paths(params)]


def _cosine(a, b):
    """The cosine of two gradients in float64, read a slice at a time
    (``row_slices``: a float64 copy of nemotron-4-15b's 1.57 B-element
    head would take 12.6 GB)."""
    import torch

    from repro_torch.train.optim import row_slices
    dot, na, nb = (torch.zeros((), dtype=torch.float64, device=a.device)
                   for _ in range(3))
    for x, y in zip(row_slices(a), row_slices(b)):
        x, y = x.double(), y.double()
        dot += (x * y).sum()
        na += (x * x).sum()
        nb += (y * y).sum()
    if float(na) == float(nb) == 0.0:
        return 1.0          # a leaf the loss does not reach (hubert's embed)
    return float(dot / (na.sqrt() * nb.sqrt()).clamp_min(1e-30))


def _kernels_against_plain(cfg, params, mb, tag):
    """Loss and gradients of one microbatch with the kernels and under
    ``_Plain``. For an MoE model a second kernel pass must give the
    first one's loss, metrics and gradients bit for bit (the dispatch's
    backward sums each token's k rows), the plain pass takes the kernel
    pass's expert choices (``_Routing``: the forward's and the remat
    recompute's), and the free-running plain loss and the tokens whose
    own top-k differs are printed beside. Returns
    (loss gap, loss with the kernels, plain loss, worst (cosine, leaf),
    the kernels' first calls)."""
    import torch

    from repro_torch.models import attention, model, ssm
    from repro_torch.train.step import (TrainConfig, loss_and_grads,
                                        working_copy)

    def grads():
        return loss_and_grads(cfg, working_copy(cfg, TrainConfig(), params),
                              mb)
    cap = Capture(((ssm, "ssd_fused"), (attention, "flash_attention")),
                  key=_flash_key)
    routing = _Routing()
    try:
        with routing.record():
            loss_k, m_k, g_k = grads()
    finally:
        cap.close()
    if routing.chosen:
        loss_2, m_2, g_2 = grads()
        differ = [name for name, a, b in zip(_leaf_names(params), g_k, g_2)
                  if not torch.equal(a, b)]
        same_m = all(torch.equal(m_k[k], m_2[k]) for k in m_k)
        log(f"{tag}: a second kernel pass of the first microbatch: loss "
            f"{float(loss_2)!r} (first {float(loss_k)!r}), metrics equal "
            f"{same_m}, {len(g_k) - len(differ)} of {len(g_k)} gradients "
            f"equal bit for bit")
        if differ or not same_m or not torch.equal(loss_k, loss_2):
            raise AssertionError(f"{tag}: two kernel passes differ "
                                 f"(gradients {differ[:5]})")
        del g_2
        with torch.no_grad(), _Plain():
            free = float(model.loss_fn(cfg, params, mb)[0])
        with _Plain(), routing.replay():
            loss_p, _, g_p = grads()
        log(f"{tag}: dropped share {float(m_k['dropped']):.6f}, aux loss "
            f"{float(m_k['aux_loss']):.6f}; plain loss free-running "
            f"{free:.6f} (gap to the kernels' {abs(free - float(loss_k)):.6f});"
            f" by call (each layer's forward, then the remat recomputes "
            f"from the last layer), the tokens (of {mb['labels'].numel()}) "
            f"whose own top-k experts in the plain pass differ from the "
            f"kernel pass's choice: {routing.flips}")
    else:
        with _Plain():
            loss_p, _, g_p = grads()
    worst = (2.0, "")
    for name, a, b in zip(_leaf_names(params), g_k, g_p):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag}: gradient {name} not finite")
        if a.dim() >= 2:
            worst = min(worst, (_cosine(a, b), name))
    calls = {k: (tuple(t.detach() if hasattr(t, "detach") else t
                       for t in a), kw) for k, (a, kw) in cap.calls.items()}
    return abs(float(loss_k) - float(loss_p)), float(loss_k), \
        float(loss_p), worst, calls


def _straggler_check(dev, tag):
    """8 hosts, one 3x slower: the monitor on the card flags exactly the
    hosts numpy's fences flag, with the same fence, and reports what the
    monitor on the host reports."""
    import numpy as np

    from repro_torch.telemetry import (KIND_TRAIN, StragglerMonitor,
                                       TelemetryRecorder)
    rng = np.random.default_rng(7)
    rec = TelemetryRecorder(n_hosts=STRAGGLER_HOSTS, device=dev)
    t, step_ns = 1_000_000_000_000, 50_000_000
    for i in range(60):
        for h in range(STRAGGLER_HOSTS):
            d = int(step_ns * (STRAGGLER_SLOW if h == 3 else 1.0)
                    * (1 + 0.05 * rng.random()))
            rec.record_step(h, t, t + d, KIND_TRAIN, 0.02 * d, i)
        t += int(step_ns * 1.1)
    rep = StragglerMonitor(device=dev).analyze(rec)
    host = StragglerMonitor(device="cpu").analyze(rec)
    means = np.array([rec.step_durations(h).mean()
                      for h in range(STRAGGLER_HOSTS)])
    q1, q3 = np.percentile(means[means != 0.0], [25.0, 75.0])
    hi = q3 + 1.5 * (q3 - q1)
    want = [int(i) for i in np.nonzero(means > hi)[0]]
    log(f"{tag}: straggler monitor on the card: hosts "
        f"{rep.straggler_hosts} (numpy's fences {want}), upper fence "
        f"{rep.hi_fence_ns!r} ns (numpy {float(hi)!r}), action {rep.action}, "
        f"{len(rep.anomalous_windows)} windows")
    if rep.straggler_hosts != want or want != [3] or rep.hi_fence_ns != hi:
        raise AssertionError("the monitor's fences on the card differ from "
                             "numpy's")
    if (rep.straggler_hosts, rep.action) != (host.straggler_hosts,
                                             host.action) or not \
            np.array_equal(rep.anomalous_windows, host.anomalous_windows):
        raise AssertionError("the monitor on the card and on the host "
                             "disagree")


def _train_cfg(arch, cut=None):
    """(config, parameter count): ``arch``'s full config cut to ``cut`` =
    (layers a segment, the reference's count of the cut) or, by default,
    as TRAIN_DEPTH_CUTS says (full depth where it says nothing)."""
    from repro_torch.configs import get_config
    counts, n = cut or TRAIN_DEPTH_CUTS.get(arch, (None, PARAM_COUNTS[arch]))
    return cut_depth(get_config(arch), counts), n


def phase_train(args, dev, card, tag):
    """``TRAIN_SPECS[tag]`` trained at full width (its depth cut as
    TRAIN_DEPTH_CUTS says) through ``Trainer.run`` on the card; returns
    (launches, |kernel - plain| on the path's own inputs by kernel, the
    kernels' first calls, the monitor's largest fence table)."""
    import numpy as np
    import torch

    from repro_torch.core import (GenerationConfig, PipelineConfig,
                                  VariabilityPipeline, anomaly)
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import model
    from repro_torch.telemetry import KIND_TRAIN
    from repro_torch.train import (AdamWConfig, RunConfig, TrainConfig,
                                   Trainer)
    from repro_torch.train.step import batch_to

    spec = TRAIN_SPECS[tag]
    cfg, n_params = _train_cfg(spec["arch"])
    micro, accum, steps = spec["micro"], spec["accum"], spec["steps"]
    tcfg = TrainConfig(optim=AdamWConfig(peak_lr=spec["lr"], warmup_steps=2,
                                         total_steps=steps),
                       grad_accum=accum)
    dcfg = DataConfig(batch=micro * accum, seq=spec["seq"], seed=args.seed,
                      vlm_patches=spec.get("patches", 64))
    tokens = micro * accum * spec["seq"]
    state_gib = STATE_BYTES * n_params / 2**30
    log(f"{tag}: {cfg.name} at full width ({cfg.n_layers} layers "
        f"{[n for _, n in cfg.plan]}, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {cfg.meta_tokens} meta tokens), {n_params} "
        f"parameters, {state_gib:.1f} GiB of training state at "
        f"{STATE_BYTES} B each; float32 master weights, a {cfg.dtype} "
        f"working copy, remat {cfg.remat!r}; microbatch {micro} x "
        f"{spec['seq']} positions, grad_accum {accum}, {steps} steps, peak "
        f"lr {spec['lr']}, seed {args.seed} [{card}]")

    # the first microbatch with the kernels and with the plain versions, on
    # the bfloat16 working copy alone (``spec["check"]``: a deeper cut)
    c_cfg, c_n = _train_cfg(spec["arch"], spec.get("check"))
    params = model.init_params(c_cfg, seed=args.seed, device=dev)
    if model.param_count(params) != c_n:
        raise AssertionError(f"{tag}: {model.param_count(params)} "
                             f"parameters, the reference has {c_n}")
    mb = batch_to({k: v[:micro] for k, v in
                   make_batch(c_cfg, dcfg, 0).items()}, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gap, loss_k, loss_p, (cos, leaf), calls = _kernels_against_plain(
        c_cfg, params, mb, tag)
    log(f"{tag}: first microbatch on {c_cfg.n_layers} layers "
        f"{[n for _, n in c_cfg.plan]} ({c_n} parameters), loss with the "
        f"kernels {loss_k:.6f}, with the plain versions {loss_p:.6f} (gap "
        f"{gap:.6f}, tolerance {TRAIN_LOSS_TOL}); smallest gradient cosine "
        f"{cos:.6f} at {leaf} (tolerance {TRAIN_COSINE}); peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    del params, mb
    torch.cuda.empty_cache()
    if gap > TRAIN_LOSS_TOL or cos < TRAIN_COSINE:
        raise AssertionError(f"{tag}: kernels and plain versions disagree")
    errs = {}
    for key, (c_args, c_kw) in calls.items():
        name = key.split("/")[0]
        check = ssd_err if name == "ssd_fused" else flash_err
        errs[name] = max(errs.get(name, 0.0), check(
            _launch_counters()[name](*c_args, **c_kw),
            _plain(name)(*c_args, **c_kw)))
    log(f"{tag}: kernels on the path's first-layer inputs, largest "
        f"|kernel - plain| {errs}")

    # the run: counters zeroed just before Trainer.run, read just after
    work = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    try:
        rcfg = RunConfig(steps=steps, ckpt_every=spec["ckpt"] or 0,
                         monitor_every=spec["monitor"], log_every=1,
                         workdir=os.path.join(work, "run"))
        trainer = Trainer(cfg, tcfg, dcfg, rcfg, seed=args.seed, device=dev)
        fences, analyses = [], [0]
        real_fences, real_analyze = anomaly.iqr_fences, \
            trainer.monitor.analyze

        def fences_kept(*a, **k):
            fences.append((a, k))
            return real_fences(*a, **k)

        def analyze_counted(rec):
            analyses[0] += 1
            return real_analyze(rec)
        anomaly.iqr_fences = fences_kept
        trainer.monitor.analyze = analyze_counted
        counters = _launch_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            _zero(counters)
            t0 = time.perf_counter()
            res = trainer.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            tc = {k: counters[k].wgmma_launches
                  for k in ("ssd_fused", "flash_attention")}
            insts = dict(counters["flash_attention"].instances)
        finally:
            anomaly.iqr_fences = real_fences
        peak = torch.cuda.max_memory_allocated(dev)
        losses = res["losses"]
        if model.param_count(res["state"]["params"]) != n_params:
            raise AssertionError(f"{tag}: the trained model does not hold "
                                 f"the reference's {n_params} parameters")
        want = _train_launches(cfg, steps * accum)
        log(f"{tag}: launches {launches}; on the tensor-core kernels {tc}; "
            f"flash_attention by instantiation {insts}; expected {want} "
            f"(one forward and one remat recompute a layer a microbatch); "
            f"{analyses[0]} monitor analyses, actions "
            f"{[a for a, _ in res['monitor_actions']]}")
        for name, n in want.items():
            if launches[name] != n or tc[name] != n:
                raise AssertionError(f"{tag}: {name} launched "
                                     f"{launches[name]} times, {tc[name]} "
                                     f"on its tensor-core kernel; expected "
                                     f"{n}")
        inst_want = ({spec["flash_instance"]: want["flash_attention"]}
                     if want["flash_attention"] else {})
        if insts != inst_want:
            raise AssertionError(f"{tag}: flash_attention ran in {insts}, "
                                 f"expected {inst_want}")
        if analyses[0] < 1 or launches["iqr_fences"] < analyses[0]:
            raise AssertionError(f"{tag}: {launches['iqr_fences']} "
                                 f"iqr_fences launches for {analyses[0]} "
                                 "monitor analyses")
        step_ms = [(e.end_ns - e.start_ns) / 1e6
                   for e in trainer.telemetry.steps if e.kind == KIND_TRAIN]
        med = float(np.median(step_ms))
        log(f"{tag}: step ms median {med:.1f} (min {min(step_ms):.1f}, max "
            f"{max(step_ms):.1f}, {len(step_ms)} steps, the first with the "
            f"warm-up); {tokens / med * 1e3:.0f} tokens/s at the median; "
            f"peak memory {peak / 2**30:.3f} GiB (the state reckoned at "
            f"{state_gib:.1f} GiB); run {wall:.2f}s with its checkpoints "
            f"and monitor [{card}]")
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        log(f"{tag}: losses {np.round(losses, 4).tolist()}; mean of the "
            f"first 3 {first:.4f}, of the last 3 {last:.4f}")
        if not np.isfinite(losses).all() or not last < first:
            raise AssertionError(f"{tag}: losses not finite or not falling")

        if spec["ckpt"]:
            _resume_check(cfg, tcfg, dcfg, rcfg, args, dev, work, losses,
                          spec["ckpt"], tag)
            # the run's own telemetry through the port's pipeline
            dbs = [os.path.join(res["telemetry_dir"], "rank0.sqlite")]
            t0 = time.perf_counter()
            out = VariabilityPipeline(PipelineConfig(
                n_ranks=1, backend="torch", device=str(dev),
                generation=GenerationConfig(interval_ns=1_000_000_000))).run(
                    dbs, os.path.join(work, "store"))
            n_events = len(trainer.telemetry.steps)
            rows = out.generation.joined_rows
            log(f"{tag}: the run's telemetry DB through VariabilityPipeline"
                f" (torch backend, card): {rows} rows of {n_events} step "
                f"events, {out.aggregation.plan.n_shards} bins, top windows "
                f"{out.anomaly_windows.tolist()}, "
                f"{time.perf_counter() - t0:.2f}s")
            if rows != n_events or not np.isfinite(
                    out.anomalies.scores).all():
                raise AssertionError(f"{tag}: the telemetry did not go "
                                     "through the pipeline")
            _straggler_check(dev, tag)

    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the monitor's largest fence table, kernel against plain version
    table = max(fences, key=lambda c: c[0][0].shape[0])
    errs["iqr_fences"] = iqr_err(_launch_counters()["iqr_fences"](
        *table[0], **table[1]), _plain("iqr_fences")(*table[0], **table[1]))
    log(f"{tag}: iqr_fences on the monitor's largest table "
        f"({table[0][0].shape[0]} scores, {table[0][0].dtype}): |kernel - "
        f"plain| {errs['iqr_fences']}")
    return launches, errs, calls, table


def _resume_check(cfg, tcfg, dcfg, rcfg, args, dev, work, losses, at, tag):
    """A second Trainer resumes from the step-``at`` checkpoint alone and
    must give the uninterrupted run's later losses."""
    import dataclasses

    import numpy as np

    from repro_torch.train import Trainer
    src = os.path.join(rcfg.workdir, "ckpt", f"step_{at:09d}")
    dst_run = os.path.join(work, "resumed")
    dst = os.path.join(dst_run, "ckpt", f"step_{at:09d}")
    os.makedirs(dst)
    for name in os.listdir(src):
        os.link(os.path.join(src, name), os.path.join(dst, name))
    t0 = time.perf_counter()
    again = Trainer(cfg, tcfg, dcfg, dataclasses.replace(
        rcfg, workdir=dst_run, ckpt_every=0), seed=args.seed,
        device=dev).run()
    gaps = np.abs(np.asarray(again["losses"]) - np.asarray(losses[at:])) \
        / np.abs(np.asarray(losses[at:]))
    log(f"{tag}: resumed from the step-{at} checkpoint: losses "
        f"{np.round(again['losses'], 4).tolist()}, largest relative gap "
        f"to the uninterrupted run {float(gaps.max()):.3e} (tolerance "
        f"{RESUME_RTOL}), {time.perf_counter() - t0:.2f}s")
    if len(again["losses"]) != len(losses) - at or gaps.max() > RESUME_RTOL:
        raise AssertionError(f"{tag}: the resumed run differs")


def _logit_gap(a, b):
    d = (a - b).abs()
    return float(d.max()), float(d.mean())


def _continuation(cfg, params, dev, seed, tag, batch, prompt):
    """prefill(N - 1) + one decode step against prefill(N) on the card,
    at a prompt whose meta + text positions pass the attention window."""
    import numpy as np
    import torch

    from repro_torch.models import model

    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (batch, prompt)), device=dev)
    max_len = cfg.meta_tokens + prompt
    with torch.inference_mode():
        lg_full, _, _ = model.prefill(cfg, params, {"tokens": toks},
                                      max_len, cfg.dtype)
        _, caches, idx = model.prefill(cfg, params,
                                       {"tokens": toks[:, :-1]}, max_len,
                                       cfg.dtype)
        lg, _ = model.decode_step(cfg, params, toks[:, -1:], caches, idx)
    d_max, d_mean = _logit_gap(lg, lg_full)
    log(f"{tag}: continuation at batch {batch}, {cfg.meta_tokens} meta"
        f" + {prompt} prompt positions: prefill(N-1) + decode vs "
        f"prefill(N) logits max {d_max:.6f}, mean {d_mean:.6f}")
    if not bool(torch.isfinite(lg).all()) or d_max > LOGIT_MAX_TOL or \
            d_mean > LOGIT_MEAN_TOL:
        raise AssertionError("decode does not continue the prefill")


def _device_profile(fn):
    """Run ``fn`` under torch.profiler; return (host wall ms, summed device
    kernel ms or None when the profiler saw none, the ten kernels with the
    most device time as (name, ms, launches))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not kern:
        return wall, None, []
    kern.sort(key=lambda e: -e.self_device_time_total)
    return (wall, sum(e.self_device_time_total for e in kern) / 1e3,
            [(e.key[:48], e.self_device_time_total / 1e3, e.count)
             for e in kern[:10]])


def kernel_names(source):
    """The ``__global__`` kernels of ``csrc/<source>.cu``, by name."""
    import re
    from repro_torch.kernels import _build
    text = (_build.CSRC / f"{source}.cu").read_text()
    return tuple(m.group(2) for m in re.finditer(
        r"__global__\s+void\s+((?:__\w+__\s*\([^)]*\)\s*)*)(\w+)\s*\(",
        text))


def _split_profile(fn, own, calls=20):
    """Run ``fn`` ``calls`` times under torch.profiler after a warm-up
    cycle of as many calls (the profiler misses the device activity of
    its first few hundred microseconds, so a window opened cold loses its
    first calls); return (device ms per call in the kernels named in
    ``own``, device ms per call in everything else — torch's copies,
    memsets and elementwise kernels —, own kernel launches seen, the other
    device activities' names with their counts)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    pat = re.compile(r"\b(" + "|".join(own) + r")\b")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):               # the warm-up cycle, then the one
            torch.cuda._sleep(SPIN_CYCLES)   # whose events are kept, each
            for _ in range(calls):       # behind a 1 ms spin kernel
                fn()
            torch.cuda.synchronize()
            prof.step()
    own_us = other_us = 0.0
    launches, others = 0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "spin_kernel" in e.name \
                or e.name.startswith("ProfilerStep"):
            continue                     # the spin and the step's own span
        us = e.time_range.elapsed_us()
        if pat.search(e.name):
            own_us += us
            launches += 1
        else:
            other_us += us
            key = e.name[:40]
            others[key] = others.get(key, 0) + 1
    return own_us / 1e3 / calls, other_us / 1e3 / calls, launches, others


SPIN_CYCLES = 2_000_000   # torch.cuda._sleep: about 1 ms of the card
PROFILE_RETRIES = 4       # more profiler readings when one lost events
TRACE_CALLS = 10_000
TRACE_BATCH = 50          # calls between synchronisations, outside a call
DETECT_CALLS = 2_000      # iqr_detect synchronises inside every call


def _trace(steps, calls=TRACE_CALLS):
    """Host time of each step of a wrapper call: ``steps`` is a list of
    (name, fn) run in order on one state dict, ``time.perf_counter_ns``
    read between steps, ``calls`` times with nothing synchronised inside
    a call (the queue is drained every TRACE_BATCH calls, outside them, so
    a launch never waits for a full queue). Returns (mean ns per call,
    {step: mean ns})."""
    import torch
    tick = time.perf_counter_ns
    total = [0] * len(steps)
    for _ in range(0, calls, TRACE_BATCH):
        torch.cuda.synchronize()
        for _ in range(TRACE_BATCH):
            st = {}
            t = tick()
            for i, (_, fn) in enumerate(steps):
                fn(st)
                u = tick()
                total[i] += u - t
                t = u
    torch.cuda.synchronize()
    per = {name: total[i] / calls for i, (name, _) in enumerate(steps)}
    return sum(per.values()), per


_P, _I, _L, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                   ctypes.c_longlong)
C_ARGS = {"rolling_stats": [_P, _LL, _LL, _P, _P],
          "binstats_flat": [_P, _P, _P, _L, _I, _I, _P, _P],
          "binstats_ts": [_P, _P, _P, _L, _I, _I, ctypes.c_float, _P, _P,
                          _P]}
TS_SMEM_MAX = 227 * 1024   # csrc/binstats.cu: the one-cluster table limit


def _rolling_steps(x, window, variant):
    """The rolling wrapper's host steps. ``op``: today's (the C++
    operator does the checks, the allocation, the stream and the launch);
    ``ctypes``: the same C entry through ctypes with lean Python steps (a
    cached typed function, the raw stream handle, a cast only when
    needed); ``before``: the earlier ctypes wrapper's (its checks and
    cast, ``check_tensor``, the locked library lookup, a
    ``torch.cuda.Stream`` object)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels._check import check_tensor, stream_ptr
    from repro_torch.kernels.rolling import ops as ro

    if variant == "op":
        def checks(st):
            if not (isinstance(x, torch.Tensor) and x.device.type == "cuda"
                    and type(window) is int):
                raise AssertionError("not a CUDA call")

        def lookup(st):
            st["op"] = ro._operator()

        def call(st):
            st["out"] = st["op"](x, window)
        return [("checks", checks), ("lookup", lookup),
                ("operator call (C++ checks, at::empty, stream, launch)",
                 call)]

    def checks(st):
        ro._check_args(x, window)
        if x.device.type == "cpu" or x.device.type != "cuda":
            raise AssertionError("not a CUDA tensor")
        if variant == "before":
            st["x"] = x.to(torch.float32).contiguous()
            check_tensor(st["x"], "x", torch.float32, 1, x.device)
        else:
            st["x"] = (x if x.dtype == torch.float32 and x.is_contiguous()
                       else x.to(torch.float32).contiguous())

    def alloc(st):
        st["out"] = torch.empty((x.shape[0], 2), dtype=torch.float32,
                                device=x.device)

    def lookup(st):
        if variant == "before":
            lib = _build.load("ops")
            getattr(lib, "_typed", False)
            st["fn"] = lib.rolling_stats
        else:
            st["fn"] = _build.function("ops", "rolling_stats",
                                       C_ARGS["rolling_stats"])

    def stream(st):
        st["s"] = (torch.cuda.current_stream(x.device).cuda_stream
                   if variant == "before" else stream_ptr(x.device))

    def launch(st):
        st["code"] = st["fn"](st["x"].data_ptr(), x.shape[0], int(window),
                              st["out"].data_ptr(), st["s"])

    def done(st):
        _build.check(st["code"], "rolling_stats")
    return [("checks", checks), ("alloc", alloc), ("lookup", lookup),
            ("stream", stream), ("binding+launch", launch),
            ("result check", done)]


def _binstats_steps(args, flat, variant):
    """The binstats wrappers' host steps, as :func:`_rolling_steps`.
    ``before`` also replays the earlier wrapper's scratch allocations, its
    order flag zeroed (``torch.zeros``) and read back with ``.item()`` in
    the flat form, and its ``out[0]`` view for 1-D values; like the others
    it calls today's C entries, which launch one kernel where the earlier
    ones launched a memset and two kernels (flat) or three kernels
    (timestamp), so its binding+launch step reads low here."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels._check import check_tensor, stream_ptr
    from repro_torch.kernels.binstats import ops as bs

    if flat:
        seg, values, n_seg, valid = args
        lead, size = seg, n_seg
    else:
        (lead, values, valid), kw = args
        size = kw["n_bins"]
        inv = float(np.float32(size / kw["total_ns"]))
    symbol = "binstats_flat" if flat else "binstats_ts"
    lead_dtype = torch.int32 if flat else torch.float32

    if variant == "op":
        def checks(st):
            if values.device.type != "cuda":
                raise AssertionError("not a CUDA call")

        def lookup(st):
            st["op"] = bs._operator(symbol)

        def call(st):
            st["out"] = (st["op"](seg, values, n_seg, valid) if flat else
                         st["op"](lead, values, valid,
                                  float(kw["total_ns"]), size))
        return [("checks", checks), ("lookup", lookup),
                ("operator call (C++ checks, at::empty, stream, launch)",
                 call)]

    def checks(st):
        if size < 1 or values.device.type == "cpu" or \
                values.device.type != "cuda":
            raise AssertionError("not a CUDA call")
        dev = values.device
        if variant == "ctypes":          # one combined test
            nd, n = values.dim(), values.shape[-1]
            if not (nd in (1, 2) and values.dtype == torch.float32
                    and values.is_contiguous() and lead.dtype == lead_dtype
                    and lead.dim() == 1 and lead.is_contiguous()
                    and lead.shape[0] == n and lead.device == dev
                    and valid.dtype == torch.bool and valid.dim() == 1
                    and valid.is_contiguous() and valid.shape[0] == n
                    and valid.device == dev):
                raise AssertionError("arguments")
            st["mn"] = (1 if nd == 1 else values.shape[0]), n
            return
        vals, _ = bs._as_2d(values)
        check_tensor(vals, "values", torch.float32, 2, dev)
        check_tensor(lead, "lead", lead_dtype, 1, dev)
        check_tensor(valid, "valid", torch.bool, 1, dev)
        if lead.shape[0] != vals.shape[1] or valid.shape[0] != vals.shape[1]:
            raise AssertionError("shapes")
        st["mn"] = vals.shape

    def lookup(st):
        if variant == "before":
            lib = _build.load("ops")
            getattr(lib, "_typed", False)
            st["fn"] = getattr(lib, symbol)
        else:
            st["fn"] = _build.function("ops", symbol, C_ARGS[symbol])

    def alloc(st):
        m, dev = st["mn"][0], values.device
        before = variant == "before"
        if before and flat:
            st["offsets"] = torch.empty(size + 1, dtype=torch.int32,
                                        device=dev)
            st["err"] = torch.zeros(1, dtype=torch.int32, device=dev)
        if not flat and (before or size * (1 + 4 * m) * 4 > TS_SMEM_MAX):
            st["cnt"] = torch.empty(size, dtype=torch.int32, device=dev)
        shape = ((size, bs.STATS) if values.dim() == 1 and not before
                 else (m, size, bs.STATS))
        st["out"] = torch.empty(shape, dtype=torch.float32, device=dev)

    def stream(st):
        st["s"] = (torch.cuda.current_stream(values.device).cuda_stream
                   if variant == "before" else stream_ptr(values.device))

    def launch(st):
        out = st["out"]
        m, n = st["mn"]
        if flat:
            st["code"] = st["fn"](lead.data_ptr(), values.data_ptr(),
                                  valid.data_ptr(), n, size, m,
                                  out.data_ptr(), st["s"])
        else:
            cnt = st.get("cnt")
            st["code"] = st["fn"](lead.data_ptr(), values.data_ptr(),
                                  valid.data_ptr(), n, m, size, inv,
                                  None if cnt is None else cnt.data_ptr(),
                                  out.data_ptr(), st["s"])

    def done(st):
        _build.check(st["code"], symbol)
        if variant == "before" and flat:
            int(st["err"].item())
        if variant == "before" and values.dim() == 1:
            st["out"][0]
    sync = " + .item() sync" if variant == "before" and flat else ""
    return [("checks", checks), ("lookup", lookup), ("alloc", alloc),
            ("stream", stream), ("binding+launch", launch),
            ("result check" + sync, done)]


def _histbin_steps(args, variant):
    """The histbin_flat wrapper's host steps, as :func:`_rolling_steps`:
    ``op`` today's (the C++ operator), ``ctypes`` the same C entry with
    lean Python steps, ``before`` the earlier ctypes wrapper's steps replayed
    (``_as_2d``, three ``check_tensor`` calls, the locked library lookup,
    ``torch.empty``, the raw stream, the call, the result check and the
    ``out[0]`` view of 1-D values)."""
    import torch

    from repro_torch.core.reducers import N_BUCKETS
    from repro_torch.kernels import _build
    from repro_torch.kernels._check import check_tensor, stream_ptr
    from repro_torch.kernels.binstats import ops as bs

    seg, values, n_seg, valid = args
    if variant == "op":
        def checks(st):
            if values.device.type != "cuda":
                raise AssertionError("not a CUDA call")

        def lookup(st):
            st["op"] = bs._operator("histbin_flat")

        def call(st):
            st["out"] = st["op"](seg, values, n_seg, valid)
        return [("checks", checks), ("lookup", lookup),
                ("operator call (C++ checks, at::empty, stream, launch)",
                 call)]

    def checks(st):
        if n_seg < 1 or values.device.type != "cuda":
            raise AssertionError("not a CUDA call")
        vals, _ = bs._as_2d(values)
        if variant == "before":
            check_tensor(vals, "values", torch.float32, 2, values.device)
            check_tensor(seg, "seg", torch.int32, 1, values.device)
            check_tensor(valid, "valid", torch.bool, 1, values.device)
        elif not (vals.is_contiguous() and seg.is_contiguous()
                  and valid.is_contiguous()):
            raise AssertionError("arguments")
        if seg.shape[0] != vals.shape[1] or valid.shape[0] != vals.shape[1]:
            raise AssertionError("shapes")
        st["mn"] = vals.shape

    def lookup(st):
        if variant == "before":
            lib = _build.load("ops")
            getattr(lib, "_typed", False)
            st["fn"] = lib.histbin_flat
        else:
            st["fn"] = _build.function("ops", "histbin_flat",
                                       C_ARGS["binstats_flat"])

    def alloc(st):
        st["out"] = torch.empty((st["mn"][0], n_seg, N_BUCKETS),
                                dtype=torch.float32, device=values.device)

    def stream(st):
        st["s"] = stream_ptr(values.device)

    def launch(st):
        m, n = st["mn"]
        st["code"] = st["fn"](seg.data_ptr(), values.data_ptr(),
                              valid.data_ptr(), n, n_seg, m,
                              st["out"].data_ptr(), st["s"])

    def done(st):
        _build.check(st["code"], "histbin_flat")
        if variant == "before" and values.dim() == 1:
            st["out"][0]
    return [("checks", checks), ("lookup", lookup), ("alloc", alloc),
            ("stream", stream), ("binding+launch", launch),
            ("result check", done)]


def _iqr_steps(scores, occ, variant):
    """The iqr_fences wrapper's host steps, as :func:`_rolling_steps`:
    ``op`` today's (the C++ operator, and the result dict with its six
    named 0-d views from one ``unbind``), ``before`` the earlier ctypes
    wrapper's steps replayed against the same C entry (its checks, two
    ``check_tensor`` calls, the typed-function lookup, four
    ``torch.empty``, the raw stream, the call, the result check and the
    result dict with its six named 0-d views)."""
    import ctypes as ct

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels._check import check_tensor, stream_ptr
    from repro_torch.kernels.iqr import ops as iq

    if variant == "op":
        def checks(st):
            if not (isinstance(scores, torch.Tensor)
                    and scores.device.type == "cuda"):
                raise AssertionError("not a CUDA call")

        def lookup(st):
            st["op"] = iq._operator()

        def call(st):
            st["out"] = st["op"](scores, occ, 1.5)

        def result(st):
            iq._result(*st["out"])
        return [("checks", checks), ("lookup", lookup),
                ("operator call (C++ checks, at::empty, stream, launch)",
                 call), ("result dict", result)]

    f64 = scores.dtype == torch.float64
    symbol, key = (("iqr_fences_f64", ct.c_double) if f64
                   else ("iqr_fences", ct.c_float))

    def checks(st):
        if scores.dim() != 1 or scores.shape[0] < 1:
            raise AssertionError("shape")
        if scores.device.type == "cpu" or scores.device.type != "cuda":
            raise AssertionError("not a CUDA call")
        check_tensor(scores, "scores", scores.dtype, 1, scores.device)
        check_tensor(occ, "occupied", torch.bool, 1, scores.device)
        if occ.shape[0] != scores.shape[0] or scores.shape[0] >= 1 << 30:
            raise AssertionError("shapes")

    def lookup(st):
        st["fn"] = _build.function("ops", symbol, [_P, _P, _I, _I, key, _P,
                                                   _P, _P, _P, _P])

    def alloc(st):
        n = scores.shape[0]
        n_p = iq.next_pow2(n)
        nbytes = _build.load("ops").iqr_scratch_bytes(
            n_p, scores.element_size())
        dev = scores.device
        st["n_p"] = n_p
        st["scratch"] = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                    device=dev)
        st["srt"] = torch.empty(n, dtype=scores.dtype, device=dev)
        st["flags"] = torch.empty(n, dtype=torch.int32, device=dev)
        st["stats"] = torch.empty(8, dtype=scores.dtype, device=dev)

    def stream(st):
        st["s"] = stream_ptr(scores.device)

    def launch(st):
        st["code"] = st["fn"](scores.data_ptr(), occ.data_ptr(),
                              scores.shape[0], st["n_p"], 1.5,
                              st["scratch"].data_ptr(), st["srt"].data_ptr(),
                              st["flags"].data_ptr(), st["stats"].data_ptr(),
                              st["s"])

    def done(st):
        _build.check(st["code"], "iqr_fences")
        out = {"sorted": st["srt"], "flags": st["flags"],
               "stats": st["stats"]}
        out.update({name: st["stats"][i]
                    for i, name in enumerate(iq.STAT_NAMES)})
    return [("checks", checks), ("lookup", lookup), ("alloc", alloc),
            ("stream", stream), ("binding+launch", launch),
            ("result check and dict", done)]


def _iqr_detect_steps(scores_np, bounds, dev):
    """``core.anomaly.iqr_detect``'s steps at the main path's call: host
    prep, the upload, the kernel call, the two device-to-host reads (the
    stats, then the flags) and the host ranking."""
    import numpy as np
    import torch

    from repro_torch.kernels.iqr import iqr_fences

    def prep(st):
        st["scores"] = s = np.asarray(scores_np, np.float64)
        occupied = s != 0.0
        st["fenced"] = occupied if occupied.any() else np.ones_like(occupied)

    def upload(st):
        st["s_t"] = torch.as_tensor(st["scores"], dtype=torch.float64,
                                    device=dev)
        st["o_t"] = torch.as_tensor(st["fenced"], device=dev)

    def call(st):
        st["out"] = iqr_fences(st["s_t"], st["o_t"], k_factor=1.5)

    def read_stats(st):
        st["q"] = [float(x) for x in st["out"]["stats"][:5].cpu()]

    def read_flags(st):
        st["flags"] = st["out"]["flags"].cpu().numpy().astype(bool)

    def rank(st):
        s, lo, hi = st["scores"], st["q"][3], st["q"][4]
        flags = st["flags"] | (~st["fenced"] & (s > hi))
        exceed = np.where(flags, np.abs(s - np.clip(s, lo, hi)), -1.0)
        top = np.argsort(-exceed, kind="stable")[:min(5, int(flags.sum()))]
        np.stack([bounds[top], bounds[top + 1]], axis=1).astype(np.int64)
    return [("host prep", prep), ("upload", upload),
            ("kernel call", call), ("stats read (sync)", read_stats),
            ("flags read", read_flags), ("host ranking", rank)]


def phase_host_trace(shapes):
    """Host time per step of the rolling_stats, binstats, binstats_flat,
    histbin_flat and iqr_fences wrappers at their path shapes: today's
    steps (the C++ operator), the same C entries through lean ctypes steps
    (not for iqr_fences), and the earlier ctypes wrapper's steps replayed,
    beside the whole wrapper call timed the same way; then iqr_detect at
    the main path's call, step by step."""
    import numpy as np

    import repro_torch.kernels as K
    from repro_torch.kernels.binstats import binstats_flat
    from repro_torch.kernels.histbin import histbin_flat

    x, window = shapes["rolling_stats"]
    (ts, vals, valid), kw = shapes["binstats"]
    flat = shapes["binstats_flat"]
    hflat = shapes["histbin_flat"]
    cases = (
        ("rolling_stats", f"{x.shape[0]} values, window {window}",
         lambda st: K.rolling_stats(x, window=window),
         lambda variant: _rolling_steps(x, window, variant)),
        ("binstats", f"{ts.shape[0]} events, {kw['n_bins']} bins",
         lambda st: K.binstats(ts, vals, valid, **kw),
         lambda variant: _binstats_steps(shapes["binstats"], False,
                                         variant)),
        ("binstats_flat", f"{flat[0].shape[0]} rows, "
         f"{tuple(flat[1].shape)} values, {flat[2]} segments",
         lambda st: binstats_flat(*flat),
         lambda variant: _binstats_steps(flat, True, variant)),
        ("histbin_flat", f"{hflat[0].shape[0]} rows, "
         f"{tuple(hflat[1].shape)} values, {hflat[2]} segments",
         lambda st: histbin_flat(*hflat),
         lambda variant: _histbin_steps(hflat, variant)),
    )
    (scores, occ), _ = shapes["iqr_fences"]
    cases += (
        ("iqr_fences", f"{scores.shape[0]} float64 scores",
         lambda st: K.iqr_fences(scores, occ),
         lambda variant: _iqr_steps(scores, occ, variant)),)
    labels = {"op": "today's steps (C++ operator)",
              "ctypes": "lean ctypes steps",
              "before": "the earlier wrapper's steps replayed"}
    out = {}
    for name, what, call, steps in cases:
        res = {"call": _trace([("call", call)])[0]}
        parts = []
        variants = (("op", "before") if name == "iqr_fences"
                    else ("op", "ctypes", "before"))
        for variant in variants:
            label = labels[variant]
            total, per = res[variant] = _trace(steps(variant))
            parts.append(f"{label} {total / 1e3:.2f} us = " + ", ".join(
                f"{k} {v / 1e3:.2f}" for k, v in per.items()))
        out[name] = res
        log(f"host trace {name} ({what}), mean over {TRACE_CALLS} calls: "
            f"wrapper call {res['call'] / 1e3:.2f} us; " + "; ".join(parts))
    # iqr_detect at the main path's call: every call synchronises
    from repro_torch.core import anomaly
    s_np = scores.cpu().numpy()
    bounds = np.arange(s_np.shape[0] + 1, dtype=np.int64) * 10_000_000
    whole, _ = _trace([("call", lambda st: anomaly.iqr_detect(
        s_np, boundaries=bounds))], DETECT_CALLS)
    total, per = _trace(_iqr_detect_steps(s_np, bounds, scores.device),
                        DETECT_CALLS)
    out["iqr_detect"] = {"call": whole, "steps": (total, per)}
    log(f"host trace iqr_detect ({s_np.shape[0]} scores), mean over "
        f"{DETECT_CALLS} calls: whole call {whole / 1e3:.2f} us; steps "
        f"{total / 1e3:.2f} us = " + ", ".join(
            f"{k} {v / 1e3:.2f}" for k, v in per.items()))
    return out


def _plain(name):
    from repro_torch.kernels.binstats import ops as bs
    from repro_torch.kernels.flashattn import ops as fa
    from repro_torch.kernels.histbin import ops as hb
    from repro_torch.kernels.iqr import ops as iq
    from repro_torch.kernels.rolling import ops as ro
    from repro_torch.kernels.ssd import ops as sd
    return {"binstats_flat": bs.binstats_flat_plain,
            "binstats": bs.binstats_plain,
            "histbin_flat": hb.histbin_flat_plain,
            "histbin": hb.histbin_plain,
            "iqr_fences": iq.iqr_fences_plain,
            "ssd_fused": sd.ssd_fused_plain,
            "flash_attention": fa.flash_attention_plain,
            "rolling_stats": ro.rolling_stats_plain}[name]


def _ts_inputs(flat_args, n_bins):
    """Timestamp-form inputs at the main path's row count and bin count
    (the timestamp forms are not on the main path)."""
    import torch
    seg, vals, _, valid = flat_args
    gen = torch.Generator(device=vals.device).manual_seed(5)
    ts = torch.rand(seg.shape[0], generator=gen, device=vals.device) * 1.2e11
    return ((ts.contiguous(), vals, valid),
            {"total_ns": 1.2e11, "n_bins": n_bins})


def phase_delta(args, work):
    import numpy as np

    from repro_torch.core import (TraceStore, VariabilityPipeline,
                                  append_rank_db, generate_synthetic,
                                  trace_remainder, truncate_trace,
                                  write_rank_db)

    ds = generate_synthetic(_spec(args))
    t0 = int(min(tr.kernels.start.min() for tr in ds.traces))
    cutoff = t0 + int(0.9 * args.duration * 1e9)
    root = os.path.join(work, "delta")
    os.makedirs(root)
    paths = [os.path.join(root, f"rank{tr.rank}.sqlite") for tr in ds.traces]
    for tr, p in zip(ds.traces, paths):
        write_rank_db(p, truncate_trace(tr, cutoff))
    store = os.path.join(root, "store")
    pipe = VariabilityPipeline(_cfg(args, "torch"))
    pipe.run(paths, store)
    # the collective phase appends the same grown DBs (the manifest keys
    # its watermarks by path) to a copy of the store before the append,
    # without its caches, and streams them into a second copy
    copy = os.path.join(work, "collective", "delta_store")
    _bare_copy(store, copy)
    stream_copy = os.path.join(work, "collective", "stream_store")
    _bare_copy(store, stream_copy)
    for tr, p in zip(ds.traces, paths):
        append_rank_db(p, trace_remainder(tr, cutoff))
    delta = pipe.append(paths, store)
    if delta.aggregation.partial_hits < 1:
        raise AssertionError("the delta served no shard from the cache")
    cold_dir = os.path.join(root, "cold")
    shutil.copytree(store, cold_dir)
    cs = TraceStore(cold_dir)
    cs.clear_summaries()
    cs.clear_partials()
    cold = pipe.aggregate(cold_dir)
    if cold.partial_hits != 0:
        raise AssertionError("the cold run read cached partials")
    a, b = delta.aggregation, cold
    for f in ("count", "sum", "sumsq", "min", "max"):
        np.testing.assert_array_equal(getattr(a.grouped, f),
                                      getattr(b.grouped, f))
    np.testing.assert_array_equal(a.reduced["quantile"].counts,
                                  b.reduced["quantile"].counts)
    log(f"delta: {len(a.recomputed_shards)} shards recomputed, "
        f"{a.partial_hits} from the partial cache; delta == cold bitwise "
        f"({len(b.recomputed_shards)} shards cold)")
    return paths, copy, stream_copy


# the layer_norm family of the synthetic name table (ids congruent mod 21),
# the one the diff phase slows down
SLOW_IDS = (3, 24, 45)
SLOW_FAMILY = "layer_norm"
# 100 ms bins (10 ms before the training phases came: the diff took
# 196-277 s there, and the script has to stay inside its time limit)
DIFF_INTERVAL_NS = 100_000_000
SERVICE_CLIENTS = 16


def _path_launches(counters):
    return {k: counters[k].launches
            for k in ("binstats_flat", "histbin_flat", "iqr_fences")}


def _need_launches(phase, launches, exact=None):
    """Raise unless every kernel of the analysis path launched (and, for
    ``exact``, launched exactly that many times)."""
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{phase}: the path never launched {name}")
        if exact is not None and name in exact and n != exact[name]:
            raise AssertionError(f"{phase}: {name} launched {n} times, "
                                 f"expected {exact[name]}")


def _bare_copy(src, dst):
    """A copy of a store's manifest and shard files, without its caches."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if name == "manifest.json" or (name.startswith("shard_")
                                       and name.endswith(".npz")):
            shutil.copy2(os.path.join(src, name), os.path.join(dst, name))


def _assert_diff_scores_close(got, want):
    """Two diff reports of one pair: the same ranked groups, match kinds,
    verdicts, counts and top bins; float scores within RTOL."""
    import numpy as np
    if [g.name_a for g in got.groups] != [g.name_a for g in want.groups]:
        raise AssertionError("the two backends rank the groups apart")
    for g, w in zip(got.groups, want.groups):
        if ((g.name_b, g.matched_via, g.regressed, g.count_a, g.count_b,
             g.top_bins) != (w.name_b, w.matched_via, w.regressed,
                             w.count_a, w.count_b, w.top_bins)):
            raise AssertionError(f"group {g.name_a} differs")
        np.testing.assert_array_equal(g.top_windows, w.top_windows)
        for f in ("mean_a", "mean_b", "mean_ratio", "p99_a", "p99_b",
                  "p99_ratio", "shift_octaves", "spread_octaves",
                  "geo_ratio"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=RTOL, atol=1e-12, err_msg=f)
        np.testing.assert_allclose(g.bin_shift, w.bin_shift, rtol=RTOL,
                                   atol=1e-12)


def phase_diff(args, work, card):
    import dataclasses
    import itertools

    import torch

    from repro_torch.core import (Query, VariabilityPipeline, distributed,
                                  generate_synthetic, inject_slowdown,
                                  normalize_kernel_name, write_synthetic_dbs)

    store_a = os.path.join(work, "store")
    store_b = os.path.join(work, "store_b")
    t0 = time.perf_counter()
    ds = inject_slowdown(generate_synthetic(
        dataclasses.replace(_spec(args), name_variant=1)), 1.5, SLOW_IDS)
    paths = write_synthetic_dbs(ds, os.path.join(work, "dbs_b"))
    del ds
    gen = VariabilityPipeline(_cfg(args, "torch")).generate(paths, store_b)
    log(f"diff: store B (name variant 1, {SLOW_FAMILY} ids {SLOW_IDS} "
        f"x1.5) built by phase 1 in {time.perf_counter() - t0:.3f}s "
        f"({gen.joined_rows} joined rows, {gen.n_shards} shards)")
    base = Query(metrics=("k_stall",), interval_ns=DIFF_INTERVAL_NS)
    pipe = VariabilityPipeline(_cfg(args, "torch"))
    counters = _launch_counters()
    seq = itertools.count()
    cap = Capture(((distributed, "binstats_flat"),
                   (distributed, "histbin_flat")),
                  key=lambda name, kwargs: (name, next(seq)))
    try:
        _zero(counters)
        t = time.perf_counter()
        cold = pipe.diff(store_a, store_b, query=base)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t
        launches = _path_launches(counters)
    finally:
        cap.close()
    # every wrapper call in order, side A's first
    calls = [(name, a) for (name, _), (a, _) in
             sorted(cap.calls.items(), key=lambda kv: kv[0][1])]
    n_seg = [a[2] for name, a in calls if name == "histbin_flat"]
    log(f"diff: cold torch diff {cold_s:.3f}s, launches {launches}, "
        f"device segments per side {n_seg}; {cold.provenance()} [{card}]")
    del launches["iqr_fences"]          # a diff fences nothing
    _need_launches("diff", launches,
                   exact={"binstats_flat": 2, "histbin_flat": 2})
    if cold.verdict != "regressed" or cold.from_cache:
        raise AssertionError(f"diff: verdict {cold.verdict}, from cache "
                             f"{cold.from_cache}")
    top = cold.groups[:len(SLOW_IDS)]
    if not all(SLOW_FAMILY in normalize_kernel_name(g.name_a) for g in top):
        raise AssertionError("diff: the injected family is not ranked "
                             f"first: {[g.name_a for g in top]}")
    if {g.name_a for g in cold.regressions()} != {g.name_a for g in top}:
        raise AssertionError("diff: regressions beyond the injected family")
    log("diff: verdict regressed, top " + ", ".join(
        f"{g.name_a} geo x{g.geo_ratio:.4f} mean x{g.mean_ratio:.4f} "
        f"p99 x{g.p99_ratio:.4f}" for g in top))
    # the kernels on side B's own inputs against their plain versions
    last = dict(calls)
    errs = {"binstats_flat": moments_err(
                distributed.binstats_flat(*last["binstats_flat"]),
                _plain("binstats_flat")(*last["binstats_flat"])),
            "histbin_flat": hist_err(
                distributed.histbin_flat(*last["histbin_flat"]),
                _plain("histbin_flat")(*last["histbin_flat"]))}
    del cap, calls, last
    torch.cuda.empty_cache()
    log(f"diff: kernels on side B's inputs, largest |kernel - plain|: "
        f"{errs}")
    self_rep = pipe.diff(store_a, store_a, query=base)
    if self_rep.verdict != "pass":
        raise AssertionError("diff: a self-diff did not pass")
    exact_pipe = VariabilityPipeline(dataclasses.replace(
        _cfg(args, "serial"), use_summary_cache=False))
    t = time.perf_counter()
    exact = exact_pipe.diff(store_a, store_b, query=base)
    exact_s = time.perf_counter() - t
    if exact.verdict != cold.verdict:
        raise AssertionError("diff: serial and torch verdicts differ")
    _assert_diff_scores_close(cold, exact)
    log(f"diff: serial diff {exact_s:.3f}s: same verdict, same "
        f"{len(exact.groups)} ranked groups, scores within rtol {RTOL}")
    for name in os.listdir(store_b):
        if name.startswith("diff_") and name.endswith(".json"):
            os.remove(os.path.join(store_b, name))
    _zero(counters)
    t = time.perf_counter()
    warm = pipe.diff(store_a, store_b, query=base)
    warm_s = time.perf_counter() - t
    if warm.from_cache or warm.shard_reads_a or warm.shard_reads_b:
        raise AssertionError(f"diff: the warm repeat read shards "
                             f"({warm.provenance()})")
    if any(_path_launches(counters).values()):
        raise AssertionError("diff: the warm repeat launched a kernel")
    t = time.perf_counter()
    cached = pipe.diff(store_a, store_b, query=base)
    cached_s = time.perf_counter() - t
    if not cached.from_cache or cached.verdict != cold.verdict:
        raise AssertionError("diff: the third call did not load the report")
    log(f"diff: seconds cold {cold_s:.3f}, warm {warm_s:.3f} "
        f"({warm.provenance()}), cached {cached_s:.3f} "
        f"({cached.provenance()}); self-diff pass [{card}]")
    return errs


def _service_queries(man):
    """Eight distinct queries: no grouping and each group column, moments
    alone and with the quantile sketch, mean / p95 / p99 scores, 10 ms /
    100 ms / 1 s bins and one time window. The second is the main
    phase's own query (a summary on the store already)."""
    span = int(man.t_end - man.t_start)
    window = [int(man.t_start + span // 3), int(man.t_start + span // 2)]
    ms = 1_000_000
    return [
        {"metrics": ["k_stall"], "interval_ns": 10 * ms},
        {"metrics": list(METRICS), "group_by": "k_device",
         "reducers": ["moments", "quantile"], "anomaly_score": "p99",
         "interval_ns": 10 * ms},
        {"metrics": ["m_duration"], "group_by": "m_kind",
         "reducers": ["moments", "quantile"], "anomaly_score": "p95",
         "interval_ns": 100 * ms},
        {"metrics": ["k_stall"], "group_by": "src_rank",
         "interval_ns": 1000 * ms},
        {"metrics": ["k_stall"], "group_by": "k_name",
         "reducers": ["moments", "quantile"], "anomaly_score": "p99",
         "interval_ns": 1000 * ms},
        {"metrics": ["m_bytes"], "group_by": "m_kind",
         "time_window": window, "interval_ns": 100 * ms},
        {"metrics": ["k_stall"], "reducers": ["quantile"],
         "anomaly_score": "p99", "interval_ns": 100 * ms},
        {"metrics": ["k_stall", "m_duration"], "group_by": "k_device",
         "interval_ns": 1000 * ms},
    ]


def _same_answer(got, want):
    """A rendered torch answer against the serial one: counts and fence
    flags exactly, min/max in float32, means within RTOL."""
    import numpy as np
    if (got["n_samples"], got["n_bins"], got.get("anomalous_bins")) != \
            (want["n_samples"], want["n_bins"], want.get("anomalous_bins")):
        raise AssertionError(f"service: {got['query']} differs in "
                             "samples, bins or flags")
    if set(got["groups"]) != set(want["groups"]):
        raise AssertionError(f"service: {got['query']} differs in groups")
    for gk, cells in want["groups"].items():
        for m, cell in cells.items():
            mine = got["groups"][gk][m]
            if mine["count"] != cell["count"] or any(
                    np.float32(mine[f]) != np.float32(cell[f])
                    for f in ("min", "max")):
                raise AssertionError(f"service: {got['query']} group {gk} "
                                     f"{m} differs")
            np.testing.assert_allclose(mine["mean"], cell["mean"],
                                       rtol=RTOL)


def phase_service(args, work, card):
    import threading

    import torch

    from repro_torch.core import Query, TraceStore, VariabilityPipeline
    from repro_torch.serve import QueryClient, QueryService, ServiceConfig

    store = os.path.join(work, "store")
    specs = _service_queries(TraceStore(store).read_manifest())
    exact_dir = os.path.join(work, "service_exact")
    _bare_copy(store, exact_dir)
    counters = _launch_counters()
    pipe = VariabilityPipeline(_cfg(args, "torch"))
    n = SERVICE_CLIENTS
    bodies, walls, errors = [None] * n, [0.0] * n, []
    _zero(counters)
    svc = pipe.serve(store, port=0, tick_ms=50.0)
    try:
        client = QueryClient(port=svc.cfg.port, timeout_s=600.0)
        if not client.wait_healthy(timeout_s=30.0):
            raise AssertionError("service: not healthy")
        start = threading.Barrier(n)

        def ask(i):
            try:
                start.wait(60)
                t = time.perf_counter()
                bodies[i] = client.query_raw([specs[i % len(specs)]])
                walls[i] = time.perf_counter() - t
            except BaseException as e:   # noqa: BLE001 — raised below
                errors.append(f"client {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = _path_launches(counters)
        stats = client.stats()
    finally:
        svc.stop()
    if errors:
        raise AssertionError(f"service: {errors}")
    widths = [b["tick"]["fused_width"] for b in bodies]
    hits = sum(bool(b["results"][0].get("inflight_hit")
                    or b["results"][0]["cache_hit"]) for b in bodies)
    log(f"service: {n} clients x 1 query ({len(specs)} distinct) in "
        f"{wall:.3f}s; request wall s {sorted(round(w, 3) for w in walls)};"
        f" fused widths {widths}; in-flight or summary hits {hits}; ticks "
        f"{stats['ticks']}, tick p50/p95/p99 {stats['tick_p50_ms']:.1f} / "
        f"{stats['tick_p95_ms']:.1f} / {stats['tick_p99_ms']:.1f} ms; "
        f"launches {launches} [{card}]")
    _need_launches("service", launches)
    if max(widths) < 2:
        raise AssertionError("service: no tick fused two requests")
    if hits < 1:
        raise AssertionError("service: no in-flight or summary hit")
    # the collective phase holds its P = 4 service to these answers
    os.makedirs(os.path.join(work, "collective"), exist_ok=True)
    with open(os.path.join(work, "collective", "service_p1.json"), "w") as f:
        json.dump([b["results"][0] for b in bodies[:len(specs)]], f)
    exact = QueryService(exact_dir, ServiceConfig(
        backend="serial", device="cuda", tick_ms=1.0,
        summary_budget_bytes=None))
    t = time.perf_counter()
    p = exact.submit([Query.from_spec(s) for s in specs])
    if exact.drain_once(block_s=0.0) != 1 or p.error is not None:
        raise AssertionError(f"service: the serial service failed "
                             f"{p.error}")
    for i, b in enumerate(bodies):
        _same_answer(b["results"][0], p.results[i % len(specs)])
    log(f"service: every answer == the serial service's on a copy of the "
        f"store (counts, flags exact; min/max in float32; means rtol "
        f"{RTOL}); serial tick {time.perf_counter() - t:.3f}s")


def _shards_equal(a, b, n):
    """Names of the first ``n`` shard files that differ between two
    stores (byte for byte)."""
    import filecmp
    names = [f"shard_{s:06d}.npz" for s in range(n)]
    _, mismatch, missing = filecmp.cmpfiles(a, b, names, shallow=False)
    return mismatch + missing


def phase_stream(args, work, card):
    import numpy as np
    import torch

    from repro_torch.core import (PipelineConfig, TraceStore,
                                  VariabilityPipeline, append_rank_db,
                                  generate_synthetic, run_append,
                                  run_generation, trace_remainder,
                                  truncate_trace, write_rank_db)
    from repro_torch.serve import (DEFAULT_FENCE_QUERY, IngestConfig,
                                   QueryClient)

    root = os.path.join(work, "stream")
    ds = generate_synthetic(_spec(args))
    t0 = int(min(tr.kernels.start.min() for tr in ds.traces))
    ns = 1_000_000_000
    cutoff = t0 + 90 * ns
    # the rank DBs the plane tails, and a copy the same appends are
    # replayed on without the service
    paths, replay = ([os.path.join(root, sub, f"rank{tr.rank}.sqlite")
                      for tr in ds.traces] for sub in ("dbs", "replay"))
    for sub in ("dbs", "replay"):
        os.makedirs(os.path.join(root, sub))
    for tr, p, q in zip(ds.traces, paths, replay):
        write_rank_db(p, truncate_trace(tr, cutoff))
        shutil.copy2(p, q)
    store, replay_store = (os.path.join(root, d)
                           for d in ("store", "replay_store"))
    cfg = PipelineConfig(n_ranks=args.ranks, backend="torch", device="cuda",
                         anomaly_score="p99")
    pipe = VariabilityPipeline(cfg)
    pipe.generate(paths, store)
    run_generation(replay, replay_store, n_ranks=args.ranks)
    counters = _launch_counters()
    svc = pipe.stream(store, paths, ingest=IngestConfig(poll_ms=25.0))
    events, since, batches, replayed = [], 0, [], []
    try:
        client = QueryClient(port=svc.cfg.port, timeout_s=600.0)
        _zero(counters)
        lo = cutoff
        for hi in (cutoff + 10 * ns, cutoff + 20 * ns, None):
            batch = [trace_remainder(tr, lo) if hi is None
                     else trace_remainder(truncate_trace(tr, hi), lo)
                     for tr in ds.traces]
            lo = hi
            for b, p in zip(batch, paths):
                append_rank_db(p, b)
            body = client.fences(since=since, timeout_s=120.0)
            if not body["events"]:
                raise AssertionError("stream: no fence event within the "
                                     "long poll")
            if not svc.ingestor.quiesce(timeout_s=300.0):
                raise AssertionError("stream: the plane did not catch up")
            got = list(body["events"])
            since = body["next_since"]
            while True:
                more = client.fences(since=since, timeout_s=0.2)
                if not more["events"]:
                    break
                got += more["events"]
                since = more["next_since"]
            batches.append(sum(e["ingest"]["rows_ingested"] for e in got))
            events += got
            for b, q in zip(batch, replay):
                append_rank_db(q, b)
            replayed.append(run_append(replay, replay_store).appended_rows)
        torch.cuda.synchronize()
        launches = _path_launches(counters)
        st = client.stats()["ingest"]
    finally:
        svc.stop()
    del ds
    log(f"stream: {len(events)} events over 3 batches (rows {batches}); "
        f"ingest ticks {st['ingest_ticks']}, rows {st['rows_ingested']}, "
        f"fence transitions {st['fence_transitions']}, errors "
        f"{st['errors']}; event_to_fence p50/p99 "
        f"{st['event_to_fence_p50_ms']:.1f} / "
        f"{st['event_to_fence_p99_ms']:.1f} ms; launches {launches} "
        f"[{card}]")
    if st["errors"]:
        raise AssertionError(f"stream: ingest errors {st['last_ingest']}")
    _need_launches("stream", launches)
    if batches != replayed or st["rows_ingested"] != sum(replayed):
        raise AssertionError(f"stream: ingested {batches} rows a batch, "
                             f"the same appends without the service "
                             f"{replayed}")
    n = TraceStore(replay_store).read_manifest().n_shards
    if TraceStore(store).read_manifest().n_shards != n:
        raise AssertionError("stream: shard count differs from the replay")
    differ = _shards_equal(store, replay_store, n)
    if differ:
        raise AssertionError(f"stream: shard files differ from the same "
                             f"appends without the service: {differ}")
    # delta == cold: the plane's fences against a cold torch run over a
    # cache-free copy of the same shards
    cold_dir = os.path.join(root, "cold")
    _bare_copy(store, cold_dir)
    streamed = svc.ingestor.fence_state().get(
        DEFAULT_FENCE_QUERY.cache_key(), ())
    cold = VariabilityPipeline(cfg).query(cold_dir, [DEFAULT_FENCE_QUERY])[0]
    mine = pipe.query(store, [DEFAULT_FENCE_QUERY])[0]
    if not mine.cache_hit or cold.cache_hit:
        raise AssertionError("stream: the plane left no summary, or the "
                             "cold copy had one")
    if tuple(int(i) for i in np.flatnonzero(cold.anomalies.flags)) != \
            streamed:
        raise AssertionError("stream: fence flags differ from a cold run")
    for f in ("count", "sum", "sumsq", "min", "max"):
        np.testing.assert_array_equal(getattr(mine.result.stats, f),
                                      getattr(cold.result.stats, f))
    np.testing.assert_array_equal(mine.result.reduced["quantile"].counts,
                                  cold.result.reduced["quantile"].counts)
    np.testing.assert_array_equal(mine.anomalies.top_windows,
                                  cold.anomalies.top_windows)
    # a from-scratch phase 1 of the final DBs, for the record: phase 1
    # never joins an already committed kernel with a memcpy appended
    # later, nor a kernel with a memcpy across a rank's range boundary
    fresh = os.path.join(root, "fresh")
    gen = run_generation(paths, fresh, n_ranks=args.ranks)
    rows = sum(int(np.load(os.path.join(store, f"shard_{s:06d}.npz"))[
        "k_start"].size) for s in range(n))
    log(f"stream: {sum(replayed)} rows ingested == the same appends "
        f"without the service; {n} shard files equal theirs byte for "
        f"byte; fences and moments == a cold torch run over the same "
        f"shards ({len(streamed)} flagged bins, top windows equal); a "
        f"from-scratch phase 1 of the final DBs holds {gen.joined_rows} "
        f"joined rows against the stream's {rows}, "
        f"{len(_shards_equal(store, fresh, n))} shard files apart")

# Rank counts of the paper's Fig 1c, capped at the usable CPUs: the
# sweep's two ends (its 2 and 4 were cut when the training phases came,
# to keep the script inside its time limit; PERF.md keeps their readings)
FIG1C_RANKS = (1, 8)

# Phase 1 of the process backend at one rank count under each start
# method, in a fresh interpreter that never touches CUDA and runs one
# thread: the only process where forking the caller is safe, so the one
# place the two rules can be timed against each other. argv: the DB paths
# as JSON, an output directory, the rank count.
START_METHOD_PROBE = """
import json, sys, time
from repro_torch.core import PipelineConfig, VariabilityPipeline, pipeline
import torch
paths, out, p = json.loads(sys.argv[1]), sys.argv[2], int(sys.argv[3])
res = {}
for name, method in (("fork", "fork"), ("forkserver_cold", "forkserver"),
                     ("forkserver_warm", "forkserver")):
    pipeline._START_METHOD = method
    pipe = VariabilityPipeline(PipelineConfig(n_ranks=p, backend="process",
                                              device="cpu"))
    gen = pipe.generate(paths, f"{out}/{name}")
    res[name] = {"phase1_s": gen.seconds,
                 "pids": len({w["pid"] for w in gen.workers})}
res["cuda_initialized"] = torch.cuda.is_initialized()
print(json.dumps(res))
"""


def _agg_equal(a, b, anom_a, anom_b):
    """Two exact results bit for bit: every moment field, sketch counts,
    fence flags and top bins."""
    import numpy as np
    for f in ("count", "sum", "sumsq", "min", "max"):
        np.testing.assert_array_equal(getattr(a.grouped, f),
                                      getattr(b.grouped, f))
    np.testing.assert_array_equal(a.reduced["quantile"].counts,
                                  b.reduced["quantile"].counts)
    np.testing.assert_array_equal(anom_a.flags, anom_b.flags)
    np.testing.assert_array_equal(anom_a.top_idx, anom_b.top_idx)


def _descendants():
    """{pid: (state, command)} of every process below this one, from
    /proc."""
    table = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
            cmd = Path(f"/proc/{entry}/cmdline").read_bytes()
        except OSError:                # ended while the table was read
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        table[int(entry)] = (state, int(ppid),
                             cmd.replace(b"\0", b" ").decode(
                                 errors="replace").strip())
    below, frontier = {}, [os.getpid()]
    while frontier:
        parent = frontier.pop()
        for pid, (state, ppid, cmd) in table.items():
            if ppid == parent and pid not in below:
                below[pid] = (state, cmd)
                frontier.append(pid)
    return below


def phase_reap():
    """Stop the rank pools' servers; then no process started by this one,
    or below it, may still run (an orphan shows as a survivor of the
    first listing)."""
    from repro_torch.core import pipeline
    before = _descendants()
    pipeline.stop_rank_pool_server()
    after = _descendants()
    left = {pid: cmd for pid, (_, cmd) in after.items()}
    for pid, (_, cmd) in before.items():
        try:
            state = Path(f"/proc/{pid}/stat").read_text().rsplit(
                ")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z":
            left[pid] = cmd
    log(f"reap: {len(before)} process(es) below this one before the "
        f"servers stopped: {sorted(before.items())}")
    if left:
        raise AssertionError(f"processes still running: {left}")


def phase_ranks(args, work, paths, card):
    """Fig 1c on the card's machine: the main phase's Table-1 DBs through
    the process and serial backends at each rank count, and the torch
    backend's phases 2+3 on the process store."""
    import numpy as np
    import torch

    from repro_torch.core import TraceStore, VariabilityPipeline

    cpus = len(os.sched_getaffinity(0))
    ranks = [p for p in FIG1C_RANKS if p <= cpus]
    log(f"ranks: {cpus} usable CPUs (os.cpu_count() {os.cpu_count()}), "
        f"rank counts {ranks} [{card}]")
    probe = subprocess.run(
        [sys.executable, "-c", START_METHOD_PROBE, json.dumps(paths),
         os.path.join(work, "probe"), str(ranks[-1])],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if probe.returncode != 0:
        raise AssertionError(f"start-method probe failed:\n{probe.stderr}")
    times = json.loads(probe.stdout.strip().splitlines()[-1])
    shutil.rmtree(os.path.join(work, "probe"), ignore_errors=True)
    log(f"ranks: process phase 1 at p = {ranks[-1]} in a fresh process "
        f"without CUDA, by start method: {times} [{card}]")
    if times["cuda_initialized"]:
        raise AssertionError("the start-method probe initialised CUDA")
    counters = _launch_counters()
    table = []
    for p in ranks:
        root = os.path.join(work, f"ranks{p}")
        res, t23, fences = {}, {}, {}
        for backend in ("process", "serial"):
            pipe = VariabilityPipeline(_cfg(args, backend, n_ranks=p))
            _zero(counters)
            t0 = time.perf_counter()
            res[backend] = pipe.run(paths, os.path.join(root, backend))
            torch.cuda.synchronize()
            t23[backend] = (time.perf_counter() - t0
                            - res[backend].generation.seconds)
            fences[backend] = counters["iqr_fences"].launches
            if backend == "process":
                # this process's peak so far: the card's machine keeps no
                # resettable high-water mark
                parent_rss = resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss
                gen_workers = res[backend].generation.workers
                scan_workers = pipe.scan_workers
        tpipe = VariabilityPipeline(_cfg(args, "torch", n_ranks=p))
        _zero(counters)
        t0 = time.perf_counter()
        tq = tpipe.query(os.path.join(root, "process"),
                         [tpipe.cfg.to_query()])[0]
        torch.cuda.synchronize()
        t23["torch"] = time.perf_counter() - t0
        t_launches = _path_launches(counters)
        fences["torch"] = t_launches["iqr_fences"]
        _need_launches(f"ranks p={p} torch", t_launches)
        for backend, n in fences.items():
            if n < 1:
                raise AssertionError(f"ranks p={p}: {backend} never "
                                     "launched iqr_fences")
        gen = res["process"].generation
        pids = sorted({w["pid"] for w in gen_workers})
        scan_pids = sorted({w["pid"] for w in scan_workers})
        if p > 1 and len(pids) < 2:
            raise AssertionError(f"ranks p={p}: phase 1 ran on one process")
        bad = _shards_equal(os.path.join(root, "serial"),
                            os.path.join(root, "process"), gen.n_shards)
        if bad or res["serial"].generation.joined_rows != gen.joined_rows:
            raise AssertionError(f"ranks p={p}: process shard files differ "
                                 f"from serial's: {bad}")
        _agg_equal(res["process"].aggregation, res["serial"].aggregation,
                   res["process"].anomalies, res["serial"].anomalies)
        _assert_torch_close(tq.result, tq.anomalies,
                            res["serial"].aggregation,
                            res["serial"].anomalies)
        owner = TraceStore(os.path.join(root, "process")).read_manifest()
        per_rank = int(np.bincount(owner.shard_owner, minlength=p).max())
        worker_rss = max(w["max_rss_kib"] for w in gen_workers + scan_workers)
        row = {"p": p, "phase1_process_s": gen.seconds,
               "phase1_serial_s": res["serial"].generation.seconds,
               "phase23_process_s": t23["process"],
               "phase23_serial_s": t23["serial"],
               "phase23_torch_s": t23["torch"],
               "max_shards_per_rank": per_rank,
               "joined_rows": gen.joined_rows,
               "parent_peak_rss_kib": parent_rss,
               "worker_peak_rss_kib": worker_rss,
               "iqr_fences": fences}
        table.append(row)
        log(f"ranks p={p}: phase 1 process {gen.seconds:.3f}s (pids {pids}) "
            f"/ serial {row['phase1_serial_s']:.3f}s; phases 2+3 process "
            f"{t23['process']:.3f}s (scan pids {scan_pids}) / serial "
            f"{t23['serial']:.3f}s / torch {t23['torch']:.3f}s; "
            f"{per_rank} shards max a rank, {gen.joined_rows} joined rows; "
            f"peak RSS of this process so far {parent_rss} KiB, of the "
            f"largest worker {worker_rss} KiB; iqr_fences launches "
            f"{fences}, torch {t_launches}; process == serial (shard files byte for byte, "
            f"moments, sketch, flags, top bins exact), torch == serial "
            f"(counts/min/max exact, sums rtol {RTOL}) [{card}]")
        shutil.rmtree(root, ignore_errors=True)
    log(f"ranks: Fig 1c table {json.dumps(table)}")


# the collective phase: rank processes on the one card, a gloo group
COLLECTIVE_RANKS = 4
COLLECTIVE_TIMEOUT_S = 300       # the group's; the phase's is 600 s
COLLECTIVE_FIELDS = ("count", "sum", "sumsq", "min", "max")


def _result_arrays(agg, anomalies):
    """An aggregation's moment fields, sketch counts (exact in float32:
    integer counts below 2^24), fence flags and top windows."""
    import numpy as np
    out = {f: getattr(agg.grouped, f) for f in COLLECTIVE_FIELDS}
    out["quantile"] = agg.reduced["quantile"].counts.astype(np.float32)
    out["flags"] = anomalies.flags
    out["top_windows"] = anomalies.top_windows
    return out


def collective_rank(args) -> int:
    """One rank of the collective phase, in a process of its own
    (``chip_smoke.py --collective-rank R``): phases 2 and 3 of the main
    phase's store, then the delta phase's append and a cold rerun, at P =
    COLLECTIVE_RANKS in a gloo group on cuda:0. Writes its record (and,
    on rank 0, the main store's result) under the phase's directory."""
    import datetime
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import TraceStore, VariabilityPipeline, pipeline
    from repro_torch.core import anomaly, distributed
    from repro_torch.kernels import _build

    root = args.collective_dir
    with open(os.path.join(root, "spec.json")) as f:
        spec = json.load(f)
    torch.set_num_threads(2)             # four ranks share the host's cores
    torch.cuda.set_device(0)
    _build.operators()                  # built by the parent: loaded only
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.collective_port}",
        rank=args.collective_rank, world_size=COLLECTIVE_RANKS,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    rank = dist.get_rank()
    counters = _launch_counters()
    pipe = VariabilityPipeline(_cfg(args, "torch"))
    rec = {"rank": rank, "pid": os.getpid()}

    cap = Capture(((distributed, "binstats_flat"),
                   (distributed, "histbin_flat"), (anomaly, "iqr_fences")))
    try:
        dist.barrier()
        _zero(counters)
        distributed.collective_times(reset=True)
        t0 = time.perf_counter()
        q = pipe.query(spec["main"], [pipe.cfg.to_query()])[0]
        torch.cuda.synchronize()
        rec["main_s"] = time.perf_counter() - t0
        rec["main_launches"] = _path_launches(counters)
        rec["main_collectives"] = distributed.collective_times(reset=True)
    finally:
        cap.close()
    if q.cache_hit or q.result.partial_hits:
        raise AssertionError("the P = 4 run served cached entries")
    errs = {}
    args_bs, _ = cap.calls["binstats_flat"]
    errs["binstats_flat"] = moments_err(counters["binstats_flat"](*args_bs),
                                        _plain("binstats_flat")(*args_bs))
    args_hb, _ = cap.calls["histbin_flat"]
    errs["histbin_flat"] = hist_err(counters["histbin_flat"](*args_hb),
                                    _plain("histbin_flat")(*args_hb))
    args_iq, kw_iq = cap.calls["iqr_fences"]
    errs["iqr_fences"] = iqr_err(counters["iqr_fences"](*args_iq, **kw_iq),
                                 _plain("iqr_fences")(*args_iq, **kw_iq))
    rec["errs"], rec["rows"] = errs, int(args_bs[0].shape[0])
    arrays = _result_arrays(q.result, q.anomalies)
    digest = hashlib.sha256()
    for k in sorted(arrays):
        digest.update(np.ascontiguousarray(arrays[k]).tobytes())
    rec["main_digest"] = digest.hexdigest()
    if rank == 0:
        np.savez(os.path.join(root, "main_p4.npz"), **arrays)
    del q, arrays

    # the delta phase's store before its append: a P = 4 run fills the
    # P = 4 partial namespace, the append's delta reads it back
    store = spec["delta_store"]
    pipe.aggregate(store)
    _zero(counters)
    distributed.collective_times(reset=True)
    t0 = time.perf_counter()
    delta = pipe.append(spec["delta_paths"], store)
    torch.cuda.synchronize()
    rec["delta_s"] = time.perf_counter() - t0
    rec["delta_launches"] = _path_launches(counters)
    rec["delta_collectives"] = distributed.collective_times(reset=True)
    agg = delta.aggregation
    if agg.partial_hits < 1 or not agg.recomputed_shards:
        raise AssertionError("the P = 4 delta served no partial or "
                             "recomputed nothing")
    cold_dir = os.path.join(root, "cold")
    if rank == 0:
        _bare_copy(store, cold_dir)
    dist.barrier()
    t0 = time.perf_counter()
    cold = pipe.aggregate(cold_dir)
    torch.cuda.synchronize()
    rec["cold_s"] = time.perf_counter() - t0
    if cold.partial_hits != 0:
        raise AssertionError("the P = 4 cold run read cached partials")
    for f in COLLECTIVE_FIELDS:
        np.testing.assert_array_equal(getattr(agg.grouped, f),
                                      getattr(cold.grouped, f))
    np.testing.assert_array_equal(agg.reduced["quantile"].counts,
                                  cold.reduced["quantile"].counts)
    rec["delta_shards"] = [len(agg.recomputed_shards), agg.partial_hits,
                           len(cold.recomputed_shards)]
    del delta, agg, cold
    # serving and streaming across the same ranks; rank 0 raises on a
    # wrong answer only after both, so no rank waits on the others
    faults = _rank_service(spec, pipe, rank, counters, rec)
    faults += _rank_stream(spec, pipe, rank, counters, rec, dist)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    pipeline.stop_rank_pool_server()
    dist.destroy_process_group()
    if faults:
        raise AssertionError("; ".join(faults))
    return 0


def _held_against_plain(counters, cap):
    """Each captured kernel call against its plain version on the same
    inputs (launches made here are not the path's)."""
    errs = {}
    for name, err in (("binstats_flat", moments_err),
                      ("histbin_flat", hist_err), ("iqr_fences", iqr_err)):
        if name not in cap.calls:
            errs[name] = None          # never launched: the parent fails
            continue
        c_args, kw = cap.calls[name]
        errs[name] = err(counters[name](*c_args, **kw),
                         _plain(name)(*c_args, **kw))
    return errs


def _calls_by_name(calls):
    """``(name, s)`` collective calls -> {name: [count, total s, max s]}."""
    out = {}
    for name, sec in calls:
        n, tot, mx = out.get(name, (0, 0.0, 0.0))
        out[name] = [n + 1, round(tot + sec, 4), round(max(mx, sec), 4)]
    return out


def _rank_service(spec, pipe, rank, counters, rec):
    """Every rank serves a cache-free copy of the main store at P =
    COLLECTIVE_RANKS (``pipe.serve`` on every rank; rank 0 holds the port)
    while SERVICE_CLIENTS threads on rank 0 send the service phase's
    queries, each twice. Returns rank 0's faults (every response 200, a
    fused tick, a hit, each answer == the service phase's P = 1 one)."""
    import threading

    import torch

    from repro_torch.core import TraceStore, anomaly, distributed
    from repro_torch.serve import QueryClient

    store = spec["service_store"]
    specs = _service_queries(TraceStore(store).read_manifest())
    with open(spec["service_p1"]) as f:
        want = json.load(f)
    n = SERVICE_CLIENTS
    bodies, walls, errors = [None] * (2 * n), [0.0] * (2 * n), []
    cap = Capture(((distributed, "binstats_flat"),
                   (distributed, "histbin_flat"), (anomaly, "iqr_fences")))
    try:
        _zero(counters)
        distributed.collective_times(reset=True)
        t0 = time.perf_counter()
        svc = pipe.serve(store, port=0, tick_ms=50.0, pipeline_depth=4)
        try:
            if rank == 0:
                client = QueryClient(port=svc.cfg.port, timeout_s=600.0)
                if not client.wait_healthy(timeout_s=30.0):
                    errors.append("service: not healthy")
                start = threading.Barrier(n)

                def ask(i):
                    try:
                        start.wait(60)
                        for k in (0, 1):
                            t = time.perf_counter()
                            bodies[2 * i + k] = client.query_raw(
                                [specs[i % len(specs)]])
                            walls[2 * i + k] = time.perf_counter() - t
                    except BaseException as e:   # noqa: BLE001 — below
                        errors.append(f"client {i}: {type(e).__name__}: "
                                      f"{e}")

                threads = [threading.Thread(target=ask, args=(i,))
                           for i in range(n)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                rec["service_stats"] = {
                    k: v for k, v in client.stats().items()
                    if k in ("ticks", "max_fused_width", "inflight_hits",
                             "tick_p50_ms", "tick_p95_ms", "tick_p99_ms",
                             "world_size")}
        finally:
            svc.stop()
        torch.cuda.synchronize()
        rec["service_s"] = time.perf_counter() - t0
        rec["service_launches"] = _path_launches(counters)
        rec["service_collectives"] = _calls_by_name(
            distributed.collective_times(reset=True))
        rec["service_group"] = svc.stats()["group"]
    finally:
        cap.close()
    rec["service_errs"] = _held_against_plain(counters, cap)
    if rank != 0:
        return []
    rec["service_walls"] = sorted(round(w, 3) for w in walls)
    rec["service_queries"] = len(specs)
    faults = list(errors)
    if not errors:
        widths = [b["tick"]["fused_width"] for b in bodies]
        rec["service_widths"] = widths
        rec["service_hits"] = sum(
            bool(b["results"][0].get("inflight_hit")
                 or b["results"][0]["cache_hit"]) for b in bodies)
        if max(widths) < 2:
            faults.append("P = 4 service: no tick fused two requests")
        if rec["service_hits"] < 1:
            faults.append("P = 4 service: no in-flight or summary hit")
        for j, b in enumerate(bodies):
            try:
                _same_answer(b["results"][0], want[(j // 2) % len(specs)])
            except AssertionError as e:
                faults.append(f"P = 4 service != P = 1: {e}")
    return faults


def _rank_stream(spec, pipe, rank, counters, rec, dist):
    """Every rank streams a cache-free copy of the delta phase's store
    from before its append, tailing the delta's grown DBs (the tailer on
    rank 0): one ingest tick or more brings the append in, its fence push
    read over HTTP on rank 0. Then every rank runs the fence query cold at
    P = COLLECTIVE_RANKS over a cache-free copy of the resulting shards;
    the streamed fence state and the fence query's moments and sketch
    must equal it bit for bit. Returns rank 0's faults."""
    import numpy as np
    import torch

    from repro_torch.core import anomaly, distributed
    from repro_torch.serve import (DEFAULT_FENCE_QUERY, IngestConfig,
                                   QueryClient)

    store = spec["stream_store"]
    faults, events = [], []
    cap = Capture(((distributed, "binstats_flat"),
                   (distributed, "histbin_flat"), (anomaly, "iqr_fences")))
    try:
        _zero(counters)
        distributed.collective_times(reset=True)
        t0 = time.perf_counter()
        svc = pipe.stream(store, spec["delta_paths"],
                          ingest=IngestConfig(poll_ms=25.0))
        try:
            if rank == 0:
                client = QueryClient(port=svc.cfg.port, timeout_s=600.0)
                body = client.fences(since=0, timeout_s=120.0)
                if not svc.ingestor.quiesce(timeout_s=300.0):
                    faults.append("P = 4 stream: the plane did not catch "
                                  "up")
                events, since = list(body["events"]), body["next_since"]
                while True:
                    more = client.fences(since=since, timeout_s=0.2)
                    if not more["events"]:
                        break
                    events += more["events"]
                    since = more["next_since"]
                st = client.stats()["ingest"]
                rec["stream_ingest"] = {
                    k: st[k] for k in ("ingest_ticks", "rows_ingested",
                                       "fence_transitions", "errors",
                                       "event_to_fence_p50_ms",
                                       "event_to_fence_p99_ms")}
                streamed = svc.ingestor.fence_state().get(
                    DEFAULT_FENCE_QUERY.cache_key(), ())
        finally:
            svc.stop()
        torch.cuda.synchronize()
        rec["stream_s"] = time.perf_counter() - t0
        rec["stream_launches"] = _path_launches(counters)
        rec["stream_collectives"] = _calls_by_name(
            distributed.collective_times(reset=True))
        rec["stream_group"] = svc.stats()["group"]
    finally:
        cap.close()
    rec["stream_errs"] = _held_against_plain(counters, cap)
    cold_dir = os.path.join(os.path.dirname(store), "stream_cold")
    if rank == 0:
        _bare_copy(store, cold_dir)
    dist.barrier()
    t0 = time.perf_counter()
    cold = pipe.query(cold_dir, [DEFAULT_FENCE_QUERY])[0]
    torch.cuda.synchronize()
    rec["stream_cold_s"] = time.perf_counter() - t0
    mine = pipe.query(store, [DEFAULT_FENCE_QUERY])[0]
    flags = tuple(int(i) for i in np.flatnonzero(cold.anomalies.flags))
    rec["stream_flags"] = len(flags)
    try:
        if not mine.cache_hit or cold.cache_hit:
            raise AssertionError("the stream left no P = 4 summary, or "
                                 "the cold copy had one")
        for f in COLLECTIVE_FIELDS:
            np.testing.assert_array_equal(getattr(mine.result.stats, f),
                                          getattr(cold.result.stats, f))
        np.testing.assert_array_equal(
            mine.result.reduced["quantile"].counts,
            cold.result.reduced["quantile"].counts)
        np.testing.assert_array_equal(mine.anomalies.flags,
                                      cold.anomalies.flags)
    except AssertionError as e:
        faults.append(f"P = 4 stream != cold P = 4: {e}")
    if rank != 0:
        return faults
    rec["stream_events"] = len(events)
    if not events:
        faults.append("P = 4 stream: no fence event over HTTP")
    if rec["stream_ingest"]["errors"] or not rec["stream_ingest"][
            "rows_ingested"]:
        faults.append(f"P = 4 stream: ingest {rec['stream_ingest']}")
    if tuple(streamed) != flags:
        faults.append(f"P = 4 stream: fence state {streamed} != cold "
                      f"{flags}")
    return faults


def _run_ranks(args, root, role, n, limit_s, script=None):
    """Start ``n`` rank processes of ``role`` (``chip_smoke.py
    --rank-role ROLE --collective-rank R``, or ``script`` with the same
    flags; the kernels loaded from the parent's build) in a gloo group on
    a free port, wait for all of them (at most ``limit_s`` seconds, then
    kill them) and raise if any failed; returns the seconds they took."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, str(Path(script or __file__).resolve()), "--seed",
           str(args.seed), "--ranks", str(args.ranks), "--duration",
           str(args.duration), "--rank-role", role, "--collective-dir",
           root, "--collective-port", str(port), "--collective-rank"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    failed = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(
                timeout=max(limit_s - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
            failed.append(f"rank {r} timed out: {err[-2000:]}")
            continue
        if p.returncode != 0:
            failed.append(f"rank {r} exit {p.returncode}: {err[-3000:]}")
    if failed:
        raise AssertionError(f"{role}: " + "\n".join(failed))
    return time.perf_counter() - t0


def phase_collective(args, work, main_res, delta_copy, card):
    """The paper's collaborative merge across ranks: COLLECTIVE_RANKS
    rank processes on cuda:0 in a gloo group run phases 2 and 3 of a copy
    of the main phase's store, then the delta phase's append and a cold
    rerun; the P = 4 result must equal the main phase's P = 1 one and the
    delta its cold rerun bit for bit."""
    import numpy as np

    root = os.path.join(work, "collective")
    os.makedirs(root, exist_ok=True)
    main_copy, service_copy = (os.path.join(root, d)
                               for d in ("main", "service"))
    for d in (main_copy, service_copy):
        _bare_copy(os.path.join(work, "store"), d)
    delta_paths, delta_store, stream_store = delta_copy
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump({"main": main_copy, "delta_paths": delta_paths,
                   "delta_store": delta_store,
                   "service_store": service_copy,
                   "service_p1": os.path.join(root, "service_p1.json"),
                   "stream_store": stream_store}, f)
    seconds = _run_ranks(args, root, "collective", COLLECTIVE_RANKS, 600)
    recs = []
    for r in range(COLLECTIVE_RANKS):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    for rec in recs:
        for key in ("main_launches", "delta_launches", "service_launches",
                    "stream_launches"):
            _need_launches(f"collective rank {rec['rank']} ({key})",
                           rec[key])
        for key in ("service_errs", "stream_errs"):
            if any(e is None for e in rec[key].values()):
                raise AssertionError(f"collective rank {rec['rank']}: no "
                                     f"call captured for {key}")
        calls = {}
        for name, s in rec["main_collectives"]:
            calls.setdefault(name, []).append(round(s, 4))
        log(f"collective rank {rec['rank']} (pid {rec['pid']}): "
            f"{rec['rows']} rows of the main store in its section; "
            f"phases 2+3 {rec['main_s']:.3f}s, launches "
            f"{rec['main_launches']}; delta {rec['delta_s']:.3f}s, launches "
            f"{rec['delta_launches']}; cold {rec['cold_s']:.3f}s; "
            f"collective seconds in phases 2+3 {calls}; |kernel - plain| "
            f"on its inputs {rec['errs']} [{card}]")
    if len({rec["main_digest"] for rec in recs}) != 1:
        raise AssertionError("the ranks' P = 4 results differ")
    got = dict(np.load(os.path.join(root, "main_p4.npz")))
    want = _result_arrays(main_res.aggregation, main_res.anomalies)
    for f in ("count", "min", "max", "quantile", "flags", "top_windows"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("sum", "sumsq"):
        np.testing.assert_allclose(got[f], want[f], rtol=RTOL, err_msg=f)
    for what in ("service", "stream"):
        for rec in recs:
            log(f"collective rank {rec['rank']} {what}: "
                f"{rec[what + '_s']:.3f}s, launches "
                f"{rec[what + '_launches']}; |kernel - plain| on its "
                f"inputs {rec[what + '_errs']}; ticks and digests "
                f"{rec[what + '_group']}; collectives (calls, s, max s) "
                f"{rec[what + '_collectives']} [{card}]")
        digests = {json.dumps({k: v for k, v in rec[what + "_group"].items()
                               if k != "rank"}, sort_keys=True)
                   for rec in recs}
        if len(digests) != 1:
            raise AssertionError(f"collective {what}: the ranks executed "
                                 "different ticks")
    lead = recs[0]
    st = lead["service_stats"]
    log(f"collective service: P = {st['world_size']}, {SERVICE_CLIENTS} "
        f"clients x 2 asks of {lead['service_queries']} distinct queries; "
        f"request wall s {lead['service_walls']}; fused widths "
        f"{lead['service_widths']}; in-flight or summary hits "
        f"{lead['service_hits']}; ticks {st['ticks']}, tick p50/p95/p99 "
        f"{st['tick_p50_ms']:.1f} / {st['tick_p95_ms']:.1f} / "
        f"{st['tick_p99_ms']:.1f} ms; every answer == the service phase's "
        f"P = 1 (counts, flags exact; min/max in float32; means rtol "
        f"{RTOL}); every rank's tick digests equal [{card}]")
    si = lead["stream_ingest"]
    log(f"collective stream: {lead['stream_events']} fence events over "
        f"HTTP; ingest ticks {si['ingest_ticks']}, rows "
        f"{si['rows_ingested']}, fence transitions "
        f"{si['fence_transitions']}; event_to_fence p50/p99 "
        f"{si['event_to_fence_p50_ms']:.1f} / "
        f"{si['event_to_fence_p99_ms']:.1f} ms; fence state "
        f"({lead['stream_flags']} flagged bins), moments and sketch == a "
        f"cold P = {COLLECTIVE_RANKS} run bit for bit (cold "
        f"{lead['stream_cold_s']:.3f}s); service + stream + cold "
        f"{max(r['service_s'] + r['stream_s'] + r['stream_cold_s'] for r in recs):.3f}s"
        f" on the slowest rank [{card}]")
    recomputed, hits, cold = recs[0]["delta_shards"]
    log(f"collective: {COLLECTIVE_RANKS} ranks on cuda:0 over gloo; P = "
        f"{COLLECTIVE_RANKS} == the main phase's P = 1 (counts, min, max, "
        f"sketch counts, {int(want['flags'].sum())} flags and the top "
        f"windows exact, sums rtol {RTOL}); every rank's result equal; "
        f"delta ({recomputed} shards recomputed, {hits} from the P = 4 "
        f"partial cache) == cold ({cold} shards) bitwise; {seconds:.3f}s "
        f"[{card}]")
    return seconds


TP_RANKS = 4
TP_TIMEOUT_S = 300               # the group's; the phase's is 460 s
# the tp phase's models, each at full width (and depth, but as
# TP_DEPTH_CUTS says) with 1 request of 2,048 prompt tokens and 8 new
# tokens; the kernel each must launch in one prefill on every rank, how
# many times, and in which flash_attention instantiation where it says
TP_SPECS = {
    "tp-danube": dict(arch="h2o-danube-1.8b", prompt=2048, new=8,
                      kernel="flash_attention", launches=24),
    # 25 query heads and 5 KV heads 4 does not divide: the attention runs
    # whole on every rank over its block of each cache's slots (2,184 =
    # 128 meta + 2,048 + 8: 546 a rank of each global cache, 256 of each
    # 1,024-slot ring), the 50 SSM heads scanned whole on every rank;
    # ``also``: a second kernel and its launches a prefill on every rank,
    # ``caches``: each rank's cache blocks held against P = 1's slices
    "tp-hymba": dict(arch="hymba-1.5b", prompt=2048, new=8,
                     kernel="flash_attention", launches=32,
                     also={"ssd_fused": 32}, caches=True),
    "tp-mamba2": dict(arch="mamba2-370m", prompt=2048, new=8,
                      kernel="ssd_fused", launches=48),
    "tp-granite": dict(arch="granite-moe-1b-a400m", prompt=2048, new=8,
                       kernel="flash_attention", launches=24),
    "tp-deepseek": dict(arch="deepseek-v2-236b", prompt=2048, new=8,
                        kernel="flash_attention", launches=2,
                        flash_instance=(192, 128)),
}
# the tp phase's flash_attention rows, one a model
TP_FLASH_ROWS = tuple(f"flash_attention/{tag}" for tag, spec in
                      TP_SPECS.items() if spec["kernel"] == "flash_attention")
# the tp phase's step on a (2, 2) mesh: granite-moe at full width and
# depth, 2 requests of 2,048 prompt tokens and 8 new served on data x model
# = 2 x 2, then `steps` decode steps on the weights-stationary branch;
# flash_attention launches a prefill on every rank
DP_TAG = "dp-granite"
DP_SPEC = dict(arch="granite-moe-1b-a400m", model=2, batch=2, prompt=2048,
               new=8, steps=8, launches=24)
TP_FLASH_ROWS += (f"flash_attention/{DP_TAG}",)
# the tp phase's training steps on the (1, 4) mesh: each model at full
# width, its depth cut as TP_TRAIN_DEPTH_CUTS says, a batch of 1 x 2,048
# tokens from make_batch at --seed, grad_accum 1, remat "full", one
# warm-up step and TP_TRAIN_STEPS timed ones at the peak lr TRAIN_SPECS
# gives the architecture (no warm-up of the schedule); the kernels each
# launches, each 2 a layer a step (the forward and the remat recompute),
# and the flash_attention instantiation where it names one
TP_TRAIN_SPECS = {
    "tp-train-granite": dict(arch="granite-moe-1b-a400m", seq=2048,
                             lr=TRAIN_SPECS["train-granite"]["lr"],
                             kernels=("flash_attention",)),
    "tp-train-mamba2": dict(arch="mamba2-370m", seq=2048,
                            lr=TRAIN_SPECS["train"]["lr"],
                            kernels=("ssd_fused",)),
    # 25 query heads, 5 KV heads and 50 SSM heads 4 does not divide: the
    # attention and the scan run whole on every rank over 128 meta +
    # 2,048 tokens, and each whole tensor's gradient is summed once over
    # the tensor axis (the FFN and the SSM's channels are the rank's)
    "tp-train-hymba": dict(arch="hymba-1.5b", seq=2048,
                           lr=TRAIN_SPECS["train-hymba"]["lr"],
                           kernels=("flash_attention", "ssd_fused"),
                           flash_instance=(64, 64)),
    # on a (2, 2) mesh (``model`` ranks on the tensor axis, the rest on
    # data), ``batch`` rows of ``seq`` tokens: one row a data rank
    "dp-train-granite": dict(arch="granite-moe-1b-a400m", seq=2048,
                             batch=2, model=2,
                             lr=TRAIN_SPECS["train-granite"]["lr"],
                             kernels=("flash_attention",)),
}
# (mamba2's 8 layers took 13-15 s of the step on one host, over the 30 s
# the two steps may add to the tp phase with the ~9 s the process's first
# non-reentrant checkpoint call takes; hymba: one global layer and one
# window-1,024 layer)
TP_TRAIN_DEPTH_CUTS = {"granite-moe-1b-a400m": (4,), "mamba2-370m": (4,),
                       "hymba-1.5b": (1, 1, 0, 0, 0)}
TP_TRAIN_STEPS = 2
TP_FLASH_ROWS += ("flash_attention/tp-train-granite",
                  "flash_attention/tp-train-hymba",
                  "flash_attention/dp-train-granite")
# deepseek-v2-236b's dense layer and 1 of its 59 MoE layers: every rank
# draws the whole tree before it keeps its shards, ~4.8 B parameters (9.7
# GB in bfloat16) here, so the four trees take ~39 GB at once (DEPTH_CUTS'
# 4 MoE layers would take 134 GB)
TP_DEPTH_CUTS = {"deepseek-v2-236b": (1, 1)}


def _digest(*tensors):
    """A checksum of the bits of ``tensors`` (each as float32, which keeps
    16-bit values apart), computed on their device: each one's words
    summed plainly and weighted by a position hash (int64 wrap-around),
    so two tensors that differ in any word differ here."""
    import torch
    out = []
    for t in tensors:
        w = t.detach().float().contiguous().view(-1).view(torch.int32).to(
            torch.int64)
        pos = (torch.arange(w.numel(), device=w.device, dtype=torch.int64)
               * 2654435761) % 2147483647 + 1
        out.append([int(w.sum()), int((w * pos).sum())])
    return out


@contextlib.contextmanager
def _moe_dropped(into):
    """Keep each ``moe_forward`` call's dropped share in ``into`` (the
    layer loop looks the function up in ``transformer``)."""
    from repro_torch.models import transformer
    real = transformer.moe_forward

    def tapped(*a, **kw):
        out = real(*a, **kw)
        into.append(out[1]["dropped"])
        return out
    transformer.moe_forward = tapped
    try:
        yield into
    finally:
        transformer.moe_forward = real


@contextlib.contextmanager
def _blocked_moe(t):
    """P = 1 under the ``ep`` path's capacity: each MoE call's routed part
    runs as ``t`` calls, one a sequence block (a batch of 1 request: rows
    ``[r S/t, (r+1) S/t)``), in block order; the aux loss and the dropped
    share are the blocks' mean, added in block order."""
    import torch

    from repro_torch.models import moe
    real = moe._moe_local

    def blocked(params, tokens, cfg):
        n = tokens.shape[0] // t
        parts = [real(params, tokens[r * n:(r + 1) * n], cfg)
                 for r in range(t)]
        means = []
        for i in (1, 2):
            acc = parts[0][i].float()
            for p in parts[1:]:
                acc = acc + p[i].float()
            means.append(acc / t)
        return torch.cat([p[0] for p in parts]), *means
    moe._moe_local = blocked
    try:
        yield
    finally:
        moe._moe_local = real


def _mean(xs):
    import torch
    return float(torch.stack([x.float() for x in xs]).mean()) if xs else None


def _tp_yardstick(cfg, seed, dev, batch, tokens, tp_logits, chosen, max_len,
                  data=1, tp_caches=None):
    """Rank 0's P = 1 run of the function the TP run computed: the whole
    tree drawn again from ``seed``, decode teacher-forced on the TP run's
    tokens. For an MoE model each prefill MoE call's routed part runs on
    the TP_RANKS blocks as separate calls (``_blocked_moe``: the ``ep``
    path's per-block capacity; on a mesh of ``data`` data ranks rank r's
    block is its request's sequence block, the blocks in rank order), and
    every routing takes the TP run's expert choices (``_Routing``:
    prefill layer l's block r is rank r's call l; decode call k is the
    data ranks' calls k, their rows stacked in data order). Returns the
    gaps a step, P = 1's argmax a step (of the first request, and of
    each), and for an MoE model the dropped shares, the free-running gap
    (P = 1's own routing, capacity over the whole call) and the tokens
    whose own top-k differs from the replayed choice. ``tp_caches``: the
    files of each rank's prefill cache blocks, held against P = 1's
    prefill caches cut as ``cache_specs`` lays them out
    (``_cache_gaps``)."""
    import torch

    from repro_torch.models import model

    params = model.init_params(cfg, seed=seed, device=dev)
    gaps_of_caches = {}
    n_moe = sum(n for sp, n in cfg.plan if sp.moe is not None)
    routing, drops = _Routing(), []
    t = TP_RANKS // data
    routing.chosen = [chosen[r][i].to(dev) for i in range(n_moe)
                      for r in range(TP_RANKS)] + [
        torch.cat([chosen[d * t][k] for d in range(data)]).to(dev)
        for k in range(n_moe, len(chosen[0]))]
    replay = routing.replay() if n_moe else contextlib.nullcontext()
    blocked = _blocked_moe(TP_RANKS) if n_moe else contextlib.nullcontext()
    with torch.inference_mode(), replay, _moe_dropped(drops):
        with blocked:
            lg, caches, index = model.prefill(cfg, params, batch, max_len,
                                              cfg.dtype)
        if tp_caches:
            gaps_of_caches = _cache_gaps(caches, tp_caches)
        p1 = [lg]
        for t in range(tokens.shape[1] - 1):
            tok = torch.as_tensor(tokens[:, t:t + 1], device=dev)
            lg, caches = model.decode_step(cfg, params, tok, caches,
                                           index + t)
            p1.append(lg)
        del caches
    argmax = torch.stack([p.argmax(-1) for p in p1], dim=1).cpu()
    out = {"gaps": [_logit_gap(a.float(), b.float())
                    for a, b in zip(tp_logits, p1)],
           "argmax_p1": argmax[0].tolist(), "argmax_rows": argmax.tolist(),
           **gaps_of_caches}
    if n_moe:
        free = []
        with torch.inference_mode(), _moe_dropped(free):
            lg_free, _, _ = model.prefill(cfg, params, batch, max_len,
                                          cfg.dtype)
        pre = routing.flips[:n_moe * TP_RANKS]
        out.update({
            "dropped_p1": _mean(drops[:n_moe]),
            "dropped_free": _mean(free),
            "free_gap": _logit_gap(tp_logits[0].float(), lg_free.float()),
            "flips_prefill": [sum(pre[i * TP_RANKS:(i + 1) * TP_RANKS])
                              for i in range(n_moe)],
            "flips_decode": sum(routing.flips[n_moe * TP_RANKS:])})
    del params
    return out


def _cache_gaps(caches, files):
    """Each rank's prefill cache blocks (``files``, in rank order, from a
    (1, TP_RANKS) mesh) against the slices ``cache_specs`` gives that
    rank of the P = 1 prefill's whole ``caches``: the largest |TP - P1|
    a rank over every leaf, whether its first layer's attention k and v
    are bit-equal, and the leaves compared."""
    import torch

    from repro_torch.core.mesh import Mesh
    from repro_torch.models.shardrules import _items, cache_specs
    mesh = Mesh(("data", "model"), {"data": 1, "model": TP_RANKS})
    whole = dict(_items(caches))
    specs = dict(_items(cache_specs(caches, mesh)))
    gaps, first, n = [], [], 0
    for r, f in enumerate(files):
        worst, same = 0.0, True
        for path, block in _items(torch.load(f)):
            want = whole[path]
            for dim, entry in enumerate(specs[path]):
                if entry and "model" in entry:
                    size = want.shape[dim] // TP_RANKS
                    want = want.narrow(dim, r * size, size)
            block = block.to(want.device)
            worst = max(worst, float((block.float() - want.float()).abs()
                                     .max()))
            if path in ("0/0/attn/k", "0/0/attn/v"):
                same = same and torch.equal(block, want)
            n += r == 0
        gaps.append(worst)
        first.append(same)
    return {"cache_gap": gaps, "cache_layer0_equal": first,
            "cache_leaves": n}


@contextlib.contextmanager
def _slot_writes(into):
    """Keep in ``into`` one record of each decode position's first global
    and first window attention layer (GQA): the position, the slot of the
    whole cache it goes to, this rank's block of the slots and whether
    the rank wrote the slot (its row of k changed)."""
    import torch

    from repro_torch.models import transformer
    real, seen = transformer.attn_decode, set()

    def tapped(params, x, cache, cfg, index, ctx=None, block=None):
        key = (index, cfg.window > 0)
        if "k" not in cache or key in seen:
            return real(params, x, cache, cfg, index, ctx, block)
        seen.add(key)
        length = block.length if block else cache["k"].shape[1]
        start, size = (block.start, block.size) if block else (0, length)
        slot = index % length if cfg.window > 0 else min(index, length - 1)
        mine = start <= slot < start + size
        before = cache["k"][:, slot - start].clone() if mine else None
        out = real(params, x, cache, cfg, index, ctx, block)
        wrote = mine and not torch.equal(cache["k"][:, slot - start], before)
        into.append({"index": index, "window": cfg.window, "slot": slot,
                     "block": [start, size], "wrote": wrote})
        return out
    transformer.attn_decode = tapped
    try:
        yield into
    finally:
        transformer.attn_decode = real


@contextlib.contextmanager
def _branches(into):
    """Count each ``moe_forward`` branch call in ``into`` (by branch
    name) within the block."""
    from repro_torch.models import moe
    names = {"_moe_ep": "ep", "_moe_stationary": "stationary",
             "_moe_replicated": "replicated", "_moe_local": "local"}
    real = {name: getattr(moe, name) for name in names}

    def counted(name):
        def wrapped(*a):
            into[names[name]] = into.get(names[name], 0) + 1
            return real[name](*a)
        return wrapped
    for name in names:
        setattr(moe, name, counted(name))
    try:
        yield into
    finally:
        for name, fn in real.items():
            setattr(moe, name, fn)


def _by_kind(calls):
    """{collective name: (calls, seconds)} of ``collective_times``."""
    out = {}
    for name, sec in calls:
        n, total = out.get(name, (0, 0.0))
        out[name] = (n + 1, total + sec)
    return out


def dp_serve(cfg, seed, dev, host, spec, counters=None):
    """The dp-granite step on this rank of a group of TP_RANKS ranks (on
    the CPU too, at any config): ``cfg`` served from ``seed`` through
    ``ServeEngine(..., mesh=make_host_mesh(model=spec["model"]))`` on
    ``host`` (numpy inputs), then ``spec["steps"]`` decode steps under
    ``make_ctx(mesh, inference=True)`` over the inference layout,
    teacher-forced on the served tokens over the served caches, under the
    expert choices of the replicated decode at the same step (the
    engine's, and one more replicated step after them), gathered from
    the data ranks. Rank 0 then runs ``_tp_yardstick``. Returns (the
    record, the captured kernel calls)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.core import group
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention, model, ssm, tp
    from repro_torch.models.shardrules import (_items, bytes_per_device,
                                               make_ctx, shard_batch,
                                               shard_params)
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve import engine as engine_mod
    from repro_torch.telemetry import KIND_DECODE, KIND_PREFILL

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for _, x in _items(tree))

    rank, t = dist.get_rank(), spec["model"]
    mesh = make_host_mesh(model=t)
    n_new, steps = spec["new"], spec["steps"]
    max_len = spec["prompt"] + max(n_new, steps)
    params = model.init_params(cfg, seed=seed, device=dev)
    engine = ServeEngine(cfg, params, ServeConfig(
        max_len=max_len, max_new_tokens=n_new, cache_dtype=cfg.dtype),
        device=dev, mesh=mesh)
    inf = make_ctx(mesh, inference=True)
    placed = shard_params(params, inf)
    want = bytes_per_device(params, mesh)
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    n_moe = sum(n for sp, n in cfg.plan if sp.moe is not None)
    # a first small collective on each of the new mesh's groups (the
    # kernels and the host's buffers are warm from the models before)
    for axis in ("data", "model", tp.MESH):
        tp.ordered_sum(torch.zeros(8, device=dev), engine.ctx, axis)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    n_steps = len(engine.telemetry.steps)
    cap = Capture(((ssm, "ssd_fused"), (attention, "flash_attention")),
                  key=_flash_key)
    logits, served = [], {}              # generate's logits, caches
    routing, drops, branches = _Routing(), [], {}

    def keep(fn):
        def wrapped(*a, **kw):
            res = fn(*a, **kw)
            logits.append(res[0])
            if len(res) == 3:
                served.update(caches=res[1], index=res[2])
            return res
        return wrapped
    engine_mod.prefill = keep(model.prefill)
    engine_mod.decode_step = keep(model.decode_step)
    try:
        dist.barrier()
        if counters is not None:
            _zero(counters)
        group.collective_times(reset=True)
        with routing.record(), _moe_dropped(drops), _branches(branches):
            tokens = engine.generate(host)
        sync()
        launches = {k: counters[k].launches if counters else 0
                    for k in ("flash_attention", "ssd_fused")}
        tc = {k: getattr(counters[k], "wgmma_launches", 0) if counters
              else 0 for k in ("flash_attention", "ssd_fused")}
        coll = _by_kind(group.collective_times(reset=True))
    finally:
        engine_mod.prefill = model.prefill
        engine_mod.decode_step = model.decode_step
        cap.close()
    steps_rec = engine.telemetry.steps[n_steps:]
    pre_ms = [(e.end_ns - e.start_ns) / 1e6 for e in steps_rec
              if e.kind == KIND_PREFILL]
    dec_ms = [(e.end_ns - e.start_ns) / 1e6 for e in steps_rec
              if e.kind == KIND_DECODE]
    # the rank's rows of the served tokens; one more replicated step
    rows, ctx = shard_batch({"t": torch.as_tensor(tokens, device=dev)},
                            engine.ctx)
    rows, caches, index = rows["t"], served["caches"], served["index"]
    replicated = list(logits[1:])
    with torch.inference_mode(), routing.record():
        for i in range(len(replicated), steps):
            lg, caches = model.decode_step(cfg, engine.params,
                                           rows[:, i:i + 1], caches,
                                           index + i, ctx, max_len)
            replicated.append(lg)
    # every rank's expert choices (the replay below and rank 0's P = 1)
    every = group.gather([c.cpu() for c in routing.chosen], "dp_choices")
    d = dist.get_world_size() // t
    stat_routing, sta_branches, sta_logits, sta_ms = _Routing(), {}, [], []
    stat_routing.chosen = [
        torch.cat([every[j * t][n_moe * (1 + i) + l]
                   for j in range(d)]).to(dev)
        for i in range(steps) for l in range(n_moe)]
    sta = dataclasses.replace(ctx, inference=True)
    group.collective_times(reset=True)
    with torch.inference_mode(), stat_routing.replay(), \
            _branches(sta_branches):
        for i in range(steps):
            sync()
            t0 = time.perf_counter()
            lg, caches = model.decode_step(cfg, placed, rows[:, i:i + 1],
                                           caches, index + i, sta, max_len)
            sync()
            sta_ms.append((time.perf_counter() - t0) * 1e3)
            sta_logits.append(lg)
    sta_coll = _by_kind(group.collective_times(reset=True))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    rec = {
        "launches": launches, "tensor_core": tc,
        "errs": _captured_errs(cap.calls, f"{DP_TAG} rank {rank}")
        if cuda else {},
        "bytes": [nbytes(engine.params), want],
        "bytes_inference": [nbytes(placed), want],
        "prefill_ms": pre_ms, "decode_ms": dec_ms, "stationary_ms": sta_ms,
        "peak_gib": peak, "collectives": coll,
        "stationary_collectives": sta_coll, "tokens": tokens.tolist(),
        "branches": branches, "stationary_branches": sta_branches,
        "dropped": _mean(drops[:n_moe]),
        "digest": _digest(*logits), "rows": int(rows.shape[0]),
        "finite": all(bool(torch.isfinite(x).all())
                      for x in logits + sta_logits),
        "stationary_gaps": [_logit_gap(a.float(), b.float())
                            for a, b in zip(sta_logits, replicated)],
        "stationary_flips": stat_routing.flips,
        "shapes": {k: [list(a.shape) for a in c[0] if hasattr(a, "shape")]
                   for k, c in cap.calls.items()}}
    # every rank's logits to rank 0, the requests stacked in data order
    all_logits = group.gather([x.cpu() for x in logits], "dp_logits")
    calls = cap.calls
    del engine, placed, caches, served, logits, replicated, sta_logits
    del routing, stat_routing, cap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank == 0:
        whole = [torch.cat([all_logits[j * t][i] for j in range(d)]).to(dev)
                 for i in range(len(all_logits[0]))]
        batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        rec.update(_tp_yardstick(cfg, seed, dev, batch, tokens, whole,
                                 every, max_len, data=d))
    return rec, calls


@contextlib.contextmanager
def _first_grads(into):
    """Keep the gradients the first ``adamw_update`` call of the block
    receives (the train step's float32 gradients, before clipping) in
    ``into``, one tensor a leaf in tree order."""
    from repro_torch.train import step
    from repro_torch.train.optim import tree_leaves
    real = step.adamw_update

    def kept(cfg, grads, *a, **kw):
        if not into:
            into.extend(tree_leaves(grads))
        return real(cfg, grads, *a, **kw)
    step.adamw_update = kept
    try:
        yield into
    finally:
        step.adamw_update = real


def _block_of(x, spec, r, shape):
    """Rank r's block of a whole tensor ``x`` on a ``(data, model)`` mesh
    of ``shape``: along each dim ``spec`` cuts, its coordinate's block
    (the rank's data row over ``data``, its column over ``model``)."""
    d, t = shape
    for dim, entry in enumerate(spec):
        for axis, i, n in (("data", r // t, d), ("model", r % t, t)):
            if entry and axis in entry:
                size = x.shape[dim] // n
                x = x.narrow(dim, i * size, size)
    return x


def _tp_train_yardstick(cfg, seed, dev, tcfg, batches, chosen, blocks,
                        names, specs, shape):
    """Rank 0's P = 1 run of the steps the run on a ``(data, model)``
    mesh of ``shape`` took: the whole state drawn again from ``seed``,
    the same batches; for an MoE model each MoE call on the ranks' blocks
    as separate calls (the ep path's capacity, ``_blocked_moe``: rank r =
    (d, m) routes row d's sequence block m, the P = 1 call's r-th block
    of its (row, position) tokens) under the mesh run's expert choices
    (``_Routing``: call i's block r is rank r's call i). Returns each
    step's loss and grad norm and, for each rank, its smallest cosine of
    a matrix gradient block (``blocks[r]``: leaf index -> the rank's
    first-step gradient block) against the same block of P = 1's
    first-step gradient, with the leaf."""
    from repro_torch.train import init_state, make_train_step

    t = shape[0] * shape[1]
    n_moe = sum(n for sp, n in cfg.plan if sp.moe is not None)
    routing = _Routing()
    routing.chosen = [chosen[r][i].to(dev) for i in range(len(chosen[0]))
                      for r in range(t)]
    replay = routing.replay() if n_moe else contextlib.nullcontext()
    blocked = _blocked_moe(t) if n_moe else contextlib.nullcontext()
    state = init_state(cfg, seed, dev)
    step_fn = make_train_step(cfg, tcfg)
    losses, norms, grads = [], [], []
    with replay, blocked, _first_grads(grads):
        for batch in batches:
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    del state
    cosines = []
    for r in range(t):
        worst = (2.0, "")
        for i, g in blocks[r].items():
            want = _block_of(grads[i], specs[i], r, shape)
            worst = min(worst, (_cosine(g.to(want.device).float(),
                                        want.float()), names[i]))
        cosines.append(worst)
    return {"losses": losses, "grad_norms": norms, "cosines": cosines,
            "flips": sum(routing.flips)}


def tp_train(cfg, seed, dev, spec, counters=None):
    """A tp-train step on this rank of a group of TP_RANKS ranks (on the
    CPU too, at any config): ``cfg`` trained on
    ``make_host_mesh(model=spec.get("model", TP_RANKS))`` from ``seed``
    by ``make_train_step(cfg, tcfg, mesh)`` on the state of
    ``init_state(..., mesh=mesh)``: one warm-up step and TP_TRAIN_STEPS
    timed ones, each on a global batch of ``spec.get("batch", 1)`` x
    ``spec["seq"]`` tokens from ``make_batch`` at ``seed`` (each data
    rank takes its rows); the counters zeroed just before the timed
    steps and read just after. Every rank's first-step gradient blocks go
    to rank 0, which runs ``_tp_train_yardstick``. Returns (the record,
    the kernels' first calls in the timed steps)."""
    t_start = time.perf_counter()
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import group
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention, ssm
    from repro_torch.models.model import param_shapes
    from repro_torch.models.shardrules import (_items, bytes_per_device,
                                               held_specs)
    from repro_torch.train import (AdamWConfig, TrainConfig, init_state,
                                   make_train_step)
    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.step import batch_to, split_leaves

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for _, x in _items(tree))

    rank, world = dist.get_rank(), dist.get_world_size()
    t = spec.get("model", world)
    shape = (world // t, t)
    laps, t_last = {}, [t_start]

    def lap(name):
        sync()
        now = time.perf_counter()
        laps[name] = now - t_last[0]
        t_last[0] = now
    lap("imports")
    mesh = make_host_mesh(model=t)
    steps = 1 + TP_TRAIN_STEPS
    tcfg = TrainConfig(optim=AdamWConfig(peak_lr=spec["lr"], warmup_steps=0,
                                         total_steps=steps))
    rows = spec.get("batch", 1)
    dcfg = DataConfig(batch=rows, seq=spec["seq"], seed=seed)
    batches = [batch_to(make_batch(cfg, dcfg, i), dev) for i in range(steps)]
    lap("batches")
    shapes = param_shapes(cfg)
    want = bytes_per_device(shapes, mesh)
    specs = [s for _, s in _items(held_specs(shapes, mesh))]
    names = [p for p, _ in _items(shapes)]
    del shapes
    lap("inputs")
    state = init_state(cfg, seed, dev, mesh)
    lap("init")
    held = nbytes(state["params"])
    moments = nbytes(state["opt"]["m"]) + nbytes(state["opt"]["v"])
    split = split_leaves(cfg, mesh)
    step_fn = make_train_step(cfg, tcfg, mesh)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    routing, grads, losses, norms, step_ms = _Routing(), [], [], [], []
    with routing.record(), _first_grads(grads):
        state, m = step_fn(state, batches[0])        # the warm-up step
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        lap("warm-up")
        dist.barrier()
        if counters is not None:
            _zero(counters)
        group.collective_times(reset=True)
        cap = Capture(((ssm, "ssd_fused"), (attention, "flash_attention")),
                      key=_flash_key)
        try:
            for batch in batches[1:]:
                sync()
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                losses.append(float(m["loss"]))     # waits for the device
                step_ms.append((time.perf_counter() - t0) * 1e3)
                norms.append(float(m["grad_norm"]))
            sync()
            launches = {k: counters[k].launches if counters else 0
                        for k in ("flash_attention", "ssd_fused")}
            tc = {k: getattr(counters[k], "wgmma_launches", 0) if counters
                  else 0 for k in ("flash_attention", "ssd_fused")}
            insts = {f"{hd}x{hdv}": n for (hd, hdv), n in getattr(
                counters["flash_attention"], "instances", {}).items()
                     } if counters else {}
            coll = _by_kind(group.collective_times(reset=True))
        finally:
            cap.close()
    lap("timed")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    calls = {k: ([a.detach() if hasattr(a, "detach") else a for a in c[0]],
                 c[1]) for k, c in cap.calls.items()}
    with torch.no_grad():
        errs = _captured_errs(calls, f"{spec.get('tag', 'tp-train')} rank "
                              f"{rank}") if cuda else {}
    trees = (state["params"], state["opt"]["m"], state["opt"]["v"])
    whole = [x for tree in trees
             for x, cut in zip(tree_leaves(tree), split) if not cut]
    # the blocks cut over model alone: each data rank holds a copy
    model = [x for tree in trees
             for x, cut in zip(tree_leaves(tree), split)
             if cut == ("model",)]
    finite = all(np.isfinite(losses)) and all(
        bool(torch.isfinite(x).all()) for x in tree_leaves(state["params"]))
    digest = _digest(*whole)
    model_digest = _digest(*model)
    lap("checks")
    rec = {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "laps": laps, "peak_gib": peak, "collectives": coll,
           "launches": launches, "tensor_core": tc, "instances": insts,
           "errs": errs, "bytes": [held, want], "moment_bytes": moments,
           "digest": digest, "model_digest": model_digest,
           "finite": finite, "mesh": list(shape),
           "tokens": rows // shape[0] * spec["seq"],
           "shapes": {k: [list(a.shape) for a in c[0] if hasattr(a, "shape")]
                      for k, c in calls.items()}}
    del state, whole, model, step_fn
    # the split matrix gradient blocks to rank 0 (exact in cfg.dtype,
    # the working copy's), the whole ones stay: every rank's are equal
    mats = [i for i, (g, cut) in enumerate(zip(grads, split))
            if cut and g.dim() >= 2]
    flat = torch.cat([grads[i].to(cfg.dtype).flatten() for i in mats]
                     ).cpu()
    wire = flat.view(torch.uint8) if flat.element_size() == 2 else flat
    parts = [torch.empty_like(wire) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(wire, parts, dst=0)
    every = group.gather([c.cpu() for c in routing.chosen], "tp_choices")
    lap("gather")
    if rank == 0:
        blocks = []
        for r in range(world):
            got, lo = parts[r].view(flat.dtype), 0
            mine = {}
            for i in mats:
                n = grads[i].numel()
                mine[i] = got[lo:lo + n].view(grads[i].shape)
                lo += n
            blocks.append(mine)
        blocks[0].update({i: g for i, g in enumerate(grads)
                          if not split[i] and g.dim() >= 2})
        del parts
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        rec["yardstick"] = _tp_train_yardstick(
            cfg, seed, dev, tcfg, batches, every, blocks, names, specs,
            shape)
        lap("yardstick")
        rec["yardstick"]["seconds"] = laps["yardstick"]
    del grads, batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec, calls


def _mm_out_dtype_grad(dev):
    """Whether this PyTorch runs a backward through ``torch.mm`` with a
    float32 result of bfloat16 operands (``tp.matmul_f32`` carries its
    own backward either way)."""
    import torch
    a = torch.ones(8, 8, dtype=torch.bfloat16, device=dev,
                   requires_grad=True)
    try:
        torch.mm(a, a, out_dtype=torch.float32).sum().backward()
        return f"taken (grad {a.grad.dtype})"
    except RuntimeError as e:
        return f"refused: {e}"[:200]


def tp_rank(args) -> int:
    """One rank of the tp phase, in a process of its own (``chip_smoke.py
    --rank-role tp --collective-rank R``): every rank draws each model of
    TP_SPECS whole from --seed (its depth cut as TP_DEPTH_CUTS says),
    serves it through ``ServeEngine(...,
    mesh=make_host_mesh(model=TP_RANKS))`` on cuda:0 in a gloo group, and
    keeps the logits of that one timed ``generate``, the MoE layers'
    expert choices and dropped shares; rank 0 then runs the same function
    at P = 1 (``_tp_yardstick``). Writes its record (and rank 0 the
    kernels' per-rank calls) under the phase's directory."""
    import datetime
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import group
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention, model, ssm
    from repro_torch.models.shardrules import bytes_per_device, _items
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve import engine as engine_mod
    from repro_torch.telemetry import KIND_DECODE, KIND_PREFILL

    root = args.collective_dir
    torch.set_num_threads(2)             # four ranks share the host's cores
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.load("flashattn")            # built by the parent: loaded only
    _build.load("ssd")
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.collective_port}",
        rank=args.collective_rank, world_size=TP_RANKS,
        timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    rank = dist.get_rank()
    mesh = make_host_mesh(model=TP_RANKS)
    counters = _launch_counters()
    rec = {"rank": rank, "pid": os.getpid()}
    # whether gloo takes bfloat16 CUDA tensors as they are (the port sends
    # 16-bit floats as uint8 views whatever the answer)
    probe = [torch.empty(4, dtype=torch.bfloat16, device=dev)
             for _ in range(TP_RANKS)]
    try:
        dist.all_gather(probe, torch.full((4,), float(rank),
                                          dtype=torch.bfloat16, device=dev))
        rec["gloo_bf16"] = "taken"
    except RuntimeError as e:
        rec["gloo_bf16"] = f"refused: {e}"[:200]
    rec["mm_out_dtype_grad"] = _mm_out_dtype_grad(dev)
    for tag, spec in TP_SPECS.items():
        t_step = time.perf_counter()
        cfg = cut_depth(get_config(spec["arch"]),
                        TP_DEPTH_CUTS.get(spec["arch"]))
        n_new = spec["new"]
        params = model.init_params(cfg, seed=args.seed, device=dev)
        host = _serve_batch(cfg, args.seed, 1, spec["prompt"])
        batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        max_len = cfg.meta_tokens + spec["prompt"] + n_new
        scfg = ServeConfig(max_len=max_len, max_new_tokens=n_new,
                           cache_dtype=cfg.dtype)
        engine = ServeEngine(cfg, params, scfg, device=dev, mesh=mesh)
        want_bytes = bytes_per_device(params, mesh)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        held = sum(x.numel() * x.element_size()
                   for _, x in _items(engine.params))
        # warm-up at a short prompt (a prefill and one decode step): the
        # kernels' attributes, the groups
        with torch.inference_mode():
            head = {k: torch.as_tensor(v, device=dev)
                    for k, v in _head(host, 128).items()}
            lg, caches, index = model.prefill(cfg, engine.params, head,
                                              max_len, cfg.dtype, engine.ctx)
            model.decode_step(cfg, engine.params, lg.argmax(-1)[:, None],
                              caches, index, engine.ctx, max_len)
            del lg, caches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t_warm = time.perf_counter()
        n_steps = len(engine.telemetry.steps)
        cap = Capture(((ssm, "ssd_fused"), (attention, "flash_attention")),
                      key=_flash_key)
        tp_logits = []                   # the logits generate computes
        routing, drops = _Routing(), []
        kept_caches = []                 # the prefill's blocks, on the host

        def keep(fn):
            def wrapped(*a, **kw):
                res = fn(*a, **kw)
                tp_logits.append(res[0])
                if spec.get("caches") and len(res) == 3:
                    kept_caches.append([[{p: {k: v.cpu() for k, v in
                                              d.items()}
                                          for p, d in c.items()}
                                         for c in seg] for seg in res[1]])
                return res
            return wrapped
        engine_mod.prefill = keep(model.prefill)
        engine_mod.decode_step = keep(model.decode_step)
        try:
            dist.barrier()
            _zero(counters)
            group.collective_times(reset=True)
            t_gen = time.perf_counter()
            with routing.record(), _moe_dropped(drops), \
                    _slot_writes(writes := []):
                tokens = engine.generate(host)
            torch.cuda.synchronize()
            t_gen = time.perf_counter() - t_gen
            launches = {k: counters[k].launches
                        for k in ("flash_attention", "ssd_fused")}
            tc = {k: counters[k].wgmma_launches
                  for k in ("flash_attention", "ssd_fused")}
            insts = {f"{hd}x{hdv}": n for (hd, hdv), n in
                     counters["flash_attention"].instances.items()}
            coll = group.collective_times(reset=True)
        finally:
            engine_mod.prefill = model.prefill
            engine_mod.decode_step = model.decode_step
            cap.close()
        peak = torch.cuda.max_memory_allocated(dev)
        steps = engine.telemetry.steps[n_steps:]
        pre_ms = [(e.end_ns - e.start_ns) / 1e6 for e in steps
                  if e.kind == KIND_PREFILL]
        dec_ms = [(e.end_ns - e.start_ns) / 1e6 for e in steps
                  if e.kind == KIND_DECODE]
        n_moe = sum(n for sp, n in cfg.plan if sp.moe is not None)
        errs = _captured_errs(cap.calls, f"{tag} rank {rank}")
        by_kind = {}
        for name, sec in coll:
            n, total = by_kind.get(name, (0, 0.0))
            by_kind[name] = (n + 1, total + sec)
        rec[tag] = {
            "launches": launches, "tensor_core": tc, "instances": insts,
            "errs": errs, "bytes": [held, want_bytes], "prefill_ms": pre_ms,
            "decode_ms": dec_ms, "peak_gib": peak / 2**30,
            "collectives": by_kind, "tokens": tokens.tolist(),
            "dropped": _mean(drops[:n_moe]),
            "digest": _digest(*tp_logits),
            "finite": all(bool(torch.isfinite(x).all()) for x in tp_logits),
            "shapes": {k: [list(a.shape) for a in c[0] if hasattr(a, "shape")]
                       for k, c in cap.calls.items()},
            "slot_writes": writes}
        if kept_caches:
            torch.save(kept_caches[0], os.path.join(
                root, f"{tag}_caches_rank{rank}.pt"))
        del kept_caches
        # every rank's expert choices to rank 0, for its P = 1 yardstick
        chosen = [c.cpu() for c in routing.chosen]
        every = [None] * TP_RANKS if rank == 0 else None
        dist.gather_object(chosen, every, dst=0)
        del engine, routing, chosen
        gc.collect()
        torch.cuda.empty_cache()
        t_yard = time.perf_counter()
        if rank == 0:
            rec[tag].update(_tp_yardstick(
                cfg, args.seed, dev, batch, np.asarray(tokens), tp_logits,
                every, max_len, tp_caches=[os.path.join(
                    root, f"{tag}_caches_rank{r}.pt")
                    for r in range(TP_RANKS)] if spec.get("caches")
                else None))
            torch.save({k: ([a.cpu() if hasattr(a, "cpu") else a
                             for a in c[0]], c[1])
                        for k, c in cap.calls.items()},
                       os.path.join(root, f"{tag}_calls.pt"))
        del tp_logits, cap, every
        gc.collect()
        torch.cuda.empty_cache()
        t_end = time.perf_counter()
        rec[tag]["parts_s"] = {
            "draw and warm-up": t_warm - t_step, "generate": t_gen,
            "checks": t_yard - t_warm - t_gen,
            "yardstick (rank 0)": t_end - t_yard}
        rec[tag]["seconds"] = t_end - t_step
    cfg = get_config(DP_SPEC["arch"])
    host = _serve_batch(cfg, args.seed, DP_SPEC["batch"], DP_SPEC["prompt"])
    rec[DP_TAG], calls = dp_serve(cfg, args.seed, dev, host, DP_SPEC,
                                  counters)
    if rank == 0:
        torch.save({k: ([a.cpu() if hasattr(a, "cpu") else a
                         for a in c[0]], c[1]) for k, c in calls.items()},
                   os.path.join(root, f"{DP_TAG}_calls.pt"))
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    for tag, spec in TP_TRAIN_SPECS.items():
        cfg = cut_depth(get_config(spec["arch"]),
                        TP_TRAIN_DEPTH_CUTS[spec["arch"]])
        t0 = time.perf_counter()
        rec[tag], calls = tp_train(cfg, args.seed, dev, dict(spec, tag=tag),
                                   counters)
        rec[tag]["seconds"] = time.perf_counter() - t0
        if rank == 0:
            torch.save({k: ([a.cpu() if hasattr(a, "cpu") else a
                             for a in c[0]], c[1]) for k, c in calls.items()},
                       os.path.join(root, f"{tag}_calls.pt"))
        del calls
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def phase_tp(args, work, dev, card):
    """Tensor-parallel serving: TP_RANKS rank processes on cuda:0 in a
    gloo group serve each model of TP_SPECS through ``ServeEngine(...,
    mesh)``, each rank holding its shards and launching its kernel on its
    heads (the MoE on its experts). Gates: the TP prefill logits and the
    decode logits of the timed generate within the serving gates of rank
    0's P = 1 run of the same function (decode teacher-forced on the TP
    tokens; for an MoE model per-block capacity and the TP run's expert
    choices, ``_tp_yardstick``), every rank's logits bit-equal, each
    rank's launches one a layer (in the spec's instantiation where it
    names one), each kernel against its plain version on the rank's own
    inputs, each rank's parameter bytes equal to ``bytes_per_device``;
    for a spec with ``caches`` each decoded slot written by the rank whose
    block holds it and layer 0's cache blocks bit-equal to P = 1's
    slices. Returns (launches, errs, calls) by ``<kernel>/<tag>``, the
    calls on ``dev``."""
    import torch

    root = os.path.join(work, "tp")
    os.makedirs(root, exist_ok=True)
    seconds = _run_ranks(args, root, "tp", TP_RANKS, 460)
    recs = []
    for r in range(TP_RANKS):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    log(f"tp: gloo all_gather of bfloat16 CUDA tensors as they are: "
        f"{recs[0]['gloo_bf16']}; a backward through torch.mm(..., "
        f"out_dtype=torch.float32) of bfloat16 operands: "
        f"{recs[0]['mm_out_dtype_grad']}")
    launches, errs, calls = {}, {}, {}
    for tag, spec in TP_SPECS.items():
        name, want = spec["kernel"], spec["launches"]
        wants = {name: want, **spec.get("also", {})}
        for rec in recs:
            r, t = rec["rank"], rec[tag]
            kinds = {k: f"{n} calls {sec:.3f}s"
                     for k, (n, sec) in t["collectives"].items()}
            a2a = kinds.pop("tp_all_to_all", None)
            log(f"{tag} rank {r} (pid {rec['pid']}): prefill "
                f"{t['prefill_ms'][0]:.3f} ms, decode median "
                f"{sorted(t['decode_ms'])[len(t['decode_ms']) // 2]:.3f} "
                f"ms/token ({len(t['decode_ms'])} steps), peak "
                f"{t['peak_gib']:.3f} GiB; launches {t['launches']} (tensor"
                f" core {t['tensor_core']}; flash_attention by "
                f"instantiation {t['instances']}); collectives {kinds}; "
                f"parameter bytes {t['bytes'][0]} (bytes_per_device "
                f"{t['bytes'][1]}); kernel calls {t['shapes']}; |kernel - "
                f"plain| {t['errs']} [{card}]")
            if a2a is not None:
                log(f"{tag} rank {r}: tp_all_to_all {a2a} in the generate"
                    f" [{card}]")
            for kind in ("tp_softmax", "dp_softmax", "mesh_softmax"):
                if kind in kinds:
                    log(f"{tag} rank {r}: {kind} {kinds[kind]} in the "
                        f"generate ({spec['new'] - 1} decode steps) "
                        f"[{card}]")
            log(f"{tag} rank {r}: step {t['seconds']:.3f}s ("
                + ", ".join(f"{k} {v:.3f}s" for k, v in
                            t["parts_s"].items())
                + f") [{card}]")
            if spec.get("caches"):
                log(f"{tag} rank {r}: slots written in decode (position, "
                    f"window, slot of the whole cache, the rank's block "
                    f"[start, size], written here): "
                    + "; ".join(f"{w['index']} w{w['window']} slot "
                                f"{w['slot']} {w['block']} {w['wrote']}"
                                for w in t["slot_writes"]) + f" [{card}]")
                for w in t["slot_writes"]:
                    lo, size = w["block"]
                    if w["wrote"] != (lo <= w["slot"] < lo + size):
                        raise AssertionError(
                            f"{tag} rank {r}: position {w['index']}'s "
                            f"slot {w['slot']} written {w['wrote']} by the"
                            f" rank of block {w['block']}")
            for kname, n in wants.items():
                if t["launches"][kname] != n or \
                        t["tensor_core"][kname] != n:
                    raise AssertionError(
                        f"{tag} rank {r}: {kname} launched "
                        f"{t['launches'][kname]} times "
                        f"({t['tensor_core'][kname]} on the tensor "
                        f"cores), expected {n}")
            if "flash_instance" in spec:
                inst = "x".join(map(str, spec["flash_instance"]))
                if t["instances"] != {inst: want}:
                    raise AssertionError(f"{tag} rank {r}: flash_attention"
                                         f" ran in {t['instances']}, "
                                         f"expected {inst}")
            if t["bytes"][0] != t["bytes"][1]:
                raise AssertionError(f"{tag} rank {r} holds {t['bytes'][0]}"
                                     f" parameter bytes, bytes_per_device "
                                     f"says {t['bytes'][1]}")
            if not t["finite"]:
                raise AssertionError(f"{tag} rank {r}: non-finite logits")
            if t["digest"] != recs[0][tag]["digest"] or \
                    t["tokens"] != recs[0][tag]["tokens"] or \
                    t["dropped"] != recs[0][tag]["dropped"]:
                raise AssertionError(f"{tag}: rank {r}'s logits, tokens or "
                                     "dropped share differ from rank 0's")
        t0 = recs[0][tag]
        gaps = t0["gaps"]
        agree = sum(a == b for a, b in zip(t0["tokens"][0], t0["argmax_p1"]))
        log(f"{tag}: {TP_RANKS} ranks == P = 1: prefill logits |TP - P1| "
            f"max {gaps[0][0]:.6f}, mean {gaps[0][1]:.6f}; decode "
            f"(P = 1 teacher-forced on the TP tokens) max "
            f"{max(g[0] for g in gaps[1:]):.6f}, mean"
            f" {max(g[1] for g in gaps[1:]):.6f} (gates {LOGIT_MAX_TOL} / "
            f"{LOGIT_MEAN_TOL}); every rank's logits bit-equal; P = 1's "
            f"argmax is the TP token at {agree}/{spec['new']} steps "
            f"[{card}]")
        if "free_gap" in t0:
            log(f"{tag}: the MoE at P = 1 under the ep path's per-block "
                f"capacity and the TP run's expert choices; prefill dropped "
                f"share (mean over the MoE layers) TP {t0['dropped']:.6f}, "
                f"P = 1 {t0['dropped_p1']:.6f}, P = 1 free-running "
                f"(capacity over the whole call, its own choices) "
                f"{t0['dropped_free']:.6f}; free-running prefill logits "
                f"|TP - P1| max {t0['free_gap'][0]:.6f}, mean "
                f"{t0['free_gap'][1]:.6f}; tokens (of {spec['prompt']}) "
                f"whose own top-k at P = 1 differs from the TP choice, by "
                f"layer: {t0['flips_prefill']}; in decode "
                f"{t0['flips_decode']} [{card}]")
        if "cache_gap" in t0:
            log(f"{tag}: each rank's prefill cache blocks == P = 1's "
                f"slices under cache_specs ({t0['cache_leaves']} leaves a "
                f"rank): largest |TP - P1| by rank {t0['cache_gap']}; "
                f"layer 0's k and v bit-equal by rank "
                f"{t0['cache_layer0_equal']} [{card}]")
            if not all(t0["cache_layer0_equal"]):
                raise AssertionError(f"{tag}: a rank's layer 0 k or v "
                                     "differs from P = 1's slice")
        if any(m > LOGIT_MAX_TOL or a > LOGIT_MEAN_TOL for m, a in gaps):
            raise AssertionError(f"{tag}: TP and P = 1 logits disagree")
        saved = torch.load(os.path.join(root, f"{tag}_calls.pt"))
        for kname in wants:
            launches[f"{kname}/{tag}"] = t0["launches"][kname]
            errs[kname] = max(max(rec[tag]["errs"].get(kname, 0.0)
                                  for rec in recs), errs.get(kname, 0.0))
            # a window layer's call where the model has one
            key = next(k for k in sorted(saved, key=lambda k: not k.endswith(
                "/window")) if k.startswith(kname))
            c_args, c_kw = saved[key]
            calls[f"{kname}/{tag}"] = ([a.to(dev) if hasattr(a, "to")
                                        else a for a in c_args], c_kw)
    name = f"flash_attention/{DP_TAG}"
    launches[name], err = _check_dp(recs, card)
    errs["flash_attention"] = max(errs["flash_attention"], err)
    saved = torch.load(os.path.join(root, f"{DP_TAG}_calls.pt"))
    c_args, c_kw = saved[next(k for k in saved
                              if k.startswith("flash_attention"))]
    calls[name] = ([a.to(dev) if hasattr(a, "to") else a for a in c_args],
                   c_kw)
    for tag, spec in TP_TRAIN_SPECS.items():
        got, err = _check_tp_train(recs, tag, card)
        saved = torch.load(os.path.join(root, f"{tag}_calls.pt"))
        for kname in spec["kernels"]:
            name = f"{kname}/{tag}"
            launches[name] = got[kname]
            errs[kname] = max(errs[kname], err[kname])
            c_args, c_kw = saved[next(k for k in saved
                                      if k.startswith(kname))]
            calls[name] = ([a.to(dev) if hasattr(a, "to") else a
                            for a in c_args], c_kw)
    log(f"tp: {TP_RANKS} ranks on cuda:0 over gloo, {seconds:.3f}s "
        f"[{card}]")
    return launches, errs, calls


# the data axis's collectives a training step on a mesh with D > 1 runs:
# the FSDP gathers, their backward and the data-whole leaves' sum
DP_TRAIN_KINDS = ("dp_fsdp", "dp_fsdp_bwd", "dp_sum_bwd")


def _check_tp_train(recs, tag, card):
    """The gates of a tp-train step (see the docstring's tp entry) on
    every rank's record; returns, by kernel of the spec, its launches a
    rank in the timed steps and the largest |kernel - plain| of its
    calls."""
    import statistics
    spec = TP_TRAIN_SPECS[tag]
    layers = sum(TP_TRAIN_DEPTH_CUTS[spec["arch"]])
    want = {"flash_attention": 0, "ssd_fused": 0}
    for name in spec["kernels"]:
        want[name] = 2 * layers * TP_TRAIN_STEPS
    inst = "x".join(map(str, spec.get("flash_instance", ())))
    y = recs[0][tag]["yardstick"]
    d, t = recs[0][tag]["mesh"]

    def kinds(coll, dp, bwd=None):
        """The calls and seconds of the kinds on the data axis (``dp``)
        or not, of the backward (``bwd``) or not (None: either)."""
        return {k: f"{n} calls {sec:.3f}s" for k, (n, sec) in
                sorted(coll.items()) if k.startswith("dp_") == dp and
                bwd in (None, k.endswith("_bwd"))}
    for rec in recs:
        r, x = rec["rank"], rec[tag]
        med = statistics.median(x["step_ms"])
        coll = x["collectives"]
        log(f"{tag} rank {r} (data {r // t}, model {r % t} of ({d}, {t})):"
            f" step ms median {med:.3f} "
            f"({[round(v, 3) for v in x['step_ms']]}, {TP_TRAIN_STEPS} "
            f"timed steps after 1 warm-up), {x['tokens'] / med * 1e3:.0f} "
            f"tokens/s a rank at the median, peak {x['peak_gib']:.3f} GiB; "
            f"the step {x['seconds']:.2f}s in all, by part "
            f"{ {k: round(v, 2) for k, v in x['laps'].items()} }; launches "
            f"{x['launches']} (tensor core "
            f"{x['tensor_core']}; flash_attention by instantiation "
            f"{x['instances']}; expected {want}); parameter bytes "
            f"{x['bytes'][0]}, moment bytes {x['moment_bytes']} "
            f"(bytes_per_device {x['bytes'][1]}); kernel calls "
            f"{x['shapes']}; |kernel - plain| {x['errs']} [{card}]")
        log(f"{tag} rank {r}: collectives in the {TP_TRAIN_STEPS} timed "
            f"steps, forward and remat recompute "
            f"{kinds(coll, False, False)}; backward "
            f"{kinds(coll, False, True)} [{card}]")
        if d > 1:
            log(f"{tag} rank {r}: data-axis collectives in the "
                f"{TP_TRAIN_STEPS} timed steps {kinds(coll, True)} "
                f"[{card}]")
            missing = [k for k in DP_TRAIN_KINDS if k not in coll]
            if missing:
                raise AssertionError(f"{tag} rank {r}: no {missing} calls "
                                     "in the timed steps")
        if x["launches"] != want or x["tensor_core"] != want:
            raise AssertionError(f"{tag} rank {r}: launches {x['launches']}"
                                 f" (tensor core {x['tensor_core']}), "
                                 f"expected {want}")
        if inst and x["instances"] != {inst: want["flash_attention"]}:
            raise AssertionError(f"{tag} rank {r}: flash_attention ran in "
                                 f"{x['instances']}, expected {inst}")
        if x["bytes"][0] != x["bytes"][1] or \
                x["moment_bytes"] != 2 * x["bytes"][1]:
            raise AssertionError(f"{tag} rank {r} holds {x['bytes'][0]} "
                                 f"parameter and {x['moment_bytes']} moment "
                                 f"bytes, bytes_per_device says "
                                 f"{x['bytes'][1]}")
        if not x["finite"]:
            raise AssertionError(f"{tag} rank {r}: non-finite values")
        lead = recs[0][tag]
        for k in ("losses", "grad_norms", "digest"):
            if x[k] != lead[k]:
                raise AssertionError(f"{tag}: rank {r}'s {k} differ from "
                                     "rank 0's")
        if x["model_digest"] != recs[r % t][tag]["model_digest"]:
            raise AssertionError(f"{tag}: rank {r}'s model blocks differ "
                                 f"from data rank 0's copy (rank {r % t})")
    x = recs[0][tag]
    gaps = [abs(a - b) for a, b in zip(x["losses"], y["losses"])]
    log(f"{tag}: ({d}, {t}) mesh == P = 1: losses {x['losses']} (P = 1 "
        f"{y['losses']}), largest gap {max(gaps):.6f} (tolerance "
        f"{TRAIN_LOSS_TOL}); grad_norm {x['grad_norms']} (P = 1 "
        f"{y['grad_norms']}); smallest first-step gradient cosine by rank "
        f"{[[round(c, 6), leaf] for c, leaf in y['cosines']]} (tolerance "
        f"{TRAIN_COSINE}); every rank's losses, grad norms and whole "
        f"leaves bit-equal, each model block's copies on the data ranks "
        f"bit-equal; tokens whose own top-k at P = 1 differs from "
        f"the mesh run's choice {y['flips']}; P = 1 run "
        f"{y['seconds']:.2f}s [{card}]")
    if max(gaps) > TRAIN_LOSS_TOL or \
            min(c for c, _ in y["cosines"]) < TRAIN_COSINE:
        raise AssertionError(f"{tag}: the ({d}, {t}) mesh and P = 1 "
                             "disagree")
    return ({k: x["launches"][k] for k in spec["kernels"]},
            {k: max(rec[tag]["errs"].get(k, 0.0) for rec in recs)
             for k in spec["kernels"]})


def _check_dp(recs, card):
    """The gates of the tp phase's dp-granite step (see the docstring's
    tp entry) on every rank's record; returns the flash_attention
    launches a rank and the largest |kernel - plain| of its calls."""
    spec, t = DP_SPEC, DP_SPEC["model"]
    cfg_layers = spec["launches"]
    n_dec = spec["new"] - 1
    for rec in recs:
        r, x = rec["rank"], rec[DP_TAG]

        def kinds(coll):
            return {k: f"{n} calls {sec:.3f}s"
                    for k, (n, sec) in sorted(coll.items())}
        log(f"{DP_TAG} rank {r} (data {r // t}, model {r % t}; "
            f"{x['rows']} request(s)): prefill {x['prefill_ms'][0]:.3f} "
            f"ms, decode median {sorted(x['decode_ms'])[n_dec // 2]:.3f} "
            f"ms/token replicated ({len(x['decode_ms'])} steps), "
            f"{sorted(x['stationary_ms'])[spec['steps'] // 2]:.3f} ms/token"
            f" stationary ({len(x['stationary_ms'])} steps, "
            f"{[round(v, 3) for v in x['stationary_ms']]}), peak "
            f"{x['peak_gib']:.3f} GiB; launches {x['launches']} (tensor "
            f"core {x['tensor_core']}); branches {x['branches']} in the "
            f"generate, {x['stationary_branches']} in the stationary "
            f"steps; parameter bytes {x['bytes'][0]} and "
            f"{x['bytes_inference'][0]} in the inference layout "
            f"(bytes_per_device {x['bytes'][1]}); kernel calls "
            f"{x['shapes']}; |kernel - plain| {x['errs']} [{card}]")
        log(f"{DP_TAG} rank {r}: collectives in the generate "
            f"{kinds(x['collectives'])}; in the stationary steps "
            f"{kinds(x['stationary_collectives'])} [{card}]")
        gaps = x["stationary_gaps"]
        log(f"{DP_TAG} rank {r}: stationary == replicated decode (the "
            f"replicated steps' expert choices; tokens whose own top-k "
            f"differs {sum(x['stationary_flips'])}): logits max "
            f"{max(g[0] for g in gaps):.6f}, mean "
            f"{max(g[1] for g in gaps):.6f} (gates {LOGIT_MAX_TOL} / "
            f"{LOGIT_MEAN_TOL}) [{card}]")
        want = {"flash_attention": cfg_layers, "ssd_fused": 0}
        if x["launches"] != want or x["tensor_core"] != want:
            raise AssertionError(f"{DP_TAG} rank {r}: launches "
                                 f"{x['launches']} (tensor core "
                                 f"{x['tensor_core']}), expected {want}")
        if x["branches"] != {"ep": cfg_layers,
                             "replicated": cfg_layers * n_dec}:
            raise AssertionError(f"{DP_TAG} rank {r}: the generate took "
                                 f"{x['branches']}")
        if x["stationary_branches"] != {
                "stationary": cfg_layers * spec["steps"]}:
            raise AssertionError(f"{DP_TAG} rank {r}: the inference steps"
                                 f" took {x['stationary_branches']}")
        for key in ("bytes", "bytes_inference"):
            if x[key][0] != x[key][1]:
                raise AssertionError(f"{DP_TAG} rank {r} holds {x[key][0]}"
                                     f" parameter bytes ({key}), "
                                     f"bytes_per_device says {x[key][1]}")
        if x["rows"] != spec["batch"] // (TP_RANKS // t):
            raise AssertionError(f"{DP_TAG} rank {r} served {x['rows']} "
                                 "requests")
        if not x["finite"]:
            raise AssertionError(f"{DP_TAG} rank {r}: non-finite logits")
        lead = recs[r - r % t][DP_TAG]
        if x["digest"] != lead["digest"] or \
                x["tokens"] != recs[0][DP_TAG]["tokens"] or \
                x["dropped"] != recs[0][DP_TAG]["dropped"]:
            raise AssertionError(f"{DP_TAG}: rank {r}'s logits differ from "
                                 "its data row's, or its tokens or dropped"
                                 " share from rank 0's")
        if any(m > LOGIT_MAX_TOL or a > LOGIT_MEAN_TOL for m, a in gaps):
            raise AssertionError(f"{DP_TAG} rank {r}: stationary and "
                                 "replicated decode logits disagree")
    x = recs[0][DP_TAG]
    gaps = x["gaps"]
    rows = x["argmax_rows"]
    agree = sum(a == b for tr, pr in zip(x["tokens"], rows)
                for a, b in zip(tr, pr))
    log(f"{DP_TAG}: (2, 2) mesh == P = 1 ({spec['batch']} requests): "
        f"prefill logits |DP - P1| max {gaps[0][0]:.6f}, mean "
        f"{gaps[0][1]:.6f}; decode (P = 1 teacher-forced on the served "
        f"tokens) max {max(g[0] for g in gaps[1:]):.6f}, mean "
        f"{max(g[1] for g in gaps[1:]):.6f} (gates {LOGIT_MAX_TOL} / "
        f"{LOGIT_MEAN_TOL}); P = 1's argmax is the served token at "
        f"{agree}/{spec['batch'] * spec['new']}; prefill dropped share "
        f"{x['dropped']:.6f}, P = 1 {x['dropped_p1']:.6f}, free-running "
        f"{x['dropped_free']:.6f}; free-running prefill gap max "
        f"{x['free_gap'][0]:.6f}, mean {x['free_gap'][1]:.6f}; tokens whose"
        f" own top-k at P = 1 differs, prefill by layer "
        f"{x['flips_prefill']}, decode {x['flips_decode']} [{card}]")
    if any(m > LOGIT_MAX_TOL or a > LOGIT_MEAN_TOL for m, a in gaps):
        raise AssertionError(f"{DP_TAG}: the (2, 2) mesh and P = 1 logits "
                             "disagree")
    return x["launches"]["flash_attention"], max(
        rec[DP_TAG]["errs"].get("flash_attention", 0.0) for rec in recs)


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_row(call, plain, library, out, inputs, ops, own,
             ops_per_s=FP32_OPS_PER_S, calls=20):
    """One row of the times phase: a wrapper call by CUDA events (what a
    caller sees, "ms") beside its one-call yardstick, then the device time
    of a call under torch.profiler (after a warm-up cycle) split into the
    row's own kernels (``own``, launched from its library) and the
    wrapper's other device work; the whole read twice, in turn. The bound
    is the larger of ``inputs`` read and ``out`` written once over the
    memory rate and ``ops`` over ``ops_per_s``."""
    nbytes = _nbytes(*inputs) + _nbytes(*out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    ev, lib, dev_ms, other_ms, seen = [], [], [], [], []
    for _ in range(2):
        ev.append(_time_ms(call))
        lib.append(None if library is None else _time_ms(library))
        d, o, k, others = _split_profile(call, own, calls)
        dev_ms.append(d)
        other_ms.append(o)
        seen.append(k)
    # every call launches at least one own kernel, so a reading that saw
    # fewer than ``calls`` lost profiler events: read again, a few times
    while max(seen) < calls and len(seen) < 2 + PROFILE_RETRIES:
        d, o, k, others = _split_profile(call, own, calls)
        dev_ms.append(d)
        other_ms.append(o)
        seen.append(k)
    return {
        "ms": ev[0], "ms_again": ev[1], "device_ms": dev_ms[0],
        "device_ms_again": dev_ms[1], "other_device_ms": other_ms[0],
        "other_device_ms_again": other_ms[1], "own_launches": seen,
        "kernels_per_call": max(seen) / calls,
        # the first reading that saw every call's own kernel
        "device_ms_seen_all": next(
            (d for d, k in zip(dev_ms, seen) if k >= calls), None),
        "other_device_ops": others, "plain_ms": _time_ms(plain),
        "library_ms": lib[0], "library_ms_again": lib[1],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": ops, "bytes_ms": t_bytes,
        "ops_ms": t_ops}


def iqr_row(fn, plain, scores, occ, kw=None):
    """``time_row`` of the iqr wrapper ``fn`` on (scores, occ): the plain
    version ``plain``, ``torch.quantile`` of the occupied scores as the
    yardstick, n log2 n comparisons as its operations."""
    import math

    import torch
    kw = kw or {}
    res = fn(scores, occ, **kw)
    n = scores.shape[0]
    q = torch.tensor([0.25, 0.75], dtype=scores.dtype, device=scores.device)
    occ_scores = scores[occ]
    return time_row(lambda: fn(scores, occ, **kw),
                    lambda: plain(scores, occ, **kw),
                    lambda: torch.quantile(occ_scores, q),
                    [res["sorted"], res["flags"], res["stats"]],
                    [scores, occ], n * max(math.log2(n), 1.0),
                    kernel_names("iqr"))


IQR_120K = 120_000   # scores: 1 ms bins of the Table-1 trace


def phase_times(shapes):
    """Kernel, plain version and a one-call yardstick at the main path's
    shapes, with each kernel's bound."""
    import torch

    from repro_torch.core.reducers import N_BUCKETS
    from repro_torch.kernels.binstats.ops import _ts_bins
    from repro_torch.kernels.histbin.ops import bucketize

    counters = _launch_counters()
    rows = {}

    def record(name, *args, **kwargs):
        rows[name] = time_row(*args, **kwargs)

    seg, vals, n_seg, valid = shapes["binstats_flat"]
    m, n = vals.shape
    out = counters["binstats_flat"](seg, vals, n_seg, valid)
    idx = seg.long().clamp(0, n_seg - 1).expand(m, n)
    record("binstats_flat",
           lambda: counters["binstats_flat"](seg, vals, n_seg, valid),
           lambda: _plain("binstats_flat")(seg, vals, n_seg, valid),
           lambda: torch.zeros(m, n_seg, device=vals.device).scatter_reduce_(
               1, idx, vals, "sum"),
           [out], [seg, vals, valid], 6 * m * n, kernel_names("binstats"))

    seg, vals, n_seg, valid = shapes["histbin_flat"]
    out = counters["histbin_flat"](seg, vals, n_seg, valid)
    fused = ((torch.arange(m, device=vals.device)[:, None] * n_seg
              + seg.long()[None, :]) * N_BUCKETS + bucketize(vals)).reshape(-1)
    record("histbin_flat",
           lambda: counters["histbin_flat"](seg, vals, n_seg, valid),
           lambda: _plain("histbin_flat")(seg, vals, n_seg, valid),
           lambda: torch.bincount(fused, minlength=m * n_seg * N_BUCKETS),
           [out], [seg, vals, valid], 4 * m * n, kernel_names("histbin"))

    # iqr_fences: the main path's float64 call, the same scores in float32
    # (the TPU kernel's contract), the micro-bench's float32 call and a
    # float64 table of 120,000 scores (the large-table path); one kernel a
    # call up to 16,384 keys, at most 16 at 120,000
    (scores, occ), kw = shapes["iqr_fences"]
    (m_scores, m_occ), _ = shapes["iqr_fences/micro"]
    for row, (s_, o_), most in (
            ("iqr_fences", (scores, occ), 1),
            ("iqr_fences/f32", (scores.to(torch.float32), occ), 1),
            ("iqr_fences/micro", (m_scores, m_occ), 1),
            ("iqr_fences/120k", iqr_table(scores.device, IQR_120K, 120),
             16)):
        rows[row] = iqr_row(counters["iqr_fences"], _plain("iqr_fences"),
                            s_, o_, kw)
        per_call = rows[row]["kernels_per_call"]
        if not 1 <= per_call <= most:
            raise AssertionError(f"{row}: {per_call} kernels a call, "
                                 f"expected 1 to {most}")

    # the timestamp forms: binstats at the micro-bench's call (its path),
    # and both at the main path's rows binned by synthetic timestamps;
    # yardsticks as for the flat forms, over the same bins: scatter_reduce_
    # (sums only) and bincount over the fused (metric, bin, bucket) index
    for row, name, key in (("binstats", "binstats", "binstats"),
                           ("binstats/table1", "binstats", "ts"),
                           ("histbin", "histbin", "ts")):
        (ts, vals, valid), kw = shapes[key]
        out = counters[name](ts, vals, valid, **kw)
        v2 = vals.reshape(-1, vals.shape[-1])
        m, n_bins = v2.shape[0], kw["n_bins"]
        bins = _ts_bins(ts, kw["total_ns"], n_bins).long()
        if name == "binstats":
            idx = bins.expand(m, -1)
            library = (lambda idx=idx, v2=v2, m=m, n_bins=n_bins:
                       torch.zeros(m, n_bins, device=v2.device)
                       .scatter_reduce_(1, idx, v2, "sum"))
        else:
            fused = ((torch.arange(m, device=v2.device)[:, None] * n_bins
                      + bins[None, :]) * N_BUCKETS + bucketize(v2)
                     ).reshape(-1)
            library = (lambda fused=fused, size=m * n_bins * N_BUCKETS:
                       torch.bincount(fused, minlength=size))
        record(row, lambda n=name, a=(ts, vals, valid), k=kw:
               counters[n](*a, **k),
               lambda n=name, a=(ts, vals, valid), k=kw: _plain(n)(*a, **k),
               library, [out], [ts, vals, valid],
               (6 if name == "binstats" else 4) * vals.numel(),
               kernel_names(name))

    # rolling_stats: the micro-bench's call and one rank's stall series.
    # Bound: x read and (N, 2) written once (12 N bytes), or about 10
    # float32 operations per value; yardstick: the window sums of x and
    # x^2 as one grouped conv1d with a ones filter (full float32, TF32
    # off), which leaves out the division, the variance and the sqrt.
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for row in ("rolling_stats", "rolling_stats/stall"):
            x, window = shapes[row]
            out = counters["rolling_stats"](x, window=window)
            lib = _window_sums(x, window)
            want = _plain("rolling_stats")(x, window=window)
            n_eff = torch.arange(1, x.shape[0] + 1, device=x.device
                                 ).clamp_max(window)
            lib_err = float((lib()[0, 0] / n_eff - want[:, 0]).abs().max())
            log(f"times: {row}: conv1d yardstick's window mean vs plain, "
                f"largest |diff| {lib_err}")
            record(row, lambda x=x, w=window: counters["rolling_stats"](
                x, window=w),
                lambda x=x, w=window: _plain("rolling_stats")(x, window=w),
                lib, [out], [x], 10 * x.numel(), kernel_names("rolling"))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    _ssd_rows(rows, shapes, ("ssd_fused", "ssd_fused/hymba"))
    _flash_rows(rows, shapes, ("flash_attention/window",
                               "flash_attention/global") + tuple(
        f"flash_attention/{tag}" for tag in FAMILY_PHASES))
    rows["flash_attention"] = rows["flash_attention/window"]
    return rows


def phase_tp_times(shapes):
    """The tp phase's rows, timed after it as the times phase times the
    others: ssd_fused at rank 0's mamba2 calls (serving, training),
    flash_attention at rank 0's call of each TP_FLASH_ROWS step."""
    rows = {}
    _ssd_rows(rows, shapes, ("ssd_fused/tp-mamba2", "ssd_fused/tp-hymba",
                             "ssd_fused/tp-train-mamba2",
                             "ssd_fused/tp-train-hymba"))
    _flash_rows(rows, shapes, TP_FLASH_ROWS)
    return rows


def _ssd_rows(rows, shapes, names):
    """``time_row`` of ssd_fused at each path call in ``names``. Bound:
    its own inputs read and outputs written once, or 2q^2 N + 2q^2 P +
    4qNP FLOP per (head, chunk) on the bfloat16 tensor cores; no single
    PyTorch call computes the scan, so there is no yardstick."""
    fn = _launch_counters()["ssd_fused"]
    for row in names:
        c_args, c_kw = shapes[row]
        xs, B = c_args[0], c_args[3]
        b, s, H, P = xs.shape
        N, q = B.shape[3], c_kw["chunk"]
        flops = b * H * (-(-s // q)) * (2 * q * q * N + 2 * q * q * P
                                        + 4 * q * N * P)
        out = fn(*c_args, **c_kw)
        rows[row] = time_row(
            lambda a=c_args, k=c_kw: fn(*a, **k),
            lambda a=c_args, k=c_kw: _plain("ssd_fused")(*a, **k), None,
            list(out), list(c_args), flops, kernel_names("ssd"),
            BF16_OPS_PER_S)
        rows[row]["fp32_floor_ms"] = flops / FP32_OPS_PER_S * 1e3


def _flash_rows(rows, shapes, names):
    """``time_row`` of flash_attention at each path call in ``names``.
    Bound: q, k, v read and o written once, or 2 (hd + hdv) FLOP per
    visible (query, key) pair on the tensor cores of the inputs' type;
    yardstick: one SDPA call with grouped KV heads (an explicit boolean
    mask for the window), or none where SDPA refuses the inputs (its
    error is logged)."""
    import torch
    fn = _launch_counters()["flash_attention"]
    for row in names:
        (q, k, v), c_kw = shapes[row]
        b, s, H, hd = q.shape
        causal, window = c_kw.get("causal", True), c_kw.get("window", 0)
        flops = b * H * _visible_pairs(s, causal, window) * 2 * (
            hd + v.shape[3])
        out = fn(q, k, v, **c_kw)
        lib = _sdpa(q, k, v, causal, window, c_kw.get("scale"))
        plain_out = _plain("flash_attention")(q, k, v, **c_kw)
        try:
            lib_err = float((lib().transpose(1, 2).float()
                             - plain_out.float()).abs().max())
        except RuntimeError as e:
            lib, lib_err = None, f"SDPA refused the inputs: {e}"
        del plain_out
        log(f"times: {row}: SDPA yardstick vs plain, largest |diff| "
            f"{lib_err}")
        rows[row] = time_row(
            lambda q=q, k=k, v=v, c=c_kw: fn(q, k, v, **c),
            lambda q=q, k=k, v=v, c=c_kw: _plain("flash_attention")(
                q, k, v, **c), lib,
            [out], [q, k, v], flops, kernel_names("flashattn"),
            BF16_OPS_PER_S if q.dtype == torch.bfloat16
            else FP32_OPS_PER_S)
        rows[row]["fp32_floor_ms"] = flops / FP32_OPS_PER_S * 1e3


def phase_train_times(shapes):
    """The training paths' rows, timed after the training phases:
    ssd_fused at mamba2's and hymba's first-layer
    training calls, flash_attention at hymba's first window call and at
    each other family's first-layer call, iqr_fences at the monitor's
    largest fence table."""
    rows = {}
    _ssd_rows(rows, shapes, ("ssd_fused/train", "ssd_fused/train-hymba"))
    _flash_rows(rows, shapes, TRAIN_FLASH_ROWS)
    (scores, occ), kw = shapes["iqr_fences/monitor"]
    rows["iqr_fences/monitor"] = iqr_row(
        _launch_counters()["iqr_fences"], _plain("iqr_fences"), scores, occ,
        kw)
    return rows


def _window_sums(x, window):
    """One torch.nn.functional.conv1d call giving the trailing-window sums
    of x and x^2 (a timing yardstick only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    xx = F.pad(torch.stack([x, x * x])[None], (window - 1, 0))
    ones = torch.ones(2, 1, window, device=x.device)
    return lambda: F.conv1d(xx, ones, groups=2)


def _visible_pairs(s, causal, window):
    """(query, key) pairs the masks leave visible in one (batch, head)."""
    import numpy as np
    i = np.arange(s)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _sdpa(q, k, v, causal, window, scale=None):
    """One torch.nn.functional.scaled_dot_product_attention call on the
    same inputs (a timing yardstick only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(q.shape[1], device=q.device)[None, :]
    mask = (i - j < window) & ((i >= j) if causal else True)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)


SOURCES = {
    "binstats_flat": ("src/repro_torch/csrc/binstats.cu",
                      "src/repro/kernels/binstats/kernel.py:58"),
    "binstats": ("src/repro_torch/csrc/binstats.cu",
                 "src/repro/kernels/binstats/kernel.py:58"),
    "histbin_flat": ("src/repro_torch/csrc/histbin.cu",
                     "src/repro/kernels/histbin/kernel.py:50"),
    "histbin": ("src/repro_torch/csrc/histbin.cu",
                "src/repro/kernels/histbin/kernel.py:50"),
    "iqr_fences": ("src/repro_torch/csrc/iqr.cu",
                   "src/repro/kernels/iqr/kernel.py:72"),
    "ssd_fused": ("src/repro_torch/csrc/ssd.cu",
                  "src/repro/kernels/ssd/kernel.py:39"),
    "flash_attention": ("src/repro_torch/csrc/flashattn.cu",
                        "src/repro/kernels/flashattn/kernel.py:30"),
    "rolling_stats": ("src/repro_torch/csrc/rolling.cu",
                      "src/repro/kernels/rolling/kernel.py:25"),
}
# the kernels timed at a second call, reported beside the first
ALSO = {"binstats": ("binstats/table1",),
        "iqr_fences": ("iqr_fences/f32", "iqr_fences/micro",
                       "iqr_fences/120k", "iqr_fences/monitor"),
        "ssd_fused": ("ssd_fused/hymba", "ssd_fused/train",
                      "ssd_fused/train-hymba", "ssd_fused/tp-mamba2",
                      "ssd_fused/tp-hymba", "ssd_fused/tp-train-mamba2",
                      "ssd_fused/tp-train-hymba"),
        "flash_attention": ("flash_attention/global",) + TRAIN_FLASH_ROWS
        + tuple(f"flash_attention/{tag}" for tag in FAMILY_PHASES)
        + TP_FLASH_ROWS,
        "rolling_stats": ("rolling_stats/stall",)}


def _free(dev):
    """Return a finished phase's blocks to the card before the next model
    is drawn."""
    import gc

    import torch
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    log(f"free: {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB still "
        "allocated")


def _laps(t_start):
    """A function that logs the seconds since its previous call (the
    first call: since ``t_start``) under a phase's name."""
    last = [t_start]

    def lap(name):
        now = time.perf_counter()
        log(f"phase {name}: {now - last[0]:.1f}s ({now - t_start:.1f}s "
            "in all)")
        last[0] = now
    return lap


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--duration", type=float, default=120.0)
    # one rank of the collective or the tp phase (started by that phase)
    for flag, kind in (("--collective-rank", int), ("--collective-port", int),
                       ("--collective-dir", str), ("--rank-role", str)):
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.collective_rank is not None:
        return (tp_rank if args.rank_role == "tp" else collective_rank)(args)
    from repro_torch.kernels import _build

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    card = phase_card()
    log(card)
    t0 = time.perf_counter()
    ptxas = _ptxas_report(_build)
    built = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    _build.operators()
    log(f"build: {time.perf_counter() - t0:.2f}s "
        f"(nvcc seconds per library: {built})")
    sass = {lib: _sass_counts(_build.lib_path(lib), _build)
            for lib in ("flashattn", "ssd")}
    regs = ptxas()
    log(f"build: SASS instructions {sass}; (registers, spill bytes) {regs}")
    for lib, counts in sass.items():
        if not all(counts.values()):
            raise AssertionError(f"{lib}'s SASS lacks {counts}: its kernel "
                                 "does not run on wgmma with TMA loads")
    wgmma = {k: v for k, v in regs.items() if k.startswith(TENSOR_CORE)}
    if len(wgmma) != 9 or any(sp for _, sp in wgmma.values()):
        raise AssertionError(f"a tensor-core kernel spills: {wgmma}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lap = _laps(t_start)
    lap("build")
    edge = phase_kernels(dev)
    log(f"kernels at edge shapes, largest |kernel - plain|: {edge}")
    lap("kernels")
    m_launches, m_errs, m_shapes = phase_micro(dev)
    lap("micro")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, errs, shapes, stalls, paths, main_res = phase_main(
            args, work)
        log(f"kernels on the main path's inputs, largest |kernel - plain|:"
            f" {errs}")
        lap("main")
        s_launches, s_err, shapes["rolling_stats/stall"] = phase_stall(
            dev, stalls)
        del stalls
        lap("stall")
        delta_copy = phase_delta(args, work)
        lap("delta")
        d_errs = phase_diff(args, work, card)
        for name, e in d_errs.items():
            errs[name] = max(errs[name], e)
        lap("diff")
        phase_service(args, work, card)
        lap("service")
        phase_stream(args, work, card)
        lap("stream")
        phase_ranks(args, work, paths, card)
        lap("ranks")
        phase_collective(args, work, main_res, delta_copy, card)
        del main_res
        lap("collective")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # binstats' timestamp form and rolling_stats run on the micro path; the
    # main path's timestamp-form inputs stay as a second timing row
    shapes.update(m_shapes)
    launches["binstats/table1"] = launches["binstats"]
    # the float32 12,000 and the 120,000 tables are on no driven path: no
    # count is taken for them, and the line says null
    launches["iqr_fences/f32"] = None
    launches["iqr_fences/micro"] = m_launches["iqr_fences"]
    launches["iqr_fences/120k"] = None
    launches["binstats"] = m_launches["binstats"]
    launches["rolling_stats"] = m_launches["rolling_stats"]
    launches["rolling_stats/stall"] = s_launches
    for name in ("binstats", "iqr_fences"):
        errs[name] = max(errs[name], m_errs[name])
    errs["rolling_stats"] = max(m_errs["rolling_stats"], s_err)
    serve_launches, serve_errs, calls = phase_serve(args, dev, "serve")
    launches["ssd_fused"] = serve_launches["ssd_fused"]
    errs["ssd_fused"] = serve_errs["ssd_fused"]
    shapes["ssd_fused"] = calls["ssd_fused"]
    del calls
    _free(dev)
    lap("serve")
    h_launches, h_errs, h_calls = phase_serve(args, dev, "serve-hymba")
    launches["flash_attention"] = h_launches["flash_attention"]
    launches["ssd_fused/hymba"] = h_launches["ssd_fused"]
    errs["flash_attention"] = h_errs["flash_attention"]
    errs["ssd_fused"] = max(errs["ssd_fused"], h_errs["ssd_fused"])
    shapes["ssd_fused/hymba"] = h_calls["ssd_fused"]
    for key in ("flash_attention/window", "flash_attention/global"):
        shapes[key] = h_calls[key]
    del h_calls
    _free(dev)
    lap("serve-hymba")
    # the families without an SSM layer: flash_attention's calls only,
    # one model on the card at a time
    for tag in FAMILY_PHASES:
        f_launches, f_errs, f_calls = (
            phase_encode(args, dev, tag) if tag == "encode-hubert"
            else phase_serve(args, dev, tag))
        (key, call), = f_calls.items()
        shapes[f"flash_attention/{tag}"] = call
        launches[f"flash_attention/{tag}"] = f_launches["flash_attention"]
        errs["flash_attention"] = max(errs["flash_attention"],
                                      f_errs["flash_attention"])
        del f_calls, call
        _free(dev)
        lap(tag)
    # the times phase comes before the tp phase: in the wake of the tp
    # phase's training steps the profiler lost the device events of the
    # short iqr_fences calls (F31a: 16 of 20 at best in 6 readings); the
    # tp phase's rows are timed after it (phase_tp_times)
    times = phase_times(shapes)
    _free(dev)          # the tp phase's ranks draw up to ~39 GB at once
    lap("times")
    tp_work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        tp_launches, tp_errs, tp_calls = phase_tp(args, tp_work, dev, card)
    finally:
        shutil.rmtree(tp_work, ignore_errors=True)
    launches.update(tp_launches)
    shapes.update(tp_calls)
    # a rank's input shapes, listed beside the tp rows of the kernels line
    tp_shapes = {k: [list(a.shape) for a in c_args if hasattr(a, "shape")]
                 for k, (c_args, _) in tp_calls.items()}
    for name, e in tp_errs.items():
        errs[name] = max(errs[name], e)
    del tp_calls
    _free(dev)
    lap("tp")
    times.update(phase_tp_times(shapes))
    lap("tp times")
    phase_host_trace(shapes)
    lap("host trace")
    # the training phases come after the times phase: in their wake the
    # profiler lost the device events of short calls
    tables = []
    for tag in TRAIN_SPECS:
        t_launches, t_errs, t_calls, table = phase_train(args, dev, card,
                                                         tag)
        if "ssd_fused" in t_calls:
            shapes[f"ssd_fused/{tag}"] = t_calls["ssd_fused"]
            launches[f"ssd_fused/{tag}"] = t_launches["ssd_fused"]
        # the first window layer's call (hymba), else the first layer's
        key = next((k for k in ("flash_attention/window",
                                "flash_attention/global") if k in t_calls),
                   None)
        if key is not None:
            shapes[f"flash_attention/{tag}"] = t_calls[key]
            launches[f"flash_attention/{tag}"] = \
                t_launches["flash_attention"]
        launches["iqr_fences/monitor"] = launches.get(
            "iqr_fences/monitor", 0) + t_launches["iqr_fences"]
        tables.append(table)
        for name, e in t_errs.items():
            errs[name] = max(errs[name], e)
        del t_calls
        _free(dev)
        lap(tag)
    shapes["iqr_fences/monitor"] = max(tables,
                                       key=lambda c: c[0][0].shape[0])
    del tables
    times.update(phase_train_times(shapes))
    lap("train times")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, (src, tpu) in SOURCES.items():
        t = times[name]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": tpu, "launches": launches[name],
               "max_abs_err": max(errs[name], edge[name]),
               **{k: t[k] for k in keys}}
        if name in ALSO:
            row["also"] = {also: {
                "launches": launches.get(also, launches[name]),
                **{k: times[also][k] for k in keys},
                **({"shapes": tp_shapes[also]} if also in tp_shapes else {})}
                for also in ALSO[name]}
        kernels.append(row)
    for name, t in times.items():
        if name == "flash_attention":
            continue                   # the same row as its window call
        floor = (f", fp32 CUDA-core floor {t['fp32_floor_ms']:.4f}"
                 if "fp32_floor_ms" in t else "")
        n = launches.get(name, launches[name.split('/')[0]])
        path = ("on no driven path" if n is None else
                f"{n} launch(es) of {name.split('/')[0]} on its path")
        log(f"time {name}: {t['ms']:.4f} ms, again {t['ms_again']:.4f} "
            f"(library {t['library_ms']}, again {t['library_ms_again']}; "
            f"device per call under the profiler: own kernels "
            f"{t['device_ms']:.4f}, again {t['device_ms_again']:.4f}, "
            f"other device work {t['other_device_ms']:.4f}, again "
            f"{t['other_device_ms_again']:.4f}, own launches seen "
            f"{t['own_launches']} in 20 calls (own kernels in the first "
            f"reading that saw all: {t['device_ms_seen_all']}), other "
            f"device ops "
            f"{t['other_device_ops']}, own kernels a call "
            f"{t['kernels_per_call']}; plain {t['plain_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} by "
            f"{t['bound_by']}: {t['bytes']} bytes {t['bytes_ms']:.4f}, "
            f"{t['ops']:.4g} ops {t['ops_ms']:.4f}{floor}), {path} "
            f"[{card}]")
    phase_reap()
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
