#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deequ_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py [--seed S]

Phases, each of which fails the run when it fails:

1. the card's name and power limit; build every kernel from
   ``deequ_tpu_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and print ptxas's register and shared-memory report;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it (the features of the first 1M-row batch of each),
   with CUDA-event times of the device work of the kernel, of the plain
   version and, where one exists, of the single PyTorch call that computes
   the same function, and the host time of each call apart. For the
   verification path: K1-K3. For the profile path: K1 with its class-count
   slots, K2, K3, and K4 and K5 on every numeric column; K4 again on a batch
   of signed zeros, NaN and values beyond the float32 range, and K5's merge
   of two sketches; K4 on a constant column of 1M rows, timed, and on six
   kinds of column (edges, a constant, one binade, signed zeros only, all
   NaN, all masked) at 0, 1, k - 1, k, k + 1, 2^20 and 2^22 rows; K5's four
   entries on levels of one, two and 70 sorted runs, an unsorted level,
   one key and interleaved signed zeros, brought to k, k + 1 and 4k items,
   at k = 2048 and at k = 8192 (device scratch). For the grouping path: K6 on the first batch of the
   bench grouping workload, on lineitem's two-column primary key and on an
   edge batch; K7 compacting that batch's keys into a full 2^22-slot
   table, merging two full tables, compacting the edge batch's keys, and
   on ``FREQ_EDGE_CASES`` (keys that differ in their lowest byte, on both
   sides of 2^63, a buffer half sentinels, an empty table, out_size below
   n_unique, runs longer than a tile, two overlapping tables).
   For the incremental path (timed inside phase 6, at its shapes): K8 at
   N = 2 on config 4's partition states and at N = 32 on states of every
   kind (a month of day partitions), bit for bit, beside ``torch.amax``
   over the stacked HLL registers, and at N = 1 and 64; K1 with one co-moment slot over two
   1M-row float64 columns. For the host tier: K8's carry entry on config
   2's battery at the chunk shape (the carry and the host partials of 32
   batches of 2^18 rows), beside ``torch.amax`` plus ``torch.sum`` of the
   stacked partials; K5's ingest entry on the chunk phase 7 (c) folds
   (the host samples of config 3's numeric columns over its ten 2^20-row
   batches), beside ``torch.sort`` of one 4,096-item level, on a full
   chunk of 32 samples of 2^18-row batches and on an edge chunk (m = 0,
   m = 2k, h = 0, +-inf), all bit for bit; and the host tier's rank
   limit against faulty versions of (c)'s chunk;
3. the verification path: one ``VerificationSuite`` over a 10M-row dataset
   (BASELINE config 2's synthetic numeric/categorical table: four nullable
   float64 columns with NaN, an int64 id, dictionary columns of ~1,000 and
   ~50,000 categories) with about twenty checks covering its analyzers, on
   ``device="cuda"``; its metrics are held against the same run on
   ``device="cpu"`` and against a numpy oracle; its trace is one
   ``verification_run`` -> ``analysis_run`` -> one device-tier
   ``engine_pass`` -> phase spans, each timed phase's spans summing to
   ``phase_seconds`` within 1e-6 relative, no orphan, a Chrome artifact
   summarised by ``tools/torch_trace_summarize.py`` (a ``[trace]`` line);
   then the same run untraced (``DEEQU_TPU_TRACE=0``) and traced again,
   the three runs' seconds on a ``[trace cost]`` line;
4. the profile path: ``ColumnProfilerRunner`` over a 10M-row TPC-H
   lineitem-shaped table (BASELINE config 3's 16 columns, cut from 100M to
   10M rows) on ``device="cuda"``, held against a numpy oracle (exact
   counts, histograms, type counts, min and max; moments within 1e-9; KLL
   percentiles within twice the sketch's relative error in rank), and the
   same profile of the table's first ``PROFILE_CPU_ROWS`` rows on the card
   against ``device="cpu"``;
5. the grouping path: Uniqueness, CountDistinct and Entropy over the
   JAX bench's grouping workload (25M int64 keys, 3,571,428 distinct,
   seed 1) with a resident frequency table (a), a non-resident one (b) and
   one that overflows into the host group-by (c), held against (a) on
   ``device="cpu"`` and a numpy oracle; lineitem's primary key and key
   checks through ``VerificationSuite`` (d), against the CPU run and
   pandas value counts; BasicExample (e), against its CPU run;
6. the incremental path, BASELINE config 4: two day partitions of 50M rows
   of the JAX bench's scan table (``build_scan_data``, seed 42), batches
   of 1M, the bench's battery. (a) each partition with ``save_states_with``
   (an in-memory provider per partition) and an in-memory metrics
   repository keyed by day; (b) ``run_on_aggregated_states`` over both
   providers, timed, Size = 100M; (c) anomaly checks on Size and Mean over
   the day history: a steady day passes, a quarter-size day does not; (d)
   the states through ``FileSystemStateProvider`` files, merged again: (b)'s
   metrics bit for bit; (e) a battery of every other persistable state type
   (Correlation, StandardDeviation, Minimum, Maximum and Mean with NaN,
   DataType, a Histogram of a dictionary column, Uniqueness, a second KLL)
   over the same partitions, merged and held against one full-table run.
   (b) and (e) are held against numpy over the whole table, and the phase
   at 2 x 5M rows against the same on ``device="cpu"``. (f) the same two
   days through ``VerificationSuite.on_partitions`` and a
   ``PartitionStateStore`` in a temporary directory, with version tokens
   (no partition is hashed): cold (both days scanned, (b)'s metrics bit for
   bit), warm (no payload read, the cold metrics bit for bit), growth by a
   1M-row third day (1M rows scanned, two partitions from the rollup,
   numpy over the three days), day2's token changed (day2 alone
   re-scanned, the growth metrics bit for bit) and day1 dropped and
   deleted (numpy over day2 and day3); each step prints its seconds, rows
   scanned and launches, and the sequence runs again at 2 x 5M + 100k rows
   on the CPU and the card, every step equal; (g) ``profile_partitioned``
   and ``suggest_partitioned`` twice each over two 1M-row days, the second
   call reading no payload and equal to the first, against the same calls
   on ``device="cpu"``;
7. the host ingest tier (``placement="host"``), each run where its data
   lives: (a) after phase 3, its table and checks plus an ApproxQuantile,
   in batches of 2^18 rows, against phase 3's metrics, the same run on
   ``device="cpu"`` bit for bit and the oracle, then again in phase 3's
   batches of 2^20 rows; (b) inside phase 6, the two day partitions with
   ``save_states_with``, their states bit for bit against the same runs on
   ``device="cpu"``, refreshed alone and each merged with phase 6's
   device-tier state of the other day, against the oracle; (c) after
   phase 5, the profile bit for bit against the same run on
   ``device="cpu"``, its sketches against phase 2's ingest of the same
   chunk, and against phase 4's oracle. Every run launches K8's carry
   entry and K5's ingest entry and prints how its pattern matches ran
   (PCRE2 or Python's ``re``). Sketches filled on the host tier hold a
   looser rank limit (``HOST_KLL_RANK_LIMIT``), which phase 2 shows a
   biased sample exceeds;
8. the streaming verification service (the reference's streaming knee,
   ``tools/streaming_knee.py``): (a) K1's and K2's stacked entries at a
   coalesced group's shape (16 sessions x 4,096 rows, and x 65,536),
   against their stacked plain versions and 16 one-session launches bit
   for bit, with times and bounds; (b) 1,000 sessions x 2 micro-batches x
   4,096 rows through ``VerificationService(workers=8,
   max_queue_depth=256)`` with every fold coalesced on the device, (c) the
   first 250 of them with serial folds, every session's metrics equal to
   (b)'s bit for bit; (d) 100 sessions x 2 x 65,536 rows, coalesced and serial, held
   likewise; (e) 16 of (b)'s sessions on ``device="cpu"`` and against
   numpy; (f) 16 sessions of (b)'s shape on a service with a partition
   store, flushed as partitions when they close and verified through
   ``svc.verify_partitioned`` with no payload read, equal to the merge of
   the sessions' own states bit for bit. Each run fails on a shed or a
   failed fold;
9. more than one device, after phase 7 (a) over its table and checks
   (with the ApproxQuantile): (a) the mesh's entries against their plain
   versions bit for bit with times and bounds: K8's butterfly over the
   host partials of 2^20-row batches as 8 shards x 1, 4 x 2 and 3 x 1
   (the gather route), on states of every kind at ``BUTTERFLY_SIZES``
   (1-64 shards x 1 and 3), K8's stacked-carry entry at 8 shards x 4 partials
   (equal to 8 carry launches), K5's stacked merge of 8 pairs (equal to 8
   one-pair merges); (b) the host tier over ``make_mesh(8,
   device="cuda")``, against 7 (a)'s unsharded run in the same batches,
   the oracle, and the same mesh on the CPU at 1M rows bit for bit; (c)
   the device tier over the mesh, against phase 3's metrics, the oracle
   and its CPU run; (d) a mesh of 3 at 1M rows against the unsharded host
   tier and its CPU run; (e) a shard lost at the second chunk fold
   (``FaultSpec("sharded_fold", "mesh_loss", at=2, shard=5)``, 2M rows in
   2^15-row batches): 1 loss, 1 re-shard 8->4, 7 salvaged states, the
   fault-free metrics; (f) 4 processes on the card joined over gloo and a
   ``FileStore``, each folding a quarter of (b)'s partials and merging
   with ``parallel.dcn.merge_host_states``, every rank equal to one
   process's mesh of 4 bit for bit; then an NCCL group of as many ranks
   as cards are visible (1 on one card);
10. constraint suggestion, BASELINE config 5 (the JAX bench's
   ``run_suggestion_stage``), last: the bench's wide table
   (``build_wide_data``: 30 numeric, 10 string and 10 categorical columns,
   seed 7) cut from 1B rows to 10M in batches of 2^20;
   ``ConstraintSuggestionRunner`` with the default rules and a quarter of
   the rows held out (seed 0), on ``device="cuda"``, with K1's and K2's
   launches a batch (50 columns take two launches of each a batch of the
   first profile pass: over 64 slots, over 32 HLL columns); a numpy oracle
   holds the training split's row count, completeness, minima and
   category counts and every status on the test split; (d, f) the table's
   first ``WIDE_CPU_ROWS`` rows with ``UniqueIfApproximatelyUniqueRule``
   added (its ``is_unique`` constraints launch K6) on the card twice (cold
   and warm, equal), the suggestions and their statuses equal to the same
   run on ``device="cpu"`` character for character (the default rules'
   suggestions among them) and held to the oracle (the warm run left the
   10M rows, and the default rules' own 1M-row comparison merged into this
   one, for the script's time budget). Phase 2 holds K1 (every bundle)
   and K2's battery entry at the first batch of the training split's first
   profile pass. ``python3 -c "import torch, chip_smoke, deequ_tpu_torch
   as dq; chip_smoke.suggestion_path(torch, dq)"`` runs this phase alone
   (the kernels build at first use), printing no result lines;
11. resumable ingest, each part where its data lives, each with an
   ``IngestCheckpointer`` over a ``FileSystemStateProvider`` in a temporary
   directory and an injected interrupt: (a) after phase 3, its run with a
   checkpoint every 4 batches, interrupted before the 7th, resumed at
   batch 4 (6 batches folded), phase 3's metrics bit for bit; (b) inside
   7 (a), its run with a checkpoint every 8 batches, interrupted at batch
   38's host partial, resumed at the chunk boundary 32, 7 (a)'s metrics bit
   for bit; (c) after phase 9, the host tier over ``make_mesh(8,
   device="cuda")`` on 1M rows in 2^14-row batches, interrupted at the
   second chunk fold, its checkpoint resumed on ``make_mesh(4)`` and on
   the plain host tier, each equal to the uninterrupted mesh run (moments
   within 1e-12, the quantile within the host rank limit);
12. the tenant plane, last, at the reference's soak sizes, each part with
   its seconds and its launch gate: (a) ``tools/catalog_soak.py
   --registered 10000 --active 500``: 10,000 tenants register the soak's
   document, 500 go hot on ``VerificationService(workers=8,
   max_queue_depth=256, catalog=root)`` with an ApproxQuantile on ``v``
   and an ApproxCountDistinct on ``id`` installed on each session, 3 x
   2,048-row frames each, every fold coalesced on the card (K1's and K2's
   stacked entries, K4, K5, K8); the mid-soak edit and the corrupt-edit
   drills; 16 hot tenants against the same tenants on ``device="cpu"``
   and numpy; (b) the soak's drill 4 (24 x 65,536 rows gated and ungated,
   bit for bit, both warm, alternating over 4 rounds: the median
   ``gated_throughput_fraction``), 512 MB of Arrow IPC frames
   of 65,536 rows through ``ingest.fold_stream`` (MB/s, rows/s) against
   the same frames through ``session.ingest``, and ``IngestEndpoint`` on
   ``start_exporter(host="127.0.0.1", port=0)``: 200, 400 for a bad
   checksum with nothing folded, 404, 409; (c)
   ``tools/anomaly_fleet_bench.py --series 10000`` in one ``detect_batch``
   against serial ``detect``, then a live harvest over 16 tenants with
   five weeks of daily Size and a ``HoltWinters(DAILY, WEEKLY)`` watch,
   their newest folds on the card (K1), one day broken: the harvest's
   flags equal a plain Holt-Winters recurrence's on the same days (that
   day and no other), the ``deequ_service_anomaly_*`` series moved, the
   fits cached, ``/statusz`` serving its six planes; (d) the HLL and KLL
   states of a 1M-row cut of phase 3's table as JVM blobs, read back onto
   the card equal to the originals and merged with them (K8, K5's merge)
   equal to the originals merged with themselves, and a 365-day JVM
   history of the card's and the CPU's metrics imported into partitioned
   repositories with equal entries; (e) ``Applicability.is_applicable_check`` of phase
   3's check and of a check naming a missing column on the card (K1),
   equal to the CPU's. ``python3 -c "import torch, chip_smoke,
   deequ_tpu_torch as dq; chip_smoke.tenant_plane(torch, dq)"`` runs this
   phase alone, printing no result lines;
13. the reliability wrapper, the scan watchdog and the feed pipeline,
   after phase 3 on its table and checks (with an ApproxQuantile), driven
   through the port's own fault sites, each drill asserting the
   recoveries its fault explains: on the first 1M rows in batches of
   2^18, (a) an ``analyzer`` fault matched to Mean(a): that analyzer alone
   a Failure, the rest equal to a clean device-tier run, at most
   ceil(log2 N) + 1 isolation re-runs; (b) a ``device`` fault at batch 3,
   inside an open outer span with ``DEEQU_TPU_FLIGHT_DIR`` set: one
   failover, a clean host-tier run's metrics bit for bit, K8's carry
   and K5's ingest entries launched after it, one trace holding the
   failed device pass and the host pass with the
   ``DeviceFailureException`` failure and ``device_failover`` events, and
   the flight dump on disk before the outer span closes; (c) an injected ``oom``:
   one bisection and the halved batch's metrics; a persistent one: three
   and the host tier; one real allocator OOM read as "oom"; (d) a 6 s
   ``stall`` at batch 2 under ``DEEQU_TPU_SCAN_DEADLINE_S=2``: a
   ``ScanStallError`` within twice the deadline, the failover, its
   ``failure`` and ``scan_stall`` events on the run's one trace, no
   ``scan-watchdog`` thread alive 5 s after the stall ended and no K1
   launch after the abandonment; (e) 65,536-row jobs through
   ``VerificationService``: a device fault sends the battery's next 8
   jobs to the host tier (``deequ_service_suspect_host_routes_total``) and
   the ninth back to the device; (f) phase 3 at ``DEEQU_TPU_PREFETCH_DEPTH``
   0, 2, 2, 0, the states bit for bit and each run's seconds and phases
   printed, then a ``feed_stall`` at ``prefetch`` under
   ``DEEQU_TPU_FEED_STALL_S=1``: a ``FeedStallError`` and the failover;
14. the self-tuning plane, after phase 13 on its table and checks: (a)
   ``tuning.calibrate.calibrate(device="cuda")`` into a fresh profile
   directory, every probe and derived knob printed beside its static
   default, each derived value inside its knob's bounds, K1 and K6
   launched (a probe pass that left the device tier raises); (b) the
   profile read back with the card's name in its substrate, a corrupted
   copy raising ``CorruptStateError`` into ``.quarantine/``; (c) a
   ``VerificationService`` booted on that directory: a controller, the
   profile's values tuned, the router seeded from them, ``/statusz``'s
   tuning plane enabled; (d) a shadow experiment (``fast_path_max_rows``
   0 against the router) over 200 8,192-row folds of one session: exactly
   every 20th a shadow fold, each arm's rate printed; (e) the reference's
   chaos-soak tuning drill (a static burst, ``fast_path_max_rows=0``
   planted, a recovered burst; ``DEEQU_TPU_TUNING_MIN_SAMPLES=8``): the
   three sessions/s figures and the decisions printed, whether the floor
   fired a finding; the gates: every fold recorded, the live samples those
   since the last floor demotion, the demotion counter the floor's
   demoted knobs, no knob tuned after; (f) phase 3's verification under
   the profile (its ``prefetch_depth`` printed) and with static knobs,
   both equal to phase 3's metrics. The whole script runs with
   ``DEEQU_TPU_TUNING_PROFILE_DIR`` set to an empty temporary directory,
   so no other phase boots with a profile;
15. the cluster plane, after phase 12: (a) a ``cluster.FrontTier`` over
   ``LocalWorker``s whose ``VerificationService``s run on the card, each
   heartbeating one membership directory over one partition store; 16
   sessions x 8 micro-batches x 65,536 integer-valued rows (the soak's
   battery with Mean, StandardDeviation and ApproxCountDistinct), a third
   worker joining mid-stream (graceful migrations), one leaving (a drain)
   and an injected ``host_loss`` at ``host_heartbeat`` declaring a third
   lost (adoption and journal replay): every session equal to one unmoved
   session on a single service (bit for bit, the moments within 1e-12) and
   to the closed form of Sum and Size, the ``deequ_service_cluster_*``
   counters equal to a plain ring's for the same script, K1, K2 and K8
   launched; (b) ``tools/torch_cluster_soak.py --procs 3 --sessions 48
   --batches 2 --rows 262144 --device cuda`` (three worker processes, 25.2M
   rows of Arrow IPC over HTTP): the reference's soak gates (exact parity,
   a cross-process ingest trace, a worker's ``/statusz`` with its six
   planes), every worker that held a session launched K1 and ran
   device-tier folds, sessions/s and rows/s printed; (c) its ``--drill
   kill-one`` at 16 sessions x 2 x 262,144 rows, its workers with
   ``DEEQU_TPU_FAST_PATH_MAX_ROWS=0`` (every fold on the device route, so
   the replay after the recovery runs the kernels whatever the crossover
   router has measured): the reference's drill gates (exact parity, the
   recovery counters, the victim's span journal), the survivor's launches
   after the recovery above 0, its folds by route and the seconds from the
   SIGKILL to the last replayed fold printed. A soak that skips fails;
16. the fleet scheduler and the service's mesh route, run after phase 9
   while phase 3's table is in memory (``fleet_plane``): (a) on a
   ``VerificationService(fleet=True, fleet_devices=8)`` over 8 shards of
   the card, config 2's check at 10M rows as tenant ``a`` alone (all 8
   shards), tenant ``b`` alone on a second table of the same builder (the
   next seed), then both at once on disjoint 4-shard slices (positions
   printed), every job on the device tier (its phases; the battery warmed
   first at widths 8 and 4): ``a`` equal to phase 3's metrics (bit for
   bit, moments within 1e-12) and its oracle, ``b`` equal to its run
   alone; one cold job of a third tenant on the host tier over its
   2-shard slice, equal to phase 3's metrics; ``verify_partitioned`` of
   two 1M-row ``build_scan_data`` partitions under the fleet, equal to
   ``VerificationSuite.verify_partitioned`` on the card, with a fleet
   lease counted; K1 and K2 stacked, K3 and K8 launched, and on the cold
   job K8's stacked carry and butterfly; (b) fleet stream folds: 2
   tenants x 4 sessions x 4 micro-batches x 2^18 integer-valued rows (the
   reference's exact battery with Mean, StandardDeviation and
   ApproxCountDistinct) at the default ``DEEQU_TPU_FLEET_STREAM_MIN_ROWS``:
   32 fleet stream folds, every session equal to the same session on a
   ``fleet=False`` service on the card (bit for bit, the moments within
   1e-12), sessions/s printed, K8's stacked carry and butterfly launched;
   (c) the shard-loss drill: ``FaultSpec("sharded_fold", "mesh_loss",
   at=1, shard=2)`` on tenant ``a``'s second fold: exactly 7 healthy
   positions, lacking the one ``a``'s lease mapped shard 2 to, one fleet
   shard loss counted, a re-pack, later leases avoiding the dead position,
   every session equal to the ``fleet=False`` run; (d) an explicit
   ``mesh=make_mesh(8)``: no fleet, one config-2 verify equal to phase 9
   (c)'s metrics, two sessions' folds on the serial path over the mesh
   (no coalesced width counted), each equal to its one-card session.
   ``mesh_substrate()`` and the lease table print first;
17. the whole-service chaos soak, the tuning report and grouping tables
   on a mesh: (a) ``tools/torch_chaos_soak.py``'s ``run_soak`` at its
   CLI's defaults (30 jobs, 8 stream batches, 4,096 rows, seed 0, 4
   workers) on the card, its cluster drill off (15 (c) runs it): the
   soak ``ok`` with no drill skipped, faults fired, a device failure
   learned, K1, K2 and K8 launched (every count printed, read before and
   after); (b) the same soak at 2^18 rows a job; (c) inside phase 14,
   ``tools/torch_tuning_report.py --json`` on the calibrated profile (its
   calibrated knobs and probes the profile's), then, last, its
   ``--bench-point`` once in a subprocess (its JSON line printed, no gate);
   (d) inside phase 5, Uniqueness, CountDistinct and Entropy of the
   grouping workload over ``make_mesh(8)``, resident and non-resident:
   each equal to 5 (a)'s metrics, one device table, K6 launched and K7
   in the non-resident run. The card's name and power limit print with
   each part;
18. the device feature cache, the examples suite and the operator
   switches: (a) after phase 3, its run under
   ``DEEQU_TPU_DEVICE_FEATURE_CACHE``: a run under a large budget measures
   the bytes of one table's features, then under a budget of 1.5 tables,
   at feed depths 0 and 2, a cold run admits every batch and a warm run
   hits every batch (no ``feature_build``, no ``host_to_device``, K1-K3
   launched), both equal to phase 3's metrics bit for bit; a second 10M-row
   table (the next seed) evicts the first whole (one eviction), and
   ``clear_device_feature_cache()`` returns the cached bytes of device
   memory; each run's seconds and phases and the cached bytes print; (b)
   last, every example of ``examples_torch`` on ``device="cuda"``, its
   result and printed lines equal to its run on ``device="cpu"``, K1 (or
   its stacked entry) and the kernels of its path launched (counts
   printed); (c) after (a), on phase 3's first 1M rows with the dictionary
   columns as plain strings: ``DEEQU_TPU_ADAPTIVE_DICT_ENCODE=0``, the host
   tier at ``DEEQU_TPU_HOST_TIER_WORKERS`` 1 and 7 (bit for bit the default
   pool's run) and ``DEEQU_TPU_NO_NATIVE=1`` (the native module imported
   again under it) against the default run, and ``DEEQU_TPU_PROFILE_DIR``'s
   one trace of the pass naming K1-K3's CUDA kernels. The card's name and
   power limit print beside every time;
19. the reference's 32-bit accumulator mode, last, in a subprocess of this
   script started with ``DEEQU_TPU_NO_X64=1`` (``--no-x64-child``) before
   phase 17, whose imports and table build overlap phases 17 and 18 (b)
   and which uses the card only when phase 19 lets it (``--wait-for-go``): (a)
   each float32 entry (K1's one-launch and stacked entries, K4, K5's
   update, merge, stacked merge and ingest, K8's fold, carry, butterfly
   and stacked carry) and K3's int32 counts against their plain versions
   at phase 2's and 6's shapes, counts, min, max, registers and items bit
   for bit, sums and moments within ``F32_KERNEL_RTOL`` of their
   magnitudes, each timed beside its float64 entry on float64 copies of
   the same inputs and beside that entry's phase 2 time, with its bound;
   (b) phase 3's battery over the same 10M-row table on the
   card, against the float64 oracle (counts exact, the rest within 1e-4)
   and against the same mode on ``device="cpu"`` over a 1M-row cut, its
   phases beside phase 3's, and config 1 (the BasicExample) against its
   CPU run; (c) config 2 and a KLL sketch on the host
   tier, unsharded and over 8 shards, bit for bit the CPU's; (d) a
   persisted-state round trip merged on the card; (e) two sessions' two
   coalesced folds each through ``VerificationService``. Every float32 entry
   must launch on (b)-(e).

Each main path runs with the kernels' launch counts set to 0 just before it
and read just after, and every kernel of the path must have been launched.
Every phase fails when any run of it recovered from a fault (a failover,
an OOM bisection, an isolation re-run, a stall, a shard loss or a
degradation in the port's process-wide tally) that no drill of it
injected. Each phase's own seconds print as ``[seconds] phase N`` lines,
with the total, before the result lines.
The native host library (``deequ_tpu_torch/native``) builds with g++ at
its first use, inside phase 2.
The last two lines of standard output are the ``{"kernels": [...]}`` table
and ``{"ok": true, "device": {...}}``; ``nvidia-smi``'s name and power
limit come on a line before them. Without a CUDA device the script exits
with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import pyarrow as pa

#: cycles of ``torch.cuda._sleep`` per millisecond at the H100 SXM's
#: highest clock (1.98 GHz); at a lower clock the spin only lasts longer
SPIN_CYCLES_PER_MS = 2_000_000

#: H100 SXM data sheet: HBM3 bandwidth, and the highest non-tensor-core
#: rate (float32, 67 TFLOP/s) as the peak for the kernels' scalar adds
#: and compares
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

#: rows of the verification path's table: BASELINE config 2's 10M
ROWS = 10_000_000
BATCH_ROWS = 1 << 20
SMALL_CATEGORIES = 1_000
LARGE_CATEGORIES = 50_000
#: a dictionary size whose shared-memory histogram needs the >48 KB opt-in
ATTRIBUTE_PATH_CATEGORIES = 20_000

TPU_KERNELS = {
    "scan_reduce": "deequ_tpu/runners/engine.py:366",
    "hll_registers": "deequ_tpu/analyzers/sketches.py:277",
    # K2's battery entry: every HLL update of the reference's fused update
    "hll_registers_columns": "deequ_tpu/analyzers/sketches.py:277",
    "dict_code_counts": "deequ_tpu/analyzers/grouping.py:660",
    "kll_sample": "deequ_tpu/ops/kll.py:233",
    "kll_compact": "deequ_tpu/ops/kll.py:204",
    "freq_keys": "deequ_tpu/analyzers/grouping.py:911",
    "freq_compact": "deequ_tpu/ops/__init__.py:33",
    "state_fold": "deequ_tpu/analyzers/base.py:273",
    # the host ingest tier's entries of K8 and K5
    "state_fold_carry": "deequ_tpu/runners/engine.py:1760",
    "kll_compact_ingest": "deequ_tpu/ops/kll.py:284",
    # the streaming service's coalesced fold: K1's and K2's stacked entries
    # (call_with_slots_stacked, the vmapped fused update)
    "scan_reduce_stacked": "deequ_tpu/runners/engine.py:501",
    "hll_registers_stacked": "deequ_tpu/runners/engine.py:501",
    # the mesh (B11): the collective merge and the sharded host-tier fold
    "state_fold_butterfly": "deequ_tpu/parallel/__init__.py:266",
    "state_fold_carry_stacked": "deequ_tpu/parallel/__init__.py:171",
    "kll_compact_merge_stacked": "deequ_tpu/parallel/__init__.py:266",
}
#: the CUDA source of each kernel (an entry's is its kernel's)
KERNEL_SOURCES = {name: name for name in TPU_KERNELS} | {
    "state_fold_carry": "state_fold", "kll_compact_ingest": "kll_compact",
    "scan_reduce_stacked": "scan_reduce", "hll_registers_stacked": "hll_registers",
    "hll_registers_columns": "hll_registers",
    "state_fold_butterfly": "state_fold", "state_fold_carry_stacked": "state_fold",
    "kll_compact_merge_stacked": "kll_compact"}
#: the kernels each main path must launch
VERIFICATION_KERNELS = ("scan_reduce", "hll_registers_columns", "dict_code_counts")
PROFILE_KERNELS = ("scan_reduce", "hll_registers_columns", "dict_code_counts", "kll_sample",
                   "kll_compact")
FREQ_KERNELS = ("freq_keys", "freq_compact")
#: the merged-state refresh of the incremental path: K8 and K5's merge
INCREMENTAL_KERNELS = ("state_fold", "kll_compact")
#: the host ingest tier: K8's carry entry and K5's ingest entry
HOST_KERNELS = ("state_fold_carry", "kll_compact_ingest")
#: phase 9: the mesh's entries of K8 and K5, and what each mesh path must
#: launch (the host tier's collective merge; the device tier's stacked
#: entries with the shard as the stacked axis and the fold of the shards'
#: partial states)
MESH_KERNELS = ("state_fold_butterfly", "state_fold_carry_stacked", "kll_compact_merge_stacked")
MESH_HOST_KERNELS = ("state_fold_carry_stacked", "kll_compact_ingest", "state_fold_butterfly",
                     "kll_compact_merge_stacked")
MESH_DEVICE_KERNELS = ("scan_reduce_stacked", "hll_registers_stacked", "state_fold",
                       "dict_code_counts", "kll_sample", "kll_compact")
MESH_SHARDS = 8
#: phase 9's cuts: the runs held against the CPU, and the shard-loss drill
#: (more than one chunk fold, so the loss at the second fold replays)
MESH_CUT_ROWS = 1_000_000
MESH_LOSS_ROWS = 2_000_000
MESH_LOSS_BATCH_ROWS = 1 << 15
#: phase 9 (f): processes on the one card, and each one's deadline
DCN_WORLD = 4
DCN_JOIN_S = 240
#: rows per batch of phase 7 (a): 40 batches, a full chunk of 32 and a tail
HOST_BATCH_ROWS = 1 << 18
#: host partials of one chunk (the engine's INGEST_CHUNK)
CHUNK = 32

#: the bench's grouping workload (bench.py run_grouping_stage,
#: tools/grouping_sweep.py): 25M int64 keys over rows // 7 distinct values
GROUPING_ROWS = 25_000_000
GROUPING_DISTINCT = GROUPING_ROWS // 7
GROUPING_SEED = 1
#: the non-resident table: 2^22 slots (the default) and a 2^20-key buffer
FULL_TABLE_SLOTS = 1 << 22
#: a table too small for the workload's keys: the overflow run (c)
OVERFLOW_TABLE_SLOTS = 1 << 20


# ---------------------------------------------------------------------------
# data, checks and oracle (plain numpy/pyarrow: callable on the CPU)
# ---------------------------------------------------------------------------


def build_table(rows: int, seed: int) -> pa.Table:
    """The synthetic table: ``a``..``d`` float64 with ~5% nulls (``c`` and
    ``d`` also ~0.1% NaN values), ``id`` int64 0..rows-1, ``cat_small`` and
    ``cat_large`` dictionary-encoded strings with ~3% nulls."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name, (mu, sigma) in zip("abcd", [(10.0, 3.0), (-2.0, 5.0), (0.5, 1.0), (100.0, 40.0)]):
        v = rng.normal(mu, sigma, rows)
        if name in "cd":
            v[rng.random(rows) < 0.001] = np.nan
        cols[name] = pa.array(v, mask=rng.random(rows) < 0.05)
    cols["id"] = pa.array(np.arange(rows, dtype=np.int64))
    for name, k, prefix in (
        ("cat_small", SMALL_CATEGORIES, "s"),
        ("cat_large", LARGE_CATEGORIES, "L"),
    ):
        # Zipf-like skew: a few heavy categories, a long tail
        codes = np.minimum(rng.zipf(1.3, rows) - 1, k - 1).astype(np.int32)
        codes = ((codes * 7919) % k).astype(np.int32)
        cols[name] = pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=rng.random(rows) < 0.03),
            pa.array([f"{prefix}{i:05d}" for i in range(k)]),
        )
    return pa.table(cols)


#: BASELINE config 3's table: TPC-H lineitem's 16 columns (bench.py
#: build_lineitem_data, seed 19), at 10M rows (scale factor ~1.7)
LINEITEM_ROWS = 10_000_000
#: phase 4: the cut of lineitem the card's profile is held against the
#: CPU's on (the full-size profile is held against the oracle)
PROFILE_CPU_ROWS = 1_000_000
LINEITEM_SEED = 19
COMMENT_POOL = 1_000_000


def build_lineitem(rows: int, seed: int = LINEITEM_SEED, comment_pool: int = COMMENT_POOL) -> pa.Table:
    """TPC-H lineitem-shaped synthetic (BASELINE config 3): 4 int64 keys, 4
    float64 measures, 2 flags, 3 dates as dictionary strings, ship
    instruction and mode, and a dictionary comment column drawn from a pool
    of ``comment_pool`` texts. With ``seed`` 19 this is ``bench.py``'s
    ``build_lineitem_data``."""
    rng = np.random.default_rng(seed)
    cols = {}
    cols["l_orderkey"] = pa.array(rng.integers(1, max(rows // 4, 2), rows))
    cols["l_partkey"] = pa.array(rng.integers(1, 200_001, rows))
    cols["l_suppkey"] = pa.array(rng.integers(1, 10_001, rows))
    cols["l_linenumber"] = pa.array(rng.integers(1, 8, rows))
    cols["l_quantity"] = pa.array(rng.integers(1, 51, rows).astype(np.float64))
    cols["l_extendedprice"] = pa.array(np.round(rng.uniform(900, 105_000, rows), 2))
    cols["l_discount"] = pa.array(np.round(rng.uniform(0, 0.10, rows), 2))
    cols["l_tax"] = pa.array(np.round(rng.uniform(0, 0.08, rows), 2))
    flags = np.array(["A", "N", "R"])
    cols["l_returnflag"] = pa.array(flags[rng.integers(0, 3, rows)])
    status = np.array(["F", "O"])
    cols["l_linestatus"] = pa.array(status[rng.integers(0, 2, rows)])
    day0 = np.datetime64("1992-01-01")
    for name in ("l_shipdate", "l_commitdate", "l_receiptdate"):
        days = rng.integers(0, 2526, rows)  # 1992-01-01 .. 1998-12-01
        dates = (day0 + days.astype("timedelta64[D]")).astype("datetime64[D]")
        dic = pa.array(np.unique(dates).astype(str))
        codes = pa.array(np.searchsorted(np.unique(days), days).astype(np.int32))
        cols[name] = pa.DictionaryArray.from_arrays(codes, dic)
    instr = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"])
    cols["l_shipinstruct"] = pa.array(instr[rng.integers(0, 4, rows)])
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"])
    cols["l_shipmode"] = pa.array(modes[rng.integers(0, 7, rows)])
    pool = np.array(
        [f"comment text fragment number {i} about the order" for i in range(comment_pool)]
    )
    codes = pa.array(rng.integers(0, len(pool), rows).astype(np.int32))
    cols["l_comment"] = pa.DictionaryArray.from_arrays(codes, pa.array(pool))
    return pa.table(cols)


#: BASELINE config 5's table (bench.py build_wide_data, run_suggestion_stage):
#: 30 numeric, 10 string and 10 categorical columns, seed 7, cut from 1B
#: rows to 10M in 2^20-row batches; a quarter of the rows is the test split
WIDE_ROWS = 10_000_000
WIDE_NUMERIC, WIDE_STRING, WIDE_CATEGORICAL = 30, 10, 10
WIDE_SEED = 7
WIDE_TESTSET_RATIO = 0.25
WIDE_SPLIT_SEED = 0
#: phase 10 (d), (f): the table's first rows, over which the run with the
#: uniqueness rule added is held against the CPU's (the full-size run is
#: held against the oracle)
WIDE_CPU_ROWS = 1_000_000


def build_wide(rows: int, n_numeric: int = WIDE_NUMERIC, n_string: int = WIDE_STRING,
               n_cat: int = WIDE_CATEGORICAL, seed: int = WIDE_SEED) -> pa.Table:
    """The wide mixed table (BASELINE config 5): numeric columns ``n<i>``
    drawn from normal(10 i, 1 + i), every third with ~2% nulls; string
    columns ``s<i>`` drawn from 100,000 ids; categorical columns ``c<i>``
    of 20 (i + 1) categories. With ``seed`` 7 this is ``bench.py``'s
    ``build_wide_data``, draw for draw (the strings are gathered by Arrow,
    with the same values)."""
    import pyarrow.compute as pc

    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(n_numeric):
        vals = rng.normal(10 * i, 1 + i, rows)
        if i % 3 == 0:
            cols[f"n{i}"] = pa.array(vals, mask=rng.random(rows) < 0.02)
        else:
            cols[f"n{i}"] = pa.array(vals)
    base = pa.array([f"id_{i:07d}" for i in range(100_000)])
    for i in range(n_string):
        cols[f"s{i}"] = pc.take(base, pa.array(rng.integers(0, len(base), rows)))
    for i in range(n_cat):
        card = 20 * (i + 1)
        cats = pa.array([f"c{j}" for j in range(card)])
        cols[f"c{i}"] = pc.take(cats, pa.array(rng.integers(0, card, rows)))
    return pa.table(cols)


def split_rows(table: pa.Table, testset_ratio: float = WIDE_TESTSET_RATIO,
               seed: int = WIDE_SPLIT_SEED) -> tuple:
    """(training, test) tables: row i trains when its draw of
    ``numpy.random.default_rng(seed).random(rows)`` is below 1 - ratio
    (the suggestion runner's split, drawn here on its own)."""
    picks = np.random.default_rng(seed).random(table.num_rows) < 1.0 - testset_ratio
    idx = np.arange(table.num_rows)
    return table.take(pa.array(idx[picks])), table.take(pa.array(idx[~picks]))


def suggestion_values(result) -> tuple:
    """What the runner's result says: ``to_json()``, and each generated
    constraint's status on the test split, in suggestion order."""
    statuses = [] if result.verification_result is None else [
        c.status.value for r in result.verification_result.check_results.values()
        for c in r.constraint_results]
    return result.to_json(), statuses


def _oracle_column(table: pa.Table, name: str, codes: bool = True) -> tuple:
    """(validity, values, codes, dictionary) of a column: a string column
    dictionary-encoded by Arrow (values None; with ``codes`` False, not
    encoded: codes and dictionary None too), any other column as numpy
    values (codes and dictionary None)."""
    import pyarrow.compute as pc

    col = table.column(name).combine_chunks()
    valid = np.asarray(col.is_valid())
    if pa.types.is_string(col.type):
        if not codes:
            return valid, None, None, None
        col = pc.dictionary_encode(col)
    if pa.types.is_dictionary(col.type):
        codes = col.indices.fill_null(0).to_numpy(zero_copy_only=False)
        return valid, None, codes, col.dictionary.to_numpy(zero_copy_only=False)
    return valid, col.to_numpy(zero_copy_only=False), None, None


def _expected_status(code: str, test: pa.Table, columns: dict = None) -> str:
    """The status a generated constraint must have on ``test``, from the
    constraint's own code string (the seven rules' forms). ``columns``
    memoizes :func:`_oracle_column` of ``test`` by name and whether codes
    are needed (a column carries several suggestions; a string column is
    dictionary-encoded only for a membership or uniqueness check)."""
    import ast

    call = ast.parse(code.lstrip(".")).body[0].value
    method = call.func.id
    args = [ast.literal_eval(a) for a in call.args if not isinstance(a, ast.Lambda)]
    bound = None
    for a in call.args:
        if isinstance(a, ast.Lambda):  # lambda v: v >= <bound>
            bound = ast.literal_eval(a.body.comparators[0])
    columns = {} if columns is None else columns
    key = (args[0], method in ("is_contained_in", "is_unique"))
    if key not in columns:
        columns[key] = _oracle_column(test, key[0], codes=key[1])
    valid, values, codes, dictionary = columns[key]
    n = len(valid)
    if method == "is_complete":
        ok = bool(valid.all())
    elif method == "has_completeness":
        ok = valid.sum() / n >= bound
    elif method == "is_non_negative":
        # the rule's predicate "col >= 0": a null row does not comply
        ok = bool((valid & (np.where(valid, values, 0) >= 0)).all())
    elif method == "is_contained_in":
        allowed = list(args[1])
        member = (np.isin(dictionary, allowed)[codes] if codes is not None
                  else np.isin(values, allowed))
        ratio = (~valid | member).sum() / n
        ok = ratio == 1.0 if bound is None else ratio >= bound
    elif method == "is_unique":
        present = values if codes is None else codes
        ok = bool(valid.all()) and len(np.unique(present)) == n
    else:
        raise AssertionError(f"the oracle has no form for {code}")
    return "Success" if ok else "Failure"


def suggestion_oracle(result, statuses: list, train: pa.Table, test: pa.Table) -> list:
    """Differences between a suggestion run and numpy over its splits: the
    training split's row count, every column's completeness, the numeric
    columns' minima and the histograms' category counts; and each
    generated constraint's status on the test split."""
    problems = []
    if result.num_records != train.num_rows:
        problems.append(f"records: {result.num_records} != {train.num_rows}")
    for name, profile in result.column_profiles.items():
        valid, values, codes, dictionary = _oracle_column(
            train, name, codes=profile.histogram is not None)
        completeness = valid.sum() / len(valid)
        if profile.completeness != completeness:
            problems.append(f"{name} completeness {profile.completeness} != {completeness}")
        minimum = getattr(profile, "minimum", None)
        if minimum is not None and minimum != values[valid].min():
            problems.append(f"{name} minimum {minimum} != {values[valid].min()}")
        if profile.histogram is not None:
            if codes is not None:
                counts = np.bincount(codes[valid], minlength=len(dictionary))
                keys = dictionary[counts > 0].astype(str)
                counts = counts[counts > 0]
            else:
                keys, counts = np.unique(values[valid].astype(str), return_counts=True)
            want = dict(zip(keys.tolist(), counts.tolist()))
            if (~valid).any():
                want["NullValue"] = int((~valid).sum())
            got = {k: v.absolute for k, v in profile.histogram.values.items()}
            if got != want:
                problems.append(f"{name} histogram {str(got)[:200]} != {str(want)[:200]}")
    suggestions = result.all_suggestions
    if len(statuses) != len(suggestions):
        problems.append(f"{len(statuses)} statuses for {len(suggestions)} suggestions")
    test_columns: dict = {}
    for s, status in zip(suggestions, statuses):
        want = _expected_status(s.code_for_constraint, test, test_columns)
        if status != want:
            problems.append(f"{s.code_for_constraint}: {status} on the test split, numpy {want}")
    return problems


def build_check(dq, rows: int):
    """About twenty checks over every analyzer of the port, some with
    where-filters. ``dq`` is the ``deequ_tpu_torch`` package."""
    yes = lambda _: True  # noqa: E731 - the values are compared, not asserted
    return (
        dq.Check(dq.CheckLevel.ERROR, "smoke")
        .has_size(lambda n: n == rows)
        .is_complete("id")
        .has_completeness("a", lambda v: v > 0.9)
        .has_completeness("b", yes).where("a > 10")
        .has_mean("a", yes)
        .has_sum("b", yes)
        .has_min("c", yes)
        .has_max("d", yes)
        .has_standard_deviation("a", yes)
        .has_standard_deviation("b", yes).where("c > 0")
        .has_mean("id", yes).where("b < 0")
        .is_non_negative("id")
        .satisfies("a > b", "a above b", yes)
        .is_contained_in("cat_small", [f"s{i:05d}" for i in range(0, SMALL_CATEGORIES, 2)], assertion=yes)
        .has_approx_count_distinct("id", yes)
        .has_approx_count_distinct("cat_large", yes)
        .has_uniqueness(["cat_small"], yes)
        .has_distinctness(["cat_large"], yes)
        .has_unique_value_ratio(["cat_large"], yes)
        .has_entropy("cat_small", yes)
        .has_number_of_distinct_values("cat_large", yes)
        .has_histogram_values("cat_small", yes)
        .has_min_length("cat_large", yes)
        .has_max_length("cat_small", yes)
        .has_pattern("cat_large", r"L0\d[05]", yes)
    )


def oracle(table: pa.Table) -> dict:
    """Exact counts and means with numpy, keyed (analyzer name, instance,
    where)."""
    def valid(name):
        arr = table[name].combine_chunks()
        return arr.to_numpy(zero_copy_only=False), np.asarray(arr.is_valid())

    a, am = valid("a")
    b, bm = valid("b")
    c, cm = valid("c")
    d, dm = valid("d")
    ids = table["id"].to_numpy()
    n = len(ids)
    out = {
        ("Size", "*", None): float(n),
        ("Completeness", "id", None): 1.0,
        ("Completeness", "a", None): am.mean(),
        ("Completeness", "b", "a > 10"): (bm & am & (a > 10)).sum() / (am & (a > 10)).sum(),
        ("Mean", "a", None): a[am].mean(),
        ("Sum", "b", None): b[bm].sum(),
        ("Minimum", "c", None): np.nanmin(c[cm]),
        ("Maximum", "d", None): np.max(d[dm]),  # a NaN value wins the max
        ("StandardDeviation", "a", None): a[am].std(),
        ("Mean", "id", "b < 0"): ids[bm & (b < 0)].mean(),
        ("Compliance", "id is non-negative", None): 1.0,
    }
    for name in ("cat_small", "cat_large"):
        col = table[name].combine_chunks()
        present = np.asarray(col.is_valid())
        codes = col.indices.fill_null(0).to_numpy(zero_copy_only=False)
        counts = np.bincount(codes[present].astype(np.int64), minlength=len(col.dictionary))
        counts = counts[counts > 0]
        if name == "cat_small":
            out[("Uniqueness", name, None)] = (counts == 1).sum() / n
        else:
            out[("Distinctness", name, None)] = len(counts) / n
            out[("UniqueValueRatio", name, None)] = (counts == 1).sum() / len(counts)
    return out


def metric_key(analyzer) -> tuple:
    return (analyzer.name, analyzer.instance, getattr(analyzer, "where", None))


def metric_values(result) -> dict:
    """Metric values keyed like :func:`oracle`; histograms as their bins."""
    out = {}
    for analyzer, metric in result.metrics.items():
        if metric.value.is_failure:
            out[metric_key(analyzer)] = ("failure", str(metric.value.exception))
            continue
        value = metric.value.get()
        if hasattr(value, "values"):  # Distribution
            value = (value.number_of_bins, {k: v.absolute for k, v in value.values.items()})
        out[metric_key(analyzer)] = value
    return out


#: metrics that are float sums or moments; all others must match exactly
MOMENT_METRICS = ("Mean", "Sum", "StandardDeviation", "Correlation")


def compare_metrics(got: dict, want: dict, rtol: float = 1e-12) -> list:
    """Differences between two metric maps: exact for every metric but the
    float moments, which agree within ``rtol`` relative."""
    problems = []
    if set(got) != set(want):
        problems.append(f"different metrics: {sorted(set(got) ^ set(want), key=str)}")
    for key in sorted(set(got) & set(want), key=str):
        g, w = got[key], want[key]
        if isinstance(g, float) and isinstance(w, float):
            if math.isnan(g) or math.isnan(w):
                ok = math.isnan(g) and math.isnan(w)
            elif key[0] in MOMENT_METRICS:
                ok = abs(g - w) <= rtol * max(abs(w), 1e-300)
            else:
                ok = g == w
        else:
            ok = g == w
        if not ok:
            problems.append(f"{key}: {g!r} != {w!r}")
    return problems


def compare_oracle(got: dict, want: dict, rtol: float = 1e-9) -> list:
    problems = []
    for key, w in want.items():
        g = got.get(key)
        w = float(w)
        if not isinstance(g, float):
            problems.append(f"{key}: {g!r}, oracle {w!r}")
        elif math.isnan(w):
            if not math.isnan(g):
                problems.append(f"{key}: {g!r}, oracle NaN")
        elif abs(g - w) > rtol * max(abs(w), 1e-300):
            problems.append(f"{key}: {g!r}, oracle {w!r}")
    return problems


#: the profiler's KLL sketch size, and the relative error in rank it is
#: held to: the port sizes a sketch at 4 / error items for a relative error
KLL_SKETCH_SIZE = 2048
KLL_RELATIVE_ERROR = 4.0 / KLL_SKETCH_SIZE
#: the rank limit of sketches filled on the host tier. Its sampler (the
#: reference's block_kll_sample, bit for bit) is a strided pick of each
#: unsorted batch, so its error is a sample's, not a compactor's: phases
#: 7 (a)-(c) read 0.0017-0.0041 on an H100 80GB HBM3 at 700 W, above twice
#: the sketch's relative error (0.0039). The limit lies between those and
#: phase 2's biased control (each sample's lower half), which must exceed
#: it. Faults that keep a sample unbiased (a wrong level, dropped samples)
#: move no percentile of lineitem's i.i.d. columns past it: the bit-for-bit
#: comparisons with the same runs on ``device="cpu"`` hold those.
HOST_KLL_RANK_LIMIT = 0.01
MOMENT_FIELDS = ("mean", "sum", "std_dev")

# the reference's type-inference regexes and decision order
# (`analyzers/catalyst/StatefulDataType.scala:36-38`)
_TYPE_PATTERNS = (
    ("Fractional", re.compile(r"(-|\+)? ?\d*\.\d*", re.ASCII)),
    ("Integral", re.compile(r"(-|\+)? ?\d*", re.ASCII)),
    ("Boolean", re.compile(r"true|false")),
)
TYPE_NAMES = ("Unknown", "Fractional", "Integral", "Boolean", "String")


def _type_name(value: str) -> str:
    for name, pattern in _TYPE_PATTERNS:
        if pattern.fullmatch(value):
            return name
    return "String"


def profile_values(profiles) -> dict:
    """Every field of every column profile, as plain Python values."""
    out = {"__records__": profiles.num_records}
    for name, p in profiles.profiles.items():
        entry = {
            "kind": type(p).__name__, "data_type": p.data_type,
            "inferred": p.is_data_type_inferred, "completeness": p.completeness,
            "distinct": p.approximate_num_distinct_values, "type_counts": dict(p.type_counts),
            "histogram": None if p.histogram is None else (
                p.histogram.number_of_bins,
                {k: (v.absolute, v.ratio) for k, v in p.histogram.values.items()}),
        }
        for f in ("mean", "maximum", "minimum", "sum", "std_dev", "approx_percentiles"):
            entry[f] = getattr(p, f, None)
        kll = getattr(p, "kll", None)
        entry["kll"] = None if kll is None else (
            [(b.low_value, b.high_value, b.count) for b in kll.buckets], kll.parameters, kll.data)
        out[name] = entry
    return out


def compare_profiles(got: dict, want: dict, rtol: float = 1e-12) -> list:
    """Differences between two profiles: every field equal but the means,
    sums and standard deviations, which agree within ``rtol`` relative."""
    problems = []
    if list(got) != list(want):
        return [f"different columns: {list(got)} vs {list(want)}"]
    if got["__records__"] != want["__records__"]:
        problems.append(f"records: {got['__records__']} != {want['__records__']}")
    for name in list(want)[1:]:
        for field, w in want[name].items():
            g = got[name][field]
            if field in MOMENT_FIELDS and g is not None and w is not None:
                ok = abs(g - w) <= rtol * max(abs(w), 1e-300)
            else:
                ok = g == w
            if not ok:
                problems.append(f"{name}.{field}: {str(g)[:200]} != {str(w)[:200]}")
    return problems


def _rank_error(sorted_items: np.ndarray, x: float, q: float) -> float:
    """How far q lies outside the rank interval [P(X < x), P(X <= x)]."""
    n = len(sorted_items)
    lo = np.searchsorted(sorted_items, np.float32(x), "left") / n
    hi = np.searchsorted(sorted_items, np.float32(x), "right") / n
    return 0.0 if lo <= q <= hi else float(min(abs(q - lo), abs(q - hi)))


#: per table (by identity): numpy's exact answers the profile oracle reads,
#: computed once for the phases that profile the same table
_PROFILE_TRUTH: dict = {}


def _column_truth(table: pa.Table, name: str) -> dict:
    """numpy's exact answers for one column of ``table``, computed once: its
    valid count and distinct values' count; the value counts where a
    histogram or type counts need them (120 distinct values or fewer, or a
    string column); for a numeric column its minimum, maximum, mean, sum,
    standard deviation and sorted float32-rounded values (the items a
    sketch holds)."""
    import pyarrow.compute as pc

    cached = _PROFILE_TRUTH.get(id(table))
    if cached is None or cached[0] is not table:
        cached = _PROFILE_TRUTH[id(table)] = (table, {})
    columns = cached[1]
    if name in columns:
        return columns[name]
    col = table[name].combine_chunks()
    if isinstance(col, pa.DictionaryArray):
        col = col.dictionary_decode()
    truth = {"valid": table.num_rows - col.null_count,
             "distinct": pc.count_distinct(col).as_py(), "string": pa.types.is_string(col.type)}
    if truth["string"] or truth["distinct"] <= 120:
        counts = {row["values"]: row["counts"] for row in pc.value_counts(col).to_pylist()}
        counts.pop(None, None)
        truth["counts"] = counts
        truth["key"] = float if pa.types.is_floating(col.type) or pa.types.is_integer(col.type) \
            else str
    if pa.types.is_integer(col.type) or pa.types.is_floating(col.type):
        v = col.to_numpy(zero_copy_only=False).astype(np.float64)
        truth["stats"] = {"minimum": v.min(), "maximum": v.max(), "mean": v.mean(),
                          "sum": v.sum(), "std_dev": v.std()}
        truth["items"] = np.sort(
            np.clip(v, -3.4028234663852886e38, 3.4028234663852886e38).astype(np.float32))
    columns[name] = truth
    return truth


def compare_profile_oracle(got: dict, table: pa.Table, rtol: float = 1e-9,
                           rank_limit: float = 2 * KLL_RELATIVE_ERROR) -> tuple:
    """Differences between a profile and numpy's exact answers on
    ``table`` (:func:`_column_truth`, computed once a table): record count,
    completeness, type counts, histograms, bucket totals, min and max
    exactly; mean, sum and standard deviation within ``rtol``; each of the
    100 percentiles within twice the KLL relative error in rank, ranked
    among the column's float32-rounded values (the items a sketch holds).
    Returns (problems, largest rank error)."""
    problems = []
    rows = table.num_rows
    if got["__records__"] != rows:
        problems.append(f"records: {got['__records__']} != {rows}")
    worst_rank = 0.0
    for name in table.column_names:
        truth = _column_truth(table, name)
        valid = truth["valid"]
        p = got[name]
        if p["completeness"] != valid / rows:
            problems.append(f"{name}.completeness: {p['completeness']} != {valid / rows}")
        if truth["string"]:
            want = dict.fromkeys(TYPE_NAMES, 0)
            want["Unknown"] = rows - valid
            for value, c in truth["counts"].items():
                want[_type_name(value)] += c
            if p["type_counts"] != want:
                problems.append(f"{name}.type_counts: {p['type_counts']} != {want}")
        if (p["histogram"] is not None) != (truth["distinct"] <= 120):
            problems.append(f"{name}: histogram {p['histogram'] is not None} at "
                            f"{truth['distinct']} values")
        if p["histogram"] is not None and truth["distinct"] <= 120:
            key = truth["key"]
            hist = {key(k): a for k, (a, _) in p["histogram"][1].items()}
            if hist != {key(k): c for k, c in truth["counts"].items()}:
                problems.append(f"{name}.histogram differs from the exact counts")
        if p["kll"] is None:
            continue
        stats = truth["stats"]
        for field in ("minimum", "maximum"):
            if p[field] != float(stats[field]):
                problems.append(f"{name}.{field}: {p[field]!r} != {float(stats[field])!r}")
        for field in ("mean", "sum", "std_dev"):
            exact = stats[field]
            if abs(p[field] - exact) > rtol * max(abs(exact), 1e-300):
                problems.append(f"{name}.{field}: {p[field]!r}, oracle {float(exact)!r}")
        if sum(b[2] for b in p["kll"][0]) != valid:
            problems.append(f"{name}: KLL buckets do not add up to {valid}")
        items = truth["items"]
        errors = [_rank_error(items, x, (i + 1) / 100) for i, x in enumerate(p["approx_percentiles"])]
        worst_rank = max(worst_rank, max(errors))
        if max(errors) > rank_limit:
            problems.append(f"{name}: percentile rank error {max(errors)} > {rank_limit}")
    return problems, worst_rank


# ---------------------------------------------------------------------------
# states of every kind state_fold folds (plain numpy/torch: callable on the CPU)
# ---------------------------------------------------------------------------


def fold_groups(dq, n_states: int, seed: int, device: str = "cpu") -> list:
    """``(analyzer, [n_states states])`` for every state kind of K8
    ``state_fold``, random from ``seed``: counts, sums, minima and maxima
    with NaN and signed zeros among them, moments and co-moments with
    empty (n = 0) states, DataType counts and HLL registers."""
    import torch

    from deequ_tpu_torch.analyzers import states as st

    rng = np.random.default_rng(seed)

    def f(x):
        return torch.tensor(float(x), dtype=torch.float64, device=device)

    def i(x):
        return torch.tensor(int(x), dtype=torch.int64, device=device)

    def value():
        r = rng.random()
        if r < 0.1:
            return math.nan
        if r < 0.2:
            return -0.0 if rng.random() < 0.5 else 0.0
        return float(rng.normal(5.0, 100.0))

    def n_or_empty():
        return 0.0 if rng.random() < 0.2 else float(rng.integers(1, 10_000))

    def moments():
        n = n_or_empty()
        if n == 0:
            return st.StandardDeviationState(f(0), f(0), f(0))
        return st.StandardDeviationState(f(n), f(rng.normal(3.0, 50.0)), f(rng.random() * n * 30))

    def comoments():
        n = n_or_empty()
        if n == 0:
            return st.CorrelationState(*(f(0) for _ in range(6)))
        x, y = rng.random() * n * 9, rng.random() * n * 4
        return st.CorrelationState(f(n), f(rng.normal(0, 9)), f(rng.normal(1, 4)),
                                   f(rng.normal(0, 1) * math.sqrt(x * y)), f(x), f(y))

    def count():
        return rng.integers(0, 1 << 40)

    makers = [
        (dq.Size(), lambda: st.NumMatches(i(count()))),
        (dq.Completeness("x0"), lambda: st.NumMatchesAndCount(i(count()), i(count()))),
        (dq.Mean("x0"), lambda: st.MeanState(f(value()), i(count()))),
        (dq.Sum("x1"), lambda: st.SumState(f(value()), i(count()))),
        (dq.Minimum("x2"), lambda: st.MinState(f(value()), i(count()))),
        (dq.Maximum("x2"), lambda: st.MaxState(f(value()), i(count()))),
        (dq.StandardDeviation("x3"), moments),
        (dq.Correlation("x0", "x1"), comoments),
        (dq.DataType("x0"), lambda: st.DataTypeHistogram(torch.from_numpy(
            rng.integers(0, 1 << 30, 5)).to(device))),
        (dq.ApproxCountDistinct("cat"), lambda: st.ApproxCountDistinctState(torch.from_numpy(
            rng.integers(0, 40, 512).astype(np.int32)).to(device))),
    ]
    return [(a, [make() for _ in range(n_states)]) for a, make in makers]


def carry_groups(dq, n_states: int, seed: int, device: str = "cpu") -> list:
    """:func:`fold_groups` and a dictionary column's code counts: every
    state kind a host partial gives K8's carry entry."""
    import torch

    from deequ_tpu_torch.analyzers import states as st
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan

    rng = np.random.default_rng(seed + 1)

    def counts():
        return st.FrequencyCountsState(
            torch.from_numpy(rng.integers(0, 1 << 20, 300)).to(device),
            torch.tensor(int(rng.integers(0, 1 << 30)), dtype=torch.int64, device=device))

    return fold_groups(dq, n_states, seed, device) + [
        (DeviceFrequencyScan("cat", 300), [counts() for _ in range(n_states)])]


def edge_samples(k: int, n: int, seed: int) -> list:
    """``n`` host KLL samples ``(items f64[4k], m, h, nv, min, max)`` at the
    edges K5's ingest entry must take: empty samples (m = 0), full ones
    (m = 2k, the host sampler's widest), h = 0 and up to 6, and items of
    +-inf and beyond the float32 range (no NaN: the sampler drops it)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        m = (0, 2 * k, int(rng.integers(1, 2 * k + 1)))[b % 3]
        h = 0 if b % 4 == 0 else int(rng.integers(0, 7))
        vals = rng.normal(b % 7, 1e3, m)
        if m >= 4:
            vals[:4] = [np.inf, -np.inf, 5e38, -1e300]
        vals = np.sort(vals)
        items = np.full(4 * k, np.inf)
        items[:m] = vals
        if m == 0:
            out.append((items, 0, 0, 0, np.inf, -np.inf))
        else:
            out.append((items, m, h, m << h, float(vals[0]), float(vals[-1])))
    return out


#: the K7 cases held against the reference (CPU tests) and the kernel
#: against its plain version (the cuda tests, phase 2)
FREQ_EDGE_CASES = ("lowest byte", "both sides of 2^63", "half sentinels", "empty table",
                   "out_size below n_unique", "runs longer than a tile",
                   "merge of overlapping tables")
U64_SENTINEL = np.uint64(2**64 - 1)


def freq_edge_case(case: str, seed: int = 0) -> tuple:
    """``(a_keys, a_counts, b_keys, b_counts, out_size)`` of one K7 edge
    case, as numpy arrays (keys uint64): a sorted table A and a raw key
    buffer B (``b_counts`` None), or a second table (merge mode). The
    tables come from the reference's function in plain numpy, so the case
    needs neither package."""
    rng = np.random.default_rng(seed)

    def table(keys, counts, size):
        uniq, inv = np.unique(keys[keys != U64_SENTINEL], return_inverse=True)
        sums = np.bincount(inv, weights=counts[keys != U64_SENTINEL]).astype(np.int64)
        out_k = np.full(size, U64_SENTINEL, np.uint64)
        out_c = np.zeros(size, np.int64)
        out_k[:min(size, uniq.size)] = uniq[:size]
        out_c[:min(size, uniq.size)] = sums[:size]
        return out_k, out_c

    def with_sentinels(keys, share):
        keys = keys.copy()
        keys[rng.random(keys.size) < share] = U64_SENTINEL
        return keys

    def around(base, spread, n):
        return (np.uint64(base) + rng.integers(0, spread, n).astype(np.uint64)).astype(np.uint64)

    if case == "lowest byte":
        base = 0x0123456789ab0000
        a = table(around(base, 256, 3000), rng.integers(1, 9, 3000), 1 << 12)
        return a + (with_sentinels(around(base, 256, 1 << 14), 0.05), None, 1 << 12)
    if case == "both sides of 2^63":
        base = 2**63 - 100
        a = table(around(base, 200, 3000), rng.integers(1, 9, 3000), 1 << 12)
        return a + (with_sentinels(around(base, 200, 1 << 14), 0.05), None, 1 << 12)
    if case == "half sentinels":
        pool = rng.integers(0, 2**64 - 1, 5000, dtype=np.uint64)
        a = table(pool[:2000], rng.integers(1, 9, 2000), 1 << 13)
        return a + (with_sentinels(pool[rng.integers(0, 5000, 1 << 14)], 0.5), None, 1 << 13)
    if case == "empty table":
        keys = rng.integers(0, 2**64 - 1, 1 << 13, dtype=np.uint64)
        return (np.zeros(0, np.uint64), np.zeros(0, np.int64), with_sentinels(keys, 0.1), None,
                1 << 13)
    if case == "out_size below n_unique":
        pool = rng.integers(0, 2**64 - 1, 40000, dtype=np.uint64)
        a = table(pool[:4096], rng.integers(1, 9, 4096), 1 << 12)
        return a + (with_sentinels(pool[rng.integers(0, 40000, 1 << 15)], 0.1), None, 1 << 10)
    if case == "runs longer than a tile":
        # three keys, each about 20,000 times in the buffer: runs longer than
        # a merge tile (2,048 entries) and a sort tile (8,192 keys)
        a = table(np.array([5, 9, 1 << 40], np.uint64), np.array([3, 1, 2]), 1 << 10)
        return a + (with_sentinels(around(5, 3, 1 << 16), 0.05), None, 1 << 10)
    if case == "merge of overlapping tables":
        a = table(around(0, 1 << 13, 1 << 14), rng.integers(1, 9, 1 << 14), 1 << 13)
        b = table(around(0, 1 << 13, 1 << 14), rng.integers(1, 9, 1 << 14), 1 << 13)
        return a + b + (1 << 13,)
    raise ValueError(f"unknown K7 edge case {case!r}")


#: the level patterns K5's compaction is held on (phase 2 and the cuda
#: tests): sorted runs, an unsorted level, one key, interleaved signed zeros
KLL_RUN_CASES = ("one run", "two runs", "70 runs", "unsorted", "equal keys", "signed zeros")
#: the level sizes the run cases reach, as multiples of k plus a remainder:
#: k (no compaction), k + 1 (an odd compaction), 4k (full: appends drop)
KLL_RUN_TARGETS = ((1, 0), (1, 1), (4, 0))


def run_items(case: str, n: int, rng) -> np.ndarray:
    """``n`` float32 items in the pattern ``case`` of :data:`KLL_RUN_CASES`
    (the signed zeros in three runs, each keeping its zeros' input order)."""
    if case == "equal keys":
        x = np.full(n, 2.5)
    elif case == "signed zeros":
        x = np.where(rng.random(n) < 0.5, -0.0, 0.0)
        some = rng.random(n) < 0.2
        x[some] = rng.normal(0.0, 1.0, int(some.sum()))
    else:
        x = rng.normal(0.0, 10.0, n)
    runs = {"one run": 1, "two runs": 2, "70 runs": 70, "equal keys": 1,
            "signed zeros": 3}.get(case)
    if runs is not None and n:
        cuts = np.linspace(0, n, runs + 1).astype(int)
        # a stable sort on keys in which -0.0 equals +0.0
        x = np.concatenate([x[a:b][np.argsort(x[a:b] + 0.0, kind="stable")]
                            for a, b in zip(cuts[:-1], cuts[1:])])
    return x.astype(np.float32)


def run_state(k: int, case: str, size: int, level: int, levels: int, rng) -> tuple:
    """A sketch's seven CPU tensors: ``size`` items of pattern ``case`` at
    ``level``, k // 2 + 1 sorted items one level up (the promotion lands
    on them), random parities."""
    items = np.full((levels, 4 * k), np.inf, dtype=np.float32)
    sizes = np.zeros(levels, dtype=np.int32)
    items[level, :size] = run_items(case, size, rng)
    up = k // 2 + 1
    items[level + 1, :up] = np.sort(rng.normal(0.0, 10.0, up)).astype(np.float32)
    sizes[level], sizes[level + 1] = size, up
    parity = rng.integers(0, 2, levels).astype(np.int32)
    return (torch_tensor(items), torch_tensor(sizes), torch_tensor(parity),
            torch_tensor(np.array(int(rng.integers(0, 9)), dtype=np.int32)),
            torch_tensor(np.array(size + up, dtype=np.int64)),
            torch_tensor(np.array(-30.0)), torch_tensor(np.array(30.0)))


#: the columns K4 is held on beside the main path's (phase 2, cuda tests)
KLL_COLUMNS = ("edges", "constant", "one binade", "signed zeros", "all NaN", "all masked")


def kll_column(case: str, n: int, seed: int) -> tuple:
    """A KLL batch of ``n`` rows (values, rows, present; numpy) in the
    pattern ``case`` of :data:`KLL_COLUMNS`: normal values with signed
    zeros, NaN, infinities and values beyond the float32 range; one
    value; values of one binade, [1, 2), none masked, whose keys share
    their top byte (K4's last pass moves nothing); only -0.0 and +0.0;
    only NaN; every row masked."""
    rng = np.random.default_rng(seed)
    v = rng.normal(50.0, 20.0, n)
    if case == "edges":
        for value, p in ((0.0, 0.05), (-0.0, 0.05), (np.nan, 0.01), (np.inf, 0.005),
                         (-1e300, 0.005)):
            v[rng.random(n) < p] = value
    elif case == "constant":
        v[:] = 7.25
    elif case == "one binade":
        v = 1.0 + rng.random(n)
    elif case == "signed zeros":
        v = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    elif case == "all NaN":
        v[:] = np.nan
    rows = rng.random(n) < (0.0 if case == "all masked" else 0.98)
    present = rng.random(n) < 0.9
    if case == "one binade":  # no row masked: a masked row's +inf has another top byte
        rows[:] = present[:] = True
    return v, rows, present


def torch_tensor(x: np.ndarray):
    import torch

    return torch.from_numpy(np.array(x))


def _run_sizes(k: int, target: tuple, parts: int) -> list:
    """Sizes of ``parts`` pieces summing to the target level size; at 4k the
    pieces add up to 5k, so an append drops k items."""
    mult, extra = target
    total = mult * k + extra + (k if mult == 4 else 0)
    first = total - (parts - 1) * (total // parts)
    return [first] + [total // parts] * (parts - 1)


def run_update_case(k: int, case: str, target: tuple, seed: int, levels: int = 8) -> tuple:
    """A sketch and a K4-shaped sample ``(samples, meta, minmax)`` (CPU
    tensors) whose append at level 1 brings it to the target size."""
    rng = np.random.default_rng(seed)
    mult, extra = target
    m = k if mult == 4 else (mult * k + extra) // 2
    size = 4 * k - m // 2 if mult == 4 else mult * k + extra - m
    state = run_state(k, case, size, 1, levels, rng)
    samples = np.full(k, np.inf, dtype=np.float32)
    samples[:m] = run_items(case, m, rng)
    meta = np.array([m, 1, m << 1], dtype=np.int32)
    minmax = np.array([float(samples[:m].min()), float(samples[:m].max())])
    return state, (torch_tensor(samples), torch_tensor(meta), torch_tensor(minmax))


def run_merge_case(k: int, case: str, target: tuple, seed: int, levels: int = 8) -> tuple:
    """Two sketches whose level 1 together reach the target size."""
    rng = np.random.default_rng(seed)
    sa, sb = _run_sizes(k, target, 2)
    return run_state(k, case, sa, 1, levels, rng), run_state(k, case, sb, 1, levels, rng)


def run_ingest_case(k: int, case: str, target: tuple, seed: int, levels: int = 8) -> tuple:
    """Two sketches (their leaves stacked) and three host samples each
    (``[S][B]`` of ``(items f64[4k], m, h, nv, min, max)``): the first
    brings level 1 to the target size, then h rises to 2 and falls to 0;
    the items in the pattern ``case``."""
    import torch

    rng = np.random.default_rng(seed)
    sketches, chunk = [], []
    for _ in range(2):
        size, m = _run_sizes(k, target, 2)
        sketches.append(run_state(k, case, size, 1, levels, rng))
        row = []
        for h, count in ((1, m), (2, k), (0, 2 * k)):
            vals = run_items(case, count, rng).astype(np.float64)
            items = np.full(4 * k, np.inf)
            items[:count] = vals
            row.append((items, count, h, count << h, float(vals.min()), float(vals.max())))
        chunk.append(row)
    return [torch.stack(list(col)).contiguous() for col in zip(*sketches)], chunk


def same_state_bits(got, want) -> bool:
    """Whether two tensor states hold the same leaves, bit for bit (NaN
    equal to NaN whatever its payload)."""
    from deequ_tpu_torch.analyzers.states import leaves

    if type(got) is not type(want) or len(leaves(got)) != len(leaves(want)):
        return False
    return same_tensor_bits(leaves(got), leaves(want))


def same_tensor_bits(got, want) -> bool:
    """Whether two sequences of tensors are equal bit for bit (NaN equal
    to NaN whatever its payload)."""
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.dtype != w.dtype or g.shape != w.shape:
            return False
        if g.dtype.kind == "f":
            nan = np.isnan(g)
            if not np.array_equal(nan, np.isnan(w)):
                return False
            g, w = np.where(nan, 0.0, g), np.where(nan, 0.0, w)
        if g.tobytes() != w.tobytes():
            return False
    return True


def sequential_fold(states: list):
    """The left-to-right fold of the states' own ``merge``."""
    merged = states[0]
    for s in states[1:]:
        merged = merged.merge(s)
    return merged


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions, with times and bounds
# ---------------------------------------------------------------------------


#: :func:`_time_ms`: a call whose host work takes longer than this (ms) is
#: timed over at most SLOW_CALL_REPS calls
SLOW_CALL_HOST_MS = 2.0
SLOW_CALL_REPS = 3
#: the longest spin queued before a timed call (ms)
SPIN_CAP_MS = 150.0


def _time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> dict:
    """Times of one call of ``fn``: ``ms``, the median CUDA-event time of
    the device work the call queues; ``host_ms``, the median host time the
    call takes to queue it; ``ahead``, how many of the ``reps`` calls were
    queued whole before their start event fired. Where any was, ``ms`` is
    the median over those alone.

    Before every call the L2 cache is flushed (the main path reads freshly
    copied features, not cached ones) and a spin kernel is queued that
    outlasts the call's host work, with the start event behind it. So the
    events bracket the queued work alone, back to back, and not the host
    time between launches. A call that waits for the card itself (a copy
    to the host, a data-dependent size) cannot be queued ahead; its ``ms``
    then includes the host time after that wait, and ``ahead`` says so.

    A call whose host work takes more than ``SLOW_CALL_HOST_MS`` (the plain
    versions, which wait for the card or issue hundreds of small launches)
    is timed over at most ``SLOW_CALL_REPS`` calls, and no spin lasts more
    than ``SPIN_CAP_MS``: the slowest call queued ahead in PR 22's runs
    took 22.4 ms, and the calls of hundreds of ms wait for the card, so
    a longer spin only waits."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    spin_ms = min(2.0 + 4e3 * host_s, SPIN_CAP_MS)
    if 1e3 * host_s > SLOW_CALL_HOST_MS:
        reps = min(reps, SLOW_CALL_REPS)
    torch.cuda.synchronize()
    device, host, queued = [], [], []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * spin_ms))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        queued.append(not start.query())
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    if any(queued):
        device = [ms for ms, q in zip(device, queued) if q]
    return {"ms": statistics.median(device), "host_ms": statistics.median(host),
            "ahead": sum(queued), "reps": reps}


def _time_kernel_ms(torch, fn) -> dict:
    """:func:`_time_ms` of a kernel's wrapper, which never waits for the
    card: most calls must have been queued ahead of their start event (a
    host thread descheduled past the spin can miss it now and then)."""
    t = _time_ms(torch, fn)
    if 2 * t["ahead"] < t["reps"]:
        raise AssertionError(f"a kernel call started before it was queued whole: {t}")
    return t


def _bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs_err(got, want) -> float:
    g = got.double().cpu().numpy().ravel()
    w = want.double().cpu().numpy().ravel()
    same = (np.isnan(g) & np.isnan(w)) | (g == w)
    diff = np.abs(g[~same] - w[~same])
    return float(diff.max()) if diff.size else 0.0


#: K2's edge cases, each (keys, rows, where, present) of one batch
HLL_EDGE_CASES = ("n = 0", "n = 1", "n = 17", "all rows masked", "one register", "odd offset",
                  "every key")


def hll_edge_inputs(torch, case: str, device, n: int = 100_003, seed: int = 0) -> tuple:
    """One of :data:`HLL_EDGE_CASES` on ``device``: random packed keys and
    masks of ``n`` rows, or ``case``'s; "odd offset" gives ``[1:]`` views
    (every array one element off its allocation), "every key" each of the
    2^15 packed keys in turn (ranks 0 to 63 of every register)."""
    rng = np.random.default_rng(seed)
    size = {"n = 0": 0, "n = 1": 1, "n = 17": 17}.get(case, n)
    skip = 1 if case == "odd offset" else 0
    m = size + skip
    keys = rng.integers(0, 1 << 15, m)
    if case == "one register":
        keys = (417 << 6) | rng.integers(0, 64, m)
    elif case == "every key":
        keys = np.arange(m) % (1 << 15)
    rows = rng.random(m) < 0.97
    if case == "all rows masked":
        rows[:] = False
    arrays = (keys.astype(np.uint16), rows, rng.random(m) < 0.6, rng.random(m) < 0.9)
    return tuple(torch.from_numpy(a).to(device)[skip:] for a in arrays)


def hll_stacked_inputs(torch, width: int, n: int, device, skip: int = 0, seed: int = 0) -> tuple:
    """(keys, rows, where, present) of ``width`` sessions x ``n`` rows, each
    ``[W, n]`` and contiguous, starting ``skip`` elements into its
    allocation."""
    rng = np.random.default_rng(seed)
    m = width * n + skip
    arrays = (rng.integers(0, 1 << 15, m).astype(np.uint16), rng.random(m) < 0.97,
              rng.random(m) < 0.6, rng.random(m) < 0.9)
    return tuple(torch.from_numpy(a).to(device)[skip:].view(width, n) for a in arrays)


def hll_battery_inputs(torch, ncols: int, n: int, device, seed: int = 0) -> tuple:
    """(columns, rows) for the battery entry: ``ncols`` columns of ``n``
    rows, every second one with a where-filter, every third one's keys a
    ``[1:]`` view (its arrays then share no tile: one-by-one loads), each
    with nonzero previous registers."""
    from deequ_tpu_torch.kernels.hll_registers import REGISTERS, HllColumn

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    rows = t(rng.random(n) < 0.97)
    columns = []
    for c in range(ncols):
        skip = 1 if c % 3 == 2 else 0
        keys = t(rng.integers(0, 1 << 15, n + skip).astype(np.uint16))[skip:]
        where = t(rng.random(n) < 0.6) if c % 2 else None
        prev = t(rng.integers(0, 21, REGISTERS).astype(np.int32))
        columns.append(HllColumn(keys, t(rng.random(n) < 0.9), where, prev))
    return columns, rows


def check_hll_edges(torch) -> None:
    """K2's entries on what the main path's batches do not reach, each bit
    for bit against its plain version on the card: :data:`HLL_EDGE_CASES`
    with and without a where-filter; W = 1 and 16 sessions of odd n (at
    aligned and odd starts), each session equal to its one-session launch;
    the battery entry over 1, 2, 16 and 33 columns (two launches) of
    nonzero previous registers, with filters and one-by-one columns; and
    the same launch twice (the workspace left zeroed)."""
    from deequ_tpu_torch.kernels.hll_registers import (
        hll_registers, hll_registers_columns, hll_registers_columns_plain, hll_registers_plain,
        hll_registers_stacked, hll_registers_stacked_plain)

    device = torch.device("cuda")
    for case in HLL_EDGE_CASES:
        keys, rows, where, present = hll_edge_inputs(torch, case, device)
        for w in (None, where):
            got = hll_registers(keys, rows, w, present)
            if not torch.equal(got, hll_registers_plain(keys, rows, w, present)):
                raise AssertionError(f"hll_registers differs from the plain version on {case}")
        print(f"[check hll_registers {case}] {keys.shape[0]} rows, bit for bit", flush=True)
    for width, n, skip in ((1, 4097, 0), (16, 4097, 1), (16, 65_537, 0), (16, 65_537, 1)):
        args = hll_stacked_inputs(torch, width, n, device, skip)
        for where in (None, args[2]):
            a = (args[0], args[1], where, args[3])
            got = hll_registers_stacked(*a)
            if not torch.equal(got, hll_registers_stacked_plain(*a)):
                raise AssertionError(f"hll_registers_stacked differs on {width} x {n}")
            for s in range(width):
                one = hll_registers(*(None if x is None else x[s] for x in a))
                if not torch.equal(one, got[s]):
                    raise AssertionError(f"hll_registers_stacked session {s} of {width} x {n} "
                                         "differs from a one-session launch")
        print(f"[check hll_registers_stacked {width} x {n}, start {skip}] bit for bit, each "
              "session its one-session launch", flush=True)
    for ncols, n in ((1, 100_003), (2, 1 << 20), (16, 100_003), (33, 4097)):
        columns, rows = hll_battery_inputs(torch, ncols, n, device)
        want = hll_registers_columns_plain(columns, rows)
        for _ in range(2):
            if not torch.equal(hll_registers_columns(columns, rows), want):
                raise AssertionError(f"hll_registers_columns differs on {ncols} columns")
        print(f"[check hll_registers_columns {ncols} columns x {n} rows] nonzero previous "
              "registers, twice, bit for bit", flush=True)


def _registers_amax(torch, keys, valid, prev=None):
    """One ``scatter_reduce`` amax computing K2's registers of ``[C, n]``
    packed keys (``valid`` masks them) into C x 512 registers, zero or
    ``prev``'s: the library call K2 is timed beside; returns a
    zero-argument call."""
    width = keys.shape[0]
    k = torch.where(valid, keys.to(torch.int32), 0)
    index = (torch.arange(width, device=keys.device)[:, None] * 512
             + (k >> 6).long()).reshape(-1)
    ranks = (k & 63).reshape(-1)
    base = (torch.zeros(width * 512, dtype=torch.int32, device=keys.device) if prev is None
            else prev.reshape(-1).contiguous())
    return lambda: base.scatter_reduce(0, index, ranks, "amax")


def check_kernels(torch, engine, features) -> dict:
    """Hold every kernel launch the main path makes on one batch against
    its plain version, printing each launch's times; returns per kernel the
    summed measurements of one batch's launches."""
    from deequ_tpu_torch.analyzers.base import resolve_slot
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.analyzers.sketches import ApproxCountDistinct, KLLSketch
    from deequ_tpu_torch.kernels.dict_code_counts import dict_code_counts, dict_code_counts_plain
    from deequ_tpu_torch.kernels.hll_registers import (
        hll_registers, hll_registers_columns, hll_registers_columns_plain, hll_registers_plain)
    from deequ_tpu_torch.kernels.scan_reduce import KIND_MOMENTS, scan_reduce, scan_reduce_plain

    rows = features["rows"]
    n = rows.shape[0]
    results = _new_results()
    add = functools.partial(_add, results)

    # K1: one launch per bundle of slots
    for bundle in engine.program.bundles:
        slots = [resolve_slot(spec, features) for spec in bundle]
        ki, kf = scan_reduce(slots, rows)
        pi, pf = scan_reduce_plain(slots, rows)
        torch.cuda.synchronize()
        if not torch.equal(ki, pi):
            raise AssertionError("scan_reduce counts differ from the plain version")
        kf_h, pf_h = kf.cpu().numpy(), pf.cpu().numpy()
        for col in (1, 2):
            a, b = kf_h[:, col], pf_h[:, col]
            same = (np.isnan(a) & np.isnan(b)) | ((a == b) & (np.signbit(a) == np.signbit(b)))
            if not same.all():
                raise AssertionError(f"scan_reduce min/max column {col} differs from the plain version")
        for s, slot in enumerate(slots):
            if slot.vals is None:
                continue
            v = slot.vals.double()
            v = v[torch.isfinite(v)]
            scales = [float(v.abs().sum()), float(v.abs().max()), float((v * v).sum())]
            for col, scale in zip((0, 3, 4), scales):
                a, b = kf_h[s, col], pf_h[s, col]
                if not ((np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12 * max(scale, 1.0)):
                    raise AssertionError(f"scan_reduce slot {s} column {col}: {a!r} vs {b!r}")
        arrays = {id(t): t for slot in slots for t in (slot.where, slot.sel, slot.vals) if t is not None}
        arrays[id(rows)] = rows
        nbytes = sum(t.numel() * t.element_size() for t in arrays.values()) + len(slots) * 7 * 8
        sel = pi[:, 0].cpu().numpy()
        ops = sum(2 * n + (7 * int(sel[s]) if slot.kind == KIND_MOMENTS else 0)
                  for s, slot in enumerate(slots))
        add("scan_reduce", f"{len(slots)} slots", _max_abs_err(kf, pf),
            _time_kernel_ms(torch, lambda: scan_reduce(slots, rows)),
            _time_ms(torch, lambda: scan_reduce_plain(slots, rows)), nbytes, ops)

    # K2: the battery's HLL columns in one launch, as the program makes it,
    # each with nonzero previous registers (the state after one batch)
    hlls = [a for a in engine.scan_analyzers if isinstance(a, ApproxCountDistinct)]
    if hlls:
        empty = [a.init_state(rows.device) for a in hlls]
        states = ApproxCountDistinct.update_columns(hlls, empty, features)
        columns = [a.hll_column(st, features) for a, st in zip(hlls, states)]
        got = hll_registers_columns(columns, rows)
        want = hll_registers_columns_plain(columns, rows)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("hll_registers_columns differs from the plain version")
        if not torch.equal(got, torch.stack([st.registers for st in states])):
            raise AssertionError("registers changed when the same batch folded in again")
        keys = torch.stack([c.keys for c in columns])
        valid = torch.stack([rows & c.present & (rows if c.where is None else c.where)
                             for c in columns])
        prev = torch.stack([c.prev for c in columns])
        arrays = {t.data_ptr(): t for c in columns for t in (c.keys, c.present, c.where)
                  if t is not None}
        arrays[rows.data_ptr()] = rows
        nbytes = sum(t.numel() * t.element_size() for t in arrays.values()) \
            + 2 * len(columns) * 512 * 4
        add("hll_registers_columns", f"{len(columns)} columns, previous registers",
            _max_abs_err(got, want),
            _time_kernel_ms(torch, lambda: hll_registers_columns(columns, rows)),
            _time_ms(torch, lambda: hll_registers_columns_plain(columns, rows)),
            nbytes, 2 * n * len(columns), _time_ms(torch, _registers_amax(torch, keys, valid,
                                                                          prev)))
        # the one-column entry on the first column, with and without a filter
        a = columns[0]
        where = torch.from_numpy(np.random.default_rng(3).random(n) < 0.6).to(rows.device)
        for label, w in (("", None), (", where", where)):
            args = (a.keys, rows, w, a.present)
            one, plain = hll_registers(*args), hll_registers_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(one, plain):
                raise AssertionError(f"hll_registers differs from the plain version{label}")
            mask = rows & a.present & (rows if w is None else w)
            nbytes = sum(t.numel() * t.element_size() for t in args if t is not None) + 512 * 4
            add("hll_registers", f"{hlls[0].column}{label}", _max_abs_err(one, plain),
                _time_kernel_ms(torch, lambda: hll_registers(*args)),
                _time_ms(torch, lambda: hll_registers_plain(*args)), nbytes, 2 * n,
                _time_ms(torch, _registers_amax(torch, a.keys[None], mask[None])))
    for a in engine.scan_analyzers:
        if isinstance(a, DeviceFrequencyScan):
            _check_counts(torch, add, features[f"codes:{a.column}"], rows,
                          features[f"mask:{a.column}"], a.num_categories,
                          dict_code_counts, dict_code_counts_plain, True)
        elif isinstance(a, KLLSketch):
            key = a._where_key()
            _check_kll(torch, add, a.column, a._sketch_size(), features[f"num:{a.column}"], rows,
                       None if key is None else features[key], features[f"mask:{a.column}"])
    # the >48 KB shared-memory path, which the main path's dictionaries skip
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, ATTRIBUTE_PATH_CATEGORIES, n).astype(np.int32)).cuda()
    _check_counts(torch, add, codes, rows, rows, ATTRIBUTE_PATH_CATEGORIES,
                  dict_code_counts, dict_code_counts_plain, False)
    return results


def check_count_paths(torch, rows) -> None:
    """K3 on what the main path's dictionaries do not reach: every valid row
    one code (each warp step one group), K just above one block's shared
    memory (the two-block cluster) and 65,536 + 1 codes (adds into device
    memory), each bit for bit against its plain version, with its time."""
    from deequ_tpu_torch.kernels.dict_code_counts import (
        CLUSTER_MAX_K,
        dict_code_counts,
        dict_code_counts_plain,
        plan_path,
        shared_limit,
        shared_max_k,
    )

    n = rows.shape[0]
    limit = shared_limit(rows.device)
    rng = np.random.default_rng(1)
    cases = [("one hot code", SMALL_CATEGORIES, torch.full((n,), 417, dtype=torch.int32,
                                                          device=rows.device))]
    for k in (shared_max_k(limit) + 1, CLUSTER_MAX_K + 1):
        # k is the sentinel of a null
        codes = torch.from_numpy(rng.integers(0, k + 1, n).astype(np.int32)).to(rows.device)
        cases.append((f"K={k}", k, codes))
    for label, k, codes in cases:
        _check_counts(torch, None, codes, rows, rows, k, dict_code_counts, dict_code_counts_plain,
                      False)
        t = _time_kernel_ms(torch, lambda: dict_code_counts(codes, rows, rows, k))
        print(f"[launch dict_code_counts {label} path={plan_path(k, limit)}] bit for bit; "
              f"ms={t['ms']:.4f}", flush=True)


def _new_results() -> dict:
    return {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
                   "max_abs_err": 0.0, "bound_by": "bytes"}
            for name in TPU_KERNELS}


def _add(results, name, label, err, kernel, plain, nbytes, ops, library=None) -> None:
    """Add one launch's measurements to ``results[name]`` and print them."""
    r = results[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += kernel["ms"]
    r["plain_ms"] += plain["ms"]
    bound, by = _bound_ms(nbytes, ops)
    r["bound_ms"] += bound
    r["bound_by"] = by
    if library is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + library["ms"]
    lib = "None" if library is None else (
        f"{library['ms']:.4f} (queued ahead {library['ahead']}/{library['reps']})")
    print(f"[launch {name} {label}] ms={kernel['ms']:.4f} host_ms={kernel['host_ms']:.4f} "
          f"plain_ms={plain['ms']:.4f} (queued ahead {plain['ahead']}/{plain['reps']}) "
          f"library_ms={lib} bound_ms={bound:.4f} ({by}) bytes={nbytes}", flush=True)


def _same_bits(got, want) -> bool:
    return all(g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes() for g, w in zip(got, want))


def _compact_bytes(sizes: list, level: int, m: int, k: int, width: int) -> int:
    """Bytes K5 must move to append ``m`` items at ``level`` and run the
    cascade on these level sizes: the appended items read and written,
    then per compacted level its n items read, the level rewritten and
    n / 2 items written one level up."""
    sizes = list(sizes)
    nbytes = 8 * m
    sizes[level] = min(sizes[level] + m, width)
    while level < len(sizes) - 1 and sizes[level] > k:
        n = sizes[level]
        nbytes += 4 * n + 4 * n + 4 * (n // 2)
        sizes[level + 1] = min(sizes[level + 1] + n // 2, width)
        sizes[level] = n & 1
        level += 1
    return nbytes


def _merge_bytes(a_sizes, b_sizes, out_sizes) -> int:
    """Bytes K5's merges of stacked sketch pairs must move, from the level
    sizes ``[M, L]`` of both inputs and of the output: each input's live
    items read once and the output's written once, each sketch's sizes
    and parity read from both inputs and written, and its scalars (ticks
    int32, count int64, min and max float64) likewise."""
    items = sum(int(t.sum()) for t in (a_sizes, b_sizes, out_sizes))
    pairs, levels = a_sizes.shape
    return 4 * items + pairs * 3 * (2 * 4 * levels + 4 + 8 + 8 + 8)


def _check_kll(torch, add, label, k, values, rows, where, present) -> None:
    """K4 on one batch of a column, then K5 appending a second sample of it
    to a sketch that already holds the first: the append overflows level h
    and compacts it, as the second batch of the main path does."""
    from deequ_tpu_torch.kernels.kll_compact import kll_compact_update, kll_compact_update_plain
    from deequ_tpu_torch.kernels.kll_sample import F32_MAX, kll_sample, kll_sample_plain
    from deequ_tpu_torch.ops.kll import kll_init, kll_update

    n = values.shape[0]
    state = kll_init(k, device=values.device)
    args = (values, rows, where, present)
    got, want = kll_sample(*args, state.ticks, k), kll_sample_plain(*args, state.ticks, k)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError(f"kll_sample differs from the plain version on {label}")
    keep = rows & present & ~torch.isnan(values)
    if where is not None:
        keep &= where
    items = torch.where(keep, values.clamp(-F32_MAX, F32_MAX), float("inf")).float()
    mask_bytes = n * (2 + (where is not None))
    add("kll_sample", label, _max_abs_err(got.samples, want.samples),
        _time_kernel_ms(torch, lambda: kll_sample(*args, state.ticks, k)),
        _time_ms(torch, lambda: kll_sample_plain(*args, state.ticks, k)),
        8 * n + mask_bytes + 4 * k + 12 + 16, n, _time_ms(torch, lambda: torch.sort(items)))

    state = kll_update(state, *args)
    sample = kll_sample(*args, state.ticks, k)
    got = kll_compact_update(state.tensors(), sample, k)
    want = kll_compact_update_plain(state.tensors(), sample, k)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError(f"kll_compact differs from the plain version on {label}")
    m, h, _ = sample.meta.tolist()
    sizes = state.sizes.tolist()
    level = state.items[h, :sizes[h]].clone()
    level = torch.cat([level, sample.samples[:m]])
    add("kll_compact", f"{label} level {h}: {sizes[h]} + {m} items",
        _max_abs_err(got[0], want[0]),
        _time_kernel_ms(torch, lambda: kll_compact_update(state.tensors(), sample, k)),
        _time_ms(torch, lambda: kll_compact_update_plain(state.tensors(), sample, k)),
        _compact_bytes(sizes, h, m, k, state.items.shape[1]), level.numel(),
        _time_ms(torch, lambda: torch.sort(level)))


def check_kll_edges(torch, values, rows, k: int = KLL_SKETCH_SIZE) -> None:
    """K4 on a batch of signed zeros, NaN, +-inf and values beyond the
    float32 range, and K5 merging the sketch of that batch into the
    sketch of a main-path column: both bit-exact against the plain
    versions. Prints the merge's times, and a profiler trace of K4's and
    K5's launches on the main-path column."""
    from deequ_tpu_torch.kernels.kll_compact import (
        kll_compact_merge,
        kll_compact_merge_plain,
        kll_compact_update,
    )
    from deequ_tpu_torch.kernels.kll_sample import kll_sample, kll_sample_plain
    from deequ_tpu_torch.ops.kll import kll_init, kll_update

    n = values.shape[0]
    rng = np.random.default_rng(7)
    v = rng.normal(0.0, 1.0, n)
    for value, p in ((0.0, 0.1), (-0.0, 0.1), (np.nan, 0.05), (np.inf, 0.01), (-np.inf, 0.01),
                     (1e300, 0.02), (-3.5e38, 0.02)):
        v[rng.random(n) < p] = value
    device = values.device
    edge = torch.from_numpy(v).to(device)
    present = torch.from_numpy(rng.random(n) < 0.9).to(device)
    ticks = torch.tensor(3, dtype=torch.int32, device=device)
    got = kll_sample(edge, rows, None, present, ticks, k)
    want = kll_sample_plain(edge, rows, None, present, ticks, k)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError("kll_sample differs from the plain version on the edge batch")
    a = kll_update(kll_update(kll_init(k, device=device), values, rows), values, rows)
    b = kll_update(kll_init(k, device=device), edge, rows, None, present)
    got = kll_compact_merge(a.tensors(), b.tensors(), k)
    want = kll_compact_merge_plain(a.tensors(), b.tensors(), k)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError("kll_compact's merge differs from the plain version")
    kernel = _time_kernel_ms(torch, lambda: kll_compact_merge(a.tensors(), b.tensors(), k))
    plain = _time_ms(torch, lambda: kll_compact_merge_plain(a.tensors(), b.tensors(), k))
    print(f"[kll edges] kll_sample bit-exact on signed zeros, NaN, +-inf and |v| > f32 max; "
          f"merge of sketches of {a.sizes.tolist()[:12]} and {b.sizes.tolist()[:12]} items "
          f"bit-exact: ms={kernel['ms']:.4f} host_ms={kernel['host_ms']:.4f} "
          f"plain_ms={plain['ms']:.4f}", flush=True)
    # the second batch of the main path: its append overflows level h
    one = kll_update(kll_init(k, device=device), values, rows)
    sample = kll_sample(values, rows, None, None, one.ticks, k)
    trace_kernels(torch, "kll_sample", lambda: kll_sample(values, rows, None, None, one.ticks, k))
    trace_kernels(torch, "kll_compact", lambda: kll_compact_update(one.tensors(), sample, k))


def check_kll_cases(torch, k: int = KLL_SKETCH_SIZE) -> None:
    """Phase 2's adversarial inputs for K4 and K5, each bit for bit against
    the plain version on the card:

    - K4 on the :data:`KLL_COLUMNS` at n in {0, 1, k - 1, k, k + 1, 2^20,
      2^22} rows (2^22: many windows of look-back), two update counters each;
      the constant column at 2^20 rows timed beside the main path's;
    - K5's update, merge (both orders), stacked merge (two pairs) and
      ingest entries on levels of :data:`KLL_RUN_CASES` brought to k,
      k + 1 and 4k items (:func:`run_update_case` and its siblings), at
      k and at k = 8192, whose levels sort in device scratch."""
    from deequ_tpu_torch.kernels.kll_compact import (
        kll_compact_ingest,
        kll_compact_ingest_plain,
        kll_compact_merge,
        kll_compact_merge_plain,
        kll_compact_merge_stacked,
        kll_compact_merge_stacked_plain,
        kll_compact_update,
        kll_compact_update_plain,
    )
    from deequ_tpu_torch.kernels.kll_sample import Sample, kll_sample, kll_sample_plain
    from deequ_tpu_torch.runners.engine import stack_samples

    def cuda(leaves):
        return tuple(t.cuda() for t in leaves)

    checked = 0
    for n in (0, 1, k - 1, k, k + 1, 1 << 20, 1 << 22):
        for case in KLL_COLUMNS:
            v, rows, present = (torch.from_numpy(x).cuda() for x in kll_column(case, n, n + 3))
            for ticks in (0, 2**31 - 1):
                t = torch.tensor(ticks, dtype=torch.int32, device="cuda")
                got = kll_sample(v, rows, None, present, t, k)
                want = kll_sample_plain(v, rows, None, present, t, k)
                torch.cuda.synchronize()
                if not _same_bits(got, want):
                    raise AssertionError(f"kll_sample differs from its plain version on the "
                                         f"{case} column of {n} rows")
                checked += 1
            if case == "constant" and n == 1 << 20:
                items = torch.full((n,), 7.25, dtype=torch.float32, device="cuda")
                _add(_new_results(), "kll_sample", f"constant column, {n} rows", 0.0,
                     _time_kernel_ms(torch, lambda: kll_sample(v, rows, None, present, t, k)),
                     _time_ms(torch, lambda: kll_sample_plain(v, rows, None, present, t, k)),
                     8 * n + 2 * n + 4 * k + 12 + 16, n,
                     _time_ms(torch, lambda: torch.sort(items)))
    print(f"[kll columns] kll_sample bit-exact on {checked} calls: {', '.join(KLL_COLUMNS)} "
          f"at n = 0, 1, k - 1, k, k + 1, 2^20 and 2^22", flush=True)

    checked = 0
    for size in (k, 8192):
        for c, case in enumerate(KLL_RUN_CASES):
            for target in KLL_RUN_TARGETS:
                seed = 100 * c + 10 * target[0] + target[1]
                state, sample = run_update_case(size, case, target, seed)
                state, sample = cuda(state), Sample(*cuda(sample))
                pairs = [(kll_compact_update(state, sample, size),
                          kll_compact_update_plain(state, sample, size))]
                a, b = (cuda(s) for s in run_merge_case(size, case, target, seed))
                pairs += [(kll_compact_merge(x, y, size), kll_compact_merge_plain(x, y, size))
                          for x, y in ((a, b), (b, a))]
                sa = [torch.stack([x, y]) for x, y in zip(a, b)]
                sb = [torch.stack([y, x]) for x, y in zip(a, b)]
                pairs.append((kll_compact_merge_stacked(sa, sb, size),
                              kll_compact_merge_stacked_plain(sa, sb, size)))
                sketches, chunk = run_ingest_case(size, case, target, seed)
                fields = stack_samples(chunk, 4 * size, lambda t: t.cuda())
                got, want = list(cuda(sketches)), list(cuda(sketches))
                kll_compact_ingest(got, fields, size)
                kll_compact_ingest_plain(want, fields, size)
                pairs.append((got, want))
                torch.cuda.synchronize()
                for entry, (g, w) in zip(("update", "merge", "merge (b, a)", "stacked merge",
                                          "ingest"), pairs):
                    if not _same_bits(g, w):
                        raise AssertionError(f"kll_compact's {entry} entry differs from its "
                                             f"plain version on {case} at k = {size}, level "
                                             f"size {target[0]}k + {target[1]}")
                    checked += 1
    print(f"[kll runs] kll_compact bit-exact on {checked} calls of its four entries: "
          f"{', '.join(KLL_RUN_CASES)}; levels of k, k + 1 and 4k items; k = {k} and 8192 "
          f"(device scratch)", flush=True)


def trace_kernels(torch, label: str, fn, calls: int = 10) -> None:
    """Device time per call of each CUDA kernel that ``fn`` launches, from
    torch.profiler's CUDA activity (CUPTI); says so where the profiler
    records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:
        print(f"[trace {label}] torch.profiler failed: {exc}", flush=True)
        return
    events = [(e.key, getattr(e, "device_time_total", 0.0), e.count)
              for e in prof.key_averages()]
    events = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])
    if not events:
        print(f"[trace {label}] torch.profiler recorded no device time", flush=True)
    for key, us, count in events:
        print(f"[trace {label}] {key}: {us / calls / 1e3:.4f} ms in {count / calls:g} "
              "launches per call", flush=True)


def _check_counts(torch, add, codes, rows, present, k, kernel, plain, main_path):
    got, got_rows = kernel(codes, rows, present, k)
    want, want_rows = plain(codes, rows, present, k)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and int(got_rows) == int(want_rows)):
        raise AssertionError(f"dict_code_counts differs from the plain version at K={k}")
    if not main_path:
        return
    n = codes.shape[0]
    keys = torch.where(rows & present & (codes >= 0) & (codes < k), codes, k).long()
    library = _time_ms(torch, lambda: torch.bincount(keys, minlength=k + 1))
    add("dict_code_counts", f"K={k}", _max_abs_err(got, want),
        _time_kernel_ms(torch, lambda: kernel(codes, rows, present, k)),
        _time_ms(torch, lambda: plain(codes, rows, present, k)),
        6 * n + 8 * k + 8, 2 * n, library)
    # the same launch on codes spread evenly over the K codes: the time the
    # skew of the main path's codes adds (atomics on the same few bins)
    even = torch.randint(0, k, (n,), dtype=torch.int32, device=codes.device,
                         generator=torch.Generator(codes.device).manual_seed(0))
    t = _time_kernel_ms(torch, lambda: kernel(even, rows, present, k))
    print(f"[launch dict_code_counts K={k} even codes] ms={t['ms']:.4f}", flush=True)


# ---------------------------------------------------------------------------
# phase 2 for the grouping path: K6 freq_keys and K7 freq_compact
# ---------------------------------------------------------------------------


def _table_features(torch, dq, table: pa.Table, cols: tuple):
    """The first 1M-row batch's features of the device frequency table
    that the runner plans for ``cols`` of ``table``, on the card, and the
    planned scan."""
    from deequ_tpu_torch.analyzers.grouping import plan_table_scan
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    data = dq.Dataset.from_arrow(table)
    scan = plan_table_scan(data.schema, cols, data.num_rows, BATCH_ROWS)
    engine = ScanEngine([scan], torch.device("cuda"))
    batch = next(data.batches(BATCH_ROWS, columns=list(cols)))
    return scan, to_device(engine.builder.build(batch), torch.device("cuda"))


def _check_freq_keys(torch, add, label, columns, rows):
    """K6 on one batch against its plain version (keys and counters bit
    for bit); returns the kernel's keys."""
    from deequ_tpu_torch.kernels.freq_keys import freq_keys, freq_keys_plain

    n = rows.shape[0]
    got_keys = torch.empty(n, dtype=torch.int64, device="cuda")
    want_keys = torch.empty_like(got_keys)
    got = freq_keys(columns, rows, got_keys, 0)
    want = freq_keys_plain(columns, rows, want_keys, 0)
    torch.cuda.synchronize()
    if not (torch.equal(got_keys, want_keys) and torch.equal(got, want)):
        raise AssertionError(f"freq_keys differs from the plain version on {label}")
    nbytes = n + sum(n + c.values.numel() * c.values.element_size() for c in columns) + 8 * n + 16
    # SplitMix64 or a load per column and an xxhash64 per chained column:
    # about 10 and 16 integer operations a row
    ops = n * (10 * len(columns) + 16 * (len(columns) - 1))
    add("freq_keys", f"{label}: {n} rows, {len(columns)} columns, sent_rows={int(got[0])}",
        0.0, _time_kernel_ms(torch, lambda: freq_keys(columns, rows, got_keys, 0)),
        _time_ms(torch, lambda: freq_keys_plain(columns, rows, want_keys, 0)), nbytes, ops)
    return got_keys


def _full_table(torch, start: int, slots: int):
    """A full table of ``slots`` sorted keys: the SplitMix64 keys of the
    integers start .. start + slots - 1, each with a count of 1 to 8."""
    from deequ_tpu_torch.kernels.freq_compact import freq_compact_plain
    from deequ_tpu_torch.ops.hashing import splitmix64_torch

    keys = splitmix64_torch(torch.arange(start, start + slots, dtype=torch.int64, device="cuda"))
    counts = 1 + torch.arange(slots, dtype=torch.int64, device="cuda") % 8
    return freq_compact_plain(keys, counts, slots)


def _check_freq_compact(torch, add, label, a_keys, a_counts, b_keys, b_counts, out_size) -> None:
    """K7 against the reference's compaction in plain PyTorch on the same
    pairs: every output bit for bit."""
    from deequ_tpu_torch.kernels.freq_compact import freq_compact, freq_compact_plain
    from deequ_tpu_torch.ops.hashing import FREQ_KEY_SENTINEL_I64

    counts_b = b_counts if b_counts is not None else (b_keys != FREQ_KEY_SENTINEL_I64).long()
    keys = torch.cat([a_keys, b_keys])
    counts = torch.cat([a_counts, counts_b])
    got = freq_compact(a_keys, a_counts, b_keys, b_counts, out_size)
    want = freq_compact_plain(keys, counts, out_size)
    torch.cuda.synchronize()
    for field, g, w in zip(got._fields, got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"freq_compact {field} differs from the plain version on {label}")
    na, nb = a_keys.shape[0], b_keys.shape[0]
    # pairs read (a buffer's keys alone), the table written, and the scalars
    nbytes = 16 * na + (8 if b_counts is None else 16) * nb + 16 * out_size + 32
    add("freq_compact", f"{label}: {na} + {nb} entries into {out_size}, "
        f"n_unique={int(got.n_unique)} kept={int(got.kept_rows)} total={int(got.total_rows)}",
        0.0, _time_kernel_ms(torch, lambda: freq_compact(a_keys, a_counts, b_keys, b_counts,
                                                         out_size)),
        _time_ms(torch, lambda: freq_compact_plain(keys, counts, out_size)), nbytes, na + nb,
        _time_ms(torch, lambda: torch.sort(keys)))


def check_freq_kernels(torch, dq, grouping: pa.Table, lineitem: pa.Table) -> dict:
    """K6 and K7 at the grouping path's shapes, each bit-exact against its
    plain version; returns the measurements of the main path's launches:
    K6 on the first batch of the bench grouping workload, K7 compacting
    that batch's keys into a full 2^22-slot table. Also checked and
    printed: K6 on lineitem's two-column key and on an edge batch, K7
    merging two full tables and compacting the edge batch's keys."""
    from deequ_tpu_torch.kernels.freq_compact import freq_compact

    results, others = _new_results(), _new_results()
    scan, features = _table_features(torch, dq, grouping, ("k",))
    if scan.resident is not True:
        raise AssertionError(f"the grouping workload should plan resident, got {scan}")
    keys = _check_freq_keys(torch, functools.partial(_add, results), "bench grouping batch 1",
                            scan.key_columns(features), features["rows"])
    table = _full_table(torch, 0, FULL_TABLE_SLOTS)
    _check_freq_compact(torch, functools.partial(_add, results), "non-resident compaction",
                        table.keys, table.counts, keys, None, FULL_TABLE_SLOTS)

    add = functools.partial(_add, others)
    pk_scan, pk = _table_features(torch, dq, lineitem, ("l_orderkey", "l_linenumber"))
    _check_freq_keys(torch, add, "lineitem (l_orderkey, l_linenumber)",
                     pk_scan.key_columns(pk), pk["rows"])
    other = _full_table(torch, FULL_TABLE_SLOTS // 2, FULL_TABLE_SLOTS)
    _check_freq_compact(torch, add, "merge of two full tables", table.keys, table.counts,
                        other.keys, other.counts, FULL_TABLE_SLOTS)

    edge, rows = freq_edge_columns(torch, BATCH_ROWS)
    for width in (1, 2, 5):
        edge_keys = _check_freq_keys(torch, add, f"edge batch, {width} columns", edge[:width],
                                     rows)
        small = _full_table(torch, 0, 1 << 10)
        _check_freq_compact(torch, add, f"edge keys of {width} columns", small.keys,
                            small.counts, edge_keys, None, 1 << 16)
    for case in FREQ_EDGE_CASES:
        check_freq_edge_case(torch, case)
    check_freq_key_edges(torch)
    trace_kernels(torch, "freq_compact",
                  lambda: freq_compact(table.keys, table.counts, keys, None, FULL_TABLE_SLOTS))
    return results


def freq_edge_columns(torch, n: int, seed: int = 5) -> tuple:
    """K6's edge batch of ``n`` rows on the card: the int64 whose
    SplitMix64 is the sentinel (a real key counted in sent_rows), negative
    and narrow integers, booleans, and NaN, -0.0 and 0.0 as xxhash64 keys;
    five key columns and the row mask."""
    from deequ_tpu_torch.data import ColumnKind
    from deequ_tpu_torch.kernels.freq_keys import KIND_HASH, KIND_NUM, KeyColumn
    from deequ_tpu_torch.ops.hashing import hash_column

    rng = np.random.default_rng(seed)
    i64 = rng.integers(-50, 50, n)
    i64[::101] = SENTINEL_PREIMAGE
    f = rng.integers(-20, 20, n) / 4.0
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    fmask = rng.random(n) < 0.97
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    edge = [
        KeyColumn(KIND_NUM, cuda(i64), cuda(rng.random(n) < 0.98)),
        KeyColumn(KIND_NUM, cuda(rng.integers(-128, 128, n).astype(np.int8)), cuda(np.ones(n, bool))),
        KeyColumn(KIND_NUM, cuda(rng.integers(-2**31, 2**31, n).astype(np.int32) // 4096),
                  cuda(np.ones(n, bool))),
        KeyColumn(KIND_NUM, cuda((rng.random(n) < 0.5).astype(np.float64)), cuda(np.ones(n, bool))),
        KeyColumn(KIND_HASH, cuda(hash_column(f, fmask, ColumnKind.FRACTIONAL).view(np.int64)),
                  cuda(fmask)),
    ]
    return edge, cuda(rng.random(n) < 0.99)


#: K6's edge cases, each (columns, rows, out, offset)
FREQ_KEY_EDGE_CASES = ("n = 0", "n = 1", "n = 13", "all rows masked", "odd views", "odd offset",
                       "one-by-one loads", "sentinel row", "i8", "u8", "i16", "i32", "i64",
                       "f64 booleans", "hash")


def freq_key_edge_inputs(torch, case: str, device, n: int = 100_003, seed: int = 0) -> tuple:
    """One of :data:`FREQ_KEY_EDGE_CASES` on ``device``: two key columns
    (int64 with the sentinel's preimage, then int16) of ``n`` rows written
    at offset 0, or ``case``'s: a dtype's one column; "sentinel row" the
    int64 column alone, every seventh valid row keyed as the sentinel; "odd views" every
    input a ``[1:]`` view; "odd offset" the keys at offset 7 of a longer
    buffer (8-byte stores); "one-by-one loads" an int64 column one element
    off its mask (no row aligns every input)."""
    from deequ_tpu_torch.kernels.freq_keys import KIND_HASH, KIND_NUM, KeyColumn

    rng = np.random.default_rng(seed)
    size = {"n = 0": 0, "n = 1": 1, "n = 13": 13}.get(case, n)
    skip = 1 if case == "odd views" else 0
    m = size + skip
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)[skip:]  # noqa: E731
    makers = {
        "i8": lambda: rng.integers(-128, 128, m).astype(np.int8),
        "u8": lambda: rng.integers(0, 256, m).astype(np.uint8),
        "i16": lambda: rng.integers(-2**15, 2**15, m).astype(np.int16),
        "i32": lambda: rng.integers(-2**31, 2**31, m).astype(np.int32),
        "i64": lambda: rng.integers(-(2**63), 2**63 - 1, m, dtype=np.int64),
        "f64 booleans": lambda: (rng.random(m) < 0.5).astype(np.float64),
        "hash": lambda: rng.integers(-(2**63), 2**63 - 1, m, dtype=np.int64),
    }
    if case in makers:
        kind = KIND_HASH if case == "hash" else KIND_NUM
        columns = [KeyColumn(kind, t(makers[case]()), t(rng.random(m) < 0.97))]
    else:
        first = rng.integers(-50, 50, m)
        first[:: 7 if case == "sentinel row" else 101] = SENTINEL_PREIMAGE
        values = t(first)
        if case == "one-by-one loads":
            values = torch.from_numpy(np.concatenate([[0], first])).to(device)[1:]
        columns = [KeyColumn(KIND_NUM, values, t(rng.random(m) < 0.98)),
                   KeyColumn(KIND_NUM, t(rng.integers(-300, 300, m).astype(np.int16)),
                             t(rng.random(m) < 0.97))]
        if case == "sentinel row":
            # one column: the preimage's key is the sentinel itself
            columns = columns[:1]
    rows = t(rng.random(m) < 0.99)
    if case == "all rows masked":
        rows = torch.zeros_like(rows)
    offset = 7 if case == "odd offset" else 0
    out = torch.full((size + offset + 3,), 5, dtype=torch.int64, device=device)
    return columns, rows, out, offset


def check_freq_key_edges(torch) -> None:
    """K6 on each of :data:`FREQ_KEY_EDGE_CASES` against its plain version
    on the card: the whole buffer (keys, and the entries around them
    untouched) and both counters bit for bit, twice (the workspace left
    zeroed)."""
    from deequ_tpu_torch.kernels.freq_keys import freq_keys, freq_keys_plain

    device = torch.device("cuda")
    for case in FREQ_KEY_EDGE_CASES:
        columns, rows, out, offset = freq_key_edge_inputs(torch, case, device)
        want_out = out.clone()
        want = freq_keys_plain(columns, rows, want_out, offset)
        for _ in range(2):
            got = freq_keys(columns, rows, out, offset)
            if not (torch.equal(out, want_out) and torch.equal(got, want)):
                raise AssertionError(f"freq_keys differs from the plain version on {case}")
        print(f"[check freq_keys {case}] {rows.shape[0]} rows, sent_rows={int(got[0])}, "
              f"num_rows={int(got[1])}, bit for bit", flush=True)


def check_freq_edge_case(torch, case: str) -> None:
    """K7 on one of :data:`FREQ_EDGE_CASES` against its plain version on
    the card, every output and meta word bit for bit."""
    from deequ_tpu_torch.kernels.freq_compact import freq_compact, freq_compact_plain

    *arrays, out_size = freq_edge_case(case)
    a_keys, a_counts, b_keys, b_counts = [
        None if x is None else torch.from_numpy(x.view(np.int64)).cuda() for x in arrays]
    counts_b = b_counts if b_counts is not None else (b_keys != -1).long()
    got = freq_compact(a_keys, a_counts, b_keys, b_counts, out_size)
    want = freq_compact_plain(torch.cat([a_keys, b_keys]), torch.cat([a_counts, counts_b]),
                              out_size)
    torch.cuda.synchronize()
    for field, g, w in zip(got._fields, got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"freq_compact {field} differs from the plain version on "
                                 f"the edge case {case!r}")
    print(f"[check freq_compact {case}] {a_keys.shape[0]} + {b_keys.shape[0]} entries into "
          f"{out_size}: n_unique={int(got.n_unique)} kept={int(got.kept_rows)} "
          f"total={int(got.total_rows)}, bit for bit", flush=True)


#: the int64 whose SplitMix64 mix is all ones, the frequency key sentinel
SENTINEL_PREIMAGE = -3487469807577879104


# ---------------------------------------------------------------------------
# phase 5: the grouping path
# ---------------------------------------------------------------------------


def build_grouping(rows: int = GROUPING_ROWS, distinct: int = GROUPING_DISTINCT,
                   seed: int = GROUPING_SEED) -> pa.Table:
    """The bench's grouping workload: ``rows`` int64 keys drawn uniformly
    from ``distinct`` values (tools/grouping_sweep.py measure_point)."""
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, distinct, rows)})


def _count_metrics(counts: np.ndarray, rows: int) -> dict:
    """Uniqueness, CountDistinct and Entropy of a count multiset."""
    p = counts / rows
    return {"Uniqueness": float((counts == 1).sum()) / rows, "CountDistinct": float(len(counts)),
            "Entropy": float(-(p * np.log(p)).sum())}


def _compare_grouping(got: dict, want: dict, rtol: float) -> list:
    problems = []
    for name, w in want.items():
        g = got[name]
        ok = g == w if name != "Entropy" else abs(g - w) <= rtol * abs(w)
        if not ok:
            problems.append(f"{name}: {g!r} != {w!r}")
    return problems


def _timed_run(torch, label: str, run, rows: int, kernels=()) -> tuple:
    """Run ``run(monitor)`` on the card with the launch counts set to 0
    just before; prints rows/s, the phases, launches and peak memory, and
    fails when a kernel of ``kernels`` was not launched."""
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    monitor = dq.RunMonitor()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run(monitor)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    phases = {k: round(v, 4) for k, v in monitor.phase_seconds.items()}
    print(f"[{label}] {rows} rows in {seconds:.3f}s = {rows / seconds:.0f} rows/s; "
          f"passes={monitor.passes} batches={monitor.batches} "
          f"device_freq_sets={monitor.device_freq_sets} "
          f"freq_overflow_fallbacks={monitor.freq_overflow_fallbacks}; launches={launches}; "
          f"peak device memory {peak / 2**20:.1f} MiB; phases={phases}", flush=True)
    missing = [name for name in kernels if launches[name] == 0]
    if missing:
        raise AssertionError(f"{label} launched no {missing}")
    return out, monitor, launches


def grouping_runs(torch, dq, grouping: pa.Table) -> tuple:
    """Phase 5 (a)-(c): the bench grouping workload resident, with a
    non-resident 2^22-slot table, and overflowing a 2^20-slot table; each
    held against (a) on the CPU and a numpy oracle. Returns the launch
    counts of (a) and (b), and (a)'s metrics."""
    rows = grouping.num_rows
    data = dq.Dataset.from_arrow(grouping)
    battery = [dq.Uniqueness(["k"]), dq.CountDistinct(["k"]), dq.Entropy("k")]

    def run(device, **options):
        def go(monitor):
            ctx = (dq.AnalysisRunner.on_data(data, device=device).add_analyzers(battery)
                   .with_batch_size(BATCH_ROWS).with_monitor(monitor)
                   .with_frequency_options(**options).run())
            return {a.name: ctx.metric(a).value.get() for a in battery}
        return go

    expected_batches = -(-rows // BATCH_ROWS)
    resident, mon_a, launches_a = _timed_run(torch, "grouping (a) resident", run("cuda"), rows,
                                             ("freq_keys",))
    if launches_a["freq_keys"] != expected_batches or launches_a["freq_compact"] != 0:
        raise AssertionError(f"(a) expected {expected_batches} freq_keys launches and no "
                             f"freq_compact: {launches_a}")
    if mon_a.device_freq_sets != 1 or mon_a.passes != 1:
        raise AssertionError(f"(a) should run one device table in one pass: {mon_a}")
    t0 = time.perf_counter()
    cpu = run("cpu")(dq.RunMonitor())
    print(f"[cpu] grouping (a) on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    _, counts = np.unique(grouping["k"].to_numpy(), return_counts=True)
    oracle = _count_metrics(counts, rows)
    problems = _compare_grouping(resident, cpu, 0.0) + _compare_grouping(resident, oracle, 1e-9)

    compacting, mon_b, launches_b = _timed_run(
        torch, "grouping (b) non-resident", run("cuda", freq_buffer_entries=FULL_TABLE_SLOTS),
        rows, FREQ_KERNELS)
    # no fallback pass: the drain found lost_rows == 0
    if mon_b.freq_overflow_fallbacks != 0 or mon_b.passes != 1:
        raise AssertionError(f"(b) should keep every group in one pass: {mon_b}")
    problems += [f"(b) {p}" for p in _compare_grouping(compacting, resident, 0.0)]

    overflowing, mon_c, _ = _timed_run(
        torch, "grouping (c) overflow", run("cuda", freq_table_slots=OVERFLOW_TABLE_SLOTS,
                                            freq_buffer_entries=FULL_TABLE_SLOTS),
        rows, FREQ_KERNELS)
    if mon_c.freq_overflow_fallbacks != 1 or mon_c.passes != 2:
        raise AssertionError(f"(c) should overflow and re-run on the host once: {mon_c}")
    problems += [f"(c) {p}" for p in _compare_grouping(overflowing, resident, 0.0)]
    if problems:
        raise AssertionError("grouping metrics disagree:\n" + "\n".join(problems))
    print(f"[grouping metrics] (a), (b) and (c) agree with the CPU run and the oracle: "
          f"{resident}", flush=True)
    return {"resident": launches_a, "compaction": launches_b}, resident


def build_lineitem_check(dq, rows: int):
    """Lineitem's key checks (phase 5 d): its primary key, distinctness
    and entropy of keys and measures, the comment dictionary, and scan
    checks beside them."""
    yes = lambda _: True  # noqa: E731 - the values are compared, not asserted
    return (
        dq.Check(dq.CheckLevel.ERROR, "lineitem keys")
        .has_size(lambda n: n == rows)
        .is_primary_key("l_orderkey", "l_linenumber")
        .has_uniqueness(["l_partkey"], yes)
        .has_entropy("l_suppkey", yes)
        .has_distinctness(["l_extendedprice"], yes)
        .has_number_of_distinct_values("l_comment", yes)
        .has_unique_value_ratio(["l_comment"], yes)
        .is_complete("l_orderkey")
        .has_mean("l_quantity", yes)
        .is_non_negative("l_discount")
        .has_approx_count_distinct("l_partkey", yes)
        .is_contained_in("l_returnflag", ["A", "N", "R"])
    )


def lineitem_oracle(table: pa.Table) -> dict:
    """The lineitem checks' grouping metrics from pandas value counts."""
    import pandas as pd

    n = table.num_rows
    df = table.select(["l_orderkey", "l_linenumber", "l_partkey", "l_suppkey",
                       "l_extendedprice"]).to_pandas()
    pk = df.groupby(["l_orderkey", "l_linenumber"]).size().to_numpy()
    part = df["l_partkey"].value_counts().to_numpy()
    supp = df["l_suppkey"].value_counts().to_numpy()
    price = df["l_extendedprice"].value_counts(dropna=False).to_numpy()
    codes = table["l_comment"].combine_chunks().indices.to_numpy()
    comment = np.bincount(codes)
    comment = comment[comment > 0]
    p = supp / n
    return {
        ("Uniqueness", "l_orderkey,l_linenumber", None): (pk == 1).sum() / n,
        ("Uniqueness", "l_partkey", None): (part == 1).sum() / n,
        ("Entropy", "l_suppkey", None): float(-(p * np.log(p)).sum()),
        ("Distinctness", "l_extendedprice", None): len(price) / n,
        ("UniqueValueRatio", "l_comment", None): (comment == 1).sum() / len(comment),
        ("Size", "*", None): float(n),
        "comment bins": len(comment),
    }


#: BASELINE config 1: the five items of examples/example_utils.py
SAMPLE_ITEMS = (
    (1, "Thingy A", "awesome thing.", "high", 0),
    (2, "Thingy B", "available at http://thingb.com", None, 0),
    (3, None, None, "low", 5),
    (4, "Thingy D", "checkout https://thingd.ca", "low", 10),
    (5, "Thingy E", None, "high", 12),
)


def basic_example(dq, device: str, monitor=None):
    """examples/basic_example.py's verification on ``device``."""
    names = ("id", "productName", "description", "priority", "numViews")
    types = (pa.int64(), pa.string(), pa.string(), pa.string(), pa.int64())
    table = pa.table({name: pa.array([item[i] for item in SAMPLE_ITEMS], type=t)
                      for i, (name, t) in enumerate(zip(names, types))})
    return (
        dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device=device)
        .add_check(
            dq.Check(dq.CheckLevel.ERROR, "integrity checks")
            .has_size(lambda size: size == 5)
            .is_complete("id")
            .is_unique("id")
            .is_complete("productName")
            .is_contained_in("priority", ["high", "low"])
            .is_non_negative("numViews"))
        .add_check(
            dq.Check(dq.CheckLevel.WARNING, "distribution checks")
            .contains_url("description", lambda ratio: ratio >= 0.5)
            .has_approx_quantile("numViews", 0.5, lambda median: median <= 10))
        .with_monitor(monitor or dq.RunMonitor())
        .run()
    )


def _statuses(result) -> list:
    return [(r.status, [c.status for c in r.constraint_results])
            for r in result.check_results.values()]


def grouping_path(torch, dq, lineitem: pa.Table) -> tuple:
    """Phase 2 at the grouping path's shapes, then phase 5 (a)-(e).
    Returns the K6 and K7 measurements and the launch counts of the runs
    that report them."""
    t0 = time.perf_counter()
    grouping = build_grouping()
    print(f"[grouping data] {grouping.num_rows} rows, {GROUPING_DISTINCT} possible keys in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    with phase(2):
        measured = check_freq_kernels(torch, dq, grouping, lineitem)
        _print_kernel_totals(measured, FREQ_KERNELS, "grouping path")
    launches, resident = grouping_runs(torch, dq, grouping)
    # phase 17 (d): the same workload over a mesh, while it is in memory
    with phase(17), part_seconds("phase 17 (d)"):
        mesh_grouping(torch, dq, grouping, resident)
    del grouping

    # (d) lineitem's keys through VerificationSuite
    rows = lineitem.num_rows
    data = dq.Dataset.from_arrow(lineitem)
    check = build_lineitem_check(dq, rows)

    def verify(device):
        return lambda monitor: (dq.VerificationSuite.on_data(data, device=device)
                                .add_check(check).with_monitor(monitor).run())

    result, monitor, _ = _timed_run(torch, "grouping (d) lineitem keys", verify("cuda"), rows,
                                    VERIFICATION_KERNELS + ("freq_keys",))
    if monitor.device_freq_sets != 4 or monitor.passes != 1:
        raise AssertionError(f"(d) should run four device tables in one pass: {monitor}")
    t0 = time.perf_counter()
    cpu_result = verify("cpu")(dq.RunMonitor())
    print(f"[cpu] lineitem keys on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    gpu_metrics = metric_values(result)
    problems = compare_metrics(gpu_metrics, metric_values(cpu_result))
    want = lineitem_oracle(lineitem)
    bins = want.pop("comment bins")
    problems += compare_oracle(gpu_metrics, want)
    got_bins = gpu_metrics[("Histogram", "l_comment", None)][0]
    if got_bins != bins:
        problems.append(f"l_comment histogram: {got_bins} bins, oracle {bins}")
    if _statuses(result) != _statuses(cpu_result):
        problems.append(f"check statuses differ: {_statuses(result)}")
    if problems:
        raise AssertionError("lineitem metrics disagree:\n" + "\n".join(problems))
    print(f"[lineitem metrics] {len(gpu_metrics)} metrics agree with the CPU run and the "
          f"oracle; check status {result.status.value}", flush=True)
    del result, cpu_result

    # (e) BasicExample
    example, _, _ = _timed_run(torch, "grouping (e) BasicExample",
                               lambda monitor: basic_example(dq, "cuda", monitor),
                               len(SAMPLE_ITEMS),
                               ("freq_keys",))
    cpu_example = basic_example(dq, "cpu")
    problems = compare_metrics(metric_values(example), metric_values(cpu_example))
    if _statuses(example) != _statuses(cpu_example) or problems:
        raise AssertionError(f"BasicExample differs from its CPU run: {problems}")
    print(f"[basic example] status {example.status.value}, equal to the CPU run", flush=True)
    return measured, launches


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 6: the incremental path, BASELINE config 4
# ---------------------------------------------------------------------------

#: BASELINE config 4: two day partitions of 50M rows of the JAX bench's
#: scan table (bench.py build_scan_data, seed 42), batches of 1M
INCREMENTAL_PARTITION_ROWS = 50_000_000
INCREMENTAL_PARTITIONS = 2
#: the CPU comparison runs the same phase at 2 x 5M rows
INCREMENTAL_CPU_PARTITION_ROWS = 5_000_000
INCREMENTAL_SEED = 42
#: months of day partitions: the N of state_fold's every-kind check
MONTH_OF_DAYS = 32


def build_scan_data(rows: int, seed: int = INCREMENTAL_SEED) -> pa.Table:
    """``bench.py build_scan_data``: x0-x3 normal (mean 100 i, sd 10) with
    5% nulls and ``cat``, int64 over 100,000 values; plus the second
    battery's columns: ``grade``, a dictionary of 100 categories
    (cat // 1000), and ``x3n``, x3 with NaN where cat % 97 == 0."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(4):
        vals = rng.normal(100 * i, 10, rows)
        nulls = rng.random(rows) < 0.05
        cols[f"x{i}"] = pa.array(vals, mask=nulls)
    cat = rng.integers(0, 100_000, rows)
    cols["cat"] = pa.array(cat)
    cols["grade"] = pa.DictionaryArray.from_arrays(
        pa.array((cat // 1000).astype(np.int32)), pa.array([f"g{i:02d}" for i in range(100)]))
    x3 = cols["x3"].to_numpy(zero_copy_only=False).copy()
    x3[cat % 97 == 0] = np.nan
    cols["x3n"] = pa.array(x3, mask=np.asarray(cols["x3"].is_null()))
    return pa.table(cols)


def incremental_battery(dq) -> list:
    """The bench's config-4 battery (bench.py run_incremental_stage)."""
    return [dq.Size(), dq.Completeness("x0"), dq.Mean("x0"), dq.Mean("x1"),
            dq.ApproxCountDistinct("cat"), dq.KLLSketch("x0")]


def every_state_battery(dq) -> list:
    """(e): every other persistable state type over the same partitions."""
    return [dq.Correlation("x0", "x1"), dq.StandardDeviation("x2"), dq.Minimum("x3n"),
            dq.Maximum("x3n"), dq.Mean("x3n"), dq.DataType("x2"), dq.Histogram("grade"),
            dq.Uniqueness(["cat"]), dq.KLLSketch("x1")]


def context_values(context) -> dict:
    """Metric values of an AnalyzerContext keyed like :func:`oracle`; a
    histogram as its bins, a KLL sketch as its buckets and items."""
    out = {}
    for analyzer, metric in context.metric_map.items():
        if metric.value.is_failure:
            out[metric_key(analyzer)] = ("failure", str(metric.value.exception))
            continue
        value = metric.value.get()
        if hasattr(value, "buckets"):
            value = (tuple((b.low_value, b.high_value, b.count) for b in value.buckets),
                     tuple(map(tuple, value.data)))
        elif hasattr(value, "values"):
            value = (value.number_of_bins, {k: v.absolute for k, v in value.values.items()})
        out[metric_key(analyzer)] = value
    return out


def kll_percentiles(data) -> list:
    """The 100 percentiles of a sketch from its compactor items (level l
    items weigh 2^l): for each q the first item whose cumulative weight
    reaches q of the total."""
    items = np.concatenate([np.asarray(level, dtype=np.float64) for level in data])
    weights = np.concatenate([np.full(len(level), 2.0 ** lvl) for lvl, level in enumerate(data)])
    order = np.argsort(items, kind="stable")
    items, cum = items[order], np.cumsum(weights[order])
    qs = np.arange(1, 101) / 100
    idx = np.minimum(np.searchsorted(cum, qs * cum[-1], "left"), len(items) - 1)
    return items[idx].tolist()


def incremental_oracle(table: pa.Table) -> tuple:
    """numpy's exact answers for both batteries over ``table``, keyed like
    :func:`oracle`, and the sorted float32-rounded valid values of x0 and
    x1 (the KLL sketches' rank oracle)."""
    def valid(name):
        arr = table[name].combine_chunks()
        return arr.to_numpy(zero_copy_only=False), np.asarray(arr.is_valid())

    n = table.num_rows
    x0, m0 = valid("x0")
    x1, m1 = valid("x1")
    x2, m2 = valid("x2")
    x3n, m3 = valid("x3n")
    cat = table["cat"].to_numpy()
    both = m0 & m1
    xc, yc = x0[both] - x0[both].mean(), x1[both] - x1[both].mean()
    v3 = x3n[m3]
    counts = np.bincount(cat)
    grade = np.bincount(table["grade"].combine_chunks().indices.to_numpy(), minlength=100)
    out = {
        ("Size", "*", None): float(n),
        ("Completeness", "x0", None): m0.mean(),
        ("Mean", "x0", None): x0[m0].mean(),
        ("Mean", "x1", None): x1[m1].mean(),
        ("Correlation", "x0,x1", None): (xc * yc).sum() / np.sqrt((xc * xc).sum() * (yc * yc).sum()),
        ("StandardDeviation", "x2", None): x2[m2].std(),
        ("Minimum", "x3n", None): np.nanmin(v3),
        ("Maximum", "x3n", None): np.max(v3),  # a NaN value wins the max
        ("Mean", "x3n", None): v3.mean(),  # NaN
        ("Uniqueness", "cat", None): (counts == 1).sum() / n,
    }
    exact = {
        ("DataType", "x2", None): (5, {"Unknown": int(n - m2.sum()), "Fractional": int(m2.sum()),
                                        "Integral": 0, "Boolean": 0, "String": 0}),
        ("Histogram", "grade", None): (100, {f"g{i:02d}": int(c) for i, c in enumerate(grade)}),
        "distinct cat": int((counts > 0).sum()),
    }
    ranks = {c: np.sort(v[m].astype(np.float32)) for c, v, m in (("x0", x0, m0), ("x1", x1, m1))}
    return out, exact, ranks


def check_incremental_oracle(values: dict, table: pa.Table,
                             rank_limit: float = 2 * KLL_RELATIVE_ERROR,
                             battery_only: bool = False, truth=None) -> tuple:
    """Differences between merged metrics and numpy over the whole table:
    counts, min, max, histograms, type counts exactly; means, the standard
    deviation and the correlation within 1e-9; the HLL estimate within
    three standard errors of the exact distinct count (1.04 / sqrt(512));
    each KLL percentile within ``rank_limit`` in rank (twice the sketch's
    relative error). ``values`` holds both batteries' metrics, or with
    ``battery_only`` the first battery's alone; ``truth`` is
    :func:`incremental_oracle`'s answer when the caller has it. Returns
    (problems, largest rank error)."""
    out, exact, ranks = incremental_oracle(table) if truth is None else truth
    if battery_only:
        out = {k: v for k, v in out.items() if k in values}
    problems = compare_oracle({k: v for k, v in values.items() if k in out}, out)
    for key, want in exact.items():
        if key == "distinct cat":
            got = values[("ApproxCountDistinct", "cat", None)]
            if abs(got - want) > 3 * 1.04 / math.sqrt(512) * want:
                problems.append(f"ApproxCountDistinct(cat) {got} vs {want} distinct")
        elif key in values and values[key] != want:
            problems.append(f"{key}: {values[key]!r}, oracle {want!r}")
    worst = 0.0
    for col in ("x0", "x1"):
        key = ("KLLSketch", col, None)
        if key not in values:
            continue
        buckets, data = values[key]
        if sum(b[2] for b in buckets) != len(ranks[col]):
            problems.append(f"{key}: buckets do not add up to {len(ranks[col])}")
        errors = [_rank_error(ranks[col], x, (i + 1) / 100)
                  for i, x in enumerate(kll_percentiles(data))]
        worst = max(worst, max(errors))
        if max(errors) > rank_limit:
            problems.append(f"{key}: percentile rank error {max(errors)}")
    return problems, worst


def _state_bytes(providers, analyzers) -> int:
    from deequ_tpu_torch.analyzers.states import leaves

    total = 0
    for provider in providers:
        for a in analyzers:
            state = provider.load(a)
            if hasattr(state, "frequencies"):
                total += int(state.frequencies.memory_usage(index=True, deep=True))
            elif state is not None:
                total += sum(t.numel() * t.element_size() for t in leaves(state))
    return total


def partition_runs(torch, dq, table: pa.Table, rows: int, analyzers: list, device: str,
                   label: str, kernels=(), placement=None) -> tuple:
    """Run every day partition with ``save_states_with`` (one in-memory
    provider per partition) and an in-memory metrics repository keyed by
    day, on the ingest tier ``placement``. On the card each run is timed;
    returns the providers, the repository and the last run's launches."""
    from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey

    providers, repo, launches = [], InMemoryMetricsRepository(), {}
    for p in range(table.num_rows // rows):
        part = dq.Dataset.from_arrow(table.slice(p * rows, rows))
        sp = InMemoryStateProvider()

        def run(monitor, part=part, sp=sp, p=p):
            return dq.AnalysisRunner.do_analysis_run(
                part, analyzers, save_states_with=sp, metrics_repository=repo,
                save_or_append_results_with_key=ResultKey(p, {"day": str(p)}),
                batch_size=BATCH_ROWS, device=device, monitor=monitor, placement=placement)

        if device == "cuda":
            _, _, launches = _timed_run(torch, f"{label} day {p}", run, rows, kernels)
        else:
            run(dq.RunMonitor())
        providers.append(sp)
    return providers, repo, launches


def merged_run(torch, dq, schema, analyzers: list, providers: list, device: str,
               label: str, kernels=()) -> tuple:
    """``run_on_aggregated_states`` over ``providers``: on the card timed
    (with the state bytes merged, the phases, launches and peak memory)."""
    def run(monitor):
        return dq.AnalysisRunner.run_on_aggregated_states(schema, analyzers, providers,
                                                          device=device, monitor=monitor)

    if device != "cuda":
        return run(dq.RunMonitor()), {}
    nbytes = _state_bytes(providers, analyzers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    monitor = dq.RunMonitor()
    reset_launch_counts()
    t0 = time.perf_counter()
    ctx = run(monitor)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    phases = {k: round(v, 6) for k, v in monitor.phase_seconds.items()}
    print(f"[{label}] merged {len(providers)} partitions' states of {len(analyzers)} "
          f"analyzers ({nbytes} state bytes) in {seconds * 1e3:.3f} ms; passes={monitor.passes}; "
          f"launches={launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; phases={phases}", flush=True)
    missing = [name for name in kernels if launches[name] == 0]
    if missing or monitor.passes:
        raise AssertionError(f"{label} launched no {missing} or read data: {monitor}")
    return ctx, launches


def anomaly_days(dq, table: pa.Table, repo, rows: int, device: str) -> tuple:
    """(c): a steady day and a quarter-size day against the partitions'
    history, anomaly checks on Size and Mean(x1)."""
    from deequ_tpu_torch.anomalydetection import RelativeRateOfChangeStrategy
    from deequ_tpu_torch.repository import ResultKey

    def day(n, key):
        return (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table.slice(0, n)),
                                             device=device)
                .with_batch_size(BATCH_ROWS).use_repository(repo)
                .save_or_append_result(ResultKey(key, {"day": str(key)}))
                .add_anomaly_check(RelativeRateOfChangeStrategy(
                    max_rate_increase=1.5, max_rate_decrease=0.5), dq.Size())
                .add_anomaly_check(RelativeRateOfChangeStrategy(
                    max_rate_increase=1.1, max_rate_decrease=0.9), dq.Mean("x1"))
                .run())

    days = INCREMENTAL_PARTITIONS
    steady, quarter = day(rows, days), day(rows // 4, days + 1)
    if steady.status != dq.CheckStatus.SUCCESS or quarter.status == dq.CheckStatus.SUCCESS:
        raise AssertionError(f"anomaly checks: steady day {steady.status}, quarter-size day "
                             f"{quarter.status}")
    return steady.status.value, quarter.status.value


def persisted_merge(dq, schema, analyzers: list, providers: list, device: str) -> dict:
    """(d): the partitions' states through FileSystemStateProviders in a
    temporary directory, loaded by fresh providers and merged."""
    import shutil
    import tempfile

    from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider

    root = tempfile.mkdtemp(prefix="chip-smoke-states-")
    try:
        t0 = time.perf_counter()
        for p, provider in enumerate(providers):
            store = FileSystemStateProvider(f"{root}/day{p}")
            for a in analyzers:
                store.persist(a, provider.load(a))
        written = time.perf_counter() - t0
        fresh = [FileSystemStateProvider(f"{root}/day{p}") for p in range(len(providers))]
        t0 = time.perf_counter()
        ctx = dq.AnalysisRunner.run_on_aggregated_states(schema, analyzers, fresh, device=device)
        loaded = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[incremental (d)] persisted {len(providers)} partitions x {len(analyzers)} states "
          f"in {written:.3f}s; loaded and merged in {loaded:.3f}s", flush=True)
    return ctx


def check_fold_kernels(torch, dq, providers: list, analyzers: list, features) -> dict:
    """Phase 2 for K8 and K1's co-moment slot: K8 at N = 2 on config 4's
    partition states and at N = 32 on every state kind, bit for bit
    against its plain version, beside ``torch.amax`` over the stacked HLL
    registers; K1 with one co-moment slot over two 1M-row float64 columns
    against its plain version."""
    from deequ_tpu_torch.analyzers.base import (
        fold_layout,
        pack_states,
        resolve_slot,
        unpack_states,
    )
    from deequ_tpu_torch.kernels.scan_reduce import scan_reduce, scan_reduce_plain
    from deequ_tpu_torch.kernels.state_fold import fold_bytes, state_fold, state_fold_plain

    results = _new_results()
    add = functools.partial(_add, results)
    layout = fold_layout()
    config4 = [[p.load(a) for p in providers] for a in analyzers
               if type(providers[0].load(a)) in layout]
    month = [states for _, states in fold_groups(dq, MONTH_OF_DAYS, 11)]
    for label, jobs in (("config 4, N=2", config4), (f"every kind, N={MONTH_OF_DAYS}", month)):
        mats, slots, places = pack_states(jobs, layout)
        mats = [m.cuda() for m in mats]
        got = state_fold(*mats, slots)
        want = state_fold_plain(*mats, slots)
        torch.cuda.synchronize()
        for g, w in zip(unpack_states(jobs, places, got), unpack_states(jobs, places, want)):
            if not same_state_bits(g, w):
                raise AssertionError(f"state_fold differs from its plain version ({label})")
        library = _time_ms(torch, lambda: torch.amax(mats[2], dim=0))
        ops = sum(m.numel() for m in mats)
        add("state_fold", label, 0.0, _time_kernel_ms(torch, lambda: state_fold(*mats, slots)),
            _time_ms(torch, lambda: state_fold_plain(*mats, slots)), fold_bytes(*mats), ops,
            library)
        if label.startswith("config 4"):
            main = dict(results["state_fold"])
    # the row of the kernels line: config 4's launch
    results["state_fold"] = main
    for n in (1, 2 * MONTH_OF_DAYS):
        jobs = [states for _, states in fold_groups(dq, n, 13 + n)]
        mats, slots, _ = pack_states(jobs, layout)
        mats = [m.cuda() for m in mats]
        got, want = state_fold(*mats, slots), state_fold_plain(*mats, slots)
        torch.cuda.synchronize()
        if not same_tensor_bits(got, want):
            raise AssertionError(f"state_fold differs from its plain version at N={n}")
        print(f"[check state_fold every kind, N={n}] bit for bit", flush=True)

    rows = features["rows"]
    spec = dq.Correlation("x0", "x1").scan_slot()
    slots = [resolve_slot(spec, features)]
    ki, kf = scan_reduce(slots, rows)
    pi, pf = scan_reduce_plain(slots, rows)
    torch.cuda.synchronize()
    if not torch.equal(ki, pi):
        raise AssertionError("the co-moment slot's count differs from the plain version")
    x, y = slots[0].vals, slots[0].vals2
    xx, yy = float((x * x).sum()), float((y * y).sum())
    scales = (float(x.abs().max()), float(y.abs().max()), math.sqrt(xx * yy), xx, yy)
    for col, scale in enumerate(scales):
        a, b = float(kf[0, col]), float(pf[0, col])
        if abs(a - b) > 1e-12 * max(scale, 1.0):
            raise AssertionError(f"co-moment slot column {col}: {a!r} vs {b!r}")
    n = rows.shape[0]
    sel = int(pi[0, 0])
    comoment = _new_results()
    _add(comoment, "scan_reduce", "co-moment slot", _max_abs_err(kf, pf),
         _time_kernel_ms(torch, lambda: scan_reduce(slots, rows)),
         _time_ms(torch, lambda: scan_reduce_plain(slots, rows)),
         19 * n + 7 * 8, 3 * n + 12 * sel)
    _print_kernel_totals(comoment, ["scan_reduce"], "co-moment slot")
    _print_kernel_totals(results, ["state_fold"], "incremental path")
    return results


def incremental_metrics(torch, dq, table: pa.Table, rows: int, device: str) -> dict:
    """Phase 6 (a), (b) and (e) without timings: the merged metrics of both
    batteries over ``table`` cut in partitions of ``rows``, on ``device``."""
    schema = dq.Dataset.from_arrow(table.slice(0, 1)).schema
    out = {}
    for analyzers in (incremental_battery(dq), every_state_battery(dq)):
        providers, _, _ = partition_runs(torch, dq, table, rows, analyzers, device,
                                         "incremental check")
        out.update(context_values(merged_run(torch, dq, schema, analyzers, providers,
                                             device, "incremental check")[0]))
    return out


def incremental_path(torch, dq, seed: int) -> tuple:
    """Phase 6 (with phase 2's K8 and co-moment checks at its shapes).
    Returns the K8 measurements and the launches of the merged refresh."""
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    rows = INCREMENTAL_PARTITION_ROWS
    t0 = time.perf_counter()
    table = build_scan_data(rows * INCREMENTAL_PARTITIONS, INCREMENTAL_SEED + seed)
    print(f"[incremental data] {INCREMENTAL_PARTITIONS} x {rows} rows in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    schema = dq.Dataset.from_arrow(table.slice(0, 1)).schema
    battery = incremental_battery(dq)

    # (a) the day partitions, (b) the merged refresh, twice (the first run
    # loads the kernel libraries)
    providers, repo, _ = partition_runs(torch, dq, table, rows, battery, "cuda",
                                        "incremental (a)",
                                        ("scan_reduce", "hll_registers_columns", "kll_sample",
                                         "kll_compact"))
    merged_run(torch, dq, schema, battery, providers, "cuda", "incremental (b) first",
               INCREMENTAL_KERNELS)
    merged, launches = merged_run(torch, dq, schema, battery, providers, "cuda",
                                  "incremental (b)", INCREMENTAL_KERNELS)
    values = context_values(merged)
    if values[("Size", "*", None)] != float(rows * INCREMENTAL_PARTITIONS):
        raise AssertionError(f"merged Size {values[('Size', '*', None)]}")

    # phase 2 at this path's shapes
    with phase(2):
        engine = ScanEngine([dq.Correlation("x0", "x1")], torch.device("cuda"))
        first = next(dq.Dataset.from_arrow(table.slice(0, BATCH_ROWS)).batches(BATCH_ROWS))
        features = to_device(engine.builder.build(first), torch.device("cuda"))
        measured = check_fold_kernels(torch, dq, providers, battery, features)
        del features

    # (c) anomaly checks over the day history
    statuses = anomaly_days(dq, table, repo, rows, "cuda")
    print(f"[incremental (c)] steady day {statuses[0]}, quarter-size day {statuses[1]}",
          flush=True)

    # (d) through files: the same metrics bit for bit
    again = context_values(persisted_merge(dq, schema, battery, providers, "cuda"))
    if repr(again) != repr(values):
        raise AssertionError("metrics merged from persisted files differ from (b)'s")

    # phase 7 (b): the same days on the host tier, refreshed with these
    truth = incremental_oracle(table)
    with phase(7):
        host_problems = host_tier_partitions(torch, dq, table, rows, providers, truth)
    if host_problems:
        raise AssertionError("host tier (b) disagrees with the oracle:\n"
                             + "\n".join(host_problems))
    del providers, repo

    # (e) every persistable state type: partitions, merged, one full pass
    second = every_state_battery(dq)
    providers2, _, _ = partition_runs(torch, dq, table, rows, second, "cuda", "incremental (e)",
                                      ("scan_reduce", "dict_code_counts"))
    merged2, _ = merged_run(torch, dq, schema, second, providers2, "cuda", "incremental (e)",
                            ("state_fold", "kll_compact"))
    del providers2
    values2 = context_values(merged2)
    full = {}

    def full_run(monitor):
        full.update(context_values(dq.AnalysisRunner.do_analysis_run(
            dq.Dataset.from_arrow(table), second, batch_size=BATCH_ROWS, device="cuda",
            monitor=monitor)))

    _timed_run(torch, "incremental (e) full table", full_run, rows * INCREMENTAL_PARTITIONS,
               ("scan_reduce",))
    exact_keys = [k for k in values2 if k[0] != "KLLSketch"]
    problems = compare_metrics({k: values2[k] for k in exact_keys},
                               {k: full[k] for k in exact_keys}, 1e-12)
    oracle_problems, worst = check_incremental_oracle({**values, **values2}, table, truth=truth)
    problems += oracle_problems

    # (f) the same two days through the partition store and the delta planner
    with part_seconds("phase 6 (f)"):
        partitioned_path(torch, dq, table, rows, values, truth[2]["x0"], seed)
    del table, truth

    # the same phase on the CPU, at 2 x 5M rows, against the card
    small = build_scan_data(INCREMENTAL_CPU_PARTITION_ROWS * INCREMENTAL_PARTITIONS,
                            INCREMENTAL_SEED + seed)
    t0 = time.perf_counter()
    cpu = incremental_metrics(torch, dq, small, INCREMENTAL_CPU_PARTITION_ROWS, "cpu")
    print(f"[cpu] phase 6 at 2 x {INCREMENTAL_CPU_PARTITION_ROWS} rows on the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gpu = incremental_metrics(torch, dq, small, INCREMENTAL_CPU_PARTITION_ROWS, "cuda")
    problems += [f"cpu vs card: {p}" for p in compare_metrics(gpu, cpu, 1e-12)]
    if problems:
        raise AssertionError("incremental metrics disagree:\n" + "\n".join(problems))
    # (f) at this size on the CPU and the card; (g) the profiler and the
    # suggestions on stored states
    with part_seconds("phase 6 (f) cpu vs card"):
        partitioned_small(torch, dq, small, INCREMENTAL_CPU_PARTITION_ROWS, seed)
    with part_seconds("phase 6 (g)"):
        stored_profiles_path(torch, dq, small)
    print(f"[incremental metrics] (b), (d) and (e) agree with the full-table run, the oracle "
          f"and the CPU run; largest KLL percentile rank error {worst:.6f} (limit "
          f"{2 * KLL_RELATIVE_ERROR:.6f}); Size {values[('Size', '*', None)]}", flush=True)
    return measured, launches


@contextlib.contextmanager
def part_seconds(label: str):
    """Print the wall seconds of one part of a phase (the parts this
    script added after its first slices, so their cost stays visible)."""
    t0 = time.perf_counter()
    yield
    print(f"[seconds] {label}: {time.perf_counter() - t0:.1f}s", flush=True)


#: wall seconds by phase, each phase's own: a phase run inside another
#: pauses the outer one's clock
PHASE_SECONDS: dict = {}
_PHASE_STACK: list = []


@contextlib.contextmanager
def phase(n: int):
    """Charge the enclosed wall time to phase ``n`` and, when it ends, fail
    the run if any run of it recovered from a fault: the port's
    process-wide tally of failovers, OOM bisections, isolation re-runs,
    stalls, shard losses and degradations (``recovery_counts``) must
    still be 0 and empty. A fault drill asserts its own recoveries and
    clears them (:func:`drill`), so a recovery no drill injected fails the
    script."""
    now = time.perf_counter()
    if _PHASE_STACK:
        outer = _PHASE_STACK[-1]
        PHASE_SECONDS[outer[0]] = PHASE_SECONDS.get(outer[0], 0.0) + now - outer[1]
    _PHASE_STACK.append([n, now])
    try:
        yield
    finally:
        now = time.perf_counter()
        _, start = _PHASE_STACK.pop()
        PHASE_SECONDS[n] = PHASE_SECONDS.get(n, 0.0) + now - start
        if _PHASE_STACK:
            _PHASE_STACK[-1][1] = now
    assert_no_recoveries(f"phase {n}")


def assert_no_recoveries(label: str) -> None:
    """Fail unless no run since the tally's last reset recovered."""
    from deequ_tpu_torch.runners.engine import recovery_counts

    found = {k: v for k, v in recovery_counts().items() if v}
    if found:
        raise AssertionError(f"{label}: runs recovered from faults that no drill injected: "
                             f"{found}")


@contextlib.contextmanager
def drill(label: str):
    """A fault drill: it asserts the recoveries it counts itself; the
    tally is clean before it and cleared after it."""
    from deequ_tpu_torch.runners.engine import reset_recovery_counts

    assert_no_recoveries(f"before {label}")
    try:
        yield
    finally:
        reset_recovery_counts()


def print_phase_seconds(total: float) -> None:
    """The ``[seconds] phase N`` lines of every phase and the total."""
    for n in range(1, 20):
        print(f"[seconds] phase {n}: {PHASE_SECONDS.get(n, 0.0):.1f}s", flush=True)
    print(f"[seconds] total: {total:.1f}s", flush=True)


# ---------------------------------------------------------------------------
# phase 6 (f) and (g): partition-aware incremental verification and the
# profiler and suggestions on stored states
# ---------------------------------------------------------------------------

#: phase 6 (f): the day the table grows by, on the card and in the CPU
#: comparison (whose days are INCREMENTAL_CPU_PARTITION_ROWS)
GROWTH_DAY_ROWS = 1_000_000
CPU_GROWTH_DAY_ROWS = 100_000
#: phase 6 (g): the two days the profiler and the suggestions read
PROFILE_DAY_ROWS = 1_000_000
#: the scan kernels of a config-4 partition (the merge adds state_fold)
PARTITION_SCAN_KERNELS = ("scan_reduce", "hll_registers_columns", "kll_sample", "kll_compact")
#: phase 6 (f)'s steps: (step, incoming partitions, their version tokens,
#: the partitions it must scan, whether dropped partitions are deleted)
PARTITION_STEPS = (
    ("cold", ("day1", "day2"), {"day1": "v1", "day2": "v1"}, ["day1", "day2"], False),
    ("warm", ("day1", "day2"), {"day1": "v1", "day2": "v1"}, [], False),
    ("growth", ("day1", "day2", "day3"), {"day1": "v1", "day2": "v1", "day3": "v1"},
     ["day3"], False),
    ("changed token", ("day1", "day2", "day3"), {"day1": "v1", "day2": "v2", "day3": "v1"},
     ["day2"], False),
    ("dropped", ("day2", "day3"), {"day2": "v2", "day3": "v1"}, [], True),
)


def partitioned_check(dq):
    """Phase 6 (f)'s check over the config-4 battery."""
    return (dq.Check(dq.CheckLevel.ERROR, "config 4 partitions")
            .has_size(lambda n: n > 0)
            .has_completeness("x0", lambda c: c > 0.9)
            .has_mean("x0", lambda v: abs(v) < 1.0)
            .has_mean("x1", lambda v: 90.0 < v < 110.0)
            .has_approx_count_distinct("cat", lambda c: c > 1_000))


def _unread(name: str):
    """A payload that fails when it is read: a reused partition's data is
    never touched."""
    def payload():
        raise AssertionError(f"partition {name}'s payload was read, but its states were stored")

    return payload


def partition_sequence(torch, dq, days: dict, device: str, label: str) -> list:
    """Phase 6 (f)'s five steps over ``days`` (three day tables) through
    ``VerificationSuite.on_partitions`` with a ``PartitionStateStore`` in a
    temporary directory, on ``device``: cold, warm (same tokens), growth
    (a third day), a changed token (day2) and a dropped partition (day1,
    deleted). Checks each step's plan, rows scanned and, on the card, its
    launches; prints its seconds, rows scanned and launches. Returns per
    step its metric values, seconds and rows scanned."""
    import shutil
    import tempfile

    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.repository import PartitionStateStore

    root = tempfile.mkdtemp(prefix="chip-smoke-partitions-")
    store = PartitionStateStore(root)
    battery = incremental_battery(dq)
    on_card = device == "cuda"
    out = {}
    try:
        for step, names, tokens, scans, drop in PARTITION_STEPS:
            payloads = {n: dq.Dataset.from_arrow(days[n]) if n in scans else _unread(n)
                        for n in names}
            monitor = dq.RunMonitor()
            builder = (dq.VerificationSuite.on_partitions(store, "events", payloads,
                                                          checksums=tokens, device=device)
                       .add_check(partitioned_check(dq)).add_required_analyzers(battery)
                       .with_batch_size(BATCH_ROWS).with_monitor(monitor))
            if drop:
                builder = builder.delete_dropped_partitions()
            if on_card:
                torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            result = builder.run()
            if on_card:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: v for k, v in launch_counts().items() if v}
            report, plan = result.incremental, result.incremental.plan
            print(f"[{label} {step}] {seconds:.3f}s; {report.rows_scanned} of "
                  f"{report.rows_total} rows scanned; scan={plan.scan} reuse={plan.reuse} "
                  f"invalidated={plan.invalidated} dropped={plan.dropped} rolled_up="
                  f"{monitor.partitions_rolled_up}; status {result.status.value}; "
                  f"launches={launches}", flush=True)
            problems = []
            if plan.scan != list(scans) or report.rows_scanned != sum(days[n].num_rows
                                                                      for n in scans):
                problems.append(f"scanned {plan.scan} ({report.rows_scanned} rows)")
            if result.status != dq.CheckStatus.SUCCESS:
                problems.append(f"status {result.status.value}")
            if step == "growth" and monitor.partitions_rolled_up != 2:
                problems.append(f"{monitor.partitions_rolled_up} partitions rolled up, not 2")
            if step == "changed token" and plan.reasons.get("day2") != "content-changed":
                problems.append(f"day2 re-scanned for {plan.reasons.get('day2')!r}")
            if step == "dropped" and (plan.dropped != ["day1"]
                                      or store.list_partitions("events") != ["day2", "day3"]):
                problems.append(f"dropped {plan.dropped}; the store lists "
                                f"{store.list_partitions('events')}")
            if on_card and scans:
                missing = [k for k in PARTITION_SCAN_KERNELS + ("state_fold",)
                           if not launches.get(k)]
                if missing:
                    problems.append(f"launched no {missing}")
            if on_card and not scans and launches.get("scan_reduce"):
                problems.append("a step without scans launched scan_reduce")
            if problems:
                raise AssertionError(f"{label} {step}: " + "; ".join(problems))
            out[step] = (context_values(dq.AnalyzerContext(result.metrics)), seconds,
                         report.rows_scanned)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def battery_parts(table: pa.Table, x0_sorted=None) -> dict:
    """Additive pieces of numpy's answers for the config-4 battery over
    ``table``: rows, valid counts and sums of x0 and x1, the counts of each
    ``cat`` value and the sorted float32-rounded valid x0 (``x0_sorted``
    when the caller has it)."""
    def valid(name):
        arr = table[name].combine_chunks()
        mask = np.asarray(arr.is_valid())
        return arr.to_numpy(zero_copy_only=False)[mask]

    x0, x1 = valid("x0"), valid("x1")
    return {
        "rows": table.num_rows, "n0": len(x0), "s0": float(x0.sum()), "n1": len(x1),
        "s1": float(x1.sum()), "cat": np.bincount(table["cat"].to_numpy(), minlength=100_000),
        "x0": np.sort(x0.astype(np.float32)) if x0_sorted is None else x0_sorted,
    }


def check_battery_oracle(values: dict, parts: list,
                         rank_limit: float = 2 * KLL_RELATIVE_ERROR) -> list:
    """Differences between the config-4 battery's metrics and numpy over
    the tables ``parts`` describe (:func:`battery_parts`): Size exactly,
    completeness and means within 1e-9, the HLL estimate within three
    standard errors, each KLL percentile within ``rank_limit`` in rank."""
    rows = sum(p["rows"] for p in parts)
    n0, n1 = sum(p["n0"] for p in parts), sum(p["n1"] for p in parts)
    want = {("Size", "*", None): float(rows), ("Completeness", "x0", None): n0 / rows,
            ("Mean", "x0", None): sum(p["s0"] for p in parts) / n0,
            ("Mean", "x1", None): sum(p["s1"] for p in parts) / n1}
    problems = compare_oracle({k: values[k] for k in want}, want)
    distinct = int((sum(p["cat"] for p in parts) > 0).sum())
    got = values[("ApproxCountDistinct", "cat", None)]
    if abs(got - distinct) > 3 * 1.04 / math.sqrt(512) * distinct:
        problems.append(f"ApproxCountDistinct(cat) {got} vs {distinct} distinct")
    buckets, data = values[("KLLSketch", "x0", None)]
    if sum(b[2] for b in buckets) != n0:
        problems.append(f"KLLSketch(x0) buckets do not add up to {n0}")
    worst = 0.0
    for i, x in enumerate(kll_percentiles(data)):
        q, v = (i + 1) / 100, np.float32(x)
        lo = sum(np.searchsorted(p["x0"], v, "left") for p in parts) / n0
        hi = sum(np.searchsorted(p["x0"], v, "right") for p in parts) / n0
        worst = max(worst, 0.0 if lo <= q <= hi else float(min(abs(q - lo), abs(q - hi))))
    if worst > rank_limit:
        problems.append(f"KLLSketch(x0) percentile rank error {worst}")
    return problems


def partitioned_path(torch, dq, table: pa.Table, rows: int, merged: dict, x0_sorted,
                     seed: int) -> list:
    """Phase 6 (f) on the card over phase 6's two days: (1) cold, equal to
    (b)'s merged metrics bit for bit (the sketch within the rank limit of
    numpy's); (2) warm, no payload read, equal to (1) bit for bit; (3)
    growth by ``GROWTH_DAY_ROWS``, against numpy over the three days; (4)
    day2's token changed, equal to (3) bit for bit; (5) day1 dropped,
    against numpy over day2 and day3. Returns the steps' seconds and rows
    scanned."""
    day3 = build_scan_data(GROWTH_DAY_ROWS, INCREMENTAL_SEED + seed + 1)
    days = {"day1": table.slice(0, rows), "day2": table.slice(rows, rows), "day3": day3}
    steps = partition_sequence(torch, dq, days, "cuda", "incremental (f)")
    kll = ("KLLSketch", "x0", None)
    full = battery_parts(table, x0_sorted)
    grown = [full, battery_parts(day3)]
    cold, warm, growth, changed, dropped = (steps[s][0] for s, *_ in PARTITION_STEPS)
    problems = [f"cold vs (b): {p}" for p in compare_metrics(_without(cold, kll),
                                                              _without(merged, kll), 0.0)]
    problems += [f"cold: {p}" for p in check_battery_oracle(cold, [full])]
    problems += [f"warm vs cold: {p}" for p in compare_metrics(warm, cold, 0.0)]
    problems += [f"growth: {p}" for p in check_battery_oracle(growth, grown)]
    problems += [f"changed token vs growth: {p}"
                 for p in compare_metrics(changed, growth, 0.0)]
    problems += [f"dropped: {p}" for p in check_battery_oracle(
        dropped, [battery_parts(days["day2"]), grown[1]])]
    if problems:
        raise AssertionError("incremental (f) disagrees:\n" + "\n".join(problems))
    cost = steps["growth"][1] / steps["cold"][1]
    print(f"[incremental (f) metrics] cold = (b) bit for bit (KLL sketch equal: "
          f"{cold[kll] == merged[kll]}), warm = cold, changed token = growth bit for bit; "
          f"growth, dropped and cold hold numpy's answers; the growth run cost {cost:.4f} of "
          f"the cold run", flush=True)
    return [(s, steps[s][1], steps[s][2]) for s, *_ in PARTITION_STEPS]


def partitioned_small(torch, dq, small: pa.Table, rows: int, seed: int) -> None:
    """Phase 6 (f) at 2 x ``rows`` + ``CPU_GROWTH_DAY_ROWS`` on the CPU and
    on the card: every step's plan and metrics equal (moments within
    1e-12)."""
    days = {"day1": small.slice(0, rows), "day2": small.slice(rows, rows),
            "day3": build_scan_data(CPU_GROWTH_DAY_ROWS, INCREMENTAL_SEED + seed + 1)}
    t0 = time.perf_counter()
    cpu = partition_sequence(torch, dq, days, "cpu", "incremental (f) cpu")
    print(f"[cpu] phase 6 (f) at 2 x {rows} + {CPU_GROWTH_DAY_ROWS} rows on the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gpu = partition_sequence(torch, dq, days, "cuda", "incremental (f) small")
    problems = [f"{step}: {p}" for step in cpu
                for p in compare_metrics(gpu[step][0], cpu[step][0])]
    if problems:
        raise AssertionError("incremental (f) cpu vs card:\n" + "\n".join(problems))


def stored_profiles(torch, dq, small: pa.Table, device: str) -> tuple:
    """Phase 6 (g) on ``device``: ``profile_partitioned`` and
    ``suggest_partitioned`` (the default rules) twice each over two
    ``PROFILE_DAY_ROWS``-row days of ``small``, each in its own store
    dataset; the second call of each reads no payload and equals the
    first. Returns the profile's values and the suggestions' JSON."""
    import shutil
    import tempfile

    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.repository import PartitionStateStore
    from deequ_tpu_torch.runners.incremental import profile_partitioned, suggest_partitioned
    from deequ_tpu_torch.suggestions import Rules

    days = {f"day{d + 1}": small.slice(d * PROFILE_DAY_ROWS, PROFILE_DAY_ROWS) for d in range(2)}
    tokens = {name: "v1" for name in days}
    root = tempfile.mkdtemp(prefix="chip-smoke-profiles-")
    store = PartitionStateStore(root)
    on_card = device == "cuda"
    got = {}
    try:
        for what, run in (
            ("profile", lambda p: profile_partitioned(store, "profile", p, checksums=tokens,
                                                      batch_size=BATCH_ROWS, device=device)),
            ("suggestions", lambda p: suggest_partitioned(store, "suggest", p, Rules.DEFAULT,
                                                          checksums=tokens,
                                                          batch_size=BATCH_ROWS, device=device)),
        ):
            outs = []
            for call in ("first", "second"):
                payloads = ({n: dq.Dataset.from_arrow(t) for n, t in days.items()}
                            if call == "first" else {n: _unread(n) for n in days})
                if on_card:
                    torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                value, report = run(payloads)
                if on_card:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = {k: v for k, v in launch_counts().items() if v}
                print(f"[incremental (g) {what} {call} on {device}] {seconds:.3f}s; "
                      f"{report.rows_scanned} of {report.rows_total} rows scanned; "
                      f"launches={launches}", flush=True)
                if call == "second" and not report.plan.fully_reused:
                    raise AssertionError(f"{what}'s second call re-scanned {report.plan.scan}")
                if on_card and call == "first":
                    missing = [k for k in PARTITION_SCAN_KERNELS + ("dict_code_counts",
                                                                   "state_fold")
                               if not launches.get(k)]
                    if missing:
                        raise AssertionError(f"incremental (g) {what} launched no {missing}")
                outs.append(profile_values(value) if what == "profile" else value.to_json())
            if repr(outs[0]) != repr(outs[1]):
                raise AssertionError(f"incremental (g): the reused {what} differs from the first")
            got[what] = outs[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return got["profile"], got["suggestions"]


def compare_stored_profiles(got: dict, want: dict, rtol: float = 1e-12) -> list:
    """:func:`compare_profiles` for profiles with NaN values (config 4's
    ``x3n``): NaN equals NaN, the means, sums and standard deviations agree
    within ``rtol`` relative and every other field is equal in its repr
    (bit for bit)."""
    def same(g, w, moment):
        if isinstance(g, float) and isinstance(w, float):
            if math.isnan(g) or math.isnan(w):
                return math.isnan(g) and math.isnan(w)
            if moment:
                return abs(g - w) <= rtol * max(abs(w), 1e-300)
        return repr(g) == repr(w)

    if list(got) != list(want):
        return [f"different columns: {list(got)} vs {list(want)}"]
    problems = [] if got["__records__"] == want["__records__"] else ["records differ"]
    for name in list(want)[1:]:
        problems += [f"{name}.{field}: {str(got[name][field])[:200]} != {str(w)[:200]}"
                     for field, w in want[name].items()
                     if not same(got[name][field], w, field in MOMENT_FIELDS)]
    return problems


def stored_profiles_path(torch, dq, small: pa.Table) -> None:
    """Phase 6 (g): the card's profiles and suggestions on stored states
    against the same calls on ``device="cpu"``."""
    profile, suggestions = stored_profiles(torch, dq, small, "cuda")
    t0 = time.perf_counter()
    cpu_profile, cpu_suggestions = stored_profiles(torch, dq, small, "cpu")
    print(f"[cpu] phase 6 (g) on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    problems = compare_stored_profiles(profile, cpu_profile)
    if suggestions != cpu_suggestions:
        problems.append("the suggestions' JSON differs from the CPU run's")
    if problems:
        raise AssertionError("incremental (g) cpu vs card:\n" + "\n".join(problems))
    print(f"[incremental (g) metrics] {len(profile) - 1} column profiles and "
          f"{len(json.loads(suggestions)['constraint_suggestions'])} suggestions equal the CPU "
          f"run's and their own reused calls", flush=True)


# ---------------------------------------------------------------------------
# the host ingest tier: phase 2's checks of K8's carry entry and K5's
# ingest entry, and phase 7
# ---------------------------------------------------------------------------


def host_partial_rows(dq, battery: list, data, batch_rows: int, n: int):
    """The host ingest tier's view of the first ``n`` batches of ``data``:
    its ``HostIngest`` on the card and each batch's packed partials (the
    non-KLL states as three host rows, the KLL samples)."""
    import torch

    from deequ_tpu_torch.analyzers.base import HostBatchContext
    from deequ_tpu_torch.runners.engine import HostIngest

    ingest = HostIngest(battery, torch.device("cuda"))
    token = object()
    packed = []
    for index, batch in enumerate(data.batches(batch_rows, pad_to_batch_size=False)):
        if index == n:
            break
        ctx = HostBatchContext(batch, batch_index=index, run_token=token)
        packed.append(ingest.pack([a.host_partial(ctx) for a in battery]))
    return ingest, packed


def check_carry_kernel(torch, dq, data, battery: list) -> dict:
    """Phase 2 for K8's carry entry at the host tier's chunk shape: the
    carry of config 2's battery (its identity states) and the host
    partials of 32 batches of 2^18 rows, 33 rows of state, bit for bit
    against the plain version, beside ``torch.amax`` of the stacked
    registers plus ``torch.sum`` of the stacked counts."""
    from deequ_tpu_torch.kernels.state_fold import state_fold_carry, state_fold_carry_plain

    results = _new_results()
    ingest, packed = host_partial_rows(dq, battery, data, HOST_BATCH_ROWS, CHUNK)
    parts = [torch.stack([rows[d] for rows, _ in packed]).cuda() for d in range(3)]
    got = [c.clone() for c in ingest.carry]
    want = [c.clone() for c in ingest.carry]
    state_fold_carry(got, parts, ingest.slots)
    state_fold_carry_plain(want, parts, ingest.slots)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError("state_fold's carry entry differs from its plain version")
    scratch = [c.clone() for c in ingest.carry]
    nbytes = sum(p.numel() * p.element_size() + 2 * c.numel() * c.element_size()
                 for p, c in zip(parts, ingest.carry))
    _add(results, "state_fold_carry",
         f"config 2's battery, {len(ingest.slots)} slots, 1 + {len(packed)} rows", 0.0,
         _time_kernel_ms(torch, lambda: state_fold_carry(scratch, parts, ingest.slots)),
         _time_ms(torch, lambda: state_fold_carry_plain(scratch, parts, ingest.slots)),
         nbytes, sum(p.numel() for p in parts),
         _time_ms(torch, lambda: (torch.amax(parts[2], dim=0), torch.sum(parts[1], dim=0))))
    _print_kernel_totals(results, ["state_fold_carry"], "host tier, config 2")
    return results


def _ingest_bytes(sizes: list, samples: list, k: int, width: int) -> tuple:
    """Bytes and sorted items of K5's ingest of ``samples`` into a sketch
    with these level sizes: each sample's m float64 items read and m
    float32 items written, then the cascade's levels as
    :func:`_compact_bytes` counts them."""
    sizes = list(sizes)
    nbytes = items = 0
    for _, m, h, *_ in samples:
        level = min(int(h), len(sizes) - 1)
        nbytes += 12 * m + 40
        sizes[level] = min(sizes[level] + m, width)
        while level < len(sizes) - 1 and sizes[level] > k:
            n = sizes[level]
            nbytes += 4 * n + 4 * n + 4 * (n // 2)
            items += n
            sizes[level + 1] = min(sizes[level + 1] + n // 2, width)
            sizes[level] = n & 1
            level += 1
    return nbytes, items


def _ingest_chunk(dq, data, sketches: list, batch_rows: int, n: int) -> list:
    """The host samples the host tier folds into ``sketches`` in their first
    chunk: of the first ``n`` batches of ``batch_rows`` rows, ``[S][n]``."""
    _, packed = host_partial_rows(dq, sketches, data, batch_rows, n)
    return [[kll[j] for _, kll in packed] for j in range(len(sketches))]


def _kll_controls(chunk: list) -> dict:
    """Faulty versions of a chunk of host samples, for the rank limit's
    control: odd samples folded one level too high; the second half of the
    samples dropped; each sample's items replaced by its lower half, each
    item twice (a sampler that sees only the smaller half of a batch)."""
    def shifted(row):
        return [(it, m, h + (b % 2), nv, lo, hi) for b, (it, m, h, nv, lo, hi) in enumerate(row)]

    def lower(row):
        out = []
        for items, m, h, nv, lo, hi in row:
            low = np.full_like(items, np.inf)
            low[:2 * (m // 2)] = np.repeat(items[:m // 2], 2)
            out.append((low, 2 * (m // 2), h, nv, lo, hi))
        return out

    return {"odd samples at h + 1": [shifted(row) for row in chunk],
            "second half dropped": [row[:max(1, len(row) // 2)] for row in chunk],
            "lower half of each sample": [lower(row) for row in chunk]}


def check_ingest_kernels(torch, dq, data, table: pa.Table, battery: list) -> tuple:
    """Phase 2 for K5's ingest entry, each chunk stacked into fresh sketches
    and held bit for bit against the plain version:

    - the chunk phase 7 (c) folds: the host samples of config 3's numeric
      columns over the profile's batches of 2^20 rows (one chunk of 10 a
      sketch at 10M rows); timed beside ``torch.sort`` of one 4,096-item
      level, the ``kernels`` line's numbers. Its sketches must equal (c)'s
      bit for bit, so their compactor items are returned;
    - a full chunk of 32 samples of 2^18-row batches, timed;
    - an edge chunk (m = 0, m = 2k, h = 0, +-inf and beyond the float32
      range);
    - the rank limit's controls (:func:`_kll_controls` of (c)'s chunk):
      each one's largest percentile rank error is printed, and the biased
      sample must exceed ``HOST_KLL_RANK_LIMIT``.

    Returns the measurements and (c)'s compactor items by column."""
    from deequ_tpu_torch.analyzers.sketches import KLLSketch
    from deequ_tpu_torch.kernels.kll_compact import kll_compact_ingest, kll_compact_ingest_plain
    from deequ_tpu_torch.ops.kll import KLLSketchState, compactor_buffers, kll_init
    from deequ_tpu_torch.runners.engine import stack_samples

    results = _new_results()
    sketches = [a for a in battery if isinstance(a, KLLSketch)]
    k = sketches[0]._sketch_size()
    width = 4 * k
    batches = min(CHUNK, -(-data.num_rows // BATCH_ROWS))

    def fresh(n):
        return [torch.stack(list(col)).contiguous()
                for col in zip(*(kll_init(k, device="cuda").tensors() for _ in range(n)))]

    def ingest(chunk, label):
        fields = stack_samples(chunk, width, lambda t: t.cuda())
        got, want = fresh(len(chunk)), fresh(len(chunk))
        kll_compact_ingest(got, fields, k)
        kll_compact_ingest_plain(want, fields, k)
        torch.cuda.synchronize()
        if not _same_bits(got, want):
            raise AssertionError(f"kll_compact's ingest entry differs from its plain version "
                                 f"({label})")
        return fields, got, want

    def timed(into, chunk, label):
        fields, got, want = ingest(chunk, label)
        zero = [0] * got[1].shape[1]
        nbytes = ops = 0
        for row in chunk:
            b, n = _ingest_bytes(zero, row, k, width)
            nbytes, ops = nbytes + b, ops + n
        scratch = fresh(len(chunk))
        level = torch.from_numpy(np.tile(chunk[0][0][0][:2 * k], 2)).float().cuda()
        _add(into, "kll_compact_ingest", label, _max_abs_err(got[0], want[0]),
             _time_kernel_ms(torch, lambda: kll_compact_ingest(scratch, fields, k)),
             _time_ms(torch, lambda: kll_compact_ingest_plain(fresh(len(chunk)), fields, k),
                      reps=5, warmup=1),
             nbytes, ops, _time_ms(torch, lambda: torch.sort(level)))
        return got

    def sketch_states(leaves):
        return [KLLSketchState(*(leaf[i] for leaf in leaves), sketch_size=k)
                for i in range(leaves[0].shape[0])]

    # phase 7 (c)'s chunk: the kernels line's numbers
    chunk = _ingest_chunk(dq, data, sketches, BATCH_ROWS, batches)
    got = timed(results, chunk, f"phase 7 (c)'s chunk: {len(sketches)} numeric columns x "
                                f"{batches} samples of {BATCH_ROWS} rows")
    sound = {a.column: compactor_buffers(s) for a, s in zip(sketches, sketch_states(got))}
    # a full chunk of 32
    timed(_new_results(), _ingest_chunk(dq, data, sketches, HOST_BATCH_ROWS, CHUNK),
          f"a full chunk: {len(sketches)} numeric columns x {CHUNK} samples of "
          f"{HOST_BATCH_ROWS} rows")
    edges = ingest([edge_samples(k, CHUNK, 17)], "edge chunk")[1]
    print(f"[kll ingest edges] bit-exact on m in {{0, {2 * k}}}, h = 0 to 6, +-inf and "
          f"|v| > f32 max; level sizes {edges[1][0].tolist()[:10]}", flush=True)

    # the rank limit's controls, ranked as the profile ranks its percentiles
    ranks = {}
    for a in sketches:
        v = table[a.column].combine_chunks().to_numpy(zero_copy_only=False).astype(np.float64)
        ranks[a.column] = np.sort(np.clip(v, -3.4028234663852886e38,
                                          3.4028234663852886e38).astype(np.float32))

    def worst_rank(leaves):
        worst = 0.0
        for a, state in zip(sketches, sketch_states(leaves)):
            q = sorted(a.compute_metric_from(state).value.get().compute_percentiles())
            worst = max(worst, max(_rank_error(ranks[a.column], x, (i + 1) / 100)
                                   for i, x in enumerate(q)))
        return worst

    readings = {"sound": worst_rank(got)}
    for label, faulty in _kll_controls(chunk).items():
        readings[label] = worst_rank(ingest(faulty, f"control: {label}")[1])
    del ranks
    print(f"[kll rank limit] largest percentile rank error over {len(sketches)} columns of "
          f"(c)'s chunk: {json.dumps(readings)} (limit {HOST_KLL_RANK_LIMIT})", flush=True)
    if readings["sound"] > HOST_KLL_RANK_LIMIT or \
            readings["lower half of each sample"] <= HOST_KLL_RANK_LIMIT:
        raise AssertionError(f"the rank limit does not part the sound chunk from the biased "
                             f"one: {readings}")
    _print_kernel_totals(results, ["kll_compact_ingest"], "host tier, config 3")
    return results, sound


def _host_tier_report(label: str, monitor) -> None:
    print(f"[{label}] placement={monitor.placement} ingest_folds={monitor.ingest_folds} "
          f"pattern routes={monitor.pattern_routes}", flush=True)
    if monitor.placement != "host" or not monitor.ingest_folds:
        raise AssertionError(f"{label} did not run on the host tier: {monitor}")


def host_tier_verification(torch, dq, table: pa.Table, rows: int, device_metrics: dict) -> dict:
    """Phase 7 (a): BASELINE config 2 (phase 3's table and checks) with
    ``with_placement("host")`` and an ApproxQuantile of ``a``, in batches
    of 2^18 rows; held against phase 3's device-tier metrics (counts
    exact, moments within 1e-12), against the same run on
    ``device="cpu"`` bit for bit, and against the numpy oracle (the
    quantile within ``HOST_KLL_RANK_LIMIT`` in rank). Then once more in
    phase 3's batches of 2^20 rows, timed beside phase 3 like for like and
    held against its metrics. Returns the first run's launches and the
    second run's metrics and check statuses (phase 9 holds its mesh runs
    against them)."""
    quantile = dq.ApproxQuantile("a", 0.5, KLL_RELATIVE_ERROR)

    def run(monitor, device="cuda", batch_rows=HOST_BATCH_ROWS, checkpointer=None):
        builder = (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device=device)
                   .add_check(build_check(dq, rows))
                   .add_required_analyzers([dq.CountDistinct("cat_large"), quantile])
                   .with_batch_size(batch_rows).with_placement("host").with_monitor(monitor))
        if checkpointer is not None:
            builder = builder.checkpoint_with(checkpointer)
        return builder.run()

    def against_device_tier(metrics):
        return compare_metrics({k: v for k, v in metrics.items() if k in device_metrics},
                               device_metrics)

    result, monitor, launches = _timed_run(torch, "host tier (a)", run, rows, HOST_KERNELS)
    _host_tier_report("host tier (a)", monitor)
    gpu = metric_values(result)
    t0 = time.perf_counter()
    cpu = metric_values(run(dq.RunMonitor(), "cpu"))
    print(f"[cpu] host tier (a) on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    problems = [f"cpu: {p}" for p in compare_metrics(gpu, cpu, 0.0)]
    problems += [f"device tier: {p}" for p in against_device_tier(gpu)]
    problems += compare_oracle(gpu, oracle(table))
    a = table["a"].combine_chunks()
    ranked = np.sort(a.to_numpy(zero_copy_only=False)[np.asarray(a.is_valid())]
                     .astype(np.float32))
    error = _rank_error(ranked, gpu[metric_key(quantile)], 0.5)
    if error > HOST_KLL_RANK_LIMIT:
        problems.append(f"ApproxQuantile(a, 0.5) rank error {error}")
    # phase 11 (b): the same run interrupted and resumed from a checkpoint
    with phase(11), part_seconds("phase 11 (b)"):
        resumable_host_tier(torch, dq, lambda m, c: run(m, checkpointer=c), gpu)
    same, monitor, _ = _timed_run(torch, f"host tier (a) in batches of {BATCH_ROWS} rows",
                                  lambda m: run(m, batch_rows=BATCH_ROWS), rows, HOST_KERNELS)
    _host_tier_report(f"host tier (a) in batches of {BATCH_ROWS} rows", monitor)
    problems += [f"2^20-row batches, device tier: {p}"
                 for p in against_device_tier(metric_values(same))]
    if problems:
        raise AssertionError("host tier (a) disagrees:\n" + "\n".join(problems))
    print(f"[host tier (a) metrics] {len(gpu)} metrics equal the CPU run bit for bit, phase 3's "
          f"device tier and the oracle; median rank error {error:.6f} (limit "
          f"{HOST_KLL_RANK_LIMIT}); in 2^20-row batches equal to phase 3's device tier",
          flush=True)
    return launches, metric_values(same), _statuses(same)


def host_tier_partitions(torch, dq, table: pa.Table, rows: int, device_providers: list,
                         truth: tuple) -> list:
    """Phase 7 (b): BASELINE config 4's day partitions on the host tier with
    ``save_states_with``, their saved states held bit for bit against the
    same runs on ``device="cpu"``; refreshed alone (bit for bit against
    the CPU's refresh) and merged with phase 6's device-tier states of the
    other day, every refresh against phase 6's numpy figures (``truth``,
    :func:`incremental_oracle`'s answer over ``table``). Returns the
    problems."""
    schema = dq.Dataset.from_arrow(table.slice(0, 1)).schema
    battery = incremental_battery(dq)

    providers = partition_runs(torch, dq, table, rows, battery, "cuda", "host tier (b)",
                               HOST_KERNELS, placement="host")[0]
    t0 = time.perf_counter()
    cpu = partition_runs(torch, dq, table, rows, battery, "cpu", "", placement="host")[0]
    print(f"[cpu] host tier (b) partitions on the CPU in {time.perf_counter() - t0:.1f}s",
          flush=True)
    problems = [f"day {day}: {a} state differs from the CPU run's"
                for day, (g, c) in enumerate(zip(providers, cpu)) for a in battery
                if not same_state_bits(g.load(a), c.load(a))]
    cpu_refresh = context_values(merged_run(torch, dq, schema, battery, cpu, "cpu", "")[0])
    worst = 0.0
    for label, pair in (("host days", providers),
                        ("host day 0, device day 1", [providers[0], device_providers[1]]),
                        ("device day 0, host day 1", [device_providers[0], providers[1]])):
        merged, _ = merged_run(torch, dq, schema, battery, pair, "cuda",
                               f"host tier (b) refresh, {label}", INCREMENTAL_KERNELS)
        values = context_values(merged)
        if pair is providers and repr(values) != repr(cpu_refresh):
            problems.append("the refresh of the host days differs from the CPU's")
        found, err = check_incremental_oracle(values, table, HOST_KLL_RANK_LIMIT,
                                              battery_only=True, truth=truth)
        problems += [f"{label}: {p}" for p in found]
        worst = max(worst, err)
    print(f"[host tier (b) metrics] saved states and the host days' refresh equal the CPU "
          f"run's bit for bit; three refreshes agree with the oracle; largest KLL percentile "
          f"rank error {worst:.6f} (limit {HOST_KLL_RANK_LIMIT})", flush=True)
    return problems


def host_tier_profile(torch, dq, table: pa.Table, sketches: dict) -> dict:
    """Phase 7 (c): BASELINE config 3's profile with
    ``with_placement("host")`` in batches of 2^20 rows (the profile's
    default), held bit for bit against the same run on ``device="cpu"``,
    its KLL sketches bit for bit against phase 2's ingest of the same
    chunk (``sketches``), and against phase 4's oracle. Returns the run's
    launches."""
    def run(monitor, device="cuda"):
        return (dq.ColumnProfilerRunner.on_data(dq.Dataset.from_arrow(table), device=device)
                .with_batch_size(BATCH_ROWS).with_placement("host").with_monitor(monitor).run())

    profiles, monitor, launches = _timed_run(torch, "host tier (c)", run, table.num_rows,
                                             HOST_KERNELS)
    _host_tier_report("host tier (c)", monitor)
    gpu = profile_values(profiles)
    t0 = time.perf_counter()
    cpu = profile_values(run(dq.RunMonitor(), "cpu"))
    print(f"[cpu] host tier (c) on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    problems = [f"cpu: {p}" for p in compare_profiles(gpu, cpu, 0.0)]
    problems += [f"{c}: KLL items differ from phase 2's ingest of (c)'s chunk"
                 for c, data in sketches.items() if gpu[c]["kll"][2] != data]
    found, worst = compare_profile_oracle(gpu, table, rank_limit=HOST_KLL_RANK_LIMIT)
    problems += found
    if problems:
        raise AssertionError("host tier (c) disagrees:\n" + "\n".join(problems))
    print(f"[host tier (c) metrics] {len(profiles.profiles)} column profiles equal the CPU run "
          f"bit for bit, {len(sketches)} KLL sketches phase 2's ingest, and agree with the "
          f"oracle; largest percentile rank error {worst:.6f} (limit {HOST_KLL_RANK_LIMIT})",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 9: more than one device (a mesh of shards on the card, and processes)
# ---------------------------------------------------------------------------


def check_mesh_kernels(torch, dq, data, battery: list) -> dict:
    """Phase 9 (a): the mesh's three entries against their plain versions
    bit for bit, at the host tier's shapes over config 2's battery and its
    ApproxQuantile (28 slots in K8's carry, one KLL sketch):

    - ``state_fold_butterfly`` on the packed host partials of 2^20-row
      batches as the shards' states: 8 shards x 1 (the kernels line's
      numbers: (b)'s merge), 4 shards x 2, 3 shards (the gather route);
    - ``state_fold_carry_stacked``: 8 identity carries, each folding 4 of
      32 partials of 2^18-row batches, equal to 8 launches of the carry
      entry;
    - ``kll_compact_merge_stacked``: 8 pairs of the quantile's sketches,
      each filled with two host samples, equal to 8 one-pair merges.

    Each timed beside ``torch.amax`` of the stacked registers plus
    ``torch.sum`` of the stacked counts (K8's entries) or ``torch.sort`` of
    one 4,096-item level (K5's), with bounds of bytes read once and written
    once at 3.35 TB/s (K5's: the live items, :func:`_merge_bytes`)."""
    from deequ_tpu_torch.kernels.kll_compact import (
        kll_compact_ingest,
        kll_compact_merge,
        kll_compact_merge_stacked,
        kll_compact_merge_stacked_plain,
    )
    from deequ_tpu_torch.kernels.state_fold import (
        state_fold_butterfly,
        state_fold_butterfly_plain,
        state_fold_carry,
        state_fold_carry_stacked,
        state_fold_carry_stacked_plain,
    )
    from deequ_tpu_torch.ops.kll import kll_init
    from deequ_tpu_torch.runners.engine import stack_samples

    results = _new_results()
    ingest, packed = host_partial_rows(dq, battery, data, BATCH_ROWS, 10)
    slots = ingest.slots
    rows = [torch.stack([r[d] for r, _ in packed]).cuda() for d in range(3)]

    def yardstick(mats):
        return _time_ms(torch, lambda: (torch.amax(mats[2], dim=0), torch.sum(mats[1], dim=0)))

    for n_dev, k in ((8, 1), (4, 2), (3, 1)):
        mats = [m[:n_dev * k].contiguous() for m in rows]
        got = state_fold_butterfly(*mats, slots, n_dev)
        want = state_fold_butterfly_plain(*mats, slots, n_dev)
        torch.cuda.synchronize()
        if not _same_bits(got, want):
            raise AssertionError(f"state_fold_butterfly differs from its plain version at "
                                 f"{n_dev} shards x {k}")
        nbytes = sum(m.numel() * m.element_size() + n_dev * m.shape[1] * m.element_size()
                     for m in mats)
        _add(results if n_dev == MESH_SHARDS else _new_results(), "state_fold_butterfly",
             f"config 2's battery, {len(slots)} slots, {n_dev} shards x {k}", 0.0,
             _time_kernel_ms(torch, lambda: state_fold_butterfly(*mats, slots, n_dev)),
             _time_ms(torch, lambda: state_fold_butterfly_plain(*mats, slots, n_dev), reps=5,
                      warmup=1),
             nbytes, sum(m.numel() for m in mats), yardstick(mats))

    check_butterfly_sizes(torch, dq)
    ingest, packed = host_partial_rows(dq, battery, data, HOST_BATCH_ROWS, CHUNK)
    parts = [torch.stack([r[d] for r, _ in packed]).cuda() for d in range(3)]
    local = CHUNK // MESH_SHARDS
    carry = [c[None].expand(MESH_SHARDS, -1).contiguous() for c in ingest.carry]
    got, want = [c.clone() for c in carry], [c.clone() for c in carry]
    state_fold_carry_stacked(got, parts, slots)
    state_fold_carry_stacked_plain(want, parts, slots)
    single = []
    for s in range(MESH_SHARDS):
        row = [c.clone() for c in ingest.carry]
        state_fold_carry(row, [p[s * local:(s + 1) * local].contiguous() for p in parts], slots)
        single.append(row)
    torch.cuda.synchronize()
    if not _same_bits(got, want) or not all(
            _same_bits([g[s] for g in got], single[s]) for s in range(MESH_SHARDS)):
        raise AssertionError("state_fold_carry_stacked differs from its plain version or from "
                             "one carry launch per shard")
    scratch = [c.clone() for c in carry]
    nbytes = sum(p.numel() * p.element_size() + 2 * c.numel() * c.element_size()
                 for p, c in zip(parts, carry))
    _add(results, "state_fold_carry_stacked",
         f"config 2's battery, {len(slots)} slots, {MESH_SHARDS} shards x {local} partials", 0.0,
         _time_kernel_ms(torch, lambda: state_fold_carry_stacked(scratch, parts, slots)),
         _time_ms(torch, lambda: state_fold_carry_stacked_plain(scratch, parts, slots)),
         nbytes, sum(p.numel() for p in parts), yardstick(parts))

    sketch = [j for j, a in enumerate(battery) if isinstance(a, dq.ApproxQuantile)][0]
    size = battery[sketch]._sketch_size()
    samples = [kll for _, kll in packed]
    at = [j for j, kll in enumerate(ingest.sketch_of) if kll].index(sketch)
    stacked = [torch.stack(list(col)).contiguous()
               for col in zip(*(kll_init(size, device="cuda").tensors() for _ in range(16)))]
    kll_compact_ingest(stacked, stack_samples(
        [[samples[2 * i][at], samples[2 * i + 1][at]] for i in range(16)], 4 * size,
        lambda t: t.cuda()), size)
    a, b = [t[:8] for t in stacked], [t[8:] for t in stacked]
    got = kll_compact_merge_stacked(a, b, size)
    want = kll_compact_merge_stacked_plain(a, b, size)
    pairs = [kll_compact_merge([t[i] for t in a], [t[i] for t in b], size) for i in range(8)]
    torch.cuda.synchronize()
    if not _same_bits(got, want) or not all(
            _same_bits([g[i] for g in got], pairs[i]) for i in range(8)):
        raise AssertionError("kll_compact_merge_stacked differs from its plain version or from "
                             "eight one-pair merges")
    nbytes = _merge_bytes(a[1], b[1], got[1])
    level = torch.from_numpy(np.tile(samples[0][at][0][:2 * size], 2)).float().cuda()
    _add(results, "kll_compact_merge_stacked", f"8 pairs of k = {size} sketches", 0.0,
         _time_kernel_ms(torch, lambda: kll_compact_merge_stacked(a, b, size)),
         _time_ms(torch, lambda: kll_compact_merge_stacked_plain(a, b, size), reps=5, warmup=1),
         nbytes, sum(int(t.sum()) for t in (a[1], b[1])), _time_ms(torch, lambda: torch.sort(level)))
    _print_kernel_totals(results, MESH_KERNELS, "mesh, config 2")
    return results


#: the meshes the butterfly is held on beside the main path's: the sizes
#: the CPU tests hold against the reference (1-16), a warp's width and past
#: it (32, 64), each at k = 1 and 3
BUTTERFLY_SIZES = tuple((n, k) for n in (1, 2, 3, 4, 8, 16, 32, 64) for k in (1, 3))


def check_butterfly_sizes(torch, dq) -> None:
    """K8's butterfly against its plain version bit for bit at every
    :data:`BUTTERFLY_SIZES` mesh, on states of every kind (``fold_groups``)."""
    from deequ_tpu_torch.analyzers.base import pack_states
    from deequ_tpu_torch.kernels.state_fold import state_fold_butterfly, state_fold_butterfly_plain

    for n_dev, k in BUTTERFLY_SIZES:
        jobs = [states for _, states in fold_groups(dq, n_dev * k, 3 * n_dev + k)]
        mats, slots, _ = pack_states(jobs)
        mats = [m.cuda() for m in mats]
        got = state_fold_butterfly(*mats, slots, n_dev)
        want = state_fold_butterfly_plain(*mats, slots, n_dev)
        torch.cuda.synchronize()
        if not same_tensor_bits(got, want):
            raise AssertionError(f"state_fold_butterfly differs from its plain version at "
                                 f"{n_dev} shards x {k}")
    print(f"[check state_fold_butterfly] every kind at {len(BUTTERFLY_SIZES)} meshes "
          f"({', '.join(f'{n}x{k}' for n, k in BUTTERFLY_SIZES)}), bit for bit", flush=True)


def _mesh_run(dq, table: pa.Table, quantile, monitor, device: str = "cuda",
              shards: int = MESH_SHARDS, placement: str = "host", batch_rows: int = BATCH_ROWS):
    """Phase 3's checks and 7 (a)'s required analyzers over ``table``,
    sharded over a mesh of ``shards`` on ``device`` (no mesh at 0)."""
    from deequ_tpu_torch.parallel import make_mesh

    builder = (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device=device)
               .add_check(build_check(dq, table.num_rows))
               .add_required_analyzers([dq.CountDistinct("cat_large"), quantile])
               .with_batch_size(batch_rows).with_placement(placement).with_monitor(monitor))
    if shards:
        builder = builder.with_sharding(make_mesh(shards, device=device))
    return builder.run()


def _quantile_error(table: pa.Table, value: float) -> float:
    a = table["a"].combine_chunks()
    ranked = np.sort(a.to_numpy(zero_copy_only=False)[np.asarray(a.is_valid())]
                     .astype(np.float32))
    return _rank_error(ranked, value, 0.5)


def _without(metrics: dict, key) -> dict:
    return {k: v for k, v in metrics.items() if k != key}


def _degraded(label: str, *monitors) -> list:
    """A fault-free mesh run must lose no shard and keep its mesh: a run
    that degraded (re-sharded, or folded on the host) would pass its
    metric checks with another path's timing."""
    return [f"{label}: shard_losses={m.shard_losses} mesh_reshards={m.mesh_reshards} "
            f"degraded={m.degraded}" for m in monitors
            if m.shard_losses or m.mesh_reshards or m.degraded]


def mesh_runs(torch, dq, table: pa.Table, host_metrics: dict, host_statuses: list,
              device_metrics: dict) -> dict:
    """Phase 9 (b)-(e) over config 2's table: (b) the host tier on a mesh
    of 8 shards on the card, against 7 (a)'s unsharded host tier in the
    same 2^20-row batches (counts, min, max, HLL, DataType and statuses
    exact, moments within 1e-12, the quantile within
    ``HOST_KLL_RANK_LIMIT``), the oracle, and, at ``MESH_CUT_ROWS``, the
    same mesh run on the CPU bit for bit; (c) the device tier on the mesh,
    against phase 3's metrics and the oracle (the quantile within twice
    the sketch's error), and its CPU run at the cut (moments within
    1e-12, the rest, the sketch included, exact); (d) a mesh of 3 at the
    cut (the gather route) against the unsharded host tier and its CPU
    run; (e) a shard lost at the second chunk fold of a host-tier run:
    the counters and the fault-free metrics. Every run of (b)-(d) must
    lose no shard and keep its mesh. Returns (b)'s launches and (c)'s
    metrics (the quantile left out)."""
    from deequ_tpu_torch.reliability import FaultSpec, inject

    quantile = dq.ApproxQuantile("a", 0.5, KLL_RELATIVE_ERROR)
    qkey = metric_key(quantile)
    rows = table.num_rows
    truth = oracle(table)
    cut = table.slice(0, MESH_CUT_ROWS)
    problems = []

    # (b) the host tier on a mesh of 8
    result, monitor, launches = _timed_run(
        torch, f"mesh (b) host tier, {MESH_SHARDS} shards", lambda m: _mesh_run(
            dq, table, quantile, m), rows, MESH_HOST_KERNELS)
    _host_tier_report("mesh (b)", monitor)
    problems += _degraded("(b)", monitor)
    gpu = metric_values(result)
    problems += [f"(b) against 7 (a): {p}" for p in compare_metrics(
        _without(gpu, qkey), _without(host_metrics, qkey))]
    if _statuses(result) != host_statuses:
        problems.append(f"(b) check statuses differ from 7 (a)'s: {_statuses(result)}")
    problems += [f"(b) oracle: {p}" for p in compare_oracle(gpu, truth)]
    worst = _quantile_error(table, gpu[qkey])
    if worst > HOST_KLL_RANK_LIMIT:
        problems.append(f"(b) ApproxQuantile rank error {worst}")
    t0 = time.perf_counter()
    monitors = [dq.RunMonitor(), dq.RunMonitor()]
    on_card = metric_values(_mesh_run(dq, cut, quantile, monitors[0]))
    on_cpu = metric_values(_mesh_run(dq, cut, quantile, monitors[1], device="cpu"))
    problems += _degraded("(b) at the cut", *monitors)
    print(f"[cpu] mesh (b) at {MESH_CUT_ROWS} rows on the card and the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    problems += [f"(b) cpu: {p}" for p in compare_metrics(on_card, on_cpu, 0.0)]

    # (c) the device tier on a mesh of 8
    result, monitor, _ = _timed_run(
        torch, f"mesh (c) device tier, {MESH_SHARDS} shards", lambda m: _mesh_run(
            dq, table, quantile, m, placement="device"), rows, MESH_DEVICE_KERNELS)
    if monitor.placement != "device":
        raise AssertionError(f"mesh (c) did not run on the device tier: {monitor}")
    problems += _degraded("(c)", monitor)
    gpu = metric_values(result)
    problems += [f"(c) against phase 3: {p}" for p in compare_metrics(
        {k: v for k, v in gpu.items() if k in device_metrics}, device_metrics)]
    problems += [f"(c) oracle: {p}" for p in compare_oracle(gpu, truth)]
    device_metrics_c = _without(gpu, qkey)
    device_error = _quantile_error(table, gpu[qkey])
    if device_error > 2 * KLL_RELATIVE_ERROR:
        problems.append(f"(c) ApproxQuantile rank error {device_error}")
    t0 = time.perf_counter()
    monitors = [dq.RunMonitor(), dq.RunMonitor()]
    on_card = metric_values(_mesh_run(dq, cut, quantile, monitors[0], placement="device"))
    on_cpu = metric_values(_mesh_run(dq, cut, quantile, monitors[1], device="cpu",
                                     placement="device"))
    problems += _degraded("(c) at the cut", *monitors)
    print(f"[cpu] mesh (c) at {MESH_CUT_ROWS} rows on the card and the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    problems += [f"(c) cpu: {p}" for p in compare_metrics(on_card, on_cpu)]

    # (d) a mesh of 3: the gather route
    three, monitor, _ = _timed_run(torch, "mesh (d) host tier, 3 shards", lambda m: _mesh_run(
        dq, cut, quantile, m, shards=3), MESH_CUT_ROWS, MESH_HOST_KERNELS)
    problems += _degraded("(d)", monitor)
    unsharded = _mesh_run(dq, cut, quantile, dq.RunMonitor(), shards=0)
    got, want = metric_values(three), metric_values(unsharded)
    problems += [f"(d) against the unsharded host tier: {p}" for p in compare_metrics(
        _without(got, qkey), _without(want, qkey))]
    if _statuses(three) != _statuses(unsharded):
        problems.append("(d) check statuses differ from the unsharded run's")
    if _quantile_error(cut, got[qkey]) > HOST_KLL_RANK_LIMIT:
        problems.append(f"(d) ApproxQuantile rank error {_quantile_error(cut, got[qkey])}")
    monitor = dq.RunMonitor()
    on_cpu = metric_values(_mesh_run(dq, cut, quantile, monitor, device="cpu", shards=3))
    problems += _degraded("(d) on the CPU", monitor)
    problems += [f"(d) cpu: {p}" for p in compare_metrics(got, on_cpu, 0.0)]

    # (e) shard loss at the second chunk fold
    small = table.slice(0, MESH_LOSS_ROWS)
    clean = metric_values(_mesh_run(dq, small, quantile, dq.RunMonitor(),
                                    batch_rows=MESH_LOSS_BATCH_ROWS))

    def lossy(monitor):
        with inject(FaultSpec("sharded_fold", "mesh_loss", at=2, shard=5)) as inj:
            out = _mesh_run(dq, small, quantile, monitor, batch_rows=MESH_LOSS_BATCH_ROWS)
        if not inj.fired:
            raise AssertionError("mesh (e): the injected shard loss did not fire")
        return out

    with drill("mesh (e)"):
        result, monitor, _ = _timed_run(torch, "mesh (e) shard loss", lossy, MESH_LOSS_ROWS,
                                        MESH_HOST_KERNELS)
    print(f"[mesh (e) recovery] shard_losses={monitor.shard_losses} "
          f"mesh_reshards={monitor.mesh_reshards} salvaged_states={monitor.salvaged_states} "
          f"degraded={monitor.degraded}", flush=True)
    if (monitor.shard_losses, monitor.mesh_reshards, monitor.salvaged_states) != (1, 1, 7) or \
            "mesh:8->4" not in monitor.degraded:
        problems.append(f"(e) recovery counters: {monitor}")
    got = metric_values(result)
    problems += [f"(e) against the fault-free run: {p}" for p in compare_metrics(
        _without(got, qkey), _without(clean, qkey), 1e-9)]
    if _quantile_error(small, got[qkey]) > HOST_KLL_RANK_LIMIT:
        problems.append(f"(e) ApproxQuantile rank error {_quantile_error(small, got[qkey])}")
    if problems:
        raise AssertionError("phase 9 disagrees:\n" + "\n".join(problems[:40]))
    print(f"[mesh metrics] (b) equals 7 (a)'s unsharded host tier (moments within 1e-12) and "
          f"the oracle, its CPU run bit for bit; (c) phase 3's metrics and the oracle, its CPU "
          f"run; (d) the gather route the unsharded run and its CPU run; (e) the fault-free "
          f"run; quantile rank errors (b) {worst:.6f} (limit {HOST_KLL_RANK_LIMIT}), (c) "
          f"{device_error:.6f} (limit {2 * KLL_RELATIVE_ERROR:.6f})", flush=True)
    return launches, device_metrics_c


def _spawn_world(world: int, store: str, job: dict, workdir: str) -> list:
    """Spawn ``world`` processes of ``dcn.worker_main``; each must finish
    within ``DCN_JOIN_S`` with code 0. Returns their outputs."""
    import os

    import torch
    import torch.multiprocessing as mp

    from deequ_tpu_torch.parallel import dcn

    job_path = os.path.join(workdir, "job.pt")
    torch.save(job, job_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dcn.worker_main,
                         args=(r, world, store, job_path, os.path.join(workdir, f"out{r}.pt")))
             for r in range(world)]
    for p in procs:
        p.start()
    failed = []
    for r, p in enumerate(procs):
        p.join(DCN_JOIN_S)
        if p.is_alive():
            p.kill()
            p.join(10)
            failed.append((r, "hung"))
        elif p.exitcode != 0:
            failed.append((r, p.exitcode))
    if failed:
        raise AssertionError(f"cross-process world of {world}: processes failed {failed}")
    return [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def cross_process(torch, dq, data, battery: list) -> None:
    """Phase 9 (f): 4 processes on the one card join a gloo group over a
    ``FileStore``; each folds its quarter of (b)'s host partials (the
    2^20-row batches, contiguous shares) on the card with
    ``dcn.fold_partials`` and merges with ``dcn.merge_host_states``. Every
    rank must return the same states, equal bit for bit to one process's
    mesh of 4 over the same shares (``sharded_ingest_fold`` and
    ``collective_merge_states`` on the card). Then an NCCL group of as
    many ranks as cards are visible, up to 4."""
    import os
    import shutil
    import tempfile

    from deequ_tpu_torch.parallel import (
        collective_merge_states,
        dcn,
        make_mesh,
        sharded_ingest_fold,
        stack_identity_states,
    )

    t0 = time.perf_counter()
    partials = dcn.host_partials(battery, data, BATCH_ROWS)
    local = -(-len(partials) // DCN_WORLD)
    shares = [list(range(r * local, min(len(partials), (r + 1) * local)))
              for r in range(DCN_WORLD)]
    chunk, flags = [], []
    for share in shares:
        chunk += [partials[j] for j in share] + [partials[0]] * (local - len(share))
        flags += [True] * len(share) + [False] * (local - len(share))
    mesh = make_mesh(DCN_WORLD, device="cuda")
    states = sharded_ingest_fold(battery, mesh, stack_identity_states(battery, DCN_WORLD, "cuda"),
                                 dcn.stack_partials(battery, chunk), np.array(flags))
    want = collective_merge_states(battery, mesh, states)
    workdir = tempfile.mkdtemp(prefix="deequ-dcn-")
    try:
        job = {"analyzers": battery, "partials": [[partials[j] for j in s] for s in shares],
               "device": "cuda", "backend": "gloo", "deadline_s": 120.0}
        outs = _spawn_world(DCN_WORLD, os.path.join(workdir, "store"), job, workdir)
        seconds = time.perf_counter() - t0
        bad = [(out["rank"], a) for out in outs for a, g, w in zip(battery, out["states"], want)
               if out["salvaged"] or not same_state_bits(g, w)]
        if bad:
            raise AssertionError(f"cross-process merge differs from the one-process mesh: {bad}")
        print(f"[mesh (f) gloo] {DCN_WORLD} processes on the card, shares "
              f"{[len(s) for s in shares]} of {len(partials)} partials: every rank's merge equals "
              f"the one-process mesh of {DCN_WORLD} bit for bit; {seconds:.1f}s with the "
              f"processes' start", flush=True)
        world = min(DCN_WORLD, torch.cuda.device_count())
        nccl_dir = os.path.join(workdir, "nccl")
        os.makedirs(nccl_dir)
        shares = [list(range(r, len(partials), world)) for r in range(world)]
        job = {"analyzers": battery, "partials": [[partials[j] for j in s] for s in shares],
               "device": "cuda", "backend": "nccl", "deadline_s": 120.0}
        t0 = time.perf_counter()
        outs = _spawn_world(world, os.path.join(nccl_dir, "store"), job, nccl_dir)
        first = outs[0]["states"]
        if any(not all(same_state_bits(g, w) for g, w in zip(o["states"], first)) for o in outs):
            raise AssertionError("the NCCL ranks returned different states")
        print(f"[mesh (f) nccl] world of {world} (cards visible: "
              f"{torch.cuda.device_count()}) in {time.perf_counter() - t0:.1f}s", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: the streaming verification service
# ---------------------------------------------------------------------------

#: the reference's streaming knee point (tools/streaming_knee.py over
#: tools/ingest_soak.py): sessions x micro-batches x rows, 8 workers, a
#: queue of 256, 32 feeder threads that park up to 30 s for queue space
STREAM_SESSIONS = 1000
STREAM_BATCHES = 2
STREAM_ROWS = 4096
#: (c): the serial run takes the first this many of (b)'s sessions (cut
#: from 1,000, where it took 100 s of the script, to keep the script
#: within half its time limit with phase 10)
STREAM_SERIAL_SESSIONS = 250
#: (d): larger micro-batches
STREAM_LARGE_SESSIONS = 100
STREAM_LARGE_ROWS = 65536
STREAM_WORKERS = 8
STREAM_QUEUE = 256
STREAM_FEEDERS = 32
STREAM_BLOCK_S = 30.0
#: sessions per coalesced launch: the service's default width
STREAM_WIDTH = 16
#: (e): this many of (b)'s sessions re-run on the CPU
STREAM_CPU_SESSIONS = 16
STREAM_SEED = 7
#: the checks' ApproxQuantile keeps its default relative error of 0.01 (a
#: sketch of 4 / 0.01 = 400 items): its median within twice that in rank
STREAM_KLL_RANK_LIMIT = 2 * 0.01
#: bound on every wait of phase 8
STREAM_WAIT_S = 300
STACKED_KERNELS = ("scan_reduce_stacked", "hll_registers_stacked")
#: what a coalesced run must launch: the stacked entries, K4 and K5 once
#: per session, and K8 merging each group's states into the persisted ones
STREAM_KERNELS = STACKED_KERNELS + ("kll_sample", "kll_compact", "state_fold")


def build_stream_table(sessions: int, batches: int, rows: int, seed: int) -> pa.Table:
    """The soak's table (tools/ingest_soak.py ``_build_table``: x, y, k,
    v), one distinct slice per session and micro-batch: session i's batch b
    is :func:`stream_slice` (i, b)."""
    rng = np.random.default_rng(seed)
    n = sessions * batches * rows
    return pa.table({
        "x": rng.normal(size=n),
        "y": rng.normal(10.0, 2.0, size=n),
        "k": rng.integers(0, 1000, size=n),
        "v": rng.uniform(0, 1, size=n),
    })


def stream_slice(table: pa.Table, i: int, b: int, rows: int) -> pa.Table:
    return table.slice((i * STREAM_BATCHES + b) * rows, rows)


def stream_check(m):
    """The soak's battery (tools/ingest_soak.py:40-49: Size, ``is_complete
    ("x")``, ``has_mean("y")``) with the moments, co-moments, HLL and KLL
    constraints that put every kernel of the coalesced fold on the path.
    ``m`` is a package exporting ``Check`` and ``CheckLevel``."""
    def yes(_):
        return True

    return (
        m.Check(m.CheckLevel.ERROR, "ingest battery")
        .has_size(lambda n: n > 0)
        .is_complete("x")
        .has_mean("y", lambda v: -100.0 < v < 100.0)
        .has_standard_deviation("y", yes)
        .has_min("v", yes).has_max("v", yes).has_sum("v", yes)
        .has_approx_count_distinct("k", yes)
        .has_approx_quantile("v", 0.5, yes)
        .has_correlation("x", "y", yes)
    )


@contextlib.contextmanager
def service_knobs(**knobs):
    """Set the service's env knobs for a block and restore them after."""
    import os

    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update({k: str(v) for k, v in knobs.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: every fold on the device route, coalesced (phase 8's knobs)
DEVICE_FOLDS = {"DEEQU_TPU_COALESCE": "1", "DEEQU_TPU_FAST_PATH_MAX_ROWS": "0",
                "DEEQU_TPU_PLACEMENT": "device"}


def stream_run(torch, dq, table: pa.Table, sessions: int, rows: int, coalesce: bool,
               device: str = "cuda", label: str = "", kernels=()) -> tuple:
    """``sessions`` streaming sessions x ``STREAM_BATCHES`` micro-batches
    of ``rows`` through ``VerificationService(workers=8,
    max_queue_depth=256, background_warm=False)`` on ``device``, fed by 32
    threads as the soak feeds them, with ``DEEQU_TPU_COALESCE`` on or off,
    ``DEEQU_TPU_FAST_PATH_MAX_ROWS=0`` (every fold takes the device) and
    ``DEEQU_TPU_PLACEMENT=device``. One warm session's fold runs first;
    the launch counts are set to 0 just before the feed. Returns each
    session's cumulative metric values (its last fold's result), the
    run's summary and its launches; fails on a shed or a failed fold, or
    when a kernel of ``kernels`` was not launched."""
    import threading

    import deequ_tpu_torch.service as service
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.service.metrics import histogram_quantile

    knobs = {**DEVICE_FOLDS, "DEEQU_TPU_COALESCE": "1" if coalesce else "0"}
    on_card = device == "cuda"
    with service_knobs(**knobs):
        with service.VerificationService(STREAM_WORKERS, STREAM_QUEUE, device=device,
                                         background_warm=False) as svc:
            checks = [stream_check(dq)]
            sess = [svc.session(f"s{i}", "stream", checks, admission_block_s=STREAM_BLOCK_S)
                    for i in range(sessions)]
            svc.session("warm", "stream", checks).ingest(
                stream_slice(table, 0, 0, rows), timeout=STREAM_WAIT_S)
            shed0 = svc.metrics.counter_value("deequ_service_jobs_shed_total")
            errors, handles, lock = [], [], threading.Lock()

            def feed(lo: int, hi: int) -> None:
                mine = []
                for i in range(lo, hi):
                    for b in range(STREAM_BATCHES):
                        try:
                            mine.append(sess[i].ingest(stream_slice(table, i, b, rows),
                                                       wait=False))
                        except service.ServiceError as exc:
                            with lock:
                                errors.append(type(exc).__name__)
                with lock:
                    handles.extend(mine)

            feeders = max(1, min(STREAM_FEEDERS, sessions))
            per = -(-sessions // feeders)
            threads = [threading.Thread(target=feed, args=(f * per, min((f + 1) * per, sessions)),
                                        daemon=True) for f in range(feeders)]
            if on_card:
                torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(STREAM_WAIT_S)
            failed = 0
            for h in handles:
                try:
                    h.result(STREAM_WAIT_S)
                except Exception:  # noqa: BLE001 - counted: the phase fails on any
                    failed += 1
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            counters = svc.json_snapshot()["counters"]
            done = sum(1 for s in sess if s.batches_ingested == STREAM_BATCHES)
            summary = {
                "sessions": sessions, "rows": rows, "coalesce": coalesce, "device": device,
                "wall_s": wall, "sessions_per_s": done / wall,
                "folds_per_s": len(handles) / wall,
                "shed": svc.metrics.counter_value("deequ_service_jobs_shed_total") - shed0,
                "feeder_errors": len(errors), "failed_folds": failed,
                "widths": counters.get("deequ_service_coalesce_width_total", {}),
                "width_sum": counters.get("deequ_service_coalesce_width_sum", 0.0),
                "phases": {k.split("=", 1)[1]: round(v, 4) for k, v in counters.get(
                    "deequ_service_phase_seconds_total", {}).items()},
                # the service's own fold-latency histogram (power-of-two
                # buckets: a quantile reads as its bucket's upper edge)
                "fold_latency_s": {f"p{int(q * 100)}": histogram_quantile(
                    svc.metrics.histogram_merged("deequ_service_fold_latency_seconds"), q)
                    for q in (0.5, 0.99)},
            }
            values = [metric_values(s.latest) if s.latest is not None else {} for s in sess]
    print(f"[{label}] {sessions} sessions x {STREAM_BATCHES} x {rows} rows, coalesce="
          f"{int(coalesce)} on {device}: {summary['sessions_per_s']:.1f} sessions/s "
          f"({summary['folds_per_s']:.1f} folds/s, {wall:.3f}s); widths={summary['widths']} "
          f"width_sum={summary['width_sum']}; fold latency {summary['fold_latency_s']}; "
          f"shed={summary['shed']} feeder_errors="
          f"{len(errors)} failed_folds={failed}; launches={launches}; "
          f"phases={summary['phases']}", flush=True)
    if summary["shed"] or errors or failed or done != sessions:
        raise AssertionError(f"{label}: {done}/{sessions} sessions completed, "
                             f"{summary['shed']} shed, {failed} failed folds, errors {errors}")
    missing = [name for name in kernels if launches[name] == 0]
    if missing:
        raise AssertionError(f"{label} launched no {missing}")
    return values, summary, launches


def _session_features(dq, table: pa.Table, width: int, rows: int):
    """The battery program of phase 8's checks and the host features of
    its first ``width`` sessions' first micro-batches (one bucket)."""
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers
    from deequ_tpu_torch.service.coalesce import build_fold_plan

    analyzers = collect_required_analyzers([stream_check(dq)])
    plan = build_fold_plan(analyzers, dq.Dataset.from_arrow(table.slice(0, 1)).schema)
    feats = [plan.builder().build(next(dq.Dataset.from_arrow(
        stream_slice(table, w, 0, rows)).batches(rows))) for w in range(width)]
    return plan.program(), feats


def check_stacked_kernels(torch, dq, table: pa.Table, rows: int) -> dict:
    """Phase 8 (a): K1's and K2's stacked entries at a coalesced group's
    shape (``STREAM_WIDTH`` sessions x ``rows``), each against its stacked
    plain version and against ``STREAM_WIDTH`` one-session launches bit for
    bit, with times and bounds (K2 beside one ``scatter_reduce`` amax over
    the W x 512 registers). Returns the measurements."""
    from deequ_tpu_torch.analyzers.base import resolve_slot
    from deequ_tpu_torch.analyzers.sketches import ApproxCountDistinct
    from deequ_tpu_torch.kernels.hll_registers import (
        hll_registers, hll_registers_stacked, hll_registers_stacked_plain)
    from deequ_tpu_torch.kernels.scan_reduce import (
        KIND_COMOMENTS, KIND_MOMENTS, Slot, scan_reduce, scan_reduce_stacked,
        scan_reduce_stacked_plain)
    from deequ_tpu_torch.runners.engine import _stack_to_device

    device = torch.device("cuda")
    width = STREAM_WIDTH
    program, feats = _session_features(dq, table, width, rows)
    stacked = {key: _stack_to_device([f[key] for f in feats], device)
               for key in program.feature_keys}
    torch.cuda.synchronize()
    rows_t = stacked["rows"]
    results = _new_results()
    add = functools.partial(_add, results)
    label = f"{width} x {rows}"
    for bundle in program.bundles:
        slots = [resolve_slot(spec, stacked) for spec in bundle]
        ki, kf = scan_reduce_stacked(slots, rows_t)
        pi, pf = scan_reduce_stacked_plain(slots, rows_t)
        torch.cuda.synchronize()
        if not torch.equal(ki, pi):
            raise AssertionError("scan_reduce_stacked counts differ from the plain version")
        kf_h, pf_h = kf.cpu().numpy(), pf.cpu().numpy()
        for w in range(width):
            one = [Slot(sl.kind, *(None if t is None else t[w] for t in (
                sl.where, sl.sel, sl.vals, sl.vals2, sl.sel2))) for sl in slots]
            oi, of = scan_reduce(one, rows_t[w])
            if not (torch.equal(oi, ki[w]) and _same_bits([of], [kf[w]])):
                raise AssertionError(f"scan_reduce_stacked session {w} differs from a "
                                     "one-session launch")
            for s, slot in enumerate(slots):
                a, b = kf_h[w, s], pf_h[w, s]
                # min and max bit for bit; a co-moment slot has none (its
                # five columns are sums)
                exact = () if slot.kind == KIND_COMOMENTS else (1, 2)
                for col in exact:
                    if not ((np.isnan(a[col]) and np.isnan(b[col])) or (
                            a[col] == b[col] and np.signbit(a[col]) == np.signbit(b[col]))):
                        raise AssertionError(f"scan_reduce_stacked min/max of slot {s} differ")
                if slot.vals is None:
                    continue
                vals = [slot.vals[w].double()] + ([slot.vals2[w]] if slot.vals2 is not None
                                                  else [])
                scale = max(max(float(v.abs().sum()), float((v * v).sum())) for v in vals)
                for col in sorted(set(range(5)) - set(exact)):
                    if not ((np.isnan(a[col]) and np.isnan(b[col]))
                            or abs(a[col] - b[col]) <= 1e-12 * max(scale, 1.0)):
                        raise AssertionError(f"scan_reduce_stacked slot {s} column {col}: "
                                             f"{a[col]!r} vs {b[col]!r}")
        arrays = {id(t): t for slot in slots
                  for t in (slot.where, slot.sel, slot.vals, slot.vals2, slot.sel2)
                  if t is not None}
        arrays[id(rows_t)] = rows_t
        nbytes = (sum(t.numel() * t.element_size() for t in arrays.values())
                  + width * len(slots) * (7 + 5) * 8)
        sel = pi[:, :, 0].sum(dim=0).cpu().numpy()
        ops = sum(2 * width * rows + (7 * int(sel[s]) if slot.kind == KIND_MOMENTS else 0)
                  for s, slot in enumerate(slots))
        add("scan_reduce_stacked", f"{label}, {len(slots)} slots", _max_abs_err(kf, pf),
            _time_kernel_ms(torch, lambda: scan_reduce_stacked(slots, rows_t)),
            _time_ms(torch, lambda: scan_reduce_stacked_plain(slots, rows_t)), nbytes, ops)
    for a in program.analyzers:
        if not isinstance(a, ApproxCountDistinct):
            continue
        key = a._where_key()
        args = (stacked[f"hll:{a.column}"], rows_t,
                None if key is None else stacked[key], stacked[f"mask:{a.column}"])
        got, want = hll_registers_stacked(*args), hll_registers_stacked_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("hll_registers_stacked differs from the plain version")
        for w in range(width):
            one = hll_registers(*(None if t is None else t[w] for t in args))
            if not torch.equal(one, got[w]):
                raise AssertionError(f"hll_registers_stacked session {w} differs from a "
                                     "one-session launch")
        valid = args[1] & args[3]
        k = torch.where(valid, args[0].to(torch.int32), 0)
        regs = (torch.arange(width, device=device)[:, None] * 512 + (k >> 6).long()).reshape(-1)
        ranks = (k & 63).reshape(-1)
        library = _time_ms(torch, lambda: torch.zeros(width * 512, dtype=torch.int32,
                                                      device=device)
                           .scatter_reduce_(0, regs, ranks, "amax"))
        nbytes = sum(t.numel() * t.element_size() for t in args if t is not None) \
            + width * 512 * 4
        add("hll_registers_stacked", f"{label}, {a.column}", _max_abs_err(got, want),
            _time_kernel_ms(torch, lambda: hll_registers_stacked(*args)),
            _time_ms(torch, lambda: hll_registers_stacked_plain(*args)),
            nbytes, 2 * width * rows, library)
    _print_kernel_totals(results, STACKED_KERNELS, f"coalesced group {label}")
    return results


def _stream_oracle(table: pa.Table, i: int, rows: int) -> dict:
    """numpy's exact metrics of session i's micro-batches, keyed like
    :func:`metric_values` (``Mean``, ``Sum``, ``StandardDeviation`` and
    ``Correlation`` within 1e-9; the rest exactly)."""
    cols = {c: np.concatenate([stream_slice(table, i, b, rows).column(c).to_numpy()
                               for b in range(STREAM_BATCHES)]) for c in ("x", "y", "v")}
    x, y, v = cols["x"], cols["y"], cols["v"]
    return {
        ("Size", "*", None): float(len(x)),
        ("Completeness", "x", None): 1.0,
        ("Mean", "y", None): float(np.mean(y)),
        ("StandardDeviation", "y", None): float(np.std(y)),
        ("Minimum", "v", None): float(v.min()),
        ("Maximum", "v", None): float(v.max()),
        ("Sum", "v", None): float(v.sum()),
        ("Correlation", "x,y", None): float(np.corrcoef(x, y)[0, 1]),
    }


def session_partitions(torch, dq, table: pa.Table) -> None:
    """Phase 8 (f): ``STREAM_WIDTH`` sessions of (b)'s shape on a
    ``VerificationService(partition_store=...)`` (a temporary directory)
    close, each flushing its states as partition ``session-<tenant>``;
    ``svc.verify_partitioned`` over them reads no payload, counts every row
    folded and equals the merge of the sessions' own states bit for bit."""
    import shutil
    import tempfile

    import deequ_tpu_torch.service as service
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers

    root = tempfile.mkdtemp(prefix="chip-smoke-session-store-")
    try:
        with service_knobs(**DEVICE_FOLDS), service.VerificationService(STREAM_WORKERS, STREAM_QUEUE, device="cuda",
                                         background_warm=False, partition_store=root) as svc:
            checks = [stream_check(dq)]
            sessions = [svc.session(f"t{i:02d}", "stream", checks) for i in range(STREAM_WIDTH)]
            t0 = time.perf_counter()
            handles = [s.ingest(stream_slice(table, i, b, STREAM_ROWS), wait=False)
                       for b in range(STREAM_BATCHES) for i, s in enumerate(sessions)]
            for h in handles:
                h.result(STREAM_WAIT_S)
            for s in sessions:
                s.close()
            torch.cuda.synchronize()
            folded = time.perf_counter() - t0
            store = svc.partition_store
            names = store.list_partitions("stream")
            want_names = [f"session-t{i:02d}" for i in range(STREAM_WIDTH)]
            if names != want_names:
                raise AssertionError(f"stream (f): the store lists {names}")
            tokens = {n: store.get("stream", n).content_checksum for n in names}
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            result = svc.verify_partitioned("stream", {n: None for n in names}, checks,
                                            checksums=tokens, timeout=STREAM_WAIT_S)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: v for k, v in launch_counts().items() if v}
            counters = svc.json_snapshot()["counters"]
        analyzers = collect_required_analyzers(checks)
        schema = dq.Dataset.from_arrow(table.slice(0, 1)).schema
        merged = dq.AnalysisRunner.run_on_aggregated_states(
            schema, analyzers, [s.provider for s in sessions], device="cuda")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows = STREAM_WIDTH * STREAM_BATCHES * STREAM_ROWS
    got = metric_values(result)
    report = result.incremental
    print(f"[stream (f)] {STREAM_WIDTH} sessions folded and flushed in {folded:.3f}s; "
          f"verify_partitioned over their {len(names)} partitions in {seconds:.3f}s, "
          f"{report.rows_scanned} of {report.rows_total} rows scanned; launches={launches}; "
          f"partition counters "
          f"{ {k: v for k, v in counters.items() if k.startswith('deequ_service_partitions')} }",
          flush=True)
    problems = compare_metrics(got, metric_values(dq.VerificationSuite.evaluate(
        checks, merged)), 0.0)
    if got[("Size", "*", None)] != float(rows) or not report.plan.fully_reused:
        problems.append(f"Size {got[('Size', '*', None)]} of {rows} rows; plan "
                        f"{report.plan.as_dict()}")
    if problems:
        raise AssertionError("stream (f) disagrees:\n" + "\n".join(problems))


def streaming_service(torch, dq, seed: int) -> tuple:
    """Phase 8: (a) the stacked kernels at two group shapes; (b) the
    coalesced run of 1,000 sessions x 2 x 4,096 rows and (c) its first 250
    sessions with serial folds, every session's metrics bit for bit; (d) 100
    sessions x 2 x 65,536 rows, coalesced and serial, held likewise; (e)
    16 of (b)'s sessions re-run on the CPU (counts, HLL and KLL bit for
    bit, moments within 1e-12), and numpy's exact metrics and KLL ranks.
    Returns the stacked kernels' measurements at (b)'s group shape and
    (b)'s launches."""
    t0 = time.perf_counter()
    table = build_stream_table(STREAM_SESSIONS, STREAM_BATCHES, STREAM_ROWS, STREAM_SEED + seed)
    large = build_stream_table(STREAM_LARGE_SESSIONS, STREAM_BATCHES, STREAM_LARGE_ROWS,
                               STREAM_SEED + 1 + seed)
    print(f"[stream data] {table.num_rows} + {large.num_rows} rows in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    measured = check_stacked_kernels(torch, dq, table, STREAM_ROWS)
    check_stacked_kernels(torch, dq, large, STREAM_LARGE_ROWS)

    coalesced, _, launches = stream_run(torch, dq, table, STREAM_SESSIONS, STREAM_ROWS, True,
                                        label="stream (b) coalesced", kernels=STREAM_KERNELS)
    serial, _, _ = stream_run(torch, dq, table, STREAM_SERIAL_SESSIONS, STREAM_ROWS, False,
                              label="stream (c) serial", kernels=("scan_reduce", "state_fold"))
    problems = [f"(c) session {i}: {p}" for i, (g, w) in enumerate(zip(coalesced, serial))
                for p in compare_metrics(g, w, 0.0)]
    big_c, _, _ = stream_run(torch, dq, large, STREAM_LARGE_SESSIONS, STREAM_LARGE_ROWS, True,
                             label="stream (d) coalesced", kernels=STREAM_KERNELS)
    big_s, _, _ = stream_run(torch, dq, large, STREAM_LARGE_SESSIONS, STREAM_LARGE_ROWS, False,
                             label="stream (d) serial", kernels=("scan_reduce", "state_fold"))
    problems += [f"(d) session {i}: {p}" for i, (g, w) in enumerate(zip(big_c, big_s))
                 for p in compare_metrics(g, w, 0.0)]
    cpu, _, _ = stream_run(torch, dq, table, STREAM_CPU_SESSIONS, STREAM_ROWS, True,
                           device="cpu", label="stream (e) on the CPU")
    problems += [f"(e) session {i}: {p}" for i, (g, w) in enumerate(zip(coalesced, cpu))
                 for p in compare_metrics(g, w)]
    worst = 0.0
    for i in range(STREAM_CPU_SESSIONS):
        problems += [f"(e) session {i} oracle: {p}"
                     for p in compare_oracle(coalesced[i], _stream_oracle(table, i, STREAM_ROWS))]
        v = np.concatenate([stream_slice(table, i, b, STREAM_ROWS).column("v").to_numpy()
                            for b in range(STREAM_BATCHES)])
        items = np.sort(v.astype(np.float32))
        worst = max(worst, _rank_error(items, coalesced[i][("ApproxQuantile-0.5", "v", None)], 0.5))
    if worst > STREAM_KLL_RANK_LIMIT:
        problems.append(f"(e) KLL median rank error {worst} above {STREAM_KLL_RANK_LIMIT}")
    if problems:
        raise AssertionError("phase 8 disagrees:\n" + "\n".join(problems[:40]))
    # (f) sessions flushing into a partition store as they close
    with part_seconds("phase 8 (f)"):
        session_partitions(torch, dq, table)
    print(f"[stream metrics] (b) = (c) for {STREAM_SERIAL_SESSIONS} sessions and (d) coalesced = "
          f"serial for {STREAM_LARGE_SESSIONS}, bit for bit; {STREAM_CPU_SESSIONS} sessions "
          f"equal their CPU run and the oracle; largest KLL median rank error {worst:.6f} "
          f"(limit {STREAM_KLL_RANK_LIMIT})", flush=True)
    return measured, launches


# ---------------------------------------------------------------------------
# phase 11: resumable ingest, each part where its data lives
# ---------------------------------------------------------------------------

#: phase 11 (c)'s batches: 62 over the mesh cut, two chunk folds of 32
MESH_RESUME_BATCH_ROWS = 1 << 14


def interrupted_then_resumed(torch, dq, label: str, run, spec, every: int, kernels=()) -> tuple:
    """``run(monitor, checkpointer)`` interrupted by ``spec`` with an
    ``IngestCheckpointer`` over a ``FileSystemStateProvider`` in a
    temporary directory, then run again with a fresh checkpointer over the
    same directory. Prints both runs' seconds and the resumed run's
    launches; fails when the fault did not fire, no checkpoint was saved,
    or the resumed run launched no kernel of ``kernels``. Returns the
    resumed run's output, its monitor and the interrupted run's saves."""
    import shutil
    import tempfile

    from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.reliability import IngestCheckpointer, inject

    root = tempfile.mkdtemp(prefix="chip-smoke-checkpoint-")
    try:
        first = IngestCheckpointer(FileSystemStateProvider(root), every=every)
        t0 = time.perf_counter()
        with inject(spec) as injector:
            try:
                run(dq.RunMonitor(), first)
            except KeyboardInterrupt:
                pass
            else:
                raise AssertionError(f"{label}: the interrupt did not stop the run")
        torch.cuda.synchronize()
        cut = time.perf_counter() - t0
        if not injector.fired or not first.saves:
            raise AssertionError(f"{label}: fired {injector.fired}, saves {first.saves}")
        monitor = dq.RunMonitor()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run(monitor, IngestCheckpointer(FileSystemStateProvider(root), every=every))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[{label}] interrupted at {injector.fired} after {cut:.3f}s with checkpoints at "
          f"{[i for i, _ in first.saves]}; resumed at batch {monitor.resumed_at_batch}, "
          f"{monitor.batches} batches in {seconds:.3f}s; checkpoint_saves="
          f"{monitor.checkpoint_saves}; launches={launches}", flush=True)
    missing = [k for k in kernels if not launches.get(k)]
    if missing:
        raise AssertionError(f"{label}: the resumed run launched no {missing}")
    return out, monitor, first.saves


def resumable_device_tier(torch, dq, data, check, rows: int, device_metrics: dict) -> None:
    """Phase 11 (a): phase 3's run with ``checkpoint_with`` (every 4
    batches), interrupted before its 7th batch; the resumed run re-enters
    at batch 4, folds only the 6 batches after it and equals phase 3's
    uninterrupted run bit for bit."""
    from deequ_tpu_torch.reliability import FaultSpec

    def run(monitor, checkpointer):
        return (dq.VerificationSuite.on_data(data, device="cuda").add_check(check)
                .add_required_analyzer(dq.CountDistinct("cat_large"))
                .with_monitor(monitor).checkpoint_with(checkpointer).run())

    result, monitor, _ = interrupted_then_resumed(
        torch, dq, "resume (a) device tier", run,
        FaultSpec("device_update", "interrupt", at=7), 4, VERIFICATION_KERNELS)
    batches = -(-rows // BATCH_ROWS)
    problems = compare_metrics(metric_values(result), device_metrics, 0.0)
    if monitor.resumed_at_batch != 4 or monitor.batches != batches - 4:
        problems.append(f"resumed at {monitor.resumed_at_batch} with {monitor.batches} batches")
    if problems:
        raise AssertionError("resume (a) disagrees:\n" + "\n".join(problems))


def resumable_host_tier(torch, dq, run, want: dict) -> None:
    """Phase 11 (b): 7 (a)'s run (40 batches of 2^18 rows) with a checkpoint
    every 8 batches, interrupted at batch 38's host partial; the resumed run
    re-enters at the chunk boundary 32 and equals 7 (a)'s run bit for
    bit."""
    from deequ_tpu_torch.reliability import FaultSpec

    result, monitor, saves = interrupted_then_resumed(
        torch, dq, "resume (b) host tier", run, FaultSpec("host_partial", "interrupt", match="38"),
        8, HOST_KERNELS)
    problems = compare_metrics(metric_values(result), want, 0.0)
    if [i for i, _ in saves] != [CHUNK] or monitor.resumed_at_batch != CHUNK:
        problems.append(f"saves {saves}, resumed at {monitor.resumed_at_batch}")
    if problems:
        raise AssertionError("resume (b) disagrees:\n" + "\n".join(problems))


def resumable_mesh(torch, dq, table: pa.Table) -> None:
    """Phase 11 (c): the host tier over ``make_mesh(8, device="cuda")`` on
    ``MESH_CUT_ROWS`` rows in batches of ``MESH_RESUME_BATCH_ROWS``,
    interrupted at its second chunk fold; the checkpoint (the shards'
    merged states after the first chunk) resumes on ``make_mesh(4)`` and
    on the plain host tier. Both equal the uninterrupted mesh run: counts,
    minima, maxima, HLL and statuses exactly, moments within 1e-12 (the
    shards' sums associate differently), the quantile within
    ``HOST_KLL_RANK_LIMIT`` of numpy's."""
    import shutil
    import tempfile

    from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.parallel import make_mesh
    from deequ_tpu_torch.reliability import FaultSpec, IngestCheckpointer, inject

    cut = table.slice(0, MESH_CUT_ROWS)
    quantile = dq.ApproxQuantile("a", 0.5, KLL_RELATIVE_ERROR)
    qkey = metric_key(quantile)

    def run(monitor, shards, checkpointer=None):
        builder = (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(cut), device="cuda")
                   .add_check(build_check(dq, cut.num_rows))
                   .add_required_analyzers([dq.CountDistinct("cat_large"), quantile])
                   .with_batch_size(MESH_RESUME_BATCH_ROWS).with_placement("host")
                   .with_monitor(monitor))
        if shards:
            builder = builder.with_sharding(make_mesh(shards, device="cuda"))
        if checkpointer is not None:
            builder = builder.checkpoint_with(checkpointer)
        return builder.run()

    want = metric_values(run(dq.RunMonitor(), MESH_SHARDS))
    root = tempfile.mkdtemp(prefix="chip-smoke-mesh-checkpoint-")
    problems = []
    try:
        first = IngestCheckpointer(FileSystemStateProvider(f"{root}/on8"), every=8)
        with inject(FaultSpec("ingest_fold", "interrupt", at=2)):
            try:
                run(dq.RunMonitor(), MESH_SHARDS, first)
                problems.append("the interrupt did not stop the mesh run")
            except KeyboardInterrupt:
                pass
        shutil.copytree(f"{root}/on8", f"{root}/copy")
        for shards, where in ((4, f"{root}/on8"), (0, f"{root}/copy")):
            monitor = dq.RunMonitor()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            got = metric_values(run(monitor, shards, IngestCheckpointer(
                FileSystemStateProvider(where), every=8)))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: v for k, v in launch_counts().items() if v}
            label = f"make_mesh({shards})" if shards else "the plain host tier"
            print(f"[resume (c) on {label}] checkpoints of the 8-shard run at "
                  f"{[i for i, _ in first.saves]}; resumed at batch {monitor.resumed_at_batch}, "
                  f"{monitor.batches} batches in {seconds:.3f}s; launches={launches}",
                  flush=True)
            if monitor.resumed_at_batch != CHUNK or (shards and monitor.shard_losses):
                problems.append(f"{label}: resumed at {monitor.resumed_at_batch}")
            problems += [f"{label}: {p}" for p in compare_metrics(_without(got, qkey),
                                                                  _without(want, qkey))]
            error = _quantile_error(cut, got[qkey])
            if error > HOST_KLL_RANK_LIMIT:
                problems.append(f"{label}: ApproxQuantile(a) rank error {error}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError("resume (c) disagrees:\n" + "\n".join(problems))
    print("[resume (c) metrics] a checkpoint of the 8-shard mesh resumed on 4 shards and on "
          "the plain host tier with the uninterrupted mesh run's metrics", flush=True)


# ---------------------------------------------------------------------------
# phase 12: the tenant plane (the catalog, the row gate, the Arrow IPC
# ingest, the fleet watch with Holt-Winters, /statusz and JVM interop)
# ---------------------------------------------------------------------------

#: (a) the catalog soak at its documented full size (tools/catalog_soak.py
#: ``--registered 10000 --active 500``): 3 micro-batches of 2,048 rows a
#: hot tenant, on the service of phase 8
TENANT_REGISTERED = 10_000
TENANT_ACTIVE = 500
TENANT_BATCHES = 3
TENANT_ROWS = 2048
#: (a) this many hot tenants re-run on the CPU and against numpy
TENANT_CPU_TENANTS = 16
TENANT_SEED = 23
#: (b) the catalog soak's drill 4 (24 frames x 65,536 rows, gated against
#: ungated in 4 rounds) and the ingest soak's stream (tools/ingest_soak.py
#: ``--stream-mb 512``, in frames of 65,536 rows)
GATE_BATCHES = 24
GATE_ROWS = 65_536
GATE_ROUNDS = 4
WIRE_MB = 512
WIRE_ROWS = 65_536
#: (c) tools/anomaly_fleet_bench.py ``--series 10000`` (seed 17), and the
#: live harvest's tenants, each with five weeks of daily Size history and a
#: newest day, a weekly pattern with 1.5% noise. At that noise the watch's
#: 1.96-sigma rule flags about one clean newest day in five; with seed 25
#: the plain recurrence (``hw_oracle``) flags none of the clean ones
FLEET_SERIES = 10_000
FLEET_SEED = 17
WATCH_TENANTS = 16
WATCH_DAYS = 35
WATCH_BASE_ROWS = 3000
WATCH_WEEK = (1.0, 1.1, 1.15, 1.05, 0.95, 0.85, 0.9)
WATCH_SEED = 25
#: (d) the KLL state's rows and the JVM metrics history's days
INTEROP_ROWS = 1_000_000
JVM_HISTORY_DAYS = 365
#: bound on every wait of phase 12
TENANT_WAIT_S = 300
#: what each part must launch: (a) the coalesced tenant folds (K1's and
#: K2's stacked entries, K4 and K5 per session, K8 into the persisted
#: states); (b) the wire's coalesced folds; (c) the newest folds (K1);
#: (d) the merges of the read-back states (K8, K5's merge); (e) the
#: applicability run's K1. The wire's battery has no HLL column.
TENANT_KERNELS = STACKED_KERNELS + ("kll_sample", "kll_compact", "state_fold")
WIRE_KERNELS = ("scan_reduce_stacked", "state_fold")
WATCH_KERNELS = ("scan_reduce",)
INTEROP_KERNELS = ("state_fold", "kll_compact")
APPLICABILITY_KERNELS = ("scan_reduce",)


def tenant_doc(priority: str = "normal", max_len: int = 8) -> dict:
    """The catalog soak's document (tools/catalog_soak.py ``_doc``): three
    constraints and a two-column row gate."""
    return {
        "checks": [{"name": "soak", "constraints": [
            {"kind": "complete", "column": "id"},
            {"kind": "min", "column": "v", "min": 0},
            {"kind": "size", "min": 1},
        ]}],
        "row_gate": {"columns": [
            {"name": "id", "type": "int", "nullable": False},
            {"name": "s", "type": "string", "max_length": max_len},
        ]},
        "priority": priority,
        "session": {"admission_block_s": 10.0},
    }


def tenant_frame(i: int, b: int, rows: int = TENANT_ROWS, s: str = "ok") -> dict:
    """Tenant ``i``'s micro-batch ``b`` (the soak's ``_frame``: ids, a short
    string, ``v``), with ``v`` drawn from a seed per tenant and batch."""
    rng = np.random.default_rng([TENANT_SEED, i, b])
    return {
        "id": np.arange(b * rows, (b + 1) * rows),
        "s": np.array([s] * rows),
        "v": rng.exponential(10.0, rows),
    }


def sketch_check(dq):
    """The ApproxQuantile on ``v`` the phase adds to each hot tenant's
    document checks (so K4 and K5 fold), with an ApproxCountDistinct on
    ``id`` (so K2's stacked entry does): the document's constraint kinds
    carry neither quantiles nor the checks' analyzers, so the harness
    installs it on the materialized session with ``reconfigure``."""
    def yes(_):
        return True

    return (dq.Check(dq.CheckLevel.ERROR, "sketches")
            .has_approx_quantile("v", 0.5, yes)
            .has_approx_count_distinct("id", yes))


def _launched(label: str, launches: dict, kernels) -> None:
    missing = [name for name in kernels if launches.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"{label} launched no {missing}: {launches}")


def catalog_hot_tier(svc, dq, tenants: list, frames_of) -> tuple:
    """Materialize ``tenants`` from the catalog, install :func:`sketch_check`
    and fold each tenant's frames, fed by 32 threads. Returns the sessions
    and the number of folds that succeeded; fails on a shed or a failed
    fold."""
    import threading

    plane = svc.catalog_plane
    sessions = {}
    for t in tenants:
        session = plane.ensure_session(t, "stream")
        session.reconfigure(checks=[*session.checks, sketch_check(dq)])
        sessions[t] = session
    handles, errors, lock = [], [], threading.Lock()

    def feed(chunk):
        mine = []
        for t in chunk:
            for frame in frames_of(t):
                try:
                    mine.append(sessions[t].ingest(frame, wait=False))
                except Exception as exc:  # noqa: BLE001 - the phase fails on any
                    with lock:
                        errors.append(f"{t}: {type(exc).__name__}: {exc}")
        with lock:
            handles.extend(mine)

    threads = [threading.Thread(target=feed, args=(tenants[f::32],), daemon=True)
               for f in range(min(32, len(tenants)))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(TENANT_WAIT_S)
    ok = 0
    for h in handles:
        try:
            ok += h.result(TENANT_WAIT_S).status.name == "SUCCESS"
        except Exception as exc:  # noqa: BLE001 - counted: the phase fails on any
            errors.append(f"{type(exc).__name__}: {exc}")
    if errors:
        raise AssertionError("tenant folds failed:\n" + "\n".join(errors[:20]))
    return sessions, ok


def _tenant_oracle(i: int) -> tuple:
    frames = [tenant_frame(i, b) for b in range(TENANT_BATCHES)]
    v = np.concatenate([f["v"] for f in frames])
    want = {("Size", "*", None): float(len(v)), ("Completeness", "id", None): 1.0,
            ("Minimum", "v", None): float(v.min())}
    return want, np.sort(v.astype(np.float32))


def catalog_soak(torch, dq) -> None:
    """Phase 12 (a): tiering at the soak's full size, the edit and corrupt
    drills, 16 hot tenants against the CPU and numpy."""
    import os
    import shutil
    import tempfile

    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.service import TenantCatalog, VerificationService
    from deequ_tpu_torch.service.scheduler import Priority

    root = tempfile.mkdtemp(prefix="chip-smoke-catalog-")
    try:
        catalog = TenantCatalog(os.path.join(root, "catalog"))
        t0 = time.perf_counter()
        for i in range(TENANT_REGISTERED):
            catalog.register(f"tenant-{i:06d}", tenant_doc())
        register_s = time.perf_counter() - t0
        hot = [f"tenant-{i:06d}" for i in range(TENANT_ACTIVE)]
        index = {t: i for i, t in enumerate(hot)}

        def frames_of(t):
            return [tenant_frame(index[t], b) for b in range(TENANT_BATCHES)]

        with service_knobs(**DEVICE_FOLDS), VerificationService(
                STREAM_WORKERS, STREAM_QUEUE, device="cuda", background_warm=False,
                catalog=catalog) as svc:
            plane = svc.catalog_plane
            plane.poll_s = 0.0  # the drills must not wait out a debounce
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            sessions, folds_ok = catalog_hot_tier(svc, dq, hot, frames_of)
            torch.cuda.synchronize()
            soak_s = time.perf_counter() - t0
            launches = launch_counts()
            card = {t: metric_values(sessions[t].latest) for t in hot[1:1 + TENANT_CPU_TENANTS]}
            shed = (svc.metrics.counter_value("deequ_service_jobs_shed_total")
                    + svc.metrics.counter_value("deequ_service_quota_shed_total"))
            summary = {"registered": catalog.registered_count(), "hot": plane.hot_count(),
                       "folds_ok": folds_ok, "shed": shed}
            print(f"[tenant (a)] {TENANT_REGISTERED} registered in {register_s:.1f}s; "
                  f"{TENANT_ACTIVE} hot x {TENANT_BATCHES} x {TENANT_ROWS} rows in "
                  f"{soak_s:.2f}s = {TENANT_ACTIVE * TENANT_BATCHES / soak_s:.1f} folds/s; "
                  f"{summary}; launches={launches}", flush=True)
            if summary != {"registered": TENANT_REGISTERED, "hot": TENANT_ACTIVE,
                           "folds_ok": TENANT_ACTIVE * TENANT_BATCHES, "shed": 0}:
                raise AssertionError(f"tiering: {summary}")
            _launched("phase 12 (a)", launches, TENANT_KERNELS)

            # the mid-soak edit: a lower priority and a looser gate, live at
            # the next fold boundary without a restart
            victim = hot[0]
            session = sessions[victim]
            catalog.register(victim, tenant_doc(priority="low", max_len=64))
            plane.on_fold_boundary(session)
            rows_before = session.rows_ingested
            edit = session.ingest(tenant_frame(0, TENANT_BATCHES, s="x" * 32),
                                  timeout=TENANT_WAIT_S)
            reloads = svc.metrics.counter_value("deequ_service_catalog_reloads_total",
                                                tenant=victim)
            edit_drill = {"priority_live": session.priority is Priority.LOW,
                          "loosened_gate_live": edit.status.name == "SUCCESS"
                          and session.rows_ingested == rows_before + TENANT_ROWS,
                          "reloads": reloads}
            # the corrupt edit: last-good keeps serving, one quarantine
            torn = os.path.join(catalog.path, f"t-{victim}", "v00000099.json")
            with open(torn, "w") as fh:
                fh.write('{"torn": tru')
            before = svc.metrics.counter_value("deequ_service_catalog_quarantined_total",
                                               tenant=victim)
            for _ in range(3):
                plane.on_fold_boundary(session)
            served = session.ingest(tenant_frame(0, TENANT_BATCHES + 1, s="x" * 32),
                                    timeout=TENANT_WAIT_S)
            bumps = svc.metrics.counter_value("deequ_service_catalog_quarantined_total",
                                              tenant=victim) - before
            qdir = catalog.path + ".quarantine"
            preserved = [n for n in os.listdir(qdir) if n.startswith("v00000099.json-")]
            corrupt_drill = {"still_serving": served.status.name == "SUCCESS",
                             "config_kept": session.priority is Priority.LOW,
                             "quarantine_bumps": bumps, "preserved": len(preserved)}
            print(f"[tenant (a) drills] edit {edit_drill}; corrupt {corrupt_drill}", flush=True)
            if edit_drill != {"priority_live": True, "loosened_gate_live": True, "reloads": 1}:
                raise AssertionError(f"edit drill: {edit_drill}")
            if corrupt_drill != {"still_serving": True, "config_kept": True,
                                 "quarantine_bumps": 1, "preserved": 1}:
                raise AssertionError(f"corrupt drill: {corrupt_drill}")

        # the same tenants, frames and checks on the CPU, and numpy
        cpu_catalog = TenantCatalog(os.path.join(root, "cpu-catalog"))
        compared = list(card)
        for t in compared:
            cpu_catalog.register(t, tenant_doc())
        with service_knobs(**DEVICE_FOLDS), VerificationService(
                STREAM_WORKERS, STREAM_QUEUE, device="cpu", background_warm=False,
                catalog=cpu_catalog) as svc:
            cpu_sessions, _ = catalog_hot_tier(svc, dq, compared, frames_of)
            cpu = {t: metric_values(cpu_sessions[t].latest) for t in compared}
        problems, worst = [], 0.0
        for t in compared:
            problems += [f"{t}: {p}" for p in compare_metrics(card[t], cpu[t])]
            want, items = _tenant_oracle(index[t])
            problems += [f"{t} oracle: {p}" for p in compare_oracle(card[t], want, 0.0)]
            worst = max(worst, _rank_error(items, card[t][("ApproxQuantile-0.5", "v", None)], 0.5))
        if worst > STREAM_KLL_RANK_LIMIT:
            problems.append(f"KLL median rank error {worst} above {STREAM_KLL_RANK_LIMIT}")
        if problems:
            raise AssertionError("phase 12 (a) disagrees:\n" + "\n".join(problems[:40]))
        print(f"[tenant (a) metrics] {len(compared)} hot tenants equal their CPU run (moments "
              f"within 1e-12) and numpy; largest KLL median rank error {worst:.6f}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def wire_checks(dq):
    """The ingest soak's battery (tools/ingest_soak.py ``_checks``)."""
    return [dq.Check(dq.CheckLevel.ERROR, "ingest battery")
            .has_size(lambda n: n > 0)
            .is_complete("x")
            .has_mean("y", lambda m: -100.0 < m < 100.0)]


def gate_checks(dq):
    """The catalog soak's drill-4 battery (tools/catalog_soak.py
    ``run_gate_throughput``)."""
    return [dq.Check(dq.CheckLevel.ERROR, "gate-throughput")
            .has_size(lambda n: n > 0)
            .is_complete("id")
            .has_mean("v", lambda m: 0.0 < m < 20.0)
            .has_sum("v", lambda s: s > 0)]


def _post(exporter, path: str, body: bytes, headers=None) -> tuple:
    import http.client

    conn = http.client.HTTPConnection(exporter.host, exporter.port, timeout=60)
    try:
        conn.request("POST", path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def gate_and_wire(torch, dq) -> None:
    """Phase 12 (b): gated against ungated, the 512 MB Arrow IPC stream
    through ``fold_stream`` against ``session.ingest``, and the HTTP
    endpoint's statuses."""
    from deequ_tpu_torch.ingest import (
        CHECKSUM_HEADER, RowGate, encode_ipc_stream, fold_stream)
    from deequ_tpu_torch.integrity import checksum_bytes
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.schema import RowLevelSchema
    from deequ_tpu_torch.service import VerificationService

    rng = np.random.default_rng(11)
    payloads = [encode_ipc_stream(pa.table({
        "id": pa.array(np.arange(b * GATE_ROWS, (b + 1) * GATE_ROWS)),
        "v": pa.array(rng.normal(10.0, 2.0, size=GATE_ROWS))})) for b in range(GATE_BATCHES)]
    gate_mb = sum(len(p) for p in payloads) / 2**20
    with service_knobs(**DEVICE_FOLDS), VerificationService(
            2, 64, device="cuda", background_warm=False) as svc:
        gate = RowGate(RowLevelSchema().with_int_column("id", is_nullable=False),
                       metrics=svc.metrics)
        kinds = {"ungated": {}, "gated": {"row_gate": gate}}
        # one warm frame down each kind first, so that neither timed stream
        # pays the battery's first fold; then the kinds alternate in order
        # from round to round, and the fraction is the median of the rounds'
        for name, kw in kinds.items():
            fold_stream(svc.session("tp-warm", name, gate_checks(dq), **kw), payloads[0],
                        source="warm")
        fractions, problems, gate_rows = [], [], []
        for r in range(GATE_ROUNDS):
            timings, values = {}, {}
            for name in sorted(kinds, reverse=r % 2 == 1):
                session = svc.session("tp", f"{name}{r}", gate_checks(dq), **kinds[name])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for payload in payloads:
                    fold_stream(session, payload, source=name)
                torch.cuda.synchronize()
                timings[name] = time.perf_counter() - t0
                values[name] = metric_values(session.current())
            fractions.append(timings["ungated"] / timings["gated"])
            problems += compare_metrics(values["gated"], values["ungated"], 0.0)
            gate_rows.append(svc.metrics.counter_value("deequ_service_rowgate_rows_total",
                                                       tenant="tp", dataset=f"gated{r}"))
            print(f"[tenant (b) gate] round {r} ({' then '.join(timings)}): "
                  f"{GATE_BATCHES} x {GATE_ROWS} rows ({gate_mb:.1f} MiB): ungated "
                  f"{gate_mb / timings['ungated']:.1f} MiB/s, gated "
                  f"{gate_mb / timings['gated']:.1f} MiB/s; fraction {fractions[-1]:.3f}; "
                  f"gate rows {gate_rows[-1]:.0f}", flush=True)
        print(f"[tenant (b) gate] gated_throughput_fraction {float(np.median(fractions)):.3f} "
              f"(median of {GATE_ROUNDS} rounds: {[round(f, 3) for f in fractions]})",
              flush=True)
        if problems or gate_rows != [GATE_BATCHES * GATE_ROWS] * GATE_ROUNDS:
            raise AssertionError(f"gated against ungated: {problems}, gate rows {gate_rows}")

        # the ingest soak's stream: one session fed through fold_stream
        soak = pa.table({"x": rng.normal(size=WIRE_ROWS), "y": rng.normal(10.0, 2.0, WIRE_ROWS),
                         "k": rng.integers(0, 1000, WIRE_ROWS), "v": rng.uniform(0, 1, WIRE_ROWS)})
        payload = encode_ipc_stream(soak)
        streams = max(1, int(WIRE_MB * 1e6 / len(payload)))
        wire = svc.session("tput", "stream", wire_checks(dq), admission_block_s=60.0)
        svc.session("tput-warm", "stream", wire_checks(dq)).ingest(soak, timeout=TENANT_WAIT_S)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        frames = sum(fold_stream(wire, payload, source="soak").frames for _ in range(streams))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        mb = streams * len(payload) / 1e6
        print(f"[tenant (b) wire] {frames} frames, {mb:.1f} MB in {wall:.2f}s = "
              f"{mb / wall:.1f} MB/s, {streams * WIRE_ROWS / wall:.0f} rows/s; "
              f"launches={launches}", flush=True)
        _launched("phase 12 (b)", launches, WIRE_KERNELS)
        direct = svc.session("tput", "direct", wire_checks(dq), admission_block_s=60.0)
        for _ in range(streams):
            direct.ingest(soak, timeout=TENANT_WAIT_S)
        problems = compare_metrics(metric_values(wire.current()), metric_values(direct.current()),
                                   0.0)
        if problems or wire.rows_ingested != streams * WIRE_ROWS:
            raise AssertionError(f"fold_stream against session.ingest: {problems}")

        # the HTTP endpoint on the exporter
        exporter = svc.start_exporter(host="127.0.0.1", port=0)
        svc.session("wire", "d", wire_checks(dq))
        small = encode_ipc_stream(soak.slice(0, 4096), max_chunksize=2048)
        ok = _post(exporter, "/ingest/v1/wire/d", small,
                   {CHECKSUM_HEADER: checksum_bytes(small)})
        bad = _post(exporter, "/ingest/v1/wire/d", small, {CHECKSUM_HEADER: "0" * 16})
        folded = svc.get_session("wire", "d").batches_ingested
        unknown = _post(exporter, "/ingest/v1/nobody/d", small)
        drifted = encode_ipc_stream(pa.table({"x": pa.array(["oops"] * 64),
                                              "y": pa.array(np.ones(64)),
                                              "k": pa.array(np.ones(64, dtype=np.int64)),
                                              "v": pa.array(np.ones(64))}))
        drift = _post(exporter, "/ingest/v1/wire/d", drifted)
        statuses = [ok[0], bad[0], unknown[0], drift[0]]
        print(f"[tenant (b) endpoint] good checksum {ok[0]} ({ok[1].get('frames')} frames), bad "
              f"checksum {bad[0]} {bad[1].get('error')}, unregistered {unknown[0]} "
              f"{unknown[1].get('error')}, drift {drift[0]} {drift[1].get('error')}; "
              f"{folded} frames folded", flush=True)
        if statuses != [200, 400, 404, 409] or folded != 2 or ok[1].get("rows") != 4096:
            raise AssertionError(f"endpoint statuses {statuses}, folded {folded}")


def build_fleet(n_series: int, seed: int = FLEET_SEED) -> list:
    """tools/anomaly_fleet_bench.py ``build_fleet``: N ragged daily metric
    histories (60-120 points, mild drift and noise), about one in eight
    with an anomalous newest point."""
    rng = np.random.default_rng(seed)
    fleet = []
    for i in range(n_series):
        n = int(rng.integers(60, 120))
        base = 50.0 + float(rng.normal(0, 10))
        s = base + 0.02 * np.arange(n) + rng.normal(0, 1.0, n)
        if i % 8 == 0:
            s[-1] += float(rng.choice([-1, 1])) * 25.0
        fleet.append(s.tolist())
    return fleet


def _flags(rows) -> list:
    return [(i, float(a.value), a.detail) for i, a in rows]


def watch_series(i: int, broken: bool) -> list:
    """Tenant ``i``'s daily Size: five weeks of history and the newest day,
    a weekly pattern around ``WATCH_BASE_ROWS`` with 1.5% noise; a broken
    tenant's newest day lies 30% below its pattern."""
    rng = np.random.default_rng([WATCH_SEED, 1000 + i])
    days = [float(round(WATCH_BASE_ROWS * WATCH_WEEK[d % 7] * (1 + 0.015 * rng.normal())))
            for d in range(WATCH_DAYS + 1)]
    if broken:
        days[-1] = float(round(0.7 * days[-1]))
    return days


def hw_oracle(series: list, alpha: float, beta: float, gamma: float) -> tuple:
    """The newest day's forecast and flag by the plain additive Holt-Winters
    recurrence (reference ``HoltWinters.scala:76-124``) and the 1.96-sigma
    residual rule, written here apart from the port; the parameters are the
    ones the watch fitted."""
    m, history = 7, np.asarray(series[:-1], dtype=np.float64)
    level = history[:m].sum() / m
    trend = (history[m:2 * m].sum() - history[:m].sum()) / (m * m)
    season = list(history[:m] - level)
    residuals = []
    for t, y in enumerate(history):
        residuals.append(y - (level + trend + season[t]))
        new_level = alpha * (y - season[t]) + (1 - alpha) * (level + trend)
        season.append(gamma * (y - level - trend) + (1 - gamma) * season[t])
        level, trend = new_level, beta * (new_level - level) + (1 - beta) * trend
    forecast = float(level + trend + season[len(history)])
    band = 1.96 * float(np.std(np.abs(residuals), ddof=1))
    return forecast, abs(series[-1] - forecast) > band


def fleet_watch(torch, dq) -> None:
    """Phase 12 (c): the bench fleet in one batched call, and a live
    Holt-Winters harvest over 16 tenants whose newest folds run on the
    card, one of them broken; then /statusz."""
    import shutil
    import tempfile
    import urllib.request

    from deequ_tpu_torch.anomalydetection import (
        HoltWinters, MetricInterval, OnlineNormalStrategy, SeriesSeasonality)
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.metrics import DoubleMetric, Entity, Success
    from deequ_tpu_torch.repository import PartitionedMetricsRepository, ResultKey
    from deequ_tpu_torch.runners.context import AnalyzerContext
    from deequ_tpu_torch.service import VerificationService
    from deequ_tpu_torch.service.statusz import REQUIRED_PLANES, validate_statusz

    fleet = build_fleet(FLEET_SERIES)
    intervals = [(len(s) - 1, len(s)) for s in fleet]
    strategy = OnlineNormalStrategy()
    t0 = time.perf_counter()
    batched = strategy.detect_batch(fleet, intervals)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = [strategy.detect(s, iv) for s, iv in zip(fleet, intervals)]
    serial_s = time.perf_counter() - t0
    differ = sum(_flags(g) != _flags(w) for g, w in zip(batched, serial))
    flagged = sum(1 for rows in batched if rows)
    print(f"[tenant (c) fleet] {FLEET_SERIES} series: detect_batch {batch_s:.3f}s, serial "
          f"{serial_s:.3f}s; {flagged} flagged; {differ} differ", flush=True)
    if differ or not flagged:
        raise AssertionError(f"detect_batch differs from detect on {differ} series")

    day_ms = 86_400_000
    now_ms = int(time.time() * 1000)
    broken = 5
    root = tempfile.mkdtemp(prefix="chip-smoke-watch-")
    try:
        with service_knobs(DEEQU_TPU_PLACEMENT="device"), VerificationService(
                4, 64, device="cuda", background_warm=False) as svc:
            hw = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY)
            fits, fitted = [], {}
            fit_batch = hw.fit_batch

            def counted_fit(series, intervals):
                params = fit_batch(series, intervals)
                fits.append(len(series))
                fitted.update((tuple(map(float, x)), p) for x, p in zip(series, params))
                return params

            hw.fit_batch = counted_fit
            days = [watch_series(i, i == broken) for i in range(WATCH_TENANTS)]
            repos = {}
            for i in range(WATCH_TENANTS):
                t = f"watched-{i:02d}"
                repos[t] = PartitionedMetricsRepository(f"{root}/{t}")
                for d, size in enumerate(days[i][:WATCH_DAYS]):
                    repos[t].save(ResultKey(now_ms - (WATCH_DAYS - d) * day_ms), AnalyzerContext(
                        {dq.Size(): DoubleMetric(Entity.DATASET, "Size", "*", Success(size))}))
            checks = [dq.Check(dq.CheckLevel.ERROR, "daily").has_size(lambda n: n > 0)]
            rng = np.random.default_rng(TENANT_SEED)

            def day_frame(rows):
                return dq.Dataset.from_dict({"x": rng.normal(size=rows)})

            # the first fold of the battery's row bucket shelters on the host
            # tier (a cold battery with no background warm); later ones run on
            # the card
            svc.verify(day_frame(WATCH_BASE_ROWS), checks, tenant="warm", timeout=TENANT_WAIT_S)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            # each tenant's newest day: a fold on the card that saves its
            # metrics into the tenant's history; tenant 5's day is broken
            handles = []
            for i, t in enumerate(repos):
                rows = int(days[i][-1])
                handles.append(svc.submit_verification(
                    day_frame(rows), checks, tenant=t, metrics_repository=repos[t],
                    save_or_append_results_with_key=ResultKey(now_ms)))
            for h in handles:
                h.result(TENANT_WAIT_S)
            # the standing watch, then one more job of a watched tenant: its
            # harvest schedules the scoring job
            for t, repo in repos.items():
                svc.watch_metrics(t, repo, [dq.Size()], strategy=hw)
            svc.verify(day_frame(WATCH_BASE_ROWS), checks, tenant="watched-00",
                       timeout=TENANT_WAIT_S)
            deadline = time.time() + TENANT_WAIT_S
            while time.time() < deadline and (svc.fleetwatch.last_report is None
                                              or not svc.scheduler.idle()
                                              or svc.fleetwatch._job_pending):
                time.sleep(0.05)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            report = svc.fleetwatch.last_report
            counters = svc.json_snapshot()["counters"]
            print(f"[tenant (c) watch] {WATCH_TENANTS} newest folds and the harvest in "
                  f"{wall:.2f}s; report {report}; fits {fits}; launches={launches}", flush=True)
            _launched("phase 12 (c)", launches, WATCH_KERNELS)
            flagged = sorted({(f[0], f[3]) for f in report.flagged}) if report else None
            # the plain recurrence on the same days, with the watch's fits
            if any(tuple(d) not in fitted for d in days):
                raise AssertionError(f"the watch fitted {len(fitted)} of the series")
            oracle = [hw_oracle(d, *fitted[tuple(d)]) for d in days]
            expected = [(f"watched-{i:02d}", WATCH_DAYS) for i, o in enumerate(oracle) if o[1]]
            # the watch's forecast of each flagged day, from its message
            said = {f[0]: float(f[5].split("Forecasted ")[1].split()[0]) for f in report.flagged}
            plain = {t: oracle[int(t[-2:])][0] for t in said}
            print(f"[tenant (c) watch] the plain recurrence flags {expected}; the watch "
                  f"flagged {flagged}; forecasts of the flagged days: the watch's {said}, "
                  f"the plain recurrence's {plain}", flush=True)
            if flagged != expected or any(abs(said[t] - plain[t]) > 1e-9 * abs(plain[t])
                                          for t in said):
                raise AssertionError(f"the harvest flagged {flagged}, the plain recurrence "
                                     f"{expected}")
            if expected != [(f"watched-{broken:02d}", WATCH_DAYS)]:
                raise AssertionError(f"the scenario's clean days are not clean: {expected}")
            if report.series_scored != WATCH_TENANTS or report.detect_calls != 1:
                raise AssertionError(f"the harvest scored {report}")
            scored = counters.get("deequ_service_anomaly_series_scored_total", {})
            moved = {"flagged": counters.get("deequ_service_anomaly_flagged_total", {}),
                     "harvests": counters.get("deequ_service_anomaly_harvests_total", 0),
                     "scored": sorted(scored)}
            if (moved["flagged"] != {f"tenant=watched-{broken:02d}": 1.0} or moved["harvests"] < 1
                    or moved["scored"] != sorted(f"tenant={t}" for t in repos)):
                raise AssertionError(f"the anomaly series: {moved}")
            again = svc.fleetwatch.harvest_now()
            if sum(fits) != WATCH_TENANTS or again.flagged != report.flagged:
                raise AssertionError(f"fits {fits}: the cached fit was not reused")
            exporter = svc.start_exporter(host="127.0.0.1", port=0)
            with urllib.request.urlopen(f"http://{exporter.host}:{exporter.port}/statusz",
                                        timeout=60) as resp:
                doc = json.loads(resp.read())
            problems = validate_statusz(doc)
            print(f"[tenant (c) statusz] planes {sorted(doc['planes'])}; problems {problems}; "
                  f"fleetwatch {doc['planes']['fleetwatch']}", flush=True)
            if problems or not set(REQUIRED_PLANES) <= set(doc["planes"]):
                raise AssertionError(f"/statusz: {problems}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _state_leaves(state) -> dict:
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in ("items", "sizes", "parity", "count", "g_min", "g_max")}


def history_entries(repo) -> list:
    return sorted((r.result_key.data_set_date, tuple(sorted(r.result_key.tags_dict.items())),
                   tuple(sorted((repr(a), m.value.get())
                                for a, m in r.analyzer_context.metric_map.items())))
                  for r in repo.load().get())


def interop_path(torch, dq, table: pa.Table) -> None:
    """Phase 12 (d): HLL and KLL states of the card as JVM blobs, read back
    onto the card and merged with the originals (K8, K5's merge); a year of
    JVM metrics history imported into partitioned repositories."""
    import shutil
    import tempfile

    from deequ_tpu_torch import interop
    from deequ_tpu_torch.analyzers.base import merge_states_batched
    from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.ops.kll import kll_merge
    from deequ_tpu_torch.repository import AnalysisResult, PartitionedMetricsRepository, ResultKey

    data = dq.Dataset.from_arrow(table)
    hll, kll = dq.ApproxCountDistinct("cat_large"), dq.KLLSketch("a")
    provider = InMemoryStateProvider()
    dq.AnalysisRunner.do_analysis_run(data, [hll, kll], batch_size=BATCH_ROWS,
                                      save_states_with=provider, device="cuda")
    # the run's states come back from the card in its one packed fetch;
    # the merges below take them on the card
    hll_state = provider.load(hll)
    hll_state = type(hll_state)(hll_state.registers.to("cuda"))
    kll_state = provider.load(kll)
    kll_state = type(kll_state)(*(leaf.to("cuda") for leaf in kll_state.tensors()),
                                sketch_size=kll_state.sketch_size)
    hll_blob = interop.write_jvm_hll_state_blob(hll_state)
    kll_blob = interop.write_jvm_kll_state_blob(kll_state)
    hll_read = interop.read_jvm_hll_state_blob(hll_blob, device="cuda")
    kll_read, _ = interop.read_jvm_kll_state_blob(kll_blob, device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    merged = merge_states_batched(hll, [hll_state, hll_read], device="cuda")
    doubled = merge_states_batched(hll, [hll_state, hll_state], device="cuda")
    kll_merged, kll_doubled = kll_merge(kll_state, kll_read), kll_merge(kll_state, kll_state)
    torch.cuda.synchronize()
    launches = launch_counts()
    problems = []
    # the reads themselves first: an HLL merge is an elementwise max, so a
    # reader that lost registers would still merge to the original's
    if not torch.equal(hll_read.registers, hll_state.registers) or \
            hll_read.registers.device.type != "cuda":
        problems.append("HLL: the blob reads back other registers")
    got, want = _state_leaves(kll_read), _state_leaves(kll_state)
    problems += [f"KLL read {name}" for name in got if not np.array_equal(got[name], want[name])]
    if kll_read.items.device.type != "cuda":
        problems.append("KLL: the blob reads back off the card")
    if not torch.equal(merged.registers, doubled.registers) or \
            merged.registers.device.type != "cuda":
        problems.append("HLL: the read-back state merges to other registers")
    got, want = _state_leaves(kll_merged), _state_leaves(kll_doubled)
    problems += [f"KLL {name}" for name in got if not np.array_equal(got[name], want[name])]
    print(f"[tenant (d) blobs] HLL blob {len(hll_blob)} bytes, KLL blob {len(kll_blob)} bytes "
          f"({int(kll_state.count)} values); read back and merged with the originals on the "
          f"card: {problems or 'bit for bit'} (KLL ticks aside: the blob carries none); "
          f"launches={launches}", flush=True)
    _launched("phase 12 (d)", launches, INTEROP_KERNELS)
    if problems:
        raise AssertionError(f"interop merges: {problems}")

    root = tempfile.mkdtemp(prefix="chip-smoke-jvm-")
    try:
        battery = [dq.Size(), dq.Mean("a"), dq.Completeness("b"), dq.Uniqueness(["cat_small"])]
        entries = {}
        for device in ("cuda", "cpu"):
            ctx = dq.AnalysisRunner.do_analysis_run(data, battery, batch_size=BATCH_ROWS,
                                                    device=device)
            history = [AnalysisResult(ResultKey(1_704_067_200_000 + d * 86_400_000,
                                                {"table": "orders"}), ctx)
                       for d in range(JVM_HISTORY_DAYS)]
            payload = interop.write_jvm_metrics_history_json(history)
            repo = PartitionedMetricsRepository(f"{root}/{device}")
            t0 = time.perf_counter()
            count = repo.import_jvm_history(payload, source=f"{device}.json")
            seconds = time.perf_counter() - t0
            entries[device] = history_entries(repo)
            print(f"[tenant (d) history] {count} days from the {device} run imported in "
                  f"{seconds:.2f}s ({len(payload)} bytes)", flush=True)
        problems = []
        for g, w in zip(entries["cuda"], entries["cpu"]):
            if g[:2] != w[:2] or [k for k, _ in g[2]] != [k for k, _ in w[2]]:
                problems.append(f"{g[:2]}: keys differ")
                continue
            for (key, gv), (_, wv) in zip(g[2], w[2]):
                if gv != wv and not ("Mean" in key and abs(gv - wv) <= 1e-12 * abs(wv)):
                    problems.append(f"{g[0]} {key}: {gv!r} != {wv!r}")
        if len(entries["cuda"]) != JVM_HISTORY_DAYS or problems:
            raise AssertionError(f"imported histories differ: {problems[:10]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _applicability(result) -> tuple:
    return (result.is_applicable, sorted(result.failures),
            sorted((str(c), ok) for c, ok in result.constraint_applicabilities.items()))


def applicability_path(torch, dq, table: pa.Table) -> None:
    """Phase 12 (e): phase 3's check, and a check that names a missing
    column, on random rows of phase 3's schema, on the card and the CPU."""
    from deequ_tpu_torch.applicability import Applicability
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    schema = dq.Dataset.from_arrow(table.slice(0, 1)).schema
    missing = (dq.Check(dq.CheckLevel.ERROR, "missing").is_complete("no_such_column")
               .has_mean("a", lambda v: True))
    for label, check in (("phase 3's check", build_check(dq, ROWS)), ("missing column", missing)):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        card = Applicability.is_applicable_check(check, schema, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        cpu = Applicability.is_applicable_check(check, schema, device="cpu")
        print(f"[tenant (e) applicability] {label}: applicable {card.is_applicable}, "
              f"{len(card.failures)} failures of {len(card.constraint_applicabilities)} "
              f"constraints in {seconds:.2f}s; launches={launches}", flush=True)
        _launched(f"phase 12 (e) {label}", launches, APPLICABILITY_KERNELS)
        if _applicability(card) != _applicability(cpu):
            raise AssertionError(f"{label}: the card's applicability differs from the CPU's")
    if card.is_applicable or "no_such_column" not in " ".join(card.failures):
        raise AssertionError(f"the missing column was not found: {card.failures}")


def tenant_plane(torch, dq) -> None:
    """Phase 12: the tenant plane on the card, parts (a)-(e), each with its
    seconds. ``python3 -c "import torch, chip_smoke, deequ_tpu_torch as dq;
    chip_smoke.tenant_plane(torch, dq)"`` runs it alone (the kernels build
    at first use), printing no result lines."""
    t0 = time.perf_counter()
    with part_seconds("phase 12 (a)"):
        catalog_soak(torch, dq)
    with part_seconds("phase 12 (b)"):
        gate_and_wire(torch, dq)
    with part_seconds("phase 12 (c)"):
        fleet_watch(torch, dq)
    table = build_table(INTEROP_ROWS, TENANT_SEED)
    with part_seconds("phase 12 (d)"):
        interop_path(torch, dq, table)
    with part_seconds("phase 12 (e)"):
        applicability_path(torch, dq, table)
    print(f"[seconds] phase 12: {time.perf_counter() - t0:.1f}s", flush=True)


# ---------------------------------------------------------------------------
# phase 13: the reliability wrapper, the scan watchdog and the feed pipeline
# ---------------------------------------------------------------------------

#: (a)-(d): phase 3's table cut to its first rows, in 4 batches
DRILL_ROWS = 1_000_000
DRILL_BATCH_ROWS = 1 << 18
#: (c): a real allocator OOM's request, more bytes than any card holds
OOM_BYTES = 1 << 46
#: (d): the scan deadline, the injected stall, and how long after the
#: stall's end no abandoned pass may still be alive
DRILL_DEADLINE_S = 2
DRILL_STALL_S = 6.0
DRILL_SETTLE_S = 5.0
#: (e): the service's micro-batches
SERVICE_ROWS = 65_536
#: (f): phase 3 at these feed depths, in this order, and the feed-stall
#: drill's deadline and stall
FEED_DEPTHS = (0, 2, 2, 0)
FEED_STALL_DEADLINE_S = 1
FEED_STALL_S = 3.0
#: the recovery counters each drill prints and asserts
RECOVERY_FIELDS = ("device_failovers", "batch_bisections", "isolation_reruns", "stalls",
                   "device_stalls")


@contextlib.contextmanager
def _env(name: str, value: str):
    import os

    prior = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prior is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prior


def _recoveries(monitor) -> dict:
    out = {name: getattr(monitor, name) for name in RECOVERY_FIELDS}
    out["degraded"] = list(monitor.degraded)
    return out


def _expect(label: str, monitor, **want) -> list:
    """Problems where ``monitor``'s recovery counters differ from ``want``
    (counters not named must be 0, ``degraded`` empty unless named)."""
    got = _recoveries(monitor)
    full = {name: 0 for name in RECOVERY_FIELDS}
    full["degraded"] = []
    full.update(want)
    return [f"{label}: {name}={got[name]!r}, expected {full[name]!r}"
            for name in full if got[name] != full[name]]


#: the port's phases summed into ``phase_seconds`` alone, with no span
#: (``RunMonitor``'s docstring)
MONITOR_ONLY_PHASES = ("feed_wait", "feature_build.")


def run_trace(label: str, outer=None) -> tuple:
    """The flight recorder's spans of one verification run (recorded since
    its last clear): one trace rooted at ``outer`` (else at the run's
    ``verification_run``), ``verification_run`` -> ``analysis_run`` ->
    every ``engine_pass``, no orphan. Returns the spans, the engine passes
    and every event."""
    from deequ_tpu_torch.observability.recorder import recorder

    spans = recorder().spans()
    by_id = {s.span_id: s for s in spans}

    def parent(s):
        return by_id[s.parent_id].name if s.parent_id in by_id else s.parent_id

    roots = [s.name for s in spans if s.parent_id is None]
    orphans = [s.name for s in spans if s.parent_id is not None and s.parent_id not in by_id]
    problems = []
    if len({s.trace_id for s in spans}) != 1 or roots != [outer or "verification_run"] \
            or orphans:
        problems.append(f"{len({s.trace_id for s in spans})} traces, roots {roots}, "
                        f"orphans {orphans}")
    tree = {s.name: parent(s) for s in spans if s.kind != "phase"}
    want = {"verification_run": outer, "analysis_run": "verification_run",
            "engine_pass": "analysis_run"}
    if any(tree.get(name, "absent") != up for name, up in want.items()):
        problems.append(f"the tree {tree}, expected {want}")
    passes = [s for s in spans if s.name == "engine_pass"]
    if any(parent(s) != "analysis_run" for s in passes):
        problems.append("an engine_pass outside the analysis_run")
    if problems:
        raise AssertionError(f"{label}'s trace: " + "; ".join(problems))
    return spans, passes, [ev for s in spans for ev in s.events]


def check_phase_spans(label: str, spans, monitor) -> dict:
    """Each timed phase of ``monitor`` has spans, and their durations sum
    to its ``phase_seconds`` within 1e-6 relative. Returns the span count
    by phase."""
    totals, counts = {}, {}
    for s in spans:
        if s.kind == "phase":
            totals[s.name] = totals.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
            counts[s.name] = counts.get(s.name, 0) + 1
    timed = {p for p in monitor.phase_seconds if not p.startswith(MONITOR_ONLY_PHASES)}
    # the checks' evaluation is a phase span of the verification, not of
    # the monitor
    if set(totals) - {"constraint_evaluation"} != timed:
        raise AssertionError(f"{label}: phases with spans {sorted(totals)}, timed "
                             f"{sorted(timed)}")
    off = {p: (totals[p], monitor.phase_seconds[p]) for p in timed
           if abs(totals[p] - monitor.phase_seconds[p]) > 1e-6 * monitor.phase_seconds[p] + 1e-9}
    if off:
        raise AssertionError(f"{label}: phase spans against phase_seconds: {off}")
    return counts


def _drill_run(dq, data, rows: int, monitor, device: str = "cuda", batch_size=None,
               placement=None, states=None):
    """Phase 3's checks and its CountDistinct, with an ApproxQuantile (K4
    and K5 on the device tier, K5's ingest entry on the host tier), over
    ``data`` of ``rows`` rows."""
    builder = (dq.VerificationSuite.on_data(data, device=device)
               .add_check(build_check(dq, rows))
               .add_required_analyzer(dq.CountDistinct("cat_large"))
               .add_required_analyzer(dq.ApproxQuantile("a", 0.5, KLL_RELATIVE_ERROR))
               .with_batch_size(batch_size or DRILL_BATCH_ROWS).with_monitor(monitor))
    if placement is not None:
        builder = builder.with_placement(placement)
    if states is not None:
        builder = builder.save_states_with(states)
    return builder.run()


def _battery_size(dq, data, rows: int) -> int:
    """N, the analyzers of the drills' shared pass: the scan-shareable
    analyzers of phase 3's checks and one frequency scan per dictionary
    column a grouping set or histogram reads (cat_small, cat_large)."""
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers

    analyzers = dict.fromkeys(collect_required_analyzers(
        [build_check(dq, rows)], [dq.CountDistinct("cat_large"),
                                  dq.ApproxQuantile("a", 0.5, KLL_RELATIVE_ERROR)]))
    return sum(isinstance(a, ScanShareableAnalyzer) for a in analyzers) + 2


def reliability_path(torch, dq, table: pa.Table, data, device: str = "cuda") -> None:
    """Phase 13: the reliability wrapper, the scan watchdog and the feed
    pipeline driven on the card through the port's own fault sites, on
    phase 3's table and checks (with an ApproxQuantile). (a)-(d) on the
    table's first ``DRILL_ROWS`` rows in batches of ``DRILL_BATCH_ROWS``,
    (e) on ``SERVICE_ROWS``-row micro-batches, (f) at phase 3's size.
    Every drill asserts the recoveries its fault explains and no other
    (:func:`drill`); the depth runs of (f) assert none."""
    import threading

    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.observability import trace
    from deequ_tpu_torch.observability.recorder import FLIGHT_DIR_ENV, recorder
    from deequ_tpu_torch.reliability import FaultSpec, classify_failure, inject
    from deequ_tpu_torch.reliability.watchdog import SCAN_DEADLINE_ENV, THREAD_PREFIX
    from deequ_tpu_torch.ingest.prefetch import FEED_STALL_ENV, PREFETCH_DEPTH_ENV

    on_card = device == "cuda"
    rows = DRILL_ROWS
    cut = dq.Dataset.from_arrow(table.slice(0, rows))
    n = _battery_size(dq, cut, rows)
    problems: list = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def faulted(label: str, spec, **kw) -> tuple:
        """One drill run under ``spec`` with the launch counts set to 0
        just before; prints its counters, launches and seconds."""
        monitor = dq.RunMonitor()
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        with inject(spec) as inj:
            result = _drill_run(dq, cut, rows, monitor, device, **kw)
        sync()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        print(f"[drill {label}] {seconds:.3f}s; fired={inj.fired}; placement={monitor.placement}"
              f"; passes={monitor.passes}; {_recoveries(monitor)}; launches={launches}",
              flush=True)
        if not inj.fired:
            problems.append(f"{label}: the injected fault did not fire")
        return metric_values(result), monitor, launches, seconds

    clean = metric_values(_drill_run(dq, cut, rows, dq.RunMonitor(), device))
    clean_host = metric_values(_drill_run(dq, cut, rows, dq.RunMonitor(), device,
                                          placement="host"))

    # (a) analyzer isolation: one analyzer's fault, matched to its tag
    with part_seconds("phase 13 (a)"), drill("phase 13 (a)"):
        target = dq.Mean("a")
        got, monitor, launches, _ = faulted(
            "(a) isolation", FaultSpec("analyzer", "analyzer", match=repr(target), count=None))
        key = metric_key(target)
        failed = [k for k, v in got.items() if isinstance(v, tuple) and v[0] == "failure"]
        if failed != [key] or "injected fault at site='analyzer'" not in got[key][1]:
            problems.append(f"(a): failures {failed}, expected {key} alone")
        problems += [f"(a) against the clean run: {p}" for p in compare_metrics(
            {k: v for k, v in got.items() if k != key},
            {k: v for k, v in clean.items() if k != key}, 1e-12)]
        bound = math.ceil(math.log2(n)) + 1
        if not 0 < monitor.isolation_reruns <= bound:
            problems.append(f"(a): {monitor.isolation_reruns} isolation re-runs, bound {bound}")
        problems += _expect("(a)", monitor, isolation_reruns=monitor.isolation_reruns,
                            degraded=[repr(target)])
        problems += [f"(a) launched no {k}" for k in VERIFICATION_KERNELS if k not in launches
                     and on_card]
        print(f"[drill (a) isolation] {n} analyzers; {monitor.isolation_reruns} re-runs "
              f"(bound {bound}); {repr(target)} alone failed", flush=True)

    # (b) tier failover: a device fault at batch 3, inside an open outer
    # span with the flight recorder's directory set
    with part_seconds("phase 13 (b)"), drill("phase 13 (b)"), \
            tempfile.TemporaryDirectory() as flight_dir, _env(FLIGHT_DIR_ENV, flight_dir):
        recorder().clear()
        with trace.span("phase 13 (b) outer", kind="drill"):
            got, monitor, launches, _ = faulted("(b) failover", FaultSpec(
                "device_update", "device", at=3))
            # the run's analysis_run has closed, the outer span has not
            dumps = [p for p in recorder().dump_paths
                     if p.startswith(flight_dir) and os.path.exists(p)]
            if not dumps:
                raise AssertionError(f"(b): no flight dump under {flight_dir} while the outer "
                                     f"span is open: {recorder().dump_paths}")
            with open(dumps[0]) as fh:
                header = json.loads(fh.readline())
            if [f["kind"] for f in header["failures"]] != ["DeviceFailureException"]:
                raise AssertionError(f"(b): the flight dump's failures {header['failures']}")
        _, passes, events = run_trace("(b)", outer="phase 13 (b) outer")
        if [(s.attrs["tier"], s.status) for s in passes] != [("device", "error"), ("host", "ok")]:
            raise AssertionError(f"(b): engine passes {[(s.attrs, s.status) for s in passes]}")
        failures = [ev["attrs"]["type"] for ev in events if ev["name"] == "failure"]
        if failures != ["DeviceFailureException"] or \
                not any(ev["name"] == "device_failover" for ev in events):
            raise AssertionError(f"(b): events {[ev['name'] for ev in events]}, failures "
                                 f"{failures}")
        print(f"[drill (b) trace] one trace: engine_pass device error, host ok; events "
              f"{sorted({ev['name'] for ev in events})}; flight dump {os.path.basename(dumps[0])} "
              f"({header['spans']} spans) on disk before the outer span closed", flush=True)
        problems += _expect("(b)", monitor, device_failovers=1,
                            degraded=["tier:device->device"])
        if monitor.placement != "host":
            problems.append(f"(b): completed on {monitor.placement}")
        problems += [f"(b) against the host tier: {p}"
                     for p in compare_metrics(got, clean_host, 0.0)]
        problems += [f"(b) launched no {k} after the failover"
                     for k in HOST_KERNELS if k not in launches and on_card]

    # (c) OOM: one injected OOM halves the batch; a persistent one falls
    # through to the host tier; a real allocator OOM reads "oom"
    with part_seconds("phase 13 (c)"), drill("phase 13 (c)"):
        half = metric_values(_drill_run(dq, cut, rows, dq.RunMonitor(), device,
                                        batch_size=DRILL_BATCH_ROWS // 2))
        got, monitor, _, _ = faulted("(c) oom", FaultSpec("device_update", "oom", at=1))
        problems += _expect("(c)", monitor, batch_bisections=1)
        problems += [f"(c) against the halved batch: {p}" for p in compare_metrics(got, half, 0.0)]
        got, monitor, launches, _ = faulted("(c) persistent oom",
                                            FaultSpec("device_update", "oom", count=None))
        problems += _expect("(c) persistent", monitor, batch_bisections=3, device_failovers=1,
                            degraded=["tier:device->oom"])
        host_eighth = metric_values(_drill_run(dq, cut, rows, dq.RunMonitor(), device,
                                               batch_size=DRILL_BATCH_ROWS // 8,
                                               placement="host"))
        problems += [f"(c) persistent against the host tier: {p}"
                     for p in compare_metrics(got, host_eighth, 0.0)]
        if on_card:
            try:
                torch.empty(OOM_BYTES, dtype=torch.uint8, device=device)
                problems.append("(c): an allocation of OOM_BYTES did not fail")
            except Exception as exc:  # noqa: BLE001 - classified below
                kind = classify_failure(exc)
                print(f"[drill (c) real oom] {type(exc).__name__}: {str(exc)[:120]!r} "
                      f"-> {kind!r}", flush=True)
                if kind != "oom":
                    problems.append(f"(c): a real allocator OOM classified {kind!r}")
            torch.cuda.empty_cache()

    # (d) the watchdog: a 6 s stall at batch 2 under a 2 s deadline
    with part_seconds("phase 13 (d)"), drill("phase 13 (d)"), \
            _env(SCAN_DEADLINE_ENV, str(DRILL_DEADLINE_S)):
        recorder().clear()
        started = time.perf_counter()
        got, monitor, launches, seconds = faulted(
            "(d) stall", FaultSpec("device_update", "stall", at=2, delay_s=DRILL_STALL_S))
        k1_after_run = launch_counts()["scan_reduce"]
        waited = [ev["attrs"]["waited_s"] for s in recorder().spans() for ev in s.events
                  if ev["name"] == "scan_stall"]
        problems += _expect("(d)", monitor, stalls=1, device_stalls=1, device_failovers=1,
                            degraded=["tier:device->device"])
        if len(waited) != 1 or waited[0] > 2 * DRILL_DEADLINE_S:
            problems.append(f"(d): the stall fired after {waited}s (deadline "
                            f"{DRILL_DEADLINE_S}s)")
        problems += [f"(d) against the host tier: {p}"
                     for p in compare_metrics(got, clean_host, 0.0)]
        # the stall ends DRILL_STALL_S after batch 2 began; DRILL_SETTLE_S
        # later no abandoned pass may be alive, nor have launched again
        time.sleep(max(0.0, started + DRILL_STALL_S + DRILL_SETTLE_S - time.perf_counter()))
        alive = [t.name for t in threading.enumerate() if t.name.startswith(THREAD_PREFIX)]
        if alive:
            problems.append(f"(d): {alive} alive {DRILL_SETTLE_S}s after the stall ended")
        if launch_counts()["scan_reduce"] != k1_after_run:
            problems.append(f"(d): K1 launched {launch_counts()['scan_reduce'] - k1_after_run} "
                            f"times after the pass was abandoned")
        _, passes, events = run_trace("(d)")
        failures = [ev["attrs"]["type"] for ev in events if ev["name"] == "failure"]
        stall_sites = [ev["attrs"]["site"] for ev in events if ev["name"] == "scan_stall"]
        if "ScanStallError" not in failures or stall_sites != ["device"] or \
                [s.attrs["tier"] for s in passes] != ["device", "host"]:
            raise AssertionError(f"(d): failures {failures}, scan_stall sites {stall_sites}, "
                                 f"passes {[s.attrs for s in passes]}")
        print(f"[drill (d) watchdog] ScanStallError after {waited}s (deadline "
              f"{DRILL_DEADLINE_S}s, stall {DRILL_STALL_S}s); run {seconds:.3f}s; K1 "
              f"{k1_after_run} launches before the stall, none after; watchdog threads alive "
              f"{DRILL_SETTLE_S}s after the stall: {alive}", flush=True)

    # (e) the service: a device fault puts the battery on probation
    with part_seconds("phase 13 (e)"), drill("phase 13 (e)"):
        service_probation(torch, dq, table, device, problems)

    # (f) the feed pipeline: phase 3 at depth 0 and 2, alternating
    with part_seconds("phase 13 (f)"):
        feed_depths(torch, dq, data, device, problems)
        with drill("phase 13 (f) feed stall"), _env(FEED_STALL_ENV, str(FEED_STALL_DEADLINE_S)), \
                _env(PREFETCH_DEPTH_ENV, "2"):
            before = recorder().dump_counts.get("FeedStallError", 0)
            got, monitor, launches, seconds = faulted(
                "(f) feed stall", FaultSpec("prefetch", "feed_stall", at=2,
                                            delay_s=FEED_STALL_S))
            stalls = recorder().dump_counts.get("FeedStallError", 0) - before
            problems += _expect("(f) feed stall", monitor, device_failovers=1,
                                degraded=["tier:device->device"])
            if stalls != 1:
                problems.append(f"(f): {stalls} FeedStallError recorded, expected 1")
            problems += [f"(f) feed stall against the host tier: {p}"
                         for p in compare_metrics(got, clean_host, 0.0)]
            print(f"[drill (f) feed stall] FeedStallError {stalls}; run {seconds:.3f}s "
                  f"(feed deadline {FEED_STALL_DEADLINE_S}s, stall {FEED_STALL_S}s)",
                  flush=True)
    if problems:
        raise AssertionError("phase 13 disagrees:\n" + "\n".join(problems[:40]))
    print("[reliability metrics] (a) one analyzer isolated, the rest equal the clean run; "
          "(b), (d) and the feed stall fail over to the host tier's metrics bit for bit; (c) "
          "the halved batch's metrics; (e) eight probation runs on the host tier; (f) depths "
          "0 and 2 bit for bit", flush=True)


def service_probation(torch, dq, table: pa.Table, device: str, problems: list) -> None:
    """Phase 13 (e): phase 3's checks over ``SERVICE_ROWS``-row micro-batches
    through ``VerificationService``: a device fault under the battery
    sends its next ``SUSPECT_PROBATION_RUNS`` jobs to the host tier
    (``deequ_service_suspect_host_routes_total``), and the one after them
    returns to the device tier."""
    from deequ_tpu_torch.reliability import FaultSpec, inject
    from deequ_tpu_torch.service import VerificationService

    micro = dq.Dataset.from_arrow(table.slice(0, SERVICE_ROWS))
    check = build_check(dq, SERVICE_ROWS)
    t0 = time.perf_counter()
    with VerificationService(workers=1, device=device, background_warm=False) as svc:
        counter = svc.metrics.counter_value
        svc.verify(micro, [check], timeout=TENANT_WAIT_S)  # warm (a host shelter if cold)
        svc.verify(micro, [check], timeout=TENANT_WAIT_S)
        hits = counter("deequ_service_placement_cache_hits_total")
        with inject(FaultSpec("device_update", "device", at=1)) as inj:
            faulted = svc.verify(micro, [check], timeout=TENANT_WAIT_S)
        if not inj.fired or hits < 1:
            problems.append(f"(e): the fault {inj.fired} did not meet a warm battery ({hits})")
        if faulted.status != faulted.status.SUCCESS and faulted.status.value == "Error":
            problems.append("(e): the faulted job failed")
        runs = svc.router.SUSPECT_PROBATION_RUNS
        statuses = [svc.verify(micro, [check], timeout=TENANT_WAIT_S).status.value
                    for _ in range(runs)]
        host_routes = counter("deequ_service_suspect_host_routes_total")
        hits_during = counter("deequ_service_placement_cache_hits_total")
        ninth = svc.verify(micro, [check], timeout=TENANT_WAIT_S)
        hits_after = counter("deequ_service_placement_cache_hits_total")
        failures = counter("deequ_service_device_failures_total")
    print(f"[drill (e) service] {SERVICE_ROWS}-row jobs: the fault {inj.fired}; "
          f"deequ_service_device_failures_total={failures}; the next {runs} jobs: "
          f"suspect host routes {host_routes}, cache hits {hits_during - hits - 1}; job "
          f"{runs + 1}: cache hits +{hits_after - hits_during} (device tier); statuses "
          f"{sorted(set(statuses + [ninth.status.value]))}; {time.perf_counter() - t0:.1f}s",
          flush=True)
    if host_routes != runs or failures != 1:
        problems.append(f"(e): {host_routes} probation routes, {failures} device failures")
    if hits_during != hits + 1 or hits_after != hits_during + 1:
        problems.append(f"(e): cache hits {hits} -> {hits_during} -> {hits_after}: the "
                        f"probation runs took the device tier or the job after them did not")


def feed_depths(torch, dq, data, device: str, problems: list) -> None:
    """Phase 13 (f): phase 3 at ``DEEQU_TPU_PREFETCH_DEPTH`` 0 and 2 in the
    order ``FEED_DEPTHS``; every run's states (through an in-memory state
    provider) equal the first's bit for bit, and no run recovered from
    anything. Prints each run's seconds and its ``feature_build``,
    ``host_to_device`` and ``kernels`` phases."""
    from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
    from deequ_tpu_torch.ingest.prefetch import PREFETCH_DEPTH_ENV

    check = build_check(dq, ROWS)
    first = None
    for depth in FEED_DEPTHS:
        states = InMemoryStateProvider()
        monitor = dq.RunMonitor()
        with _env(PREFETCH_DEPTH_ENV, str(depth)):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            (dq.VerificationSuite.on_data(data, device=device).add_check(check)
             .add_required_analyzer(dq.CountDistinct("cat_large"))
             .with_monitor(monitor).save_states_with(states).run())
            if device == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        ph = monitor.phase_seconds
        print(f"[feed depth {depth}] {ROWS} rows in {seconds:.3f}s; feature_build "
              f"{ph.get('feature_build', 0.0):.4f} host_to_device "
              f"{ph.get('host_to_device', 0.0):.4f} feed_wait "
              f"{ph.get('feed_wait', 0.0):.4f} kernels "
              f"{ph.get('kernels', 0.0):.4f} state_fetch {ph.get('state_fetch', 0.0):.4f} "
              f"metric_derivation {ph.get('metric_derivation', 0.0):.4f}", flush=True)
        problems += _expect(f"(f) depth {depth}", monitor)
        got = {repr(a): states.load(a) for a in states.analyzers()}
        if first is None:
            first = got
        elif set(got) != set(first) or not all(_same_persisted(got[k], first[k]) for k in first):
            problems.append(f"(f): depth {depth}'s states differ from depth "
                            f"{FEED_DEPTHS[0]}'s")


# ---------------------------------------------------------------------------
# phase 14: the self-tuning plane (calibration, profiles, the controller)
# ---------------------------------------------------------------------------

#: (d): micro-batches of one session folded while a shadow experiment on
#: ``fast_path_max_rows`` runs; at the default shadow fraction (0.05, a
#: period of 20) every 20th rides the candidate
TUNING_SHADOW_FOLDS = 200
#: (d), (e): rows of a micro-batch (the reference's drill: 8,192)
TUNING_FOLD_ROWS = 8192
#: (e): folds per burst and the samples an experiment arm needs
TUNING_BURST = 24
TUNING_MIN_SAMPLES = 8
#: the kernels calibration must launch: K1 (device probes), K6 (the
#: grouping-knee probe's device frequency table)
CALIBRATION_KERNELS = ("scan_reduce", "freq_keys")
TUNING_WAIT_S = 120


def tuning_check(dq):
    """The reference drill's battery (``tools/chaos_soak.py``,
    ``_tuning_drill``): fast-path capable."""
    return (dq.Check(dq.CheckLevel.ERROR, "tuning drill")
            .is_complete("x").has_mean("y", lambda m: 5.0 < m < 15.0))


def tuning_table(rows: int = TUNING_FOLD_ROWS) -> pa.Table:
    rng = np.random.default_rng(77)
    return pa.table({"x": rng.normal(size=rows), "y": rng.normal(10.0, 2.0, size=rows)})


def _record_spy(controller) -> dict:
    """Count the controller's ``record`` calls, and those after its last
    floor demotion (which restarts the live EWMA)."""
    seen = {"calls": 0, "since_reset": 0}
    record = controller.record

    def spied(rows, seconds, arm=None):
        before = len(controller.decisions)
        record(rows, seconds, arm=arm)
        seen["calls"] += 1
        seen["since_reset"] += 1
        if any(d["verdict"] == "floor_demotion" for d in controller.decisions[before:]):
            seen["since_reset"] = 0

    controller.record = spied
    return seen


def tuning_plane(torch, dq, table: pa.Table, data, gpu_metrics: dict,
                 device: str = "cuda") -> None:
    """Phase 14: the self-tuning plane on the card. (a) ``calibrate`` into
    a fresh profile directory, K1 and K6 launched; (b) the profile read
    back, a corrupted copy quarantined; (c) a ``VerificationService`` booted
    on that directory; (d) a shadow experiment's exact shadow count; (e)
    the reference's guardrail drill; (f) phase 3's verification under the
    profile and under static knobs. The script-wide profile directory (set
    in ``main``) stays empty, so no other phase boots with a profile."""
    import json as _json
    import shutil
    import tempfile

    from deequ_tpu_torch.exceptions import CorruptStateError
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.service import VerificationService
    from deequ_tpu_torch.tuning import knobs
    from deequ_tpu_torch.tuning.calibrate import calibrate
    from deequ_tpu_torch.tuning.profile import load_profile

    problems: list = []
    dev = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tuning_")
    profile_dir = os.path.join(workdir, "profiles")
    knobs.clear_tuned()
    try:
        # (a) calibration
        with part_seconds("phase 14 (a)"):
            reset_launch_counts()
            t0 = time.perf_counter()
            profile = calibrate(save=True, profile_dir=profile_dir, device=device)
            wall = time.perf_counter() - t0
            launches = launch_counts()
        for name, value in sorted(profile.probes.items()):
            print(f"[tuning probe] {name} = {value!r}", flush=True)
        for name, value in sorted(profile.knob_values.items()):
            k = knobs.REGISTRY[name]
            print(f"[tuning knob] {name} = {value!r} (static {k.static_default!r}, bounds "
                  f"[{k.lo}, {k.hi}])", flush=True)
            if not (k.lo <= value <= k.hi) or k.cast(value) != value:
                problems.append(f"(a): {name}={value!r} outside its bounds or cast")
        slope = profile.probes["device_stack_slope_s"]
        print(f"[tuning calibrate] {wall:.2f}s ({profile.calibration_wall_s:.2f}s inside); "
              f"launches {{{', '.join(f'{n}: {launches[n]}' for n in CALIBRATION_KERNELS)}}}; "
              f"device_stack_slope_s {slope!r}: coalesce_max_width "
              f"{'derived' if 'coalesce_max_width' in profile.knob_values else 'static (slope below 1e-7 s)'}; "
              f"every device probe pass on the device tier (calibrate raises otherwise)",
              flush=True)
        missing = [n for n in CALIBRATION_KERNELS if launches[n] == 0]
        if missing:
            problems.append(f"(a): calibration launched no {missing}")
        if knobs.any_tuned():
            problems.append("(a): calibrate installed tuned values")

        # (b) the profile on disk
        with part_seconds("phase 14 (b)"):
            loaded = load_profile(profile_dir, device=device)
            kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
            if loaded != profile or loaded.substrate["device_kind"] != kind:
                problems.append(f"(b): the saved profile read back as {loaded}")
            bad_dir = os.path.join(workdir, "corrupt")
            os.makedirs(bad_dir)
            name = f"profile-{profile.fingerprint}.json"
            shutil.copy(os.path.join(profile_dir, name), os.path.join(bad_dir, name))
            with open(os.path.join(bad_dir, name)) as fh:
                record = _json.load(fh)
            record["payload"]["probes"]["device_fixed_s"] = -1.0
            with open(os.path.join(bad_dir, name), "w") as fh:
                _json.dump(record, fh)
            try:
                load_profile(bad_dir, device=device)
                problems.append("(b): a corrupted profile loaded")
            except CorruptStateError as exc:
                print(f"[tuning profile] {profile.fingerprint} ({loaded.substrate}) read back; "
                      f"the corrupted copy: {type(exc).__name__}", flush=True)
            quarantined = os.listdir(os.path.join(bad_dir, ".quarantine"))
            if len(quarantined) != 1 or os.path.exists(os.path.join(bad_dir, name)):
                problems.append(f"(b): quarantine holds {quarantined}")
        # phase 17 (c): the tuning report on this profile
        with phase(17), part_seconds("phase 17 (c) report"):
            tuning_report_check(profile_dir, profile, device)

        # (c) boot on the profile, (d) a shadow experiment in it
        with _env("DEEQU_TPU_TUNING_PROFILE_DIR", profile_dir), \
                _env("DEEQU_TPU_PLACEMENT", "device"), part_seconds("phase 14 (c, d)"):
            with VerificationService(workers=1, device=device, background_warm=False) as svc:
                ctl = svc.tuning_controller
                tuned = {n: v["value"] for n, v in knobs.tuned_snapshot().items()}
                router = svc.coalescer.router
                seeds = {"router_host_rows_per_s": router._default_host_rate,
                         "router_device_fixed_s": router._device_fixed_s,
                         "router_device_rows_per_s": router._device_rows_per_s}
                status = svc.statusz.snapshot()["planes"]["tuning"]
                print(f"[tuning boot] controller {ctl is not None}; tuned {tuned}; router "
                      f"seeds {seeds}; /statusz tuning enabled {status.get('enabled')}",
                      flush=True)
                if ctl is None or ctl.profile != profile:
                    problems.append("(c): no controller, or not on the saved profile")
                if tuned != profile.knob_values:
                    problems.append(f"(c): tuned {tuned} != the profile's "
                                    f"{profile.knob_values}")
                if any(seeds[k] != profile.knob_values[k] for k in seeds):
                    problems.append(f"(c): router seeds {seeds} are not the profile's")
                if status.get("enabled") is not True:
                    problems.append(f"(c): /statusz tuning {status}")

                if ctl is not None:
                    seen = _record_spy(ctl)
                    session = svc.session("tuning", "shadow", [tuning_check(dq)])
                    micro = tuning_table()
                    session.ingest(micro, timeout=TUNING_WAIT_S)  # warm both routes' code
                    incumbent = knobs.value("fast_path_max_rows")
                    started = ctl.propose("fast_path_max_rows", 0, mode="shadow")
                    shadow0 = svc.metrics.counter_value(
                        "deequ_service_tuning_shadow_folds_total")
                    t0 = time.perf_counter()
                    for _ in range(TUNING_SHADOW_FOLDS):
                        session.ingest(micro, timeout=TUNING_WAIT_S)
                    seconds = time.perf_counter() - t0
                    shadow = svc.metrics.counter_value(
                        "deequ_service_tuning_shadow_folds_total") - shadow0
                    period = max(int(round(1.0 / knobs.shadow_fraction())), 2)
                    exp = ctl.snapshot()["experiments"].get("fast_path_max_rows", {})
                    print(f"[tuning shadow] {TUNING_SHADOW_FOLDS} folds of {TUNING_FOLD_ROWS} "
                          f"rows in {seconds:.3f}s; candidate fast_path_max_rows=0 against "
                          f"{incumbent}: {shadow:.0f} shadow folds (period {period}); "
                          f"incumbent {exp.get('incumbent_rate', 0.0):.0f} rows/s over "
                          f"{exp.get('incumbent_samples')} folds, candidate "
                          f"{exp.get('candidate_rate', 0.0):.0f} rows/s over "
                          f"{exp.get('candidate_samples')}", flush=True)
                    if not started or shadow != TUNING_SHADOW_FOLDS // period:
                        problems.append(f"(d): {shadow} shadow folds, expected "
                                        f"{TUNING_SHADOW_FOLDS // period}")
                    if seen["calls"] != TUNING_SHADOW_FOLDS + 1:
                        problems.append(f"(d): {seen['calls']} folds recorded of "
                                        f"{TUNING_SHADOW_FOLDS + 1}")
        knobs.clear_tuned()

        # (e) the guardrail drill, on a service with no profile
        with _env(knobs.TUNING_MIN_SAMPLES_ENV, str(TUNING_MIN_SAMPLES)), \
                _env("DEEQU_TPU_PLACEMENT", "device"), part_seconds("phase 14 (e)"):
            problems += guardrail_drill(dq, device)
        if knobs.any_tuned():
            problems.append(f"(e): knobs still tuned after the drill: {knobs.tuned_snapshot()}")

        # (f) phase 3's verification under the profile, then static
        with part_seconds("phase 14 (f)"):
            rows = table.num_rows
            runs = {}
            for label in ("profile", "static"):
                if label == "profile":
                    profile.apply(source="profile")
                depth = knobs.value("prefetch_depth")
                monitor = dq.RunMonitor()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = (dq.VerificationSuite.on_data(data, device=device)
                          .add_check(build_check(dq, rows))
                          .add_required_analyzer(dq.CountDistinct("cat_large"))
                          .with_monitor(monitor).run())
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                knobs.clear_tuned()
                ph = monitor.phase_seconds
                print(f"[tuning verification {label}] {rows} rows in {seconds:.3f}s at "
                      f"prefetch_depth {depth}; feature_build "
                      f"{ph.get('feature_build', 0.0):.4f} feed_wait "
                      f"{ph.get('feed_wait', 0.0):.4f} host_to_device "
                      f"{ph.get('host_to_device', 0.0):.4f} kernels "
                      f"{ph.get('kernels', 0.0):.4f}", flush=True)
                runs[label] = metric_values(result)
                problems += [f"(f) {label}: {p}"
                             for p in compare_metrics(runs[label], gpu_metrics)]
    finally:
        knobs.clear_tuned()
        shutil.rmtree(workdir, ignore_errors=True)
    if problems:
        raise AssertionError("phase 14:\n" + "\n".join(problems))


def guardrail_drill(dq, device: str) -> list:
    """Phase 14 (e): the reference's chaos-soak tuning drill
    (``tools/chaos_soak.py``, ``_tuning_drill``) on the card: a static
    burst, ``fast_path_max_rows=0`` planted (every fold on the device),
    then a recovered burst, through one session. Whether the floor fires
    is printed, not gated (on the card a device fold may cost no more than
    the fast path); the gates are the controller's bookkeeping."""
    from deequ_tpu_torch.service import VerificationService
    from deequ_tpu_torch.tuning import knobs

    problems = []
    micro = tuning_table()
    with VerificationService(workers=1, device=device, background_warm=False) as svc:
        ctl = svc.tuning_controller
        if ctl is None or ctl.profile is not None:
            return [f"(e): expected a controller without a profile, got {ctl}"]
        seen = _record_spy(ctl)
        session = svc.session("tuning-drill", "stream", [tuning_check(dq)])

        def burst(n: int) -> float:
            t0 = time.perf_counter()
            for _ in range(n):
                session.ingest(micro, timeout=TUNING_WAIT_S)
            return n / (time.perf_counter() - t0)

        rates = {}
        try:
            knobs.clear_tuned()  # the floor is measured at true static
            session.ingest(micro, timeout=TUNING_WAIT_S)  # warm the static route
            rates["static"] = burst(TUNING_BURST)
            before = svc.metrics.counter_value("deequ_service_tuning_demotions_total")
            knobs.set_tuned("fast_path_max_rows", 0, source="drill")
            rates["poisoned"] = burst(TUNING_BURST)
            rates["recovered"] = burst(TUNING_BURST)
            demoted = not knobs.tuned_snapshot()
        finally:
            knobs.clear_tuned()
        snap = ctl.snapshot()
        decisions = snap["decisions"]
        floor = [d for d in decisions if d["verdict"] == "floor_demotion"]
        demotions = svc.metrics.counter_value("deequ_service_tuning_demotions_total") - before
        routes = {r: svc.metrics.counter_value("deequ_service_fold_route_total", route=r)
                  for r in ("fast", "device")}
    folds = 1 + 3 * TUNING_BURST
    print(f"[tuning drill] {TUNING_FOLD_ROWS}-row folds, sessions/s static "
          f"{rates['static']:.1f}, poisoned {rates['poisoned']:.1f}, recovered "
          f"{rates['recovered']:.1f}; decisions {[d['verdict'] for d in decisions]}; floor "
          f"fired {bool(floor)} (demoted {demoted}); routes {routes}; static floor "
          f"{snap['static_rate_ewma']:.0f} rows/s over {snap['static_samples']} folds, live "
          f"{snap['live_rate_ewma']:.0f} rows/s over {snap['live_samples']}", flush=True)
    if seen["calls"] != folds or snap["live_samples"] != seen["since_reset"]:
        problems.append(f"(e): {seen['calls']} folds recorded of {folds}, live samples "
                        f"{snap['live_samples']} against {seen['since_reset']} since the "
                        f"last floor demotion")
    knobs_demoted = sum(len(d["knob"].split(",")) for d in floor)
    if demotions != knobs_demoted:
        problems.append(f"(e): the demotion counter moved {demotions}, the floor demoted "
                        f"{knobs_demoted} knob(s)")
    return problems


def _same_persisted(got, want) -> bool:
    """Two persisted states equal bit for bit: tensor states leaf by leaf,
    a grouping set's frequencies by their rows and counts."""
    from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows

    if isinstance(want, FrequenciesAndNumRows):
        return (isinstance(got, FrequenciesAndNumRows) and got.num_rows == want.num_rows
                and got.frequencies.sort_index().equals(want.frequencies.sort_index()))
    return same_state_bits(got, want)


# ---------------------------------------------------------------------------
# phase 15: the cluster plane
# ---------------------------------------------------------------------------

#: (a): the in-process front tier's sessions, micro-batches and rows (the
#: reference's migration cases at a real cluster's load)
CLUSTER_SESSIONS = 16
CLUSTER_BATCHES = 8
CLUSTER_ROWS = 65_536
CLUSTER_WORKERS = 4
#: (b) and (c): tools/torch_cluster_soak.py's worker processes, sessions,
#: micro-batches and rows. 2^18-row folds lie above the coalescer's
#: crossover for the soak battery (about 143,000 rows at its static seeds),
#: so they reach the device; 65,536-row folds take the host fast path.
#: 48 x 2 x 2^18 = 25.2M rows (201 MB of float64 over HTTP); 16 x 2 x 2^18
#: = 8.4M rows in the drill
SOAK_PROCS = 3
SOAK_SESSIONS = 48
SOAK_BATCHES = 2
SOAK_ROWS = 1 << 18
DRILL_SESSIONS = 16
DRILL_BATCHES = 2
SOAK_TIMEOUT_S = 300
#: the kernels of the cluster's folds, by the kernel they enter
CLUSTER_KERNELS = {
    "K1": ("scan_reduce", "scan_reduce_stacked"),
    "K2": ("hll_registers", "hll_registers_stacked", "hll_registers_columns"),
    "K8": ("state_fold",),
}
#: the planes a worker's /statusz must carry (the reference's six)
STATUSZ_PLANES = ("scheduler", "tuning", "cluster", "catalog", "fleetwatch", "partition_store")
CLUSTER_COUNTERS = ("routes", "migrations", "host_losses", "ring_moves", "sessions_recovered",
                    "replayed_folds", "journal_flushes")


def cluster_batch(i: int, b: int, rows: int = None) -> dict:
    """Session ``i``'s micro-batch ``b``: integer-valued float64s, unique
    per (session, batch) and below 2^53 in every partial sum
    (tools/cluster_soak.py's data)."""
    rows = CLUSTER_ROWS if rows is None else rows
    base = i * 100_000_000 + b * rows
    return {"v": np.arange(base, base + rows, dtype=np.float64)}


def cluster_key(i: int) -> tuple:
    return (f"tenant-{i % 4}", f"stream-{i}")


def cluster_check(dq):
    """The soak's battery (``is_complete``, ``has_size``, a Sum) with the
    moments and an ApproxCountDistinct, whose HLL puts every fold on the
    coalescer's device route."""
    def yes(_):
        return True

    return (dq.Check(dq.CheckLevel.ERROR, "cluster battery")
            .is_complete("v").has_size(lambda n: n > 0)
            .has_mean("v", yes).has_standard_deviation("v", yes)
            .has_approx_count_distinct("v", yes))


def _blake2b64(key: str) -> int:
    import hashlib

    return int.from_bytes(hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


def plain_route(hosts, key: str, vnodes: int = 64) -> str:
    """A plain consistent-hash ring (independent of the package): the
    first of the hosts' ``vnodes`` points clockwise of the key's hash."""
    import bisect

    points = sorted((_blake2b64(f"{h}#{v}"), h) for h in hosts for v in range(vnodes))
    i = bisect.bisect_right([p for p, _ in points], _blake2b64(key)) % len(points)
    return points[i][1]


def expected_cluster_counters(script: list, sessions: int) -> dict:
    """The ``deequ_service_cluster_*`` counters a front tier must show for
    ``script`` (``("join", host)``, ``("open",)``, ``("ingest", b0, b1)``,
    ``("flush",)``, ``("remove", host)``, ``("lose", host)``), from the
    plain ring: every open and ingest routes once; a ring change counts
    the placed keys it re-homes and migrates them (a graceful move clears
    the key's journal); a loss recovers the lost host's keys and replays
    their journals."""
    counts = dict.fromkeys(CLUSTER_COUNTERS, 0)
    hosts, placed, journal = [], {}, {}
    keys = ["/".join(cluster_key(i)) for i in range(sessions)]
    for step in script:
        kind = step[0]
        if kind == "open":
            for k in keys:
                placed[k], journal[k] = plain_route(hosts, k), 0
            counts["routes"] += len(keys)
        elif kind == "ingest":
            for k in keys:
                journal[k] += step[2] - step[1]
            counts["routes"] += len(keys) * (step[2] - step[1])
        elif kind == "flush":
            journal = dict.fromkeys(journal, 0)
        elif kind in ("join", "remove", "lose"):
            host = step[1]
            before = {k: plain_route(hosts, k) for k in placed}
            hosts = hosts + [host] if kind == "join" else [h for h in hosts if h != host]
            after = {k: plain_route(hosts, k) for k in placed}
            counts["ring_moves"] += sum(before[k] != after[k] for k in placed)
            for k in placed:
                if kind == "join" and before[k] != after[k] or (
                        kind == "remove" and placed[k] == host):
                    counts["migrations"] += 1
                    journal[k] = 0
                elif kind == "lose" and placed[k] == host:
                    counts["sessions_recovered"] += 1
                    counts["replayed_folds"] += journal[k]
                else:
                    continue
                placed[k] = after[k]
            counts["host_losses"] += kind == "lose"
    return counts


def _front_counters(front) -> dict:
    return {name: int(front.metrics.counter_value(f"deequ_service_cluster_{name}_total"))
            for name in CLUSTER_COUNTERS}


def _kernel_launches(launches: dict) -> dict:
    return {k: sum(launches.get(n, 0) for n in names) for k, names in CLUSTER_KERNELS.items()}


def cluster_in_process(torch, dq, device: str = "cuda") -> None:
    """Phase 15 (a): a ``FrontTier`` over ``LocalWorker``s whose services
    run on ``device``, each heartbeating one membership directory; 16
    sessions x 8 micro-batches x 65,536 rows streamed concurrently; a third
    worker joins after batch 4 (graceful migrations), w0 leaves after
    batch 6 (a drain) and an injected ``host_loss`` at ``host_heartbeat``
    declares the host of session 0 lost after batch 7 (adoption from the
    store and journal replay). Every session's metrics equal one unmoved
    session's on a single service (bit for bit, the moments within 1e-12)
    and the closed form of Sum and Size; the cluster counters equal the
    plain ring's for the same script; K1, K2 and K8 launched."""
    from concurrent.futures import ThreadPoolExecutor

    from deequ_tpu_torch import kernels
    from deequ_tpu_torch.analyzers import Sum
    from deequ_tpu_torch.cluster import FrontTier, HeartbeatMembership, LocalWorker
    from deequ_tpu_torch.reliability.faults import FaultSpec, inject
    from deequ_tpu_torch.service import VerificationService

    root = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    store, beats = os.path.join(root, "store"), os.path.join(root, "hb")
    required = [Sum("v")]

    def worker(host: str):
        service = VerificationService(workers=CLUSTER_WORKERS, background_warm=False,
                                      partition_store=store, device=device)
        membership = HeartbeatMembership(beats, host_id=host, heartbeat_period_s=0.1,
                                         ttl_s=3600)
        return LocalWorker(host, service, membership=membership)

    hosts = {h: worker(h) for h in ("w0", "w1", "w2")}
    front = FrontTier(membership=HeartbeatMembership(beats, ttl_s=3600))
    sessions = range(CLUSTER_SESSIONS)
    script = []

    def stage(b0: int, b1: int) -> None:
        def drive(i):
            for b in range(b0, b1):
                front.ingest(*cluster_key(i), cluster_batch(i, b))

        with ThreadPoolExecutor(max_workers=CLUSTER_SESSIONS) as pool:
            for future in [pool.submit(drive, i) for i in sessions]:
                future.result()
        script.append(("ingest", b0, b1))

    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for h in ("w0", "w1"):
            front.add_worker(hosts[h])
            script.append(("join", h))
        for i in sessions:
            front.open_session(*cluster_key(i), [cluster_check(dq)], required_analyzers=required)
        script.append(("open",))
        stage(0, 2)
        front.flush_all()
        script.append(("flush",))
        stage(2, 4)
        front.add_worker(hosts["w2"])
        script.append(("join", "w2"))
        stage(4, 6)
        front.remove_worker("w0")
        script.append(("remove", "w0"))
        stage(6, 7)
        lost = front.placement(*cluster_key(0))
        with inject(FaultSpec("host_heartbeat", "host_loss", match=lost)):
            recovered = front.check_membership()
        script.append(("lose", lost))
        stage(7, 8)
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        got = []
        for i in sessions:
            placed = front.placement(*cluster_key(i))
            got.append(metric_values(front.workers[placed].service
                                     .get_session(*cluster_key(i)).current()))
        counters = _front_counters(front)
        members = front.workers[front.placement(*cluster_key(0))].service.statusz.snapshot()
    finally:
        front.close()
        for w in hosts.values():  # the drained and the lost hosts
            w.close()
        shutil.rmtree(root, ignore_errors=True)
    rows = CLUSTER_SESSIONS * CLUSTER_BATCHES * CLUSTER_ROWS
    print(f"[cluster (a)] {CLUSTER_SESSIONS} sessions x {CLUSTER_BATCHES} x {CLUSTER_ROWS} rows "
          f"over w0, w1 (+w2, -w0, lost {lost}) in {seconds:.3f}s ({rows / seconds:.0f} rows/s); "
          f"counters {counters}; launches {_kernel_launches(launches)}", flush=True)

    problems = []
    if recovered != [lost]:
        problems.append(f"the sweep recovered {recovered}, not [{lost}]")
    want_counters = expected_cluster_counters(script, CLUSTER_SESSIONS)
    if counters != want_counters:
        problems.append(f"counters {counters}, the plain ring's {want_counters}")
    section = members["planes"]["cluster"]
    if not section.get("attached") or len(section.get("sessions", [])) == 0:
        problems.append(f"the adopting worker's /statusz cluster section: {section}")
    # one unmoved session per key on a single service
    with VerificationService(workers=CLUSTER_WORKERS, background_warm=False,
                             device=device) as single:
        for i in sessions:
            single.session(*cluster_key(i), [cluster_check(dq)], required_analyzers=required)

        def drive_single(i):
            for b in range(CLUSTER_BATCHES):
                single.get_session(*cluster_key(i)).ingest(cluster_batch(i, b))

        with ThreadPoolExecutor(max_workers=CLUSTER_SESSIONS) as pool:
            for future in [pool.submit(drive_single, i) for i in sessions]:
                future.result()
        want = [metric_values(single.get_session(*cluster_key(i)).current()) for i in sessions]
    for i in sessions:
        problems += [f"session {i}: {p}" for p in compare_metrics(got[i], want[i])]
        total = sum((2 * (i * 100_000_000 + b * CLUSTER_ROWS) + CLUSTER_ROWS - 1)
                    * CLUSTER_ROWS // 2 for b in range(CLUSTER_BATCHES))
        closed = {("Sum", "v", None): float(total),
                  ("Size", "*", None): float(CLUSTER_BATCHES * CLUSTER_ROWS)}
        problems += [f"session {i} closed form: {key} {got[i].get(key)!r} != {value!r}"
                     for key, value in closed.items() if got[i].get(key) != value]
    missing = [k for k, n in _kernel_launches(launches).items() if n == 0]
    if missing:
        problems.append(f"no launch of {missing}: {launches}")
    if problems:
        raise AssertionError("phase 15 (a) disagrees:\n" + "\n".join(problems[:40]))


def run_cluster_soak(args: list, device: str) -> dict:
    """``tools/torch_cluster_soak.py`` with ``args`` on ``device``, from this
    checkout's root; its JSON line. A skipped soak (exit code 2) fails."""
    out = subprocess.run(
        [sys.executable, "-m", "tools.torch_cluster_soak", *args, "--device", device],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=SOAK_TIMEOUT_S,
    )
    lines = [line for line in out.stdout.splitlines() if line.strip()]
    if out.returncode != 0 or not lines:
        raise AssertionError(f"torch_cluster_soak {args} exited {out.returncode}: "
                             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return json.loads(lines[-1])


def _soak_problems(report: dict) -> list:
    """The reference's soak gates (tests/test_cluster_soak.py)."""
    problems = []
    if not report.get("ok"):
        problems.append("the verdict is not ok")
    if report.get("parity_failures"):
        problems.append(f"parity: {report['parity_failures'][:4]}")
    obs = report.get("observability", {})
    if not obs.get("ok") or obs.get("statusz_problems"):
        problems.append(f"observability: {obs}")
    if obs.get("cross_process_ingest_traces", 0) < 1:
        problems.append("no cross-process ingest trace")
    missing = [p for p in STATUSZ_PLANES if p not in obs.get("statusz_planes", [])]
    if missing:
        problems.append(f"/statusz lacks {missing}")
    return problems


def cluster_soak(torch, device: str = "cuda") -> None:
    """Phase 15 (b): the throughput soak (3 worker processes, 48 sessions x
    2 x 2^18 rows over HTTP): the reference's gates, and every worker that
    held a session launched K1 and ran device-tier folds."""
    report = run_cluster_soak(["--procs", str(SOAK_PROCS), "--sessions", str(SOAK_SESSIONS),
                               "--batches", str(SOAK_BATCHES), "--rows", str(SOAK_ROWS)],
                              device)
    workers = report.get("workers", {})
    print(f"[cluster (b)] {SOAK_PROCS} processes, {SOAK_SESSIONS} sessions x {SOAK_BATCHES} x "
          f"{SOAK_ROWS} rows in {report.get('elapsed_s')}s: {report.get('sessions_per_s')} "
          f"sessions/s, {report.get('rows_per_s')} rows/s; " + "; ".join(
              f"{h}: {w['sessions']} sessions, folds device {w['device_folds']} / host "
              f"{w['host_folds']} / fast {w['fast_folds']}, launches "
              f"{_kernel_launches(w['launches'])}" for h, w in sorted(workers.items())),
          flush=True)
    problems = _soak_problems(report)
    if report.get("sessions_per_s", 0) <= 0:
        problems.append("no sessions/s")
    if report.get("counters", {}).get("deequ_service_cluster_routes_total", 0) <= 0:
        problems.append("no route counted")
    if report.get("observability", {}).get("journals", 0) < 2:
        problems.append("fewer than two span journals")
    if len(workers) != SOAK_PROCS:
        problems.append(f"{len(workers)} workers reported")
    for host, w in sorted(workers.items()):
        if w["sessions"] and (_kernel_launches(w["launches"])["K1"] == 0 or not w["device_folds"]):
            problems.append(f"{host} held {w['sessions']} sessions and ran "
                            f"{w['device_folds']} device-tier folds, launches {w['launches']}")
    if problems:
        raise AssertionError("phase 15 (b) disagrees:\n" + "\n".join(problems))


def cluster_drill(torch, device: str = "cuda") -> None:
    """Phase 15 (c): the kill-one drill (16 sessions x 2 x 2^18 rows over
    two worker processes, one SIGKILLed after the flush): the reference's
    gates, and the survivor launched kernels after the recovery.

    The workers run with ``DEEQU_TPU_FAST_PATH_MAX_ROWS=0``: the crossover
    router learns the device's cost per fold from the first coalesced
    launches, and on a loaded host that cost can send every later fold of
    2^18 rows, the replay included, to the host fast path, which launches
    no kernel. The gate holds the replay on the card, so the route is
    fixed; phase 15 (b) keeps the measured route."""
    with _env("DEEQU_TPU_FAST_PATH_MAX_ROWS", "0"):
        report = run_cluster_soak(["--drill", "kill-one", "--sessions", str(DRILL_SESSIONS),
                                   "--batches", str(DRILL_BATCHES), "--rows", str(SOAK_ROWS)],
                                  device)
    after = _kernel_launches(report.get("survivor_launches_after_recovery", {}))
    survivor = report.get("survivor_after_recovery", {})
    print(f"[cluster (c)] victim {report.get('victim')} ({report.get('victim_sessions')} sessions, "
          f"{report.get('victim_journal_spans')} spans in its journal); SIGKILL to the last "
          f"replayed fold {report.get('recovery_s')}s; counters {report.get('counters')}; the "
          f"survivor's folds device {survivor.get('device_folds')} / host "
          f"{survivor.get('host_folds')} / fast {survivor.get('fast_folds')}, its launches "
          f"after the recovery {after}", flush=True)
    problems = _soak_problems(report)
    victim = report.get("victim")
    if report.get("recovered_hosts") != [victim]:
        problems.append(f"recovered {report.get('recovered_hosts')}, victim {victim}")
    for key, (src, dst) in report.get("rehomed", {}).items():
        if src != victim or dst == src:
            problems.append(f"{key} moved {src} -> {dst}")
    counters = report.get("counters", {})
    for name in ("host_losses", "sessions_recovered", "replayed_folds"):
        if counters.get(f"deequ_service_cluster_{name}_total", 0) < 1:
            problems.append(f"no {name}")
    if report.get("victim_journal_spans", 0) < 1:
        problems.append("the victim's span journal is empty")
    if not sum(after.values()):
        problems.append(f"the survivor launched nothing after the recovery: {survivor}")
    if problems:
        raise AssertionError("phase 15 (c) disagrees:\n" + "\n".join(problems))


def cluster_plane(torch, dq, device: str = "cuda") -> None:
    """Phase 15: the cluster plane, (a) in-process, (b) and (c) across
    worker processes (``tools/torch_cluster_soak.py``)."""
    with part_seconds("phase 15 (a)"):
        cluster_in_process(torch, dq, device)
    with part_seconds("phase 15 (b)"):
        cluster_soak(torch, device)
    with part_seconds("phase 15 (c)"):
        cluster_drill(torch, device)


# ---------------------------------------------------------------------------
# phase 16: the fleet scheduler and the service's mesh route (ROADMAP A5b)
# ---------------------------------------------------------------------------

#: shards of the card in the fleet's device table (``fleet_devices=``)
FLEET_SHARDS = 8
#: (b): tenants x sessions x micro-batches x rows
FLEET_TENANTS = 2
FLEET_SESSIONS = 4
FLEET_BATCHES = 4
FLEET_ROWS = 1 << 18
FLEET_SEED = 29
#: (a): the partitions of the fleet's ``verify_partitioned``
FLEET_PARTITION_ROWS = 1_000_000
FLEET_WAIT_S = 300
#: launches each part must show
FLEET_DEVICE_KERNELS = ("scan_reduce_stacked", "hll_registers_stacked", "dict_code_counts",
                        "state_fold")
FLEET_HOST_KERNELS = ("state_fold_carry_stacked", "state_fold_butterfly")
FLEET_STREAM_KERNELS = ("state_fold_carry_stacked", "state_fold_butterfly", "state_fold")


def fleet_stream_check(dq):
    """The reference's exact fleet battery (Size, Completeness, Minimum,
    Maximum, Sum: ``tests/test_fleet.py``) with Mean, StandardDeviation
    and ApproxCountDistinct."""
    def yes(_):
        return True

    return (dq.Check(dq.CheckLevel.ERROR, "fleet stream")
            .has_size(lambda n: n > 0).is_complete("x")
            .has_min("x", yes).has_max("x", yes).has_sum("x", yes)
            .has_mean("x", yes).has_standard_deviation("x", yes)
            .has_approx_count_distinct("x", yes))


def fleet_batch(tenant: int, session: int, batch: int, rows: int = FLEET_ROWS) -> pa.Table:
    """One micro-batch of integer-valued float64 (sums stay exact: below
    2^53 at every fold boundary)."""
    rng = np.random.default_rng([FLEET_SEED, tenant, session, batch])
    return pa.table({"x": rng.integers(0, 1_000_000, rows).astype(np.float64)})


def _job_tier(handle) -> str:
    """The tier a job's pass ran on, from its monitor's phases."""
    phases = handle.phase_seconds
    if "ingest_fold" in phases:
        return "host"
    return "device" if "kernels" in phases else "none"


def _fleet_streams(torch, dq, svc, sessions: list, batches: int = FLEET_BATCHES) -> tuple:
    """Ingest ``batches`` micro-batches into each ``(tenant index, session
    index)`` of ``sessions`` on ``svc``, the sessions concurrently and each
    one's folds in order (each waited for). Returns the sessions' metrics
    and the seconds."""
    from concurrent.futures import ThreadPoolExecutor

    handles = {key: svc.session(f"t{key[0]}", f"s{key[1]}", [fleet_stream_check(dq)])
               for key in sessions}

    def drive(key):
        for b in range(batches):
            handles[key].ingest(fleet_batch(key[0], key[1], b), timeout=FLEET_WAIT_S)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sessions)) as pool:
        for f in [pool.submit(drive, k) for k in sessions]:
            f.result()
    seconds = time.perf_counter() - t0
    return {key: metric_values(h.current()) for key, h in handles.items()}, seconds


def _fleet_verify(torch, svc, data, check, required, tenant: str, label: str, rows: int,
                  kernels=()) -> tuple:
    """One verification job of ``tenant`` on ``svc``, launch counts set to
    0 just before; returns its metrics, its tier and its launches."""
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    handle = svc.submit_verification(data, [check], required_analyzers=required, tenant=tenant)
    result = handle.result(FLEET_WAIT_S)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    tier = _job_tier(handle)
    print(f"[fleet {label}] {rows} rows in {seconds:.3f}s = {rows / seconds:.0f} rows/s; tier "
          f"{tier}; positions {svc.fleet.devices_of(tenant) if svc.fleet else None}; "
          f"launches={launches}", flush=True)
    _launched(f"fleet {label}", launches, kernels)
    return metric_values(result), tier, launches


def fleet_batch_jobs(torch, dq, table: pa.Table, data, check, phase3: dict,
                     device: str = "cuda") -> None:
    """Phase 16 (a): batch jobs on disjoint sub-meshes, the cold job on the
    host tier, ``verify_partitioned`` under the fleet."""
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.parallel import make_mesh
    from deequ_tpu_torch.repository import PartitionStateStore
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers
    from deequ_tpu_torch.runners.engine import warm_fused_program
    from deequ_tpu_torch.service import VerificationService

    rows = table.num_rows
    required = [dq.CountDistinct("cat_large")]
    problems = []
    t0 = time.perf_counter()
    table_b = build_table(rows, FLEET_SEED + 1)
    data_b = dq.Dataset.from_arrow(table_b)
    print(f"[fleet (a) data] the second table, {rows} rows, in {time.perf_counter() - t0:.1f}s",
          flush=True)
    # the battery warm at both widths the packing hands out here, so every
    # job below but the cold one runs on the device tier
    analyzers = collect_required_analyzers([check], required)
    for width in (FLEET_SHARDS, FLEET_SHARDS // 2):
        warm_fused_program(analyzers, data, batch_size=BATCH_ROWS, device=device,
                           mesh=make_mesh(width, device=device))
    with VerificationService(workers=4, background_warm=False, device=device, fleet=True,
                             fleet_devices=FLEET_SHARDS) as svc:
        fleet = svc.fleet
        a8, tier, launches = _fleet_verify(torch, svc, data, check, required, "a",
                                           "(a) tenant a alone", rows, FLEET_DEVICE_KERNELS)
        if fleet.devices_of("a") != tuple(range(FLEET_SHARDS)) or tier != "device":
            problems.append(f"a alone: positions {fleet.devices_of('a')}, tier {tier}")
        fleet.evict_idle()
        b8, tier, _ = _fleet_verify(torch, svc, data_b, check, required, "b",
                                    "(a) tenant b alone", rows, FLEET_DEVICE_KERNELS)
        if fleet.devices_of("b") != tuple(range(FLEET_SHARDS)) or tier != "device":
            problems.append(f"b alone: positions {fleet.devices_of('b')}, tier {tier}")
        fleet.evict_idle()
        # both tenants join the packing before their jobs run, so neither
        # job runs on a lease cut before the other arrived
        for tenant in ("a", "b"):
            fleet.acquire(tenant)
            fleet.release(tenant)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        handles = [svc.submit_verification(d, [check], required_analyzers=required, tenant=t)
                   for t, d in (("a", data), ("b", data_b))]
        results = [h.result(FLEET_WAIT_S) for h in handles]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        packed = {k: v for k, v in launch_counts().items() if v}
        pos_a, pos_b = fleet.devices_of("a"), fleet.devices_of("b")
        tiers = [_job_tier(h) for h in handles]
        print(f"[fleet (a) packed] a and b at once, {2 * rows} rows in {seconds:.3f}s = "
              f"{2 * rows / seconds:.0f} rows/s; a on positions {pos_a}, b on {pos_b}; tiers "
              f"{tiers}; launches={packed}", flush=True)
        print(f"[fleet lease table] {fleet.snapshot()}", flush=True)
        _launched("fleet (a) packed", packed, FLEET_DEVICE_KERNELS)
        if len(pos_a) != 4 or len(pos_b) != 4 or set(pos_a) & set(pos_b):
            problems.append(f"packed positions a {pos_a}, b {pos_b}")
        if tiers != ["device", "device"]:
            problems.append(f"packed tiers {tiers}")
        a4, b4 = metric_values(results[0]), metric_values(results[1])
        for label, got, want in (("a alone", a8, phase3), ("a packed", a4, phase3),
                                 ("b packed", b4, b8)):
            problems += [f"{label}: {p}" for p in compare_metrics(got, want)]
        problems += [f"a oracle: {p}" for p in compare_oracle(a4, oracle(table))]
        problems += [f"b oracle: {p}" for p in compare_oracle(b4, oracle(table_b))]
        # a third tenant re-packs the table into 2-shard slices: its width
        # is cold, so its job runs on the host tier over its slice
        c2, tier, _ = _fleet_verify(torch, svc, data, check, required, "c",
                                    "(a) cold tenant c", rows, FLEET_HOST_KERNELS)
        if tier != "host" or len(fleet.devices_of("c")) != 2:
            problems.append(f"cold c: tier {tier}, positions {fleet.devices_of('c')}")
        problems += [f"cold c: {p}" for p in compare_metrics(c2, phase3)]
        # incremental verification under the fleet
        root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
        try:
            parts = {f"p{i}": build_scan_data(FLEET_PARTITION_ROWS, INCREMENTAL_SEED + 10 + i)
                     for i in range(2)}
            battery = [dq.Size(), dq.Completeness("x0"), dq.Mean("x0"), dq.Mean("x1"),
                       dq.ApproxCountDistinct("cat")]
            leases = svc.metrics.counter_value("deequ_service_fleet_leases_total")
            t0 = time.perf_counter()
            got = svc.verify_partitioned(
                "fleet-parts", {n: dq.Dataset.from_arrow(t) for n, t in parts.items()},
                [partitioned_check(dq)], required_analyzers=battery, tenant="a",
                store=PartitionStateStore(os.path.join(root, "fleet")), timeout=FLEET_WAIT_S)
            seconds = time.perf_counter() - t0
            leases = svc.metrics.counter_value("deequ_service_fleet_leases_total") - leases
            want = dq.VerificationSuite.verify_partitioned(
                PartitionStateStore(os.path.join(root, "card")), "fleet-parts",
                {n: dq.Dataset.from_arrow(t) for n, t in parts.items()},
                [partitioned_check(dq)], battery, device=device)
            print(f"[fleet (a) partitions] 2 x {FLEET_PARTITION_ROWS} rows in {seconds:.3f}s "
                  f"under the fleet ({leases:.0f} leases), status {got.status.value}", flush=True)
            if leases < 1:
                problems.append("verify_partitioned took no fleet lease")
            problems += [f"partitions: {p}" for p in compare_metrics(
                metric_values(got), metric_values(want))]
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if problems:
        raise AssertionError("phase 16 (a) disagrees:\n" + "\n".join(problems[:40]))


def fleet_stream_folds(torch, dq, device: str = "cuda") -> dict:
    """Phase 16 (b): fleet stream folds against the same sessions on a
    ``fleet=False`` service. Returns the one-card sessions' metrics."""
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.service import VerificationService

    sessions = [(t, s) for t in range(FLEET_TENANTS) for s in range(FLEET_SESSIONS)]
    n_rows = len(sessions) * FLEET_BATCHES * FLEET_ROWS
    with VerificationService(workers=8, background_warm=False, device=device,
                             fleet=False) as svc:
        single, seconds = _fleet_streams(torch, dq, svc, sessions)
    print(f"[fleet (b) one card] {len(sessions)} sessions x {FLEET_BATCHES} x {FLEET_ROWS} rows "
          f"in {seconds:.3f}s = {len(sessions) / seconds:.2f} sessions/s, "
          f"{n_rows / seconds:.0f} rows/s", flush=True)
    with VerificationService(workers=8, background_warm=False, device=device, fleet=True,
                             fleet_devices=FLEET_SHARDS) as svc:
        torch.cuda.synchronize()
        reset_launch_counts()
        got, seconds = _fleet_streams(torch, dq, svc, sessions)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        folds = svc.metrics.counter_value("deequ_service_fleet_stream_folds_total")
        snap = svc.fleet.snapshot()
    print(f"[fleet (b) fleet] {len(sessions)} sessions x {FLEET_BATCHES} x {FLEET_ROWS} rows in "
          f"{seconds:.3f}s = {len(sessions) / seconds:.2f} sessions/s, {n_rows / seconds:.0f} "
          f"rows/s; fleet stream folds {folds:.0f}; assignment {snap['assignment']}; "
          f"launches={launches}", flush=True)
    _launched("fleet (b)", launches, FLEET_STREAM_KERNELS)
    problems = []
    if folds != len(sessions) * FLEET_BATCHES:
        problems.append(f"{folds} fleet stream folds, not {len(sessions) * FLEET_BATCHES}")
    for key in sessions:
        problems += [f"session {key}: {p}" for p in compare_metrics(got[key], single[key])]
    if problems:
        raise AssertionError("phase 16 (b) disagrees:\n" + "\n".join(problems[:40]))
    return single


def fleet_loss_drill(torch, dq, single: dict, device: str = "cuda") -> None:
    """Phase 16 (c): a shard of tenant a's 4-shard lease lost at a's second
    fold; one session a tenant, folds in order."""
    from deequ_tpu_torch.reliability import FaultSpec, inject
    from deequ_tpu_torch.service import VerificationService

    sessions = [(t, 0) for t in range(FLEET_TENANTS)]
    with drill("fleet (c)"), VerificationService(
            workers=4, background_warm=False, device=device, fleet=True,
            fleet_devices=FLEET_SHARDS) as svc:
        fleet = svc.fleet
        for key in sessions:
            fleet.acquire(f"t{key[0]}")
            fleet.release(f"t{key[0]}")
        lease_a = fleet.devices_of("t0")
        dead = lease_a[2]
        granted = []
        acquire = fleet.acquire

        def recording(tenant):
            lease = acquire(tenant)
            granted.append((tenant, lease.positions))
            return lease

        fleet.acquire = recording
        handles = {key: svc.session(f"t{key[0]}", f"s{key[1]}", [fleet_stream_check(dq)])
                   for key in sessions}
        t0 = time.perf_counter()
        for b in range(FLEET_BATCHES):
            for key in sessions:
                batch = fleet_batch(key[0], key[1], b)
                if key == sessions[0] and b == 1:
                    repacks = fleet.repacks
                    with inject(FaultSpec("sharded_fold", "mesh_loss", at=1, shard=2)) as inj:
                        handles[key].ingest(batch, timeout=FLEET_WAIT_S)
                    mark = len(granted)
                else:
                    handles[key].ingest(batch, timeout=FLEET_WAIT_S)
        seconds = time.perf_counter() - t0
        got = {key: metric_values(h.current()) for key, h in handles.items()}
        snap = fleet.snapshot()
        losses = svc.metrics.counter_value("deequ_service_fleet_shard_losses_total")
    after = granted[mark:]
    print(f"[fleet (c)] a's lease {lease_a}, shard 2 = position {dead}; healthy after "
          f"{snap['healthy']}; fleet shard losses {losses:.0f}; re-packs "
          f"{snap['repacks'] - repacks}; assignment after {snap['assignment']}; leases after "
          f"the loss {after}; {seconds:.3f}s", flush=True)
    problems = []
    if not inj.fired:
        problems.append("the injected shard loss did not fire")
    if snap["healthy"] != [p for p in range(FLEET_SHARDS) if p != dead]:
        problems.append(f"healthy {snap['healthy']}, lost {dead}")
    if losses != 1.0:
        problems.append(f"{losses} fleet shard losses")
    if snap["repacks"] <= repacks:
        problems.append("no re-pack")
    if not after or any(dead in positions for _, positions in after):
        problems.append(f"the leases after the loss: {after}")
    for key in sessions:
        problems += [f"session {key}: {p}" for p in compare_metrics(got[key], single[key])]
    if problems:
        raise AssertionError("phase 16 (c) disagrees:\n" + "\n".join(problems))


def fleet_explicit_mesh(torch, dq, data, check, mesh_metrics: dict, single: dict,
                        device: str = "cuda") -> None:
    """Phase 16 (d): ``VerificationService(mesh=make_mesh(8))``."""
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.parallel import make_mesh
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers
    from deequ_tpu_torch.runners.engine import warm_fused_program
    from deequ_tpu_torch.service import VerificationService

    required = [dq.CountDistinct("cat_large")]
    mesh = make_mesh(FLEET_SHARDS, device=device)
    warm_fused_program(collect_required_analyzers([check], required), data,
                       batch_size=BATCH_ROWS, device=device, mesh=mesh)
    problems = []
    with VerificationService(workers=4, background_warm=False, device=device,
                             mesh=mesh) as svc:
        if svc.fleet is not None:
            problems.append("an explicit mesh left a fleet on")
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        handle = svc.submit_verification(data, [check], required_analyzers=required)
        got = metric_values(handle.result(FLEET_WAIT_S))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        print(f"[fleet (d) mesh] {data.num_rows} rows in {seconds:.3f}s = "
              f"{data.num_rows / seconds:.0f} rows/s; tier {_job_tier(handle)}; "
              f"launches={launches}", flush=True)
        _launched("fleet (d)", launches, FLEET_DEVICE_KERNELS)
        if _job_tier(handle) != "device":
            problems.append(f"the mesh verify ran on the {_job_tier(handle)} tier")
        want = {k: v for k, v in mesh_metrics.items() if k in got}
        problems += [f"verify: {p}" for p in compare_metrics(got, want)]
        sessions = [(t, 0) for t in range(FLEET_TENANTS)]
        widths = svc.metrics.counter_value("deequ_service_coalesce_width_total")
        reset_launch_counts()
        streams, seconds = _fleet_streams(torch, dq, svc, sessions)
        launches = {k: v for k, v in launch_counts().items() if v}
        moved = svc.metrics.counter_value("deequ_service_coalesce_width_total") - widths
        print(f"[fleet (d) sessions] {len(sessions)} sessions x {FLEET_BATCHES} folds on the "
              f"serial path over the mesh in {seconds:.3f}s; coalesce width moved by {moved}; "
              f"launches={launches}", flush=True)
        if moved:
            problems.append(f"the coalesce width moved by {moved}")
        for key in sessions:
            problems += [f"session {key}: {p}" for p in compare_metrics(streams[key],
                                                                        single[key])]
    if problems:
        raise AssertionError("phase 16 (d) disagrees:\n" + "\n".join(problems[:40]))


def fleet_plane(torch, dq, table=None, data=None, check=None, phase3=None, mesh_metrics=None,
                device: str = "cuda") -> None:
    """Phase 16: the fleet scheduler and the service's mesh route, (a)-(d).
    Alone (no table given) it builds phase 3's table and check and runs
    phase 3's verification and phase 9 (c)'s mesh run for their metrics."""
    from deequ_tpu_torch.parallel import make_mesh
    from deequ_tpu_torch.service import mesh_substrate

    if table is None:
        table = build_table(ROWS, 0)
        data = dq.Dataset.from_arrow(table)
        check = build_check(dq, ROWS)
        phase3 = metric_values(dq.VerificationSuite.on_data(data, device=device)
                               .add_check(check)
                               .add_required_analyzer(dq.CountDistinct("cat_large")).run())
        quantile = dq.ApproxQuantile("a", 0.5, KLL_RELATIVE_ERROR)
        mesh_metrics = _without(metric_values(_mesh_run(dq, table, quantile, dq.RunMonitor(),
                                                        device=device, placement="device")),
                                metric_key(quantile))
    print(f"[fleet substrate] {mesh_substrate(make_mesh(FLEET_SHARDS, device=device).devices)}; "
          f"the visible cards: {mesh_substrate()}", flush=True)
    with part_seconds("phase 16 (a)"):
        fleet_batch_jobs(torch, dq, table, data, check, phase3, device)
    with part_seconds("phase 16 (b)"):
        single = fleet_stream_folds(torch, dq, device)
    with part_seconds("phase 16 (c)"):
        fleet_loss_drill(torch, dq, single, device)
    with part_seconds("phase 16 (d)"):
        fleet_explicit_mesh(torch, dq, data, check, mesh_metrics, single, device)


# ---------------------------------------------------------------------------
# phase 17: the whole-service chaos soak, the tuning report and grouping
# tables on a mesh
# ---------------------------------------------------------------------------

#: phase 17 (a): ``tools/torch_chaos_soak.py``'s CLI defaults; (b) the same
#: soak at 2^18 rows a job (the stream batches keep their 512 rows)
CHAOS_SOAK = {"jobs": 30, "stream_batches": 8, "rows": 4096, "seed": 0, "workers": 4}
CHAOS_BIG_ROWS = 1 << 18
BENCH_POINT_TIMEOUT_S = 600


def chaos_soak_run(label: str, card: str, device: str = "cuda", **sizes) -> dict:
    """One ``run_soak`` of ``tools/torch_chaos_soak.py`` on ``device`` (the
    cluster drill off: phase 15 (c) runs it), its launches read before and
    after. Fails unless the soak is ``ok`` with no drill skipped, faults
    fired, the router learned a device failure, and K1, K2 and K8 were
    launched. The soak injects its faults itself, so it runs as a drill."""
    from deequ_tpu_torch.kernels import launch_counts
    from tools.torch_chaos_soak import run_soak, skipped_drills

    before = launch_counts()
    t0 = time.perf_counter()
    with drill(f"phase 17 ({label})"):
        summary = run_soak(device=device, cluster_drill=False, **sizes)
    seconds = time.perf_counter() - t0
    launches = {n: c - before[n] for n, c in launch_counts().items()}
    # the battery's scan and HLL, the session merges (K1, K2, K8)
    by_k = _kernel_launches(launches)
    skipped = skipped_drills(summary)
    tuning, mesh, fleet = summary["tuning_drill"], summary["mesh_drill"], summary["fleet_drill"]
    print(f"[chaos ({label})] {sizes['jobs']} jobs x {sizes['rows']} rows, "
          f"{sizes['stream_batches']} stream batches of 512, {sizes['workers']} workers, seed "
          f"{sizes['seed']}: {seconds:.3f}s (the soak's clock {summary['seconds']}s) on {card}; "
          f"ok {summary['ok']}, failed {summary['failed_invariants']}, skipped {skipped}; "
          f"succeeded {summary['succeeded']}, typed failures {summary['typed_failures']}, "
          f"degraded metrics {summary['degraded_metrics']}, stream folds "
          f"{summary['stream_folds_ok']} (drift rejects {summary['drift_rejects']}); faults "
          f"fired {summary['faults_fired']}, device failures learned "
          f"{summary['device_failures_learned']}; mesh drill {mesh['devices']} shards, "
          f"degraded {mesh.get('degraded')}; fleet drill healthy {fleet.get('healthy_after')}, "
          f"stream folds {fleet.get('mesh_stream_folds')}; tuning drill sessions/s static "
          f"{tuning.get('static_sessions_per_s')}, poisoned "
          f"{tuning.get('poisoned_sessions_per_s')}, recovered "
          f"{tuning.get('recovered_sessions_per_s')}, decisions {tuning.get('decisions')}",
          flush=True)
    print(f"[chaos ({label}) launches] {by_k}; by entry "
          f"{ {n: c for n, c in sorted(launches.items())} }", flush=True)
    problems = []
    if not summary["ok"]:
        problems.append(f"failed invariants {summary['failed_invariants']}: " + "; ".join(
            f"{name} {summary.get(name)}" for name in summary["failed_invariants"]))
    if skipped:
        problems.append(f"skipped drills {skipped}")
    if summary["faults_fired"] <= 0 or summary["device_failures_learned"] <= 0:
        problems.append(f"faults fired {summary['faults_fired']}, device failures learned "
                        f"{summary['device_failures_learned']}")
    missing = [k for k, n in by_k.items() if n == 0]
    if missing:
        problems.append(f"launched no {missing}: {launches}")
    if problems:
        raise AssertionError(f"phase 17 ({label}):\n" + "\n".join(problems))
    return summary


def tuning_bench_point(card: str, device: str = "cuda") -> dict:
    """Phase 17 (c): ``tools/torch_tuning_report.py --bench-point`` once in
    a subprocess on ``device``; its JSON line printed (no gate on rates)."""
    out = subprocess.run(
        [sys.executable, "-m", "tools.torch_tuning_report", "--bench-point", "--device", device],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=BENCH_POINT_TIMEOUT_S,
    )
    lines = [line for line in out.stdout.splitlines() if line.strip()]
    if out.returncode != 0 or not lines:
        raise AssertionError(f"torch_tuning_report --bench-point exited {out.returncode}: "
                             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    print(f"[tuning bench point] {card}: {lines[-1]}", flush=True)
    return json.loads(lines[-1])


def chaos_plane(torch, device: str = "cuda") -> None:
    """Phase 17 (a)-(c) but the report's profile check (run inside phase
    14, while its profile exists): the soak at its CLI's defaults, the same
    soak at 2^18 rows a job, and the tuning report's bench point."""
    card = _nvidia_smi()
    with part_seconds("phase 17 (a)"):
        chaos_soak_run("a", card, device, **CHAOS_SOAK)
    with part_seconds("phase 17 (b)"):
        chaos_soak_run("b", card, device, **dict(CHAOS_SOAK, rows=CHAOS_BIG_ROWS))
    with part_seconds("phase 17 (c) bench point"):
        tuning_bench_point(card, device)


def tuning_report_check(profile_dir: str, profile, device: str = "cuda") -> None:
    """Phase 17 (c): ``tools/torch_tuning_report.py --json`` on the profile
    phase 14 calibrated: its calibrated knobs equal the profile's derived
    values, its probes the profile's probes."""
    import io

    from tools import torch_tuning_report

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = torch_tuning_report.main(["--json", "--dir", profile_dir, "--device", device])
    report = json.loads(text.getvalue())
    rows = (report.get("profile") or {}).get("knobs", {})
    calibrated = {name: row["calibrated"] for name, row in rows.items()}
    print(f"[tuning report] {_nvidia_smi()}; substrate {report['substrate']}; calibrated "
          f"{calibrated}; static { {n: r['static'] for n, r in rows.items()} }", flush=True)
    if rc != 0 or calibrated != profile.knob_values or (
            report["profile"]["probes"] != profile.probes):
        raise AssertionError(f"phase 17 (c): the report {report} is not the calibrated "
                             f"profile {profile}")


def mesh_grouping(torch, dq, grouping: pa.Table, resident: dict, device: str = "cuda") -> None:
    """Phase 17 (d): phase 5's grouping workload over ``make_mesh(8)`` on
    the card, resident and non-resident (a 2^22-entry buffer, as 5 (b)):
    each equal to phase 5 (a)'s metrics, one device table, K6 launched and
    K7 in the non-resident run."""
    from deequ_tpu_torch.parallel import make_mesh

    rows = grouping.num_rows
    data = dq.Dataset.from_arrow(grouping)
    battery = [dq.Uniqueness(["k"]), dq.CountDistinct(["k"]), dq.Entropy("k")]
    mesh = make_mesh(8, device=device)
    card = _nvidia_smi()

    def run(**options):
        def go(monitor):
            ctx = (dq.AnalysisRunner.on_data(data, device=device).add_analyzers(battery)
                   .with_batch_size(BATCH_ROWS).with_monitor(monitor).with_sharding(mesh)
                   .with_frequency_options(**options).run())
            return {a.name: ctx.metric(a).value.get() for a in battery}
        return go

    problems = []
    for label, options, kernels in (
            ("resident", {}, ("freq_keys",)),
            ("non-resident", {"freq_buffer_entries": FULL_TABLE_SLOTS}, FREQ_KERNELS)):
        got, monitor, _ = _timed_run(torch, f"grouping on make_mesh(8) {label}; {card}",
                                     run(**options), rows, kernels)
        if monitor.device_freq_sets != 1 or monitor.passes != 1:
            problems.append(f"{label}: {monitor.device_freq_sets} device tables, "
                            f"{monitor.passes} passes")
        problems += [f"{label}: {p}" for p in _compare_grouping(got, resident, 0.0)]
    if problems:
        raise AssertionError("phase 17 (d) disagrees with phase 5 (a):\n" + "\n".join(problems))
    print(f"[grouping on make_mesh(8)] resident and non-resident equal to phase 5 (a): "
          f"{resident}", flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _print_kernel_totals(measured: dict, names, path: str) -> None:
    for name in names:
        r = measured[name]
        print(f"[kernel {name} {path}] ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g}", flush=True)


def profile_path(torch, dq, table: pa.Table) -> tuple:
    """Phase 2 at the profile path's shapes, then phase 4, over the
    lineitem table. Returns the kernels' measurements at those shapes and
    the launch counts of the profile run."""
    from deequ_tpu_torch.analyzers import Histogram
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.profiles import first_pass_analyzers
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    device = torch.device("cuda")

    # phase 2 at the shapes of the profile's first pass, the one whose
    # battery holds every kernel
    with phase(2):
        probe = dq.Dataset.from_arrow(table)
        first_pass = first_pass_analyzers(probe, probe.schema.names, {})
        battery = [a for a in first_pass if not isinstance(a, Histogram)]
        battery += [DeviceFrequencyScan(a.column, probe.dictionary_size(a.column))
                    for a in first_pass if isinstance(a, Histogram)]
        engine = ScanEngine(battery, device)
        features = to_device(engine.builder.build(next(probe.batches(BATCH_ROWS))), device)
        measured = check_kernels(torch, engine, features)
        check_kll_edges(torch, features["num:l_extendedprice"], features["rows"])
        del features
        check_kll_cases(torch)
        _print_kernel_totals(measured, PROFILE_KERNELS, "profile path")
        ingest_measured, ingest_sketches = check_ingest_kernels(torch, dq, probe, table,
                                                                first_pass)
        del probe

    # phase 4: the profile on the card, launch counts set to 0 just before
    data = dq.Dataset.from_arrow(table)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    monitor = dq.RunMonitor()
    reset_launch_counts()
    t0 = time.perf_counter()
    profiles = dq.ColumnProfilerRunner.on_data(data, device="cuda").with_monitor(monitor).run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    phases = {k: round(v, 4) for k, v in monitor.phase_seconds.items()}
    print(f"[profile] {LINEITEM_ROWS} rows x {table.num_columns} columns in {seconds:.3f}s = "
          f"{LINEITEM_ROWS / seconds:.0f} rows/s; passes={monitor.passes} "
          f"batches={monitor.batches}; launches={launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB; phases={phases}", flush=True)
    missing = [name for name in PROFILE_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the profile launched no {missing}")
    # the first pass's 16 HLL columns: one launch a batch
    if launches["hll_registers_columns"] != -(-LINEITEM_ROWS // BATCH_ROWS):
        raise AssertionError(f"expected one K2 launch a first-pass batch, got {launches}")

    gpu = profile_values(profiles)
    # the CPU comparison at the table's first PROFILE_CPU_ROWS rows, on the
    # card and the CPU; the full-size run is held against the oracle
    cut = dq.Dataset.from_arrow(table.slice(0, PROFILE_CPU_ROWS))
    t0 = time.perf_counter()
    cut_card = profile_values(dq.ColumnProfilerRunner.on_data(cut, device="cuda").run())
    cpu = profile_values(dq.ColumnProfilerRunner.on_data(cut, device="cpu").run())
    print(f"[cpu] the same profile at {PROFILE_CPU_ROWS} rows on the card and the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    problems = compare_profiles(cut_card, cpu)
    oracle_problems, worst_rank = compare_profile_oracle(gpu, table)
    if problems or oracle_problems:
        raise AssertionError("profiles disagree:\n" + "\n".join(problems + oracle_problems))
    numeric = sum(1 for v in list(gpu.values())[1:] if v["kll"] is not None)
    print(f"[profile metrics] {len(gpu) - 1} column profiles agree with the oracle, and at "
          f"{PROFILE_CPU_ROWS} rows with the CPU run; {numeric} KLL sketches, largest "
          f"percentile rank error {worst_rank:.6f} (limit {2 * KLL_RELATIVE_ERROR:.6f})",
          flush=True)
    return measured, launches, ingest_measured, ingest_sketches


def _suggestion_run(dq, data, device: str, rules, monitor=None):
    """The JAX bench's suggestion run (bench.py run_suggestion_stage) on
    ``device``: ``rules``, a quarter of the rows held out with seed 0."""
    from deequ_tpu_torch.suggestions import ConstraintSuggestionRunner

    builder = (ConstraintSuggestionRunner.on_data(data, device=device)
               .add_constraint_rules(rules)
               .use_train_test_split_with_testset_ratio(WIDE_TESTSET_RATIO,
                                                        testset_split_random_seed=WIDE_SPLIT_SEED))
    if monitor is not None:
        builder = builder.with_monitor(monitor)
    return builder.run()


def suggestion_path(torch, dq) -> tuple:
    """Phase 2 at the suggestion path's shapes, then phase 10 (BASELINE
    config 5): the cut table, K1 and K2 on the first batch of the training
    split's first profile pass (every K1 bundle, the K2 battery of 50
    columns), the suggestion run on the card with its launch counts, held
    against a numpy oracle, and the table's first ``WIDE_CPU_ROWS`` rows
    with the uniqueness rule added twice on the card (cold and warm,
    equal), on the CPU and against the oracle. Returns the kernels'
    measurements at those shapes and the launch counts of the full-size
    run."""
    from deequ_tpu_torch.analyzers import ApproxCountDistinct, ScanShareableAnalyzer
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.profiles import first_pass_analyzers
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device
    from deequ_tpu_torch.suggestions import Rules, UniqueIfApproximatelyUniqueRule

    device = torch.device("cuda")
    t0 = time.perf_counter()
    table = build_wide(WIDE_ROWS)
    data = dq.Dataset.from_arrow(table)
    print(f"[wide] {WIDE_ROWS} rows x {table.num_columns} columns in "
          f"{time.perf_counter() - t0:.1f}s; {table.nbytes / 2**30:.2f} GiB of Arrow", flush=True)

    # phase 2 at the shapes of the training split's first profile pass:
    # K1's bundles and K2's battery (the other kernels' shapes are phase 4's)
    with phase(2):
        t0 = time.perf_counter()
        train, _ = data.random_split(1.0 - WIDE_TESTSET_RATIO, seed=WIDE_SPLIT_SEED)
        print(f"[suggest split] random_split of {WIDE_ROWS} rows in "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
        first_pass = first_pass_analyzers(train, train.schema.names, {})
        battery = [a for a in first_pass if isinstance(a, ApproxCountDistinct) or (
            isinstance(a, ScanShareableAnalyzer) and a.scan_slot() is not None)]
        engine = ScanEngine(battery, device)
        features = to_device(engine.builder.build(next(train.batches(BATCH_ROWS))), device)
        print(f"[suggestion battery] {len(battery)} analyzers of the first pass: "
              f"{[len(b) for b in engine.program.bundles]} K1 slots a bundle, "
              f"{len(engine.program.hll_of)} HLL columns", flush=True)
        measured = check_kernels(torch, engine, features)
        del features, train, engine
        _print_kernel_totals(measured, ("scan_reduce", "hll_registers_columns"),
                             "suggestion path")

    # phase 10 (c): the bench's run, launch counts set to 0 just before it
    # (its warm twin runs at (d)'s cut: the time budget of the script)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    monitor = dq.RunMonitor()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = _suggestion_run(dq, data, "cuda", Rules.DEFAULT, monitor)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    phases = {k: round(v, 4) for k, v in monitor.phase_seconds.items()}
    print(f"[suggest cold] {WIDE_ROWS} rows x {table.num_columns} columns in "
          f"{seconds:.3f}s = {WIDE_ROWS / seconds:.0f} rows/s; "
          f"{len(result.all_suggestions)} suggestions; passes={monitor.passes} "
          f"batches={monitor.batches}; launches={launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB; phases={phases}", flush=True)

    # (e) every kernel of the profile ran; K1 and K2 each more than once a
    # batch of the first profile pass (50 columns: over 64 slots, over 32
    # HLL columns)
    missing = [name for name in PROFILE_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the suggestion path launched no {missing}")
    train_batches = -(-result.num_records // BATCH_ROWS)
    per_batch = {name: launches[name] / monitor.batches for name in ("scan_reduce",)}
    per_batch["hll_registers_columns"] = launches["hll_registers_columns"] / train_batches
    print(f"[suggest launches] {monitor.batches} batches in {monitor.passes} passes, "
          f"{train_batches} in the first profile pass; a batch: {per_batch}", flush=True)
    if launches["hll_registers_columns"] != 2 * train_batches:
        raise AssertionError(f"expected two K2 launches a first-pass batch (50 HLL columns), "
                             f"got {launches['hll_registers_columns']}")
    if launches["scan_reduce"] < 2 * train_batches:
        raise AssertionError(f"expected at least two K1 launches a first-pass batch, got "
                             f"{launches['scan_reduce']}")

    # (d) the full-size run against numpy over its splits
    got = suggestion_values(result)
    t0 = time.perf_counter()
    problems = suggestion_oracle(result, got[1], *split_rows(table))
    if problems:
        raise AssertionError("suggestions disagree:\n" + "\n".join(problems))
    print(f"[suggest metrics] {len(result.all_suggestions)} suggestions and their statuses on "
          f"the test split ({got[1].count('Success')} Success); the oracle holds "
          f"{len(result.column_profiles)} profiles and every status "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    del result, data

    # (d), (f): the table's first WIDE_CPU_ROWS rows with the uniqueness rule
    # added (its is_unique constraints run on the device frequency table of
    # the test split) on the card, cold then warm (equal), and on the CPU,
    # character for character (the default rules' suggestions among them),
    # and against numpy
    small = table.slice(0, WIDE_CPU_ROWS)
    del table
    rules = tuple(Rules.DEFAULT) + (UniqueIfApproximatelyUniqueRule(),)
    data = dq.Dataset.from_arrow(small)
    monitor = dq.RunMonitor()
    reset_launch_counts()
    t0 = time.perf_counter()
    unique = _suggestion_run(dq, data, "cuda", rules, monitor)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    unique_launches = launch_counts()
    n_unique = sum(1 for s in unique.all_suggestions
                   if s.code_for_constraint.startswith(".is_unique"))
    print(f"[suggest (f) uniqueness rule] {WIDE_CPU_ROWS} rows in {seconds:.3f}s; "
          f"{n_unique} is_unique; device_freq_sets={monitor.device_freq_sets}; "
          f"launches={unique_launches}", flush=True)
    if unique_launches["freq_keys"] == 0:
        raise AssertionError("the uniqueness rule's run launched no freq_keys")
    got = suggestion_values(unique)
    t0 = time.perf_counter()
    warm = suggestion_values(_suggestion_run(dq, data, "cuda", rules))
    torch.cuda.synchronize()
    print(f"[suggest warm] {WIDE_CPU_ROWS} rows on the card: cold {seconds:.3f}s, warm "
          f"{time.perf_counter() - t0:.3f}s", flush=True)
    t0 = time.perf_counter()
    want = suggestion_values(_suggestion_run(dq, data, "cpu", rules))
    print(f"[cpu] the same suggestion run at {WIDE_CPU_ROWS} rows on the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    problems = [] if warm == got else ["the cold and warm runs disagree"]
    problems += [] if got == want else ["the card's suggestions or statuses differ from the CPU's"]
    problems += suggestion_oracle(unique, got[1], *split_rows(small))
    if problems:
        raise AssertionError("uniqueness-rule suggestions disagree:\n" + "\n".join(problems))
    print("[suggest (f) metrics] cold equal to warm, equal to the CPU run and the oracle",
          flush=True)
    return measured, launches


# ---------------------------------------------------------------------------
# phase 18: the device feature cache, the examples suite and the operator
# switches
# ---------------------------------------------------------------------------

#: phase 18 (a): the feature cache's budget, in tables' worth of phase 3's
#: features (one fits, two do not)
CACHE_BUDGET_TABLES = 1.5
#: phase 18 (a): the budget of the run that measures one table's bytes
CACHE_PROBE_GB = 40
#: phase 18 (b): the examples of ``examples_torch``
EXAMPLES = (
    "basic_example", "incremental_metrics_example",
    "update_metrics_on_partitioned_data_example", "metrics_repository_example",
    "anomaly_detection_example", "data_profiling_example", "constraint_suggestion_example",
    "kll_example", "kll_check_example", "multi_device_example",
    "continuous_verification_example",
)
#: phase 18 (b): the kernels each example's path launches besides K1 (or
#: K1's stacked entry)
EXAMPLE_KERNELS = {
    "basic_example": ("kll_sample",),
    "incremental_metrics_example": ("hll_registers_columns", "state_fold"),
    "update_metrics_on_partitioned_data_example": ("state_fold",),
    "data_profiling_example": ("kll_sample", "kll_compact"),
    "constraint_suggestion_example": ("kll_sample", "kll_compact"),
    "kll_example": ("kll_sample", "kll_compact"),
    "kll_check_example": ("kll_sample",),
    "multi_device_example": ("scan_reduce_stacked", "state_fold_butterfly"),
}
#: phase 18 (c): the cut of phase 3's table the switches run on, its
#: dictionary columns as plain strings (so the ingest-time encoding decides)
SWITCH_ROWS = 1_000_000
#: phase 18 (c): host tier pool sizes, each held bit for bit to the default,
#: and the host tier's batches (16 of them, so the pool has work to share)
SWITCH_WORKERS = (1, 7)
SWITCH_HOST_BATCH_ROWS = 1 << 16
#: masked in the examples' printed lines: epoch milliseconds, temporary paths
_EXAMPLE_MASKS = ((re.compile(r"\b\d{13}\b"), "<epoch-ms>"), (re.compile(r"/tmp/\S+"), "<tmp>"))
_NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+(?:e[-+]?\d+)?")


def _cached_run(torch, dq, data, check, label: str, depth: int, card: str) -> tuple:
    """Phase 3's verification run at feed depth ``depth`` with whatever
    feature cache the environment sets. Returns (metrics, monitor,
    launches)."""
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    monitor = dq.RunMonitor()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with _env("DEEQU_TPU_PREFETCH_DEPTH", str(depth)):
        result = (dq.VerificationSuite.on_data(data, device="cuda").add_check(check)
                  .add_required_analyzer(dq.CountDistinct("cat_large"))
                  .with_monitor(monitor).run())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    phases = {k: round(v, 4) for k, v in monitor.phase_seconds.items()
              if not k.startswith("feature_build.")}
    print(f"[cache {label}, depth {depth}] {ROWS} rows in {seconds:.3f}s; "
          f"{monitor.feature_cache_hits} of {monitor.batches} batches hit; "
          f"launches={ {k: v for k, v in launches.items() if v} }; phases={phases}; {card}",
          flush=True)
    return metric_values(result), monitor, launches


def feature_cache_path(torch, dq, data, check, gpu_metrics: dict, seed: int, card: str) -> None:
    """Phase 18 (a): phase 3's run under ``DEEQU_TPU_DEVICE_FEATURE_CACHE``.
    A first run under a large budget measures one table's features; under
    a budget of 1.5 tables, at feed depths 0 and 2, a cold run admits every
    batch and a warm run hits every batch (no feature build, no copy, K1-K3
    launched), both equal to phase 3's metrics bit for bit; then a second
    table (the next seed) evicts the first whole, and clearing the cache
    returns its device memory."""
    from deequ_tpu_torch.runners import engine

    knob = engine.DEVICE_FEATURE_CACHE_ENV
    n_batches = -(-ROWS // BATCH_ROWS)
    engine.clear_device_feature_cache()
    with _env(knob, str(CACHE_PROBE_GB)):
        _cached_run(torch, dq, data, check, "probe", 0, card)
        one_table = engine.device_feature_cache().bytes
    engine.clear_device_feature_cache()
    budget_gb = CACHE_BUDGET_TABLES * one_table / 1e9
    print(f"[cache] one table's features: {one_table} bytes in {n_batches} batches; "
          f"budget {budget_gb!r} GB", flush=True)
    problems = []
    with _env(knob, repr(budget_gb)):
        for depth in (0, 2):
            engine.clear_device_feature_cache()
            cold, cold_mon, _ = _cached_run(torch, dq, data, check, "cold", depth, card)
            cache = engine.device_feature_cache()
            if cold_mon.feature_cache_hits or cache.bytes != one_table \
                    or len(cache.store) != n_batches:
                problems.append(f"depth {depth}: the cold run hit {cold_mon.feature_cache_hits}"
                                f" and left {cache.bytes} bytes in {len(cache.store)} entries")
            warm, warm_mon, warm_launches = _cached_run(torch, dq, data, check, "warm", depth,
                                                        card)
            if warm_mon.feature_cache_hits != n_batches or warm_mon.batches != n_batches:
                problems.append(f"depth {depth}: {warm_mon.feature_cache_hits} of "
                                f"{warm_mon.batches} warm batches hit")
            for phase_name in ("feature_build", "host_to_device"):
                if warm_mon.phase_seconds.get(phase_name, 0.0):
                    problems.append(f"depth {depth}: the warm run spent "
                                    f"{warm_mon.phase_seconds[phase_name]} s in {phase_name}")
            missing = [k for k in VERIFICATION_KERNELS if not warm_launches[k]]
            if missing:
                problems.append(f"depth {depth}: the warm run launched no {missing}")
            for label, got in (("cold", cold), ("warm", warm)):
                problems += [f"depth {depth} {label}: {p}"
                             for p in compare_metrics(got, gpu_metrics, rtol=0.0)]
        held = torch.cuda.memory_allocated()
        second = dq.Dataset.from_arrow(build_table(ROWS, seed + 1))
        _cached_run(torch, dq, second, check, "second table", 0, card)
        cache = engine.device_feature_cache()
        if cache.evictions != 1 or list(cache.tables) != [id(second.arrow)] \
                or cache.bytes != one_table:
            problems.append(f"the second table left evictions={cache.evictions}, tables="
                            f"{len(cache.tables)}, {cache.bytes} bytes")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine.clear_device_feature_cache()
    del second, cache
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"[cache] device memory allocated: {held} bytes with the first table cached, "
          f"{before} with the second, {after} after clear_device_feature_cache()", flush=True)
    if before - after < one_table:
        problems.append(f"clearing the cache returned {before - after} bytes of {one_table}")
    if problems:
        raise AssertionError("the feature cache:\n" + "\n".join(problems))
    print(f"[cache] every warm batch hit at depths 0 and 2, phase 3's metrics bit for bit; "
          f"the second table evicted the first whole", flush=True)


def _masked_lines(text: str) -> list:
    for pattern, mask in _EXAMPLE_MASKS:
        text = pattern.sub(mask, text)
    return text.splitlines()


def same_printed_lines(got: str, want: str, rtol: float = 1e-12) -> bool:
    """Equal text once timestamps and temporary paths are masked, numbers
    within ``rtol`` relative (moments differ in the last bits)."""
    g_lines, w_lines = _masked_lines(got), _masked_lines(want)
    if len(g_lines) != len(w_lines):
        return False
    for g, w in zip(g_lines, w_lines):
        if _NUMBER.sub("#", g) != _NUMBER.sub("#", w):
            return False
        for x, y in zip(_NUMBER.findall(g), _NUMBER.findall(w)):
            x, y = float(x), float(y)
            if x != y and not abs(x - y) <= rtol * max(abs(x), abs(y)):
                return False
    return True


def example_values(result):
    """An example's return value as plain data: verification results by
    their JSON, contexts by their metrics, profiles and suggestions by
    their JSON, frames by their sorted records (without ``dataset_date``),
    a service snapshot by its shed and stream-batch counters."""
    if isinstance(result, (tuple, list)):
        return [example_values(r) for r in result]
    if isinstance(result, dict) and "counters" in result:
        return {k: result["counters"].get(k) for k in (
            "deequ_service_jobs_shed_total", "deequ_service_stream_batches_total")}
    if isinstance(result, dict):
        return {k: example_values(v) for k, v in result.items()}
    if hasattr(result, "to_dict") and hasattr(result, "columns"):
        return sorted(result.drop(columns=["dataset_date"]).to_dict("records"),
                      key=lambda r: (r["entity"], r["instance"], r["name"]))
    if hasattr(result, "check_results_as_json"):
        return [result.status.name, json.loads(result.success_metrics_as_json()),
                json.loads(result.check_results_as_json())]
    if hasattr(result, "metric_map"):
        out = {}
        for analyzer, metric in result.metric_map.items():
            value = metric.value.get()
            if hasattr(value, "buckets"):
                value = repr(value.buckets)
            out[repr(analyzer)] = value
        return out
    if hasattr(result, "to_json"):
        return json.loads(result.to_json())
    if hasattr(result, "attempts"):
        return ["job", result.attempts, result.result().status.name]
    if hasattr(result, "name") and hasattr(result, "value"):
        return result.name
    return result


def same_values(got, want, rtol: float = 1e-12) -> bool:
    if isinstance(got, float) and isinstance(want, (int, float)):
        return (got == want or (math.isnan(got) and math.isnan(want))
                or abs(got - want) <= rtol * max(abs(got), abs(want)))
    if isinstance(got, dict) and isinstance(want, dict):
        return got.keys() == want.keys() and all(same_values(got[k], want[k], rtol)
                                                 for k in got)
    if isinstance(got, list) and isinstance(want, list):
        return len(got) == len(want) and all(same_values(g, w, rtol)
                                             for g, w in zip(got, want))
    return got == want


def examples_on_card(torch, card: str) -> None:
    """Phase 18 (b): every example of ``examples_torch`` on
    ``device="cuda"``, its result and printed lines equal to its run on
    ``device="cpu"``, its path's kernels launched (counts printed)."""
    import importlib
    import io

    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    problems = []
    for name in EXAMPLES:
        module = importlib.import_module(f"examples_torch.{name}")
        out = io.StringIO()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            got = module.main(device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        cpu_out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(cpu_out):
            want = module.main(device="cpu")
        cpu_seconds = time.perf_counter() - t0
        print(f"[example {name}] cuda {seconds:.3f}s, cpu {cpu_seconds:.3f}s; "
              f"{len(out.getvalue().splitlines())} lines; launches={launches}; {card}",
              flush=True)
        if not same_values(example_values(got), example_values(want)):
            problems.append(f"{name}: the card's result differs from the CPU's")
        if not same_printed_lines(out.getvalue(), cpu_out.getvalue()):
            problems.append(f"{name}: the card's printed lines differ from the CPU's")
        needed = EXAMPLE_KERNELS.get(name, ())
        missing = [k for k in needed if not launches.get(k)]
        if not (launches.get("scan_reduce") or launches.get("scan_reduce_stacked")):
            missing.append("scan_reduce")
        if missing:
            problems.append(f"{name}: launched no {missing}")
    if problems:
        raise AssertionError("the examples:\n" + "\n".join(problems))
    print(f"[examples] {len(EXAMPLES)} examples on the card equal to their CPU runs", flush=True)


def switch_cut(table: pa.Table) -> pa.Table:
    """Phase 18 (c)'s table: phase 3's first ``SWITCH_ROWS`` rows, the
    dictionary columns decoded to plain strings."""
    cut = table.slice(0, SWITCH_ROWS)
    for name in ("cat_small", "cat_large"):
        cut = cut.set_column(cut.schema.get_field_index(name), name,
                             cut.column(name).cast(pa.string()))
    return cut


def _switch_run(torch, dq, data, label: str, card: str, **kw) -> tuple:
    """Phase 3's check over the cut on the card; (metrics, monitor, launches)."""
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    monitor = dq.RunMonitor()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = dq.VerificationSuite.do_verification_run(
        data, [build_check(dq, SWITCH_ROWS)], monitor=monitor, device="cuda", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    print(f"[switch {label}] {SWITCH_ROWS} rows in {seconds:.3f}s on the {monitor.placement} "
          f"tier; launches={launches}; {card}", flush=True)
    return metric_values(result), monitor, launches


@contextlib.contextmanager
def native_disabled():
    """``DEEQU_TPU_NO_NATIVE=1`` in this process for a block: the switch is
    read when ``deequ_tpu_torch.native.lib`` is imported, so the module and
    the package that re-exports it are imported again under it, and again
    without it after the block (every caller imports the host kernels from
    the package at call time). Yields the package."""
    import importlib

    from deequ_tpu_torch import native
    from deequ_tpu_torch.native import lib

    with _env("DEEQU_TPU_NO_NATIVE", "1"):
        importlib.reload(lib)
        importlib.reload(native)
    try:
        yield native
    finally:
        importlib.reload(lib)
        importlib.reload(native)


def operator_switches(torch, dq, table: pa.Table, card: str) -> None:
    """Phase 18 (c): on :func:`switch_cut`, the default run on the card
    against ``DEEQU_TPU_ADAPTIVE_DICT_ENCODE=0`` (no dictionary column),
    the host tier at ``DEEQU_TPU_HOST_TIER_WORKERS`` 1 and 7 (bit for bit
    the default pool's run) and ``DEEQU_TPU_NO_NATIVE=1`` (the numpy host
    kernels, :func:`native_disabled`); each equal to the default run
    (moments within 1e-12). Then ``DEEQU_TPU_PROFILE_DIR``: one trace of
    the pass, naming K1-K3's CUDA kernels."""
    cut = switch_cut(table)
    data = dq.Dataset.from_arrow(cut)
    default, _, launches = _switch_run(torch, dq, data, "default", card)
    problems = []
    missing = [k for k in VERIFICATION_KERNELS if not launches.get(k)]
    if missing:
        problems.append(f"the default run launched no {missing}")
    with _env("DEEQU_TPU_ADAPTIVE_DICT_ENCODE", "0"):
        plain = dq.Dataset.from_arrow(cut)
    print(f"[switch encoding] dictionary sizes of cat_small, cat_large: "
          f"{data.dictionary_size('cat_small')}, {data.dictionary_size('cat_large')}; "
          f"with DEEQU_TPU_ADAPTIVE_DICT_ENCODE=0: {plain.dictionary_size('cat_small')}, "
          f"{plain.dictionary_size('cat_large')}", flush=True)
    if data.dictionary_size("cat_small") is None or plain.dictionary_size("cat_small") \
            is not None:
        problems.append("the encoding switch changed no column")
    got, _, _ = _switch_run(torch, dq, plain, "DEEQU_TPU_ADAPTIVE_DICT_ENCODE=0", card)
    problems += [f"no encoding: {p}" for p in compare_metrics(got, default)]
    del plain

    host, _, host_launches = _switch_run(torch, dq, data, "host tier, every core", card,
                                         placement="host", batch_size=SWITCH_HOST_BATCH_ROWS)
    problems += [f"host tier: {p}" for p in compare_metrics(host, default)]
    if not host_launches.get("state_fold_carry"):
        problems.append("the host tier launched no state_fold_carry")
    for workers in SWITCH_WORKERS:
        with _env("DEEQU_TPU_HOST_TIER_WORKERS", str(workers)):
            got, _, _ = _switch_run(torch, dq, data, f"host tier, {workers} workers", card,
                                    placement="host", batch_size=SWITCH_HOST_BATCH_ROWS)
        problems += [f"{workers} workers: {p}" for p in compare_metrics(got, host, rtol=0.0)]

    with native_disabled() as native:
        plain_kernels = native.native_xxhash64_strings.__name__.endswith("_plain")
        got, _, _ = _switch_run(torch, dq, dq.Dataset.from_arrow(cut),
                                "DEEQU_TPU_NO_NATIVE=1", card)
    print(f"[switch DEEQU_TPU_NO_NATIVE=1] numpy host kernels: {plain_kernels}; the library "
          f"again after: {not native.NATIVE_DISABLED}", flush=True)
    if not plain_kernels or native.NATIVE_DISABLED:
        problems.append("the DEEQU_TPU_NO_NATIVE=1 run did not switch the host kernels")
    problems += [f"no native: {p}" for p in compare_metrics(got, default)]

    scratch = tempfile.mkdtemp(prefix="chip_smoke_switches_")
    try:
        traces = os.path.join(scratch, "traces")
        with _env("DEEQU_TPU_PROFILE_DIR", traces):
            got, _, _ = _switch_run(torch, dq, data, "DEEQU_TPU_PROFILE_DIR", card)
        problems += [f"profiled: {p}" for p in compare_metrics(got, default, rtol=0.0)]
        files = sorted(os.listdir(traces)) if os.path.isdir(traces) else []
        names = set()
        for f in files:
            with open(os.path.join(traces, f)) as fh:
                events = json.load(fh).get("traceEvents", [])
            names |= {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        port_kernels = ("scan_reduce", "hll_registers", "dict_code_counts")
        ours = sorted(n for n in names if any(k in n for k in port_kernels))
        print(f"[switch DEEQU_TPU_PROFILE_DIR] {len(files)} trace(s); {len(names)} distinct "
              f"CUDA kernels, the port's: {ours}", flush=True)
        if len(files) != 1:
            problems.append(f"expected one trace of the pass, found {files}")
        for kernel in port_kernels:
            if not any(kernel in n for n in ours):
                problems.append(f"the trace names no {kernel} kernel")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    if problems:
        raise AssertionError("the operator switches:\n" + "\n".join(problems))
    print("[switch] every switch's run equal to the default run", flush=True)


def switches_and_cache(torch, dq, table: pa.Table, data, check, gpu_metrics: dict,
                       seed: int) -> None:
    """Phase 18 (a) and (c), after phase 3 on its table."""
    card = _nvidia_smi()
    with part_seconds("phase 18 (a)"):
        feature_cache_path(torch, dq, data, check, gpu_metrics, seed, card)
    with part_seconds("phase 18 (c)"):
        operator_switches(torch, dq, table, card)


#: phase 3's seconds and phases, which phase 19 prints its own beside
MAIN_PHASES: dict = {}


def traced_run_check(torch, dq, data, check, monitor, seconds: float) -> None:
    """Phase 3's trace: :func:`run_trace` with one device-tier engine pass,
    the phase spans against ``phase_seconds`` (:func:`check_phase_spans`),
    a Chrome artifact summarised by ``tools/torch_trace_summarize.py``
    with no orphan. Then the same run untraced and traced again, their
    seconds beside the first's: the cost of tracing on the card."""
    from deequ_tpu_torch.observability import export as obs_export
    from deequ_tpu_torch.observability.recorder import recorder
    from deequ_tpu_torch.observability.trace import TRACE_ENV
    from tools.torch_trace_summarize import load_spans, span_accounting, summarize

    spans, passes, events = run_trace("phase 3")
    if [s.attrs["tier"] for s in passes] != ["device"] or events:
        raise AssertionError(f"phase 3: engine passes {[s.attrs for s in passes]}, events "
                             f"{events}")
    counts = check_phase_spans("phase 3", spans, monitor)
    with tempfile.TemporaryDirectory() as tmp:
        artifact = obs_export.write_chrome_trace(os.path.join(tmp, "phase3.trace.json"))
        accounting = span_accounting(load_spans(artifact))
        text = summarize(artifact)
    if accounting != {"total": len(spans), "roots": 1, "orphans": 0, "trace_ids": 1} or \
            "0 orphaned" not in text:
        raise AssertionError(f"phase 3's artifact: {accounting}\n{text}")
    print(f"[trace] phase 3: {len(spans)} spans in 1 trace, 0 orphans; "
          f"{sum(counts.values())} phase spans over {len(counts)} phases {counts}", flush=True)
    lines = text.splitlines()
    for line in lines[1:lines.index(next(ln for ln in lines if ln.startswith("top ")))]:
        print(f"[trace summary] {line}", flush=True)

    def rerun() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (dq.VerificationSuite.on_data(data, device="cuda").add_check(check)
         .add_required_analyzer(dq.CountDistinct("cat_large")).run())
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    recorder().clear()
    with _env(TRACE_ENV, "0"):
        untraced = rerun()
    if recorder().spans():
        raise AssertionError("DEEQU_TPU_TRACE=0 recorded spans")
    traced = rerun()
    if not recorder().spans():
        raise AssertionError("the traced re-run recorded no span")
    recorder().clear()
    print(f"[trace cost] phase 3's run: traced {seconds:.3f}s, untraced (DEEQU_TPU_TRACE=0) "
          f"{untraced:.3f}s, traced again {traced:.3f}s", flush=True)


def verification_path(torch, dq, table: pa.Table, data, check) -> tuple:
    """Phase 3: the main path on the card, launch counts set to 0 just
    before, against the same run on the CPU and the oracle. Returns the
    card's metrics and the run's launches."""
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.observability.recorder import recorder

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    monitor = dq.RunMonitor()
    recorder().clear()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = (dq.VerificationSuite.on_data(data, device="cuda").add_check(check)
              .add_required_analyzer(dq.CountDistinct("cat_large"))
              .with_monitor(monitor).run())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    traced_run_check(torch, dq, data, check, monitor, seconds)
    peak = torch.cuda.max_memory_allocated()
    phases = {k: round(v, 4) for k, v in monitor.phase_seconds.items()}
    MAIN_PHASES.update(phases, seconds=round(seconds, 3))
    print(f"[main] {ROWS} rows in {seconds:.3f}s = {ROWS / seconds:.0f} rows/s; "
          f"batches={monitor.batches}; launches={launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB; phases={phases}", flush=True)
    print(f"[main placement] {monitor.placement}: the link probe read "
          f"{monitor.feed_bandwidth_mbps} MB/s", flush=True)
    missing = [name for name in VERIFICATION_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the verification path launched no {missing}")
    expected_batches = -(-ROWS // BATCH_ROWS)
    if monitor.batches != expected_batches or monitor.passes != 1:
        raise AssertionError(f"expected 1 pass of {expected_batches} batches, got {monitor}")
    if launches["hll_registers_columns"] != expected_batches or launches["hll_registers"]:
        raise AssertionError(f"expected one K2 launch a batch for the battery's HLL columns, "
                             f"got {launches}")

    gpu_metrics = metric_values(result)
    t0 = time.perf_counter()
    cpu_result = (dq.VerificationSuite.on_data(data, device="cpu").add_check(check)
                  .add_required_analyzer(dq.CountDistinct("cat_large")).run())
    print(f"[cpu] the same run on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    problems = compare_metrics(gpu_metrics, metric_values(cpu_result))
    problems += compare_oracle(gpu_metrics, oracle(table))
    statuses = [r.status for r in result.check_results.values()]
    if statuses != [r.status for r in cpu_result.check_results.values()]:
        problems.append(f"check statuses differ: {statuses}")
    if problems:
        raise AssertionError("metrics disagree:\n" + "\n".join(problems))
    print(f"[metrics] {len(gpu_metrics)} metrics agree with the CPU run and the oracle; "
          f"check status {result.status.value}", flush=True)
    return gpu_metrics, launches


# ---------------------------------------------------------------------------
# phase 19: the reference's 32-bit accumulator mode (DEEQU_TPU_NO_X64), in
# a subprocess started with the switch set (the mode is fixed at import)
# ---------------------------------------------------------------------------

#: each float32 entry's launch-count name and the float64 entry whose
#: phase 2 time it stands beside
F32_ENTRIES = {
    "scan_reduce_f32": "scan_reduce", "scan_reduce_stacked_f32": "scan_reduce_stacked",
    "kll_sample_f32": "kll_sample", "kll_compact_f32": "kll_compact",
    "kll_compact_ingest_f32": "kll_compact_ingest",
    "kll_compact_merge_stacked_f32": "kll_compact_merge_stacked",
    "state_fold_f32": "state_fold", "state_fold_carry_f32": "state_fold_carry",
    "state_fold_carry_stacked_f32": "state_fold_carry_stacked",
    "state_fold_butterfly_f32": "state_fold_butterfly",
}
#: float32 sums and moments of a kernel against its plain version, relative
#: to the magnitudes that bound their rounding (the values' absolute sum,
#: largest absolute value and sum of squares)
F32_KERNEL_RTOL = 1e-5
#: a float32 run's metrics against the float64 numpy oracle (the
#: reference's own bound, tests/test_no_x64.py) and against the same run on
#: the CPU (tests/test_torch_no_x64.py measures 9.0e-8 between the packages)
NO_X64_ORACLE_RTOL = 1e-4
NO_X64_CPU_RTOL = 1e-5
#: rows of (b)'s CPU comparison and of (c)-(e)'s runs
NO_X64_CUT_ROWS = 1_000_000


def f32_mats(torch, mats: list) -> list:
    """``state_fold`` matrices in the 32-bit mode's types: the float matrix
    as float32, the counts as int32 (wrapping, the same in the kernel and
    the plain version), the int32 registers as they are."""
    return [mats[0].float().contiguous(), mats[1].to(torch.int32).contiguous(), mats[2]]


def f32_sketch(torch, state) -> list:
    """A sketch's seven leaves with the 32-bit mode's scalars."""
    t = list(state.tensors())
    return t[:4] + [t[4].to(torch.int32), t[5].float(), t[6].float()]


def _f32_slot(slot):
    from deequ_tpu_torch.kernels.scan_reduce import Slot

    def f(t):
        return t if t is None or not t.dtype.is_floating_point else t.float().contiguous()

    return Slot(slot.kind, slot.where, slot.sel, f(slot.vals), f(slot.vals2), slot.sel2)


def _f64_slot(slot):
    """A float32 slot's twin over float64 copies of its values."""
    from deequ_tpu_torch.kernels.scan_reduce import Slot

    def f(t):
        return t if t is None or not t.dtype.is_floating_point else t.double()

    return Slot(slot.kind, slot.where, slot.sel, f(slot.vals), f(slot.vals2), slot.sel2)


def _check_f32_scan(torch, add, name, slots, rows, launch, plain) -> float:
    """Hold a float32 launch of K1 to its plain version; returns the
    largest absolute difference of the outputs."""
    ki, kf = launch(slots, rows)
    pi, pf = plain(slots, rows)
    torch.cuda.synchronize()
    if ki.dtype != torch.int32 or kf.dtype != torch.float32 or not torch.equal(ki, pi):
        raise AssertionError(f"{name}: counts {ki.dtype} differ from the plain version")
    kf_h, pf_h = kf.cpu().numpy().reshape(-1, 5), pf.cpu().numpy().reshape(-1, 5)
    for col in (1, 2):  # bit for bit, NaN equal to NaN whatever its payload
        if not same_tensor_bits([torch.from_numpy(kf_h[:, col])],
                                [torch.from_numpy(pf_h[:, col])]):
            raise AssertionError(f"{name}: min/max column {col} differs from the plain version")
    width = rows.shape[0] if rows.dim() == 2 else 1
    for s, slot in enumerate(slots):
        if slot.vals is None:
            continue
        v = slot.vals.double().reshape(width, -1)
        for w in range(width):
            u = v[w][torch.isfinite(v[w])]
            scales = [float(u.abs().sum()), float(u.abs().max()) if u.numel() else 0.0,
                      float((u * u).sum())]
            for col, scale in zip((0, 3, 4), scales):
                a, b = kf_h[w * len(slots) + s, col], pf_h[w * len(slots) + s, col]
                if not ((np.isnan(a) and np.isnan(b))
                        or abs(float(a) - float(b)) <= F32_KERNEL_RTOL * max(scale, 1.0)):
                    raise AssertionError(f"{name} slot {s} column {col}: {a!r} vs {b!r}")
    return _max_abs_err(kf, pf)


def check_f32_kernels(torch, dq, data, battery, rows_per_batch: int = BATCH_ROWS,
                      quick: bool = False) -> dict:
    """Phase 19 (a): each float32 entry against its plain version at phase
    2's and phase 6's main-path shapes (one 2^20-row batch of config 2's
    battery; sketches of size 2,048; 32 packed states of every kind; a
    host chunk of 32; 8 shards), counts, min, max, registers and items bit
    for bit, sums and moments within ``F32_KERNEL_RTOL`` of their
    magnitudes; K3's counts in the process's ``COUNT_DTYPE``. Works in
    either mode: the inputs are cast to float32 / int32 here. Beside each
    float32 entry the float64 entry is timed on float64 / int64 copies of
    the same inputs (``f64_ms``). Returns the measurements by launch-count
    name."""
    from deequ_tpu_torch.analyzers.base import pack_states, resolve_slot
    from deequ_tpu_torch.config import COUNT_DTYPE
    from deequ_tpu_torch.kernels import scan_reduce as sr
    from deequ_tpu_torch.kernels import state_fold as sf
    from deequ_tpu_torch.kernels.dict_code_counts import dict_code_counts, dict_code_counts_plain
    from deequ_tpu_torch.kernels.kll_compact import (
        kll_compact_ingest, kll_compact_ingest_plain, kll_compact_merge, kll_compact_merge_plain,
        kll_compact_merge_stacked, kll_compact_merge_stacked_plain, kll_compact_update,
        kll_compact_update_plain)
    from deequ_tpu_torch.kernels.kll_sample import kll_sample, kll_sample_plain
    from deequ_tpu_torch.ops.kll import kll_init
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    results = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
                      "max_abs_err": 0.0, "bound_by": "bytes", "f64_ms": 0.0}
               for name in F32_ENTRIES}
    add = functools.partial(_add, results)

    def wide(t):
        """The float64 / int64 type of a float32 / int32 accumulator."""
        return {torch.float32: torch.float64, torch.int32: torch.int64}[t.dtype]

    def wide_sketch(leaves):
        """A sketch's leaves with float64 / int64 scalars (items, sizes,
        parity and ticks keep their types)."""
        return [*leaves[:4], *(x.to(wide(x)) for x in leaves[4:])]

    def f64_time(name, label, fn):
        t = time_kernel(fn)
        results[name]["f64_ms"] += t["ms"]
        print(f"[launch {F32_ENTRIES[name]} (float64, same inputs) {label}] "
              f"ms={t['ms']:.4f}", flush=True)
    time_kernel = (lambda fn: _time_ms(torch, fn, reps=5, warmup=1)) if quick else (
        lambda fn: _time_kernel_ms(torch, fn))
    time_plain = (lambda fn: _time_ms(torch, fn, reps=3, warmup=1)) if quick else (
        lambda fn: _time_ms(torch, fn))

    def reduce_calls(mats):
        # the float64 rows' library call: torch.amax of the stacked
        # registers and torch.sum of the stacked counts
        return time_plain(lambda: (torch.amax(mats[2], dim=0), torch.sum(mats[1], dim=0)))
    device = torch.device("cuda")
    engine = ScanEngine(battery, device)
    features = to_device(engine.builder.build(next(data.batches(rows_per_batch))), device)
    rows = features["rows"]
    n = rows.shape[0]

    # K1, one launch per bundle, and the stacked entry at phase 8's group
    # shape (16 sessions x 4,096 rows of the first bundle)
    for bundle in engine.program.bundles:
        slots = [_f32_slot(resolve_slot(spec, features)) for spec in bundle]
        err = _check_f32_scan(torch, add, "scan_reduce_f32", slots, rows, sr.scan_reduce,
                              sr.scan_reduce_plain)
        arrays = {(t.data_ptr(), t.dtype): t for slot in slots
                  for t in (rows, slot.where, slot.sel, slot.vals, slot.vals2, slot.sel2)
                  if t is not None}
        nbytes = sum(t.numel() * t.element_size() for t in arrays.values()) + len(slots) * 12 * 4
        add("scan_reduce_f32", f"{len(slots)} slots, float32 values", err,
            time_kernel(lambda: sr.scan_reduce(slots, rows)),
            time_plain(lambda: sr.scan_reduce_plain(slots, rows)), nbytes, 0)
        slots64 = [_f64_slot(s) for s in slots]
        f64_time("scan_reduce_f32", f"{len(slots)} slots",
                 lambda: sr.scan_reduce(slots64, rows))
    width, m = 16, 4096
    stacked_rows = rows[:width * m].reshape(width, m).contiguous()
    stacked = [sr.Slot(s.kind, *(None if t is None else t[:width * m].reshape(width, m)
                                 .contiguous() for t in (s.where, s.sel, s.vals, s.vals2, s.sel2)))
               for s in [_f32_slot(resolve_slot(spec, features))
                         for spec in engine.program.bundles[0]]]
    err = _check_f32_scan(torch, add, "scan_reduce_stacked_f32", stacked, stacked_rows,
                          sr.scan_reduce_stacked, sr.scan_reduce_stacked_plain)
    got_i, got_f = sr.scan_reduce_stacked(stacked, stacked_rows)
    for w in range(width):
        one_i, one_f = sr.scan_reduce([sr.Slot(s.kind, *(None if t is None else t[w] for t in (
            s.where, s.sel, s.vals, s.vals2, s.sel2))) for s in stacked], stacked_rows[w])
        if not (torch.equal(one_i, got_i[w]) and same_tensor_bits([one_f], [got_f[w]])):
            raise AssertionError(f"scan_reduce_stacked_f32 session {w} differs from its "
                                 "one-session launch")
    arrays = {(t.data_ptr(), t.dtype): t for slot in stacked
              for t in (stacked_rows, slot.where, slot.sel, slot.vals) if t is not None}
    add("scan_reduce_stacked_f32", f"{width} x {m} rows, {len(stacked)} slots", err,
        time_kernel(lambda: sr.scan_reduce_stacked(stacked, stacked_rows)),
        time_plain(lambda: sr.scan_reduce_stacked_plain(stacked, stacked_rows)),
        sum(t.numel() * t.element_size() for t in arrays.values()), 0)
    stacked64 = [_f64_slot(s) for s in stacked]
    f64_time("scan_reduce_stacked_f32", f"{width} x {m} rows",
             lambda: sr.scan_reduce_stacked(stacked64, stacked_rows))

    # K3: a dictionary column's counts, in COUNT_DTYPE
    for a in engine.scan_analyzers:
        if type(a).__name__ == "DeviceFrequencyScan":
            codes, present = features[f"codes:{a.column}"], features[f"mask:{a.column}"]
            got = dict_code_counts(codes, rows, present, a.num_categories)
            want = dict_code_counts_plain(codes, rows, present, a.num_categories)
            torch.cuda.synchronize()
            if got[0].dtype != COUNT_DTYPE or not all(torch.equal(g, w)
                                                       for g, w in zip(got, want)):
                raise AssertionError(f"dict_code_counts {a.column}: counts differ or are not "
                                     f"{COUNT_DTYPE}")
            print(f"[launch dict_code_counts {a.column} {COUNT_DTYPE}] bit for bit", flush=True)

    # K4 and K5 on a float32 column: the sample, then an append that
    # compacts; the merge; 8 stacked merges; a chunk of 32 host samples
    k = KLL_SKETCH_SIZE
    values = features["num:a"].float().contiguous()
    present = features["mask:a"]
    state = kll_init(k, device=device)
    leaves = f32_sketch(torch, state)
    got, want = (kll_sample(values, rows, None, present, leaves[3], k),
                 kll_sample_plain(values, rows, None, present, leaves[3], k))
    torch.cuda.synchronize()
    if got.minmax.dtype != torch.float32 or not same_tensor_bits(got, want):
        raise AssertionError("kll_sample_f32 differs from the plain version")
    keep = rows & present & ~torch.isnan(values)
    items = torch.where(keep, values, float("inf"))
    add("kll_sample_f32", f"a, {n} rows", 0.0,
        time_kernel(lambda: kll_sample(values, rows, None, present, leaves[3], k)),
        time_plain(lambda: kll_sample_plain(values, rows, None, present, leaves[3], k)),
        4 * n + 2 * n + 4 * k + 12 + 8, n, time_plain(lambda: torch.sort(items)))
    values64 = values.double()
    f64_time("kll_sample_f32", f"a, {n} rows",
             lambda: kll_sample(values64, rows, None, present, leaves[3], k))
    first = kll_compact_update(leaves, got, k)
    second = kll_sample(values, rows, None, present, first[3], k)
    upd = kll_compact_update(first, second, k)
    upd_plain = kll_compact_update_plain(first, second, k)
    torch.cuda.synchronize()
    if upd[4].dtype != torch.int32 or upd[5].dtype != torch.float32 or not same_tensor_bits(
            upd, upd_plain):
        raise AssertionError("kll_compact_f32's update differs from the plain version")
    merged = kll_compact_merge(upd, first, k)
    if not same_tensor_bits(merged, kll_compact_merge_plain(upd, first, k)):
        raise AssertionError("kll_compact_f32's merge differs from the plain version")
    sizes, (m_items, h, _) = first[1].tolist(), second.meta.tolist()
    level = torch.cat([first[0][h, :sizes[h]], second.samples[:m_items]])
    add("kll_compact_f32", f"a, level {h}: {sizes[h]} + {m_items} items", 0.0,
        time_kernel(lambda: kll_compact_update(first, second, k)),
        time_plain(lambda: kll_compact_update_plain(first, second, k)),
        _compact_bytes(sizes, h, m_items, k, first[0].shape[1]), 0,
        time_plain(lambda: torch.sort(level)))
    first64 = wide_sketch(first)
    second64 = second._replace(minmax=second.minmax.double())
    f64_time("kll_compact_f32", f"level {h}", lambda: kll_compact_update(first64, second64, k))
    pairs = [torch.stack([x] * 8).contiguous() for x in upd]
    others = [torch.stack([x] * 8).contiguous() for x in first]
    got = kll_compact_merge_stacked(pairs, others, k)
    if not same_tensor_bits(got, kll_compact_merge_stacked_plain(pairs, others, k)):
        raise AssertionError("kll_compact_merge_stacked_f32 differs from the plain version")
    add("kll_compact_merge_stacked_f32", f"8 pairs, k = {k}", 0.0,
        time_kernel(lambda: kll_compact_merge_stacked(pairs, others, k)),
        time_plain(lambda: kll_compact_merge_stacked_plain(pairs, others, k)),
        _merge_bytes(pairs[1], others[1], got[1]), 0, time_plain(lambda: torch.sort(level)))
    pairs64, others64 = wide_sketch(pairs), wide_sketch(others)
    f64_time("kll_compact_merge_stacked_f32", "8 pairs",
             lambda: kll_compact_merge_stacked(pairs64, others64, k))
    samples = edge_samples(k, CHUNK, seed=19)
    sketches = [torch.stack([x] * 3).contiguous() for x in first]
    fields = [torch.from_numpy(np.stack([np.stack([s[0] for s in samples])] * 3)).to(device)]
    for j, dtype in ((1, torch.int32), (2, torch.int32), (3, torch.int32), (4, torch.float32),
                     (5, torch.float32)):
        fields.append(torch.tensor([[s[j] for s in samples]] * 3, dtype=dtype, device=device))
    got = [x.clone() for x in sketches]
    want = [x.clone() for x in sketches]
    kll_compact_ingest(got, fields, k)
    kll_compact_ingest_plain(want, fields, k)
    torch.cuda.synchronize()
    if not same_tensor_bits(got, want):
        raise AssertionError("kll_compact_ingest_f32 differs from the plain version")
    scratch = [x.clone() for x in sketches]
    nbytes, _ = _ingest_bytes(first[1].tolist(), samples, k, first[0].shape[1])
    add("kll_compact_ingest_f32", f"3 sketches x {CHUNK} host samples", 0.0,
        time_kernel(lambda: kll_compact_ingest(scratch, fields, k)),
        time_plain(lambda: kll_compact_ingest_plain([x.clone() for x in sketches], fields, k)),
        3 * nbytes, 0, time_plain(lambda: torch.sort(level)))
    sketches64 = wide_sketch(sketches)
    fields64 = [*fields[:3], *(x.to(wide(x)) for x in fields[3:])]
    f64_time("kll_compact_ingest_f32", f"3 sketches x {CHUNK} samples",
             lambda: kll_compact_ingest(sketches64, fields64, k))

    # K8: the fold of 32 states of every kind, the carry of a host chunk,
    # the butterfly over 8 shards and the stacked carry of 8 x 4
    def packed(groups):
        mats, slots, _ = pack_states([states for _, states in groups])
        return [m.to(device) for m in f32_mats(torch, mats)], slots

    def f64(mats):
        return [m.to(wide(m)) for m in mats[:2]] + [mats[2]]

    mats, slots = packed(fold_groups(dq, 32, seed=19))
    got, want = sf.state_fold(*mats, slots), sf.state_fold_plain(*mats, slots)
    torch.cuda.synchronize()
    if got[0].dtype != torch.float32 or not same_tensor_bits(got, want):
        raise AssertionError("state_fold_f32 differs from the plain version")
    add("state_fold_f32", "32 states, every kind", 0.0,
        time_kernel(lambda: sf.state_fold(*mats, slots)),
        time_plain(lambda: sf.state_fold_plain(*mats, slots)), sf.fold_bytes(*mats), 0,
        reduce_calls(mats))
    mats64 = f64(mats)
    f64_time("state_fold_f32", "32 states", lambda: sf.state_fold(*mats64, slots))
    mats, slots = packed(carry_groups(dq, CHUNK + 1, seed=19))
    carry = [m_[0].clone() for m_ in mats]
    plain = [m_[0].clone() for m_ in mats]
    parts = [m_[1:].contiguous() for m_ in mats]
    sf.state_fold_carry(carry, parts, slots)
    sf.state_fold_carry_plain(plain, parts, slots)
    torch.cuda.synchronize()
    if not same_tensor_bits(carry, plain):
        raise AssertionError("state_fold_carry_f32 differs from the plain version")
    scratch = [m_[0].clone() for m_ in mats]
    add("state_fold_carry_f32", f"1 + {CHUNK} rows, every kind a host partial gives", 0.0,
        time_kernel(lambda: sf.state_fold_carry(scratch, parts, slots)),
        time_plain(lambda: sf.state_fold_carry_plain(scratch, parts, slots)),
        sf.fold_bytes(*mats), 0, reduce_calls(parts))
    carry64, parts64 = f64([m_[0].clone() for m_ in mats]), f64(parts)
    f64_time("state_fold_carry_f32", f"1 + {CHUNK} rows",
             lambda: sf.state_fold_carry(carry64, parts64, slots))
    mats, slots = packed(carry_groups(dq, MESH_SHARDS, seed=20))
    got = sf.state_fold_butterfly(*mats, slots, MESH_SHARDS)
    want = sf.state_fold_butterfly_plain(*mats, slots, MESH_SHARDS)
    torch.cuda.synchronize()
    if not same_tensor_bits(got, want):
        raise AssertionError("state_fold_butterfly_f32 differs from the plain version")
    add("state_fold_butterfly_f32", f"{MESH_SHARDS} shards x 1", 0.0,
        time_kernel(lambda: sf.state_fold_butterfly(*mats, slots, MESH_SHARDS)),
        time_plain(lambda: sf.state_fold_butterfly_plain(*mats, slots, MESH_SHARDS)),
        sf.fold_bytes(*mats) + (MESH_SHARDS - 1) * sum(m_.shape[1] * m_.element_size()
                                                        for m_ in mats), 0, reduce_calls(mats))
    mats64 = f64(mats)
    f64_time("state_fold_butterfly_f32", f"{MESH_SHARDS} shards",
             lambda: sf.state_fold_butterfly(*mats64, slots, MESH_SHARDS))
    mats, slots = packed(carry_groups(dq, MESH_SHARDS * 5, seed=21))
    carry = [m_[:MESH_SHARDS].contiguous() for m_ in mats]
    parts = [m_[MESH_SHARDS:].contiguous() for m_ in mats]
    flags = torch.from_numpy(np.random.default_rng(3).random(MESH_SHARDS * 4) < 0.75).to(device)
    got, want = [c.clone() for c in carry], [c.clone() for c in carry]
    sf.state_fold_carry_stacked(got, parts, slots, flags)
    sf.state_fold_carry_stacked_plain(want, parts, slots, flags)
    torch.cuda.synchronize()
    if not same_tensor_bits(got, want):
        raise AssertionError("state_fold_carry_stacked_f32 differs from the plain version")
    scratch = [c.clone() for c in carry]
    add("state_fold_carry_stacked_f32", f"{MESH_SHARDS} shards x 4 partials", 0.0,
        time_kernel(lambda: sf.state_fold_carry_stacked(scratch, parts, slots, flags)),
        time_plain(lambda: sf.state_fold_carry_stacked_plain(scratch, parts, slots, flags)),
        sf.fold_bytes(*mats) + sum(c.numel() * c.element_size() for c in carry), 0,
        reduce_calls(parts))
    carry64, parts64 = f64(carry), f64(parts)
    f64_time("state_fold_carry_stacked_f32", f"{MESH_SHARDS} shards x 4",
             lambda: sf.state_fold_carry_stacked(carry64, parts64, slots, flags))
    return results


def _config2_host_battery(dq) -> list:
    """BASELINE config 2's analyzers (Completeness, Mean, StdDev, Histogram)
    and a KLL sketch, so the host tier's K5 ingest entry runs too."""
    return [dq.Completeness("a"), dq.Completeness("b"), dq.Mean("a"), dq.Mean("b"),
            dq.StandardDeviation("a"), dq.StandardDeviation("b", where="c > 0"),
            dq.Histogram("cat_small"), dq.ApproxQuantile("a", 0.5, KLL_RELATIVE_ERROR)]


def _analysis_values(ctx) -> dict:
    return {repr(a): (m.value.get() if not hasattr(m.value.get(), "values") else
                      (m.value.get().number_of_bins,
                       {k: v.absolute for k, v in m.value.get().values.items()}))
            if m.value.is_success else ("failure", str(m.value.exception))
            for a, m in ctx.metric_map.items()}


def _run_counted(torch, fn):
    """``fn()`` with every launch count set to 0 just before it; returns
    its result and the counts just after."""
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def _state_dtypes(states) -> set:
    from deequ_tpu_torch.analyzers.states import leaves

    return {str(t.dtype) for s in states if s is not None and hasattr(s, "__dataclass_fields__")
            for t in leaves(s)}


def no_x64_child(torch, dq, seed: int, wait=None) -> dict:
    """Phase 19 in its subprocess (``DEEQU_TPU_NO_X64=1``): (a) the float32
    entries against their plain versions; (b) phase 3's verification
    battery over the 10M-row config 2 table on the card, against the
    float64 numpy oracle and against the same mode on ``device="cpu"``
    over a 1M-row cut, and BASELINE config 1 (``examples_torch.
    basic_example``) against its CPU run; (c) config 2 (with a KLL sketch) on the host tier,
    unsharded and over 8 shards, each bit for bit against the same run on
    the CPU; (d) a persisted-state round trip merged on the card; (e) one
    coalesced folds of two sessions through ``VerificationService``. Each
    path's launch counts are set to 0 just before it and read just after.
    With ``wait`` (a callable), the process builds its table, then calls
    it and touches the card only when it returns True (None otherwise).
    Returns the measurements, launches, seconds and phases as JSON."""
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider
    from deequ_tpu_torch.config import ACC_DTYPE, COUNT_DTYPE, x64_enabled
    from deequ_tpu_torch.parallel import make_mesh
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers

    if x64_enabled() or ACC_DTYPE != torch.float32 or COUNT_DTYPE != torch.int32:
        raise AssertionError("phase 19's process did not start in the 32-bit mode")
    out = {"launches": {}, "seconds": {}}
    t0 = time.perf_counter()
    table = build_table(ROWS, seed)
    data = dq.Dataset.from_arrow(table)
    check = build_check(dq, ROWS)
    out["seconds"]["data"] = time.perf_counter() - t0
    if wait is not None and not wait():
        return None

    # (a)
    t0 = time.perf_counter()
    analyzers = list(dict.fromkeys(collect_required_analyzers([check])))
    battery = [a for a in analyzers if isinstance(a, ScanShareableAnalyzer)]
    battery += [DeviceFrequencyScan(c, data.dictionary_size(c)) for c in ("cat_small", "cat_large")]
    out["measured"] = check_f32_kernels(torch, dq, data, battery)
    out["seconds"]["a"] = time.perf_counter() - t0

    # (b)
    t0 = time.perf_counter()
    monitor = dq.RunMonitor()
    t1 = time.perf_counter()
    result, launches = _run_counted(torch, lambda: (
        dq.VerificationSuite.on_data(data, device="cuda").add_check(check)
        .add_required_analyzer(dq.CountDistinct("cat_large")).with_monitor(monitor).run()))
    run_seconds = time.perf_counter() - t1
    out["phases"] = {k: round(v, 4) for k, v in monitor.phase_seconds.items()}
    out["phases"]["seconds"] = round(run_seconds, 3)
    gpu = metric_values(result)
    want = oracle(table)
    problems = []
    for key, w in want.items():
        g = gpu.get(key)
        exact = key[0] not in MOMENT_METRICS + ("Minimum", "Maximum")
        if not isinstance(g, float) or (exact and g != float(w)) or (
                not exact and abs(g - float(w)) > NO_X64_ORACLE_RTOL * max(abs(float(w)), 1e-300)):
            problems.append(f"{key}: {g!r}, oracle {float(w)!r}")
    cut = dq.Dataset.from_arrow(table.slice(0, NO_X64_CUT_ROWS))
    cut_check = build_check(dq, NO_X64_CUT_ROWS)
    runs = [metric_values(dq.VerificationSuite.on_data(cut, device=d).add_check(cut_check)
                          .add_required_analyzer(dq.CountDistinct("cat_large")).run())
            for d in ("cuda", "cpu")]
    problems += compare_metrics(runs[0], runs[1], NO_X64_CPU_RTOL)
    if problems:
        raise AssertionError("phase 19 (b): " + "\n".join(problems))
    out["launches"]["b"] = launches
    out["b"] = {"seconds": time.perf_counter() - t0, "batches": monitor.batches,
                "metrics": len(gpu), "status": result.status.value}
    print(f"[phase 19 (b)] {ROWS} rows in {run_seconds:.3f}s, {len(gpu)} metrics within "
          f"{NO_X64_ORACLE_RTOL} of the "
          f"float64 oracle (counts exact) and the 1M-row cut within {NO_X64_CPU_RTOL} of the "
          f"CPU; phases={out['phases']}; launches={_nonzero(launches)}", flush=True)
    del result
    # BASELINE config 1: the BasicExample's checks through the port's example
    import contextlib as _contextlib
    import io

    from examples_torch import basic_example

    runs, texts = [], []
    for i, d in enumerate(("cuda", "cpu")):
        text = io.StringIO()
        with _contextlib.redirect_stdout(text):
            got, counts = _run_counted(torch, lambda: basic_example.main(device=d))
        runs.append(got)
        texts.append(text.getvalue())
        if i == 0:
            out["launches"]["b config 1"] = counts
    if not (same_values(example_values(runs[0]), example_values(runs[1]))
            and texts[0] == texts[1]):
        raise AssertionError("phase 19 (b): config 1 on the card differs from the CPU's")
    print(f"[phase 19 (b) config 1] the BasicExample's checks {runs[0].status.value}, "
          f"equal to the CPU's; launches={_nonzero(out['launches']['b config 1'])}", flush=True)

    # (c)
    t0 = time.perf_counter()
    host_battery = _config2_host_battery(dq)
    for label, sharding in (("c", None), ("c mesh", "mesh")):
        runs = {}
        for d in ("cuda", "cpu"):
            mesh = None if sharding is None else make_mesh(MESH_SHARDS, device=d)
            ctx, counts = _run_counted(torch, lambda: dq.AnalysisRunner.do_analysis_run(
                cut, host_battery, batch_size=HOST_BATCH_ROWS // 4, device=d, placement="host",
                sharding=mesh))
            runs[d] = _analysis_values(ctx)
            if d == "cuda":
                out["launches"][label] = counts
        problems = compare_metrics(runs["cuda"], runs["cpu"], 0.0)
        if problems:
            raise AssertionError(f"phase 19 ({label}): " + "\n".join(problems))
    out["seconds"]["c"] = time.perf_counter() - t0
    print(f"[phase 19 (c)] config 2 and a KLL sketch on the host tier, unsharded and over "
          f"{MESH_SHARDS} shards, bit for bit the CPU's; launches="
          f"{_nonzero(out['launches']['c'])} / {_nonzero(out['launches']['c mesh'])}", flush=True)

    # (d)
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_no_x64_")
    try:
        dq.AnalysisRunner.do_analysis_run(cut, host_battery, device="cuda", placement="device",
                                          save_states_with=FileSystemStateProvider(store))
        provider = FileSystemStateProvider(store)
        loaded = [provider.load(a) for a in host_battery]
        if _state_dtypes(loaded) - {"torch.float32", "torch.int32"}:
            raise AssertionError(f"phase 19 (d): loaded states hold {_state_dtypes(loaded)}")
        merged = {}
        for d in ("cuda", "cpu"):
            ctx, counts = _run_counted(torch, lambda: dq.AnalysisRunner.run_on_aggregated_states(
                cut.schema, host_battery, [provider, provider], device=d))
            merged[d] = _analysis_values(ctx)
            if d == "cuda":
                out["launches"]["d"] = counts
        problems = compare_metrics(merged["cuda"], merged["cpu"], 0.0)
        if problems:
            raise AssertionError("phase 19 (d): " + "\n".join(problems))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    out["seconds"]["d"] = time.perf_counter() - t0
    print(f"[phase 19 (d)] {len(host_battery)} states saved, loaded as float32 / int32 and "
          f"merged on the card, bit for bit the CPU's merge; launches="
          f"{_nonzero(out['launches']['d'])}", flush=True)

    # (e)
    t0 = time.perf_counter()
    streams = {}
    for d in ("cuda", "cpu"):
        with service_knobs(DEEQU_TPU_COALESCE="1", DEEQU_TPU_FAST_PATH_MAX_ROWS="0"):
            def fold():
                from deequ_tpu_torch.service import VerificationService
                from deequ_tpu_torch.service.placement import shape_qualified_signature

                with VerificationService(workers=2, device=d, background_warm=False) as svc:
                    sessions = [svc.session(f"t{i}", "d", [stream_check(dq)]) for i in range(2)]
                    svc.router.note_ran(shape_qualified_signature(sessions[0]._analyzers, 4096),
                                        0, "device")
                    handles = [s.ingest(stream_table(4096, 100 + 2 * i + b), wait=False)
                               for b in range(2) for i, s in enumerate(sessions)]
                    for h in handles:
                        h.result(300)
                    folds = svc.json_snapshot()["counters"].get(
                        "deequ_service_coalesced_folds_total")
                    return [metric_values(s.current()) for s in sessions], folds

            (metrics, folds), counts = _run_counted(torch, fold)
        if folds != 4:
            raise AssertionError(f"phase 19 (e): {folds} coalesced folds on {d}, expected 4")
        streams[d] = metrics
        if d == "cuda":
            out["launches"]["e"] = counts
    for g, w in zip(streams["cuda"], streams["cpu"]):
        problems = compare_metrics(g, w, NO_X64_CPU_RTOL)
        if problems:
            raise AssertionError("phase 19 (e): " + "\n".join(problems))
    out["seconds"]["e"] = time.perf_counter() - t0
    print(f"[phase 19 (e)] two sessions, two coalesced folds each, the card's metrics the CPU's; "
          f"launches={_nonzero(out['launches']['e'])}", flush=True)

    # every float32 entry launched on one of the paths
    total = {name: sum(c.get(name, 0) for c in out["launches"].values()) for name in F32_ENTRIES}
    missing = [name for name, c in total.items() if c == 0]
    print(f"[phase 19 launches] {total}", flush=True)
    if missing:
        raise AssertionError(f"phase 19: no launch of {missing} on its paths")
    out["f32_launches"] = total
    return out


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def stream_table(rows: int, seed: int) -> pa.Table:
    """A micro-batch of the soak's table (x with nulls, y, k, v)."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "x": pa.array(rng.normal(size=rows), mask=rng.random(rows) < 0.05),
        "y": rng.normal(10.0, 2.0, size=rows),
        "k": rng.integers(0, 1000, size=rows),
        "v": rng.uniform(0, 1, size=rows),
    })


def start_no_x64_child() -> tuple:
    """Start phase 19's process (this script with ``--no-x64-child`` and
    ``DEEQU_TPU_NO_X64=1``) ahead of its phase: it imports the port and
    builds its 10M-row table while earlier phases run, then waits for
    :func:`no_x64_phase` to let it onto the card. Returns the process and
    the path of its results; the process is killed at exit if still
    running."""
    out_path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_19_"), "out.json")
    env = dict(os.environ, DEEQU_TPU_NO_X64="1")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--no-x64-child",
                             out_path, "--wait-for-go"], env=env, stdin=subprocess.PIPE,
                            text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out_path


def no_x64_phase(torch, child: tuple, f64_ms: dict, main_phases: dict, card: str) -> list:
    """Phase 19: let the process :func:`start_no_x64_child` started (its
    table built meanwhile) run :func:`no_x64_child` on the card, wait for
    it, and print each float32 entry's time beside its float64 entry's
    from phase 2 (``f64_ms``, by the float64 entry's name), and (b)'s
    phases beside phase 3's (``main_phases``). Returns the float32
    entries' rows of the ``kernels`` line."""
    proc, out_path = child
    try:
        proc.stdin.write("go\n")
        proc.stdin.close()
    except BrokenPipeError:  # it ended before its phase: its exit code says why
        pass
    try:
        code = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
    if code != 0:
        raise AssertionError(f"phase 19's process failed with exit code {code}")
    with open(out_path) as fh:
        out = json.load(fh)
    shutil.rmtree(os.path.dirname(out_path), ignore_errors=True)
    for name, base in F32_ENTRIES.items():
        m = out["measured"][name]
        print(f"[phase 19 {name}] ms={m['ms']:.4f}, float64 entry on the same inputs "
              f"{m['f64_ms']:.4f}, {base} in phase 2 at its path's shapes "
              f"{f64_ms.get(base, 0.0):.4f}; plain_ms={m['plain_ms']:.4f} "
              f"bound_ms={m['bound_ms']:.6f} launches={out['f32_launches'][name]}; {card}",
              flush=True)
    print(f"[phase 19 (b) phases] {out['phases']}; phase 3's: {main_phases}; {card}",
          flush=True)
    print(f"[phase 19 seconds] {out['seconds']} (b) {out['b']['seconds']:.1f}; its start and "
          f"the table's build ran beside phases 17-18", flush=True)
    rows = []
    for name, base in F32_ENTRIES.items():
        m = out["measured"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"deequ_tpu_torch/kernels/csrc/{KERNEL_SOURCES[base]}.cu",
            "replaces": TPU_KERNELS[base], "launches": out["f32_launches"][name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    return rows



def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-x64-child", metavar="OUT", default=None,
                        help="phase 19's subprocess (started with DEEQU_TPU_NO_X64=1): write "
                             "its results to OUT")
    parser.add_argument("--wait-for-go", action="store_true",
                        help="with --no-x64-child: build the table, then wait for a 'go' "
                             "line on standard input before using the card")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import deequ_tpu_torch as dq

    if args.no_x64_child:
        wait = (lambda: sys.stdin.readline().strip() == "go") if args.wait_for_go else None
        out = no_x64_child(torch, dq, args.seed, wait)
        if out is None:
            return 3
        with open(args.no_x64_child, "w") as fh:
            json.dump(out, fh)
        return 0
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.kernels import build
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    device = torch.device("cuda")
    started = time.perf_counter()
    # a profile left on the machine must not tune any phase: every service
    # of the script boots on an empty profile directory (phase 14 calibrates
    # into a directory of its own)
    profiles = tempfile.mkdtemp(prefix="chip_smoke_profiles_")
    atexit.register(shutil.rmtree, profiles, True)
    os.environ["DEEQU_TPU_TUNING_PROFILE_DIR"] = profiles
    with phase(1):
        kind = torch.cuda.get_device_name(0)
        card = _nvidia_smi()
        print(f"[device] {kind}; nvidia-smi: {card}", flush=True)

        # build every kernel, one nvcc per source in parallel
        t0 = time.perf_counter()
        reports = build.build(force=True)
        print(f"[build] {len(reports)} kernels in {time.perf_counter() - t0:.1f}s", flush=True)
        for name, report in reports.items():
            for line in report.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"[ptxas {name}] {line.strip()}")

    with phase(3):
        # the data and the battery of the main path
        t0 = time.perf_counter()
        table = build_table(ROWS, args.seed)
        data = dq.Dataset.from_arrow(table)
        check = build_check(dq, ROWS)
        print(f"[data] {ROWS} rows in {time.perf_counter() - t0:.1f}s", flush=True)

    with phase(2):
        # each kernel against its plain version at main-path shapes
        analyzers = list(dict.fromkeys(collect_required_analyzers([check])))
        battery = [a for a in analyzers if isinstance(a, ScanShareableAnalyzer)]
        battery += [DeviceFrequencyScan(c, data.dictionary_size(c))
                    for c in ("cat_small", "cat_large")]
        engine = ScanEngine(battery, device)
        first = next(data.batches(BATCH_ROWS))
        features = to_device(engine.builder.build(first), device)
        measured = check_kernels(torch, engine, features)
        check_count_paths(torch, features["rows"])
        check_hll_edges(torch)
        del features
        _print_kernel_totals(measured, VERIFICATION_KERNELS, "verification path")
        carry_measured = check_carry_kernel(torch, dq, data, battery)

    with phase(3):
        # the main path on the card, launch counts set to 0 just before
        gpu_metrics, launches = verification_path(torch, dq, table, data, check)
    # phase 18 (a), (c): the device feature cache and the operator switches
    # on phase 3's table and checks
    with phase(18):
        switches_and_cache(torch, dq, table, data, check, gpu_metrics, args.seed)
    # phase 13: the reliability wrapper, the scan watchdog and the feed
    # pipeline on phase 3's table and checks
    with phase(13):
        reliability_path(torch, dq, table, data)
    # phase 14: the self-tuning plane, on phase 3's table and checks
    with phase(14):
        tuning_plane(torch, dq, table, data, gpu_metrics)
    # phase 11 (a): the same run interrupted and resumed from a checkpoint
    with phase(11), part_seconds("phase 11 (a)"):
        resumable_device_tier(torch, dq, data, check, ROWS, gpu_metrics)

    # phase 7 (a): the same table and checks on the host tier
    with phase(7):
        host_launches, host_metrics, host_statuses = host_tier_verification(
            torch, dq, table, ROWS, gpu_metrics)
    # phase 9: the same table and checks over a mesh
    with phase(9):
        mesh_battery = battery + [dq.ApproxQuantile("a", 0.5, KLL_RELATIVE_ERROR)]
        mesh_measured = check_mesh_kernels(torch, dq, data, mesh_battery)
        mesh_launches, mesh_metrics = mesh_runs(torch, dq, table, host_metrics, host_statuses,
                                                gpu_metrics)
    # phase 11 (c): a mesh checkpoint resumed on a smaller mesh and without one
    with phase(11), part_seconds("phase 11 (c)"):
        resumable_mesh(torch, dq, table)
    with phase(9):
        cross_process(torch, dq, data, mesh_battery)
    # phase 16: the fleet scheduler and the service's mesh route, while
    # phase 3's table is in memory
    with phase(16):
        fleet_plane(torch, dq, table, data, check, gpu_metrics, mesh_metrics)
    del table, data

    with phase(4):
        t0 = time.perf_counter()
        lineitem = build_lineitem(LINEITEM_ROWS, LINEITEM_SEED + args.seed)
        print(f"[lineitem] {LINEITEM_ROWS} rows x {lineitem.num_columns} columns in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        profile_measured, profile_launches, ingest_measured, ingest_sketches = profile_path(
            torch, dq, lineitem)
    with phase(5):
        freq_measured, freq_launches = grouping_path(torch, dq, lineitem)
    # phase 7 (c): the profile on the host tier
    with phase(7):
        ingest_launches = host_tier_profile(torch, dq, lineitem, ingest_sketches)
    del lineitem
    with phase(6):
        fold_measured, fold_launches = incremental_path(torch, dq, args.seed)
    # phase 8: the streaming service
    with phase(8):
        stacked_measured, stream_launches = streaming_service(torch, dq, args.seed)
    # phase 10: constraint suggestion, BASELINE config 5
    with phase(10):
        suggestion_path(torch, dq)
    # phase 12: the tenant plane
    with phase(12):
        tenant_plane(torch, dq)
    # phase 15: the cluster plane, in-process and across worker processes
    with phase(15):
        cluster_plane(torch, dq)
    # phase 17: the whole-service chaos soak and the tuning report's bench
    # point ((c)'s report ran in phase 14, (d) in phase 5)
    # phase 19's process starts here: its imports and table build overlap
    # phases 17 and 18 (b); it waits to touch the card until phase 19
    child19 = start_no_x64_child()
    with phase(17):
        chaos_plane(torch)
    # phase 18 (b): the examples suite on the card against the CPU
    with phase(18), part_seconds("phase 18 (b)"):
        examples_on_card(torch, card)
    # phase 19: the 32-bit accumulator mode, in a process of its own
    with phase(19):
        # each float64 entry's phase 2 time at its path's shapes
        sources = {"scan_reduce": measured, "scan_reduce_stacked": stacked_measured,
                   "kll_sample": profile_measured, "kll_compact": profile_measured,
                   "kll_compact_ingest": ingest_measured, "state_fold": fold_measured,
                   "state_fold_carry": carry_measured}
        f64_ms = {base: sources.get(base, mesh_measured)[base]["ms"]
                  for base in F32_ENTRIES.values()}
        f32_rows = no_x64_phase(torch, child19, f64_ms, MAIN_PHASES, card)
    print_phase_seconds(time.perf_counter() - started)

    # K1-K3 as the verification path runs them, K4 and K5 as the profile
    # path does (the verification path runs no sketch); each with the
    # launches of its path's run
    def row(name, m, counts):
        return {
            "name": name,
            "route": "cuda",
            "source": f"deequ_tpu_torch/kernels/csrc/{KERNEL_SOURCES[name]}.cu",
            "replaces": TPU_KERNELS[name],
            "launches": counts[name],
            "max_abs_err": m[name]["max_abs_err"],
            "ms": m[name]["ms"],
            "plain_ms": m[name]["plain_ms"],
            "bound_ms": m[name]["bound_ms"],
            "bound_by": m[name]["bound_by"],
            "library_ms": m[name]["library_ms"],
        }

    kernels = [row(name, measured, launches) for name in VERIFICATION_KERNELS]
    kernels += [row(name, profile_measured, profile_launches)
                for name in PROFILE_KERNELS if name not in VERIFICATION_KERNELS]
    # K6 with the launches of the resident grouping run, K7 with those of
    # the non-resident one
    kernels.append(row("freq_keys", freq_measured, freq_launches["resident"]))
    kernels.append(row("freq_compact", freq_measured, freq_launches["compaction"]))
    # K8 with the launches of the merged refresh (b); its carry entry with
    # those of host tier (a), K5's ingest entry with those of host tier (c)
    kernels.append(row("state_fold", fold_measured, fold_launches))
    kernels.append(row("state_fold_carry", carry_measured, host_launches))
    kernels.append(row("kll_compact_ingest", ingest_measured, ingest_launches))
    # the stacked entries at (b)'s group shape, with (b)'s launches
    kernels += [row(name, stacked_measured, stream_launches) for name in STACKED_KERNELS]
    # the mesh's entries at phase 9 (b)'s shapes, with (b)'s launches
    kernels += [row(name, mesh_measured, mesh_launches) for name in MESH_KERNELS]
    # the float32 entries (phase 19), each with the launches of its paths
    kernels += f32_rows
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
