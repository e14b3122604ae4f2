#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dask_sql_tpu_torch``) on one card.

    python3 chip_smoke.py [--sf 1.0] [--seed 0]

Phases, in order; any failure exits non-zero before the last line:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compile every hand-written kernel from ``dask_sql_tpu_torch/csrc``
   with nvcc (sm_90a), one nvcc per source, all started together, and,
   beside them, the native parser and optimizer from
   ``dask_sql_tpu_torch/native`` with g++; report the build times and
   ptxas's register report;
3. data: the eight TPC-H tables at ``--sf`` (SF 1: 6.0 M lineitem rows),
   generated here from ``--seed`` in numpy alone with the columns,
   distributions and random stream of ``benchmarks/tpch.py``, registered
   on ``Context(device="cuda")``; ``create_table`` collects each table's
   statistics on the card (``runtime/statistics.py``), and the seconds
   include them;
4. kernel 1 (segsum_fixedpoint) against its plain PyTorch version on the
   card -- on the reduction Q1 hands it (captured from Q1's cold run), on
   edge cases and on its warp schedules (one group in every row, both signs
   in every warp, n off every chunk and range boundary, 256 groups with
   block-shared accumulators) -- required bit-identical; then, on Q1's
   inputs, its time (the kernel's own device time from torch.profiler,
   beside the CUDA-event mean over back-to-back calls, which also counts the
   host's gaps between them) beside the plain version's, one library
   call's, and the bound the data sheet allows (3.35 TB/s HBM3, 34 TFLOP/s
   FP64);
5. kernel 2 (segsum_accumulate): its path -- Q1's reduction cast to float32
   through the float32 branch of ``segmented_sums_dispatch`` -- driven once
   with the launch counts at 0; then, on that input and on edge cases
   (ragged n, 256 groups, NaN/+-Inf in their own groups, a masked NaN, all
   rows masked, empty input, float64 input, one group in every row, 40
   groups, n >= 8 M), kernel and plain version each
   held to the float64 sum of the same values within
   (1024 + ceil(n/1024)) * eps * sum|v| per (row, group), non-finite
   results and empty groups exact, and the kernel run twice for identical
   bits; then its time (profiler and event mean, as for kernel 1) beside
   the plain version's, one float32
   ``index_add_`` and the bound (3.35 TB/s, 67 TFLOP/s FP32);
6. stats: the tables copied to a Context on the CPU, whose statistics
   (collected there) must equal the card's field for field;
Phases 4-8 and 10-11 measure the eager executor (``DSQL_COMPILE=0``), as
they did before the compiled tier; phases 9 and 12 run the default path,
the compiled tier first.

7. slice, the eager path, with the statistics-driven dispatch on (the
   default): TPC-H Q1-Q22 through the Context, one cold and three warm
   runs each, the launch counts set to 0 before each query and read after
   it (kernel 1 must launch); the host synchronisations of one more warm
   run counted with ``torch.cuda.set_sync_debug_mode``; the GROUP BY and
   join variants the run took, from the telemetry counters of its
   ``QueryReport``; Q1 and Q6 checked against a numpy oracle (counts
   exact, doubles rtol 1e-12, per-group sums by ``math.fsum``), every
   query against the same query run by the port on the CPU over the same
   tables (ints and strings exact, doubles rtol 1e-9); then one warm run
   of Q1, Q4, Q5, Q6 and Q9 under ``torch.profiler`` (device time by
   kernel, device idle share);
8. adaptive: the 22 queries with the dispatch on and with
   ``DSQL_ADAPTIVE=0`` (the statistics-free dispatch and join order), the
   two modes in turns so that both meet the same host state: per mode one
   cold and three warm runs (wall and planning time), launch counts,
   syncs and variants, each answer with the dispatch off equal to phase
   7's (ints and strings exact, doubles rtol 1e-9: a changed join order
   may add floats in another order); Q5, Q9 and Q10 under
   ``torch.profiler`` in both modes; each query's host time in both modes
   split into planning, execution, the dispatch decisions inside it and
   (Q9, Q10) each plan node (``host breakdown:``); then Q1 and Q3 under
   ``DSQL_FORCE_GROUPBY`` set to ``hash``, ``sorted`` and ``dense``,
   answers equal to phase 7's, Q1
   still on the static-domain route with one kernel-1 launch (the
   variable pins only the other GROUP BYs' codes), Q3 on the forced codes;
9. oracle: the 22 queries at SF 0.01 through a Context on the card (the
   compiled tier, after phase 12) against the standard library's ``sqlite3`` (the rules of
   ``tests/integration/test_tpch.py``: row count exact, doubles rtol 1e-6,
   everything else as strings, unordered results sorted), then phase 10's
   W1-W3 and the part of F1 that sqlite has (no math, date or padding
   functions);
10. surface, the SQL beyond TPC-H's operators: every key of the port's
   ``OPERATION_MAPPING`` through ``Context.sql`` on the card over 100,000
   rows against the CPU run (RAND, RANDOM and RAND_INTEGER by range and
   seed only: the card draws another stream; SEARCH from its RexCall);
   then, at ``--sf``, window queries
   over lineitem (W1: ROW_NUMBER, RANK, DENSE_RANK, NTILE; W2: ROWS-frame
   SUM, bounded MIN/MAX, AVG, LAG, LEAD; W3: a RANGE-offset SUM,
   FIRST_VALUE / LAST_VALUE of a string, CUME_DIST, a whole-partition
   COUNT) and F1, a static GROUP BY over the math, date, conditional and
   string functions (through joins to orders, customer and part), each a
   cold and three warm runs with launch counts, syncs and the answer held
   to the port's CPU run over the same tables (ints and strings exact,
   doubles rtol 1e-9, window sums within 1e-9 of their absolute prefix as
   well; F1 must launch kernel 1 once per run); then S1, LIKE over
   2,000,000 rows of 1,000,000 distinct comments: four patterns by the
   default route (the device bitmap, or regex for a ``_`` pattern, counted
   in ``strings_fast.stats``), each count equal to numpy over the regex
   bitmap and the device bitmap equal to it bit for bit, NOT LIKE's warm
   wall under each strategy forced, the bytes matrix's size; W2 and S1
   profiled once (device busy and idle).  One ``surface table:`` JSON line
   per query;
11. front end: Q1-Q22 at ``--sf`` planned five times each, in turns, by
   the native front end (``Context``'s path: the C++ parser and optimizer,
   then the statistics join order; every plan counts ``planner_native``)
   and by the port's Python parser and ``PASSES`` pipeline called directly
   (with the same post-pass); the EXPLAIN texts equal, the plan-ms medians
   of both, of the native path's C++ calls (parse and optimize, ctypes and
   JSON decoding included) and of the statistics post-pass; then each
   query's warm wall through ``Context.sql`` with either front end
   (``DSQL_NATIVE=0`` for the Python one), five runs each in turns, and
   the garbage collector's generation-2 passes in each; one
   ``frontend table:`` JSON line per query; then the statement layer on
   the card: CREATE SCHEMA, CREATE TABLE AS Q1 (kernel 1 launches once,
   the launch counts set to 0 before it and read after it; the table
   equal to the numpy oracle and to phase 7's answer), a view over
   lineitem queried twice (equal to the inline query), SHOW TABLES,
   PREPARE Q6 with ``?`` markers and EXECUTE with two parameter sets (each
   equal to the inline-literal query), EXPLAIN ANALYZE of Q1 and Q9 (the
   root's ``rows=`` equal to the result's rows), fractional RANGE offsets
   and LAG / LEAD defaults over lineitem against the port's CPU run, and
   the DROPs; one ``statements:`` JSON line;
12. compiled, the main path (run after phase 8): the 22 queries at
   ``--sf`` through the compiled tier, each plan one program captured as a
   CUDA graph and replayed: per query the tier and any fallback's reason,
   the cold wall (warm-up and capture), three warm walls (replays), the
   host syncs of one more warm run and the source line of each, the
   graph's memory pool, and kernel 1's launches per replay (the launch
   counts set to 0 before each run and read after it); every answer equal
   to phase 7's eager answer (doubles rtol 1e-9), Q1's bit for bit; a
   query that does not compile, or a static GROUP BY (Q1, Q4, Q5, Q12,
   Q22) that compiles without one kernel-1 launch per replay, fails it;
   then Q1 and Q9 profiled (device busy, idle share against the
   unprofiled warm wall).  One ``compiled table:`` JSON line per query.
   The ``kernels`` line's launches for kernel 1 are this phase's.  The
   pass runs with ``DSQL_PROGRAM_STORE`` and ``DSQL_CAPS_FILE`` on an
   empty ``build/phase22`` (22(a)): it finds nothing there, and stores a
   build record after every build.
13. the rest of the compiled tier (after phase 12): parameters, stage
   graphs, tiering and the ladder (``params table:``, ``stages table:``);
   13(c) also runs a cold query whose background build's capture is held
   open while another thread calls ``torch.cuda.synchronize()`` once: the
   build must land (a capture invalidated so is retried once on the
   build's thread, ``background_capture_retries``; ``tiering device
   sync:``).
14. serving, the default layers in front of the tiers (after phase 13, at
   ``--sf``): phases 1-13 run with ``DSQL_RESULT_CACHE_MB=0`` and
   ``DSQL_MAX_CONCURRENT_QUERIES=0`` so that they measure the engine, and
   phase 14 lifts both pins.  (a) The result cache at its defaults (the
   manager off): Q1-Q22 twice, the second run a hit that launches no
   kernel, replays no graph and equals the first bit for bit; nation
   registered again with other names, after which Q5 and Q7 miss and
   answer the new rows; parameterized Q1 at DELTA 60, 120 and 60 again,
   the last a hit equal bit for bit to the first although the second
   replayed the same graph over its pool; a device budget just above one
   result, so that entries spill to the host tier and come back on a
   hit; Q8 and Q21 again with a literal of their root stage changed,
   whose first stage hits the subplan cache.  (b) The workload manager at
   its defaults (4 slots, a queue 32 deep, a 4096 MB ledger; the cache
   off): 16 client threads, Q1, Q3, Q6, Q9, Q10, Q12, Q14 and Q18 once
   as ``interactive`` and once as ``batch``, answers equal to phase 7's
   (doubles rtol 1e-9); per class the queue ms p50 / p95 and the admitted
   count (all, none rejected); per query the byte estimate against the
   ledger; with ``DSQL_QUEUE_DEPTH=2`` and every slot held the third
   waiter is refused.  (c) The Presto-wire server on the card
   (``run_server(..., port=0, blocking=False)``, urllib clients): 8
   concurrent clients send (b)'s 16 queries, answers equal; each query
   once with the cache off, POST to FINISHED beside phase 12's warm wall
   (Q1 must launch kernel 1); a result of over 100,000 rows paged and
   reassembled equal to the direct answer; 429 with ``Retry-After`` on a
   full queue; ``/metrics`` and ``/v1/engine`` (the devices section names
   the card); DELETE of a query waiting for a slot; last, a drain: a new
   POST answers 503 while the query in flight finishes.  One ``serving
   table:`` JSON line per part and query; the launch counts set to 0
   before the phase and read after it (kernel 1 must launch).
15. out-of-core (last, on the default path: the compiled tier first):
   (a) lineitem at ``--sf`` registered chunked from its numpy columns
   (``ChunkedSource.from_columns``, no pandas) in batches of 1,048,576
   rows (6 at SF 1, the last one short), the other tables resident:
   Q1-Q22 once cold and once warm, each answer equal to phase 7's
   (doubles rtol 1e-9); per query the walls, the streamed batches, each
   streamed program's captures and replays (at most two captures: the
   full batch and the padded last one; the other batches replay), the
   bytes uploaded per batch and the effective upload rate (bytes over
   the warm wall); Q1 must launch kernel 1 at least once per batch; the
   port's upload path over Q1's columns beside one pinned ``copy_`` of a
   batch (the bound, CUDA events); Q1 and Q6 profiled (device idle
   share) and run once more with ``DSQL_COMPILE=0`` (the eager scan
   compacts the padded batch).  (b) orders and lineitem both chunked,
   ``DSQL_SPILL_MB=64``, ``DSQL_SPILL_DEVICE_MB=8`` and the spill
   directory under ``build/``: Q3 and a Q3-shaped orders-lineitem GROUP
   BY through the grace-hash join, equal to the resident answers;
   ``morsel_joins``, ``morsel_pairs`` and ``spill_partitions`` must
   advance, the store's peak device bytes stay within its cap, no run is
   left after a query, and with ``DSQL_SPILL_MB=0`` the join raises
   ``StreamingUnsupported``.  (c) phase 10's W1 over the chunked lineitem
   (buckets of l_suppkey) equal to the resident answer row for row.  (d)
   lineitem at SF 5 (about 30 M rows, 8 batches of the default
   4,194,304) chunked, Q1 and Q6 cold and warm against the numpy oracles
   of the same data.  One ``ooc table:`` JSON line per query of (a) and an
   ``ooc summary:`` line; the ``kernels`` line carries Q1's kernel-1
   launches of (a) as ``launches_out_of_core_q1``.

16. the write path (last, on the default path, the result cache and the
   workload manager on): (a) TPC-H's RF1 (spec 2.5: SF x 1,500 new orders
   and their about SF x 6,000 lineitems on new keys, from the seed) ten
   times, half as INSERT INTO ... SELECT from staged tables and half as
   ``append_rows`` of numpy dicts: each append's wall and the bytes the
   whole-table concat and the statistics move, Q1's cold (a new capture:
   new tables) and warm wall after it.  (b) Four materialized views made
   before the appends: Q1 (``agg``), a selection (``append``), orders
   JOIN lineitem without an aggregate (``join``, the delta join) and
   COUNT(DISTINCT l_suppkey) GROUP BY l_returnflag (``cdistinct``); after
   each RF1 every view is read: it must refresh incrementally
   (``mv_refresh_incremental`` +1, ``mv_refresh_full`` +0) and equal the
   same query run directly (counts exact, doubles rtol 1e-9), and the Q1
   view's refresh must launch kernel 1; at the end a tombstone and
   REFRESH MATERIALIZED VIEW recompute each in full, equal to its
   incremental result.  (c) ANALYZE TABLE lineitem on the card equal to
   the port's CPU run (numeric cells rtol 1e-12).  (d) The ingest log
   under ``build/`` with fsync on: RF1 lineitem batches through
   ``append_rows``, through ``POST /v1/ingest`` of an in-process server
   and coalesced two to a WAL line (batches/s, rows/s); a new Context
   replays the log equal to the live table; a reader thread's Q6 answers
   under the writer, on the default path (some from the compiled tier),
   each equal Q6 over a committed prefix.  (e) CTAS over a chunked
   lineitem equals the SELECT (F14), and ANALYZE TABLE over it equals
   ANALYZE of the same columns resident, with the device's peak below the
   table's bytes and within the resident ANALYZE's peak plus one column
   and one batch.  One ``write table:`` JSON
   line per RF1 and a ``write summary:`` line; the ``kernels`` line
   carries the phase's kernel-1 launches as ``launches_write_path``.

17. multi-device execution (last, on the default path): the resident
   tables at ``--sf`` on ``Context(mesh=Mesh([cuda:0] * 4))`` (four row
   shards on the card, ``parallel/``).  (a) Q1-Q22 cold and 3 warm with
   the SPMD stage executor on: per query the tier (``spmd``, or the
   compiled tier where it declines), the ``spmd_*`` counters and
   collective bytes, kernel-1 launches, syncs, cold and warm walls; each
   answer equal to phase 7's (doubles rtol 1e-9), the last two warm runs
   bit for bit.  Then a CAST to VARCHAR and a string CASE over lineitem
   (order keys up to 4,000, ``LIMIT 1000``), cold and warm: each stage
   reads device values on the host, so the walker falls back on
   ``host_read`` alone (``spmd_fallbacks`` 1, as in JAX) and the answer
   equals the ``DSQL_MESH=0`` one.  (b) The 22 queries with
   ``DSQL_MESH=0``: the compiled tier over the padded mesh tables, each
   with phase 12's tier (no new fallback), kernel 1 launching for Q1, Q4,
   Q5, Q12 and Q22, answers equal.  (c) Q1 and Q6 streamed over lineitem
   chunked on the mesh (batches of 1,048,576 rows, each sharded), equal.
   (d) One RF1 appended to the mesh lineitem, then Q1, equal to a plain
   context's after the same append.  (e) Q1, Q3, Q6, Q12 and Q14 on
   ``default_mesh()`` (one shard per card) when the machine has two cards
   or more, cold and twice warm: every stage one CUDA graph over all the
   cards, no eager stage, a graph replayed in every warm run, the answers
   phase 7's, Q3 falling back on ``radix_overflow`` only; per query the
   walls and per run the graph replays, eager stages and stage programs
   built.  On one card, one line saying the branch is skipped.  One ``mesh table:`` JSON line per
   query and part, and a ``mesh summary:`` line; the ``kernels`` line
   carries the phase's kernel-1 launches as ``launches_mesh``.

18. the mesh across processes (last; ``parallel/group.py``): (a) a
   process group of one rank in this process over NCCL
   (``init_multihost("127.0.0.1:<port>", 1, 0, local_shards=4)``, the
   same four shards as phase 17, every collective through the group):
   Q1-Q22 cold and three times warm on the resident tables, each run
   held to phase 17's checks (Q1, Q6, Q8, Q12 and Q14 served, Q3 served
   or falling back on ``radix_overflow`` only, no walker error, no stage
   outside a CUDA graph: each stage is captured with its NCCL calls
   inside), a served run must count ``mesh_process_collectives`` and
   ``mesh_process_bytes``, and each warm run must replay one graph per
   stage program and count the cold run's collectives and bytes; Q4, Q5
   and Q22 must launch kernel 1 on the compiled tier, every answer equal
   to phase 7's and every served one bit for bit 17(a)'s; one
   ``multiprocess walls:`` line per served query sets its cold and warm
   walls beside 17(a)'s and beside those of eager stages
   (``MP_EAGER_MS``); the mean wall of a store rendezvous; a world of
   one rank holds whole tables, so no run gathers (``mesh_gathers`` 0);
   the group is destroyed after.  (b) Where the machine has two cards or
   more, one rank per card (up to four), each a process of this script
   (``--rank``) that generates the tables from ``--seed`` at ``--sf``
   and holds one shard: its catalog holds only its rows of each table
   (the bytes allocated on its card by the registration within the
   tables' bytes over the world plus the padding and one padded column;
   the registration's peak printed), and it runs the same checks, a
   declined query over the columns it scans gathered from every rank
   (``mesh_gathers`` and ``mesh_gather_bytes`` of its cold run; no warm
   run gathers); every rank's answers equal phase 7's, rank 0's bit for
   bit, and with four ranks 18(a)'s served answers bit for bit; one RF1
   appended to orders and lineitem on every rank, then Q1, equal to a
   plain context's after the same append and rank 0's bit for bit.
   Rank 0's walls go on one ``multiprocess walls:`` line per query, and
   each rank's catalog and RF1 on ``18(b) rank`` lines, each with its
   card's name and power limit.  Then the last rank leaves, and every
   other rank's next query (Q6, its stage replayed) must end in
   ``RankError`` within a group timeout of 20 s plus 30, and every rank
   process must exit.  On one card one line says 18(b) is skipped (``--only
   multiprocess`` runs phase 18 alone with its set-up, for a machine of
   four cards).  One warm run each of Q1 and Q12 in 18(a) under
   ``torch.profiler`` (device busy and idle share).
   One ``multiprocess table:`` JSON line per query and part, a
   ``multiprocess summary:`` line per part; the ``kernels`` line carries
   18(a)'s kernel-1 launches as ``launches_multiprocess``.

19. profiling, query history and the event bus (after phase 13, on phase
   12's tables; ``runtime/{profiler,flight_recorder,events}.py``):
   ``DSQL_PROFILE``, ``DSQL_HISTORY_FILE`` and ``DSQL_EVENTS`` armed with
   their files under ``build/phase19``, the workload manager on and the
   result cache off.  (a) Every program dropped, then per query an armed
   cold run (the build counts its cost) and two warm runs armed and two
   unarmed, in turns: each answer equal to phase 12's bit for bit; every
   program built has a counted cost with bytes above 0; the history holds
   an envelope for each query, with measured bytes above 0 where the
   result has rows; Q1's program holds kernel 1's record (one launch, at
   least Q1's values' bytes) and each replay launches it once.  (b) One
   ``profile table:`` JSON line per query (warm walls armed and unarmed,
   the counted bytes of the programs that served and the measured bytes,
   ``est_source``, ``cost_err``), a ``profile split:`` line for Q1, Q2
   and Q8 (warm walls with no variable and with each alone) and a
   ``profile summary:`` line.  (c) EXPLAIN PROFILE of Q1 and Q9: every
   device row ``platform=gpu`` with bytes in use above 0 and the card's
   total memory as its limit.  (d) ``Context.profile(Q1)`` writes a chrome
   trace that names ``segsum_fixedpoint_kernel`` (a trace without device
   events raises; three tries, as phase 4's timing).  (e) The server
   echoes ``X-DSQL-Trace`` and ``/v1/events`` returns that trace's
   events.  (f) The sampler at ``DSQL_PROFILE_SAMPLE_MS=10`` beside one
   tiering background build (Q3): the build lands with no error and no
   capture retry, the next arrival replays it, equal bit for bit; then
   ``Context.profile(Q6)`` called while the same build runs waits for it
   (torch.profiler's start and stop invalidate another thread's capture),
   and the build lands with no retry.  (g), inside phase
   17 after 17(a): the mesh's Q1 armed, every SPMD stage's
   ``shard_rows`` equal to a host count of each shard's valid rows.  The
   ``kernels`` line carries 19(a)'s Q1 launches as
   ``launches_profiled_q1``.

20. the system schema, the autopilot and the fleet plane (after 18;
   ``runtime/{system_tables,autopilot,fleet}.py``), on a new Context over
   phase 3's encoded tables on the default path, its files under
   ``build/phase20``.  (a) Every one of the 18 ``system.*`` tables binds
   and runs on the card; ``system.devices``' row of the card equals the
   caching allocator's reading (bytes in use, peak) and its total memory;
   ``system.table_stats`` of lineitem equals a CPU context's over the same
   table; ``system.mesh`` lists the card, and a four-shard mesh's
   placement.  (b) The autopilot (``DSQL_AUTOPILOT=1``, explicit ticks,
   two hits, the history armed, the result cache on): Q1 with its
   whitespace collapsed (470 characters; the history cuts a text at 500
   and the autopilot skips a cut one, so Q1 as written never
   materializes) three times, then a tick makes ``auto_mv_<fp[:12]>``;
   after one RF1 (phase 16's generator) the next Q1 is served from the
   view after an incremental refresh, kernel 1 launching twice (the
   delta's partial and the merge), equal to a direct Q1 with
   ``DSQL_AUTOPILOT=0`` (ints, strings and counts exact, doubles within
   1e-12: the view's partial sums are doubles, so a merged sum is rounded
   twice; the cells that differ in their last bits are counted); after a
   second RF1 a tick refreshes the view (two launches) and Q1 is served
   as it stands; then the daemon at 50 ms beside a tiering build of Q16
   while RF1s land: the build lands with no error (its capture retries
   reported), the daemon refreshes the view, and the served Q1 equals a
   direct one.  (c) Q14 on a four-shard mesh of the card with
   ``DSQL_PROFILE`` and ``DSQL_AUTOPILOT_SKEW=1.0``: the first run records
   a hint that flips its SPMD join, the next takes the other join with
   stage programs captured anew (the hint is in the stage key), answers
   equal (doubles rtol 1e-9), a third replays them, and both verdicts are
   journaled.
   (e) Q1-Q22 three times each with ``DSQL_PROFILE`` and the autopilot
   armed: the hints recorded, applied and reverted (``autopilot
   hints:``).  (d), last: the fleet armed, a server on the card and a
   child replica (this script with ``--replica``) on the same card at SF
   0.01: both heartbeats alive, ``/v1/fleet`` and ``system.replicas`` show
   two replicas, ``system.events`` and ``system.queries`` merge both; the
   child killed with SIGKILL ages out after the TTL.  ``system table:``,
   ``autopilot table:``, ``replan table:``, ``autopilot hints:``, ``fleet
   table:`` and ``system summary:`` lines; the ``kernels`` line carries
   (b)'s served Q1's kernel-1 launches as ``launches_autopilot``.

21. the host boundary (last; ``io/inputs.py``, ``models/``, row UDFs and
   custom aggregations), on a new Context over phase 3's encoded lineitem
   and a CPU Context over a copy of its columns, files under
   ``build/phase21``.  (a) ``host libraries:``, whether pandas, pyarrow,
   sklearn, joblib and IPython import here (asked in a child process).
   (b) ``create_table`` from a ``Table``, a dict of numpy arrays and a
   list of two dicts (lineitem's numeric columns, the rows in two
   halves), each on the card and answering the same sums as lineitem
   (doubles rtol 1e-12, the rest exact); then a csv path, CREATE TABLE
   ... WITH (location), a row UDF query and a UDAF query: where pandas is
   absent each raises ImportError naming pandas, where it is present each
   runs on the card and equals the CPU's answer.  (c) ``_Lstsq`` (exact
   least squares in float64, defined here): CREATE MODEL on lineitem's
   ``l_quantity, l_discount, l_tax`` against ``l_extendedprice`` (the
   card's and the CPU's coefficients equal), SHOW MODELS and DESCRIBE
   MODEL, then a GROUP BY over PREDICT: kernel 1 launches at least once
   (the counts set to 0 just before it and read just after), the answer
   equals the CPU's (strings and counts exact, doubles rtol 1e-9), and a
   warm repeat equals it exactly;
   PREDICT's column equals ``predict`` of the host matrix bit for bit;
   ``wrap_fit`` over the same columns as a chunked table streams
   ``HB_BATCHES`` (6) ``partial_fit`` calls, its coefficients within
   1e-9 of the gathered fit's; EXPORT MODEL to pickle predicts the same
   bits; DROP MODEL.  A ``host boundary table:`` line has the walls (the
   training query, the gather, the fit; for the cold and the warm GROUP
   BY over PREDICT, PREDICT's input, gather, predict-and-upload and the
   rest, the GROUP BY); the ``kernels`` line
   carries (c)'s launches as ``launches_predict``.

22. the program store (last; ``runtime/program_store.py``, build records).
   (a) After phase 12: its records' count and bytes (``store:``), its
   answers and walls handed over in ``build/phase22/answers.pkl``.  (d)
   Q1 and Q12 on phase 17's four-shard mesh with the store armed store
   their stage records; then on 18(a)'s mesh across processes (a group of
   one rank holding four shards of the card), twice, each pass after
   ``spmd.clear_programs()``: the second makes every stage program from
   the first's records (``spmd_store_hits`` as many as its builds, no
   ``spmd_compiles``, no eager stage, the collectives of the first),
   answers bit for bit the first's and the one-process mesh's (``store
   mesh: process`` lines).  (b) A fresh process (this script with
   ``--store-child store``) generates the same tables from the same seed
   and runs Q1-Q22 compiled over the store: per query a ``store table:``
   line (cold wall, warm-up and capture ms, builds, recompiles,
   ``program_store_hits``, ``graph_captures``, kernel-1 launches per
   replay, the answer bit for bit phase 12's); every query phase 12 built
   takes 0 builds and 0 recompiles, kernel 1 replays once per run of Q1,
   Q4, Q5, Q12, Q22, Q2 falls back on its runtime flag (F8) as in phase
   12; then (d) Q1 and Q12 on a four-shard mesh of its tables from the
   stage records (``spmd_store_hits``, no ``spmd_compiles``, answers
   equal), and (e) a corrupt entry (Q6), a fingerprint mismatch (Q14),
   altered constants (the first of Q13, Q9, Q20, Q3, Q10 whose record
   holds any) and a record without constants over dropped kernel-1
   layouts (Q1) each fall back to a build, counted, the answer equal.
   (c) Where the script has used under ``STORE_CAPS_BEFORE_S`` (780 s), a
   fresh process over ``DSQL_CAPS_FILE`` alone.  A ``store summary:``
   line sums phase 12's, (b)'s and (c)'s cold walls, warm-ups, captures,
   builds and recompiles; the ``kernels`` line carries (b)'s kernel-1
   launches as ``launches_program_store``.

The last two lines are a JSON object ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints neither.
"""
from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP64_OPS_PER_S = 34e12         # H100 SXM data sheet, FP64 outside tensor cores
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, FP32 outside tensor cores
ORACLE_SF = 0.01               # the sqlite oracle's scale: a few seconds in sqlite

# Q1's static-domain reduction: the occupancy row, then (value, count) rows
# for 4 SUMs and 3 AVGs over doubles, then COUNT(*)'s two count rows
Q1_CLASSES = ["unit"] + ["float", "unit"] * 7 + ["unit", "unit"]


def _days(s: str) -> int:
    return int((np.datetime64(s, "D") - np.datetime64("1970-01-01", "D"))
               .astype(np.int64))


# ---------------------------------------------------------------------------
# data: the eight TPC-H tables of benchmarks/tpch.py (dbgen-shaped), in
# numpy only -- the same columns, distributions and random stream
# ---------------------------------------------------------------------------

_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
_INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
_TYPES = [f"{a} {b} {c}" for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE",
                                   "ECONOMY", "PROMO")
          for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
          for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
_CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
               for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM")]


def _tag(prefix, nums: np.ndarray, width: int) -> np.ndarray:
    """f"{prefix}{num:0{width}d}" (dbgen-style names); ``prefix`` may be an
    array.  (numpy's ``char.zfill`` cuts longer numbers to ``width``.)"""
    digits = np.array([f"{v:0{width}d}" for v in np.asarray(nums).tolist()],
                      dtype=str)
    return np.char.add(prefix, digits)


def _blank(n: int) -> np.ndarray:
    return np.full(n, "", dtype="<U1")


def _dates(days: np.ndarray) -> np.ndarray:
    return np.datetime64("1970-01-01", "D") + np.asarray(days).astype("timedelta64[D]")


def generate_tpch(sf: float, seed: int) -> dict:
    """{table: {column: numpy array}} for the eight TPC-H tables."""
    rng = np.random.RandomState(seed)
    n_part = max(int(200_000 * sf), 50)
    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 30)
    n_ord = max(int(1_500_000 * sf), 150)
    n_nation = len(_NATIONS)
    region = {"r_regionkey": np.arange(5), "r_name": np.array(_REGIONS),
              "r_comment": _blank(5)}
    nation = {"n_nationkey": np.arange(n_nation),
              "n_name": np.array([n for n, _ in _NATIONS]),
              "n_regionkey": np.array([r for _, r in _NATIONS]),
              "n_comment": _blank(n_nation)}
    supplier = {
        "s_suppkey": np.arange(1, n_supp + 1),
        "s_name": _tag("Supplier#", np.arange(1, n_supp + 1), 9),
        "s_address": _tag("addr", np.arange(n_supp), 0),
        "s_nationkey": rng.randint(0, n_nation, n_supp),
        "s_phone": _tag("", np.arange(n_supp), 10),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": _blank(n_supp),
    }
    pk = np.arange(1, n_part + 1)
    part = {
        "p_partkey": pk,
        "p_name": rng.choice(["ivory blue", "green navy", "red linen",
                              "metallic olive", "antique puff"], n_part),
        "p_mfgr": _tag("Manufacturer#", np.arange(n_part) % 5 + 1, 0),
        "p_brand": _tag("Brand#", (np.arange(n_part) % 5 + 1) * 10
                        + (np.arange(n_part) // 5) % 5 + 1, 0),
        "p_type": rng.choice(_TYPES, n_part),
        "p_size": rng.randint(1, 51, n_part),
        "p_container": rng.choice(_CONTAINERS, n_part),
        "p_retailprice": np.round(900 + (pk % 1000) / 10.0 + 100 * (pk % 10), 2),
        "p_comment": _blank(n_part),
    }
    n_ps = n_part * 4
    ps_step = max(n_supp // 4, 1)

    def psupp(partkey, i):
        return (partkey - 1 + i * ps_step) % n_supp + 1

    partsupp = {
        "ps_partkey": np.repeat(pk, 4),
        "ps_suppkey": psupp(np.repeat(pk, 4), np.tile(np.arange(4), n_part)),
        "ps_availqty": rng.randint(1, 10_000, n_ps),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_ps), 2),
        "ps_comment": _blank(n_ps),
    }
    c_nationkey = rng.randint(0, n_nation, n_cust)
    customer = {
        "c_custkey": np.arange(1, n_cust + 1),
        "c_name": _tag("Customer#", np.arange(1, n_cust + 1), 9),
        "c_address": _tag("addr", np.arange(n_cust), 0),
        "c_nationkey": c_nationkey,
        "c_phone": _tag(np.char.add((c_nationkey + 10).astype(str), "-"),
                        np.arange(n_cust), 8),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": rng.choice(_SEGMENTS, n_cust),
        "c_comment": _blank(n_cust),
    }
    o_dates = rng.randint(_days("1992-01-01"), _days("1998-08-02"), n_ord)
    o_custkey = rng.randint(1, n_cust + 1, n_ord)
    o_custkey = o_custkey + (o_custkey % 3 == 0)
    o_custkey = np.where(o_custkey > n_cust, 1, o_custkey)
    orders = {
        "o_orderkey": np.arange(1, n_ord + 1) * 4,
        "o_custkey": o_custkey,
        "o_orderstatus": rng.choice(["F", "O", "P"], n_ord, p=[0.49, 0.49, 0.02]),
        "o_totalprice": np.round(rng.uniform(800.0, 600_000.0, n_ord), 2),
        "o_orderdate": _dates(o_dates),
        "o_orderpriority": rng.choice(_PRIORITIES, n_ord),
        "o_clerk": _tag("Clerk#", np.arange(n_ord) % 1000, 9),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": _blank(n_ord),
    }
    lines = rng.randint(1, 8, n_ord)
    n_li = int(lines.sum())
    odate = np.repeat(o_dates, lines)
    ship = odate + rng.randint(1, 122, n_li)
    commit = odate + rng.randint(30, 91, n_li)
    receipt = ship + rng.randint(1, 31, n_li)
    returnflag = np.where(receipt <= _days("1995-06-17"),
                          rng.choice(["R", "A"], n_li), "N")
    li_partkey = rng.randint(1, n_part + 1, n_li)
    lineitem = {
        "l_orderkey": np.repeat(orders["o_orderkey"], lines),
        "l_partkey": li_partkey,
        "l_suppkey": psupp(li_partkey, rng.randint(0, 4, n_li)),
        "l_linenumber": np.arange(n_li) - np.repeat(np.cumsum(lines) - lines,
                                                    lines) + 1,
        "l_quantity": rng.randint(1, 51, n_li).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900.0, 105_000.0, n_li), 2),
        "l_discount": np.round(rng.randint(0, 11, n_li) / 100.0, 2),
        "l_tax": np.round(rng.randint(0, 9, n_li) / 100.0, 2),
        "l_returnflag": returnflag,
        "l_linestatus": np.where(ship > _days("1995-06-17"), "O", "F"),
        "l_shipdate": _dates(ship),
        "l_commitdate": _dates(commit),
        "l_receiptdate": _dates(receipt),
        "l_shipinstruct": rng.choice(_INSTRUCTS, n_li),
        "l_shipmode": rng.choice(_SHIPMODES, n_li),
        "l_comment": _blank(n_li),
    }
    return {"region": region, "nation": nation, "supplier": supplier,
            "part": part, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}


# The TPC-H query texts of benchmarks/tpch.py (a copy: that module needs
# pandas, which the card's machine does not have)
QUERIES = {
    1: """
        SELECT l_returnflag, l_linestatus,
               SUM(l_quantity) AS sum_qty,
               SUM(l_extendedprice) AS sum_base_price,
               SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
               SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
               AVG(l_quantity) AS avg_qty,
               AVG(l_extendedprice) AS avg_price,
               AVG(l_discount) AS avg_disc,
               COUNT(*) AS count_order
        FROM lineitem
        WHERE l_shipdate <= DATE '1998-09-02'
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus
    """,
    3: """
        SELECT l_orderkey,
               SUM(l_extendedprice * (1 - l_discount)) AS revenue,
               o_orderdate, o_shippriority
        FROM customer, orders, lineitem
        WHERE c_mktsegment = 'BUILDING'
          AND c_custkey = o_custkey
          AND l_orderkey = o_orderkey
          AND o_orderdate < DATE '1995-03-15'
          AND l_shipdate > DATE '1995-03-15'
        GROUP BY l_orderkey, o_orderdate, o_shippriority
        ORDER BY revenue DESC, o_orderdate
        LIMIT 10
    """,
    5: """
        SELECT n_name,
               SUM(l_extendedprice * (1 - l_discount)) AS revenue
        FROM customer, orders, lineitem, supplier, nation, region
        WHERE c_custkey = o_custkey
          AND l_orderkey = o_orderkey
          AND l_suppkey = s_suppkey
          AND c_nationkey = s_nationkey
          AND s_nationkey = n_nationkey
          AND n_regionkey = r_regionkey
          AND r_name = 'ASIA'
          AND o_orderdate >= DATE '1994-01-01'
          AND o_orderdate < DATE '1995-01-01'
        GROUP BY n_name
        ORDER BY revenue DESC
    """,
    6: """
        SELECT SUM(l_extendedprice * l_discount) AS revenue
        FROM lineitem
        WHERE l_shipdate >= DATE '1994-01-01'
          AND l_shipdate < DATE '1995-01-01'
          AND l_discount BETWEEN 0.05 AND 0.07
          AND l_quantity < 24
    """,
    9: """
        SELECT nation, o_year, SUM(amount) AS sum_profit
        FROM (
            SELECT n_name AS nation,
                   EXTRACT(YEAR FROM o_orderdate) AS o_year,
                   l_extendedprice * (1 - l_discount)
                     - ps_supplycost * l_quantity AS amount
            FROM part, supplier, lineitem, partsupp, orders, nation
            WHERE s_suppkey = l_suppkey
              AND ps_suppkey = l_suppkey
              AND ps_partkey = l_partkey
              AND p_partkey = l_partkey
              AND o_orderkey = l_orderkey
              AND s_nationkey = n_nationkey
              AND p_name LIKE '%green%'
        ) AS profit
        GROUP BY nation, o_year
        ORDER BY nation, o_year DESC
    """,
    10: """
        SELECT c_custkey, c_name,
               SUM(l_extendedprice * (1 - l_discount)) AS revenue,
               c_acctbal, n_name, c_address, c_phone, c_comment
        FROM customer, orders, lineitem, nation
        WHERE c_custkey = o_custkey
          AND l_orderkey = o_orderkey
          AND o_orderdate >= DATE '1993-10-01'
          AND o_orderdate < DATE '1994-01-01'
          AND l_returnflag = 'R'
          AND c_nationkey = n_nationkey
        GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
        ORDER BY revenue DESC
        LIMIT 20
    """,
    12: """
        SELECT l_shipmode,
               SUM(CASE WHEN o_orderpriority = '1-URGENT'
                         OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END) AS high_line_count,
               SUM(CASE WHEN o_orderpriority <> '1-URGENT'
                        AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END) AS low_line_count
        FROM orders, lineitem
        WHERE o_orderkey = l_orderkey
          AND l_shipmode IN ('MAIL', 'SHIP')
          AND l_commitdate < l_receiptdate
          AND l_shipdate < l_commitdate
          AND l_receiptdate >= DATE '1994-01-01'
          AND l_receiptdate < DATE '1995-01-01'
        GROUP BY l_shipmode
        ORDER BY l_shipmode
    """,
    14: """
        SELECT 100.00 * SUM(CASE WHEN p_type LIKE 'PROMO%'
                                 THEN l_extendedprice * (1 - l_discount)
                                 ELSE 0 END) / SUM(l_extendedprice * (1 - l_discount)) AS promo_revenue
        FROM lineitem, part
        WHERE l_partkey = p_partkey
          AND l_shipdate >= DATE '1995-09-01'
          AND l_shipdate < DATE '1995-10-01'
    """,
    2: """
        SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
               s_phone, s_comment
        FROM part, supplier, partsupp, nation, region
        WHERE p_partkey = ps_partkey
          AND s_suppkey = ps_suppkey
          AND p_size = 15
          AND p_type LIKE '%BRASS'
          AND s_nationkey = n_nationkey
          AND n_regionkey = r_regionkey
          AND r_name = 'EUROPE'
          AND ps_supplycost = (
                SELECT MIN(ps_supplycost)
                FROM partsupp, supplier, nation, region
                WHERE p_partkey = ps_partkey
                  AND s_suppkey = ps_suppkey
                  AND s_nationkey = n_nationkey
                  AND n_regionkey = r_regionkey
                  AND r_name = 'EUROPE')
        ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
        LIMIT 100
    """,
    4: """
        SELECT o_orderpriority, COUNT(*) AS order_count
        FROM orders
        WHERE o_orderdate >= DATE '1993-07-01'
          AND o_orderdate < DATE '1993-10-01'
          AND EXISTS (
                SELECT * FROM lineitem
                WHERE l_orderkey = o_orderkey
                  AND l_commitdate < l_receiptdate)
        GROUP BY o_orderpriority
        ORDER BY o_orderpriority
    """,
    7: """
        SELECT supp_nation, cust_nation, l_year, SUM(volume) AS revenue
        FROM (
            SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
                   EXTRACT(YEAR FROM l_shipdate) AS l_year,
                   l_extendedprice * (1 - l_discount) AS volume
            FROM supplier, lineitem, orders, customer, nation n1, nation n2
            WHERE s_suppkey = l_suppkey
              AND o_orderkey = l_orderkey
              AND c_custkey = o_custkey
              AND s_nationkey = n1.n_nationkey
              AND c_nationkey = n2.n_nationkey
              AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
                OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
              AND l_shipdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'
        ) AS shipping
        GROUP BY supp_nation, cust_nation, l_year
        ORDER BY supp_nation, cust_nation, l_year
    """,
    8: """
        SELECT o_year,
               SUM(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0 END)
                 / SUM(volume) AS mkt_share
        FROM (
            SELECT EXTRACT(YEAR FROM o_orderdate) AS o_year,
                   l_extendedprice * (1 - l_discount) AS volume,
                   n2.n_name AS nation
            FROM part, supplier, lineitem, orders, customer,
                 nation n1, nation n2, region
            WHERE p_partkey = l_partkey
              AND s_suppkey = l_suppkey
              AND l_orderkey = o_orderkey
              AND o_custkey = c_custkey
              AND c_nationkey = n1.n_nationkey
              AND n1.n_regionkey = r_regionkey
              AND r_name = 'AMERICA'
              AND s_nationkey = n2.n_nationkey
              AND o_orderdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'
              AND p_type = 'ECONOMY ANODIZED STEEL'
        ) AS all_nations
        GROUP BY o_year
        ORDER BY o_year
    """,
    11: """
        SELECT ps_partkey, SUM(ps_supplycost * ps_availqty) AS value
        FROM partsupp, supplier, nation
        WHERE ps_suppkey = s_suppkey
          AND s_nationkey = n_nationkey
          AND n_name = 'GERMANY'
        GROUP BY ps_partkey
        HAVING SUM(ps_supplycost * ps_availqty) > (
                SELECT SUM(ps_supplycost * ps_availqty) * 0.0001
                FROM partsupp, supplier, nation
                WHERE ps_suppkey = s_suppkey
                  AND s_nationkey = n_nationkey
                  AND n_name = 'GERMANY')
        ORDER BY value DESC
    """,
    13: """
        SELECT c_count, COUNT(*) AS custdist
        FROM (
            SELECT c_custkey, COUNT(o_orderkey) AS c_count
            FROM customer LEFT OUTER JOIN orders
              ON c_custkey = o_custkey AND o_comment NOT LIKE '%special%requests%'
            GROUP BY c_custkey
        ) AS c_orders
        GROUP BY c_count
        ORDER BY custdist DESC, c_count DESC
    """,
    15: """
        WITH revenue0 AS (
            SELECT l_suppkey AS supplier_no,
                   SUM(l_extendedprice * (1 - l_discount)) AS total_revenue
            FROM lineitem
            WHERE l_shipdate >= DATE '1996-01-01'
              AND l_shipdate < DATE '1996-04-01'
            GROUP BY l_suppkey
        )
        SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
        FROM supplier, revenue0
        WHERE s_suppkey = supplier_no
          AND total_revenue = (SELECT MAX(total_revenue) FROM revenue0)
        ORDER BY s_suppkey
    """,
    16: """
        SELECT p_brand, p_type, p_size, COUNT(DISTINCT ps_suppkey) AS supplier_cnt
        FROM partsupp, part
        WHERE p_partkey = ps_partkey
          AND p_brand <> 'Brand#45'
          AND p_type NOT LIKE 'MEDIUM POLISHED%'
          AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
          AND ps_suppkey NOT IN (
                SELECT s_suppkey FROM supplier
                WHERE s_comment LIKE '%Customer%Complaints%')
        GROUP BY p_brand, p_type, p_size
        ORDER BY supplier_cnt DESC, p_brand, p_type, p_size
    """,
    17: """
        SELECT SUM(l_extendedprice) / 7.0 AS avg_yearly
        FROM lineitem, part
        WHERE p_partkey = l_partkey
          AND p_brand = 'Brand#23'
          AND p_container = 'MED BOX'
          AND l_quantity < (
                SELECT 0.2 * AVG(l_quantity)
                FROM lineitem
                WHERE l_partkey = p_partkey)
    """,
    19: """
        SELECT SUM(l_extendedprice * (1 - l_discount)) AS revenue
        FROM lineitem, part
        WHERE (p_partkey = l_partkey AND p_brand = 'Brand#12'
               AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
               AND l_quantity >= 1 AND l_quantity <= 11
               AND p_size BETWEEN 1 AND 5
               AND l_shipmode IN ('AIR', 'AIR REG')
               AND l_shipinstruct = 'DELIVER IN PERSON')
           OR (p_partkey = l_partkey AND p_brand = 'Brand#23'
               AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
               AND l_quantity >= 10 AND l_quantity <= 20
               AND p_size BETWEEN 1 AND 10
               AND l_shipmode IN ('AIR', 'AIR REG')
               AND l_shipinstruct = 'DELIVER IN PERSON')
           OR (p_partkey = l_partkey AND p_brand = 'Brand#34'
               AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
               AND l_quantity >= 20 AND l_quantity <= 30
               AND p_size BETWEEN 1 AND 15
               AND l_shipmode IN ('AIR', 'AIR REG')
               AND l_shipinstruct = 'DELIVER IN PERSON')
    """,
    20: """
        SELECT s_name, s_address
        FROM supplier, nation
        WHERE s_suppkey IN (
                SELECT ps_suppkey FROM partsupp
                WHERE ps_partkey IN (
                        SELECT p_partkey FROM part WHERE p_name LIKE 'ivory%')
                  AND ps_availqty > (
                        SELECT 0.5 * SUM(l_quantity)
                        FROM lineitem
                        WHERE l_partkey = ps_partkey
                          AND l_suppkey = ps_suppkey
                          AND l_shipdate >= DATE '1994-01-01'
                          AND l_shipdate < DATE '1995-01-01'))
          AND s_nationkey = n_nationkey
          AND n_name = 'CANADA'
        ORDER BY s_name
    """,
    21: """
        SELECT s_name, COUNT(*) AS numwait
        FROM supplier, lineitem l1, orders, nation
        WHERE s_suppkey = l1.l_suppkey
          AND o_orderkey = l1.l_orderkey
          AND o_orderstatus = 'F'
          AND l1.l_receiptdate > l1.l_commitdate
          AND EXISTS (
                SELECT * FROM lineitem l2
                WHERE l2.l_orderkey = l1.l_orderkey
                  AND l2.l_suppkey <> l1.l_suppkey)
          AND NOT EXISTS (
                SELECT * FROM lineitem l3
                WHERE l3.l_orderkey = l1.l_orderkey
                  AND l3.l_suppkey <> l1.l_suppkey
                  AND l3.l_receiptdate > l3.l_commitdate)
          AND s_nationkey = n_nationkey
          AND n_name = 'SAUDI ARABIA'
        GROUP BY s_name
        ORDER BY numwait DESC, s_name
        LIMIT 100
    """,
    22: """
        SELECT cntrycode, COUNT(*) AS numcust, SUM(c_acctbal) AS totacctbal
        FROM (
            SELECT SUBSTRING(c_phone FROM 1 FOR 2) AS cntrycode, c_acctbal
            FROM customer
            WHERE SUBSTRING(c_phone FROM 1 FOR 2) IN
                    ('13', '31', '23', '29', '30', '18', '17')
              AND c_acctbal > (
                    SELECT AVG(c_acctbal) FROM customer
                    WHERE c_acctbal > 0.00
                      AND SUBSTRING(c_phone FROM 1 FOR 2) IN
                            ('13', '31', '23', '29', '30', '18', '17'))
              AND NOT EXISTS (
                    SELECT * FROM orders WHERE o_custkey = c_custkey)
        ) AS custsale
        GROUP BY cntrycode
        ORDER BY cntrycode
    """,
    18: """
        SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
               SUM(l_quantity) AS total_qty
        FROM customer, orders, lineitem
        WHERE o_orderkey IN (
                SELECT l_orderkey FROM lineitem
                GROUP BY l_orderkey HAVING SUM(l_quantity) > 300)
          AND c_custkey = o_custkey
          AND o_orderkey = l_orderkey
        GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
        ORDER BY o_totalprice DESC, o_orderdate
        LIMIT 100
    """,
}


# ---------------------------------------------------------------------------
# answers: numpy oracles for Q1 and Q6, the CPU run, sqlite
# ---------------------------------------------------------------------------

def oracle_q1(li: dict) -> dict:
    ship = li["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    keep = ship <= _days("1998-09-02")
    price, disc = li["l_extendedprice"][keep], li["l_discount"][keep]
    qty, tax = li["l_quantity"][keep], li["l_tax"][keep]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    rf, ls = li["l_returnflag"][keep], li["l_linestatus"][keep]
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty",
                           "sum_base_price", "sum_disc_price", "sum_charge",
                           "avg_qty", "avg_price", "avg_disc", "count_order")}
    for r in sorted(set(rf.tolist())):
        for s in sorted(set(ls.tolist())):
            sel = (rf == r) & (ls == s)
            cnt = int(sel.sum())
            if not cnt:
                continue
            out["l_returnflag"].append(r)
            out["l_linestatus"].append(s)
            out["sum_qty"].append(math.fsum(qty[sel]))
            out["sum_base_price"].append(math.fsum(price[sel]))
            out["sum_disc_price"].append(math.fsum(disc_price[sel]))
            out["sum_charge"].append(math.fsum(charge[sel]))
            out["avg_qty"].append(math.fsum(qty[sel]) / cnt)
            out["avg_price"].append(math.fsum(price[sel]) / cnt)
            out["avg_disc"].append(math.fsum(disc[sel]) / cnt)
            out["count_order"].append(cnt)
    return out


def oracle_q6(li: dict) -> dict:
    ship = li["l_shipdate"].astype("datetime64[D]").astype(np.int64)
    d, q = li["l_discount"], li["l_quantity"]
    keep = ((ship >= _days("1994-01-01")) & (ship < _days("1995-01-01"))
            & (d >= 0.05) & (d <= 0.07) & (q < 24))
    return {"revenue": [math.fsum(li["l_extendedprice"][keep] * d[keep])]}


def check_answer(name: str, got: dict, want: dict) -> None:
    if list(got) != list(want):
        raise AssertionError(f"{name}: columns {list(got)} != {list(want)}")
    for col, w in want.items():
        g = got[col]
        if len(g) != len(w):
            raise AssertionError(f"{name}.{col}: {len(g)} rows, expected {len(w)}")
        if w and isinstance(w[0], str) or col.startswith("count"):
            if list(g) != list(w):
                raise AssertionError(f"{name}.{col}: {list(g)} != {w}")
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=1e-12,
                                       err_msg=f"{name}.{col}")


def check_same_result(name: str, got, want, rtol: float) -> None:
    """Two port results of one query: same columns and rows; doubles to
    rtol, everything else exact."""
    if got.names != want.names or got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got} != {want}")
    for col, g, w in zip(want.names, got.columns, want.columns):
        gv, wv = g.to_numpy(), w.to_numpy()
        if wv.dtype.kind == "f":
            np.testing.assert_allclose(gv.astype(np.float64), wv, rtol=rtol,
                                       equal_nan=True, err_msg=f"{name}.{col}")
        elif gv.tolist() != wv.tolist():
            raise AssertionError(f"{name}.{col} differs")


def to_sqlite(q: str) -> str:
    """The dialect rewrites of tests/integration/test_tpch.py."""
    q = q.replace("DATE '", "'")
    q = re.sub(r"SUBSTRING\(\s*(\w+)\s+FROM\s+(\d+)\s+FOR\s+(\d+)\s*\)",
               r"substr(\1, \2, \3)", q)
    q = re.sub(r"EXTRACT\(\s*YEAR\s+FROM\s+(\w+)\s*\)",
               r"CAST(strftime('%Y', \1) AS INTEGER)", q)
    return q


def load_sqlite(tables: dict):
    """An in-memory sqlite database of the tables: dates as ISO strings,
    int columns INTEGER, floats REAL, strings TEXT (as pandas' to_sql), and
    an index on every key column (it changes no answer; without it sqlite
    runs Q21's correlated EXISTS as nested scans for minutes)."""
    import sqlite3

    conn = sqlite3.connect(":memory:")
    for name, cols in tables.items():
        decl, values = [], []
        for col, arr in cols.items():
            kind = arr.dtype.kind
            if kind == "M":
                values.append(np.datetime_as_string(arr, unit="D").tolist())
                decl.append(f"{col} TEXT")
            else:
                values.append(arr.tolist())
                decl.append(f"{col} " + {"i": "INTEGER", "f": "REAL"}.get(kind, "TEXT"))
        conn.execute(f"CREATE TABLE {name} ({', '.join(decl)})")
        conn.executemany(f"INSERT INTO {name} VALUES ({', '.join('?' * len(cols))})",
                         zip(*values))
        for col in cols:
            if col.endswith("key"):
                conn.execute(f"CREATE INDEX {col}_idx ON {name} ({col})")
    return conn


def _cell(v) -> str:
    if isinstance(v, np.datetime64):
        if np.isnat(v):
            return "None"
        return np.datetime_as_string(v.astype("datetime64[D]"))
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "None"
    return str(v)


def check_sqlite(name: str, result, cur, ordered: bool, atol=None) -> None:
    """The comparison rules of tests/integration/test_tpch.py; ``atol``
    ({column: per-row array in the result's row order}) widens a double
    column by an absolute bound as well."""
    want_rows = cur.fetchall()
    cols = [c.to_numpy() for c in result.columns]
    got_rows = [tuple(c[i] for c in cols) for i in range(result.num_rows)]
    if len(got_rows) != len(want_rows):
        raise AssertionError(f"{name}: {len(got_rows)} rows vs sqlite "
                             f"{len(want_rows)}")
    order = list(range(len(got_rows)))
    if not ordered:
        key = lambda r: [_cell(v) for v in r]  # noqa: E731
        order.sort(key=lambda i: key(got_rows[i]))
        got_rows, want_rows = [got_rows[i] for i in order], sorted(want_rows, key=key)
    for j in range(len(cols)):
        g = [r[j] for r in got_rows]
        w = [r[j] for r in want_rows]
        if cols[j].dtype.kind in "fc" or any(isinstance(v, float) for v in w):
            gv = np.array([np.nan if v is None else float(v) for v in g])
            wv = np.array([np.nan if v is None else float(v) for v in w])
            tol = 1e-6 * np.abs(wv)
            if atol and result.names[j] in atol:
                tol = tol + np.asarray(atol[result.names[j]])[order]
            bad = ~((np.abs(gv - wv) <= tol) | (gv == wv)
                    | (np.isnan(gv) & np.isnan(wv)))
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                raise AssertionError(
                    f"{name} column {result.names[j]}: {int(bad.sum())} rows "
                    f"differ, first {gv[i]!r} vs sqlite {wv[i]!r}")
        elif [_cell(v) for v in g] != [_cell(v) for v in w]:
            raise AssertionError(f"{name} column {result.names[j]} differs")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of fn() in ms by CUDA events over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_ms(fn, kernel: str, reps: int, fallback: float) -> tuple:
    """(ms, source): the device time per run of fn() of the CUDA kernels
    whose names contain ``kernel`` (the hand-written kernel itself, without
    the wrapper's zeroing or the host's gaps between launches), from
    torch.profiler over ``reps`` runs, and "profiler"; or ``fallback`` and
    "events" if the profiler sees no such kernel in three tries (it now and
    then returns no device events at all)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and kernel in e.key)
        if total > 0:
            return total / 1e3 / reps, "profiler"
    print(f"profiler: no device time for {kernel}; using CUDA events")
    return fallback, "events"


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def stream_wall_ms(fn) -> float:
    """``wall_ms`` ending in the current stream's synchronisation, not the
    device's: safe while another thread captures a CUDA graph."""
    stream = torch.cuda.current_stream()
    stream.synchronize()
    t0 = time.perf_counter()
    fn()
    stream.synchronize()
    return (time.perf_counter() - t0) * 1e3


def count_syncs(fn) -> int:
    """Host synchronisations of one run of fn(), as reported by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment() -> str:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    return card


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from dask_sql_tpu_torch import native
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        front_end = pool.submit(native.build)
        kernels = gk.build_kernels()
        info = front_end.result()
    print(f"build: native parser and optimizer "
          f"{'built' if info['built'] else 'cached'} in "
          f"{info['seconds']:.1f} s -> {info['path']}")
    for name, info in kernels.items():
        print(f"build: {name} {'built' if info['built'] else 'cached'} in "
              f"{info['seconds']:.1f} s -> {info['path']}")
        for line in str(info["log"]).splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s in all")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int64 if a.element_size() == 8 else torch.int32
    return bool(torch.equal(a.contiguous().view(view), b.contiguous().view(view)))


def _segsum_case(rng, n: int, g: int, classes) -> tuple:
    rows = []
    for c in classes:
        if c == "unit":
            rows.append((rng.rand(n) > 0.1).astype(np.float64))
        elif c == "int":
            rows.append(rng.randint(-10**9, 10**9, n).astype(np.float64))
        else:
            rows.append(np.round(rng.uniform(900.0, 105_000.0, n), 2))
    vals = np.vstack(rows) if rows else np.zeros((0, n))
    codes = rng.randint(0, g, n)
    mask = rng.rand(n) > 0.02
    return vals, codes, mask


def capture_q1_reduction(ctx) -> tuple:
    """Run Q1 once -- its cold run, the first query in the process -- with a
    spy on the executor's static-domain reduction.  Returns the inputs the
    main path hands the kernel, (values, codes, mask, groups, row classes),
    the run's wall time in ms, and the launch counts of the run."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk
    from dask_sql_tpu_torch.physical.rel import executor as ex

    real = ex.segmented_sums_dispatch
    box = {}

    def spy(vals, codes, mask, num_groups, row_classes=None):
        box["args"] = (vals, codes, mask, num_groups, list(row_classes))
        return real(vals, codes, mask, num_groups, row_classes=row_classes)

    ex.segmented_sums_dispatch = spy
    gk.reset_launch_counts()
    try:
        cold_ms = wall_ms(lambda: ctx.sql(QUERIES[1]))
    finally:
        ex.segmented_sums_dispatch = real
    return box["args"], cold_ms, dict(gk.LAUNCHES)


def phase_kernel1(dev, q1_args: tuple) -> dict:
    """segsum_fixedpoint against its plain version: bit-identical on Q1's
    own reduction and on edge cases; timed on Q1's reduction."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    rng = np.random.RandomState(1)
    cases = {}
    v, c, m = _segsum_case(rng, 500_000, 256, Q1_CLASSES)
    cases["domain_256"] = (v, c, m, 256, Q1_CLASSES)
    v, c, m = _segsum_case(rng, 1_000_003, 4, ["float", "int", "unit"])
    cases["ragged_n"] = (v, c, m, 4, ["float", "int", "unit"])
    v, c, m = _segsum_case(rng, 200_000, 5, ["float", "int", "unit"])
    for row, col, x in [(0, 5, np.nan), (0, 9, np.inf), (1, 7, -np.inf),
                        (1, 8, np.inf), (2, 11, np.nan), (0, 12, -np.inf)]:
        v[row, col] = x
    cases["nonfinite"] = (v, c, m, 5, ["float", "int", "unit"])
    v, c, m = _segsum_case(rng, 100_000, 3, ["float"])
    v[0, 17], m[17] = 1e300, False
    cases["masked_outlier"] = (v, c, m, 3, ["float"])
    v, c, m = _segsum_case(rng, 100_000, 3, ["int", "int"])
    v[:, :4] = [[2.0**52, -(2.0**52), 2.0**52 - 1, -1.0]] * 2
    v[:, 4:] = 0.0
    cases["int_near_2_53"] = (v, c, m, 3, ["int", "int"])
    cases["empty"] = (np.zeros((3, 0)), np.zeros(0, np.int64), np.ones(0, bool),
                      3, ["float", "int", "unit"])
    # the warp schedules: one group in every row (the old worst case), both
    # signs in every warp, n off every chunk and block range, and 256 groups
    # (block-shared accumulators) with both signs
    v, c, m = _segsum_case(rng, 1_000_000, 6, Q1_CLASSES)
    cases["one_group"] = (v, np.full_like(c, 2), m, 6, Q1_CLASSES)
    mixed = ["unit", "float", "unit", "int", "float"]
    v, c, m = _segsum_case(rng, 1_000_000, 6, mixed)
    v[[1, 3, 4]] *= np.where(rng.rand(3, v.shape[1]) > 0.5, 1.0, -1.0)
    cases["mixed_signs"] = (v, c, m, 6, mixed)
    v, c, m = _segsum_case(rng, 32 * 100_003 + 5, 6, Q1_CLASSES)
    cases["ragged_boundary"] = (v, c, m, 6, Q1_CLASSES)
    v, c, m = _segsum_case(rng, 500_000, 256, mixed)
    v[[1, 3, 4]] *= np.where(rng.rand(3, v.shape[1]) > 0.5, 1.0, -1.0)
    cases["domain_256_mixed_signs"] = (v, c, m, 256, mixed)
    tensors = {"q1_main_path": q1_args}
    for name, (v, c, m, g, cls) in cases.items():
        tensors[name] = (torch.from_numpy(v).to(dev), torch.from_numpy(c).to(dev),
                         torch.from_numpy(m).to(dev), g, cls)
    max_err = 0.0
    for name, (vals, codes, mask, g, cls) in tensors.items():
        got = gk.segmented_sums_fixedpoint(vals, codes, mask, g, row_classes=cls)
        plain = gk.segmented_sums_fixedpoint(
            vals, codes, mask, g, row_classes=cls,
            limb_totals=gk.segsum_limb_totals_plain)
        torch.cuda.synchronize()
        diff = ((got - plain).nan_to_num(0.0).abs().max().item()
                if got.numel() else 0.0)
        if not _bits_equal(got, plain):
            raise AssertionError(f"kernel 1 vs plain differ on {name}: max {diff}")
        max_err = max(max_err, diff)
        print(f"kernel 1 case {name}: {tuple(vals.shape)} x {g} groups, "
              f"{len(cls)} row classes: bit-identical")

    # timing on Q1's own reduction: the kernel's function (limb totals)
    vals, codes, mask, g, cls = q1_args
    codes32 = codes.to(torch.int32).contiguous()
    mask_u8 = mask.to(torch.uint8).contiguous()
    scale = gk._pow2(gk._grid_exponents(vals, mask_u8, cls))
    args = (vals, codes32, mask_u8, scale, cls, g)
    event_ms = cuda_ms(lambda: gk.segsum_limb_totals_cuda(*args), reps=20)
    ms, ms_source = profiled_ms(lambda: gk.segsum_limb_totals_cuda(*args),
                                "segsum_fixedpoint_kernel", reps=20,
                                fallback=event_ms)
    plain_ms = cuda_ms(lambda: gk.segsum_limb_totals_plain(*args), reps=3)
    library_ms = cuda_ms(
        lambda: gk.reference_segmented_sums(vals, codes, mask, g), reps=20)
    full_ms = cuda_ms(lambda: gk.segmented_sums_fixedpoint(
        vals, codes, mask, g, row_classes=cls), reps=10)
    a, n = vals.shape
    n_limb_rows = gk.limb_layout(cls)[2][-1]
    moved = (a * n * 8 + n * 4 + n * 1 + a * 8
             + (n_limb_rows + 3 * a) * g * 8)
    ops = a * n                     # one add per contributing value
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S) * 1e3
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= ops / FP64_OPS_PER_S \
        else "operations"
    print(f"segsum_fixedpoint on Q1's reduction ({a} x {n}, {g} groups): "
          f"kernel {ms:.3f} ms ({ms_source}: device time of the kernel; event mean "
          f"over back-to-back calls {event_ms:.3f} ms), plain {plain_ms:.3f} ms, "
          f"index_add_ "
          f"{library_ms:.3f} ms, full fixed-point sums {full_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}: {moved / 1e9:.3f} GB)")
    return {"name": "segsum_fixedpoint", "route": "cuda",
            "source": "dask_sql_tpu_torch/csrc/segsum_fixedpoint.cu",
            "replaces": "dask_sql_tpu/ops/pallas_kernels.py:103",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "event_ms": event_ms,
            "ms_source": ms_source}


def _accumulate_check(name: str, vals, codes, mask, g, got) -> float:
    """Hold a kernel-2 result to the float64 sum of the same values:
    |got - want| <= (1024 + ceil(n/1024)) * eps * sum|v| per (row, group);
    NaN where the float64 sum is NaN, the same infinities, 0.0 for a group
    with no rows.  Returns the largest |got - want| over finite entries."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    n = vals.shape[1]
    v64 = vals.to(torch.float64)
    want = gk.reference_segmented_sums(v64, codes, mask, g)
    abs_sum = gk.reference_segmented_sums(
        v64.nan_to_num(0.0, 0.0, 0.0).abs(), codes, mask, g)
    eps = 2.0 ** -24 if vals.dtype == torch.float32 else 2.0 ** -53
    bound = (1024 + -(-n // 1024)) * eps * abs_sum
    fin = torch.isfinite(want)
    err = (got.to(torch.float64) - want).abs()
    ok = (got.dtype == vals.dtype
          and torch.equal(torch.isnan(got), torch.isnan(want))
          and torch.equal(got[~fin & ~torch.isnan(want)].to(torch.float64),
                          want[~fin & ~torch.isnan(want)])
          and bool((err[fin] <= bound[fin]).all())
          and bool((got[fin & (abs_sum == 0)] == 0).all()))
    if not ok:
        raise AssertionError(f"kernel 2 case {name}: outside the bound "
                             f"(max err {err[fin].max().item() if fin.any() else 0})")
    return err[fin].max().item() if bool(fin.any()) else 0.0


def phase_kernel2(dev, q1_args: tuple) -> dict:
    """segsum_accumulate: its path (Q1's reduction in float32 through the
    float32 branch of segmented_sums_dispatch) with the counts at 0, then
    kernel and plain version held to the float64 sum on that input and on
    edge cases, the kernel twice for identical bits; then timed."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    vals, codes, mask, g, _ = q1_args
    vals32 = vals.to(torch.float32).contiguous()
    gk.reset_launch_counts()
    path_out = gk.segmented_sums_dispatch(vals32, codes, mask, g)
    torch.cuda.synchronize()
    launches = gk.LAUNCHES["segsum_accumulate"]
    if launches < 1 or gk.LAUNCHES["segsum_fixedpoint"]:
        raise AssertionError(f"the float32 dispatch did not take kernel 2: "
                             f"{dict(gk.LAUNCHES)}")
    print(f"kernel 2 path: segmented_sums_dispatch on Q1's reduction in "
          f"float32 {tuple(vals32.shape)} x {g} groups -> {dict(gk.LAUNCHES)}")

    rng = np.random.RandomState(2)
    cases = {"q1_float32": (vals32, codes, mask, g)}

    def put(name, v, c, m, groups):
        cases[name] = (torch.from_numpy(v).to(dev), torch.from_numpy(c).to(dev),
                       torch.from_numpy(m).to(dev), groups)

    v, c, m = _segsum_case(rng, 1_000_003, 6, ["float", "int", "unit"])
    put("ragged_n", v.astype(np.float32), c, m, 6)
    v, c, m = _segsum_case(rng, 500_000, 256, ["float"] * 5)
    put("domain_256", v.astype(np.float32), c, m, 256)
    v, c, m = _segsum_case(rng, 200_000, 8, ["float", "float"])
    c[:6] = [5, 6, 7, 5, 6, 7]
    m[:6] = True
    v[:, :6] = [[np.nan, np.inf, -np.inf, 1.0, 2.0, 3.0]] * 2
    c[6:] = np.where(np.isin(c[6:], [5, 6, 7]), 0, c[6:])
    put("nonfinite_groups", v.astype(np.float32), c, m, 8)
    v, c, m = _segsum_case(rng, 100_000, 3, ["float"])
    v[0, 17], m[17] = np.nan, False
    put("masked_nan", v.astype(np.float32), c, m, 3)
    v, c, m = _segsum_case(rng, 50_000, 4, ["float", "float"])
    put("all_masked", v.astype(np.float32), c, np.zeros_like(m), 4)
    put("empty", np.zeros((3, 0), np.float32), np.zeros(0, np.int64),
        np.ones(0, bool), 3)
    v, c, m = _segsum_case(rng, 300_007, 7, ["float", "int", "unit"])
    put("float64", v, c, m, 7)
    # the schedules: one group in every row, 40 groups (more than a lane
    # folds at once), n >= 8 M (ranges capped at ACC_STAGE, many blocks),
    # and 4,000 / 2,600 groups (many group slices over blockIdx.y)
    v, c, m = _segsum_case(rng, 1_000_003, 6, ["float", "int", "unit"])
    put("one_group", v.astype(np.float32), np.full_like(c, 4), m, 6)
    v, c, m = _segsum_case(rng, 1_000_003, 40, ["float", "float", "unit"])
    put("groups_40", v.astype(np.float32), c, m, 40)
    v, c, m = _segsum_case(rng, 8_400_001, 6, ["float", "unit"])
    put("n_8m", v.astype(np.float32), c, m, 6)
    v, c, m = _segsum_case(rng, 1_000_003, 4000, ["float", "float", "unit"])
    put("groups_4000", v.astype(np.float32), c, m, 4000)
    v, c, m = _segsum_case(rng, 1_000_003, 2600, ["float", "int", "unit"])
    put("groups_2600_f64", v, c, m, 2600)

    max_err = 0.0
    for name, (v, c, m, groups) in cases.items():
        run = (gk.segmented_sums_dispatch if v.dtype == torch.float32
               else gk.segmented_sums)
        got = run(v, c, m, groups)
        again = run(v, c, m, groups)
        plain = gk.segmented_sums(v, c, m, groups,
                                  accumulate=gk.segsum_accumulate_plain)
        torch.cuda.synchronize()
        if not _bits_equal(got, again):
            raise AssertionError(f"kernel 2 case {name}: two runs differ")
        if name == "q1_float32" and not _bits_equal(got, path_out):
            raise AssertionError("kernel 2: the path run differs from the check")
        err = _accumulate_check(name, v, c, m, groups, got)
        perr = _accumulate_check(name + " (plain)", v, c, m, groups, plain)
        diff = ((got - plain).to(torch.float64).nan_to_num(0.0).abs().max().item()
                if got.numel() else 0.0)
        max_err = max(max_err, diff)
        print(f"kernel 2 case {name}: {tuple(v.shape)} {str(v.dtype)[6:]} x "
              f"{groups} groups: within the bound (kernel {err:.3g}, plain "
              f"{perr:.3g} from the float64 sum; |kernel - plain| {diff:.3g}), "
              f"deterministic")

    a, n = vals32.shape
    codes32 = codes.to(torch.int32).contiguous()
    mask_u8 = mask.to(torch.uint8).contiguous()
    event_ms = cuda_ms(lambda: gk.segsum_accumulate_cuda(vals32, codes32, mask_u8, g),
                       reps=20)
    ms, ms_source = profiled_ms(
        lambda: gk.segsum_accumulate_cuda(vals32, codes32, mask_u8, g),
        "segsum_", reps=20, fallback=event_ms)
    plain_ms = cuda_ms(lambda: gk.segsum_accumulate_plain(vals32, codes32,
                                                          mask_u8, g), reps=5)
    codes64 = codes.to(torch.int64)
    library_ms = cuda_ms(lambda: torch.zeros(
        (a, g), dtype=torch.float32, device=dev).index_add_(
        1, codes64, torch.where(mask, vals32, 0.0)), reps=20)
    full_ms = cuda_ms(lambda: gk.segmented_sums(vals32, codes, mask, g), reps=10)
    moved = a * n * 4 + n * 4 + n * 1 + a * g * 4 + 3 * a * g * 8
    ops = a * n
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    bound_by = "bytes" if moved / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S \
        else "operations"
    print(f"segsum_accumulate on Q1's reduction in float32 ({a} x {n}, {g} "
          f"groups): kernel {ms:.3f} ms ({ms_source}: device time of both passes; "
          f"event mean over back-to-back calls {event_ms:.3f} ms), plain "
          f"{plain_ms:.3f} ms, float32 "
          f"index_add_ {library_ms:.3f} ms, full segmented_sums {full_ms:.3f} "
          f"ms, bound {bound_ms:.3f} ms ({bound_by}: {moved / 1e9:.3f} GB)")
    return {"name": "segsum_accumulate", "route": "cuda",
            "source": "dask_sql_tpu_torch/csrc/segsum_accumulate.cu",
            "replaces": "dask_sql_tpu/ops/pallas_kernels.py:81",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "event_ms": event_ms,
            "ms_source": ms_source}


def profile_query(ctx, name: str, text: str) -> dict:
    """One warm run under torch.profiler: device time by kernel, and the
    device's busy share of the host wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ctx.sql(text)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile {name}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for e in events[:10]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall}


def host_breakdown(ctx, text: str, reps: int = 3) -> dict:
    """Where one warm query's host time goes, from the median (by wall) of
    ``reps`` runs: the report's planning and execution ms, the ms spent at
    execution time inside the statistics' dispatch decisions
    (``groupby_decision``, ``join_decision``: the latter estimates both
    join inputs' rows), and each plan node's exclusive host ms (its own
    work and the syncs it waits on, its inputs' time excluded) with its
    output rows."""
    from dask_sql_tpu_torch.physical.rel import executor as ex_mod
    from dask_sql_tpu_torch.runtime import statistics as st

    run_node = ex_mod.RelExecutor.execute
    decisions = {n: getattr(st, n) for n in ("groupby_decision",
                                             "join_decision")}
    cur: dict = {}

    def timed_node(self, rel):
        t0 = time.perf_counter()
        cur["stack"].append(0.0)
        try:
            out = run_node(self, rel)
        finally:
            total = (time.perf_counter() - t0) * 1e3
            inner = cur["stack"].pop()
            if cur["stack"]:
                cur["stack"][-1] += total
        label = type(rel).__name__.replace("Logical", "")
        if getattr(rel, "join_type", None):
            label += f"({rel.join_type})"
        cur["nodes"].append([label, round(total - inner, 3), out.num_rows])
        return out

    def timed_decision(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                cur["decide_ms"] += (time.perf_counter() - t0) * 1e3
        return wrapper

    runs = []
    ex_mod.RelExecutor.execute = timed_node
    for name, fn in decisions.items():
        setattr(st, name, timed_decision(fn))
    try:
        for _ in range(reps):
            cur.update(stack=[], nodes=[], decide_ms=0.0)
            wall = wall_ms(lambda: ctx.sql(text))
            phases = ctx.last_report.phases
            runs.append({"wall_ms": wall, "plan_ms": phases["plan"],
                         "execute_ms": phases["execute"],
                         "decide_ms": cur["decide_ms"],
                         "nodes": cur["nodes"]})
    finally:
        ex_mod.RelExecutor.execute = run_node
        for name, fn in decisions.items():
            setattr(st, name, fn)
    runs.sort(key=lambda r: r["wall_ms"])
    return runs[len(runs) // 2]


def register(dev, tables: dict):
    """A Context on ``dev`` with the tables; returns it and the seconds."""
    from dask_sql_tpu_torch import Context

    t0 = time.perf_counter()
    ctx = Context(device=dev)
    for name, cols in tables.items():
        ctx.create_table(name, cols)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return ctx, time.perf_counter() - t0


def _table_bytes(ctx) -> int:
    total = 0
    for entry in ctx.schema["root"].tables.values():
        for c in entry.table.columns:
            total += c.data.numel() * c.data.element_size()
            if c.mask is not None:
                total += c.mask.numel()
    return total


def phase_data(dev, sf: float, seed: int):
    t0 = time.perf_counter()
    tables = generate_tpch(sf, seed)
    rows = {k: len(next(iter(v.values()))) for k, v in tables.items()}
    print(f"TPC-H SF {sf}: {rows} (generated in {time.perf_counter() - t0:.1f} s)")
    ctx, seconds = register(dev, tables)
    print(f"create_table: {seconds:.1f} s, {_table_bytes(ctx) / 1e9:.3f} GB on {dev}")
    return ctx, tables


def variants(ctx) -> dict:
    """The GROUP BY and join variants the context's last query took, from
    its report's telemetry counters: {"join=dense": 4, ...}."""
    prefix = "operator_choice_"
    out = {}
    for key, n in sorted(ctx.last_report.counters.items()):
        if key.startswith(prefix):
            op, _, variant = key[len(prefix):].rpartition("_")
            out[f"{op}={variant}"] = n
    return out


def run_query(ctx, text: str, times: list, runs: list) -> tuple:
    """Runs of ``text`` until ``times`` holds 4 walls (the first cold),
    the launch counts set to 0 before each run and read after it; then the
    variants of the last run and the syncs of one more.  Returns (the last
    run's result, variants, syncs)."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    while len(times) < 4:
        gk.reset_launch_counts()
        box = {}
        times.append(wall_ms(lambda: box.update(r=ctx.sql(text))))
        runs.append(dict(gk.LAUNCHES))
        result = box["r"]
    taken = variants(ctx)
    return result, taken, count_syncs(lambda: ctx.sql(text))


def phase_slice(ctx, tables: dict, q1_cold: tuple, cpu_ctx) -> tuple:
    """The 22 queries through the Context: cold + 3 warm runs each (Q1's
    cold run was the capture run), the launch counts set to 0 before each
    query and read after it, the variants taken, the host synchronisations
    of one more warm run, and the answers checked.  Returns the launches of
    all runs, the per-query rows and the results."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    want = {1: oracle_q1(tables["lineitem"]), 6: oracle_q6(tables["lineitem"])}
    total = {k: 0 for k in gk.LAUNCHES}
    static_queries = []
    rows = []
    results = {}
    for qid in sorted(QUERIES):
        text = QUERIES[qid]
        times, runs = [], []
        if qid == 1:
            times.append(q1_cold[0])
            runs.append(q1_cold[1])
        result, taken, syncs = run_query(ctx, text, times, runs)
        results[qid] = result
        for launches in runs:
            for k, v in launches.items():
                total[k] += v
        launched = {k: v for k, v in runs[-1].items() if v}
        if launched.get("segsum_fixedpoint"):
            static_queries.append(qid)
        checks = []
        if qid in want:
            got = {k: v.tolist() for k, v in result.to_numpy().items()}
            check_answer(f"Q{qid}", got, want[qid])
            checks.append("numpy oracle")
        checks.append(cross_check(qid, text, result, cpu_ctx))
        rows.append({"q": qid, "cold_ms": times[0], "warm_ms": times[1:],
                     "launched": launched, "syncs": syncs,
                     "variants": taken, "rows": result.num_rows})
        print(f"Q{qid}: cold {times[0]:.1f} ms, warm "
              + ", ".join(f"{t:.1f}" for t in times[1:])
              + f" ms; {result.num_rows} rows; launched {launched or 'none'}; "
              f"{syncs} host syncs; variants {taken or '-'}; checked against "
              f"{', '.join(checks) or '-'}")
    if total["segsum_fixedpoint"] < 1:
        raise AssertionError(f"no query launched segsum_fixedpoint: {total}")
    print(f"queries that launched segsum_fixedpoint: {static_queries}")
    print("slice table: " + json.dumps(rows))
    return total, results, {r["q"]: r for r in rows}


def phase_stats(ctx, cpu_ctx) -> None:
    """The statistics collected on the card equal those the CPU collects
    from the same tables, field for field."""
    for name, entry in ctx.schema["root"].tables.items():
        gpu, cpu = entry.stats, cpu_ctx.schema["root"].tables[name].stats
        if gpu is None or cpu is None:
            raise AssertionError(f"stats of {name}: card {gpu}, CPU {cpu}")
        if gpu.rows != cpu.rows or gpu.cols != cpu.cols:
            diff = [c for c in cpu.cols if gpu.cols.get(c) != cpu.cols[c]]
            raise AssertionError(f"stats of {name} differ in {diff}")
        print(f"stats {name}: {gpu.rows} rows, {len(gpu.cols)} columns, "
              f"{gpu.collected_ms:.1f} ms on the card, {cpu.collected_ms:.1f} "
              f"ms on the CPU; equal")
    li = ctx.schema["root"].tables["lineitem"].stats
    print("stats lineitem: " + json.dumps(
        {c: cs.to_row() for c, cs in li.cols.items()}))


def _median(xs: list) -> float:
    return float(np.median(xs))


def phase_adaptive(ctx, on_results: dict) -> dict:
    """The 22 queries with the statistics-driven dispatch on (the default)
    and off (``DSQL_ADAPTIVE=0``), the two modes in turns (on, off, on,
    off, ...) so that both meet the same state of the host: per mode a
    cold run and three warm ones (walls, planning ms from the query's
    report), the launch counts of each run, the variants taken and the
    syncs of one more run; each answer with the dispatch off equal to the
    main path's.  Then Q5, Q9 and Q10 profiled in both modes, each
    query's host time split (``host_breakdown``) in both modes, and Q1 and
    Q3 under each forced GROUP BY variant.  Returns the launches of all runs
    with the dispatch off or forced."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    modes = {"on": None, "off": "0"}

    def set_mode(value):
        if value is None:
            os.environ.pop("DSQL_ADAPTIVE", None)
        else:
            os.environ["DSQL_ADAPTIVE"] = value

    total = {k: 0 for k in gk.LAUNCHES}
    table = []
    try:
        for qid in sorted(QUERIES):
            text = QUERIES[qid]
            row = {"q": qid}
            got = {m: {"walls": [], "plan_ms": [], "launched": {}}
                   for m in modes}
            for _ in range(4):
                for mode, value in modes.items():
                    set_mode(value)
                    gk.reset_launch_counts()
                    box = {}
                    got[mode]["walls"].append(
                        wall_ms(lambda: box.update(r=ctx.sql(text))))
                    got[mode]["plan_ms"].append(ctx.last_report.phases["plan"])
                    got[mode]["launched"] = {k: v for k, v in
                                             gk.LAUNCHES.items() if v}
                    got[mode]["result"] = box["r"]
                    got[mode]["variants"] = variants(ctx)
                    if mode == "off":
                        for k, v in gk.LAUNCHES.items():
                            total[k] += v
            for mode, value in modes.items():
                set_mode(value)
                g = got[mode]
                row[mode] = {"cold_ms": g["walls"][0], "warm_ms": g["walls"][1:],
                             "warm_median_ms": _median(g["walls"][1:]),
                             "plan_median_ms": _median(g["plan_ms"][1:]),
                             "syncs": count_syncs(lambda: ctx.sql(text)),
                             "variants": g["variants"],
                             "launched": g["launched"]}
            check_same_result(f"Q{qid} adaptive off", got["off"]["result"],
                              on_results[qid], rtol=1e-9)
            table.append(row)
            print(f"Q{qid}: warm median on {row['on']['warm_median_ms']:.1f} "
                  f"ms (plan {row['on']['plan_median_ms']:.2f}), off "
                  f"{row['off']['warm_median_ms']:.1f} ms (plan "
                  f"{row['off']['plan_median_ms']:.2f}); syncs on "
                  f"{row['on']['syncs']}, off {row['off']['syncs']}; variants "
                  f"on {row['on']['variants'] or '-'}, off "
                  f"{row['off']['variants'] or '-'}; launched on "
                  f"{row['on']['launched'] or 'none'}, off "
                  f"{row['off']['launched'] or 'none'}; answers equal")
        profiles = {}
        for mode, value in modes.items():
            set_mode(value)
            for q in (5, 9, 10):
                profiles[f"Q{q} {mode}"] = profile_query(
                    ctx, f"Q{q} adaptive {mode}", QUERIES[q])
        breakdown = {}
        for qid in sorted(QUERIES):
            breakdown[qid] = {}
            for mode, value in modes.items():
                set_mode(value)
                b = host_breakdown(ctx, QUERIES[qid])
                if qid not in (9, 10):
                    del b["nodes"]
                breakdown[qid][mode] = b
            on, off = breakdown[qid]["on"], breakdown[qid]["off"]
            print(f"host Q{qid}: on / off wall {on['wall_ms']:.2f} / "
                  f"{off['wall_ms']:.2f} ms, plan {on['plan_ms']:.2f} / "
                  f"{off['plan_ms']:.2f}, execute {on['execute_ms']:.2f} / "
                  f"{off['execute_ms']:.2f}, of it in the dispatch "
                  f"decisions {on['decide_ms']:.3f} / {off['decide_ms']:.3f}")
    finally:
        set_mode(None)
    print("adaptive table: " + json.dumps(table))
    print("adaptive profiles: " + json.dumps(profiles))
    print("host breakdown: " + json.dumps(breakdown))
    for qid in (1, 3):
        for forced in ("hash", "sorted", "dense"):
            os.environ["DSQL_FORCE_GROUPBY"] = forced
            try:
                gk.reset_launch_counts()
                result = ctx.sql(QUERIES[qid])
                launched = {k: v for k, v in gk.LAUNCHES.items() if v}
                taken = variants(ctx)
            finally:
                del os.environ["DSQL_FORCE_GROUPBY"]
            for k, v in launched.items():
                total[k] += v
            check_same_result(f"Q{qid} forced {forced}", result,
                              on_results[qid], rtol=1e-9)
            groupbys = {k: v for k, v in taken.items()
                        if k.startswith("groupby=")}
            # Q1's GROUP BY stays on the static-domain route (kernel 1)
            # whatever is forced; Q3's multi-column keys take the forced
            # codes, "dense" falling through to "sorted"
            want = ({"groupby=static": 1} if qid == 1 else
                    {f"groupby={'sorted' if forced == 'dense' else forced}": 1})
            if groupbys != want or (qid == 1 and launched.get(
                    "segsum_fixedpoint") != 1):
                raise AssertionError(
                    f"Q{qid} with DSQL_FORCE_GROUPBY={forced}: variants "
                    f"{taken}, launched {launched}; expected {want}"
                    + (" and one kernel-1 launch" if qid == 1 else ""))
            print(f"Q{qid} with DSQL_FORCE_GROUPBY={forced}: variants "
                  f"{taken}; launched {launched or 'none'}; equal to the "
                  f"main path's answer")
    return total


def cross_check(qid: int, text: str, result, cpu_ctx) -> str:
    """The query's answer on the card against the port's run on the CPU
    over the same tables."""
    t0 = time.perf_counter()
    check_same_result(f"Q{qid}", result, cpu_ctx.sql(text), rtol=1e-9)
    return f"the CPU run ({time.perf_counter() - t0:.1f} s)"


def phase_oracle(dev, sf: float, seed: int) -> None:
    """The 22 queries, W1-W3 and the part of F1 that sqlite has, at ``sf``
    on the card against sqlite."""
    tables = generate_tpch(sf, seed)
    ctx, _ = register(dev, tables)
    t0 = time.perf_counter()
    conn = load_sqlite(tables)
    print(f"sqlite oracle at SF {sf}: loaded in {time.perf_counter() - t0:.1f} s")
    for qid in sorted(QUERIES):
        t0 = time.perf_counter()
        result = ctx.sql(QUERIES[qid])
        check_sqlite(f"Q{qid}", result, conn.execute(to_sqlite(QUERIES[qid])),
                     "ORDER BY" in QUERIES[qid])
        print(f"oracle Q{qid}: {result.num_rows} rows match sqlite "
              f"({time.perf_counter() - t0:.1f} s)")
    # window sums and averages are differences of one global prefix sum,
    # whose rounding on the card follows its scan order: they are held to
    # 1e-9 of the absolute prefix as well (an average of zeros may be 2e-13)
    li = tables["lineitem"]
    rn = ctx.sql(SURFACE["W1"]).columns[2].data.cpu().numpy()
    window_atol = {
        "W2": {"sq": 1e-9 * _abs_prefix_bound(li, "l_quantity"),
               "ad": 1e-9 * _abs_prefix_bound(li, "l_discount", rn)},
        "W3": {"rs": 1e-9 * _abs_prefix_bound(li, "l_extendedprice")}}
    surface = {name: (SURFACE[name], SURFACE[name], False)
               for name in ("W1", "W2", "W3")}
    surface["F1 (sqlite's part)"] = (F1_SQLITE_PORT, F1_SQLITE_SQLITE, True)
    for name, (ours, theirs, ordered) in surface.items():
        t0 = time.perf_counter()
        result = ctx.sql(ours)
        check_sqlite(name, result, conn.execute(theirs), ordered,
                     window_atol.get(name))
        print(f"oracle {name}: {result.num_rows} rows match sqlite "
              f"({time.perf_counter() - t0:.1f} s)")
    conn.close()


# ---------------------------------------------------------------------------
# phase 12: the compiled tier (one CUDA graph per query plan)
# ---------------------------------------------------------------------------

COMPILED_WARM = 3


def _last_tier(ctx) -> tuple:
    """(tier, the reason of a fallback, the compiled tier's counters) of the
    context's last query, from its report."""
    rep = ctx.last_report
    tier, reason = "eager", ""
    for s in rep.root.walk():
        tier = s.attrs.get("tier", tier)
        reason = (s.attrs.get("compiled_unsupported")
                  or s.attrs.get("compiled_fallback") or reason)
    names = ("compiles", "hits", "unsupported", "fallbacks", "recompiles",
             "graph_captures", "graph_replays", "stage_graphs", "stage_execs",
             "stage_compiles", "stage_hits", "compile_errors",
             "degradations", "param_plan_hits", "param_plan_misses")
    return tier, reason, {k: rep.counters[k] for k in names
                          if rep.counters.get(k)}


def _graph_attrs(ctx) -> dict:
    """The graph attributes on the context's last query report, summed
    over its programs (a stage graph has one per stage): pool, constant
    bytes, warm-up and capture ms."""
    out = {}
    for s in ctx.last_report.root.walk():
        for k, v in s.attrs.items():
            if k.startswith("graph_"):
                out[k[len("graph_"):]] = out.get(k[len("graph_"):], 0) + v
    return out


def sync_sites(fn) -> list:
    """The port's source line (file:line) of each host synchronisation in
    one run of fn(): the Python stack at each
    ``torch.cuda.set_sync_debug_mode("warn")`` warning, innermost frame in
    ``dask_sql_tpu_torch``."""
    import traceback

    sites = []
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "dask_sql_tpu_torch" in f.filename]
        f = frames[-1] if frames else None
        sites.append("?" if f is None else
                     f"{f.filename.split('dask_sql_tpu_torch/')[-1]}:"
                     f"{f.lineno} ({f.name})")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = show
    torch.cuda.synchronize()
    return sites


def _bit_equal_tables(name: str, got, want) -> None:
    if got.names != want.names or got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got} != {want}")
    for col, g, w in zip(want.names, got.columns, want.columns):
        gv, wv = g.to_numpy(), w.to_numpy()
        if gv.dtype.kind == "f":
            same = gv.dtype == wv.dtype and np.array_equal(
                gv.view(np.int64), wv.view(np.int64))
        else:
            same = gv.tolist() == wv.tolist()
        if not same:
            raise AssertionError(f"{name}.{col} is not bit for bit the "
                                 f"answer it is held to")


def _compiled_query(ctx, qid: int, eager_results: dict, eager_rows: dict,
                    total: dict, answers: dict) -> dict:
    """Phase 12 for one query (see ``phase_compiled``); adds its launches
    to ``total``, keeps its answer in ``answers`` and returns its table
    row."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    text = QUERIES[qid]
    box = {}
    gk.reset_launch_counts()
    cold = wall_ms(lambda: box.update(r=ctx.sql(text)))
    tier, reason, counters = _last_tier(ctx)
    capture = _graph_attrs(ctx)
    runs = [dict(gk.LAUNCHES)]
    warm = []
    for _ in range(COMPILED_WARM):
        gk.reset_launch_counts()
        warm.append(wall_ms(lambda: box.update(r=ctx.sql(text))))
        runs.append(dict(gk.LAUNCHES))
    warm_tier, _, warm_counters = _last_tier(ctx)
    sites = sync_sites(lambda: ctx.sql(text))
    syncs = len(sites)
    result = answers[qid] = box["r"]
    for launches in runs:
        for k, v in launches.items():
            total[k] += v
    if qid == 1:
        _bit_equal_tables("Q1 compiled", result, eager_results[1])
    else:
        check_same_result(f"Q{qid} compiled", result, eager_results[qid],
                          rtol=1e-9)
    if tier != "compiled" and "runtime" not in reason:
        raise AssertionError(f"Q{qid} did not compile on the card: "
                             f"{tier}, {reason or counters}")
    k1 = runs[-1].get("segsum_fixedpoint", 0)
    static = bool(eager_rows[qid]["launched"].get("segsum_fixedpoint"))
    if static and warm_tier == "compiled" and k1 != 1:
        raise AssertionError(f"Q{qid}: kernel 1 launched {k1} times per "
                             f"replay, expected 1")
    if warm_tier == "compiled" and not warm_counters.get("graph_replays"):
        raise AssertionError(f"Q{qid}: a warm run replayed no graph: "
                             f"{warm_counters}")
    eager_warm = sorted(eager_rows[qid]["warm_ms"])[1]
    row = {"q": qid, "tier": warm_tier, "reason": reason,
           "cold_ms": cold, "warm_ms": warm,
           "warm_median_ms": sorted(warm)[1], "syncs": syncs,
           "sync_sites": sites,
           "eager_warm_median_ms": eager_warm,
           "eager_syncs": eager_rows[qid]["syncs"],
           "pool_mb": capture.get("pool_bytes", 0) / 2**20,
           "const_mb": capture.get("const_bytes", 0) / 2**20,
           "warmup_ms": capture.get("warmup_ms"),
           "capture_ms": capture.get("capture_ms"),
           "kernel1_per_replay": k1, "cold_counters": counters,
           "warm_counters": warm_counters, "rows": result.num_rows}
    print(f"compiled Q{qid}: {warm_tier}{' (' + reason + ')' if reason else ''}; "
          f"cold {cold:.1f} ms (warm-up {capture.get('warmup_ms', 0):.1f}, "
          f"capture {capture.get('capture_ms', 0):.1f}), warm "
          + ", ".join(f"{t:.2f}" for t in warm)
          + f" ms (eager {eager_warm:.1f}); {syncs} syncs (eager "
          f"{eager_rows[qid]['syncs']}; at {', '.join(sites) or '-'}); "
          f"pool {row['pool_mb']:.1f} MB; "
          f"kernel 1 x{k1} per run; {result.num_rows} rows; equal to "
          f"eager{' bit for bit' if qid == 1 else ''}")
    print("compiled table: " + json.dumps(row))
    return row


def phase_compiled(ctx, eager_results: dict, eager_rows: dict) -> tuple:
    """The 22 queries through the compiled tier (the default path:
    ``DSQL_COMPILE`` unset): per query the tier and any fallback's reason,
    the cold wall (trace, warm-up and capture), the warm walls (graph
    replays), the host syncs of one more warm run, the graph's memory pool
    and kernel 1's launches per replay (the launch counts set to 0 before
    each run and read after it).  Every answer equals phase 7's eager
    answer (doubles rtol 1e-9), Q1's bit for bit; a query that does not
    compile, or a static GROUP BY that compiles without launching kernel 1
    once per replay, fails the phase.  Then Q1 and Q9 profiled, and every
    program dropped.  Returns the launches of all runs, the rows and the
    answers (phase 19 holds its own to them bit for bit)."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk
    from dask_sql_tpu_torch.physical import compiled, graphs

    os.environ.pop("DSQL_COMPILE", None)
    total = {k: 0 for k in gk.LAUNCHES}
    rows = []
    answers = {}
    failures = []
    ladder0 = {k: compiled.stats.get(k, 0)
               for k in ("compile_errors", "degradations")}
    for qid in sorted(QUERIES):
        try:
            rows.append(_compiled_query(ctx, qid, eager_results, eager_rows,
                                        total, answers))
        except Exception as exc:  # reported together after the loop
            import traceback
            traceback.print_exc()
            failures.append(f"Q{qid}: {type(exc).__name__}: {exc}")
            print(f"compiled Q{qid}: FAILED {failures[-1]}")
    ladder = {k: compiled.stats.get(k, 0) - v for k, v in ladder0.items()}
    if any(ladder.values()):
        failures.append(f"the ladder ran: {ladder}")
    if failures:
        raise AssertionError("phase 12: " + "; ".join(failures))
    # the profiler's tracing slows graph replays several-fold, so the idle
    # share is also given against the same query's unprofiled warm median
    profiles = {}
    for q in (1, 9):
        prof = profile_query(ctx, f"compiled Q{q}", QUERIES[q])
        warm_ms = next(r["warm_median_ms"] for r in rows if r["q"] == q)
        prof["unprofiled_warm_ms"] = warm_ms
        prof["idle_vs_unprofiled"] = 1 - prof["busy_ms"] / warm_ms
        print(f"compiled Q{q}: device busy {prof['busy_ms']:.2f} ms of an "
              f"unprofiled warm {warm_ms:.2f} ms: idle "
              f"{100 * prof['idle_vs_unprofiled']:.1f}%")
        profiles[q] = prof
    print("compiled profiles: " + json.dumps(profiles))
    print(f"compiled: {sum(r['tier'] == 'compiled' for r in rows)} of "
          f"{len(rows)} queries compiled; graph pools alive "
          f"{graphs.live_pool_bytes() / 2**20:.1f} MB; counters "
          + json.dumps({k: v for k, v in compiled.stats.items()
                        if k in ("compiles", "hits", "unsupported",
                                 "fallbacks", "recompiles", "graph_captures",
                                 "graph_replays", "stage_graphs",
                                 "stage_compiles", "compile_errors",
                                 "degradations")}))
    forget_programs()
    return total, rows, answers


def forget_programs(learned: bool = False) -> None:
    """Drop every program (and, with ``learned``, the learned capacities
    and verdicts: a fresh process's state) and the cached card memory."""
    from dask_sql_tpu_torch.physical import compiled

    for entry in list(compiled._cache.values()):
        if isinstance(entry, compiled._Compiled):
            entry.fn.release()
    compiled._cache.clear()
    if learned:
        compiled._learned_caps.clear()
        compiled._runtime_eager.clear()
    with compiled._tier_lock:
        compiled._tier_done.clear()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the rest of the compiled tier (parameters, stage graphs,
# tiering, the ladder)
# ---------------------------------------------------------------------------

def _q1_variant(delta: int) -> str:
    day = np.datetime64("1998-12-01") - np.timedelta64(delta, "D")
    return QUERIES[1].replace("DATE '1998-09-02'", f"DATE '{day}'")


def _q6_variant(year: int, discount: float, quantity: int) -> str:
    return (QUERIES[6]
            .replace("DATE '1994-01-01'", f"DATE '{year}-01-01'")
            .replace("DATE '1995-01-01'", f"DATE '{year + 1}-01-01'")
            .replace("BETWEEN 0.05 AND 0.07",
                     f"BETWEEN {discount - 0.01:.2f} AND {discount + 0.01:.2f}")
            .replace("l_quantity < 24", f"l_quantity < {quantity}"))


#: TPC-H's substitution ranges: Q1 DELTA in [60, 120]; Q6 DATE the first of
#: January of 1993-1997, DISCOUNT in [0.02, 0.09], QUANTITY 24 or 25
PARAM_VARIANTS = {
    1: [(f"DELTA={d}", _q1_variant(d)) for d in (60, 75, 90, 105, 120)],
    6: [(f"{y}/{d}/{q}", _q6_variant(y, d, q))
        for y, d, q in ((1993, 0.02, 24), (1994, 0.05, 25), (1995, 0.07, 24),
                        (1996, 0.09, 25), (1997, 0.04, 24))],
}


def _counter_delta(before: dict, names) -> dict:
    from dask_sql_tpu_torch.physical import compiled
    return {k: compiled.stats.get(k, 0) - before.get(k, 0) for k in names}


def _eager_answer(ctx, text: str):
    os.environ["DSQL_COMPILE"] = "0"
    try:
        return ctx.sql(text)
    finally:
        os.environ.pop("DSQL_COMPILE", None)


def phase_params(ctx) -> list:
    """13(a): Q1 and Q6 over five literal sets each.  With parameters (the
    default) each query captures once and replays for every later set;
    kernel 1 launches once per Q1 run.  The same sets with
    ``DSQL_PARAM_PLANS=0`` (one program per set) and eagerly answer alike:
    Q1 bit for bit, Q6 rtol 1e-9."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk
    from dask_sql_tpu_torch.physical import compiled

    names = ("graph_captures", "graph_replays", "compiles", "hits",
             "param_plan_hits", "param_plan_misses")
    rows = []
    for qid, variants in PARAM_VARIANTS.items():
        forget_programs()
        param_runs = []
        for label, text in variants:
            before = dict(compiled.stats)
            gk.reset_launch_counts()
            box = {}
            ms = wall_ms(lambda: box.update(r=ctx.sql(text)))
            param_runs.append((label, ms, _counter_delta(before, names),
                               gk.LAUNCHES["segsum_fixedpoint"], box["r"]))
        os.environ["DSQL_PARAM_PLANS"] = "0"
        try:
            baked = []
            for label, text in variants:
                box = {}
                ms = wall_ms(lambda: box.update(r=ctx.sql(text)))
                baked.append((ms, box["r"]))
        finally:
            os.environ.pop("DSQL_PARAM_PLANS", None)
        captures = sum(r[2]["graph_captures"] for r in param_runs)
        for i, ((label, text), run, (baked_ms, baked_r)) in enumerate(
                zip(variants, param_runs, baked)):
            _, ms, counters, k1, result = run
            eager = _eager_answer(ctx, text)
            if qid == 1:
                _bit_equal_tables(f"Q1 {label} (parameters, baked)", result,
                                  baked_r)
                _bit_equal_tables(f"Q1 {label} (parameters, eager)", result,
                                  eager)
                if k1 != 1:
                    raise AssertionError(f"Q1 {label}: kernel 1 launched {k1} "
                                         "times, expected 1")
            else:
                check_same_result(f"Q6 {label} (parameters, baked)", result,
                                  baked_r, rtol=1e-9)
                check_same_result(f"Q6 {label} (parameters, eager)", result,
                                  eager, rtol=1e-9)
            if i > 0 and (counters["graph_captures"]
                          or counters["graph_replays"] != 1):
                raise AssertionError(f"Q{qid} {label}: {counters}, expected "
                                     "one replay and no capture")
            row = {"q": qid, "variant": label, "wall_ms": ms,
                   "baked_wall_ms": baked_ms,
                   "captures": counters["graph_captures"],
                   "replays": counters["graph_replays"],
                   "kernel1": k1, "counters": counters,
                   "rows": result.num_rows}
            rows.append(row)
            print(f"params Q{qid} {label}: {ms:.2f} ms (baked {baked_ms:.2f} "
                  f"ms), captures {row['captures']}, replays "
                  f"{row['replays']}, kernel 1 x{k1}; equal to the baked "
                  f"literal and eager")
            print("params table: " + json.dumps(row))
        if captures != 1:
            raise AssertionError(f"Q{qid}: {captures} captures over five "
                                 "literal sets, expected 1")
    forget_programs()
    return rows


STAGED = (2, 8, 21)
PADDED = (3, 9, 20)
#: runtime verdicts a stage graph reaches in both packages (ROADMAP Queue
#: 3): Q2's second stage builds its INNER join on the materialized boundary
#: (fewer rows than the aggregate it joins), whose keys repeat, and the
#: non-unique build sends the query to eager; the whole program compiles
KNOWN_STAGE_FALLBACKS = {2: ("runtime flag",
                             "runtime verdict of these tables")}


def _staged_run(ctx, qid: int, env: dict) -> dict:
    """A fresh process's cold run (no programs, no learned capacities) and
    three warm runs of ``qid`` under ``env``; counters of the cold run,
    syncs of one more warm run."""
    from dask_sql_tpu_torch.physical import compiled

    forget_programs(learned=True)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        names = ("stage_graphs", "stage_execs", "stage_compiles", "stage_hits",
                 "compiles", "recompiles", "graph_captures")
        before = dict(compiled.stats)
        box = {}
        cold = wall_ms(lambda: box.update(r=ctx.sql(QUERIES[qid])))
        counters = _counter_delta(before, names)
        warm = [wall_ms(lambda: box.update(r=ctx.sql(QUERIES[qid])))
                for _ in range(3)]
        syncs = count_syncs(lambda: ctx.sql(QUERIES[qid]))
        tier, reason, _ = _last_tier(ctx)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if tier != "compiled" and not (
            counters["stage_graphs"]
            and reason in KNOWN_STAGE_FALLBACKS.get(qid, ())):
        raise AssertionError(f"Q{qid} {env}: {tier} ({reason})")
    return {"tier": tier, "reason": reason, "cold_ms": cold, "warm_ms": warm,
            "warm_median_ms": _median(warm), "syncs": syncs,
            "counters": counters, "result": box["r"]}


def phase_stages(ctx, eager_results: dict) -> list:
    """13(b): Q2, Q8 and Q21 as stage graphs at the default budget, with
    ``DSQL_COMPILE_WORKERS=1`` and 4, against the whole program
    (``DSQL_STAGE_HEAVY=99``) and eager (phase 7); then Q3, Q9 and Q20 at
    ``DSQL_STAGE_HEAVY=1`` against whole: the walls that padded rows and
    materialized boundaries cost (a measurement, not a default).  Each run
    starts as a fresh process would: no programs, no learned caps."""
    rows = []
    configs = {q: {"workers=4": {"DSQL_COMPILE_WORKERS": "4"},
                   "workers=1": {"DSQL_COMPILE_WORKERS": "1"},
                   "whole": {"DSQL_STAGE_HEAVY": "99"}} for q in STAGED}
    for q in PADDED:
        configs[q] = {"budget=1": {"DSQL_STAGE_HEAVY": "1"},
                      "whole": {"DSQL_STAGE_HEAVY": "99"}}
    for qid, runs in configs.items():
        results = {}
        for label, env in runs.items():
            got = _staged_run(ctx, qid, env)
            results[label] = got.pop("result")
            row = {"q": qid, "config": label, **got}
            rows.append(row)
            c = got["counters"]
            print(f"stages Q{qid} {label}: {got['tier']}"
                  + (f" ({got['reason']})" if got["tier"] != "compiled"
                     else "")
                  + f", {c['stage_execs'] or 1} program(s), cold "
                  f"{got['cold_ms']:.1f} ms "
                  f"({c['compiles']} builds, {c['recompiles']} recompiles), "
                  f"warm " + ", ".join(f"{t:.2f}" for t in got["warm_ms"])
                  + f" ms, {got['syncs']} syncs")
            print("stages table: " + json.dumps(row))
        if qid in STAGED and not all(
                r["counters"]["stage_graphs"] for r in rows
                if r["q"] == qid and r["config"] != "whole"):
            raise AssertionError(f"Q{qid} did not stage at the default budget")
        for label, result in results.items():
            check_same_result(f"Q{qid} {label} against whole", result,
                              results["whole"], rtol=1e-9)
            check_same_result(f"Q{qid} {label} against eager", result,
                              eager_results[qid], rtol=1e-9)
        print(f"stages Q{qid}: every configuration equal to the whole "
              "program and to eager")
    forget_programs(learned=True)
    return rows


TIERED_QUERY = 10
EAGER_SIDE_QUERIES = (1, 6, 12, 14)


def phase_tiering(ctx, eager_results: dict) -> dict:
    """13(c): with tiering on (the production default), a cold plan's
    first arrival is answered eager (``eager-compiling``) while its
    program builds on a background thread, and meanwhile another thread
    runs eager queries (their host reads must not disturb the warm-up, nor
    be disturbed by it); once no build is in flight the next arrival is
    ``compiled``.  Answers equal phase 7's; one background build done, no
    background error."""
    from dask_sql_tpu_torch.physical import compiled
    from dask_sql_tpu_torch.physical.rel.executor import RelExecutor
    import threading

    forget_programs(learned=True)
    text = QUERIES[TIERED_QUERY]
    before = dict(compiled.stats)
    os.environ["DSQL_TIERED"] = "1"
    os.environ["DSQL_EAGER_FALLBACK"] = "1"
    side = {"runs": 0, "error": None}
    stop = threading.Event()

    def eager_side():
        try:
            plans = [ctx._get_plan(*_query_of(QUERIES[q]))
                     for q in EAGER_SIDE_QUERIES]
            while not stop.is_set():
                for q, plan in zip(EAGER_SIDE_QUERIES, plans):
                    got = RelExecutor(ctx).execute(plan)
                    check_same_result(f"eager Q{q} beside a build", got,
                                      eager_results[q], rtol=1e-9)
                    side["runs"] += 1
        except Exception as exc:   # reported by the main thread
            side["error"] = exc

    try:
        box = {}
        # a device-wide synchronize while the background build captures
        # would invalidate its capture: the first arrival is timed to its
        # own stream's synchronisation
        first_ms = stream_wall_ms(lambda: box.update(r=ctx.sql(text)))
        first_tier, _, _ = _last_tier(ctx)
        thread = threading.Thread(target=eager_side, name="eager-side")
        thread.start()
        t0 = time.perf_counter()
        while compiled.inflight_background_compiles():
            if time.perf_counter() - t0 > 300:
                raise AssertionError("background compile still running "
                                     "after 300 s")
            time.sleep(0.005)
        build_s = time.perf_counter() - t0
        stop.set()
        thread.join()
        if side["error"] is not None:
            raise side["error"]
        second_ms = wall_ms(lambda: box.update(r2=ctx.sql(text)))
        second_tier, _, _ = _last_tier(ctx)
    finally:
        stop.set()
        os.environ["DSQL_TIERED"] = "0"
        os.environ["DSQL_EAGER_FALLBACK"] = "0"
    counters = _counter_delta(before, ("background_compiles_done",
                                       "background_compile_errors",
                                       "served_eager_while_compiling"))
    for name, result in (("first", box["r"]), ("second", box["r2"])):
        check_same_result(f"Q{TIERED_QUERY} {name} arrival", result,
                          eager_results[TIERED_QUERY], rtol=1e-9)
    row = {"q": TIERED_QUERY, "first_tier": first_tier,
           "first_ms": first_ms, "build_wait_s": build_s,
           "second_tier": second_tier, "second_ms": second_ms,
           "eager_side_runs": side["runs"], "counters": counters}
    print(f"tiering Q{TIERED_QUERY}: first arrival {first_tier} "
          f"{first_ms:.1f} ms; background build done {build_s:.2f} s later "
          f"({side['runs']} eager queries on another thread meanwhile); "
          f"next arrival {second_tier} {second_ms:.1f} ms; {counters}")
    print("tiering table: " + json.dumps(row))
    if (first_tier != "eager-compiling" or second_tier != "compiled"
            or counters["background_compiles_done"] != 1
            or counters["background_compile_errors"]):
        raise AssertionError(f"tiering: {row}")
    forget_programs(learned=True)
    row["device_sync"] = tiering_device_sync(ctx, eager_results)
    forget_programs(learned=True)
    return row


def tiering_device_sync(ctx, eager_results: dict) -> dict:
    """13(c), F12: another thread calls ``torch.cuda.synchronize()`` once
    while the background build's CUDA graph capture is open (the first
    capture attempt waits inside the captured function until the call has
    returned or raised), which invalidates that capture; the build
    captures once more on its own thread (``background_capture_retries``)
    and lands: the next arrival is ``compiled``, equal to phase 7's.  The
    row says whether the sync raised and how many captures were retried."""
    import threading

    from dask_sql_tpu_torch.physical import compiled, graphs
    from dask_sql_tpu_torch.runtime import telemetry as tel

    text = QUERIES[TIERED_QUERY]
    opened, synced = threading.Event(), threading.Event()
    seen = {"sync_error": None, "hooked": 0}
    real = graphs.GraphProgram._capture

    def capture(self, inputs, consts):
        if seen["hooked"]:
            return real(self, inputs, consts)
        seen["hooked"] += 1
        fn = self.fn

        def held(*args):
            opened.set()
            synced.wait(60)
            return fn(*args)

        self.fn = held
        try:
            return real(self, inputs, consts)
        finally:
            self.fn = fn

    def syncer():
        if not opened.wait(300):
            return
        try:
            torch.cuda.synchronize()
        except Exception as exc:   # reported in the row
            seen["sync_error"] = f"{type(exc).__name__}: {str(exc)[:120]}"
        finally:
            synced.set()

    before = dict(compiled.stats)
    retries0 = tel.REGISTRY.counters().get("background_capture_retries", 0)
    os.environ["DSQL_TIERED"] = "1"
    os.environ["DSQL_EAGER_FALLBACK"] = "1"
    graphs.GraphProgram._capture = capture
    thread = threading.Thread(target=syncer, name="device-sync")
    thread.start()
    try:
        box = {}
        first_ms = stream_wall_ms(lambda: box.update(r=ctx.sql(text)))
        first_tier = _last_tier(ctx)[0]
        t0 = time.perf_counter()
        while compiled.inflight_background_compiles():
            if time.perf_counter() - t0 > 300:
                raise AssertionError("background build still running after "
                                     "300 s")
            time.sleep(0.005)
        build_s = time.perf_counter() - t0
    finally:
        synced.set()
        opened.set()
        thread.join()
        graphs.GraphProgram._capture = real
        torch.cuda.synchronize()
    try:
        box["r2"] = ctx.sql(text)
        second_tier = _last_tier(ctx)[0]
    finally:
        os.environ["DSQL_TIERED"] = "0"
        os.environ["DSQL_EAGER_FALLBACK"] = "0"
    counters = _counter_delta(before, ("background_compiles_done",
                                       "background_compile_errors"))
    counters["background_capture_retries"] = (
        tel.REGISTRY.counters().get("background_capture_retries", 0)
        - retries0)
    for name, result in (("first", box["r"]), ("second", box["r2"])):
        check_same_result(f"Q{TIERED_QUERY} {name} arrival beside a sync",
                          result, eager_results[TIERED_QUERY], rtol=1e-9)
    row = {"q": TIERED_QUERY, "first_tier": first_tier,
           "first_ms": first_ms, "build_s": build_s,
           "second_tier": second_tier, "sync_error": seen["sync_error"],
           "counters": counters}
    print("tiering device sync: " + json.dumps(row))
    if (first_tier != "eager-compiling" or second_tier != "compiled"
            or counters["background_compiles_done"] != 1
            or counters["background_compile_errors"]
            or counters["background_capture_retries"] > 1):
        raise AssertionError(f"tiering beside a device-wide sync: {row}")
    return row


def _query_of(text: str) -> tuple:
    from dask_sql_tpu_torch.sql.parser import parse_sql
    return parse_sql(text)[0].query, text


LADDER_QUERY = ("SELECT k, SUM(x) AS s, COUNT(*) AS n FROM lt GROUP BY k "
                "ORDER BY k")
LADDER_ROWS = 1_000_000


def ladder_table(ctx) -> None:
    """The small table of phase 13(d), the same in every process."""
    rng = np.random.default_rng(13)
    ctx.create_table("lt", {"k": rng.integers(0, 1000, LADDER_ROWS),
                            "x": rng.random(LADDER_ROWS)})


def ladder_child(qfile: str, device: str) -> None:
    """The second process of 13(d): the quarantined program's query, run
    with the first process's quarantine file; prints its counters."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.physical import compiled

    os.environ.update({"DSQL_QUARANTINE_FILE": qfile, "DSQL_TIERED": "0",
                       "DSQL_EAGER_FALLBACK": "1"})
    ctx = Context(device=device)
    ladder_table(ctx)
    result = ctx.sql(LADDER_QUERY)
    print(json.dumps({"rows": result.num_rows,
                      "quarantine_skips": compiled.stats.get(
                          "quarantine_skips", 0),
                      "compiles": compiled.stats.get("compiles", 0)}))


def phase_ladder(ctx, eager_results: dict) -> dict:
    """13(d): the compile-error ladder on the card.  An injected transient
    compile fault retries and builds; an injected fatal one is exiled,
    marked in a quarantine file and answered eager, equal to the eager
    answer, and a second process skips its build; an injected transient
    ``stage_exec`` fault replays exactly one stage of Q3 (budget 1, one
    worker); ``timeout=0.001`` on Q9 raises ``DeadlineExceeded``."""
    from dask_sql_tpu_torch.physical import compiled
    from dask_sql_tpu_torch.runtime import faults
    from dask_sql_tpu_torch.runtime.resilience import DeadlineExceeded

    out = {}
    ladder_table(ctx)
    want = _eager_answer(ctx, LADDER_QUERY)
    os.environ["DSQL_RETRY_BASE_MS"] = "1"
    names = ("compile_errors", "retries", "compiles", "degradations",
             "exiled", "quarantine_marks", "quarantine_skips",
             "stage_execs", "stage_replays", "stage_replay_saved_stages",
             "deadline_exceeded")
    try:
        forget_programs(learned=True)
        before = dict(compiled.stats)
        with faults.inject("compile:1"):
            got = ctx.sql(LADDER_QUERY)
        c = _counter_delta(before, names)
        check_same_result("transient compile fault", got, want, rtol=1e-9)
        tier, _, _ = _last_tier(ctx)
        if tier != "compiled" or c["retries"] != 1 or c["compiles"] < 1:
            raise AssertionError(f"transient compile fault: {tier} {c}")
        out["transient"] = c
        print(f"ladder: transient compile fault retried and built ({c})")

        forget_programs(learned=True)
        qfile = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "quarantine.json")
        os.makedirs(os.path.dirname(qfile), exist_ok=True)
        if os.path.exists(qfile):
            os.unlink(qfile)
        os.environ["DSQL_QUARANTINE_FILE"] = qfile
        os.environ["DSQL_EAGER_FALLBACK"] = "1"
        before = dict(compiled.stats)
        with faults.inject("compile:1+:fatal"):
            got = ctx.sql(LADDER_QUERY)
        c = _counter_delta(before, names)
        tier, _, _ = _last_tier(ctx)
        check_same_result("fatal compile fault", got, want, rtol=1e-9)
        if tier != "eager" or c["exiled"] != 1 or c["quarantine_marks"] != 1:
            raise AssertionError(f"fatal compile fault: {tier} {c}")
        child = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.ladder_child({qfile!r}, "
             f"{str(ctx.device)!r})"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            raise AssertionError(f"quarantine child failed: {child.stderr}")
        seen = json.loads(child.stdout.strip().splitlines()[-1])
        if (seen["quarantine_skips"] != 1 or seen["compiles"] != 0
                or seen["rows"] != want.num_rows):
            raise AssertionError(f"the second process did not skip: {seen}")
        out["fatal"] = {**c, "second_process": seen}
        print(f"ladder: fatal compile fault exiled, marked and answered "
              f"eager ({c}); a second process skipped its build ({seen})")
    finally:
        os.environ.pop("DSQL_QUARANTINE_FILE", None)
        os.environ["DSQL_EAGER_FALLBACK"] = "0"

    forget_programs(learned=True)
    os.environ.update({"DSQL_STAGE_HEAVY": "1", "DSQL_COMPILE_WORKERS": "1"})
    try:
        before = dict(compiled.stats)
        with faults.inject("stage_exec:2"):
            got = ctx.sql(QUERIES[3])
        c = _counter_delta(before, names)
    finally:
        os.environ.pop("DSQL_STAGE_HEAVY", None)
        os.environ.pop("DSQL_COMPILE_WORKERS", None)
        os.environ.pop("DSQL_RETRY_BASE_MS", None)
    check_same_result("Q3 after a stage replay", got, eager_results[3],
                      rtol=1e-9)
    if (c["stage_replays"] != 1 or c["stage_replay_saved_stages"] != 1
            or c["degradations"]):
        raise AssertionError(f"stage replay: {c}")
    out["stage_replay"] = c
    print(f"ladder: a transient stage_exec fault replayed one stage of Q3 "
          f"({c['stage_execs'] - 1} stages, {c['stage_execs']} executions)")

    try:
        ctx.sql(QUERIES[9], timeout=0.001)
    except DeadlineExceeded as exc:
        out["deadline"] = str(exc)
        print(f"ladder: Q9 with timeout=0.001 raised DeadlineExceeded ({exc})")
    else:
        raise AssertionError("Q9 with timeout=0.001 did not raise")
    forget_programs(learned=True)
    print("ladder table: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 10: the SQL surface beyond TPC-H's operators
# ---------------------------------------------------------------------------

_OVER = "PARTITION BY l_suppkey ORDER BY l_shipdate, l_orderkey, l_linenumber"
_BY_KEY = "PARTITION BY l_suppkey ORDER BY l_orderkey, l_linenumber"
SURFACE = {
    "W1": f"SELECT l_orderkey, l_linenumber, ROW_NUMBER() OVER ({_OVER}) AS rn, "
          f"RANK() OVER ({_OVER}) AS rk, DENSE_RANK() OVER ({_OVER}) AS dr, "
          f"NTILE(4) OVER ({_OVER}) AS nt FROM lineitem",
    "W2": f"SELECT l_orderkey, l_linenumber, SUM(l_quantity) OVER ({_OVER} ROWS "
          f"BETWEEN 6 PRECEDING AND CURRENT ROW) AS sq, MIN(l_extendedprice) OVER "
          f"({_OVER} ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING) AS mn, "
          f"MAX(l_extendedprice) OVER ({_OVER} ROWS BETWEEN 3 PRECEDING AND 3 "
          f"FOLLOWING) AS mx, AVG(l_discount) OVER ({_OVER}) AS ad, "
          f"LAG(l_extendedprice, 2) OVER ({_OVER}) AS lg, LEAD(l_shipdate) OVER "
          f"({_OVER}) AS ld FROM lineitem",
    "W3": "SELECT l_orderkey, l_linenumber, SUM(l_extendedprice) OVER (PARTITION "
          "BY l_suppkey ORDER BY l_orderkey RANGE BETWEEN 1000 PRECEDING AND "
          f"CURRENT ROW) AS rs, FIRST_VALUE(l_shipmode) OVER ({_BY_KEY}) AS fv, "
          f"LAST_VALUE(l_shipmode) OVER ({_BY_KEY}) AS lv, CUME_DIST() OVER "
          f"({_BY_KEY}) AS cd, COUNT(*) OVER (PARTITION BY l_returnflag) AS nrf "
          "FROM lineitem",
    "F1": "SELECT l_returnflag, l_linestatus, "
          "SUM(ROUND(l_extendedprice * (1 - l_discount), 2)) AS sum_round, "
          "SUM(SQRT(l_extendedprice)) AS sum_sqrt, AVG(LN(l_quantity)) AS avg_ln, "
          "SUM(POWER(l_quantity, 2)) AS sum_pow, "
          "SUM(SIGN(l_discount - 0.05)) AS sum_sign, "
          "SUM(FLOOR(l_tax * 100) + CEIL(l_discount * 100)) AS sum_floor_ceil, "
          "SUM(EXTRACT(DAY FROM l_shipdate - FLOOR(l_shipdate TO MONTH))) "
          "AS sum_days_in_month, "
          "SUM(GREATEST(l_quantity, 25) - LEAST(l_tax * 100, 4)) AS sum_greatest_least, "
          "AVG(NULLIF(l_discount, 0)) AS avg_nullif, "
          "SUM(CASE WHEN l_shipmode IS DISTINCT FROM 'AIR' THEN 1 ELSE 0 END) "
          "AS n_not_air, "
          "SUM(CHAR_LENGTH(UPPER(c_name) || '-x')) AS len_concat, "
          "SUM(CHAR_LENGTH(LOWER(p_name))) AS len_lower, "
          "SUM(POSITION('BLUE' IN UPPER(p_name))) AS pos_blue, "
          "SUM(CHAR_LENGTH(TRIM(p_name))) AS len_trim, "
          "SUM(CHAR_LENGTH(REPLACE(c_phone, '-', ''))) AS len_replace, "
          "SUM(CHAR_LENGTH(LPAD(p_name, 20, '*'))) AS len_lpad, "
          "SUM(CAST(SPLIT_PART(c_phone, '-', 1) AS INTEGER)) AS sum_country, "
          "COUNT(*) AS n "
          "FROM lineitem, orders, customer, part WHERE l_orderkey = o_orderkey "
          "AND o_custkey = c_custkey AND l_partkey = p_partkey "
          "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus",
}
# the part of F1 that sqlite has (no math functions, dates or padding), as
# the port reads it and as sqlite does
F1_SQLITE = (
    "SELECT l_returnflag, l_linestatus, "
    "SUM(ROUND(l_extendedprice * (1 - l_discount), 2)) AS sum_round, "
    "SUM({greatest}(l_quantity, 25) - {least}(l_tax * 100, 4)) AS sum_greatest_least, "
    "AVG(NULLIF(l_discount, 0)) AS avg_nullif, "
    "SUM(CASE WHEN l_shipmode {distinct} 'AIR' THEN 1 ELSE 0 END) AS n_not_air, "
    "SUM({length}(UPPER(c_name) || '-x')) AS len_concat, "
    "SUM({length}(LOWER(p_name))) AS len_lower, "
    "SUM({position}) AS pos_blue, "
    "SUM({length}(TRIM(p_name))) AS len_trim, "
    "SUM({length}(REPLACE(c_phone, '-', ''))) AS len_replace, COUNT(*) AS n "
    "FROM lineitem, orders, customer, part WHERE l_orderkey = o_orderkey "
    "AND o_custkey = c_custkey AND l_partkey = p_partkey "
    "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus")
F1_SQLITE_PORT = F1_SQLITE.format(
    greatest="GREATEST", least="LEAST", distinct="IS DISTINCT FROM",
    length="CHAR_LENGTH", position="POSITION('BLUE' IN UPPER(p_name))")
F1_SQLITE_SQLITE = F1_SQLITE.format(
    greatest="MAX", least="MIN", distinct="IS NOT", length="LENGTH",
    position="INSTR(UPPER(p_name), 'BLUE')")

# one SQL expression per key of OPERATION_MAPPING, over the table FX_ROWS
# builds (SEARCH, which only the native optimizer emits, is evaluated from
# its RexCall)
FUNCTION_SQL = {
    "AND": "b AND (i > 0)", "OR": "b OR (i > 0)", "NOT": "NOT b",
    "=": "i = k", "<>": "s <> 'date'", "<": "f < 1.5",
    "<=": "CAST(ts AS DATE) <= DATE '1997-01-01'", ">": "s > 'c'", ">=": "ts >= d",
    "+": "i + k", "-": "ts - INTERVAL '1' DAY", "*": "f * 2.5", "/": "i / k",
    "%": "i % 3", "MOD": "MOD(i, k)", "NEGATE": "-f",
    "IS_NULL": "s IS NULL", "IS_NOT_NULL": "i IS NOT NULL",
    "IS_TRUE": "b IS TRUE", "IS_NOT_TRUE": "b IS NOT TRUE",
    "IS_FALSE": "b IS FALSE", "IS_NOT_FALSE": "b IS NOT FALSE",
    "IS_DISTINCT_FROM": "i IS DISTINCT FROM k",
    "IS_NOT_DISTINCT_FROM": "s IS NOT DISTINCT FROM 'date'",
    "CASE": "CASE WHEN f > 0 THEN 'pos' WHEN f < 0 THEN 'neg' END",
    "COALESCE": "COALESCE(i, k, 0)", "IFNULL": "IFNULL(f, 0.0)",
    "NVL": "NVL(s, 'none')", "NULLIF": "NULLIF(i, 0)",
    "GREATEST": "GREATEST(i, k, 0)", "LEAST": "LEAST(s, 'm')",
    "IN_LIST": "k IN (1, 3, 5)",
    "LIKE": "s LIKE '%a%'", "ILIKE": "s ILIKE 'A%'",
    "SIMILAR": "s SIMILAR TO '(a|d)%'",
    "ABS": "ABS(i)", "SQRT": "SQRT(p)", "EXP": "EXP(u)", "LN": "LN(p)",
    "LOG10": "LOG10(p)", "LOG": "LOG(2.0, p)", "POWER": "POWER(i, k)",
    "POW": "POW(p, 0.5)", "SIN": "SIN(f)", "COS": "COS(f)", "TAN": "TAN(f)",
    "ASIN": "ASIN(u)", "ACOS": "ACOS(u)", "ATAN": "ATAN(f)",
    "ATAN2": "ATAN2(f, p)", "SINH": "SINH(u)", "COSH": "COSH(u)",
    "TANH": "TANH(f)", "COT": "COT(p)", "DEGREES": "DEGREES(f)",
    "RADIANS": "RADIANS(f)", "SIGN": "SIGN(f)", "CBRT": "CBRT(f)",
    "ROUND": "ROUND(f, 1)", "TRUNCATE": "TRUNCATE(f, 1)", "PI": "PI()",
    "FLOOR": "FLOOR(ts TO MONTH)", "CEIL": "CEIL(f)",
    "CEILING": "CEILING(CAST(ts AS DATE) TO YEAR)",
    "RAND": "RAND(7)", "RANDOM": "RANDOM()", "RAND_INTEGER": "RAND_INTEGER(7, 10)",
    "||": "s || '!'", "CONCAT": "CONCAT(s, '-', s)", "UPPER": "UPPER(s)",
    "LOWER": "LOWER(s)", "INITCAP": "INITCAP(s)", "REVERSE": "REVERSE(s)",
    "CHAR_LENGTH": "CHAR_LENGTH(s)", "CHARACTER_LENGTH": "CHARACTER_LENGTH(s)",
    "LENGTH": "LENGTH(s)", "OCTET_LENGTH": "OCTET_LENGTH(s)", "ASCII": "ASCII(s)",
    "CHR": "CHR(k + 65)", "SUBSTRING": "SUBSTRING(s FROM 2 FOR 3)",
    "SUBSTR": "SUBSTR(s, 2)", "TRIM": "TRIM(BOTH 'a' FROM s)",
    "LTRIM": "LTRIM(s)", "RTRIM": "RTRIM(s)", "BTRIM": "BTRIM(s, 'a')",
    "POSITION": "POSITION('a' IN s)", "STRPOS": "STRPOS(s, 'e')",
    "OVERLAY": "OVERLAY(s PLACING 'XY' FROM 2 FOR 1)",
    "REPLACE": "REPLACE(s, 'a', 'o')", "REPEAT": "REPEAT(s, 2)",
    "LEFT": "LEFT(s, 3)", "RIGHT": "RIGHT(s, 2)", "LPAD": "LPAD(s, 8, '*')",
    "RPAD": "RPAD(s, 8, '*')", "SPLIT_PART": "SPLIT_PART(s, ' ', 1)",
    "TRANSLATE": "TRANSLATE(s, 'ae', 'AE')",
    "REGEXP_REPLACE": "REGEXP_REPLACE(s, 'a+', '_')",
    "EXTRACT": "EXTRACT(DOY FROM ts)", "YEAR": "YEAR(ts)", "MONTH": "MONTH(ts)",
    "DAY": "DAY(ts)", "HOUR": "HOUR(ts)", "MINUTE": "MINUTE(ts)",
    "SECOND": "SECOND(ts)", "QUARTER": "QUARTER(ts)", "DAYOFWEEK": "DAYOFWEEK(ts)",
    "DAYOFMONTH": "DAYOFMONTH(ts)", "DAYOFYEAR": "DAYOFYEAR(ts)", "WEEK": "WEEK(ts)",
}
FX_ROWS = 100_000
RANDOM_KEYS = ("RAND", "RANDOM", "RAND_INTEGER")


def function_table(n: int, seed: int) -> dict:
    """The columns FUNCTION_SQL reads: ints, doubles, a boolean, strings
    and timestamps, NULLs in i, f, b and s."""
    rng = np.random.RandomState(seed)

    def nulls(values, share):
        out = values.astype(object)
        out[rng.rand(n) < share] = None
        return out

    words = np.array(["apple pie", "Banana", "  cherry  ", "date", "",
                      "a%b c", "x_y z", "Éclair", "dark ale"], dtype=object)
    days = rng.randint(9000, 11000, n)
    return {
        "i": nulls(rng.randint(-20, 20, n), 0.1), "k": rng.randint(-3, 6, n),
        "f": nulls(np.round(rng.randn(n) * 10, 3), 0.1),
        "p": np.abs(rng.randn(n)) * 5 + 0.1, "u": rng.uniform(-0.99, 0.99, n),
        "b": nulls(rng.rand(n) < 0.5, 0.1), "s": nulls(rng.choice(words, n), 0.1),
        "ts": _dates(days) + rng.randint(0, 86_400, n).astype("timedelta64[s]"),
        "d": _dates(days + rng.randint(-5, 5, n)),
    }


def phase_functions(dev, seed: int) -> dict:
    """Every key of OPERATION_MAPPING through Context.sql on the card over
    FX_ROWS rows, each answer held to the port's CPU run over the same
    table (ints, booleans, dates and strings exact, doubles rtol 1e-13: the
    card's and the CPU's math libraries differ by an ulp or two).  RAND,
    RANDOM and RAND_INTEGER are left out of the CPU cross-check (the card's
    generator draws another stream): they are held to their range, and a
    seed to its own values on a second run.  SEARCH, which only the native
    optimizer emits, is evaluated from its RexCall.  Returns the keys'
    warm ms on the card."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.physical.rex.evaluate import evaluate_rex
    from dask_sql_tpu_torch.plan.nodes import RexCall, RexInputRef, RexLiteral
    from dask_sql_tpu_torch.types import BOOLEAN, SqlType

    data = function_table(FX_ROWS, seed)
    card, cpu = Context(device=dev), Context(device=torch.device("cpu"))
    for c in (card, cpu):
        c.create_table("fx", data)
    walls = {}
    for key, expr in FUNCTION_SQL.items():
        text = f"SELECT {expr} AS r FROM fx"
        got = card.sql(text)
        walls[key] = wall_ms(lambda: card.sql(text))
        if key in RANDOM_KEYS:
            vals = got.columns[0].data
            hi = 10 if key == "RAND_INTEGER" else 1.0
            if not (bool((vals >= 0).all()) and bool((vals < hi).all())):
                raise AssertionError(f"{key}: values outside [0, {hi})")
            if "7" in expr and not torch.equal(vals, card.sql(text).columns[0].data):
                raise AssertionError(f"{key}: a seed drew two streams")
            continue
        check_tensors(key, got, cpu.sql(text), 1e-13)
    ranges = [(0, False, 5, True), (10, True, None, False)]
    search = RexCall("SEARCH", [RexInputRef(0, SqlType("BIGINT")),
                                RexLiteral(ranges, SqlType("ANY"))], BOOLEAN)
    tables = [c.schema["root"].tables["fx"].table for c in (card, cpu)]
    got, want = (evaluate_rex(search, t.limit_to(["i"])) for t in tables)
    if not torch.equal(got.data.cpu() & got.valid_mask().cpu(),
                       want.data & want.valid_mask()):
        raise AssertionError("SEARCH differs")
    print(f"functions: {len(FUNCTION_SQL) + 1} keys on the card over {FX_ROWS} "
          f"rows, equal to the CPU run (RAND, RANDOM, RAND_INTEGER by their "
          f"range and seed); warm ms per key " + json.dumps(walls))
    return walls


CLIFF_ROWS, CLIFF_DISTINCT = 2_000_000, 1_000_000
CLIFF = {
    "S1_not_like": ("LIKE", "%special%requests%", True),
    "S1_ilike": ("ILIKE", "%SPECIAL%", False),
    "S1_prefix": ("LIKE", "special%", False),
    "S1_underscore": ("LIKE", "special _equests%", False),
}


def _make_comments(n_rows: int, n_distinct: int, seed: int = 0) -> np.ndarray:
    """The comment column of ``benchmarks/string_cliff.py`` (a copy: that
    module's ``main`` imports the JAX package)."""
    rng = np.random.RandomState(seed)
    words = np.array(["special", "requests", "pending", "furious", "ironic",
                      "deposits", "accounts", "packages", "theodolites"])
    parts = words[rng.randint(0, len(words), (n_distinct, 4))]
    distinct = np.array([" ".join(row) + f" #{i}"
                         for i, row in enumerate(parts)], dtype=object)
    return distinct[rng.randint(0, n_distinct, n_rows)]


def _abs_prefix_bound(li: dict, col: str, counts=None) -> np.ndarray:
    """Per row, the magnitude a window SUM over ``PARTITION BY l_suppkey``
    is rounded at: the one global prefix sum of |x| (partitions in key
    order) at the end of the row's partition, divided by the frame's row
    count for an average."""
    supp = li["l_suppkey"]
    totals = np.bincount(supp, weights=np.abs(li[col]))
    bound = np.cumsum(totals)[supp]
    return bound if counts is None else bound / counts


def check_tensors(name: str, got, want, rtol: float, atol=None) -> None:
    """Two results of one query compared as tensors: names, rows and NULLs
    equal; strings by their codes when both use one dictionary; ints,
    booleans and dates exact; doubles within ``rtol`` of the value plus a
    per-row ``atol`` (a float array, or {column: array})."""
    if got.names != want.names or got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got} != {want}")
    for col, g, w in zip(want.names, got.columns, want.columns):
        gm, wm = g.valid_mask().cpu(), w.valid_mask().cpu()
        if not torch.equal(gm, wm):
            raise AssertionError(f"{name}.{col}: NULLs differ")
        gd, wd = g.data.cpu()[wm], w.data.cpu()[wm]
        if g.stype.is_string:
            same = (torch.equal(gd, wd) if g.dictionary is w.dictionary
                    else g.to_numpy().tolist() == w.to_numpy().tolist())
            if not same:
                raise AssertionError(f"{name}.{col}: strings differ")
        elif wd.dtype.is_floating_point:
            extra = 0.0
            if isinstance(atol, dict) and col in atol:
                extra = torch.from_numpy(np.asarray(atol[col]))[wm]
            tol = rtol * wd.abs() + extra
            bad = ~(((gd - wd).abs() <= tol) | (gd == wd)
                    | (gd.isnan() & wd.isnan()))
            if bool(bad.any()):
                i = int(bad.nonzero()[0])
                raise AssertionError(f"{name}.{col}: {float(gd[i])} != "
                                     f"{float(wd[i])} (tolerance {float(tol[i])})")
        elif not torch.equal(gd, wd):
            raise AssertionError(f"{name}.{col} differs")


def phase_surface(ctx, tables: dict) -> list:
    """W1-W3 and F1 through the Context on the card: a cold and three warm
    runs, the launch counts set to 0 before each run and read after it, the
    host synchronisations of one more run, and the answer held to the same
    query run by the port on the CPU over the same tables (ints and strings
    exact, doubles rtol 1e-9; window sums and averages within 1e-9 of the
    absolute prefix they are rounded at, as well).  F1 must take the static
    route with one kernel-1 launch per run.  W2 is profiled once, and F1's
    host time split by plan node."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    cpu_ctx = Context(device=torch.device("cpu"))
    for name in ("lineitem", "orders", "customer", "part"):
        cpu_ctx.create_table(name, ctx.schema["root"].tables[name].table)
    li = tables["lineitem"]
    rows, cpu_results = [], {}
    for name, text in SURFACE.items():
        times, runs = [], []
        result, taken, syncs = run_query(ctx, text, times, runs)
        t0 = time.perf_counter()
        want = cpu_ctx.sql(text)
        cpu_s = time.perf_counter() - t0
        cpu_results[name] = want
        atol = None
        if name == "W2":
            rn = cpu_results["W1"].columns[2].data.numpy()
            atol = {"sq": 1e-9 * _abs_prefix_bound(li, "l_quantity"),
                    "ad": 1e-9 * _abs_prefix_bound(li, "l_discount", rn)}
        elif name == "W3":
            atol = {"rs": 1e-9 * _abs_prefix_bound(li, "l_extendedprice")}
        check_tensors(name, result, want, 1e-9, atol)
        launched = [{k: v for k, v in r.items() if v} for r in runs]
        if name == "F1" and any(r != {"segsum_fixedpoint": 1} for r in launched):
            raise AssertionError(f"F1 must launch kernel 1 once per run: {launched}")
        row = {"query": name, "cold_ms": times[0], "warm_ms": times[1:],
               "syncs": syncs, "rows": result.num_rows,
               "launched": launched[-1], "variants": taken,
               "cpu_rerun_s": cpu_s}
        if name == "W2":
            prof = profile_query(ctx, "W2", text)
            row["device_busy_ms"], row["device_idle"] = prof["busy_ms"], prof["idle"]
        if name == "F1":
            # the host's per-dictionary-entry string work sits in Project
            row["host"] = host_breakdown(ctx, text)
            print("host F1: " + json.dumps(row["host"]))
        rows.append(row)
        print(f"{name}: cold {times[0]:.1f} ms, warm "
              + ", ".join(f"{t:.1f}" for t in times[1:])
              + f" ms; {result.num_rows} rows; {syncs} host syncs; launched "
              f"{launched[-1] or 'none'}; equal to the CPU run ({cpu_s:.1f} s)")
    return rows


def _regex_entries(kind: str, pattern: str, d: np.ndarray) -> np.ndarray:
    from dask_sql_tpu_torch.physical.rex.ops import sql_like_to_regex

    rx = re.compile(sql_like_to_regex(pattern),
                    re.IGNORECASE if kind == "ILIKE" else 0)
    return np.array([rx.match(x) is not None for x in d.tolist()], dtype=bool)


def phase_cliff(dev, seed: int) -> list:
    """S1, LIKE over a large dictionary: 2,000,000 rows of 1,000,000
    distinct comments (``benchmarks/string_cliff.py``'s column).  Each query
    a cold and three warm runs by the default route (the device bitmap, or
    regex for a ``_`` pattern; ``stats`` counts each), its answer equal to a
    numpy count over the regex bitmap, and the device bitmap equal to the
    regex bitmap bit for bit; then NOT LIKE's warm wall under each strategy
    forced (device, vectorized, regex) and one profiled run."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.ops import strings_fast as sf

    t0 = time.perf_counter()
    comments = _make_comments(CLIFF_ROWS, CLIFF_DISTINCT, seed)
    ctx = Context(device=dev)
    ctx.create_table("t", {"c": comments})
    col = ctx.schema["root"].tables["t"].table.columns[0]
    dct, codes = col.dictionary, col.data.cpu().numpy()
    print(f"S1: {CLIFF_ROWS} rows, {len(dct)} distinct comments "
          f"(threshold {sf.DEVICE_STRING_THRESHOLD}); built in "
          f"{time.perf_counter() - t0:.1f} s")
    rows = []
    for name, (kind, pattern, negated) in CLIFF.items():
        text = (f"SELECT COUNT(*) AS n FROM t WHERE c {'NOT ' if negated else ''}"
                f"{kind} '{pattern}'")
        entries = _regex_entries(kind, pattern, dct.astype(str))
        want = int((entries[codes] != negated).sum())
        before = dict(sf.stats)
        times, runs = [], []
        result, _, syncs = run_query(ctx, text, times, runs)
        counted = {k: sf.stats[k] - before[k] for k in sf.stats}
        got = int(result.columns[0].data[0])
        if got != want:
            raise AssertionError(f"{name}: {got} rows, numpy over regex {want}")
        route = "regex_bitmaps" if "_" in pattern else "device_bitmaps"
        if counted[route] != 5 or sum(counted.values()) != 5:
            raise AssertionError(f"{name}: strategies counted {counted}")
        row = {"query": name, "cold_ms": times[0], "warm_ms": times[1:],
               "syncs": syncs, "rows": CLIFF_ROWS, "answer": got,
               "route": route, "launched": {k: v for k, v in runs[-1].items() if v}}
        if route == "device_bitmaps":
            bitmap = sf.device_like_bitmap(dct, pattern, None, kind, dev)
            if not np.array_equal(bitmap.cpu().numpy(), entries):
                raise AssertionError(f"{name}: device bitmap != regex bitmap")
        else:
            if sf.device_like_bitmap(dct, pattern, None, kind, dev) is not None:
                raise AssertionError(f"{name}: the device took a '_' pattern")
        rows.append(row)
        print(f"{name}: {got} rows match; cold {times[0]:.1f} ms, warm "
              + ", ".join(f"{t:.1f}" for t in times[1:])
              + f" ms; {syncs} host syncs; by {route}")
    mat, lens, _ = sf._bytes_matrix(dct, dev)
    matrix_bytes = mat.numel() * mat.element_size() + lens.numel() * 4
    text = ("SELECT COUNT(*) AS n FROM t WHERE c NOT LIKE '%special%requests%'")
    saved = (sf.DEVICE_STRING_THRESHOLD, sf.like_bitmap_vectorized)
    strategies = {}
    try:
        for strategy in ("device", "vectorized", "regex"):
            sf.DEVICE_STRING_THRESHOLD = 0 if strategy == "device" else 1 << 62
            if strategy == "regex":
                sf.like_bitmap_vectorized = lambda *a: None
            ctx.sql(text)
            walls = [wall_ms(lambda: ctx.sql(text)) for _ in range(3)]
            strategies[strategy] = {"warm_ms": walls,
                                    "warm_median_ms": _median(walls)}
            sf.DEVICE_STRING_THRESHOLD, sf.like_bitmap_vectorized = saved
    finally:
        sf.DEVICE_STRING_THRESHOLD, sf.like_bitmap_vectorized = saved
    prof = profile_query(ctx, "S1_not_like", text)
    rows[0].update(strategies=strategies, matrix_bytes=matrix_bytes,
                   device_busy_ms=prof["busy_ms"], device_idle=prof["idle"])
    print(f"S1 strategies (NOT LIKE, warm medians): "
          + ", ".join(f"{k} {v['warm_median_ms']:.1f} ms"
                      for k, v in strategies.items())
          + f"; bytes matrix {mat.shape[0]} x {mat.shape[1]} on the card "
          f"({matrix_bytes / 1e6:.1f} MB)")
    return rows


# ---------------------------------------------------------------------------
# phase 11: the front end and the statement layer
# ---------------------------------------------------------------------------

FRONTEND_REPS = 5

# F5's fractional RANGE offsets and F6's LAG / LEAD defaults over lineitem
FRONTEND_WINDOWS = (
    "SELECT l_orderkey, l_linenumber, COUNT(*) OVER (PARTITION BY l_suppkey "
    "ORDER BY l_quantity RANGE BETWEEN 0.5 PRECEDING AND CURRENT ROW) AS c_half, "
    "SUM(l_quantity) OVER (PARTITION BY l_suppkey ORDER BY l_quantity RANGE "
    "BETWEEN 1.5 PRECEDING AND 0.25 FOLLOWING) AS s_mixed, "
    "LAG(l_linenumber, 1, -1) OVER (PARTITION BY l_orderkey ORDER BY "
    "l_linenumber) AS lag_d, LEAD(l_shipmode, 2, 'dflt') OVER (PARTITION BY "
    "l_orderkey ORDER BY l_linenumber) AS lead_d FROM lineitem")

Q6_PREPARE = (
    "PREPARE q6 AS SELECT SUM(l_extendedprice * l_discount) AS revenue "
    "FROM lineitem WHERE l_shipdate >= DATE '1994-01-01' "
    "AND l_shipdate < DATE '1995-01-01' AND l_discount BETWEEN ? AND ? "
    "AND l_quantity < ?")
Q6_INLINE = (
    "SELECT SUM(l_extendedprice * l_discount) AS revenue FROM lineitem "
    "WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < DATE '1995-01-01' "
    "AND l_discount BETWEEN {} AND {} AND l_quantity < {}")


def _walls_by_front_end(ctx, text: str) -> dict:
    """Warm walls of ``Context.sql(text)`` with the native front end and
    with ``DSQL_NATIVE=0`` (the Python parser and pipeline), in turns, and
    the garbage collector's generation-2 passes during each mode's runs."""
    walls = {"native": [], "python": []}
    gc2 = {"native": 0, "python": 0}
    for _ in range(FRONTEND_REPS):
        for mode in walls:
            if mode == "python":
                os.environ["DSQL_NATIVE"] = "0"
            try:
                before = gc.get_stats()[2]["collections"]
                walls[mode].append(wall_ms(lambda: ctx.sql(text)))
                gc2[mode] += gc.get_stats()[2]["collections"] - before
            finally:
                os.environ.pop("DSQL_NATIVE", None)
    return {"wall_native_ms": _median(walls["native"]),
            "wall_python_ms": _median(walls["python"]),
            "gc2_native": gc2["native"], "gc2_python": gc2["python"]}


def phase_frontend(ctx) -> list:
    """Q1-Q22 planned by the native front end and by the Python parser and
    pipeline, in turns; EXPLAIN texts equal; per query the plan-ms medians
    of both paths, of the native C++ calls and of the statistics
    post-pass; then each query's warm wall by either front end, in turns
    (``_walls_by_front_end``)."""
    from dask_sql_tpu_torch import native
    from dask_sql_tpu_torch.plan import optimizer as opt
    from dask_sql_tpu_torch.plan.binder import Binder
    from dask_sql_tpu_torch.runtime import telemetry as tel
    from dask_sql_tpu_torch.sql.parser import Parser, parse_sql

    clock = {"cpp": 0.0, "stats": 0.0}
    real = {"parse_to_json": native.parse_to_json,
            "optimize_to_json": native.optimize_to_json,
            "reorder_joins_stats": opt.reorder_joins_stats}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                clock[key] += (time.perf_counter() - t0) * 1e3
        return wrapper

    def plan_native(text):
        return ctx._get_plan(parse_sql(text)[0].query, text)

    def plan_python(text):
        stmt = Parser(text).parse_statements()[0]
        plan = opt.optimize_python(Binder(ctx, text).bind(stmt.query))
        return opt.reorder_joins_stats(plan, ctx)

    native.parse_to_json = timed(real["parse_to_json"], "cpp")
    native.optimize_to_json = timed(real["optimize_to_json"], "cpp")
    opt.reorder_joins_stats = timed(real["reorder_joins_stats"], "stats")
    rows = []
    try:
        for qid in sorted(QUERIES):
            text = QUERIES[qid]
            got = {k: [] for k in ("native_ms", "native_cpp_ms",
                                   "native_stats_ms", "python_ms",
                                   "python_stats_ms")}
            counted = tel.REGISTRY.counters().get("planner_native", 0)
            for _ in range(FRONTEND_REPS):
                for path in ("native", "python"):
                    clock.update(cpp=0.0, stats=0.0)
                    t0 = time.perf_counter()
                    plan = (plan_native if path == "native"
                            else plan_python)(text)
                    got[f"{path}_ms"].append((time.perf_counter() - t0) * 1e3)
                    got[f"{path}_stats_ms"].append(clock["stats"])
                    if path == "native":
                        got["native_cpp_ms"].append(clock["cpp"])
                        native_text = plan.explain()
                    elif plan.explain() != native_text:
                        raise AssertionError(
                            f"Q{qid}: native and Python plans differ")
            counted = tel.REGISTRY.counters()["planner_native"] - counted
            if counted != FRONTEND_REPS:
                raise AssertionError(f"Q{qid}: planner_native {counted}")
            rows.append({"q": qid, **{k: _median(v) for k, v in got.items()},
                         "planner_native": counted})
    finally:
        native.parse_to_json = real["parse_to_json"]
        native.optimize_to_json = real["optimize_to_json"]
        opt.reorder_joins_stats = real["reorder_joins_stats"]
    for row in rows:
        row.update(_walls_by_front_end(ctx, QUERIES[row["q"]]))
        print("frontend table: " + json.dumps(row))
    total = {k: sum(r[k] for r in rows) for k in (
        "native_ms", "python_ms", "native_cpp_ms", "wall_native_ms",
        "wall_python_ms")}
    print(f"front end: Q1-Q22 plan ms (sums of medians) native "
          f"{total['native_ms']:.2f} (C++ calls {total['native_cpp_ms']:.2f}),"
          f" Python {total['python_ms']:.2f}; EXPLAIN texts equal; warm walls "
          f"native {total['wall_native_ms']:.1f}, Python "
          f"{total['wall_python_ms']:.1f}")
    return rows


def _analyzed_root_rows(ctx, text: str) -> tuple:
    lines = ctx.sql("EXPLAIN ANALYZE " + text).columns[0].to_numpy().tolist()
    m = re.search(r"\[rows=(\d+) ", lines[0])
    if m is None or "-- tier: eager" not in lines:
        raise AssertionError(f"EXPLAIN ANALYZE: {lines}")
    return int(m.group(1)), lines


def phase_statements(ctx, tables: dict, q1_result) -> dict:
    """The statement layer on the card (see the module docstring)."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    out = {}

    def timed(label, sql):
        box = {}
        out[label] = wall_ms(lambda: box.update(r=ctx.sql(sql)))
        return box["r"]

    timed("create_schema_ms", "CREATE SCHEMA smoke")
    gk.reset_launch_counts()
    timed("ctas_q1_ms", f"CREATE TABLE smoke.q1 AS ({QUERIES[1]})")
    launched = {k: v for k, v in gk.LAUNCHES.items() if v}
    if launched != {"segsum_fixedpoint": 1}:
        raise AssertionError(f"CREATE TABLE AS Q1 launched {launched}")
    out["ctas_q1_launches"] = launched
    q1 = timed("query_ctas_ms", "SELECT * FROM smoke.q1")
    check_answer("CTAS Q1", {k: v.tolist() for k, v in q1.to_numpy().items()},
                 oracle_q1(tables["lineitem"]))
    check_same_result("CTAS Q1", q1, q1_result, rtol=1e-12)

    view = ("SELECT COUNT(*) AS n, SUM(l_extendedprice) AS s, "
            "MAX(l_orderkey) AS mx FROM {} ")
    where = "WHERE l_quantity > 45"
    timed("create_view_ms", "CREATE VIEW smoke.big AS (SELECT l_orderkey, "
          f"l_quantity, l_extendedprice FROM lineitem {where})")
    inline = ctx.sql(view.format("lineitem") + where)
    for i in range(2):
        check_same_result(f"view run {i + 1}",
                          timed(f"view_run{i + 1}_ms", view.format("smoke.big")),
                          inline, rtol=1e-9)
    tables_shown = timed("show_tables_ms", "SHOW TABLES FROM smoke")
    if sorted(tables_shown.columns[0].to_numpy().tolist()) != ["big", "q1"]:
        raise AssertionError(f"SHOW TABLES: {tables_shown}")

    timed("prepare_ms", Q6_PREPARE)
    for i, params in enumerate([(0.05, 0.07, 24), (0.02, 0.09, 30)]):
        got = timed(f"execute{i + 1}_ms", "EXECUTE q6 ({}, {}, {})".format(*params))
        check_same_result(f"EXECUTE q6 {params}", got,
                          ctx.sql(Q6_INLINE.format(*params)), rtol=1e-12)

    for qid in (1, 9):
        t0 = time.perf_counter()
        root_rows, lines = _analyzed_root_rows(ctx, QUERIES[qid])
        out[f"explain_analyze_q{qid}_ms"] = (time.perf_counter() - t0) * 1e3
        want = ctx.sql(QUERIES[qid]).num_rows
        if root_rows != want:
            raise AssertionError(f"EXPLAIN ANALYZE Q{qid}: rows={root_rows}, "
                                 f"the query returns {want}")
        out[f"explain_analyze_q{qid}_rows"] = root_rows
        print(f"EXPLAIN ANALYZE Q{qid}:\n  " + "\n  ".join(lines))

    cpu_ctx = Context(device=torch.device("cpu"))
    cpu_ctx.create_table("lineitem", ctx.schema["root"].tables["lineitem"].table)
    timed("windows_cold_ms", FRONTEND_WINDOWS)
    got = timed("windows_warm_ms", FRONTEND_WINDOWS)
    t0 = time.perf_counter()
    check_tensors("F5/F6 windows", got, cpu_ctx.sql(FRONTEND_WINDOWS), 1e-12)
    out["windows_cpu_rerun_s"] = time.perf_counter() - t0
    lag = got.columns[4].data
    lead = got.columns[5].to_numpy()
    n_orders = int(torch.unique(got.columns[0].data).numel())
    if int((lag == -1).sum()) != n_orders or not (lead == "dflt").any():
        raise AssertionError("LAG / LEAD defaults missing")

    for label, sql in (("drop_table_ms", "DROP TABLE smoke.q1"),
                       ("drop_view_ms", "DROP TABLE smoke.big"),
                       ("drop_schema_ms", "DROP SCHEMA smoke")):
        timed(label, sql)
    if "smoke" in ctx.sql("SHOW SCHEMAS").columns[0].to_numpy().tolist():
        raise AssertionError("DROP SCHEMA left the schema")
    print("statements: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 14: the serving path (the result cache, the workload manager, the
# Presto-wire server)
# ---------------------------------------------------------------------------

#: 14(b) and (c): the client mix, each query once per priority class
SERVING_MIX = (1, 3, 6, 9, 10, 12, 14, 18)
#: the pins of phases 1-13: the cache and the manager off, so that their
#: warm runs measure the engine (as bench.py pins the JAX package's)
SERVING_PINS = {"DSQL_RESULT_CACHE_MB": "0", "DSQL_MAX_CONCURRENT_QUERIES": "0"}
#: 14(c)'s paged result has more rows than this (about 120,000 at SF 1)
PAGED_MIN_ROWS = 100_000


def _unpin_serving() -> None:
    for name in SERVING_PINS:
        os.environ.pop(name, None)


#: phase 14's launches, summed over the per-run counts its checks read
SERVING_LAUNCHES: dict = {}


def _fold_launches() -> None:
    """Add the launch counts into ``SERVING_LAUNCHES`` and set them to 0."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    for k, v in gk.LAUNCHES.items():
        SERVING_LAUNCHES[k] = SERVING_LAUNCHES.get(k, 0) + v
    gk.reset_launch_counts()


def _replays(report) -> int:
    """Graph replays in a query's report."""
    return report.counters.get("graph_replays", 0)


def _renamed_nation(nation: dict) -> dict:
    """nation with FRANCE and GERMANY's names swapped and CHINA renamed:
    Q7's two nations trade places and Q5's ASIA names change."""
    names = [str(n) for n in nation["n_name"]]
    swap = {"FRANCE": "GERMANY", "GERMANY": "FRANCE", "CHINA": "CATHAY"}
    out = dict(nation)
    out["n_name"] = np.array([swap.get(n, n) for n in names], dtype=object)
    return out


def _q8_variant() -> str:
    # the root stage's literal (TPC-H's NATION parameter of Q8)
    return QUERIES[8].replace("'BRAZIL'", "'CANADA'")


def _q21_variant() -> str:
    # the root stage's LIMIT; the other literals sit in the first stage
    return QUERIES[21].replace("LIMIT 100", "LIMIT 50")


def _direct(ctx, text: str):
    """``text`` through the tiers with the cache off."""
    os.environ["DSQL_RESULT_CACHE_MB"] = "0"
    try:
        return ctx.sql(text)
    finally:
        os.environ.pop("DSQL_RESULT_CACHE_MB", None)


def serving_cache(ctx, tables: dict) -> dict:
    """14(a): the result cache at its defaults (256 MB on the card, 1024 MB
    on the host) with the manager off, as (b) runs the manager with the
    cache off.  Q1-Q22 run twice: the first run is a miss that stores, the
    second a hit that launches no kernel, replays no graph and equals the
    miss bit for bit.  Then nation is dropped and registered again with
    other names: Q5 and Q7 miss and answer the new rows.  Then the
    graph-pool check: parameterized Q1 at DELTA 60 (stored), 120 (a miss
    replaying the same graph over its pool), 60 again (a hit equal bit for
    bit to the first).  Then a device budget just above Q1's result:
    entries spill to the host tier and come back on a hit.  Then Q8 and
    Q21, each run again with a literal of its root stage changed: a
    full-query miss whose first stage hits the subplan cache."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk
    from dask_sql_tpu_torch.runtime import result_cache as rc
    from dask_sql_tpu_torch.runtime import telemetry as tel

    os.environ["DSQL_MAX_CONCURRENT_QUERIES"] = "0"
    try:
        return _serving_cache(ctx, tables, rc.get_cache(), gk, rc, tel)
    finally:
        os.environ.pop("DSQL_MAX_CONCURRENT_QUERIES", None)


def _serving_cache(ctx, tables: dict, cache, gk, rc, tel) -> dict:
    cache.clear()
    names = ("graph_replays", "graph_captures", "result_cache_hits",
             "result_cache_misses", "result_cache_stores")
    rows, misses = [], {}
    for qid in sorted(QUERIES):
        _fold_launches()
        box = {}
        miss_ms = wall_ms(lambda: box.update(r=ctx.sql(QUERIES[qid])))
        miss_launches = dict(gk.LAUNCHES)
        miss = box["r"]
        stored = ctx.last_report.cache["stored"]
        _fold_launches()
        hit_ms = wall_ms(lambda: box.update(r=ctx.sql(QUERIES[qid])))
        hit_launches = sum(gk.LAUNCHES.values())
        rep = ctx.last_report
        counters = {k: rep.counters.get(k, 0) for k in names}
        if not stored or not rep.cache["hit"] or hit_launches or \
                _replays(rep):
            raise AssertionError(
                f"Q{qid}: the second run is not a launch-free hit: "
                f"{rep.cache}, launches {hit_launches}, {counters}")
        _bit_equal_tables(f"Q{qid} hit", box["r"], miss)
        misses[qid] = miss
        row = {"q": qid, "stored": stored, "hit": rep.cache["hit"],
               "miss_ms": miss_ms, "hit_ms": hit_ms,
               "miss_kernel1": miss_launches.get("segsum_fixedpoint", 0),
               "hit_launches": hit_launches,
               "result_bytes": rc._table_nbytes(miss),
               "cache_device_bytes": cache.device_bytes}
        rows.append(row)
        print("serving table: " + json.dumps({"part": "a-cache", **row}))
    summary = {"stored": len(rows), "device_bytes": cache.device_bytes,
               "host_bytes": cache.host_bytes,
               "miss_ms_sum": sum(r["miss_ms"] for r in rows),
               "hit_ms_sum": sum(r["hit_ms"] for r in rows)}
    print(f"serving cache: {len(rows)} of 22 stored and hit; hit walls "
          f"{summary['hit_ms_sum']:.1f} ms against misses "
          f"{summary['miss_ms_sum']:.1f} ms; {cache.device_bytes} bytes on "
          f"the card")

    # a mutation: nation re-registered with other names
    original = tables["nation"]
    ctx.drop_table("nation")
    ctx.create_table("nation", _renamed_nation(original))
    try:
        mutated = {}
        for qid in (5, 7):
            got = ctx.sql(QUERIES[qid])
            if ctx.last_report.cache["hit"]:
                raise AssertionError(f"Q{qid} hit after nation changed")
            want = _direct(ctx, QUERIES[qid])
            check_same_result(f"Q{qid} after the change", got, want,
                              rtol=1e-12)
            if got.to_pylist() == misses[qid].to_pylist():
                raise AssertionError(f"Q{qid} gave the old answer")
            mutated[qid] = [str(v) for v in got.to_pylist()[0]]
    finally:
        ctx.drop_table("nation")
        ctx.create_table("nation", original)
    summary["mutated"] = mutated
    print(f"serving cache: nation changed, Q5 and Q7 missed and answered "
          f"the new rows ({mutated})")

    # the graph pool: the stored answer must not alias the graph's outputs
    a_text, b_text = _q1_variant(60), _q1_variant(120)
    first = ctx.sql(a_text)
    first_rep = ctx.last_report
    ctx.sql(b_text)
    b_rep = ctx.last_report
    again = ctx.sql(a_text)
    if not ctx.last_report.cache["hit"]:
        raise AssertionError("Q1 DELTA 60 missed on its second run")
    if not _replays(b_rep):
        raise AssertionError(f"Q1 DELTA 120 replayed no graph: "
                             f"{b_rep.counters}")
    _bit_equal_tables("Q1 DELTA 60 after DELTA 120", again, first)
    summary["aliasing"] = {
        "a_stored": first_rep.cache["stored"],
        "b_replays": _replays(b_rep),
        "a_again_hit": True}
    print("serving cache: Q1 DELTA 60, 120, 60: the hit equals the first "
          "answer bit for bit after a replay over the same graph")

    # the host tier: a device budget just above one Q1 result, three
    # literal sets of Q1 twice: each store spills the one before it, and
    # the second pass hits the host tier
    nbytes = rc._table_nbytes(first)
    os.environ["DSQL_RESULT_CACHE_MB"] = repr(1.5 * nbytes / 2**20)
    try:
        cache.clear()
        before = tel.REGISTRY.counters()
        texts = [_q1_variant(d) for d in (60, 90, 120)]
        stored_answers = [ctx.sql(t) for t in texts]
        host_hits = 0
        for text, want in zip(texts, stored_answers):
            got = ctx.sql(text)
            if ctx.last_report.cache["tier"] == "host":
                host_hits += 1
            _bit_equal_tables("Q1 from the host tier", got, want)
        after = tel.REGISTRY.counters()
    finally:
        os.environ.pop("DSQL_RESULT_CACHE_MB", None)
    spills = after["result_cache_spills"] - before["result_cache_spills"]
    if not spills or not host_hits:
        raise AssertionError(f"no spill or no host hit ({spills}, "
                             f"{host_hits})")
    summary["host_tier"] = {"budget_bytes": int(1.5 * nbytes),
                            "spills": spills, "host_hits": host_hits,
                            "host_bytes": cache.host_bytes}
    print(f"serving cache: budget {int(1.5 * nbytes)} bytes: {spills} "
          f"spills, {host_hits} hits from the host tier, answers equal")

    # the subplan cache on stage graphs
    subplan = {}
    for qid, variant in ((8, _q8_variant()), (21, _q21_variant())):
        cache.clear()
        ctx.sql(QUERIES[qid])
        if not ctx.last_report.counters.get("stage_graphs"):
            raise AssertionError(f"Q{qid} did not run as a stage graph")
        got = ctx.sql(variant)
        rep = ctx.last_report
        hits = rep.counters.get("result_cache_subplan_hits", 0)
        want = _direct(ctx, variant)
        check_same_result(f"Q{qid} variant", got, want, rtol=1e-12)
        if rep.cache["hit"] or not hits:
            raise AssertionError(f"Q{qid} variant: {rep.cache}, subplan "
                                 f"hits {hits}")
        subplan[qid] = {"subplan_hits": hits, "rows": got.num_rows,
                        "stage_graphs": rep.counters.get("stage_graphs", 0)}
    summary["subplan"] = subplan
    cache.clear()
    print(f"serving cache: stage variants {subplan}, answers equal to "
          "direct runs")
    print("serving table: " + json.dumps({"part": "a-summary", **summary}))
    return summary


def _percentile(xs: list, p: float) -> float:
    xs = sorted(xs)
    return xs[min(int(round(p * (len(xs) - 1))), len(xs) - 1)] if xs else 0.0


def _run_clients(fn, args: list) -> list:
    import threading

    out = [None] * len(args)
    errors = []

    def one(i):
        try:
            out[i] = fn(*args[i])
        except BaseException as e:   # noqa: BLE001 - reported below
            errors.append(f"{args[i]}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError("clients failed: " + "; ".join(errors))
    return out


def serving_manager(ctx, answers: dict) -> dict:
    """14(b): the workload manager at its defaults (4 slots, a queue 32
    deep, a 4096 MB ledger) with the cache off.  16 client threads send
    the mix (Q1, Q3, Q6, Q9, Q10, Q12, Q14, Q18), half interactive and
    half batch; every answer equals phase 12's (doubles rtol 1e-9).  Per
    class: the queue ms (p50, p95) and the admitted count, which must be
    the submitted count with none rejected; per query its byte estimate
    against the ledger and whether it was clamped to the budget.  Then,
    with ``DSQL_QUEUE_DEPTH=2`` and every slot held, the third waiter is
    refused with ``AdmissionRejected``."""
    import threading

    from dask_sql_tpu_torch.runtime import resilience as res
    from dask_sql_tpu_torch.runtime import scheduler as sched
    from dask_sql_tpu_torch.runtime import telemetry as tel

    mgr = sched.get_manager()
    budget = mgr.ledger.budget()
    os.environ["DSQL_RESULT_CACHE_MB"] = "0"
    try:
        def client(qid, priority):
            t0 = time.perf_counter()
            got = ctx.sql(QUERIES[qid], priority=priority)
            wall = (time.perf_counter() - t0) * 1e3
            rep = tel.last_report()
            q = next(s for s in rep.root.walk() if s.name == "queued")
            return got, wall, dict(q.attrs)

        # each query once first: a program whose input tables changed in
        # (a) captures again here, not inside the measured clients
        warmup = {q: wall_ms(lambda q=q: ctx.sql(QUERIES[q]))
                  for q in SERVING_MIX}
        jobs = [(q, p) for q in SERVING_MIX for p in ("interactive", "batch")]
        before = tel.REGISTRY.counters()
        t0 = time.perf_counter()
        results = _run_clients(client, jobs)
        total_ms = (time.perf_counter() - t0) * 1e3
        after = tel.REGISTRY.counters()
        per_class = {}
        estimates = {}
        for (qid, prio), (got, wall, attrs) in zip(jobs, results):
            check_same_result(f"Q{qid} {prio} under the manager", got,
                              answers[qid], rtol=1e-9)
            per_class.setdefault(prio, []).append(attrs.get("queued_ms", 0.0))
            estimates[qid] = {"est_bytes": attrs.get("est_bytes"),
                              "source": attrs.get("est_source"),
                              "reserved": attrs.get("reserved_bytes"),
                              "clamped": attrs.get("est_bytes", 0) > budget}
        classes = {}
        for prio, queued in per_class.items():
            admitted = after[f"sched_admitted_{prio}"] - \
                before[f"sched_admitted_{prio}"]
            rejected = after[f"sched_rejected_{prio}"] - \
                before[f"sched_rejected_{prio}"]
            if admitted != len(queued) or rejected:
                raise AssertionError(f"{prio}: {admitted} admitted, "
                                     f"{rejected} rejected of {len(queued)}")
            classes[prio] = {"submitted": len(queued), "admitted": admitted,
                             "rejected": rejected,
                             "queue_p50_ms": _percentile(queued, 0.5),
                             "queue_p95_ms": _percentile(queued, 0.95)}

        # a full queue
        os.environ["DSQL_QUEUE_DEPTH"] = "2"
        held = [mgr.acquire("interactive", 0) for _ in range(mgr.limit())]
        verdicts = []
        try:
            waiters = []
            for _ in range(2):
                th = threading.Thread(
                    target=lambda: verdicts.append(
                        type(_admit_once(ctx)).__name__))
                th.start()
                waiters.append(th)
            deadline = time.time() + 30
            while len(mgr.waiting_snapshot()) < 2 and time.time() < deadline:
                time.sleep(0.005)
            overflow = _admit_once(ctx)
        finally:
            for t in held:
                mgr.release(t)
            for th in waiters:
                th.join(timeout=60)
            os.environ.pop("DSQL_QUEUE_DEPTH", None)
        if not isinstance(overflow, res.AdmissionRejected) or \
                verdicts != ["Table", "Table"]:
            raise AssertionError(f"queue depth 2: overflow {overflow!r}, "
                                 f"waiters {verdicts}")
    finally:
        os.environ.pop("DSQL_RESULT_CACHE_MB", None)
    out = {"classes": classes, "estimates": estimates,
           "budget_bytes": budget, "wall_ms": total_ms, "warmup_ms": warmup,
           "clamped": sum(e["clamped"] for e in estimates.values()),
           "overflow": type(overflow).__name__,
           "retry_after_s": overflow.retry_after_s}
    print(f"serving manager: 16 clients in {total_ms:.1f} ms; {classes}; "
          f"{out['clamped']} of {len(estimates)} estimates clamped to the "
          f"{budget} byte ledger; depth 2 overflow: {out['overflow']}")
    print("serving table: " + json.dumps({"part": "b-manager", **out}))
    return out


def _admit_once(ctx):
    """Q6 through the Context; the exception instead of raising it."""
    try:
        return ctx.sql(QUERIES[6])
    except Exception as e:      # the verdict is the result here
        return e


def _http(method: str, url: str, body: bytes = None, headers=None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post_and_poll(base: str, text: str, headers=None) -> tuple:
    """(final payload, POST-to-FINISHED ms, rows, pages) of one statement,
    following page URIs to the end; ``POLLS`` counts the status polls."""
    t0 = time.perf_counter()
    code, _, body = _http("POST", f"{base}/v1/statement", text.encode(),
                          headers)
    if code != 200:
        raise AssertionError(f"POST answered {code}: {body[:300]}")
    p = json.loads(body)
    while "nextUri" in p and "/v1/status/" in p["nextUri"]:
        time.sleep(0.001)
        p = json.loads(_http("GET", p["nextUri"])[2])
        POLLS.append(1)
    ms = (time.perf_counter() - t0) * 1e3
    if "error" in p:
        raise AssertionError(f"{text[:60]}: {p['error']}")
    rows, pages = list(p.get("data", [])), 1
    while "nextUri" in p:
        p = json.loads(_http("GET", p["nextUri"])[2])
        rows.extend(p.get("data", []))
        pages += 1
    return p, ms, rows, pages


#: one entry per status poll of ``_post_and_poll``
POLLS: list = []


def _wire_cell(v):
    if hasattr(v, "isoformat"):
        return v.isoformat(sep=" ") if hasattr(v, "date") else v.isoformat()
    if hasattr(v, "item"):
        return v.item()
    return v


def check_wire_rows(name: str, got: list, want, rtol: float) -> None:
    """Rows decoded from the wire against a port table: ints, strings and
    timestamps exact, doubles to rtol."""
    expect = [[_wire_cell(v) for v in row] for row in want.to_pylist()]
    if len(got) != len(expect):
        raise AssertionError(f"{name}: {len(got)} rows, expected "
                             f"{len(expect)}")
    for g_row, w_row in zip(got, expect):
        for g, w in zip(g_row, w_row):
            if isinstance(w, float) and g is not None:
                if not math.isclose(g, w, rel_tol=rtol, abs_tol=0.0) and \
                        not (math.isnan(w) and math.isnan(g)):
                    raise AssertionError(f"{name}: {g} != {w}")
            elif g != w:
                raise AssertionError(f"{name}: {g!r} != {w!r}")


def serving_server(ctx, answers: dict, compiled_rows: list) -> dict:
    """14(c): the server on the card (``run_server(context, port=0,
    blocking=False)``; the clients use urllib).  8 concurrent clients POST
    the mix and poll until done, answers equal to phase 12's; a cache-off
    Q1 request launches kernel 1; a result of over 100,000 rows pages
    through the spool and reassembles to the direct answer; a full queue
    answers 429 with Retry-After; /metrics parses and carries the
    result_cache_* and sched_* series; /v1/engine's devices section names
    the card; DELETE cancels a queued query; each query's POST-to-FINISHED
    wall beside phase 12's warm wall; last, ``drain_async()`` makes new
    POSTs answer 503 while the query in flight finishes."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk
    from dask_sql_tpu_torch.runtime import scheduler as sched
    from dask_sql_tpu_torch.runtime import telemetry as tel
    from dask_sql_tpu_torch.server.app import run_server

    mgr = sched.get_manager()
    srv = run_server(context=ctx, host="127.0.0.1", port=0, blocking=False)
    base = f"http://127.0.0.1:{srv.server_port}"
    out = {}
    try:
        # 8 concurrent clients, the cache at its default
        jobs = [(q, p) for q in SERVING_MIX[:4] for p in ("interactive",
                                                          "batch")] + \
               [(q, p) for q in SERVING_MIX[4:] for p in ("interactive",
                                                          "batch")]

        def client(batch):
            done = []
            for qid, prio in batch:
                _, ms, rows, _ = _post_and_poll(
                    base, QUERIES[qid], {"X-DSQL-Priority": prio})
                check_wire_rows(f"Q{qid} {prio} over the wire", rows,
                                answers[qid], rtol=1e-9)
                done.append(ms)
            return done

        batches = [jobs[i::8] for i in range(8)]
        t0 = time.perf_counter()
        walls = _run_clients(client, [(b,) for b in batches])
        out["clients"] = {"clients": 8, "queries": len(jobs),
                          "wall_ms": (time.perf_counter() - t0) * 1e3,
                          "p50_ms": _percentile(sum(walls, []), 0.5),
                          "p95_ms": _percentile(sum(walls, []), 0.95)}

        # one client, the cache off: POST to FINISHED per query against
        # phase 12's warm wall; Q1 must launch kernel 1
        os.environ["DSQL_RESULT_CACHE_MB"] = "0"
        try:
            added = {}
            warm = {r["q"]: r["warm_median_ms"] for r in compiled_rows}
            for qid in SERVING_MIX:
                direct_ms = wall_ms(lambda: ctx.sql(QUERIES[qid]))
                _fold_launches()
                POLLS.clear()
                _, ms, rows, _ = _post_and_poll(base, QUERIES[qid])
                polls = len(POLLS)
                launches = dict(gk.LAUNCHES)
                check_wire_rows(f"Q{qid} cache off", rows, answers[qid],
                                rtol=1e-9)
                if qid == 1 and launches.get("segsum_fixedpoint", 0) < 1:
                    raise AssertionError(f"Q1 over the server launched no "
                                         f"kernel 1: {launches}")
                base_ms = warm.get(qid)
                added[qid] = {"post_to_finished_ms": ms,
                              "direct_ms": direct_ms,
                              "server_added_ms": ms - direct_ms,
                              "polls": polls,
                              "phase12_warm_ms": base_ms,
                              "added_ms": (None if base_ms is None
                                           else ms - base_ms),
                              "kernel1": launches.get("segsum_fixedpoint",
                                                      0)}
            out["added"] = added

            # paging: over 100,000 rows
            text = ("SELECT l_orderkey, l_linenumber, l_quantity, "
                    "l_extendedprice, l_shipdate FROM lineitem "
                    "WHERE l_orderkey <= 120000 "
                    "ORDER BY l_orderkey, l_linenumber")
            _, ms, rows, pages = _post_and_poll(base, text)
            direct = ctx.sql(text)
            if direct.num_rows <= PAGED_MIN_ROWS or pages < 3:
                raise AssertionError(f"paging: {direct.num_rows} rows, "
                                     f"{pages} pages")
            check_wire_rows("paged result", rows, direct, rtol=0.0)
            out["paging"] = {"rows": direct.num_rows, "pages": pages,
                             "ms": ms}
        finally:
            os.environ.pop("DSQL_RESULT_CACHE_MB", None)

        # a full queue: 429 with Retry-After
        os.environ["DSQL_QUEUE_DEPTH"] = "0"
        held = [mgr.acquire("interactive", 0) for _ in range(mgr.limit())]
        try:
            code, hdrs, body = _http("POST", f"{base}/v1/statement",
                                     QUERIES[6].encode())
        finally:
            for t in held:
                mgr.release(t)
            os.environ.pop("DSQL_QUEUE_DEPTH", None)
        err = json.loads(body)["error"]
        if code != 429 or int(hdrs.get("Retry-After", 0)) < 1 or \
                err["errorName"] != "QUERY_QUEUE_FULL":
            raise AssertionError(f"full queue: {code} {hdrs} {err}")
        out["full_queue"] = {"status": code,
                             "retry_after": int(hdrs["Retry-After"]),
                             "errorName": err["errorName"]}

        # /metrics and /v1/engine
        code, hdrs, body = _http("GET", f"{base}/metrics")
        series = {}
        for line in body.decode().splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                series[name] = float(value)
        if not any(k.startswith("dsql_result_cache_") for k in series) or \
                not any(k.startswith("dsql_sched_") for k in series):
            raise AssertionError("/metrics lacks result_cache_* or sched_*")
        engine = json.loads(_http("GET", f"{base}/v1/engine")[2])
        kind = torch.cuda.get_device_name(0)
        if not engine["devices"] or engine["devices"][0]["kind"] != kind:
            raise AssertionError(f"/v1/engine devices: {engine['devices']}")
        out["metrics"] = {"series": len(series),
                          "sched_admitted_interactive": series.get(
                              "dsql_sched_admitted_interactive_total"),
                          "result_cache_hits": series.get(
                              "dsql_result_cache_hits_total")}
        out["devices"] = engine["devices"]

        # DELETE cancels a query waiting for a slot
        held = [mgr.acquire("interactive", 0) for _ in range(mgr.limit())]
        before = tel.REGISTRY.counters()
        try:
            p = json.loads(_http("POST", f"{base}/v1/statement",
                                 QUERIES[14].encode())[2])
            deadline = time.time() + 30
            while not mgr.waiting_snapshot() and time.time() < deadline:
                time.sleep(0.005)
            code, _, _ = _http("DELETE", p["partialCancelUri"])
            deadline = time.time() + 30
            while mgr.waiting_snapshot() and time.time() < deadline:
                time.sleep(0.005)     # the cancelled wait leaves the queue
        finally:
            for t in held:
                mgr.release(t)
        deadline = time.time() + 30
        while (mgr.running_count() or mgr.queue_depth()) and \
                time.time() < deadline:
            time.sleep(0.005)
        status = _http("GET", p["nextUri"])[0]
        after = tel.REGISTRY.counters()
        timeouts = after["sched_timeout_interactive"] - \
            before["sched_timeout_interactive"]
        if code != 200 or status != 404 or timeouts != 1:
            raise AssertionError(f"cancel: DELETE {code}, status {status}, "
                                 f"abandoned waits {timeouts}")
        out["cancel"] = {"delete": code, "status_after": status,
                         "abandoned_waits": timeouts}

        # drain: the query in flight finishes, new POSTs answer 503
        held = [mgr.acquire("interactive", 0) for _ in range(mgr.limit())]
        try:
            first = json.loads(_http("POST", f"{base}/v1/statement",
                                     QUERIES[1].encode())[2])
            deadline = time.time() + 30
            while not mgr.waiting_snapshot() and time.time() < deadline:
                time.sleep(0.005)
            srv.drain_async()
            deadline = time.time() + 30
            while not mgr.draining() and time.time() < deadline:
                time.sleep(0.005)
            code, hdrs, body = _http("POST", f"{base}/v1/statement",
                                     QUERIES[6].encode())
        finally:
            for t in held:
                mgr.release(t)
        p = first
        while "nextUri" in p:
            time.sleep(0.005)
            p = json.loads(_http("GET", p["nextUri"])[2])
        if code != 503 or int(hdrs.get("Retry-After", 0)) < 1 or \
                "data" not in p:
            raise AssertionError(f"drain: {code} {hdrs}, in flight {p}")
        check_wire_rows("Q1 in flight during the drain", p["data"],
                        answers[1], rtol=1e-9)
        if not srv.drained_event.wait(30):
            raise AssertionError("the drain did not stop the server")
        out["drain"] = {"new_post": code,
                        "retry_after": int(hdrs["Retry-After"]),
                        "in_flight_finished": True}
    finally:
        mgr.end_drain()
        try:
            srv.shutdown()
            srv.server_close()
        except Exception:
            pass
        srv.app_state.drained.set()
        srv.app_state.pool.shutdown(wait=True)
    print(f"serving server: 8 clients {out['clients']}; paging "
          f"{out['paging']}; 429 {out['full_queue']}; cancel "
          f"{out['cancel']}; drain {out['drain']}")
    for qid, row in out["added"].items():
        print("serving table: " + json.dumps({"part": "c-server", "q": qid,
                                              **row}))
    print("serving table: " + json.dumps({"part": "c-summary",
                                          **{k: v for k, v in out.items()
                                             if k != "added"}}))
    return out


def phase_serving(ctx, tables: dict, answers: dict,
                  compiled_rows: list) -> dict:
    """Phase 14 (see ``serving_cache``, ``serving_manager``,
    ``serving_server``), the launch counts set to 0 before it and read
    after it: kernel 1 must launch on its path.  The pins of phases 1-13
    come back at its end."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    _unpin_serving()
    gk.reset_launch_counts()
    SERVING_LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        out = {"cache": serving_cache(ctx, tables),
               "manager": serving_manager(ctx, answers),
               "server": serving_server(ctx, answers, compiled_rows)}
    finally:
        os.environ.update(SERVING_PINS)
    _fold_launches()
    out["launches"] = dict(SERVING_LAUNCHES)
    out["seconds"] = time.perf_counter() - t0
    if out["launches"].get("segsum_fixedpoint", 0) < 1:
        raise AssertionError(f"phase 14 launched no kernel 1: "
                             f"{out['launches']}")
    print(f"launches: serving path {out['launches']} "
          f"({out['seconds']:.1f} s)")
    forget_programs()
    return out


# ---------------------------------------------------------------------------
# phase 19: profiling, query history and the event bus (runtime/profiler.py,
# runtime/flight_recorder.py, runtime/events.py) on the compiled tier
# ---------------------------------------------------------------------------

OBS_DIR = os.path.join("build", "phase19")
#: warm runs per query and mode (armed, unarmed), in turns
OBS_WARM = 2


def _obs_env(armed: bool) -> None:
    """Arm (or disarm) the three variables, the files under ``OBS_DIR``."""
    if armed:
        os.environ.update({
            "DSQL_PROFILE": "1", "DSQL_EVENTS": "1",
            "DSQL_HISTORY_FILE": os.path.join(OBS_DIR, "history.jsonl")})
    else:
        for name in ("DSQL_PROFILE", "DSQL_EVENTS", "DSQL_HISTORY_FILE"):
            os.environ.pop(name, None)


def _program_costs() -> list:
    """Every compiled program in the cache: its counted cost."""
    from dask_sql_tpu_torch.physical import compiled

    return [e.fn.cost for e in list(compiled._cache.values())
            if isinstance(e, compiled._Compiled)]


def obs_answers_and_records(ctx, answers: dict, q1_args: tuple) -> list:
    """19(a) and (b): every program dropped, then per query one armed cold
    run (the build counts its cost) and ``OBS_WARM`` warm runs armed and
    unarmed in turns, the launch counts set to 0 before each run and read
    after it.  Each answer equal to phase 12's bit for bit; every program
    built has a cost with bytes above 0; the history holds an envelope
    with measured bytes above 0 for each query; Q1's program counts kernel
    1's function once, reading at least Q1's values, and each warm replay
    of Q1 launches kernel 1 once.  One ``profile table:`` line per query."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk
    from dask_sql_tpu_torch.runtime import flight_recorder as fr

    rows = []
    for qid in sorted(QUERIES):
        text = QUERIES[qid]
        forget_programs()
        _obs_env(True)
        box = {}
        gk.reset_launch_counts()
        cold = wall_ms(lambda: box.update(r=ctx.sql(text)))
        _bit_equal_tables(f"19(a) Q{qid} cold", box["r"], answers[qid])
        costs = _program_costs()
        if any(c is None or c["bytes"] <= 0 for c in costs) or (
                not costs and _last_tier(ctx)[0] == "compiled"):
            raise AssertionError(f"19(a) Q{qid}: a program without a "
                                 f"counted cost: {costs}")
        walls = {True: [], False: []}
        k1 = []
        served_cost = 0.0
        for _ in range(OBS_WARM):
            for armed in (True, False):
                _obs_env(armed)
                gk.reset_launch_counts()
                walls[armed].append(
                    wall_ms(lambda: box.update(r=ctx.sql(text))))
                k1.append(gk.LAUNCHES.get("segsum_fixedpoint", 0))
                _bit_equal_tables(f"19(a) Q{qid} warm", box["r"],
                                  answers[qid])
                if armed:
                    # the programs that served the run (the report's)
                    served_cost = sum(
                        float(sp.attrs.get("cost_bytes") or 0)
                        for sp in ctx.last_report.root.walk())
        _obs_env(True)
        envs = [e for e in fr.read_events(kind="query")
                if e["query"] == text.strip()[:500]]
        # an empty result measures no bytes (rows at SF 0.01: Q18)
        if not envs or (envs[-1]["measured_bytes"] <= 0
                        and answers[qid].num_rows > 0):
            raise AssertionError(f"19(a) Q{qid}: no envelope with measured "
                                 f"bytes in the history: {envs[-1:]}")
        kernels = {}
        for c in costs:
            for name, rec in c["kernels"].items():
                kernels[name] = kernels.get(name, 0) + rec["launches"]
        if qid == 1:
            vals = q1_args[0]
            (rec,) = [c["kernels"]["segsum_fixedpoint"] for c in costs
                      if "segsum_fixedpoint" in c["kernels"]]
            if rec["launches"] != 1 or rec["bytes"] < vals.numel() * 8:
                raise AssertionError(f"19(a) Q1: kernel 1's cost record "
                                     f"{rec}, values {tuple(vals.shape)}")
            if k1 != [1] * len(k1):
                raise AssertionError(f"19(a) Q1: kernel-1 launches per "
                                     f"replay {k1}")
        last = envs[-1]
        row = {"q": qid, "cold_armed_ms": cold,
               "warm_armed_ms": walls[True], "warm_unarmed_ms": walls[False],
               "warm_armed_median_ms": _median(walls[True]),
               "warm_unarmed_median_ms": _median(walls[False]),
               "programs": len(costs), "cost_bytes": served_cost,
               "cost_bytes_all_programs": sum(c["bytes"] for c in costs),
               "kernel_records": kernels,
               "measured_bytes": last["measured_bytes"],
               "est_source": last["est_source"],
               "est_bytes": last["est_bytes"], "cost_err": last["cost_err"],
               "tier": last["tier"], "envelopes": len(envs),
               "kernel1_per_run": k1}
        print("profile table: " + json.dumps(row))
        rows.append(row)
    return rows


#: 19(b)'s breakdown of the armed overhead by variable
OBS_SPLIT_QUERIES = (1, 2, 8)
OBS_SPLIT = {"none": {}, "profile": {"DSQL_PROFILE": "1"},
             "history": {"DSQL_HISTORY_FILE": None},
             "events": {"DSQL_EVENTS": "1"}}


def obs_overhead_split(ctx) -> list:
    """19(b): the warm wall of Q1, Q2 and Q8 (one program, an eager stage
    graph, a two-stage graph) with no variable, then each of the three
    alone, three runs each in turns; the median per variant."""
    history = os.path.join(OBS_DIR, "history.jsonl")
    rows = []
    for qid in OBS_SPLIT_QUERIES:
        # built armed (its cost counted), and run once warm
        _obs_env(True)
        ctx.sql(QUERIES[qid])
        ctx.sql(QUERIES[qid])
        walls = {name: [] for name in OBS_SPLIT}
        for _ in range(3):
            for name, env in OBS_SPLIT.items():
                _obs_env(False)
                os.environ.update({k: v or history for k, v in env.items()})
                walls[name].append(wall_ms(lambda: ctx.sql(QUERIES[qid])))
        _obs_env(False)
        row = {"q": qid, **{f"{name}_ms": _median(w)
                             for name, w in walls.items()}}
        print("profile split: " + json.dumps(row))
        rows.append(row)
    # the history's own writes, where the split puts the overhead: one
    # O_APPEND line, and one read-merge-replace of the statistics file
    from dask_sql_tpu_torch.runtime import flight_recorder as fr

    _obs_env(True)
    t0 = time.perf_counter()
    for i in range(50):
        fr._append(history, {"kind": "probe", "i": i})
    t1 = time.perf_counter()
    for i in range(50):
        fr._observe_stat("probe", nbytes=i)
    t2 = time.perf_counter()
    io = {"append_ms": (t1 - t0) * 20, "observe_stat_ms": (t2 - t1) * 20,
          "stats_entries": len(fr._STATS.read())}
    print("profile io: " + json.dumps(io))
    _obs_env(False)
    rows.append(io)
    return rows


def obs_explain_profile(ctx) -> dict:
    """19(c): EXPLAIN PROFILE of Q1 and Q9 armed; each device row names the
    card (``platform=gpu``) with bytes in use above 0 and the card's total
    memory as its limit."""
    total = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for qid in (1, 9):
        lines = [r[0] for r in ctx.sql("EXPLAIN PROFILE "
                                       + QUERIES[qid]).to_pylist()]
        dev = [dict(re.findall(r"(\w+)=(\S+)", l)) for l in lines
               if l.startswith("-- device")]
        if not dev or any(d["platform"] != "gpu"
                          or int(d["hbm_in_use"]) <= 0
                          or int(d["hbm_limit"]) != total for d in dev):
            raise AssertionError(f"19(c) Q{qid}: device rows {dev}, card "
                                 f"total {total}")
        stage = [l for l in lines if l.startswith("-- stage")]
        if not stage or any(" bytes=n/a" in l for l in stage):
            raise AssertionError(f"19(c) Q{qid}: stage rows {stage}")
        print(f"19(c) EXPLAIN PROFILE Q{qid}:\n  " + "\n  ".join(
            l for l in lines if l.startswith("--")))
        out[qid] = [l for l in lines if l.startswith("--")]
    return out


def obs_trace(ctx) -> dict:
    """19(d): ``Context.profile(Q1)`` writes a chrome trace that names
    ``segsum_fixedpoint_kernel``.  A trace without device events raises in
    ``Context.profile``; as phase 4's timing does, three tries (each
    printed) before the run fails."""
    trace_dir = os.path.join(OBS_DIR, "trace")
    errors = []
    for _ in range(3):
        try:
            ctx.profile(QUERIES[1], trace_dir=trace_dir)
        except RuntimeError as e:
            errors.append(str(e))
            print(f"19(d): {e}")
            continue
        with open(ctx.last_profile_trace) as f:
            trace = json.load(f)
        names = [e.get("name", "") for e in trace["traceEvents"]]
        hits = sum("segsum_fixedpoint_kernel" in n for n in names)
        if not hits:
            raise AssertionError("19(d): the trace names no "
                                 "segsum_fixedpoint_kernel")
        print(f"19(d): {ctx.last_profile_trace}: {len(names)} events, "
              f"segsum_fixedpoint_kernel x{hits}")
        return {"events": len(names), "kernel1_events": hits,
                "empty_tries": len(errors)}
    raise AssertionError(f"19(d): three traces without device events: "
                         f"{errors}")


def obs_server(ctx) -> dict:
    """19(e): the server echoes ``X-DSQL-Trace``, and ``/v1/events``
    returns that trace's events, ``query.begin`` through ``query.done``."""
    from dask_sql_tpu_torch import run_server

    srv = run_server(context=ctx, host="127.0.0.1", port=0, blocking=False)
    base = f"http://127.0.0.1:{srv.server_port}"
    tid = "phase19-q6"
    try:
        code, headers, body = _http("POST", f"{base}/v1/statement",
                                    QUERIES[6].encode(),
                                    {"X-DSQL-Trace": tid})
        if code != 200 or headers.get("X-DSQL-Trace") != tid:
            raise AssertionError(f"19(e): POST {code}, headers {headers}")
        p = json.loads(body)
        while "nextUri" in p:
            time.sleep(0.005)
            code, headers, body = _http("GET", p["nextUri"])
            p = json.loads(body)
        if "error" in p or p["stats"].get("traceId") != tid \
                or headers.get("X-DSQL-Trace") != tid:
            raise AssertionError(f"19(e): final {p.get('error')}, "
                                 f"{p['stats']}, {headers}")
        code, headers, body = _http("GET",
                                    f"{base}/v1/events?cursor=0&limit=5000")
        evs = [json.loads(l) for l in body.splitlines() if l]
        types = [e["type"] for e in evs if e["trace"] == tid]
        if code != 200 or types[:1] != ["query.begin"] \
                or types[-1:] != ["query.done"]:
            raise AssertionError(f"19(e): /v1/events {code}, {types}")
        engine = json.loads(_http("GET", f"{base}/v1/engine")[2])
    finally:
        srv.shutdown()
        srv.server_close()
    print(f"19(e): X-DSQL-Trace echoed; /v1/events: {types}")
    return {"types": types, "history": engine["history"],
            "slo": engine["slo"]["classes"][0],
            "profile_samples": engine["profile"]["samples"]}


def _background_build(ctx, qid: int, during=None) -> dict:
    """One cold arrival of ``qid`` under tiering (answered eager while its
    programs build on a daemon thread), ``during()`` called until the build
    lands; the build's counters and the eager answer."""
    from dask_sql_tpu_torch.physical import compiled
    from dask_sql_tpu_torch.runtime import telemetry as tel

    names = ("background_compiles_done", "background_compile_errors",
             "background_capture_retries", "profile_samples")
    c0 = {k: tel.REGISTRY.get(k, 0) for k in names}
    forget_programs()
    prev = {k: os.environ.get(k) for k in ("DSQL_TIERED",
                                           "DSQL_EAGER_FALLBACK")}
    # tiering answers a cold arrival eager: it needs the eager fallback
    os.environ.update(DSQL_TIERED="1", DSQL_EAGER_FALLBACK="1")
    try:
        first = ctx.sql(QUERIES[qid])
        tier = _last_tier(ctx)[0]
        deadline = time.monotonic() + 600
        while compiled.inflight_background_compiles():
            if during is not None:
                during()
            else:
                time.sleep(0.005)
            if time.monotonic() > deadline:
                raise AssertionError(f"19(f): Q{qid}'s build did not land")
        second = ctx.sql(QUERIES[qid])
        second_tier = _last_tier(ctx)[0]
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {k: tel.REGISTRY.get(k, 0) - v for k, v in c0.items()}
    out.update(first_tier=tier, second_tier=second_tier)
    return out, first, second


def obs_sampler(ctx, answers: dict) -> dict:
    """19(f): the sampler at ``DSQL_PROFILE_SAMPLE_MS=10`` runs through one
    tiering background build (Q3) with no failed capture: the build lands
    with no error and no capture retry, samples are taken meanwhile, and
    the next arrival replays the program, equal to phase 12 bit for bit.
    Then ``Context.profile(Q6)`` called while the same build runs: it
    waits for the build, which lands with no error and no retry."""
    from dask_sql_tpu_torch.runtime import profiler as prof
    from dask_sql_tpu_torch.runtime import telemetry as tel

    os.environ["DSQL_PROFILE_SAMPLE_MS"] = "10"
    try:
        prof.ensure_sampler()
        # the sampler may still sleep out its last interval (500 ms by
        # default): the build starts once it samples at 10 ms
        n0 = tel.REGISTRY.get("profile_samples", 0)
        deadline = time.monotonic() + 5
        while tel.REGISTRY.get("profile_samples", 0) < n0 + 2 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        got, first, second = _background_build(ctx, 3)
    finally:
        os.environ.pop("DSQL_PROFILE_SAMPLE_MS", None)
    if got["background_compile_errors"] or got["background_capture_retries"] \
            or got["background_compiles_done"] < 1 \
            or got["profile_samples"] < 3 or got["first_tier"] != \
            "eager-compiling" or got["second_tier"] != "compiled":
        raise AssertionError(f"19(f): sampler beside the build: {got}")
    check_same_result("19(f) Q3 first arrival", first, answers[3], rtol=1e-9)
    _bit_equal_tables("19(f) Q3 replay", second, answers[3])
    print(f"19(f): sampler at 10 ms beside Q3's background build: {got}")

    # Context.profile while a background build runs: it waits for the
    # build (the profiler's start and stop invalidate a capture on
    # another thread), then traces
    prof_walls = []

    def profile_q6():
        # timed to a stream synchronisation: a device-wide one here, while
        # the build captures, fails on this thread (F12)
        if not prof_walls:
            prof_walls.append(stream_wall_ms(lambda: ctx.profile(
                QUERIES[6], trace_dir=os.path.join(OBS_DIR, "trace"))))

    beside, _, second = _background_build(ctx, 3, during=profile_q6)
    beside["profile_ms"] = prof_walls[0] if prof_walls else None
    if beside["background_compile_errors"] \
            or beside["background_capture_retries"] or not prof_walls:
        raise AssertionError(f"19(f): Context.profile beside a background "
                             f"build: {beside}")
    _bit_equal_tables("19(f) Q3 replay after Context.profile", second,
                      answers[3])
    print(f"19(f): Context.profile(Q6) beside Q3's background build "
          f"waited for it: {beside}")
    return {"sampler": got, "profile_beside_build": beside}


def phase_observability(ctx, answers: dict, q1_args: tuple) -> dict:
    """Phase 19 (after phase 13, on phase 12's tables): the three variables
    armed with their files under ``build/phase19``, the workload manager on
    (so that each query has an estimate) and the result cache off (so that
    each executes); the pins restored after."""
    import shutil

    shutil.rmtree(OBS_DIR, ignore_errors=True)
    os.makedirs(OBS_DIR)
    os.environ.pop("DSQL_COMPILE", None)
    os.environ.pop("DSQL_MAX_CONCURRENT_QUERIES", None)
    t0 = time.perf_counter()
    try:
        rows = obs_answers_and_records(ctx, answers, q1_args)
        split = obs_overhead_split(ctx)
        _obs_env(True)
        out = {"split": split, "explain": obs_explain_profile(ctx),
               "trace": obs_trace(ctx), "server": obs_server(ctx),
               "sampler": obs_sampler(ctx, answers)}
    finally:
        _obs_env(False)
        os.environ.update(SERVING_PINS)
        # phase 14 meets the state phase 13 left (no program, nothing
        # learned)
        forget_programs(learned=True)
    out["q1_launches"] = sum(next(r["kernel1_per_run"] for r in rows
                                  if r["q"] == 1))
    armed = sum(r["warm_armed_median_ms"] for r in rows)
    unarmed = sum(r["warm_unarmed_median_ms"] for r in rows)
    summary = {"warm_armed_ms_sum": armed, "warm_unarmed_ms_sum": unarmed,
               "overhead": armed / unarmed - 1,
               "cost_bytes_sum": sum(r["cost_bytes"] for r in rows),
               "measured_bytes_sum": sum(r["measured_bytes"] for r in rows),
               "est_sources": sorted({r["est_source"] for r in rows}),
               "seconds": time.perf_counter() - t0}
    out["summary"] = summary
    print("profile summary: " + json.dumps(summary))
    return out


def mesh_profile(mctx) -> dict:
    """19(g), on phase 17's mesh: Q1 armed with ``DSQL_PROFILE``; every
    SPMD stage's ``shard_rows`` equal to a host count of each shard's
    valid rows of that stage's output (the validity copied to the host
    beside the probe's own device reduction)."""
    from dask_sql_tpu_torch.parallel import spmd

    real = spmd._skew_probe
    seen = []

    def spy(valid, mesh, gathered):
        got = real(valid, mesh, gathered)
        host = valid.cpu().numpy().astype(np.int64)
        seen.append((got, host.reshape(mesh.size, -1).sum(axis=1).tolist()))
        return got

    spmd._skew_probe = spy
    os.environ["DSQL_PROFILE"] = "1"
    try:
        mctx.sql(QUERIES[1])
    finally:
        spmd._skew_probe = real
        os.environ.pop("DSQL_PROFILE", None)
    stages = [{k: s.attrs.get(k) for k in ("index", "shard_rows",
                                            "skew_ratio")}
              for s in mctx.last_report.root.walk()
              if s.name == "spmd_stage"]
    if not seen or any(got.get("shard_rows") != host for got, host in seen) \
            or [g["shard_rows"] for g, _ in seen] != \
            [s["shard_rows"] for s in stages]:
        raise AssertionError(f"19(g): probes {seen}, stage spans {stages}")
    print(f"19(g): mesh Q1 stage probes {stages} equal the host counts")
    return {"stages": stages, "skew_ratio": mctx.last_report.skew_ratio}


# ---------------------------------------------------------------------------
# phase 15: out-of-core execution (chunked tables, the streaming executor,
# grace-hash joins over the spill store)
# ---------------------------------------------------------------------------

#: (a)-(c): lineitem in batches of 1,048,576 rows (6 at SF 1, the last short)
OOC_BATCH_ROWS = 1 << 20
#: (d): lineitem at this scale in the default 4,194,304-row batches
OOC_SCALE_SF = 5.0
#: (b): the spill store as scripts/ooc_smoke.py sets it
OOC_SPILL_ENV = {"DSQL_SPILL_MB": "64", "DSQL_SPILL_DEVICE_MB": "8"}
#: (b): a Q3-shaped orders-lineitem join under a GROUP BY
OOC_JOIN = ("SELECT o_orderpriority, COUNT(*) AS n, "
            "SUM(l_extendedprice * (1 - l_discount)) AS revenue "
            "FROM orders JOIN lineitem ON o_orderkey = l_orderkey "
            "WHERE o_orderdate < DATE '1995-03-15' "
            "AND l_shipdate > DATE '1995-03-15' "
            "GROUP BY o_orderpriority ORDER BY o_orderpriority")


class GraphLog:
    """Calls and captures of every CUDA-graph program while it is entered
    (``GraphProgram.__call__`` and ``_warm_and_capture`` wrapped), mapped
    after the run to the compiled tier's plan keys: which programs scan a
    streamed batch or a grace-join pair."""

    def __enter__(self):
        from dask_sql_tpu_torch.physical import graphs

        self.calls, self.captures = {}, {}
        cls = graphs.GraphProgram
        self._orig = (cls.__call__, cls._warm_and_capture)
        call, capture = self._orig
        log = self

        def logged_call(prog, *flat):
            log.calls[id(prog)] = log.calls.get(id(prog), 0) + 1
            return call(prog, *flat)

        def logged_capture(prog, key, flat):
            log.captures[id(prog)] = log.captures.get(id(prog), 0) + 1
            return capture(prog, key, flat)

        cls.__call__, cls._warm_and_capture = logged_call, logged_capture
        return self

    def __exit__(self, *exc):
        from dask_sql_tpu_torch.physical import graphs

        graphs.GraphProgram.__call__, graphs.GraphProgram._warm_and_capture = \
            self._orig

    def streamed(self) -> list:
        """Per streamed split (the programs whose plan scans
        ``__stream__.batch``, the full batch's and the padded last batch's
        together, or a grace pair): ``programs`` (compiled programs run:
        one per batch layout and capacity set; a capacity escalation, the
        tier's ``recompiles``, is a new program), ``calls``, ``captures``
        and ``replays``, and the most captures of any one program."""
        from dask_sql_tpu_torch.physical import compiled

        rows = {}
        for key, entry in list(compiled._cache.items()):
            if not isinstance(entry, compiled._Compiled):
                continue
            fp = key[0][0]
            if "__stream__.batch" not in fp and "__stream__.grace_l" not in fp:
                continue
            pid = id(entry.fn)
            if pid not in self.calls:
                continue
            row = rows.setdefault(fp.replace("+rv", ""), {
                "programs": 0, "calls": 0, "captures": 0,
                "most_captures": 0})
            caps = self.captures.get(pid, 0)
            row["programs"] += 1
            row["calls"] += self.calls[pid]
            row["captures"] += caps
            row["most_captures"] = max(row["most_captures"], caps)
        out = []
        for _name, row in sorted(rows.items()):
            row["replays"] = row["calls"] - row["captures"]
            out.append(row)
        return out


def _upload_bytes(report) -> list:
    """``upload_bytes`` of each ``stream_batch`` span of a query report."""
    return [s.attrs["upload_bytes"] for s in report.root.walk()
            if s.name == "stream_batch" and "upload_bytes" in s.attrs]


def _ooc_run(ctx, text: str) -> dict:
    """One run of ``text`` (the launch counts set to 0 before it and read
    after it): the result, the wall, the streamed programs' calls,
    captures and replays, the batches and their upload bytes."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    gk.reset_launch_counts()
    box = {}
    with GraphLog() as log:
        ms = wall_ms(lambda: box.update(r=ctx.sql(text)))
    rep = ctx.last_report
    uploads = _upload_bytes(rep)
    return {"result": box["r"], "ms": ms, "programs": log.streamed(),
            "batches": rep.counters.get("stream_batches", 0),
            "upload_bytes": sum(uploads), "uploads": len(uploads),
            "launches": {k: v for k, v in gk.LAUNCHES.items() if v},
            "counters": rep.counters}


def _check_streamed(name: str, run: dict) -> None:
    """Each streamed program was captured at most once (so a split takes
    two captures, the full batch's and the padded last batch's, plus one
    per capacity escalation), and every other call was a replay."""
    for p in run["programs"]:
        if p["most_captures"] > 1 or p["replays"] < p["calls"] - p["programs"]:
            raise AssertionError(f"{name}: streamed programs captured more "
                                 f"than once: {run['programs']}")


def _graph_cells(programs: list) -> str:
    """(programs, captures, replays) of each streamed split, as JSON."""
    return json.dumps([(p["programs"], p["captures"], p["replays"])
                       for p in programs])


def _ooc_context(dev, ctx, tables: dict, chunked: dict) -> tuple:
    """A Context on ``dev`` with the tables of ``chunked`` ({name:
    batch_rows}) registered chunked from their numpy columns
    (``ChunkedSource.from_columns``, no pandas) and the others sharing the
    resident context's entries; returns it and the encode seconds."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.io.chunked import ChunkedSource

    octx = Context(device=dev)
    seconds = {}
    for name, cols in tables.items():
        if name in chunked:
            t0 = time.perf_counter()
            src = ChunkedSource.from_columns(cols, batch_rows=chunked[name])
            seconds[name] = time.perf_counter() - t0
            octx.create_table(name, src, chunked=True)
        else:
            octx.schema["root"].tables[name] = ctx.schema["root"].tables[name]
    return octx, seconds


def pinned_copy_gbps(dev, nbytes: int) -> float:
    """The upload bound: one pinned host-to-device ``copy_`` of ``nbytes``,
    timed with CUDA events (GB/s)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host.fill_(1)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: dst.copy_(host, non_blocking=True), reps=5)
    return nbytes / ms / 1e6


def upload_path_gbps(source, dev, columns) -> tuple:
    """(bytes, GB/s) of the port's own upload path over every batch of
    ``source`` (staging into pinned memory and the copy), host clock to
    a synchronisation."""
    total = 0

    def run():
        nonlocal total
        total = 0
        for i in range(source.n_batches):
            t, rv = source.batch_table(i, dev, columns)
            total += sum(c.data.numel() * c.data.element_size()
                         + (0 if c.mask is None else c.mask.numel())
                         for c in t.columns)
    run()
    ms = wall_ms(run)
    return total, total / ms / 1e6


def _sorted_columns(result, keys: tuple) -> dict:
    """{name: host array} of ``result`` sorted by the ``keys`` columns."""
    cols = {n: c.to_numpy() for n, c in zip(result.names, result.columns)}
    order = np.lexsort(tuple(cols[k] for k in reversed(keys)))
    return {n: v[order] for n, v in cols.items()}


def ooc_one_table(dev, ctx, tables: dict, answers: dict) -> tuple:
    """15(a): lineitem chunked, Q1-Q22 cold and warm against phase 7;
    Q1 and Q6 profiled, and once more eagerly (``DSQL_COMPILE=0``)."""
    octx, enc = _ooc_context(dev, ctx, tables,
                             {"lineitem": OOC_BATCH_ROWS})
    source = octx.schema["root"].tables["lineitem"].chunked
    print(f"ooc: lineitem chunked, {source.n_rows} rows in "
          f"{source.n_batches} batches of {OOC_BATCH_ROWS} (encoded in "
          f"{enc['lineitem']:.1f} s, no pandas)")
    rows, failures = [], []
    q1_launches = None
    for qid in sorted(QUERIES):
        text = QUERIES[qid]
        try:
            cold = _ooc_run(octx, text)
            warm = _ooc_run(octx, text)
            for label, run in (("cold", cold), ("warm", warm)):
                check_same_result(f"ooc Q{qid} {label}", run["result"],
                                  answers[qid], 1e-9)
                _check_streamed(f"ooc Q{qid} {label}", run)
            if qid == 1:
                q1_launches = warm["launches"].get("segsum_fixedpoint", 0)
                if q1_launches < source.n_batches:
                    raise AssertionError(
                        f"ooc Q1 launched kernel 1 {q1_launches} times for "
                        f"{source.n_batches} batches")
        except Exception as exc:  # reported together after the loop
            import traceback
            traceback.print_exc()
            failures.append(f"Q{qid}: {type(exc).__name__}: {exc}")
            continue
        per_batch = (warm["upload_bytes"] / warm["uploads"]
                     if warm["uploads"] else 0)
        row = {"q": qid, "cold_ms": cold["ms"], "warm_ms": warm["ms"],
               "stream_batches": warm["batches"],
               "programs_cold": cold["programs"],
               "programs_warm": warm["programs"],
               "upload_bytes_per_batch": per_batch,
               "effective_h2d_gbps": (warm["upload_bytes"] / warm["ms"] / 1e6
                                      if warm["ms"] else 0.0),
               "launches_warm": warm["launches"]}
        rows.append(row)
        print(f"ooc Q{qid}: cold {cold['ms']:.1f} ms, warm {warm['ms']:.1f} "
              f"ms; {warm['batches']} batches, {per_batch / 1e6:.1f} MB "
              f"uploaded per batch, {row['effective_h2d_gbps']:.2f} GB/s "
              f"effective; streamed splits cold "
              + _graph_cells(cold["programs"]) + " warm "
              + _graph_cells(warm["programs"])
              + f" (programs, captures, replays); launched "
              f"{warm['launches'] or '-'}")
    if failures:
        raise AssertionError("phase 15(a): " + "; ".join(failures))
    for row in rows:
        print("ooc table: " + json.dumps(row))
    q1_cols = ["l_returnflag", "l_linestatus", "l_quantity",
               "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]
    nbytes, path_gbps = upload_path_gbps(source, dev, q1_cols)
    bound = pinned_copy_gbps(dev, nbytes // source.n_batches)
    print(f"ooc upload: Q1's {len(q1_cols)} columns, {nbytes} bytes in "
          f"{source.n_batches} batches: the port's path {path_gbps:.2f} GB/s, "
          f"one pinned copy_ of a batch {bound:.2f} GB/s (the bound)")
    # the profiler slows the run down: the idle share is also given
    # against the unprofiled warm wall
    profiles = {}
    for q in (1, 6):
        prof = profile_query(octx, f"ooc Q{q}", QUERIES[q])
        warm_ms = next(r["warm_ms"] for r in rows if r["q"] == q)
        prof["unprofiled_warm_ms"] = warm_ms
        prof["idle_vs_unprofiled"] = 1 - prof["busy_ms"] / warm_ms
        print(f"ooc Q{q}: device busy {prof['busy_ms']:.2f} ms of an "
              f"unprofiled warm {warm_ms:.2f} ms: idle "
              f"{100 * prof['idle_vs_unprofiled']:.1f}%")
        profiles[q] = prof
    os.environ["DSQL_COMPILE"] = "0"
    try:
        for qid in (1, 6):
            run = _ooc_run(octx, QUERIES[qid])
            check_same_result(f"ooc eager Q{qid}", run["result"],
                              answers[qid], 1e-9)
            print(f"ooc eager Q{qid}: {run['ms']:.1f} ms, {run['batches']} "
                  f"batches, equal to phase 7 (the eager scan compacts the "
                  f"padded last batch)")
    finally:
        os.environ.pop("DSQL_COMPILE", None)
    return octx, {"rows": rows, "q1_launches": q1_launches,
                  "upload_path_gbps": path_gbps, "pinned_copy_gbps": bound,
                  "profiles": profiles}


def ooc_two_tables(dev, ctx, tables: dict, answers: dict) -> dict:
    """15(b): orders and lineitem chunked, the grace-hash join over the
    spill store (its device tier capped small, runs under ``build/``)."""
    from dask_sql_tpu_torch.physical.streaming import StreamingUnsupported
    from dask_sql_tpu_torch.runtime import spill

    spill_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "ooc_spill")
    os.environ.update(OOC_SPILL_ENV)
    os.environ["DSQL_SPILL_DIR"] = spill_dir
    spill.reset_store()
    out = {}
    try:
        octx, _ = _ooc_context(dev, ctx, tables,
                               {"orders": OOC_BATCH_ROWS,
                                "lineitem": OOC_BATCH_ROWS})
        want = {"Q3": answers[3], "OJ": ctx.sql(OOC_JOIN)}
        for name, text in (("Q3", QUERIES[3]), ("OJ", OOC_JOIN)):
            run = _ooc_run(octx, text)
            check_same_result(f"ooc join {name}", run["result"], want[name],
                              1e-9)
            _check_streamed(f"ooc join {name}", run)
            c = run["counters"]
            moved = {k: c.get(k, 0) for k in
                     ("morsel_joins", "morsel_pairs", "spill_partitions",
                      "spill_chunks", "spill_flushes", "spill_loads",
                      "spill_demotions", "spill_bytes_host",
                      "spill_bytes_disk", "stream_batches")}
            for k in ("morsel_joins", "morsel_pairs", "spill_partitions"):
                if moved[k] < 1:
                    raise AssertionError(f"ooc join {name}: {k} did not "
                                         f"advance: {moved}")
            stats = spill.get_store().stats()
            if stats["runs"] or stats["host_bytes"] or stats["disk_bytes"]:
                raise AssertionError(f"ooc join {name}: runs left: {stats}")
            if stats["peak_device_bytes"] > stats["device_cap"]:
                raise AssertionError(f"ooc join {name}: peak device bytes "
                                     f"{stats['peak_device_bytes']} over the "
                                     f"cap {stats['device_cap']}")
            out[name] = {"ms": run["ms"], "counters": moved,
                         "peak_device_bytes": stats["peak_device_bytes"],
                         "device_cap": stats["device_cap"],
                         "programs": run["programs"]}
            print(f"ooc join {name}: {run['ms']:.1f} ms, equal to the "
                  f"resident answer; {json.dumps(moved)}; store peak device "
                  f"{stats['peak_device_bytes']} of a {stats['device_cap']}-"
                  f"byte cap, no run left; streamed splits "
                  + _graph_cells(run["programs"]))
        os.environ["DSQL_SPILL_MB"] = "0"
        spill.reset_store()
        try:
            octx.sql(QUERIES[3])
        except StreamingUnsupported as exc:
            print(f"ooc join with DSQL_SPILL_MB=0: StreamingUnsupported "
                  f"({exc})")
        else:
            raise AssertionError("ooc join with DSQL_SPILL_MB=0 answered")
    finally:
        for k in (*OOC_SPILL_ENV, "DSQL_SPILL_DIR"):
            os.environ.pop(k, None)
        spill.reset_store()
    return out


def ooc_window(ctx, octx) -> dict:
    """15(c): phase 10's W1 over the chunked lineitem (the window regroup:
    buckets of l_suppkey) against the resident answer, rows sorted by
    (l_orderkey, l_linenumber)."""
    os.environ["DSQL_COMPILE"] = "0"
    try:
        want = _sorted_columns(ctx.sql(SURFACE["W1"]),
                               ("l_orderkey", "l_linenumber"))
    finally:
        os.environ.pop("DSQL_COMPILE", None)
    run = _ooc_run(octx, SURFACE["W1"])
    got = _sorted_columns(run["result"], ("l_orderkey", "l_linenumber"))
    for name, w in want.items():
        if not np.array_equal(got[name], w):
            raise AssertionError(f"ooc W1.{name} differs from phase 10's")
    print(f"ooc W1: {run['ms']:.1f} ms, {run['batches']} batches and "
          f"buckets, {len(want['rn'])} rows equal to phase 10's; streamed "
          "splits " + _graph_cells(run["programs"]))
    return {"ms": run["ms"], "batches": run["batches"]}


def ooc_at_scale(dev, sf: float, seed: int) -> dict:
    """15(d): lineitem at ``sf`` chunked in the default batches, Q1 and Q6
    against the numpy oracles of the same data."""
    from dask_sql_tpu_torch.io.chunked import DEFAULT_BATCH_ROWS

    t0 = time.perf_counter()
    tables = generate_tpch(sf, seed)
    li = tables.pop("lineitem")
    tables.clear()
    gen_s = time.perf_counter() - t0
    want = {1: oracle_q1(li), 6: oracle_q6(li)}
    octx, enc = _ooc_context(dev, None, {"lineitem": li},
                             {"lineitem": DEFAULT_BATCH_ROWS})
    source = octx.schema["root"].tables["lineitem"].chunked
    print(f"ooc scale: SF {sf} lineitem {source.n_rows} rows in "
          f"{source.n_batches} batches of {DEFAULT_BATCH_ROWS} (generated "
          f"in {gen_s:.1f} s, encoded in {enc['lineitem']:.1f} s)")
    del li
    out = {"sf": sf, "rows": source.n_rows, "batches": source.n_batches}
    for qid in (1, 6):
        cold = _ooc_run(octx, QUERIES[qid])
        warm = _ooc_run(octx, QUERIES[qid])
        for label, run in (("cold", cold), ("warm", warm)):
            got = {k: v.tolist() for k, v in run["result"].to_numpy().items()}
            check_answer(f"ooc SF {sf} Q{qid} {label}", got, want[qid])
            _check_streamed(f"ooc SF {sf} Q{qid} {label}", run)
        gbps = warm["upload_bytes"] / warm["ms"] / 1e6
        out[f"Q{qid}"] = {"cold_ms": cold["ms"], "warm_ms": warm["ms"],
                          "batches": warm["batches"],
                          "upload_bytes": warm["upload_bytes"],
                          "effective_h2d_gbps": gbps,
                          "launches": warm["launches"]}
        print(f"ooc scale Q{qid}: cold {cold['ms']:.1f} ms, warm "
              f"{warm['ms']:.1f} ms, {warm['batches']} batches, "
              f"{warm['upload_bytes'] / 1e9:.2f} GB uploaded, {gbps:.2f} GB/s "
              f"effective, equal to the numpy oracle; launched "
              f"{warm['launches'] or '-'}")
    return out


def phase_ooc(dev, ctx, tables: dict, answers: dict, seed: int) -> dict:
    """Phase 15 (see ``ooc_one_table``, ``ooc_two_tables``, ``ooc_window``,
    ``ooc_at_scale``) on the default path (the compiled tier first)."""
    os.environ.pop("DSQL_COMPILE", None)
    forget_programs()
    t0 = time.perf_counter()
    octx, one = ooc_one_table(dev, ctx, tables, answers)
    t1 = time.perf_counter()
    two = ooc_two_tables(dev, ctx, tables, answers)
    t2 = time.perf_counter()
    window = ooc_window(ctx, octx)
    del octx
    forget_programs()
    t3 = time.perf_counter()
    scale = ooc_at_scale(dev, OOC_SCALE_SF, seed)
    forget_programs()
    seconds = {"one_table": t1 - t0, "two_tables": t2 - t1,
               "window": t3 - t2, "scale": time.perf_counter() - t3}
    print("ooc summary: " + json.dumps(
        {"seconds": seconds, "q1_launches": one["q1_launches"],
         "upload_path_gbps": one["upload_path_gbps"],
         "pinned_copy_gbps": one["pinned_copy_gbps"],
         "idle": {q: p["idle"] for q, p in one["profiles"].items()},
         "idle_vs_unprofiled": {q: p["idle_vs_unprofiled"]
                                for q, p in one["profiles"].items()},
         "two_tables": two, "window": window, "scale": scale}))
    return {"q1_launches": one["q1_launches"]}


# ---------------------------------------------------------------------------
# phase 16: the write path (appends, INSERT INTO, maintained views, ANALYZE
# TABLE, the ingest log and POST /v1/ingest)
# ---------------------------------------------------------------------------

#: RF1 refresh functions of 16(a) and (b): half INSERT INTO ... SELECT
RF1_ROUNDS = 10
#: 16(d)'s batches through append_rows, through the server, and buffered
INGEST_BATCHES = 4
#: 16(d)'s micro-batch: this many RF1 lineitem batches coalesce
INGEST_COALESCE = 2
WRITE_VIEWS = {
    "v_q1": QUERIES[1],
    "v_sel": ("SELECT l_orderkey, l_linenumber, l_extendedprice, "
              "l_discount, l_shipdate FROM lineitem "
              "WHERE l_quantity > 48 AND l_discount >= 0.09"),
    "v_join": ("SELECT o_orderkey, o_orderdate, o_orderpriority, "
               "l_linenumber, l_extendedprice FROM orders "
               "JOIN lineitem ON o_orderkey = l_orderkey "
               "WHERE o_orderdate >= DATE '1998-06-01'"),
    "v_cd": ("SELECT l_returnflag, COUNT(DISTINCT l_suppkey) AS n_supp "
             "FROM lineitem GROUP BY l_returnflag"),
}
WRITE_SHAPES = {"v_q1": "agg", "v_sel": "append", "v_join": "join",
                "v_cd": "cdistinct"}
INGEST_DIR = os.path.join("build", "dask_sql_tpu_torch", "ingest-smoke")


def rf1(sf: float, rng, first_key: int) -> tuple:
    """TPC-H's New Sales refresh function (RF1, spec 2.5): SF x 1,500 new
    orders on keys from ``first_key`` (every fourth key, as the base
    table's) with their about SF x 6,000 lineitems, drawn as
    ``generate_tpch`` draws the base tables.  Returns (orders, lineitem)
    as dicts of numpy arrays."""
    n_part = max(int(200_000 * sf), 50)
    n_supp = max(int(10_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 30)
    n_ord = max(int(1_500 * sf), 1)
    ps_step = max(n_supp // 4, 1)
    o_dates = rng.randint(_days("1992-01-01"), _days("1998-08-02"), n_ord)
    keys = first_key + np.arange(n_ord) * 4
    orders = {
        "o_orderkey": keys,
        "o_custkey": rng.randint(1, n_cust + 1, n_ord),
        "o_orderstatus": rng.choice(["F", "O", "P"], n_ord,
                                    p=[0.49, 0.49, 0.02]),
        "o_totalprice": np.round(rng.uniform(800.0, 600_000.0, n_ord), 2),
        "o_orderdate": _dates(o_dates),
        "o_orderpriority": rng.choice(_PRIORITIES, n_ord),
        "o_clerk": _tag("Clerk#", np.arange(n_ord) % 1000, 9),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": _blank(n_ord),
    }
    lines = rng.randint(1, 8, n_ord)
    n_li = int(lines.sum())
    odate = np.repeat(o_dates, lines)
    ship = odate + rng.randint(1, 122, n_li)
    commit = odate + rng.randint(30, 91, n_li)
    receipt = ship + rng.randint(1, 31, n_li)
    partkey = rng.randint(1, n_part + 1, n_li)
    lineitem = {
        "l_orderkey": np.repeat(keys, lines),
        "l_partkey": partkey,
        "l_suppkey": (partkey - 1 + rng.randint(0, 4, n_li) * ps_step)
        % n_supp + 1,
        "l_linenumber": np.arange(n_li) - np.repeat(np.cumsum(lines) - lines,
                                                    lines) + 1,
        "l_quantity": rng.randint(1, 51, n_li).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900.0, 105_000.0, n_li), 2),
        "l_discount": np.round(rng.randint(0, 11, n_li) / 100.0, 2),
        "l_tax": np.round(rng.randint(0, 9, n_li) / 100.0, 2),
        "l_returnflag": np.where(receipt <= _days("1995-06-17"),
                                 rng.choice(["R", "A"], n_li), "N"),
        "l_linestatus": np.where(ship > _days("1995-06-17"), "O", "F"),
        "l_shipdate": _dates(ship),
        "l_commitdate": _dates(commit),
        "l_receiptdate": _dates(receipt),
        "l_shipinstruct": rng.choice(_INSTRUCTS, n_li),
        "l_shipmode": rng.choice(_SHIPMODES, n_li),
        "l_comment": _blank(n_li),
    }
    return orders, lineitem


def _entry_bytes(ctx, name: str) -> int:
    total = 0
    for c in ctx.schema["root"].tables[name].table.columns:
        total += c.data.numel() * c.data.element_size()
        if c.mask is not None:
            total += c.mask.numel()
    return total


def _host_rows(result) -> list:
    """A result's rows on the host, in a canonical order (the views and
    the direct queries answer the same rows in any order)."""
    cols = [c.to_numpy() for c in result.columns]
    rows = list(zip(*[v.tolist() for v in cols])) if cols else []
    return sorted(rows, key=lambda r: tuple(
        (v is None, str(v) if not isinstance(v, float) else f"{v:.9e}")
        for v in r))


def check_same_rows(name: str, got, want, rtol: float = 1e-9) -> None:
    """Two results of one query in any row order: integers, strings,
    timestamps and NULLs exact, doubles to ``rtol``."""
    if got.names != want.names or got.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {got} != {want}")
    for gr, wr in zip(_host_rows(got), _host_rows(want)):
        for g, w in zip(gr, wr):
            if isinstance(w, float) and isinstance(g, float) \
                    and not (math.isnan(w) and math.isnan(g)):
                if not math.isclose(g, w, rel_tol=rtol, abs_tol=0.0):
                    raise AssertionError(f"{name}: {gr} != {wr}")
            elif g != w:
                raise AssertionError(f"{name}: {gr} != {wr}")


WRITE_LAUNCHES: dict = {}


def _fold_write_launches() -> dict:
    """Add the launch counts into ``WRITE_LAUNCHES``, set them to 0, and
    return what this step launched."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    step = dict(gk.LAUNCHES)
    for k, v in step.items():
        WRITE_LAUNCHES[k] = WRITE_LAUNCHES.get(k, 0) + v
    gk.reset_launch_counts()
    return step


def _mv_counters() -> dict:
    from dask_sql_tpu_torch.runtime import telemetry as tel

    c = tel.REGISTRY.counters()
    return {k: c.get(k, 0) for k in ("mv_refresh_incremental",
                                     "mv_refresh_full", "mv_deltas_recorded")}


def _direct_ms(ctx, text: str) -> tuple:
    """(result, wall ms) of a query run past the result cache's lookup."""
    ctx._rc_bypass = True
    try:
        out = {}
        ms = wall_ms(lambda: out.setdefault("r", ctx.sql(text)))
        return out["r"], ms
    finally:
        ctx._rc_bypass = False


def write_appends_and_views(ctx, sf: float, seed: int) -> dict:
    """16(a) and (b): the views, then RF1 x ``RF1_ROUNDS`` (half INSERT
    INTO ... SELECT from staged tables, half append_rows of numpy dicts),
    each followed by a read of every view (incremental, equal to the
    direct query), Q1's cold and warm wall over the appended base; at the
    end a tombstone and REFRESH MATERIALIZED VIEW recompute each view in
    full, equal to the incremental result."""
    from dask_sql_tpu_torch.runtime import matview as mv

    rng = np.random.RandomState(seed + 16)
    first_key = int(ctx.sql("SELECT MAX(o_orderkey) AS m FROM orders")
                    .to_pylist()[0][0]) + 4
    create_ms = {}
    for name, text in WRITE_VIEWS.items():
        create_ms[name] = wall_ms(lambda: ctx.sql(
            f"CREATE OR REPLACE MATERIALIZED VIEW {name} AS {text}"))
    reg = ctx._matview_registry
    for name, kind in WRITE_SHAPES.items():
        v = reg.views[("root", name)]
        if not v.maintainable or v.shape.kind != kind:
            raise AssertionError(f"16(b) {name}: not maintained as {kind} "
                                 f"({v.reason})")
    _fold_write_launches()
    rounds = []
    latest = {}
    for i in range(RF1_ROUNDS):
        orders, lineitem = rf1(sf, rng, first_key)
        first_key = int(orders["o_orderkey"][-1]) + 4
        row = {"round": i, "rows": len(lineitem["l_orderkey"]),
               "route": "insert" if i % 2 == 0 else "append_rows"}
        if i % 2 == 0:
            ctx.create_table("rf1_orders", orders)
            ctx.create_table("rf1_lineitem", lineitem)
            row["append_ms"] = wall_ms(lambda: (
                ctx.sql("INSERT INTO orders SELECT * FROM rf1_orders"),
                ctx.sql("INSERT INTO lineitem SELECT * FROM rf1_lineitem")))
            ctx.drop_table("rf1_orders")
            ctx.drop_table("rf1_lineitem")
        else:
            row["append_ms"] = wall_ms(lambda: (
                ctx.append_rows("orders", orders),
                ctx.append_rows("lineitem", lineitem)))
        li1, ord1 = (_entry_bytes(ctx, "lineitem"),
                     _entry_bytes(ctx, "orders"))
        # concat_tables reads the base and the batch (the new table's
        # bytes) and writes the new table; collect_table_stats reads it
        row["concat_bytes"] = 2 * (li1 + ord1)
        row["stats_bytes"] = li1 + ord1
        row["append_launches"] = _fold_write_launches()
        refresh = {}
        for name, text in WRITE_VIEWS.items():
            before = _mv_counters()
            out = {}
            ms = wall_ms(lambda: out.setdefault(
                "r", ctx.sql(f"SELECT * FROM {name}")))
            step = _fold_write_launches()
            moved = {k: v - before[k] for k, v in _mv_counters().items()}
            if moved["mv_refresh_incremental"] != 1 \
                    or moved["mv_refresh_full"] != 0:
                raise AssertionError(f"16(b) round {i} {name}: {moved} "
                                     f"({reg.views[('root', name)].last_refresh_reason})")
            if name == "v_q1" and step.get("segsum_fixedpoint", 0) < 1:
                raise AssertionError(f"16(b) round {i}: the Q1 view's "
                                     f"refresh launched no kernel 1: {step}")
            direct, direct_ms = _direct_ms(ctx, text)
            _fold_write_launches()   # the direct query's, not the view's
            check_same_rows(f"16(b) round {i} {name}", out["r"], direct)
            refresh[name] = {"incremental_ms": ms, "direct_cold_ms": direct_ms,
                             "kernel1_launches": step.get(
                                 "segsum_fixedpoint", 0)}
            latest[name] = out["r"]
        _fold_write_launches()
        row["views"] = refresh
        _, row["q1_warm_ms"] = _direct_ms(ctx, QUERIES[1])
        row["q1_cold_ms"] = refresh["v_q1"]["direct_cold_ms"]
        _fold_write_launches()
        rounds.append(row)
        print("write table: " + json.dumps(row))
    # the direct queries' warm walls, then a full REFRESH of each view
    full = {}
    for name, text in WRITE_VIEWS.items():
        _, warm = _direct_ms(ctx, text)
        ctx.bump_table_epoch("root", "lineitem")   # a tombstone: no delta
        before = _mv_counters()
        ms = wall_ms(lambda: ctx.sql(f"REFRESH MATERIALIZED VIEW {name}"))
        moved = {k: v - before[k] for k, v in _mv_counters().items()}
        if moved["mv_refresh_full"] != 1:
            raise AssertionError(f"16(b) REFRESH {name}: {moved}")
        check_same_rows(f"16(b) REFRESH {name}", ctx.sql(
            f"SELECT * FROM {name}"), latest[name])
        full[name] = {"full_refresh_ms": ms, "direct_warm_ms": warm}
    _fold_write_launches()
    for name in WRITE_VIEWS:
        ctx.sql(f"DROP MATERIALIZED VIEW {name}")
    rows = mv.matview_rows(ctx)
    if rows:
        raise AssertionError(f"16(b): views left after DROP: {rows}")
    return {"create_ms": create_ms, "rounds": rounds, "full": full}


def write_analyze(ctx) -> dict:
    """16(c): ANALYZE TABLE lineitem on the card, equal to the port's CPU
    run over the same table (numeric cells rtol 1e-12, the others
    exact)."""
    from dask_sql_tpu_torch import Context

    sql = "ANALYZE TABLE lineitem COMPUTE STATISTICS FOR ALL COLUMNS"
    out = {}
    ms = wall_ms(lambda: out.setdefault("r", ctx.sql(sql)))
    cpu = Context(device=torch.device("cpu"))
    cpu.create_table("lineitem", ctx.schema["root"].tables["lineitem"].table)
    t0 = time.perf_counter()
    want = cpu.sql(sql)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got = out["r"]
    if got.names != want.names or got.num_rows != want.num_rows:
        raise AssertionError(f"16(c): {got} != {want}")
    cells = 0
    for name, g, w in zip(got.names, got.columns, want.columns):
        for a, b in zip(g.to_pylist(), w.to_pylist()):
            cells += 1
            if a == b:
                continue
            try:
                fa, fb = float(a), float(b)
            except (TypeError, ValueError):
                raise AssertionError(f"16(c) {name}: {a!r} != {b!r}")
            if not math.isclose(fa, fb, rel_tol=1e-12):
                raise AssertionError(f"16(c) {name}: {a!r} != {b!r}")
    return {"analyze_ms": ms, "cpu_ms": cpu_ms, "cells": cells,
            "columns": got.num_columns - 1}


def _answered_by(ctx) -> str:
    """``result_cache`` on a cache hit, else the tier of the context's
    last query, from its report."""
    tier = "eager"
    for s in ctx.last_report.root.walk():
        if s.attrs.get("result_cache") == "hit":
            return "result_cache"
        tier = s.attrs.get("tier", tier)
    return tier


def _post_json(url: str, body: dict) -> tuple:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wire_batch(lineitem: dict) -> dict:
    """An RF1 lineitem batch as a /v1/ingest body's columns (dates as ISO
    strings, as a JSON client sends them)."""
    out = {}
    for k, v in lineitem.items():
        if v.dtype.kind == "M":
            out[k] = [str(d) for d in v.astype("datetime64[D]")]
        else:
            out[k] = v.tolist()
    return out


def _q6_prefixes(base: float, batches: list) -> list:
    """Q6's answer over the base and each committed prefix of ``batches``."""
    out, total = [base], base
    for li in batches:
        total += oracle_q6(li)["revenue"][0]
        out.append(total)
    return out


def write_ingest(dev, ctx, sf: float, seed: int) -> dict:
    """16(d): the ingest log armed at a directory under build/, fsync on:
    RF1 lineitem batches through append_rows and through POST /v1/ingest
    to an in-process server (batches/s, rows/s), again with
    ``DSQL_INGEST_BATCH_ROWS`` > 1; a new Context replays the log equal to
    the live table; a reader thread runs Q6 while the writer appends, each
    answer equal to Q6 over a committed prefix."""
    import shutil
    import threading

    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.runtime import ingest

    shutil.rmtree(INGEST_DIR, ignore_errors=True)
    env = {"DSQL_INGEST_DIR": INGEST_DIR, "DSQL_INGEST_FSYNC": "1"}
    saved = {k: os.environ.get(k) for k in
             list(env) + ["DSQL_INGEST_BATCH_ROWS", "DSQL_INGEST_BATCH_MS"]}
    os.environ.update(env)
    rng = np.random.RandomState(seed + 17)
    base = ctx.schema["root"].tables["lineitem"].table
    first_key = int(ctx.sql("SELECT MAX(l_orderkey) AS m FROM lineitem")
                    .to_pylist()[0][0]) + 4
    out = {}
    try:
        ictx = Context(device=dev)
        ictx.create_table("lineitem", base)
        batches = []

        def batch():
            nonlocal first_key
            _, li = rf1(sf, rng, first_key)
            first_key = int(li["l_orderkey"][-1]) + 4
            batches.append(li)
            return li

        def rate(label: str, fn, n: int) -> None:
            rows0 = ictx.schema["root"].tables["lineitem"].table.num_rows
            work = [batch() for _ in range(n)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for li in work:
                fn(li)
            log = ictx.__dict__.get("_ingest_log")
            if log is not None:
                log.flush_all()
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            rows = ictx.schema["root"].tables["lineitem"].table.num_rows \
                - rows0
            if rows != sum(len(li["l_orderkey"]) for li in work):
                raise AssertionError(f"16(d) {label}: {rows} rows applied")
            out[label] = {"batches": n, "rows": rows, "seconds": s,
                          "batches_per_s": n / s, "rows_per_s": rows / s}

        rate("append_rows", lambda li: ictx.append_rows("lineitem", li),
             INGEST_BATCHES)
        srv = ictx.run_server(host="127.0.0.1", port=0, blocking=False)
        url = f"http://127.0.0.1:{srv.server_port}/v1/ingest"
        try:
            def post(li):
                code, payload = _post_json(url, {"table": "lineitem",
                                                 "rows": _wire_batch(li)})
                if code != 200 or payload.get("state") != "COMMITTED":
                    raise AssertionError(f"16(d) POST: {code} {payload}")

            rate("v1_ingest", post, INGEST_BATCHES)
        finally:
            srv.shutdown()
            srv.server_close()
        per_batch = len(batches[-1]["l_orderkey"])
        os.environ["DSQL_INGEST_BATCH_ROWS"] = str(
            per_batch * INGEST_COALESCE)
        os.environ["DSQL_INGEST_BATCH_MS"] = "60000"
        rate("append_rows_coalesced",
             lambda li: ictx.append_rows("lineitem", li), INGEST_BATCHES)
        os.environ.pop("DSQL_INGEST_BATCH_ROWS")
        os.environ.pop("DSQL_INGEST_BATCH_MS")
        live = ictx.schema["root"].tables["lineitem"].table
        out["wal_bytes"] = ingest.engine_section(ictx)["walBytes"]
        # a new Context replays the log onto the same base
        ictx._ingest_log.close()
        ictx.__dict__.pop("_ingest_log")
        rctx = Context(device=dev)
        replay_s = wall_ms(lambda: rctx.create_table("lineitem", base)) / 1e3
        got = rctx.schema["root"].tables["lineitem"].table
        n0 = base.num_rows
        check_same_result("16(d) replayed tail", got.slice(n0, got.num_rows),
                          live.slice(n0, live.num_rows), rtol=0.0)
        check_same_result("16(d) replayed Q1", rctx.sql(QUERIES[1]),
                          ictx.sql(QUERIES[1]), rtol=1e-9)
        out["replay"] = {"seconds": replay_s, "rows": got.num_rows - n0}
        del rctx
        # a reader under a writer on the default path: the compiled tier
        # captures Q6 afresh over each new table while the writer appends
        ingest_log = ingest.get_log(ictx, create=True)
        base_q6 = float(ictx.sql(QUERIES[6]).to_pylist()[0][0])
        writes = [batch() for _ in range(INGEST_BATCHES)]
        prefixes = _q6_prefixes(base_q6, writes)
        seen, tiers, errors = [], [], []
        done = threading.Event()

        def reader():
            try:
                while not done.is_set():
                    seen.append(float(ictx.sql(QUERIES[6])
                                      .to_pylist()[0][0]))
                    tiers.append(_answered_by(ictx))
            except Exception as exc:
                errors.append(exc)

        th = threading.Thread(target=reader)
        th.start()
        t0 = time.perf_counter()
        try:
            for li in writes:
                ictx.append_rows("lineitem", li)
        finally:
            done.set()
            th.join(timeout=120)
        if th.is_alive():
            raise AssertionError("16(d): the reader thread did not stop")
        if errors:
            raise errors[0]
        for v in seen:
            if not any(math.isclose(v, p, rel_tol=1e-9) for p in prefixes):
                raise AssertionError(f"16(d) reader saw {v}, not a prefix "
                                     f"of {prefixes}")
        final = float(ictx.sql(QUERIES[6]).to_pylist()[0][0])
        if not math.isclose(final, prefixes[-1], rel_tol=1e-9):
            raise AssertionError(f"16(d) Q6 after the writer: {final} != "
                                 f"{prefixes[-1]}")
        out["reader"] = {"answers": len(seen),
                         "prefixes_seen": len({min(
                             range(len(prefixes)),
                             key=lambda k: abs(prefixes[k] - v))
                             for v in seen}),
                         "writer_s": time.perf_counter() - t0,
                         "answered_by": {t: tiers.count(t)
                                         for t in sorted(set(tiers))}}
        if not out["reader"]["answered_by"].get("compiled"):
            raise AssertionError(f"16(d): no reader answer came from the "
                                 f"compiled tier: {out['reader']}")
        ingest_log.close()
        ictx.__dict__.pop("_ingest_log", None)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(INGEST_DIR, ignore_errors=True)
    return out


def write_f14(dev, tables: dict) -> dict:
    """16(e): CTAS over a chunked lineitem equals the SELECT over it (the
    JAX package's CTAS reads the one-row binding stub, F14), and ANALYZE
    TABLE over it equals ANALYZE of the same columns resident, cell for
    cell, with the device's peak over the chunked ANALYZE below the
    table's bytes and within the resident ANALYZE's peak plus one column
    and one batch."""
    from dask_sql_tpu_torch import Context

    li = tables["lineitem"]
    # every column but the three free-text ones (their dictionaries take
    # seconds to encode at SF 1)
    cols = [k for k in li if k not in ("l_shipinstruct", "l_shipmode",
                                       "l_comment")]
    fctx = Context(device=dev)
    fctx.create_table("lic", {k: li[k] for k in cols}, chunked=True,
                      batch_rows=OOC_BATCH_ROWS)
    q = ("SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS q, "
         "SUM(l_extendedprice) AS p, COUNT(*) AS n FROM lic "
         "GROUP BY l_returnflag, l_linestatus")
    want = fctx.sql(q)
    ms = wall_ms(lambda: fctx.sql(f"CREATE TABLE f14 AS {q}"))
    got = fctx.sql("SELECT * FROM f14")
    check_same_rows("16(e) CTAS", got, want)
    n = sum(r[4] for r in got.to_pylist())
    if n != len(li["l_returnflag"]) or got.num_rows < 2:
        raise AssertionError(f"16(e): CTAS counts {n} rows in "
                             f"{got.num_rows} groups")
    analyze = "ANALYZE TABLE {} COMPUTE STATISTICS FOR ALL COLUMNS"

    def peak_of(name: str) -> tuple:
        """(wall ms, the device's peak bytes over what it held before) of
        ANALYZE of ``name``, and its result."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = {}
        ms = wall_ms(lambda: out.setdefault("r", fctx.sql(
            analyze.format(name))))
        return ms, torch.cuda.max_memory_allocated() - base, out["r"]

    a_ms, peak, chunked = peak_of("lic")
    fctx.create_table("lir", {k: li[k] for k in cols})
    resident = fctx.schema["root"].tables["lir"].table
    table_bytes = sum(c.data.nbytes + (0 if c.mask is None else c.mask.nbytes)
                      for c in resident.columns)
    column_bytes = max(c.data.nbytes + len(c.data) for c in resident.columns)
    r_ms, r_peak, want = peak_of("lir")
    if chunked.to_pylist() != want.to_pylist():
        raise AssertionError(f"16(e) ANALYZE: {chunked.to_pylist()} != "
                             f"{want.to_pylist()}")
    # beyond what the resident ANALYZE adds over its table, the chunked
    # one holds one column (its data and mask) and one batch of it
    bound = r_peak + column_bytes * (1 + OOC_BATCH_ROWS / len(li["l_tax"]))
    if peak >= table_bytes or peak > bound:
        raise AssertionError(
            f"16(e) ANALYZE: device peak {peak} bytes, the table "
            f"{table_bytes}, the resident ANALYZE's peak {r_peak} and a "
            f"column {column_bytes}")
    return {"ctas_ms": ms, "groups": got.num_rows, "rows": n,
            "analyze_chunked_ms": a_ms, "analyze_resident_ms": r_ms,
            "analyze_peak_bytes": peak, "analyze_resident_peak_bytes": r_peak,
            "table_bytes": table_bytes, "column_bytes": column_bytes}


def phase_write(dev, ctx, tables: dict, sf: float, seed: int) -> dict:
    """Phase 16 on the default path (the compiled tier first, the result
    cache and the workload manager on; the cache holds the views' state),
    the launch counts set to 0 before it and read after it."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    _unpin_serving()
    os.environ.pop("DSQL_COMPILE", None)
    os.environ["DSQL_RESULT_CACHE_MB"] = "2048"
    gk.reset_launch_counts()
    WRITE_LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        out = {"views": write_appends_and_views(ctx, sf, seed)}
        t1 = time.perf_counter()
        out["analyze"] = write_analyze(ctx)
        t2 = time.perf_counter()
        out["ingest"] = write_ingest(dev, ctx, sf, seed)
        t3 = time.perf_counter()
        out["f14"] = write_f14(dev, tables)
        out["seconds"] = {"views": t1 - t0, "analyze": t2 - t1,
                          "ingest": t3 - t2,
                          "f14": time.perf_counter() - t3}
    finally:
        os.environ.update(SERVING_PINS)
    _fold_write_launches()
    out["launches"] = dict(WRITE_LAUNCHES)
    if out["launches"].get("segsum_fixedpoint", 0) < 1:
        raise AssertionError(f"phase 16 launched no kernel 1: "
                             f"{out['launches']}")
    rounds = out["views"].pop("rounds")
    out["views"]["q1_view_launches_per_refresh"] = [
        r["views"]["v_q1"]["kernel1_launches"] for r in rounds]
    print("write summary: " + json.dumps(out))
    forget_programs()
    return out



# ---------------------------------------------------------------------------
# phase 17: multi-device execution (parallel/): a mesh of four shards on
# the card
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_WARM = 3
#: the static GROUP BYs the single-device tier sums through kernel 1
MESH_KERNEL1 = (1, 4, 5, 12, 22)
#: 17(e) on distinct cards: psum trees (Q1, Q6), joins whose exchange or
#: all-gather crosses the cards (Q12, Q14), Q3's known fallback
MESH_DISTINCT = (1, 3, 6, 12, 14)
MESH_STREAMED = (1, 6)
MESH_BATCH_ROWS = 1 << 20
#: the queries the SPMD walker serves (tests/test_torch_spmd_tpch.py's
#: SERVED); the other 16 decline up front (``spmd_unsupported``)
MESH_SPMD_SERVED = (1, 3, 6, 8, 12, 14)
#: the one runtime flag a served query may fall back on: Q3's mixed-radix
#: group codes pass 2**62 over microsecond timestamps at SF 1, as in JAX
#: (a duplicate-build-key flag of the same run would only flip its join)
MESH_SPMD_FLAGS = {3: "radix_overflow"}
#: 17(a)'s stages that read device values on the host (each shard would
#: build its own dictionary): the walker falls back on ``host_read``, as
#: the JAX stage whose trace fails does, and the tiers answer.  The filter
#: keeps the tiers' strings small: built on the host for all 6.0 M rows
#: of SF 1, the CAST took 27 s a run on the card
MESH_HOST_READS = {
    "cast": ("SELECT l_orderkey, CAST(l_quantity AS VARCHAR) AS q "
             "FROM lineitem WHERE l_orderkey <= 4000 LIMIT 1000"),
    "case": ("SELECT l_orderkey, CASE WHEN l_quantity > 25 THEN l_shipmode "
             "ELSE 'zz' END AS m FROM lineitem WHERE l_orderkey <= 4000 "
             "LIMIT 1000"),
}


def _spmd_counters(ctx) -> dict:
    return {k: v for k, v in sorted(ctx.last_report.counters.items())
            if k.startswith("spmd_") and v}


def _span_attr(ctx, key: str):
    for s in ctx.last_report.root.walk():
        if key in s.attrs:
            return s.attrs[key]
    return None


def _spmd_run(ctx) -> dict:
    """What the SPMD executor did in the context's last query: its
    counters, the runtime flags that sent it to the tiers, the error its
    walker raised, if any, and the graph replays of the query."""
    return {"counters": _spmd_counters(ctx),
            "fallback": _span_attr(ctx, "spmd_fallback"),
            "error": _span_attr(ctx, "spmd_error"),
            "graph_replays": _replays(ctx.last_report)}


def check_spmd_runs(label: str, qid: int, tier: str, runs: list,
                    captured: bool) -> None:
    """Every run of a query on the SPMD path did what the walker should:
    no error caught by its generic handler; a served shape served, or
    falling back on its one known flag only; any other shape declined up
    front; where the mesh's shards sit on one card (``captured``: a mesh
    of one card, or a rank of a mesh across processes) no stage run
    outside a CUDA graph."""
    for run in runs:
        c = run["counters"]
        if c.get("spmd_errors") or run["error"]:
            raise AssertionError(f"{label} Q{qid}: the SPMD walker failed: "
                                 f"{run}")
        if captured and c.get("spmd_eager_stages"):
            raise AssertionError(f"{label} Q{qid}: stages ran outside a "
                                 f"CUDA graph: {run}")
        if qid not in MESH_SPMD_SERVED:
            if c != {"spmd_unsupported": 1}:
                raise AssertionError(f"{label} Q{qid}: expected a decline up "
                                     f"front: {run}")
        elif c.get("spmd_fallbacks"):
            fatal = [f for f in str(run["fallback"]).split(",")
                     if not f.startswith("dup_build_keys@")]
            if fatal != [MESH_SPMD_FLAGS.get(qid)]:
                raise AssertionError(f"{label} Q{qid}: fell back on "
                                     f"{run['fallback']}: {run}")
        elif c.get("spmd_queries") != 1:
            raise AssertionError(f"{label} Q{qid}: not served: {run}")
    served = [r["counters"].get("spmd_queries") == 1 for r in runs]
    if any(served) != all(served) or (tier == "spmd") != all(served):
        raise AssertionError(f"{label} Q{qid}: tier {tier}, runs {runs}")


def _mesh_context(mesh, base: dict):
    """A mesh context over the resident context's encoded tables (``base``:
    name -> device ``Table``, as phase 3 registered them)."""
    from dask_sql_tpu_torch import Context

    t0 = time.perf_counter()
    mctx = Context(mesh=mesh)
    for name, table in base.items():
        mctx.create_table(name, table)
    torch.cuda.synchronize()
    return mctx, time.perf_counter() - t0


def _mesh_runs(mctx, qid: int, answers: dict, warm: int,
               keep: dict = None) -> dict:
    """Cold and ``warm`` warm runs of one query on a mesh context, the
    launch counts set to 0 before each run and read after it; the answer
    held to the resident one and the last two warm runs to each other,
    bit for bit (and kept in ``keep``, where given)."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    text = QUERIES[qid]
    walls, launches, results, runs = [], [], [], []
    for _ in range(1 + warm):
        gk.reset_launch_counts()
        box = {}
        walls.append(wall_ms(lambda: box.update(r=mctx.sql(text))))
        launches.append(gk.LAUNCHES.get("segsum_fixedpoint", 0))
        results.append(box["r"])
        runs.append(_spmd_run(mctx))
        MESH_LAUNCHES["segsum_fixedpoint"] = (
            MESH_LAUNCHES.get("segsum_fixedpoint", 0) + launches[-1])
    tier, reason, comp = _last_tier(mctx)
    spmd = _spmd_counters(mctx)
    check_same_result(f"mesh Q{qid}", results[-1], answers[qid], rtol=1e-9)
    if warm >= 2:
        _bit_equal_tables(f"mesh Q{qid} warm runs", results[-1], results[-2])
    if keep is not None:
        keep[qid] = results[-1]
    return {"q": qid, "tier": tier, "reason": reason, "compiled": comp,
            "spmd": spmd, "spmd_runs": runs,
            "spmd_fallback": sorted({str(r["fallback"]) for r in runs
                                     if r["fallback"]}),
            "kernel1_launches": launches,
            "syncs": count_syncs(lambda: mctx.sql(text)),
            "cold_ms": walls[0], "warm_ms": walls[1:],
            "warm_median_ms": _median(walls[1:]) if warm else None}


MESH_LAUNCHES: dict = {}
#: 17(a)'s answers (four shards in one process), which phase 18's mesh
#: across processes (four shards too) must give bit for bit
MESH_ANSWERS: dict = {}
#: 17(a)'s cold and warm median walls (ms), printed beside 18(a)'s
MESH_WALLS: dict = {}


def mesh_spmd(mctx, answers: dict) -> list:
    """17(a): the 22 queries with the SPMD executor on (the default under a
    mesh): a query the stage executor declines (``spmd_unsupported``) or
    whose stage raises a runtime flag (``spmd_fallbacks``: Q3's mixed-radix
    group codes overflow over microsecond timestamps, as in the JAX
    package) runs on the compiled tier over the padded tables.  Every run
    is held to ``check_spmd_runs``."""
    rows = []
    for qid in sorted(QUERIES):
        row = _mesh_runs(mctx, qid, answers, MESH_WARM, MESH_ANSWERS)
        row["part"] = "spmd"
        rows.append(row)
        MESH_WALLS[qid] = (row["cold_ms"], row["warm_median_ms"])
        print("mesh table: " + json.dumps(
            {k: v for k, v in row.items() if k != "spmd_runs"}))
        check_spmd_runs("mesh", qid, row["tier"], row["spmd_runs"],
                        captured=True)
    return rows


def mesh_host_reads(mctx) -> list:
    """17(a'): ``MESH_HOST_READS`` on the mesh: each falls back on
    ``host_read`` alone (``spmd_fallbacks`` 1, no walker error, no eager
    stage) and equals its ``DSQL_MESH=0`` answer, cold and warm."""
    rows = []
    for name, sql in MESH_HOST_READS.items():
        walls, results, runs = [], [], []
        for _ in range(2):
            box = {}
            walls.append(wall_ms(lambda: box.update(r=mctx.sql(sql))))
            results.append(box["r"])
            runs.append(_spmd_run(mctx))
        os.environ["DSQL_MESH"] = "0"
        try:
            want = mctx.sql(sql)
        finally:
            os.environ.pop("DSQL_MESH", None)
        for i, (got, run) in enumerate(zip(results, runs)):
            check_same_result(f"mesh host read {name} run {i}", got, want,
                              rtol=0.0)
            if run["counters"] != {"spmd_fallbacks": 1} \
                    or run["fallback"] != "host_read" or run["error"]:
                raise AssertionError(f"mesh host read {name}: expected one "
                                     f"host_read fallback: {run}")
        row = {"part": "host-read", "name": name, "rows": want.num_rows,
               "tier": _last_tier(mctx)[0], "cold_ms": walls[0],
               "warm_ms": walls[1], "spmd": runs[-1]["counters"]}
        rows.append(row)
        print("mesh table: " + json.dumps(row))
    return rows


def mesh_single_device(mctx, answers: dict, resident_tiers: dict) -> list:
    """17(b): the 22 queries with ``DSQL_MESH=0``: each served by the
    compiled tier over the mesh tables with no fallback that phase 12's
    run over the resident tables did not have (Q2's stage graph falls
    back there, F8); kernel 1 launches for the static GROUP BYs."""
    rows = []
    os.environ["DSQL_MESH"] = "0"
    try:
        for qid in sorted(QUERIES):
            row = _mesh_runs(mctx, qid, answers, 1)
            row["part"] = "single-device"
            rows.append(row)
            print("mesh table: " + json.dumps(
                {k: v for k, v in row.items() if k != "spmd_runs"}))
            if any(r["counters"] for r in row["spmd_runs"]):
                raise AssertionError(f"mesh Q{qid}: the SPMD executor ran "
                                     f"with DSQL_MESH=0: {row}")
            if row["tier"] != resident_tiers[qid] or (
                    row["tier"] != "compiled"
                    and "runtime" not in row["reason"]):
                raise AssertionError(f"mesh Q{qid} with DSQL_MESH=0 took "
                                     f"{row['tier']} ({row['reason']}), the "
                                     f"resident tables "
                                     f"{resident_tiers[qid]}: {row}")
            if qid in MESH_KERNEL1 and min(row["kernel1_launches"]) < 1:
                raise AssertionError(f"mesh Q{qid} with DSQL_MESH=0 launched "
                                     f"no kernel 1: {row}")
    finally:
        os.environ.pop("DSQL_MESH", None)
    return rows


def mesh_streamed(mesh, tables: dict, answers: dict) -> list:
    """17(c): Q1 and Q6 streamed over lineitem chunked on the mesh (each
    uploaded batch row-sharded), equal to the resident answers."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.io.chunked import ChunkedSource

    sctx = Context(mesh=mesh)
    sctx.create_table("lineitem", ChunkedSource.from_columns(
        tables["lineitem"], batch_rows=MESH_BATCH_ROWS), chunked=True)
    rows = []
    for qid in MESH_STREAMED:
        walls = []
        for _ in range(2):
            box = {}
            walls.append(wall_ms(
                lambda: box.update(r=sctx.sql(QUERIES[qid]))))
        check_same_result(f"streamed mesh Q{qid}", box["r"], answers[qid],
                          rtol=1e-9)
        batches = sctx.last_report.counters.get("stream_batches", 0)
        row = {"part": "streamed", "q": qid, "cold_ms": walls[0],
               "warm_ms": walls[1], "batches": batches}
        rows.append(row)
        print("mesh table: " + json.dumps(row))
    return rows


def mesh_append(dev, mctx, base: dict, tables: dict, sf: float,
                seed: int) -> dict:
    """17(d): one RF1 appended to the mesh lineitem (its valid prefix
    concatenated with the batch and sharded again), then Q1, equal to Q1
    on a plain context after the same append."""
    from dask_sql_tpu_torch import Context

    first_key = int(tables["orders"]["o_orderkey"].max()) + 1
    _, lines = rf1(sf, np.random.RandomState(seed + 17), first_key)
    plain = Context(device=dev)
    plain.create_table("lineitem", base["lineitem"])
    n = len(lines["l_orderkey"])
    t0 = time.perf_counter()
    appended = mctx.append_rows("lineitem", lines)
    torch.cuda.synchronize()
    append_ms = (time.perf_counter() - t0) * 1e3
    plain.append_rows("lineitem", lines)
    entry = mctx.schema["root"].tables["lineitem"]
    rows_now = len(tables["lineitem"]["l_orderkey"]) + n
    if appended != n or entry.stats.rows != rows_now \
            or entry.table.num_rows % MESH_SHARDS:
        raise AssertionError(f"mesh append: {appended} of {n} rows, stats "
                             f"{entry.stats.rows} of {rows_now}, "
                             f"{entry.table.num_rows} padded rows")
    box = {}
    q1_ms = wall_ms(lambda: box.update(r=mctx.sql(QUERIES[1])))
    check_same_result("mesh Q1 after RF1", box["r"], plain.sql(QUERIES[1]),
                      rtol=1e-9)
    row = {"part": "append", "rows": n, "append_ms": append_ms,
           "q1_cold_ms": q1_ms, "tier": _last_tier(mctx)[0]}
    print("mesh table: " + json.dumps(row))
    del plain
    return row


#: 17(e)'s warm runs per query after the cold one
MESH_DISTINCT_WARM = 2


def mesh_distinct_cards(base: dict, answers: dict) -> dict:
    """17(e): ``MESH_DISTINCT`` on ``default_mesh()`` when it spans
    distinct cards (each shard on its own card): every stage one CUDA
    graph over all the cards (no eager stage), replayed on the warm runs,
    the answers phase 7's.  Per query its cold and warm walls, and per
    run its graph replays, eager stages and stage programs built."""
    from dask_sql_tpu_torch.parallel.mesh import default_mesh

    if torch.cuda.device_count() < 2:
        print("mesh 17(e): skipped, the machine has one card: a mesh over "
              "distinct cards is not verified by this run")
        return {"part": "distinct-cards", "skipped": "one card"}
    mesh = default_mesh()
    dctx, seconds = _mesh_context(mesh, base)
    rows = [_mesh_runs(dctx, qid, answers, MESH_DISTINCT_WARM)
            for qid in MESH_DISTINCT]
    for r in rows:
        runs = r.pop("spmd_runs")
        r["graph_replays"] = [run["graph_replays"] for run in runs]
        r["spmd_eager_stages"] = [run["counters"].get("spmd_eager_stages", 0)
                                  for run in runs]
        r["spmd_compiles"] = [run["counters"].get("spmd_compiles", 0)
                              for run in runs]
        check_spmd_runs("distinct-card mesh", r["q"], r["tier"], runs,
                        captured=True)
        if min(r["graph_replays"][1:]) < 1:
            raise AssertionError(f"distinct-card mesh Q{r['q']}: a warm run "
                                 f"replayed no graph: {r}")
    row = {"part": "distinct-cards", "devices": [str(d) for d in mesh.devices],
           "create_s": seconds, "queries": rows}
    print("mesh table: " + json.dumps(row))
    del dctx
    return row


def phase_mesh(dev, base: dict, tables: dict, answers: dict,
               compiled_rows: list, sf: float, seed: int) -> dict:
    """Phase 17: ``Context(mesh=Mesh([cuda:0] * 4))`` over phase 3's
    tables at ``--sf`` (``base``, their encoded device tables; ``tables``,
    the generated columns), on the default path: SPMD stages, then the
    compiled tier; the launch counts set to 0 before each run and read
    after it."""
    from dask_sql_tpu_torch.parallel import spmd
    from dask_sql_tpu_torch.parallel.mesh import Mesh

    os.environ.pop("DSQL_COMPILE", None)
    os.environ.pop("DSQL_MESH", None)
    MESH_LAUNCHES.clear()
    MESH_ANSWERS.clear()
    MESH_WALLS.clear()
    forget_programs()
    shard = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    mesh = Mesh([shard] * MESH_SHARDS)
    t0 = time.perf_counter()
    mctx, create_s = _mesh_context(mesh, base)
    out = {"create_s": create_s}
    t1 = time.perf_counter()
    out["spmd"] = mesh_spmd(mctx, answers)
    out["host_reads"] = mesh_host_reads(mctx)
    out["profile"] = mesh_profile(mctx)
    t2 = time.perf_counter()
    out["single_device"] = mesh_single_device(
        mctx, answers, {r["q"]: r["tier"] for r in compiled_rows})
    t3 = time.perf_counter()
    out["streamed"] = mesh_streamed(mesh, tables, answers)
    t4 = time.perf_counter()
    out["append"] = mesh_append(dev, mctx, base, tables, sf, seed)
    t5 = time.perf_counter()
    out["distinct_cards"] = mesh_distinct_cards(base, answers)
    eager_stages = sum(r["spmd"].get("spmd_eager_stages", 0)
                       for r in out["spmd"])
    served = [r["q"] for r in out["spmd"] if r["tier"] == "spmd"]
    fell_back = {r["q"]: r["spmd_fallback"] for r in out["spmd"]
                 if r["spmd_fallback"]}
    for r in out["spmd"]:
        del r["spmd_runs"]
    summary = {
        "create_s": create_s, "spmd_served": served,
        "spmd_fallback_flags": fell_back,
        "spmd_eager_stages": eager_stages,
        "spmd_programs": len(spmd._prog_cache),
        "kernel1_launches": dict(MESH_LAUNCHES),
        "seconds": {"spmd": t2 - t1, "single_device": t3 - t2,
                    "streamed": t4 - t3, "append": t5 - t4,
                    "distinct_cards": time.perf_counter() - t5,
                    "all": time.perf_counter() - t0}}
    print(f"mesh: {len(served)} of 22 queries served as SPMD stages "
          f"{served}, fallbacks {fell_back}, no walker error; "
          f"{eager_stages} stage runs outside a CUDA graph")
    print("mesh summary: " + json.dumps(summary))
    out["summary"] = summary
    del mctx
    spmd.clear_programs()
    forget_programs()
    return out


# ---------------------------------------------------------------------------
# phase 18: the mesh across processes (parallel/group.py): init_multihost
# over torch.distributed, one rank per process, NCCL on the cards
# ---------------------------------------------------------------------------

#: 18(a): one rank with four shards on its card (phase 17's layout)
MP_SHARDS = 4
#: 18(b): one rank per card, one shard each, up to four cards
MP_MAX_RANKS = 4
#: 18(b)'s ranks in all, their data's generation included
MP_RANK_LIMIT_S = 600.0
#: the static GROUP BYs that decline the walker and sum through kernel 1
#: on each rank's compiled tier
MP_KERNEL1 = tuple(q for q in MESH_KERNEL1 if q not in MESH_SPMD_SERVED)
MP_COUNTERS = ("mesh_process_collectives", "mesh_process_bytes")
#: the gathers of catalog rows a run made (parallel/gather.py)
MP_GATHERS = ("mesh_gathers", "mesh_gather_bytes")
#: warm runs per query after the cold one (17(a)'s count)
MP_WARM = MESH_WARM
#: 18(a)'s warm runs under torch.profiler: a psum-tree query and a
#: broadcast join, replayed graphs both
MP_PROFILED = (1, 12)
#: 18(a)'s warm walls (ms) when every stage across processes ran eagerly,
#: as PERF.md section 5 records them (NVIDIA H100 80GB HBM3, 700.00 W),
#: printed beside this run's captured ones
MP_EAGER_MS = {1: 43.44, 6: 12.86, 8: 3123.42, 12: 69.04,
                       14: 41.77}
#: 18(b)'s last part: the last rank exits, and every other rank must end
#: its next query (a served one, its stages replayed) with RankError
#: within the group's timeout, set to this for the part, and the margin
MP_EXIT_QUERY = 6
MP_EXIT_TIMEOUT_S = 20.0
MP_EXIT_MARGIN_S = 30.0
#: rounds of the group's store rendezvous timed after the queries (each
#: stage's agreed outcome takes one)
MP_RENDEZVOUS_ROUNDS = 50
MP_RANK_DIR = os.path.join("build", "dask_sql_tpu_torch", "multiprocess")
#: 18(b)'s streamed part: lineitem registered again as a chunked table in
#: phase 15(a)'s batches on every rank, these queries cold and ``MP_WARM``
#: warm; then lineitem at phase 15(d)'s scale in its batches
MP_STREAMED = (1, 6, 12, 14, 3)
MP_STREAM_TABLE = "lineitem_c"
MP_STREAM_SCALE = (1, 6)
MP_SCALE_TABLE = "lineitem_scale"
#: the queries whose every batch the walker must serve
MP_STREAM_SERVED = (1, 6)
#: what 18(b) starts once per rank (with ``--rank``)
MP_RANK_SCRIPT = os.path.abspath(__file__)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mp_env() -> None:
    """Phase 17's settings: the default path (the compiled tier behind the
    walker), no eager first arrival, the result cache and the workload
    manager off (every run executes)."""
    os.environ.pop("DSQL_COMPILE", None)
    os.environ.pop("DSQL_MESH", None)
    os.environ.update({"DSQL_TIERED": "0", "DSQL_EAGER_FALLBACK": "0"})
    os.environ.update(SERVING_PINS)


def _mp_queries(mctx, label: str, answers: dict = None) -> tuple:
    """Q1-Q22 on a mesh across processes, a cold and ``MP_WARM`` warm runs
    each, the launch counts set to 0 before each run and read after it.
    Every run is held to ``check_spmd_runs`` (served shapes served, Q3
    falling back on its one known flag only, no walker error, no stage
    outside a CUDA graph), a served run must have gone through the
    process group, each warm run must replay one graph per stage program
    the cold run built and count the cold run's collectives and bytes,
    the declined static GROUP BYs must launch kernel 1, and the answer
    must equal ``answers`` (doubles rtol 1e-9) where given.  Gathers of
    catalog rows (``mesh_gathers``): none in a world of one rank (its
    entries are whole), none in a served run, none in a warm run (the
    gathered columns are cached).  Returns the rows and the last warm
    answers."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    world = mctx.mesh.world_size
    rows, results = [], {}
    for qid in sorted(QUERIES):
        walls, launches, runs, traffic, replays = [], [], [], [], []
        gathers = []
        for _ in range(1 + MP_WARM):
            gk.reset_launch_counts()
            box = {}
            walls.append(wall_ms(lambda: box.update(
                r=mctx.sql(QUERIES[qid]))))
            launches.append(gk.LAUNCHES.get("segsum_fixedpoint", 0))
            runs.append(_spmd_run(mctx))
            traffic.append({k: mctx.last_report.counters.get(k, 0)
                            for k in MP_COUNTERS})
            gathers.append({k: mctx.last_report.counters.get(k, 0)
                            for k in MP_GATHERS})
            replays.append(_replays(mctx.last_report))
        tier = _last_tier(mctx)[0]
        check_spmd_runs(label, qid, tier, runs, captured=True)
        for run, moved in zip(runs, traffic):
            if run["counters"].get("spmd_rank_errors"):
                raise AssertionError(f"{label} Q{qid}: ranks disagreed: {run}")
            if tier == "spmd" and not all(moved.values()):
                raise AssertionError(f"{label} Q{qid}: served without the "
                                     f"process group: {moved}")
        programs = runs[0]["counters"].get("spmd_compiles", 0)
        if tier == "spmd" and (
                any(n != programs for n in replays[1:])
                or programs < runs[1]["counters"].get("spmd_stages", 0)
                or any(t != traffic[0] for t in traffic[1:])):
            raise AssertionError(f"{label} Q{qid}: the warm runs replayed "
                                 f"{replays[1:]} graphs for {programs} stage "
                                 f"programs and moved {traffic[1:]}, the "
                                 f"cold run {traffic[0]}")
        if qid in MP_KERNEL1 and min(launches) < 1:
            raise AssertionError(f"{label} Q{qid}: kernel 1 did not launch "
                                 f"on the compiled tier: {launches}")
        counted = [g["mesh_gathers"] for g in gathers]
        if (world == 1 or tier == "spmd") and any(counted) \
                or any(counted[1:]):
            raise AssertionError(f"{label} Q{qid}: gathers {gathers} on a "
                                 f"world of {world}, tier {tier} (only a "
                                 f"cold run of a declined query gathers)")
        if answers is not None:
            check_same_result(f"{label} Q{qid}", box["r"], answers[qid],
                              rtol=1e-9)
        results[qid] = box["r"]
        row = {"q": qid, "tier": tier, "spmd": _spmd_counters(mctx),
               "spmd_fallback": sorted({str(r["fallback"]) for r in runs
                                        if r["fallback"]}),
               "kernel1_launches": launches, "process_traffic": traffic,
               "gathers": gathers, "graph_replays": replays,
               "cold_ms": walls[0],
               "warm_ms": walls[1:], "warm_median_ms": _median(walls[1:])}
        rows.append(row)
        print("multiprocess table: " + json.dumps(dict(row, part=label)))
    return rows, results


def _card(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" for
    a rehearsal on the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def _mp_catalog(mctx, dev, allocated0: int) -> dict:
    """18(b): what this rank's catalog holds.  Every resident entry holds
    this rank's ``padded / world`` rows; on the card the bytes allocated
    since ``allocated0`` (before the tables were registered) must stay
    within the whole tables' bytes over the world, plus the padding and
    the largest padded column (one whole column passes through the card
    while its statistics are collected: the peak is printed too)."""
    world = mctx.mesh.world_size
    whole = padding = largest = local = 0
    for name, e in mctx.schema["root"].tables.items():
        rr = e.rank_rows
        if rr is None or e.table.num_rows != rr.padded // world:
            raise AssertionError(f"18(b): {name} holds {e.table.num_rows} "
                                 f"rows, not its rank's part ({rr})")
        per_row = sum(c.data.element_size() + (c.mask is not None)
                      for c in e.table.columns)
        whole += rr.rows * per_row
        padding += (rr.padded - rr.rows) * per_row + (
            rr.padded if e.row_valid is not None else 0)
        largest = max([largest] + [rr.padded * c.data.element_size()
                                   for c in e.table.columns])
        local += e.table.num_rows * per_row + (
            0 if e.row_valid is None else e.table.num_rows)
    out = {"world": world, "resident_bytes": whole, "local_bytes": local,
           "padding_bytes": padding, "largest_column_bytes": largest,
           "bound_bytes": whole // world + padding + largest}
    if dev.type != "cuda":
        out["catalog_bytes"] = "not measured (CPU)"
        return out
    torch.cuda.synchronize(dev)
    out["catalog_bytes"] = torch.cuda.memory_allocated(dev) - allocated0
    out["registration_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                      - allocated0)
    if out["catalog_bytes"] > out["bound_bytes"]:
        raise AssertionError(f"18(b): the rank's catalog holds "
                             f"{out['catalog_bytes']} bytes on the card, "
                             f"above {out['bound_bytes']}: {out}")
    return out


def _mp_rf1(mctx, tables: dict, sf: float, seed: int) -> tuple:
    """18(b): one RF1 (phase 16's generator) appended on every rank to
    orders and lineitem, then Q1: (the answer, the append's facts).  The
    appended entries hold this rank's part of the new padded rows."""
    first_key = int(tables["orders"]["o_orderkey"].max()) + 1
    orders, lines = rf1(sf, np.random.RandomState(seed + 18), first_key)
    t0 = time.perf_counter()
    mctx.append_rows("orders", orders)
    mctx.append_rows("lineitem", lines)
    append_ms = (time.perf_counter() - t0) * 1e3
    world = mctx.mesh.world_size
    for name, added in (("orders", orders), ("lineitem", lines)):
        e = mctx.schema["root"].tables[name]
        n = len(tables[name][next(iter(tables[name]))]) + len(
            next(iter(added.values())))
        if e.rank_rows is None or e.rank_rows.rows != n \
                or e.table.num_rows != e.rank_rows.padded // world \
                or e.stats.rows != n:
            raise AssertionError(f"18(b) RF1: {name} holds "
                                 f"{e.table.num_rows} rows of {e.rank_rows}"
                                 f", statistics of {e.stats.rows}, not {n}")
    box = {}
    q1_ms = wall_ms(lambda: box.update(r=mctx.sql(QUERIES[1])))
    return box["r"], {"append_ms": append_ms, "q1_cold_ms": q1_ms,
                      "tier": _last_tier(mctx)[0],
                      "lineitem_rows": len(lines["l_orderkey"])}


class RendezvousTimer:
    """Calls of the group's store rendezvous (``parallel.group.rendezvous``:
    each agreed stage, epilogue and gather takes one) while entered, and
    their wall in ms."""

    def __enter__(self):
        from dask_sql_tpu_torch.parallel import group as G

        self.calls, self.ms = 0, 0.0
        self._orig = orig = G.rendezvous

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.calls += 1
                self.ms += (time.perf_counter() - t0) * 1e3

        G.rendezvous = timed
        return self

    def __exit__(self, *exc):
        from dask_sql_tpu_torch.parallel import group as G

        G.rendezvous = self._orig


def _on_table(text: str, table: str) -> str:
    """A TPC-H query over ``table`` in place of lineitem."""
    return re.sub(r"\blineitem\b", table, text)


def _mp_stream_run(mctx, text: str, dev) -> dict:
    """18(b): one streamed run on a rank (the launch counts set to 0 before
    it and read after it): the result, the wall, each batch's upload bytes
    and how its plan ran (``stream_tier``: the walker over this rank's
    rows, or the tiers over the batch gathered whole), the gathers, the
    stage programs built and the graphs captured, the rendezvous calls and
    their ms, and the peak device bytes above what the card held before
    the run (the catalog)."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    gk.reset_launch_counts()
    box = {}
    held = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with RendezvousTimer() as rv:
        ms = wall_ms(lambda: box.update(r=mctx.sql(text)))
    peak = (torch.cuda.max_memory_allocated(dev) - held
            if dev.type == "cuda" else "not measured (CPU)")
    rep = mctx.last_report
    spans = [s for s in rep.root.walk() if s.name == "stream_batch"]
    c = rep.counters
    return {"result": box["r"], "ms": ms,
            "uploads": [s.attrs.get("upload_bytes") for s in spans],
            "tiers": [s.attrs.get("stream_tier") for s in spans],
            "fallbacks": sorted({s.attrs["spmd_fallback"] for s in spans
                                 if "spmd_fallback" in s.attrs}),
            "batches": c.get("stream_batches", 0),
            "gathers": c.get("mesh_gathers", 0),
            "gather_bytes": c.get("mesh_gather_bytes", 0),
            "spmd_compiles": c.get("spmd_compiles", 0),
            "spmd_stages": c.get("spmd_stages", 0),
            "spmd_join_flips": c.get("spmd_join_flips", 0),
            "compiles": c.get("compiles", 0),
            "captures": c.get("graph_captures", 0),
            "rendezvous": rv.calls, "rendezvous_ms": rv.ms,
            "peak_bytes": peak,
            "launches": gk.LAUNCHES.get("segsum_fixedpoint", 0)}


def _check_stream_programs(label: str, runs: list) -> None:
    """The stage programs of a streamed query: at most two per stage of
    its batch plan cold (the full batch's and the short last batch's; a
    join whose build side flipped takes a program of its own for each),
    none built and no graph captured warm, every batch of a query in
    ``MP_STREAM_SERVED`` served by the walker."""
    cold, warm = runs[0], runs[1:]
    served = sum(t == "spmd" for t in cold["tiers"])
    if served:
        per_plan = cold["spmd_stages"] // served
        most = 2 * per_plan * (2 if cold["spmd_join_flips"] else 1)
        if cold["spmd_compiles"] > most:
            raise AssertionError(f"{label}: {cold['spmd_compiles']} stage "
                                 f"programs for {per_plan} stages a batch")
    for run in warm:
        if run["spmd_compiles"] or run["compiles"] or run["captures"]:
            raise AssertionError(f"{label}: a warm run built or captured: "
                                 f"{run}")


def _mp_stream(mctx, tables: dict, dev, rank: int) -> dict:
    """18(b)'s streamed part on a rank: lineitem registered again as the
    chunked ``MP_STREAM_TABLE`` in ``OOC_BATCH_ROWS`` batches, then each
    query of ``MP_STREAMED`` cold and ``MP_WARM`` warm (``_mp_stream_run``,
    ``_check_stream_programs``); one ``18(b) rank r stream:`` line per
    query.  The columns that Q1-Q22 gathered are dropped first, so that a
    cold run pays the gather of the resident tables its plan scans (read
    whole before streaming: ``Context._whole_tables``), which a warm run
    finds cached (``resident_gather_bytes``, the cold run's gathered
    bytes less a warm run's).  Returns the last answers (on the host) and
    the runs' facts."""
    from dask_sql_tpu_torch.io.chunked import ChunkedSource

    mctx.__dict__.pop("_gathered", None)
    t0 = time.perf_counter()
    source = ChunkedSource.from_columns(tables["lineitem"],
                                        batch_rows=OOC_BATCH_ROWS)
    mctx.create_table(MP_STREAM_TABLE, source, chunked=True)
    encode_s = time.perf_counter() - t0
    answers, rows = {}, {}
    for qid in MP_STREAMED:
        label = f"18(b) rank {rank} streamed Q{qid}"
        runs = [_mp_stream_run(mctx, _on_table(QUERIES[qid],
                                               MP_STREAM_TABLE), dev)
                for _ in range(1 + MP_WARM)]
        _check_stream_programs(label, runs)
        for run in runs:
            if run["batches"] != source.n_batches or len(set(
                    run["uploads"])) != 1:
                raise AssertionError(f"{label}: {run['batches']} batches "
                                     f"uploading {run['uploads']} bytes")
            if qid in MP_STREAM_SERVED and set(run["tiers"]) != {"spmd"}:
                raise AssertionError(f"{label}: batches ran {run['tiers']}")
        if qid == 1 and min(r["launches"] for r in runs) < 1:
            raise AssertionError(f"{label}: kernel 1 did not launch in the "
                                 f"merge: {[r['launches'] for r in runs]}")
        answers[qid] = _host_table(runs[-1]["result"])
        warm = runs[1:]
        row = {"q": qid, "cold_ms": runs[0]["ms"],
               "warm_ms": [r["ms"] for r in warm],
               "warm_median_ms": _median([r["ms"] for r in warm]),
               "batches": runs[0]["batches"],
               "upload_bytes_per_batch": runs[0]["uploads"][0],
               "tiers": sorted(set(runs[0]["tiers"])),
               "served_batches": sum(t == "spmd" for t in runs[0]["tiers"]),
               "fallbacks": runs[0]["fallbacks"],
               "gathers": [r["gathers"] for r in runs],
               "gather_bytes": [r["gather_bytes"] for r in runs],
               "resident_gather_bytes": (runs[0]["gather_bytes"]
                                         - runs[-1]["gather_bytes"]),
               "peak_bytes": [r["peak_bytes"] for r in runs],
               "spmd_stages": runs[0]["spmd_stages"],
               "spmd_join_flips": runs[0]["spmd_join_flips"],
               "programs_cold": runs[0]["spmd_compiles"],
               "compiles_cold": runs[0]["compiles"],
               "captures_cold": runs[0]["captures"],
               "programs_warm": [r["spmd_compiles"] for r in warm],
               "captures_warm": [r["captures"] for r in warm],
               "rendezvous_warm": warm[-1]["rendezvous"],
               "rendezvous_warm_ms": [r["rendezvous_ms"] for r in warm],
               "launches": [r["launches"] for r in runs]}
        rows[qid] = row
        print(f"18(b) rank {rank} stream: " + json.dumps(row), flush=True)
    mctx.drop_table(MP_STREAM_TABLE)
    return answers, {"rows": rows, "encode_s": encode_s,
                     "n_batches": source.n_batches}


def _mp_stream_scale(mctx, sf: float, seed: int, dev, rank: int) -> dict:
    """18(b): lineitem at ``sf`` (generated here from ``seed``) chunked in
    the default batches as ``MP_SCALE_TABLE``, Q1 and Q6 cold and warm on
    every rank, each held to the numpy oracle of the same data; one
    ``18(b) rank r stream scale:`` line.  Returns the warm answers (on the
    host) and the runs' facts."""
    from dask_sql_tpu_torch.io.chunked import DEFAULT_BATCH_ROWS, ChunkedSource

    t0 = time.perf_counter()
    tables = generate_tpch(sf, seed)
    li = tables.pop("lineitem")
    tables.clear()
    gen_s = time.perf_counter() - t0
    want = {1: oracle_q1(li), 6: oracle_q6(li)}
    t1 = time.perf_counter()
    source = ChunkedSource.from_columns(li, batch_rows=DEFAULT_BATCH_ROWS)
    del li
    mctx.create_table(MP_SCALE_TABLE, source, chunked=True)
    out = {"sf": sf, "rows": source.n_rows, "batches": source.n_batches,
           "generate_s": gen_s, "encode_s": time.perf_counter() - t1}
    answers = {}
    for qid in MP_STREAM_SCALE:
        label = f"18(b) rank {rank} SF {sf} streamed Q{qid}"
        runs = [_mp_stream_run(mctx, _on_table(QUERIES[qid],
                                               MP_SCALE_TABLE), dev)
                for _ in range(2)]
        for name, run in zip(("cold", "warm"), runs):
            got = {k: v.tolist() for k, v in run["result"].to_numpy().items()}
            check_answer(f"{label} {name}", got, want[qid])
        _check_stream_programs(label, runs)
        answers[qid] = _host_table(runs[1]["result"])
        out[f"Q{qid}"] = {"cold_ms": runs[0]["ms"], "warm_ms": runs[1]["ms"],
                          "upload_bytes_per_batch": runs[1]["uploads"][0],
                          "tiers": sorted(set(runs[1]["tiers"])),
                          "gathers": [r["gathers"] for r in runs],
                          "peak_bytes": [r["peak_bytes"] for r in runs],
                          "rendezvous_warm": runs[1]["rendezvous"],
                          "rendezvous_warm_ms": runs[1]["rendezvous_ms"],
                          "launches": [r["launches"] for r in runs]}
    mctx.drop_table(MP_SCALE_TABLE)
    print(f"18(b) rank {rank} stream scale: " + json.dumps(out), flush=True)
    return answers, out


def mp_stream_reference(dev, base: dict, answers: dict, sf: float,
                        seed: int) -> dict:
    """18(b)'s one-card reference, in this process before the ranks start:
    phase 15(a)'s set-up (lineitem chunked in ``OOC_BATCH_ROWS`` batches,
    the other tables resident from ``base``) and the queries of
    ``MP_STREAMED`` cold and ``MP_WARM`` warm, each answer equal to phase
    7's: their walls and bytes uploaded per batch."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.io.chunked import ChunkedSource

    octx = Context(device=dev)
    for name, table in base.items():
        if name != "lineitem":
            octx.create_table(name, table)
    octx.create_table("lineitem", ChunkedSource.from_columns(
        generate_tpch(sf, seed)["lineitem"], batch_rows=OOC_BATCH_ROWS),
        chunked=True)
    rows = {}
    for qid in MP_STREAMED:
        runs = [_ooc_run(octx, QUERIES[qid]) for _ in range(1 + MP_WARM)]
        for run in runs:
            check_same_result(f"18(b) one-card streamed Q{qid}",
                              run["result"], answers[qid], 1e-9)
        rows[qid] = {"cold_ms": runs[0]["ms"],
                     "warm_median_ms": _median([r["ms"] for r in runs[1:]]),
                     "upload_bytes_per_batch": (runs[0]["upload_bytes"]
                                                / runs[0]["uploads"])}
    del octx
    forget_programs()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def _host_table(r):
    from dask_sql_tpu_torch.table import Column, Table

    return Table(r.names, [Column(
        c.data.cpu(), c.stype, None if c.mask is None else c.mask.cpu(),
        c.dictionary) for c in r.columns])


def _rendezvous_ms(group) -> float:
    """The mean wall of one store rendezvous of ``group`` (every rank runs
    the same rounds)."""
    from dask_sql_tpu_torch.parallel import group as G

    t0 = time.perf_counter()
    for _ in range(MP_RENDEZVOUS_ROUNDS):
        G.rendezvous(group, {"step": "timed"})
    return (time.perf_counter() - t0) * 1e3 / MP_RENDEZVOUS_ROUNDS


def _mp_walls(rows: list, label: str, card: str, every: bool = False) -> None:
    """One line per served query (per query where ``every``): its cold and
    warm walls across processes (captured stages) beside 17(a)'s and the
    eager stages' of ``MP_EAGER_MS``, its tier and gathers, and the card
    (name and power limit)."""
    for r in rows:
        if r["tier"] != "spmd" and not every:
            continue
        cold17, warm17 = MESH_WALLS.get(r["q"], (None, None))
        print("multiprocess walls: " + json.dumps({
            "part": label, "q": r["q"], "tier": r["tier"],
            "cold_ms": r["cold_ms"],
            "warm_median_ms": r["warm_median_ms"],
            "warm_ms": r["warm_ms"], "gathers": r["gathers"][0],
            "mesh_17a_cold_ms": cold17,
            "mesh_17a_warm_median_ms": warm17,
            "eager_stages_warm_ms": MP_EAGER_MS.get(r["q"]), "card": card}))


def _mp_summary(rows: list, world: int, seconds: float) -> dict:
    return {"world_size": world,
            "served": [r["q"] for r in rows if r["tier"] == "spmd"],
            "fallback_flags": {r["q"]: r["spmd_fallback"] for r in rows
                               if r["spmd_fallback"]},
            "eager_stages": sum(r["spmd"].get("spmd_eager_stages", 0)
                                for r in rows),
            "collectives": sum(t["mesh_process_collectives"]
                               for r in rows for t in r["process_traffic"]),
            "bytes": sum(t["mesh_process_bytes"]
                         for r in rows for t in r["process_traffic"]),
            "kernel1_launches": sum(sum(r["kernel1_launches"])
                                    for r in rows),
            "mesh_gathers": sum(g["mesh_gathers"]
                                for r in rows for g in r["gathers"]),
            "mesh_gather_bytes": sum(g["mesh_gather_bytes"]
                                     for r in rows for g in r["gathers"]),
            "seconds": seconds}


def multiprocess_world1(dev, base: dict, answers: dict) -> tuple:
    """18(a): a process group of one rank in this process (NCCL on the
    card) holding four shards: Q1-Q22 through ``Context(mesh=...)``, every
    collective through the group; served answers bit for bit 17(a)'s
    (the same four shards, reduced in the same order)."""
    from dask_sql_tpu_torch.parallel import group as G
    from dask_sql_tpu_torch.parallel.mesh import init_multihost

    t0 = time.perf_counter()
    device = "cpu" if dev.type == "cpu" else "cuda:0"
    mesh = init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, device=device,
                          local_shards=MP_SHARDS)
    try:
        if mesh.group.backend != ("gloo" if dev.type == "cpu" else "nccl"):
            raise AssertionError(f"18(a): a {mesh.group.backend} group")
        mctx, create_s = _mesh_context(mesh, base)
        rows, results = _mp_queries(mctx, "18(a)", answers)
        _mp_walls(rows, "18(a)", _card(dev))
        rendezvous_ms = _rendezvous_ms(mesh.group)
        profiles = {q: profile_query(mctx, f"18(a) Q{q}", QUERIES[q])
                    for q in MP_PROFILED}
        for row in rows:
            if row["tier"] == "spmd" and row["q"] in MESH_ANSWERS:
                _bit_equal_tables(f"18(a) Q{row['q']} against 17(a)",
                                  results[row["q"]], MESH_ANSWERS[row["q"]])
        del mctx
    finally:
        G.close(mesh.group)
    summary = _mp_summary(rows, 1, time.perf_counter() - t0)
    summary.update(create_s=create_s, profiles=profiles,
                   rendezvous_ms=rendezvous_ms)
    return summary, results


def _mp_exit_part(mctx, rank: int, world: int) -> dict:
    """18(b)'s last part, on every rank after its queries: every rank runs
    ``MP_EXIT_QUERY`` once more (so that its stages' captures are the
    most recently used: the graphs' memory budget evicts the least
    recently used), the ranks meet at the group's store, then the last
    one leaves (returns ``"exits"``), and every other runs
    ``MP_EXIT_QUERY`` again (its stages replayed, each holding an NCCL
    call the gone rank never joins) under a group timeout of
    ``MP_EXIT_TIMEOUT_S``: the query must end in ``RankError``."""
    from dask_sql_tpu_torch.parallel import group as G
    from dask_sql_tpu_torch.parallel.spmd import RankError

    group = mctx.mesh.group
    mctx.sql(QUERIES[MP_EXIT_QUERY])
    G.rendezvous(group, {"step": "exit"})
    if rank == world - 1:
        return {"exits": True}
    group.timeout_s = MP_EXIT_TIMEOUT_S
    # a rank that does not end the query in time prints its stacks
    faulthandler.dump_traceback_later(MP_EXIT_TIMEOUT_S + MP_EXIT_MARGIN_S)
    t0 = time.perf_counter()
    try:
        mctx.sql(QUERIES[MP_EXIT_QUERY])
        raised, text = None, ""
    except Exception as exc:
        raised, text = type(exc).__name__, str(exc)[:300]
    seconds = time.perf_counter() - t0
    faulthandler.cancel_dump_traceback_later()
    print(f"18(b) rank {rank}: Q{MP_EXIT_QUERY} after rank {world - 1} left: "
          f"{raised} in {seconds:.1f} s: {text}", flush=True)
    return {"exits": False, "raised": raised, "error": text,
            "seconds": seconds, "rank_error": raised == RankError.__name__}


def multiprocess_rank(args) -> int:
    """One rank of 18(b), started by ``multiprocess_cards`` as ``chip_smoke.py
    --rank R --world W --port P``: the tables generated from ``--seed`` at
    ``--sf``, a mesh of one shard per rank (rank ``r`` on ``cuda:r``) whose
    catalog holds this rank's rows (``_mp_catalog``: its bytes on the card
    and the registration's peak), the 22 queries held to 18(a)'s checks
    (the declined ones over gathered columns, a warm run gathering
    nothing), the streamed part (``_mp_stream``, ``_mp_stream_scale``),
    one RF1 appended and Q1 again (``_mp_rf1``), then the exit part
    (``_mp_exit_part``); the answers (on the host), the summary and the
    exit part pickled under ``MP_RANK_DIR`` for the parent.  The process
    ends with ``os._exit``: a rank that left, or one whose communicator
    was aborted, has nothing to tear down."""
    import pickle

    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.parallel import group as G
    from dask_sql_tpu_torch.parallel.mesh import init_multihost

    _mp_env()
    os.environ.pop("DSQL_ADAPTIVE", None)
    os.environ.pop("DSQL_FORCE_GROUPBY", None)
    t0 = time.perf_counter()
    mesh = init_multihost(f"127.0.0.1:{args.port}", args.world, args.rank,
                          device=args.device, local_shards=1)
    dev = mesh.devices[0]
    card = _card(dev)
    tables = generate_tpch(args.sf, args.seed)
    allocated0 = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        allocated0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    mctx = Context(mesh=mesh)
    for name, cols in tables.items():
        mctx.create_table(name, cols)
    catalog = _mp_catalog(mctx, dev, allocated0)
    catalog.update(create_s=time.perf_counter() - t1, card=card)
    print(f"18(b) rank {args.rank} catalog: " + json.dumps(catalog),
          flush=True)
    ready_s = time.perf_counter() - t0
    rows, results = _mp_queries(mctx, f"18(b) rank {args.rank}")
    if args.rank == 0:
        _mp_walls(rows, "18(b) rank 0", card, every=True)
    rendezvous_ms = _rendezvous_ms(mesh.group)
    host = {q: _host_table(r) for q, r in results.items()}
    streamed, stream = _mp_stream(mctx, tables, dev, args.rank)
    scaled, scale = _mp_stream_scale(mctx, OOC_SCALE_SF, args.seed, dev,
                                     args.rank)
    q1_rf1, rf1_facts = _mp_rf1(mctx, tables, args.sf, args.seed)
    print(f"18(b) rank {args.rank} RF1: " + json.dumps(
        dict(rf1_facts, card=card)), flush=True)
    summary = _mp_summary(rows, args.world, time.perf_counter() - t0)
    summary.update(rank=args.rank, device=str(mesh.devices[0]),
                   ready_s=ready_s, rendezvous_ms=rendezvous_ms,
                   catalog=catalog, rf1=rf1_facts, card=card, stream=stream,
                   stream_scale=scale)
    path = os.path.join(MP_RANK_DIR, f"rank{args.rank}.pkl")
    exit_part = _mp_exit_part(mctx, args.rank, args.world)
    with open(path, "wb") as f:
        pickle.dump({"summary": summary, "answers": host,
                     "streamed": streamed, "scaled": scaled,
                     "q1_rf1": _host_table(q1_rf1), "exit": exit_part}, f)
    if exit_part["exits"]:
        # leave as a rank that is gone: no teardown of the communicator
        mesh.group.broken = "this rank left the mesh"
    # rank 0 serves the store and waits in close for every other rank
    G.close(mesh.group)
    sys.stdout.flush()
    os._exit(0)


def multiprocess_cards(sf: float, seed: int, answers: dict, world1: dict,
                       base: dict, n_ranks: int = None,
                       device: str = None) -> dict:
    """18(b): one rank per card (up to four), each a process of its own
    (``multiprocess_rank``) over NCCL, when the machine has two cards or
    more; else one line saying why it is skipped.  Every rank's answers
    equal the resident ones (doubles rtol 1e-9) and rank 0's bit for bit,
    and the served ones 18(a)'s bit for bit where the ranks hold as many
    shards (four); Q1 after the RF1 equals Q1 on a plain context over
    ``base`` after the same append; the streamed answers and uploads are
    held by ``_mp_check_streams`` against the one-card reference that this
    process runs before the ranks start (``mp_stream_reference``).  Then
    the last rank leaves, and every other rank's next query must end in
    ``RankError`` within
    ``MP_EXIT_TIMEOUT_S`` plus ``MP_EXIT_MARGIN_S``; every process must
    have exited within ``MP_RANK_LIMIT_S``."""
    import pickle

    n = n_ranks or min(torch.cuda.device_count(), MP_MAX_RANKS)
    if n < 2:
        print("multiprocess 18(b): skipped, the machine has one card: NCCL "
              "takes one rank per card, so ranks on several cards are not "
              "verified by this run")
        return {"skipped": "one card"}
    t0 = time.perf_counter()
    one_card = mp_stream_reference(torch.device(device or "cuda"), base,
                                   answers, sf, seed)
    os.makedirs(MP_RANK_DIR, exist_ok=True)
    for r in range(n):
        for suffix in ("pkl", "log"):
            path = os.path.join(MP_RANK_DIR, f"rank{r}.{suffix}")
            if os.path.exists(path):
                os.remove(path)
    port = _free_port()
    cmd = [sys.executable, MP_RANK_SCRIPT, "--sf", repr(sf),
           "--seed", str(seed), "--world", str(n), "--port", str(port)]
    if device:
        cmd += ["--device", device]
    paths = [os.path.join(MP_RANK_DIR, f"rank{r}.log") for r in range(n)]
    procs = []
    for r, path in enumerate(paths):
        with open(path, "w") as log:
            procs.append(subprocess.Popen(
                cmd + ["--rank", str(r)], stdout=log,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONUNBUFFERED="1")))
    logs = []
    deadline = time.monotonic() + MP_RANK_LIMIT_S
    try:
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            with open(paths[r]) as f:
                logs.append(f.read())
            if p.returncode:
                # the C++ frames of a native error crowd out the Python ones
                tail = "\n".join(line for line in logs[-1].splitlines()
                                 if "frame #" not in line)
                raise AssertionError(f"18(b) rank {r} exited {p.returncode}:"
                                     f"\n{tail[-6000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    q1_rf1 = _plain_q1_after_rf1(base, sf, seed, device)
    ranks = []
    for r in range(n):
        with open(os.path.join(MP_RANK_DIR, f"rank{r}.pkl"), "rb") as f:
            got = pickle.load(f)
        check_same_result(f"18(b) rank {r} Q1 after RF1", got["q1_rf1"],
                          q1_rf1, rtol=1e-9)
        if r:
            _bit_equal_tables(f"18(b) rank {r} Q1 after RF1 against rank 0",
                              got["q1_rf1"], ranks[0]["q1_rf1"])
        gone = got["exit"]
        if gone["exits"] != (r == n - 1) or (not gone["exits"] and (
                not gone["rank_error"]
                or gone["seconds"] > MP_EXIT_TIMEOUT_S + MP_EXIT_MARGIN_S)):
            raise AssertionError(f"18(b) rank {r} after rank {n - 1} left: "
                                 f"{gone}")
        _mp_check_streams(r, n, got, ranks[0] if r else None, answers,
                          one_card)
        for qid, result in got["answers"].items():
            check_same_result(f"18(b) rank {r} Q{qid}", result, answers[qid],
                              rtol=1e-9)
            if n == MP_SHARDS and qid in got["summary"]["served"]:
                _bit_equal_tables(f"18(b) rank {r} Q{qid} against 18(a)",
                                  result, world1[qid])
            if r:
                _bit_equal_tables(f"18(b) rank {r} Q{qid} against rank 0",
                                  result, ranks[0]["answers"][qid])
        ranks.append(got)
    for r, log in enumerate(logs):
        for line in log.splitlines():
            if line.startswith("18(b) rank") or (r == 0 and line.startswith(
                    ("multiprocess table: ", "multiprocess walls: "))):
                print(line)
    card = ranks[0]["summary"]["card"]
    rows0 = ranks[0]["summary"]["stream"]["rows"]
    for qid in MP_STREAMED:
        row, ref = rows0[qid], one_card[qid]
        print("multiprocess stream: " + json.dumps({
            "q": qid, "ranks": n, "cold_ms": row["cold_ms"],
            "warm_median_ms": row["warm_median_ms"],
            "warm_ms": row["warm_ms"],
            "one_card_cold_ms": ref["cold_ms"],
            "one_card_warm_median_ms": ref["warm_median_ms"],
            "upload_bytes_per_batch": row["upload_bytes_per_batch"],
            "one_card_upload_bytes_per_batch": ref["upload_bytes_per_batch"],
            "tiers": row["tiers"], "fallbacks": row["fallbacks"],
            "gathers": row["gathers"],
            "resident_gather_bytes": row["resident_gather_bytes"],
            "rendezvous_warm": row["rendezvous_warm"],
            "rendezvous_warm_ms": row["rendezvous_warm_ms"],
            "card": card}))
    return {"world_size": n, "seconds": time.perf_counter() - t0,
            "ranks": [g["summary"] for g in ranks],
            "exit": [g["exit"] for g in ranks], "one_card_stream": one_card,
            "stream_q1_launches": rows0[1]["launches"][-1]}


def _mp_check_streams(r: int, n: int, got: dict, first, answers: dict,
                      one_card: dict) -> None:
    """18(b)'s streamed part of rank ``r`` of ``n``: every answer equal to
    phase 7's (doubles rtol 1e-9) and to rank 0's (``first``) bit for bit,
    the scaled ones to rank 0's bit for bit (each rank held them to the
    oracles), and each batch's upload at most the one-card upload over the
    ranks plus one padding row."""
    rows = got["summary"]["stream"]["rows"]
    for qid, result in got["streamed"].items():
        label = f"18(b) rank {r} streamed Q{qid}"
        check_same_result(label, result, answers[qid], rtol=1e-9)
        if first is not None:
            _bit_equal_tables(f"{label} against rank 0", result,
                              first["streamed"][qid])
        whole = one_card[qid]["upload_bytes_per_batch"]
        bound = whole / n + whole / OOC_BATCH_ROWS
        if rows[qid]["upload_bytes_per_batch"] > bound:
            raise AssertionError(f"{label}: {rows[qid]['upload_bytes_per_batch']}"
                                 f" bytes uploaded per batch, above {bound} "
                                 f"(one card {whole} over {n} ranks and a "
                                 f"padding row)")
    if first is not None:
        for qid, result in got["scaled"].items():
            _bit_equal_tables(f"18(b) rank {r} SF {OOC_SCALE_SF} streamed "
                              f"Q{qid} against rank 0", result,
                              first["scaled"][qid])


def _plain_q1_after_rf1(base: dict, sf: float, seed: int, device) -> Table:
    """Q1 over ``base``'s lineitem on one device after the RF1 the ranks of
    18(b) append (``_mp_rf1``'s batch)."""
    from dask_sql_tpu_torch import Context

    keys = base["orders"].column("o_orderkey").data
    first_key = int(keys.max()) + 1
    _, lines = rf1(sf, np.random.RandomState(seed + 18), first_key)
    plain = Context(device=device or "cuda")
    plain.create_table("lineitem", base["lineitem"])
    plain.append_rows("lineitem", lines)
    return _host_table(plain.sql(QUERIES[1]))


def phase_multiprocess(dev, base: dict, answers: dict, sf: float,
                       seed: int) -> dict:
    """Phase 18: the mesh across processes.  18(a) in this process (a
    group of one rank over NCCL), 18(b) over the machine's cards; the
    launch counts set to 0 before each run and read after it."""
    from dask_sql_tpu_torch.parallel import spmd

    _mp_env()
    forget_programs()
    t0 = time.perf_counter()
    world1, results = multiprocess_world1(dev, base, answers)
    spmd.clear_programs()
    forget_programs()
    print("multiprocess summary: " + json.dumps(dict(world1, part="18(a)")))
    t1 = time.perf_counter()
    cards = multiprocess_cards(sf, seed, answers, results, base)
    if "ranks" in cards:
        print("multiprocess summary: " + json.dumps(dict(cards,
                                                         part="18(b)")))
    print(f"multiprocess: world 1 x {MP_SHARDS} shards served "
          f"{world1['served']} with {world1['collectives']} collectives "
          f"({world1['bytes']} bytes) through the group in "
          f"{t1 - t0:.1f} s; 18(b) "
          + ("skipped" if "skipped" in cards else
             f"{cards['world_size']} ranks in {cards['seconds']:.1f} s"))
    return {"world1": world1, "cards": cards}


# ---------------------------------------------------------------------------
# phase 20: the system schema, the autopilot and the fleet plane
# (runtime/{system_tables,autopilot,fleet}.py)
# ---------------------------------------------------------------------------

SYS_DIR = os.path.join("build", "phase20")
#: the autopilot's query: Q1 with its whitespace collapsed (470
#: characters).  The history keeps a text's first 500 characters and the
#: autopilot never acts on a cut text, so Q1 as written (636) never
#: materializes, in either package
AP_Q1 = " ".join(QUERIES[1].split())
#: 20(b): the autopilot with explicit ticks, a candidate at two hits, the
#: result cache on (it holds the view's state), the history under SYS_DIR
AP_ENV = {"DSQL_AUTOPILOT": "1", "DSQL_AUTOPILOT_INTERVAL_S": "0",
          "DSQL_AUTOPILOT_MIN_HITS": "2", "DSQL_RESULT_CACHE_MB": "2048"}
#: 20(b): the daemon's interval beside the tiering build, the query that
#: builds (Q16 scans neither orders nor lineitem, so the appends leave its
#: program's inputs as they are), and the RF1 appends made while it builds
#: (each a refresh for the daemon)
AP_DAEMON_S = "0.05"
AP_BUILD_QUERY = 16
AP_DAEMON_APPENDS = 3
#: 20(c): the query re-planned on the SPMD path (a broadcast join of
#: lineitem and part), and its forced skew: any shard skew trips the hint
#: (max/mean >= 1)
AP_REPLAN_QUERY = 14
AP_FORCED_SKEW = "1.0"
#: 20(d): the heartbeat's interval (the TTL is three of them) and the
#: child replica's scale
FLEET_BEAT_S = "0.2"
FLEET_CHILD_SF = 0.01
FLEET_CHILD_LIMIT_S = 300.0


class _Env:
    """Set environment variables (None: unset) for a block, then restore
    them as they were."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.prev = {k: os.environ.get(k) for k in self.env}
        for k, v in self.env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _stats_rows(ctx, table: str) -> list:
    """``system.table_stats``' rows of one table, collected_ms masked."""
    res = ctx.sql("SELECT * FROM system.table_stats")
    i = res.names.index("collected_ms")
    return [r[:i] + r[i + 1:] for r in res.to_pylist() if r[1] == table]


def sys_tables(dev, ctx) -> dict:
    """20(a): every ``system.*`` table binds and runs on the card; the
    card's row of ``system.devices`` equal to the allocator's reading and
    its total memory; ``system.table_stats`` for lineitem equal to a CPU
    context's over the same table; ``system.mesh`` lists the card, in a
    four-shard mesh's placement too."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.parallel.mesh import Mesh
    from dask_sql_tpu_torch.runtime import system_tables as st

    walls, rows = {}, {}
    for name in st.TABLE_NAMES:
        out = {}
        walls[name] = wall_ms(lambda: out.setdefault(
            "r", ctx.sql(f"SELECT * FROM system.{name}")))
        if out["r"].num_columns == 0:
            raise AssertionError(f"20(a) system.{name}: no columns")
        rows[name] = out["r"].num_rows
    i = torch.cuda.current_device()
    torch.cuda.synchronize()
    in_use = torch.cuda.memory_stats(i)["allocated_bytes.all.current"]
    dev_rows = st.build("devices", ctx).to_pylist()
    want = [i, "gpu", torch.cuda.get_device_name(i), in_use,
            torch.cuda.memory_stats(i)["allocated_bytes.all.peak"],
            torch.cuda.get_device_properties(i).total_memory]
    if len(dev_rows) != torch.cuda.device_count() or dev_rows[i] != want:
        raise AssertionError(f"20(a) system.devices: {dev_rows} != {want}")
    sql_rows = ctx.sql("SELECT * FROM system.devices").to_pylist()
    if sql_rows[i][:3] != want[:3] or sql_rows[i][5] != want[5] \
            or not 0 < sql_rows[i][3] <= sql_rows[i][4]:
        raise AssertionError(f"20(a) system.devices by SQL: {sql_rows}")
    t0 = time.perf_counter()
    cpu = Context(device=torch.device("cpu"))
    cpu.create_table("lineitem", ctx.schema["root"].tables["lineitem"].table)
    card_stats, cpu_stats = _stats_rows(ctx, "lineitem"), \
        _stats_rows(cpu, "lineitem")
    if not card_stats or card_stats != cpu_stats:
        raise AssertionError(f"20(a) system.table_stats: {card_stats} != "
                             f"{cpu_stats}")
    stats_s = time.perf_counter() - t0
    del cpu
    mesh_rows = ctx.sql("SELECT * FROM system.mesh").to_pylist()
    if [r[:3] for r in mesh_rows] != [
            [d, "gpu", torch.cuda.get_device_name(d)]
            for d in range(torch.cuda.device_count())]:
        raise AssertionError(f"20(a) system.mesh: {mesh_rows}")
    mctx = Context(mesh=Mesh([f"cuda:{i}"] * MESH_SHARDS))
    placed = mctx.sql("SELECT device_id, in_mesh, mesh_axes, mesh_size "
                      "FROM system.mesh").to_pylist()
    if [i, True, f"data:{MESH_SHARDS}", MESH_SHARDS] not in placed:
        raise AssertionError(f"20(a) system.mesh of a mesh: {placed}")
    del mctx
    out = {"rows": rows, "ms": walls, "device_row": dev_rows[i],
           "lineitem_stats_columns": len(card_stats),
           "stats_equal_s": stats_s}
    print("system table: " + json.dumps(out))
    return out


def _rf1_append(ctx, sf: float, rng, first_key: int) -> int:
    orders, lineitem = rf1(sf, rng, first_key)
    ctx.append_rows("orders", orders)
    ctx.append_rows("lineitem", lineitem)
    return int(orders["o_orderkey"][-1]) + 4


def _ap_counters() -> dict:
    from dask_sql_tpu_torch.runtime import telemetry as tel

    c = tel.REGISTRY.counters()
    return {k: c.get(k, 0) for k in (
        "autopilot_mv_serves", "autopilot_mv_refreshes",
        "autopilot_mv_creates", "mv_refresh_incremental", "mv_refresh_full",
        "background_compiles_done", "background_compile_errors",
        "background_capture_retries")}


def _moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in _ap_counters().items()}


def _view_stale(ctx, view: str) -> bool:
    reg = ctx._matview_registry
    mv = reg.views[("root", view)]
    with reg.lock:
        kind, _ = reg._staleness(ctx, mv)
    return kind != "fresh"


#: 20(b): a served Q1 against a direct one.  The view keeps each SUM's
#: partial as a double, so a merged sum is rounded twice (the state's, then
#: the merge's) where the direct query rounds the exact total once: a
#: double may differ in its last bits (not bit for bit), and is held to
#: this relative bound; ints, strings and counts are exact
AP_SERVED_RTOL = 1e-12


def _served_equal(name: str, got, want) -> dict:
    """``got`` against ``want`` as ``check_same_result`` holds them at
    ``AP_SERVED_RTOL``; returns the doubles that are not bit for bit equal
    and their largest relative difference."""
    check_same_result(name, got, want, AP_SERVED_RTOL)
    cells, worst = 0, 0.0
    for g, w in zip(got.columns, want.columns):
        gv, wv = g.to_numpy(), w.to_numpy()
        if wv.dtype.kind != "f":
            continue
        diff = gv.view(np.int64) != wv.view(np.int64)
        cells += int(diff.sum())
        if diff.any():
            worst = max(worst, float(np.max(np.abs(gv[diff] - wv[diff])
                                            / np.abs(wv[diff]))))
    return {"doubles_not_bit_equal": cells, "max_rel_diff": worst}


def _direct_q1(ctx):
    """Q1 with the autopilot off, past the result cache: a direct run."""
    with _Env(DSQL_AUTOPILOT="0"):
        out, ms = _direct_ms(ctx, AP_Q1)
    return out, ms


def _served(ctx) -> tuple:
    """(result, wall ms, launches, counters moved) of Q1 served by the
    autopilot, the launch counts set to 0 before it and read after it."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    gk.reset_launch_counts()
    before = _ap_counters()
    out = {}
    ms = wall_ms(lambda: out.setdefault("r", ctx.sql(AP_Q1)))
    launches = dict(gk.LAUNCHES)
    return out["r"], ms, launches, _moved(before)


def ap_views(ctx, sf: float, seed: int) -> dict:
    """20(b): Q1's collapsed text three times, then a tick makes
    ``auto_mv_<fp>``; after one RF1 the next Q1 is served from the view
    after an incremental refresh (two kernel-1 launches: the delta's
    partial and the merge), equal to a direct Q1 (``_served_equal``);
    after a second RF1 a tick refreshes the view (two launches) and Q1 is
    served from it as it stands.  Then the daemon at ``AP_DAEMON_S``
    beside a tiering build of Q16 while RF1s land: the build lands, the
    daemon refreshes, and the served Q1 equals a direct one."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk
    from dask_sql_tpu_torch.runtime import autopilot as ap

    rng = np.random.RandomState(seed + 20)
    first_key = int(ctx.sql("SELECT MAX(o_orderkey) AS m FROM orders")
                    .to_pylist()[0][0]) + 4
    runs = [wall_ms(lambda: ctx.sql(AP_Q1)) for _ in range(3)]
    before = _ap_counters()
    create_ms = wall_ms(lambda: ap.tick(ctx))
    made = ap.engine_section()["managedViews"]
    (rec,) = [r for r in ap.journal_rows() if r["action"] == "mv_create"]
    view = f"auto_mv_{rec['fingerprint'][:12]}"
    if made != [view] or _moved(before)["autopilot_mv_creates"] != 1:
        raise AssertionError(f"20(b): the tick made {made}, not {view}")
    out = {"q1_ms": runs, "create_ms": create_ms, "view": view,
           "fingerprint": rec["fingerprint"], "view_bytes": rec["bytes"]}
    # (1) an RF1, then Q1 served after an incremental refresh
    first_key = _rf1_append(ctx, sf, rng, first_key)
    served, ms, launches, moved = _served(ctx)
    if moved["autopilot_mv_serves"] != 1 \
            or moved["mv_refresh_incremental"] != 1 \
            or moved["mv_refresh_full"] != 0 \
            or launches.get("segsum_fixedpoint", 0) != 2:
        raise AssertionError(f"20(b) served after RF1: {moved}, {launches}")
    direct, direct_ms = _direct_q1(ctx)
    out.update(served_refresh_ms=ms, served_launches=launches,
               direct_ms=direct_ms,
               served_vs_direct=_served_equal("20(b) served Q1", served,
                                              direct))
    # (2) an RF1, a tick refreshes the view, Q1 served as it stands
    first_key = _rf1_append(ctx, sf, rng, first_key)
    gk.reset_launch_counts()
    before = _ap_counters()
    refresh = {}
    out["tick_refresh_ms"] = wall_ms(lambda: refresh.setdefault(
        "r", ap.tick(ctx)))
    tick_launches = dict(gk.LAUNCHES)
    if refresh["r"].get("refreshed") != 1 \
            or _moved(before)["mv_refresh_incremental"] != 1 \
            or tick_launches.get("segsum_fixedpoint", 0) != 2:
        raise AssertionError(f"20(b) tick refresh: {refresh['r']}, "
                             f"{tick_launches}")
    served, ms, launches, moved = _served(ctx)
    if moved["autopilot_mv_serves"] != 1 \
            or moved["mv_refresh_incremental"] != 0:
        raise AssertionError(f"20(b) served fresh: {moved}")
    direct, direct_ms = _direct_q1(ctx)
    out.update(tick_launches=tick_launches, served_fresh_ms=ms,
               served_fresh_launches=launches, direct2_ms=direct_ms,
               served_fresh_vs_direct=_served_equal(
                   "20(b) served Q1 after the tick", served, direct))
    # (3) the daemon beside a tiering background build, RF1s landing
    before = _ap_counters()
    appended = [0]

    def during():
        nonlocal first_key
        if appended[0] < AP_DAEMON_APPENDS:
            first_key = _rf1_append(ctx, sf, rng, first_key)
            appended[0] += 1
        time.sleep(0.01)

    # only refreshes: no new candidate materializes on the daemon thread
    with _Env(DSQL_AUTOPILOT_INTERVAL_S=AP_DAEMON_S,
              DSQL_AUTOPILOT_MIN_HITS="1000000"):
        # Q16's first arrival (eager, its build on a thread of tiering's)
        # starts the autopilot's daemon too
        build, _, _ = _background_build(ctx, AP_BUILD_QUERY, during=during)
        deadline = time.monotonic() + 60
        while _view_stale(ctx, view) and time.monotonic() < deadline:
            time.sleep(0.05)
        daemon_alive = ap._DAEMON is not None and ap._DAEMON.is_alive()
    # the interval back at 0: the daemon's loop ends
    deadline = time.monotonic() + 10
    while ap._DAEMON is not None and time.monotonic() < deadline:
        time.sleep(0.05)
    moved = _moved(before)
    if not daemon_alive or ap._DAEMON is not None:
        raise AssertionError("20(b): the daemon did not run, or did not "
                             "stop")
    if build["background_compile_errors"] or \
            build["background_compiles_done"] < 1 or \
            moved["autopilot_mv_refreshes"] < 1:
        raise AssertionError(f"20(b) daemon beside the build: {build}, "
                             f"{moved}")
    served, ms, launches, moved2 = _served(ctx)
    direct, _ = _direct_q1(ctx)
    out.update(daemon=dict(build, appends=appended[0],
                           daemon_refreshes=moved["autopilot_mv_refreshes"],
                           served_ms=ms,
                           refreshed_at_serve=moved2["mv_refresh_incremental"],
                           served_vs_direct=_served_equal(
                               "20(b) served Q1 after the daemon", served,
                               direct)))
    print("autopilot table: " + json.dumps(out))
    return out


def _new_captures(report) -> int:
    """CUDA graphs captured during a query (its report's counters)."""
    return report.counters.get("graph_captures", 0)


def ap_replan(base: dict) -> dict:
    """20(c): a forced-skew re-plan on the SPMD path.  Q14 on a four-shard
    mesh of the card (phase 17's placement; lineitem and part) with
    ``DSQL_PROFILE`` (the stages' skew probe), ``DSQL_AUTOPILOT_SKEW`` at
    1.0 and the result cache off: the first run (a broadcast join)
    records a hint that flips the join; the next run takes the other
    join, records and captures its stage programs anew (the hint is part
    of the stage key: a new capture, never a replay of the unhinted
    graph), and answers equal to the first (ints exact, doubles rtol
    1e-9: the join feeds the sums in another order); a third replays the
    hinted programs; each hinted run's verdict is journaled."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.parallel.mesh import Mesh
    from dask_sql_tpu_torch.runtime import autopilot as ap
    from dask_sql_tpu_torch.runtime import telemetry as tel

    dev = base["lineitem"].columns[0].data.device
    mctx = Context(mesh=Mesh([dev] * MESH_SHARDS))
    for name in ("lineitem", "part"):
        mctx.create_table(name, base[name])
    runs = []
    with _Env(DSQL_PROFILE="1", DSQL_AUTOPILOT_SKEW=AP_FORCED_SKEW,
              DSQL_RESULT_CACHE_MB="0", DSQL_MESH=None):
        for _ in range(3):
            res = {}
            c0 = tel.REGISTRY.get("spmd_compiles", 0)
            ms = wall_ms(lambda: res.setdefault(
                "r", mctx.sql(QUERIES[AP_REPLAN_QUERY])))
            rep = mctx.last_report
            runs.append({
                "ms": ms, "result": res["r"], "tier": rep.tier,
                "join": [o.split(" ", 1)[0] for o in rep.operators
                         if o.startswith("spmd_join=")],
                "spmd_compiles": tel.REGISTRY.get("spmd_compiles", 0) - c0,
                "captures": _new_captures(rep),
                "replays": rep.counters.get("graph_replays", 0),
                "hinted": any(s.attrs.get("autopilot_hinted")
                              for s in rep.root.walk()),
                "skew": rep.skew_ratio})
    print("replan runs: " + json.dumps([
        {k: v for k, v in r.items() if k != "result"} for r in runs]))
    recs = [r for r in ap.journal_rows() if r["action"] == "hint_record"]
    if len(recs) != 1 or not recs[0]["trigger"].startswith("skew_ratio="):
        raise AssertionError(f"20(c): hint records {recs}")
    fp = recs[0]["fingerprint"]
    hint = ap.get_hint(fp)["hints"]
    first, hinted, again = runs
    flipped = {"spmd_join=broadcast": "exchange",
               "spmd_join=exchange": "broadcast"}.get(
                   (first["join"] or [""])[0])
    if any(r["tier"] != "spmd" for r in runs) or flipped is None \
            or hint.get("join") != flipped or not hinted["hinted"] \
            or hinted["join"] != [f"spmd_join={flipped}"] \
            or hinted["spmd_compiles"] < 1 or hinted["captures"] < 1 \
            or again["captures"] or again["join"] != hinted["join"]:
        raise AssertionError(f"20(c): hint {hint}; runs {runs}")
    for r in (hinted, again):
        check_same_result("20(c) hinted Q14", r["result"], first["result"],
                          1e-9)
    verdicts = [r for r in ap.journal_rows()
                if r["fingerprint"] == fp
                and r["action"] in ("hint_verdict", "hint_strike",
                                    "hint_revert")]
    if len(verdicts) != 2:
        raise AssertionError(f"20(c): verdicts {verdicts}")
    out = {"query": AP_REPLAN_QUERY, "fingerprint": fp,
           "trigger": recs[0]["trigger"], "hint": hint,
           "verdicts": [(v["action"], v["verdict"]) for v in verdicts],
           "runs": [{k: v for k, v in r.items() if k != "result"}
                    for r in runs]}
    print("replan table: " + json.dumps(out))
    del mctx
    return out


def ap_hint_pass(ctx) -> dict:
    """20(e): Q1-Q22 three times each with ``DSQL_PROFILE`` and the
    autopilot armed (every program dropped first, so that each build
    counts its cost; the result cache off, so that every run is a
    sample): the hints recorded, applied, struck and reverted."""
    from dask_sql_tpu_torch.runtime import autopilot as ap
    from dask_sql_tpu_torch.runtime import telemetry as tel

    names = ("autopilot_hints_recorded", "autopilot_hints_applied",
             "autopilot_hints_reverted")
    c0 = {k: tel.REGISTRY.get(k, 0) for k in names}
    # the managed view would answer Q1 (its plan is the view's): forgotten,
    # every query executes
    for view in ap.engine_section()["managedViews"]:
        ctx.sql(f"DROP MATERIALIZED VIEW {view}")
    ap._reset_for_tests()
    forget_programs()
    cost_err, query_of = {}, {}
    t0 = time.perf_counter()
    # a hint file of its own: (c)'s Q14 hint would apply to this Q14
    hints = os.path.abspath(os.path.join(SYS_DIR, "hint-pass.json"))
    with _Env(DSQL_PROFILE="1", DSQL_RESULT_CACHE_MB="0",
              DSQL_AUTOPILOT_FILE=hints):
        for q in sorted(QUERIES):
            for _ in range(3):
                ctx.sql(QUERIES[q])
            rep = ctx.last_report
            cost_err[q] = rep.cost_err
            for s in rep.root.walk():
                if "plan_fp" in s.attrs:
                    query_of[s.attrs["plan_fp"]] = q
    journal = ap.journal_rows()
    acts = [r["action"] for r in journal]
    out = {k: tel.REGISTRY.get(k, 0) - v for k, v in c0.items()}
    out.update(strikes=acts.count("hint_strike"),
               verdicts=acts.count("hint_verdict"),
               seconds=time.perf_counter() - t0,
               hints={f"Q{query_of.get(r['fingerprint'], '?')}":
                      [r["trigger"], json.loads(r["detail"] or "{}")]
                      for r in journal if r["action"] == "hint_record"},
               reverted=[f"Q{query_of.get(r['fingerprint'], '?')}"
                         for r in journal if r["action"] == "hint_revert"],
               cost_err={q: v for q, v in cost_err.items()})
    print("autopilot hints: " + json.dumps(out))
    forget_programs()
    return out


def fleet_replica(args) -> int:
    """20(d)'s child replica, started by ``fleet_plane`` as
    ``chip_smoke.py --replica RID``: a Context on the card (which arms the
    fleet: ``DSQL_FLEET_DIR`` and ``DSQL_REPLICA_ID`` come from the
    parent), TPC-H at ``--sf``, Q1 and Q6 against the numpy oracles, a
    heartbeat, then ``ready`` on stdout and a wait until it is killed (at
    most ``FLEET_CHILD_LIMIT_S``)."""
    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.runtime import fleet

    dev = torch.device(args.device or "cuda")
    tables = generate_tpch(args.sf, args.seed)
    ctx = Context(device=dev)
    for name, cols in tables.items():
        ctx.create_table(name, cols)
    for q, oracle in ((1, oracle_q1), (6, oracle_q6)):
        res = ctx.sql(QUERIES[q])
        check_answer(f"20(d) child Q{q}", {n: c.to_numpy().tolist()
                                            for n, c in zip(res.names,
                                                            res.columns)},
                     oracle(tables["lineitem"]))
    fleet.write_heartbeat_now()
    print("ready " + fleet.replica_id(), flush=True)
    time.sleep(FLEET_CHILD_LIMIT_S)
    return 0


def _fleet_alive(base: str) -> dict:
    status, _, body = _http("GET", f"{base}/v1/fleet")
    if status != 200:
        raise AssertionError(f"20(d) /v1/fleet: {status}")
    snap = json.loads(body)
    return {r["replica"]: bool(r["alive"]) for r in snap["replicas"]}


def fleet_plane(ctx, sf: float, seed: int) -> dict:
    """20(d), last: the fleet armed (its directory under SYS_DIR, beats of
    ``FLEET_BEAT_S``), a server on the card, and a child replica of the
    port on the same card at ``FLEET_CHILD_SF``: both heartbeats alive,
    ``/v1/fleet`` and ``system.replicas`` show two replicas,
    ``system.events`` merges both rings; the child killed, it ages out
    after the TTL.  The variables the fleet set are removed after."""
    import select
    import shutil
    import signal

    from dask_sql_tpu_torch.runtime import events, fleet

    fdir = os.path.abspath(os.path.join(SYS_DIR, "fleet"))
    shutil.rmtree(fdir, ignore_errors=True)
    armed_vars = ("DSQL_EVENTS", "DSQL_EVENTS_FILE", "DSQL_HISTORY_FILE",
                  "DSQL_REPLICA_ID")
    for k in armed_vars:
        os.environ.pop(k, None)
    os.environ.update(DSQL_FLEET_DIR=fdir, DSQL_FLEET_BEAT_S=FLEET_BEAT_S,
                      DSQL_REPLICA_ID="r-main")
    fleet._reset_for_tests()
    events._reset_for_tests()
    t0 = time.perf_counter()
    child = srv = None
    try:
        srv = ctx.run_server(host="127.0.0.1", port=0, blocking=False)
        base = f"http://127.0.0.1:{srv.server_port}"
        env = {k: v for k, v in os.environ.items() if k not in armed_vars}
        env.update(DSQL_REPLICA_ID="r-child", DSQL_TIERED="0")
        err_path = os.path.join(SYS_DIR, "child.err")
        with open(err_path, "w") as err:
            child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--replica",
                 "r-child", "--sf", str(FLEET_CHILD_SF), "--seed",
                 str(seed)], env=env, stdout=subprocess.PIPE, stderr=err,
                text=True)
        ready, _, _ = select.select([child.stdout], [], [],
                                    FLEET_CHILD_LIMIT_S)
        line = child.stdout.readline() if ready else ""
        if not line.startswith("ready r-child"):
            child.kill()
            child.wait(timeout=60)
            with open(err_path) as f:
                raise AssertionError(f"20(d) child: {line!r} "
                                     f"{f.read()[-3000:]}")
        ready_s = time.perf_counter() - t0
        ctx.sql(AP_Q1)                # one query of this replica's own
        alive = _fleet_alive(base)
        reps = ctx.sql("SELECT replica, alive FROM system.replicas"
                       ).to_pylist()
        evs = ctx.sql("SELECT replica, type FROM system.events").to_pylist()
        qs = ctx.sql("SELECT replica FROM system.queries").to_pylist()
        if alive != {"r-main": True, "r-child": True} \
                or sorted(reps) != [["r-child", True], ["r-main", True]] \
                or {r[0] for r in evs} != {"r-main", "r-child"} \
                or {"r-main", "r-child"} - {r[0] for r in qs}:
            raise AssertionError(f"20(d) two replicas: {alive}, {reps}, "
                                 f"{sorted({tuple(r) for r in evs})}")
        t_kill = time.perf_counter()
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
        deadline = time.monotonic() + 10 * fleet.ttl_s() + 5
        while _fleet_alive(base).get("r-child") \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        aged_s = time.perf_counter() - t_kill
        alive = _fleet_alive(base)
        reps = ctx.sql("SELECT replica, alive FROM system.replicas"
                       ).to_pylist()
        if alive != {"r-main": True, "r-child": False} \
                or sorted(reps) != [["r-child", False], ["r-main", True]]:
            raise AssertionError(f"20(d) after the kill: {alive}, {reps}")
        out = {"child_ready_s": ready_s, "aged_out_s": aged_s,
               "ttl_s": fleet.ttl_s(), "events": len(evs),
               "events_by_replica": {r: sum(1 for e in evs if e[0] == r)
                                     for r in ("r-main", "r-child")},
               "seconds": time.perf_counter() - t0}
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        fleet._reset_for_tests()
        events._reset_for_tests()
        for k in armed_vars + ("DSQL_FLEET_DIR", "DSQL_FLEET_BEAT_S"):
            os.environ.pop(k, None)
    print("fleet table: " + json.dumps(out))
    return out


def phase_system(dev, base: dict, sf: float, seed: int) -> dict:
    """Phase 20, after phase 18: a new Context over phase 3's encoded
    tables on the default path (the compiled tier first, the workload
    manager on), (a) the system schema, (b) the autopilot's views with
    the result cache on and its history under SYS_DIR, (c) a forced-skew
    re-plan of an SPMD join, (e) the armed TPC-H hint pass, then (d) the
    fleet, last, so
    that nothing before runs with its variables.  The kernels line's
    ``launches_autopilot`` is (b)'s served Q1 after its RF1: the launch
    counts set to 0 just before it and read just after."""
    import shutil

    from dask_sql_tpu_torch import Context
    from dask_sql_tpu_torch.runtime import autopilot as ap

    _unpin_serving()
    os.environ.pop("DSQL_COMPILE", None)
    shutil.rmtree(SYS_DIR, ignore_errors=True)
    os.makedirs(SYS_DIR, exist_ok=True)
    forget_programs()
    t0 = time.perf_counter()
    ctx = Context(device=dev)
    for name, table in base.items():
        ctx.create_table(name, table)
    out = {"system": sys_tables(dev, ctx)}
    t1 = time.perf_counter()
    hist = os.path.abspath(os.path.join(SYS_DIR, "history.jsonl"))
    try:
        with _Env(DSQL_HISTORY_FILE=hist, **AP_ENV):
            ap._reset_for_tests()
            out["autopilot"] = ap_views(ctx, sf, seed)
            t2 = time.perf_counter()
            out["replan"] = ap_replan(base)
            t3 = time.perf_counter()
            out["hints"] = ap_hint_pass(ctx)
            t4 = time.perf_counter()
    finally:
        ap._reset_for_tests()
        os.environ.update(SERVING_PINS)
    _unpin_serving()
    out["fleet"] = fleet_plane(ctx, sf, seed)
    os.environ.update(SERVING_PINS)
    out["seconds"] = {"system": t1 - t0, "autopilot": t2 - t1,
                      "replan": t3 - t2, "hints": t4 - t3,
                      "fleet": time.perf_counter() - t4,
                      "all": time.perf_counter() - t0}
    print("system summary: " + json.dumps(out["seconds"]))
    del ctx
    forget_programs()
    return out


# ---------------------------------------------------------------------------
# phase 21: the host boundary (input plugins, models with PREDICT, UDFs)
# ---------------------------------------------------------------------------

HB_DIR = os.path.join("build", "phase21")
#: phase 21(a): the libraries of the host boundary
HB_LIBRARIES = ("pandas", "pyarrow", "sklearn", "joblib", "IPython")
HB_FEATURES = ("l_quantity", "l_discount", "l_tax")
HB_TARGET = "l_extendedprice"
#: 21(c)'s chunked lineitem is streamed in this many batches
HB_BATCHES = 6
#: 21(b): the rows the pandas-only surfaces read (a row UDF is a Python
#: call per row)
HB_ROW_UDF_KEYS = 400
HB_UDAF_KEYS = 40_000
HB_MODEL = "CREATE MODEL {name} WITH (model_class = '{cls}', {extra}" \
    "target_column = '" + HB_TARGET + "') AS (SELECT " \
    + ", ".join(HB_FEATURES) + ", " + HB_TARGET + " FROM {table})"
HB_PREDICT = ("SELECT l_returnflag, l_linestatus, SUM(target) AS s, "
              "AVG(target) AS a, COUNT(*) AS n FROM PREDICT(MODEL m, "
              "SELECT l_returnflag, l_linestatus, " + ", ".join(HB_FEATURES)
              + " FROM lineitem) GROUP BY l_returnflag, l_linestatus")


class _Lstsq:
    """An exact least-squares regressor for phase 21: the normal equations
    (with an intercept) accumulated and solved in float64; ``fit`` is one
    ``partial_fit`` over everything.  ``predict`` is elementwise, so its
    bits do not depend on a BLAS's blocking."""

    def __init__(self):
        self.partial_fits_ = 0

    def _normal(self, X, y):
        A = np.column_stack([np.asarray(X, np.float64), np.ones(len(X))])
        return A.T @ A, A.T @ np.asarray(y, np.float64)

    def fit(self, X, y):
        self.ata_, self.aty_ = self._normal(X, y)
        self.coef_ = np.linalg.solve(self.ata_, self.aty_)
        return self

    def partial_fit(self, X, y):
        ata, aty = self._normal(X, y)
        self.ata_ = getattr(self, "ata_", 0.0) + ata
        self.aty_ = getattr(self, "aty_", 0.0) + aty
        self.coef_ = np.linalg.solve(self.ata_, self.aty_)
        self.partial_fits_ += 1
        return self

    def predict(self, X):
        X = np.asarray(X, np.float64)
        out = np.full(len(X), self.coef_[-1])
        for j in range(X.shape[1]):
            out = out + X[:, j] * self.coef_[j]
        return out

    def get_params(self, deep=True):
        return {"solver": "normal equations"}


def host_libraries() -> dict:
    """Whether each library of ``HB_LIBRARIES`` imports, asked in a child
    process (this one imports none of them)."""
    probe = ("import importlib, json\nout = {}\nfor m in %r:\n"
             "    try:\n        importlib.import_module(m)\n"
             "        out[m] = True\n    except Exception:\n"
             "        out[m] = False\nprint(json.dumps(out))"
             % (HB_LIBRARIES,))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _span_ms(report, name: str) -> float:
    return sum(s.wall_ms for s in report.root.walk() if s.name == name)


def _hb_sums(ctx, table: str) -> object:
    return ctx.sql(f"SELECT COUNT(*) AS n, SUM(l_orderkey) AS k, "
                   f"SUM(l_quantity) AS q, SUM(l_extendedprice) AS p, "
                   f"SUM(l_tax) AS t FROM {table}")


def _hb_predict(ctx) -> tuple:
    """The GROUP BY over PREDICT once: its result and walls (the query's,
    and the PREDICT node's input, gather, predict-and-upload from its
    spans; the rest, the GROUP BY and the query's own overheads)."""
    t0 = time.perf_counter()
    got = ctx.sql(HB_PREDICT)
    torch.cuda.synchronize()
    walls = {"query_ms": (time.perf_counter() - t0) * 1e3}
    for span in ("predict_input", "predict_gather", "predict_model"):
        walls[f"{span}_ms"] = _span_ms(ctx.last_report, span)
    walls["group_by_ms"] = walls["query_ms"] - sum(
        walls[f"{span}_ms"] for span in ("predict_input", "predict_gather",
                                         "predict_model"))
    return got, walls


def hb_inputs(dev, ctx, cpu_ctx, base: dict, tables: dict,
              pandas_present: bool) -> dict:
    """21(b): ``create_table`` from a Table, a dict of numpy arrays and a
    list of two dicts (lineitem's numeric columns, the rows split in two
    halves), each answering phase 3's lineitem's sums; then the four
    surfaces that need pandas: each raises ImportError naming it where
    pandas is absent, and equals the CPU's answer where it is present."""
    li = tables["lineitem"]
    numeric = [k for k, v in li.items() if v.dtype.kind in "if"]
    half = len(li[numeric[0]]) // 2
    want = _hb_sums(ctx, "lineitem")
    sources = {
        "from_table": base["lineitem"].limit_to(numeric),
        "from_dict": {k: li[k] for k in numeric},
        "from_list": [{k: li[k][:half] for k in numeric},
                      {k: li[k][half:] for k in numeric}],
    }
    out = {}
    for name, source in sources.items():
        t0 = time.perf_counter()
        ctx.create_table(name, source)
        entry = ctx.schema["root"].tables[name]
        if any(c.data.device.type != dev.type for c in entry.table.columns):
            raise AssertionError(f"21(b) {name}: a column is not on {dev}")
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        check_same_result(f"21(b) {name}", _hb_sums(ctx, name), want,
                          rtol=1e-12)
        ctx.drop_table(name)

    os.makedirs(HB_DIR, exist_ok=True)
    csv_path = os.path.join(HB_DIR, "li.csv")
    keys = li["l_orderkey"] < HB_UDAF_KEYS
    with open(csv_path, "w") as f:
        f.write("l_orderkey,l_quantity,l_tax\n")
        for row in zip(li["l_orderkey"][keys][:2000].tolist(),
                       li["l_quantity"][keys][:2000].tolist(),
                       li["l_tax"][keys][:2000].tolist()):
            f.write("%d,%r,%r\n" % row)
    for c in (ctx, cpu_ctx):
        c.register_function(lambda row: row["a0"] * 2.0 + row["a1"], "rowf",
                            [("x", np.float64), ("y", np.float64)],
                            np.float64, row_udf=True, replace=True)
        c.register_aggregation(lambda s: float(s.max() - s.min()), "span",
                               [("x", np.float64)], np.float64, replace=True)
    surfaces = {
        "csv": lambda c: (c.create_table("csv_t", csv_path),
                          c.sql("SELECT COUNT(*) AS n, SUM(l_tax) AS t "
                                "FROM csv_t"))[1],
        "location": lambda c: (c.sql(
            f"CREATE OR REPLACE TABLE loc_t WITH (location = '{csv_path}', "
            "format = 'csv')"), c.sql("SELECT SUM(l_quantity) AS q, "
                                      "COUNT(*) AS n FROM loc_t"))[1],
        "row_udf": lambda c: c.sql(
            "SELECT l_orderkey, l_linenumber, rowf(l_quantity, l_tax) AS r "
            f"FROM lineitem WHERE l_orderkey < {HB_ROW_UDF_KEYS}"),
        "udaf": lambda c: c.sql(
            "SELECT l_returnflag, span(l_extendedprice) AS s, COUNT(*) AS n "
            f"FROM lineitem WHERE l_orderkey < {HB_UDAF_KEYS} "
            "GROUP BY l_returnflag"),
    }
    for name, run in surfaces.items():
        t0 = time.perf_counter()
        if not pandas_present:
            try:
                run(ctx)
            except ImportError as exc:
                if "pandas" not in str(exc):
                    raise AssertionError(
                        f"21(b) {name}: ImportError without pandas' name: "
                        f"{exc}") from exc
                out[name] = "ImportError"
            else:
                raise AssertionError(
                    f"21(b) {name} ran without pandas: it must raise")
        else:
            check_same_rows(f"21(b) {name}", run(ctx), run(cpu_ctx))
            out[name] = "equal"
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def hb_models(dev, ctx, cpu_ctx, tables: dict) -> dict:
    """21(c): CREATE MODEL, SHOW / DESCRIBE, the GROUP BY over PREDICT
    (kernel 1, counts set to 0 just before it and read just after),
    against the CPU; PREDICT's column against ``predict`` of the host
    matrix, bit for bit; wrap_fit over a chunked lineitem in
    ``HB_BATCHES`` batches; EXPORT MODEL and DROP MODEL."""
    import pickle

    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    cls = f"{__name__}._Lstsq"
    li = tables["lineitem"]
    host_X = np.column_stack([li[c].astype(np.float64) for c in HB_FEATURES])
    out = {}
    for c in (ctx, cpu_ctx):
        c.sql(HB_MODEL.format(name="m", cls=cls, extra="", table="lineitem"))
    report = ctx.last_report
    out["training_query_ms"] = _span_ms(report, "model_training_query")
    out["gather_ms"] = _span_ms(report, "model_gather")
    out["fit_ms"] = _span_ms(report, "model_fit")
    model = ctx.schema["root"].models["m"][0]
    cpu_model = cpu_ctx.schema["root"].models["m"][0]
    if model.coef_.tolist() != cpu_model.coef_.tolist():
        raise AssertionError("21(c): the card's and the CPU's fits differ")
    shown = ctx.sql("SHOW MODELS").to_pylist()
    described = dict(ctx.sql("DESCRIBE MODEL m").to_pylist())
    if shown != [["m"]] or described.get("training_columns") != \
            str(list(HB_FEATURES)):
        raise AssertionError(f"21(c) SHOW / DESCRIBE: {shown} {described}")

    gk.reset_launch_counts()
    got, out["predict_cold"] = _hb_predict(ctx)
    launches = gk.LAUNCHES["segsum_fixedpoint"]
    if launches < 1:
        raise AssertionError("21(c): the GROUP BY over PREDICT launched no "
                             "kernel 1")
    check_same_rows("21(c) PREDICT GROUP BY", got, cpu_ctx.sql(HB_PREDICT))
    out["launches"] = launches
    again, out["predict_warm"] = _hb_predict(ctx)
    check_same_rows("21(c) PREDICT GROUP BY warm", again, got, rtol=0.0)
    col = ctx.sql("SELECT * FROM PREDICT(MODEL m, SELECT "
                  + ", ".join(HB_FEATURES) + " FROM lineitem)"
                  ).column("target").to_numpy()
    want = model.predict(host_X)
    if col.dtype != np.float64 or not np.array_equal(
            col.view(np.int64), want.view(np.int64)):
        raise AssertionError("21(c): PREDICT's column is not predict() of "
                             "the host matrix bit for bit")

    n = len(host_X)
    batch_rows = -(-n // HB_BATCHES)
    ctx.create_table("li_chunked", {c: li[c] for c in HB_FEATURES + (
        HB_TARGET,)}, chunked=True, batch_rows=batch_rows)
    t0 = time.perf_counter()
    ctx.sql(HB_MODEL.format(name="ms", cls=cls, extra="wrap_fit = True, ",
                            table="li_chunked"))
    out["wrap_fit_ms"] = (time.perf_counter() - t0) * 1e3
    streamed = ctx.schema["root"].models["ms"][0]
    rel = np.max(np.abs(streamed.coef_ - model.coef_)
                 / np.maximum(np.abs(model.coef_), 1e-300))
    if streamed.partial_fits_ != HB_BATCHES or rel > 1e-9:
        raise AssertionError(f"21(c) wrap_fit: {streamed.partial_fits_} "
                             f"partial fits, coef rel err {rel}")
    out["wrap_fit_partial_fits"] = streamed.partial_fits_
    out["wrap_fit_coef_rel_err"] = float(rel)
    ctx.drop_table("li_chunked")

    path = os.path.join(HB_DIR, "m.pkl")
    ctx.sql(f"EXPORT MODEL m WITH (format = 'pickle', location = '{path}')")
    with open(path, "rb") as f:
        loaded = pickle.load(f)
    if not np.array_equal(loaded.predict(host_X).view(np.int64),
                          want.view(np.int64)):
        raise AssertionError("21(c): the exported model predicts other bits")
    for c in (ctx, cpu_ctx):
        c.sql("DROP MODEL m")
    if ctx.sql("SHOW MODELS").to_pylist() != [["ms"]]:
        raise AssertionError("21(c): DROP MODEL left m")
    return out


def phase_host_boundary(dev, base: dict, tables: dict) -> dict:
    """Phase 21, after phase 20: a new Context over phase 3's encoded
    tables and a CPU Context over a copy of lineitem's columns; (a) the
    host libraries, (b) the input plugins and the pandas-only surfaces,
    (c) models and PREDICT.  The kernels line's ``launches_predict`` is
    (c)'s GROUP BY over PREDICT."""
    import shutil

    from dask_sql_tpu_torch import Context

    t0 = time.perf_counter()
    shutil.rmtree(HB_DIR, ignore_errors=True)
    os.makedirs(HB_DIR, exist_ok=True)
    libraries = host_libraries()
    print("host libraries: " + json.dumps(libraries))
    forget_programs()
    ctx = Context(device=dev)
    ctx.create_table("lineitem", base["lineitem"])
    cpu_ctx = Context(device=torch.device("cpu"))
    # the CPU's copy of the lineitem columns 21(b) and 21(c) read
    cpu_ctx.create_table("lineitem", base["lineitem"].limit_to(
        ["l_orderkey", "l_linenumber", "l_returnflag", "l_linestatus",
         HB_TARGET, *HB_FEATURES]))
    t1 = time.perf_counter()
    out = {"libraries": libraries,
           "inputs": hb_inputs(dev, ctx, cpu_ctx, base, tables,
                               libraries["pandas"])}
    t2 = time.perf_counter()
    out["models"] = hb_models(dev, ctx, cpu_ctx, tables)
    out["seconds"] = {"setup": t1 - t0, "inputs": t2 - t1,
                      "models": time.perf_counter() - t2,
                      "all": time.perf_counter() - t0}
    print("host boundary table: " + json.dumps(
        {"inputs": out["inputs"], "models": out["models"],
         "seconds": out["seconds"]}))
    del ctx, cpu_ctx
    forget_programs()
    return out


# ---------------------------------------------------------------------------
# phase 22: the program store (build records across processes)
# ---------------------------------------------------------------------------

STORE_DIR = os.path.join("build", "phase22")
#: the static GROUP BYs: kernel 1 launches once per replay
STORE_KERNEL1 = (1, 4, 5, 12, 22)
#: 22(d): on phase 17's four-shard mesh of the card
STORE_MESH_QUERIES = (1, 12)
#: 22(e): the query whose entry is corrupted, whose fingerprint is changed,
#: whose recorded constants are altered (the first of these whose record
#: holds any), and whose record loses its constants while the process's
#: cached uploads are dropped (its capture asks for one)
STORE_CORRUPT, STORE_MISMATCH, STORE_MISSING = 6, 14, 1
STORE_ALTERED = (13, 9, 20, 3, 10)
STORE_CHILD_LIMIT_S = 600.0
#: 22(c) runs only while the script has used less than this many seconds
#: (it takes about a minute of a 1200 s limit)
STORE_CAPS_BEFORE_S = 780.0
#: when main started (22(c)'s budget)
_STARTED = [time.perf_counter()]
#: the script a child of 22(b)/(c) runs (a rehearsal points it at a wrapper)
STORE_CHILD_SCRIPT = os.path.abspath(__file__)


def _store_paths() -> dict:
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), STORE_DIR)
    return {"root": root, "store": os.path.join(root, "store"),
            "caps": os.path.join(root, "caps.json"),
            "answers": os.path.join(root, "answers.pkl")}


def store_arm() -> dict:
    """22(a), before phase 12: ``DSQL_PROGRAM_STORE`` and ``DSQL_CAPS_FILE``
    on an empty directory, so that phase 12's compiled pass (which finds
    nothing there) stores a record after every build."""
    import shutil

    from dask_sql_tpu_torch.physical import compiled

    paths = _store_paths()
    shutil.rmtree(paths["root"], ignore_errors=True)
    os.makedirs(paths["store"], exist_ok=True)
    os.environ["DSQL_PROGRAM_STORE"] = paths["store"]
    os.environ["DSQL_CAPS_FILE"] = paths["caps"]
    compiled._caps_disk = None
    return paths


def _table_arrays(result) -> list:
    return [(name, col.to_numpy())
            for name, col in zip(result.names, result.columns)]


def _same_arrays(got: list, want: list) -> bool:
    """Two answers as column arrays, bit for bit."""
    if [n for n, _ in got] != [n for n, _ in want]:
        return False
    for (_, g), (_, w) in zip(got, want):
        if len(g) != len(w):
            return False
        if w.dtype.kind == "f":
            if g.dtype != w.dtype or not np.array_equal(
                    np.ascontiguousarray(g).view(np.uint8),
                    np.ascontiguousarray(w).view(np.uint8)):
                return False
        elif g.tolist() != w.tolist():
            return False
    return True


def store_populated(paths: dict, rows: list, answers: dict) -> dict:
    """22(a), after phase 12: the store disarmed, its entries and bytes
    printed; phase 12's answers and per-query walls handed to 22(b) in a
    file."""
    import pickle

    from dask_sql_tpu_torch.physical import compiled
    from dask_sql_tpu_torch.runtime import program_store

    os.environ.pop("DSQL_PROGRAM_STORE", None)
    os.environ.pop("DSQL_CAPS_FILE", None)
    compiled._caps_disk = None
    store = program_store.ProgramStore(paths["store"])
    caps_keys = 0
    if os.path.exists(paths["caps"]):
        with open(paths["caps"]) as f:
            caps_keys = len(json.load(f))
    p12 = {r["q"]: {"tier": r["tier"], "reason": r["reason"],
                    "cold_ms": r["cold_ms"],
                    "warmup_ms": r["warmup_ms"] or 0.0,
                    "capture_ms": r["capture_ms"] or 0.0,
                    "builds": r["cold_counters"].get("compiles", 0),
                    "recompiles": r["cold_counters"].get("recompiles", 0)}
           for r in rows}
    with open(paths["answers"], "wb") as f:
        pickle.dump({"answers": {q: _table_arrays(t)
                                 for q, t in answers.items()},
                     "phase12": p12, "mesh": {}}, f)
    out = {"entries": len(store.entries()), "bytes": store.total_bytes(),
           "caps_keys": caps_keys}
    print(f"store: phase 12 stored {out['entries']} build records, "
          f"{out['bytes']} bytes; the caps file holds {caps_keys} programs")
    return out


def store_mesh_records(dev, base: dict, paths: dict) -> dict:
    """22(d)'s records: Q1 and Q12 on a four-shard mesh of the card (phase
    17's) with the store armed; returns their answers."""
    from dask_sql_tpu_torch.parallel import spmd
    from dask_sql_tpu_torch.parallel.mesh import Mesh
    from dask_sql_tpu_torch.runtime import telemetry as tel

    for k in ("DSQL_COMPILE", "DSQL_MESH"):
        os.environ.pop(k, None)
    forget_programs()
    spmd.clear_programs()
    os.environ["DSQL_PROGRAM_STORE"] = paths["store"]
    out = {}
    try:
        mctx, _ = _mesh_context(Mesh([torch.device(dev.type, 0) if dev.type
                                      == "cuda" else dev] * MESH_SHARDS),
                                base)
        for qid in STORE_MESH_QUERIES:
            c0 = tel.REGISTRY.counters()
            result = mctx.sql(QUERIES[qid])
            c1 = tel.REGISTRY.counters()
            d = {k: c1.get(k, 0) - c0.get(k, 0)
                 for k in ("spmd_compiles", "program_store_stores")}
            tier = _last_tier(mctx)[0]
            if tier != "spmd" or d["spmd_compiles"] < 1 \
                    or d["program_store_stores"] < d["spmd_compiles"]:
                raise AssertionError(f"22(d) Q{qid}: {tier}, {d}")
            out[qid] = _table_arrays(result)
            print(f"store mesh: Q{qid} stored {d['program_store_stores']} "
                  f"stage records ({tier})")
        del mctx
    finally:
        os.environ.pop("DSQL_PROGRAM_STORE", None)
        spmd.clear_programs()
        forget_programs()
    return out


def store_process_mesh(dev, base: dict, paths: dict, want: dict) -> dict:
    """22(d) across processes: Q1 and Q12 on a one-rank process group
    holding four shards of the card (18(a)'s mesh) with the store armed,
    twice, each pass after every stage program was dropped: the first
    builds and stores this rank's stage records, the second makes every
    stage program from them (``spmd_store_hits`` as many as the first
    pass's builds, no ``spmd_compiles``), answers bit for bit the first
    pass's and ``want``'s (the same four shards in one process)."""
    from dask_sql_tpu_torch.parallel import group as G
    from dask_sql_tpu_torch.parallel import spmd
    from dask_sql_tpu_torch.parallel.mesh import init_multihost
    from dask_sql_tpu_torch.runtime import telemetry as tel

    names = ("spmd_compiles", "spmd_store_hits", "spmd_eager_stages",
             "program_store_stores", "program_store_errors",
             "mesh_process_collectives")
    device = "cpu" if dev.type == "cpu" else "cuda:0"
    mesh = init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, device=device,
                          local_shards=MESH_SHARDS)
    os.environ["DSQL_PROGRAM_STORE"] = paths["store"]
    passes, failures = [], []
    try:
        mctx, _ = _mesh_context(mesh, base)
        for n in (1, 2):
            spmd.clear_programs()
            done = {}
            for qid in STORE_MESH_QUERIES:
                box = {}
                c0 = tel.REGISTRY.counters()
                cold = wall_ms(lambda: box.update(r=mctx.sql(QUERIES[qid])))
                c1 = tel.REGISTRY.counters()
                done[qid] = {"tier": _last_tier(mctx)[0], "cold_ms": cold,
                             "result": _table_arrays(box["r"]),
                             **{k: c1.get(k, 0) - c0.get(k, 0)
                                for k in names}}
            passes.append(done)
        del mctx
    finally:
        os.environ.pop("DSQL_PROGRAM_STORE", None)
        spmd.clear_programs()
        G.close(mesh.group)
    out = {}
    for qid in STORE_MESH_QUERIES:
        built, hit = passes[0][qid], passes[1][qid]
        got = hit.pop("result")
        row = {"q": qid, "equal": _same_arrays(got, built.pop("result"))
               and _same_arrays(got, want[qid]), "build": built, "hit": hit}
        print("store mesh: process " + json.dumps(row))
        if (built["tier"] != "spmd" or hit["tier"] != "spmd"
                or not row["equal"] or hit["spmd_compiles"]
                or hit["spmd_eager_stages"] or built["spmd_eager_stages"]
                or built["spmd_compiles"] < 1
                or hit["spmd_store_hits"] != built["spmd_compiles"]
                or hit["mesh_process_collectives"]
                != built["mesh_process_collectives"]):
            failures.append(f"22(d) across processes Q{qid}: {row}")
        out[qid] = row
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def _store_query(ctx, qid: int, handed: dict, mode: str) -> dict:
    """22(b)/(c) for one query: the cold run (a record's capture and
    replay, or a build) and one warm replay, the launch counts set to 0
    before each run and read after it."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk

    text = QUERIES[qid]
    box = {}
    gk.reset_launch_counts()
    cold = wall_ms(lambda: box.update(r=ctx.sql(text)))
    cold_k1 = gk.LAUNCHES["segsum_fixedpoint"]
    tier, reason, counters = _last_tier(ctx)
    rep = ctx.last_report.counters
    graph = _graph_attrs(ctx)
    gk.reset_launch_counts()
    warm = wall_ms(lambda: box.update(w=ctx.sql(text)))
    k1 = gk.LAUNCHES["segsum_fixedpoint"]
    want = handed["answers"][qid]
    row = {"q": qid, "mode": mode, "tier": tier, "reason": reason,
           "cold_ms": cold, "warmup_ms": graph.get("warmup_ms", 0.0),
           "capture_ms": graph.get("capture_ms", 0.0),
           "builds": counters.get("compiles", 0),
           "recompiles": counters.get("recompiles", 0),
           "program_store_hits": rep.get("program_store_hits", 0),
           "program_store_errors": rep.get("program_store_errors", 0),
           "program_store_rejects": rep.get("program_store_rejects", 0),
           "graph_captures": counters.get("graph_captures", 0),
           "cold_kernel1": cold_k1, "kernel1_per_replay": k1,
           "warm_ms": warm,
           "equal": (_same_arrays(_table_arrays(box["r"]), want)
                     and _same_arrays(_table_arrays(box["w"]), want))}
    print("store table: " + json.dumps(row))
    return row


def _entry_digests(ctx, store, qid: int) -> list:
    """The store digests a fresh run of ``qid`` loads (their ``used_at``
    moves on a hit)."""
    forget_programs(learned=True)
    before = {d: e.get("used_at") for d, e in store.entries().items()}
    ctx.sql(QUERIES[qid])
    return sorted(d for d, e in store.entries().items()
                  if e.get("used_at") != before.get(d))


def _rewrite_entry(store, digest: str, change) -> None:
    import pickle

    path = store._entry_path(digest)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    change(raw)
    with open(path, "wb") as f:
        pickle.dump(raw, f)


def store_fallbacks(ctx, handed: dict) -> dict:
    """22(e): each damaged entry falls back to a build, counted, with the
    answer equal to phase 12's."""
    from dask_sql_tpu_torch.ops import gpu_kernels as gk
    from dask_sql_tpu_torch.physical import compiled
    from dask_sql_tpu_torch.runtime import program_store

    store = program_store.get_store()
    names = ("program_store_errors", "program_store_rejects",
             "program_store_hits", "compiles")

    def damaged_run(label: str, qid: int, counter: str) -> dict:
        forget_programs(learned=True)
        before = dict(compiled.stats)
        result = ctx.sql(QUERIES[qid])
        d = _counter_delta(before, names)
        equal = _same_arrays(_table_arrays(result), handed["answers"][qid])
        if d[counter] < 1 or d["compiles"] < 1 or not equal:
            raise AssertionError(f"22(e) {label} Q{qid}: {d}, equal {equal}")
        print(f"store fallback: {label} entry of Q{qid} -> {counter} "
              f"{d[counter]}, rebuilt ({d['compiles']} builds), answer equal")
        return {"q": qid, **d, "equal": equal}

    out = {}
    (digest,) = _entry_digests(ctx, store, STORE_CORRUPT)
    with open(store._entry_path(digest), "wb") as f:
        f.write(b"\x80corrupt")
    out["corrupt"] = damaged_run("corrupt", STORE_CORRUPT,
                                 "program_store_errors")

    (digest,) = _entry_digests(ctx, store, STORE_MISMATCH)
    _rewrite_entry(store, digest, lambda raw: raw["fingerprint"].update(
        device="cuda:another card"))
    out["fingerprint"] = damaged_run("fingerprint", STORE_MISMATCH,
                                     "program_store_rejects")

    import pickle
    for qid in STORE_ALTERED:
        digests = _entry_digests(ctx, store, qid)
        with_consts = []
        for d in digests:
            with open(store._entry_path(d), "rb") as f:
                if pickle.load(f)["consts"]:
                    with_consts.append(d)
        if with_consts:
            break
    else:
        raise AssertionError(f"22(e): no record of {STORE_ALTERED} holds a "
                             f"constant")

    def alter(raw):
        key, (arr, n) = next(iter(raw["consts"].items()))
        arr = arr.copy()
        arr.reshape(-1).view(np.uint8)[0] ^= 1
        raw["consts"][key] = (arr, n)

    for d in with_consts:
        _rewrite_entry(store, d, alter)
    out["altered_consts"] = damaged_run("altered-constants", qid,
                                        "program_store_errors")

    for d in _entry_digests(ctx, store, STORE_MISSING):
        _rewrite_entry(store, d, lambda raw: raw.update(consts={}))
    # the process's cached uploads dropped: the capture asks for them
    gk._row_layout.cache_clear()
    gk._kernel_plan.cache_clear()
    out["missing_consts"] = damaged_run("constant-less", STORE_MISSING,
                                        "program_store_errors")
    return out


def store_child_mesh(ctx, handed: dict) -> dict:
    """22(d) in the child: Q1 and Q12 on a four-shard mesh of the card over
    its own tables, from the stored stage records."""
    from dask_sql_tpu_torch.parallel.mesh import Mesh
    from dask_sql_tpu_torch.runtime import telemetry as tel

    base = {name: entry.table
            for name, entry in ctx.schema["root"].tables.items()}
    dev = ctx.device
    mctx, _ = _mesh_context(Mesh([torch.device(dev.type, 0) if dev.type ==
                                  "cuda" else dev] * MESH_SHARDS), base)
    out = {}
    for qid in STORE_MESH_QUERIES:
        box = {}
        c0 = tel.REGISTRY.counters()
        cold = wall_ms(lambda: box.update(r=mctx.sql(QUERIES[qid])))
        c1 = tel.REGISTRY.counters()
        d = {k: c1.get(k, 0) - c0.get(k, 0)
             for k in ("spmd_queries", "spmd_compiles", "spmd_store_hits",
                       "program_store_errors", "spmd_eager_stages")}
        row = {"q": qid, "tier": _last_tier(mctx)[0], "cold_ms": cold, **d,
               "equal": _same_arrays(_table_arrays(box["r"]),
                                     handed["mesh"][qid])}
        print("store mesh: " + json.dumps(row))
        out[qid] = row
    return out


def store_child(args) -> int:
    """22(b) (``--store-child store``) and (c) (``--store-child caps``): a
    fresh process, the same tables from the same seed, Q1-Q22 compiled
    over the store (or over the caps file alone); then, over the store,
    22(d) and 22(e).  Prints ``store table:`` lines and a ``store child:``
    JSON line."""
    import pickle
    import traceback

    paths = _store_paths()
    for k in [k for k in os.environ if k.startswith("DSQL_")]:
        os.environ.pop(k)
    os.environ.update({"DSQL_TIERED": "0", "DSQL_EAGER_FALLBACK": "0",
                       **SERVING_PINS})
    if args.store_child == "store":
        os.environ["DSQL_PROGRAM_STORE"] = paths["store"]
    else:
        os.environ["DSQL_CAPS_FILE"] = paths["caps"]
    with open(paths["answers"], "rb") as f:
        handed = pickle.load(f)
    t0 = time.perf_counter()
    tables = generate_tpch(args.sf, args.seed)
    ctx, create_s = register(torch.device(args.device or "cuda"), tables)
    del tables
    out = {"mode": args.store_child, "setup_s": time.perf_counter() - t0,
           "create_s": create_s, "rows": [], "failures": []}
    parts = [("queries", lambda: out["rows"].extend(
        _store_query(ctx, q, handed, args.store_child)
        for q in sorted(QUERIES)))]
    if args.store_child == "store":
        parts += [("mesh", lambda: out.update(mesh=store_child_mesh(
            ctx, handed))),
                  ("fallbacks", lambda: out.update(fallbacks=store_fallbacks(
                      ctx, handed)))]
    for label, part in parts:
        try:
            part()
        except Exception as exc:   # reported together by the parent
            traceback.print_exc()
            out["failures"].append(f"{label}: {type(exc).__name__}: {exc}")
    print("store child: " + json.dumps(out))
    return 0


def _run_store_child(mode: str, sf: float, seed: int) -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("DSQL_")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, STORE_CHILD_SCRIPT, "--store-child", mode,
         "--sf", str(sf), "--seed", str(seed)],
        cwd=here, env=env, capture_output=True, text=True,
        timeout=STORE_CHILD_LIMIT_S)
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        if not line.startswith("store child: "):
            print(line)
    if proc.returncode != 0 or not lines \
            or not lines[-1].startswith("store child: "):
        raise AssertionError(f"22 {mode} child failed ({proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    out = json.loads(lines[-1][len("store child: "):])
    out["process_s"] = time.perf_counter() - t0
    if out["failures"]:
        print(proc.stderr[-3000:])
    return out


def _store_sums(rows) -> dict:
    rows = list(rows)
    return {k: sum(r[k] for r in rows)
            for k in ("cold_ms", "warmup_ms", "capture_ms", "builds",
                      "recompiles")}


def phase_store(dev, base: dict, sf: float, seed: int,
                populated: dict) -> dict:
    """Phase 22, last: (d)'s stage records from this process, (b) the
    fresh child over the store, (c) the fresh child over the caps file
    alone where the time allows, the checks, and the ``store summary:``
    line."""
    import pickle

    t0 = time.perf_counter()
    paths = _store_paths()
    mesh_answers = store_mesh_records(dev, base, paths)
    process_mesh = store_process_mesh(dev, base, paths, mesh_answers)
    with open(paths["answers"], "rb") as f:
        handed = pickle.load(f)
    handed["mesh"] = mesh_answers
    with open(paths["answers"], "wb") as f:
        pickle.dump(handed, f)
    p12 = handed["phase12"]
    child = _run_store_child("store", sf, seed)
    used = time.perf_counter() - _STARTED[0]
    caps = None
    if used < STORE_CAPS_BEFORE_S:
        caps = _run_store_child("caps", sf, seed)
    else:
        print(f"store: 22(c) skipped, {used:.0f} s used of the "
              f"{STORE_CAPS_BEFORE_S:.0f} s it needs to start within")
    failures = list(child["failures"]) + (caps or {}).get("failures", [])
    for r in child["rows"]:
        q = r["q"]
        if not r["equal"]:
            failures.append(f"Q{q}: the answer is not phase 12's")
        if p12[q]["builds"] and (r["builds"] or r["recompiles"]):
            failures.append(f"Q{q}: {r['builds']} builds, {r['recompiles']} "
                            f"recompiles from the store")
        if q in STORE_KERNEL1 and r["kernel1_per_replay"] != 1:
            failures.append(f"Q{q}: kernel 1 launched "
                            f"{r['kernel1_per_replay']} times per replay")
        if ("runtime" in p12[q]["reason"]) != ("runtime" in r["reason"]):
            failures.append(f"Q{q}: {r['reason']!r}, phase 12 "
                            f"{p12[q]['reason']!r}")
    for q, m in (child.get("mesh") or {}).items():
        if (m["tier"] != "spmd" or m["spmd_compiles"] or not m["equal"]
                or m["spmd_store_hits"] < 1):
            failures.append(f"22(d) Q{q}: {m}")
    for r in (caps or {}).get("rows", []):
        if not r["equal"]:
            failures.append(f"22(c) Q{r['q']}: the answer is not phase 12's")
    hits = [r for r in child["rows"] if r["program_store_hits"]]
    summary = {
        "phase12": _store_sums(p12.values()),
        "store": {**_store_sums(child["rows"]),
                  "hits": sum(r["program_store_hits"] for r in hits),
                  "setup_s": child["setup_s"],
                  "process_s": child["process_s"]},
        "caps": None if caps is None else {
            **_store_sums(caps["rows"]), "setup_s": caps["setup_s"],
            "process_s": caps["process_s"]},
        "hit_skipped_warmup": bool(hits) and all(
            r["warmup_ms"] == 0 for r in hits),
        "entries": populated["entries"], "bytes": populated["bytes"],
        "mesh": child.get("mesh"), "process_mesh": process_mesh,
        "fallbacks": child.get("fallbacks"),
        "kernel1_launches": sum(r["cold_kernel1"] + r["kernel1_per_replay"]
                                for r in child["rows"]),
        "seconds": time.perf_counter() - t0}
    print("store summary: " + json.dumps(summary))
    if failures:
        raise AssertionError("phase 22: " + "; ".join(failures))
    return summary


def main_multiprocess(args) -> int:
    """``--only multiprocess``: the kernels built, the tables at ``--sf``
    and their eager answers (phase 7's), then phase 18; on a machine of
    four cards 18(b) runs a rank on each.  Prints a ``multiprocess only:``
    JSON line last."""
    os.environ.pop("DSQL_ADAPTIVE", None)
    os.environ.pop("DSQL_FORCE_GROUPBY", None)
    os.environ.update({"DSQL_TIERED": "0", "DSQL_EAGER_FALLBACK": "0",
                       **SERVING_PINS})
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    card = phase_environment()
    phase_build()
    ctx, tables = phase_data(dev, args.sf, args.seed)
    base = {name: entry.table
            for name, entry in ctx.schema["root"].tables.items()}
    os.environ["DSQL_COMPILE"] = "0"
    answers = {q: ctx.sql(QUERIES[q]) for q in sorted(QUERIES)}
    os.environ.pop("DSQL_COMPILE")
    del ctx, tables
    multi = phase_multiprocess(dev, base, answers, args.sf, args.seed)
    print(f"card: {card}")
    print("multiprocess only: " + json.dumps({
        "ok": True, "cards": torch.cuda.device_count(),
        "world1_served": multi["world1"]["served"],
        "ranks": multi["cards"].get("world_size"),
        "exit": multi["cards"].get("exit"),
        "launches_multiprocess_stream": multi["cards"].get(
            "stream_q1_launches"),
        "seconds": time.perf_counter() - t0}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sf", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    # one rank of phase 18(b), started by the script itself
    for flag in ("--rank", "--world", "--port"):
        p.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    # phase 20(d)'s child replica, started by the script itself
    p.add_argument("--replica", default=None, help=argparse.SUPPRESS)
    # phase 22's fresh processes, started by the script itself
    p.add_argument("--store-child", default=None, choices=("store", "caps"),
                   help=argparse.SUPPRESS)
    p.add_argument("--only", default=None, choices=("multiprocess",),
                   help="run only phase 18 and the set-up it needs (with "
                        "four cards, 18(b) runs four ranks)")
    args = p.parse_args(argv)
    _STARTED[0] = time.perf_counter()
    rehearsal = (args.rank is not None or args.replica is not None
                 or args.store_child is not None) and args.device == "cpu"
    if not torch.cuda.is_available() and not rehearsal:
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import dask_sql_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable: {exc}", file=sys.stderr)
        return 3
    from dask_sql_tpu_torch import Context

    if args.rank is not None:
        return multiprocess_rank(args)
    if args.replica is not None:
        return fleet_replica(args)
    if args.store_child is not None:
        return store_child(args)
    if args.only == "multiprocess":
        return main_multiprocess(args)
    # the production default: statistics-driven dispatch, nothing forced;
    # phases 4-8 and 10-11 measure the eager executor (DSQL_COMPILE=0) as
    # they did before the compiled tier, phases 9 and 12 the compiled tier
    os.environ.pop("DSQL_ADAPTIVE", None)
    os.environ.pop("DSQL_FORCE_GROUPBY", None)
    os.environ["DSQL_COMPILE"] = "0"
    # the compiled phases: cold means trace, warm-up and capture (no eager
    # first arrival), and no failure turns into an eager answer; phase 13
    # turns each on where it tests it
    os.environ["DSQL_TIERED"] = "0"
    os.environ["DSQL_EAGER_FALLBACK"] = "0"
    # phases 1-13 measure the engine: the result cache and the workload
    # manager stay off until phase 14 (bench.py pins the JAX package so)
    os.environ.update(SERVING_PINS)
    dev = torch.device("cuda")
    card = phase_environment()
    phase_build()
    ctx, tables = phase_data(dev, args.sf, args.seed)
    # phase 3's encoded tables, for phase 17 (phases 14 and 16 replace
    # entries of the context)
    base = {name: entry.table
            for name, entry in ctx.schema["root"].tables.items()}
    q1_args, q1_cold_ms, q1_launches = capture_q1_reduction(ctx)
    kernel1 = phase_kernel1(dev, q1_args)
    kernel2 = phase_kernel2(dev, q1_args)
    # the card's tables, copied to the CPU as they are encoded
    cpu_ctx = Context(device=torch.device("cpu"))
    for name, entry in ctx.schema["root"].tables.items():
        cpu_ctx.create_table(name, entry.table)
    phase_stats(ctx, cpu_ctx)
    launches, on_results, eager_rows = phase_slice(
        ctx, tables, (q1_cold_ms, q1_launches), cpu_ctx)
    del cpu_ctx
    profiles = {q: profile_query(ctx, f"Q{q}", QUERIES[q])
                for q in (1, 4, 5, 6, 9)}
    print("profiles: " + json.dumps(profiles))
    off_launches = phase_adaptive(ctx, on_results)
    print(f"launches: eager path (adaptive on) {launches}, adaptive off and "
          f"forced {off_launches}")
    store_paths = store_arm()
    compiled_launches, compiled_rows, compiled_answers = phase_compiled(
        ctx, on_results, eager_rows)
    populated = store_populated(store_paths, compiled_rows, compiled_answers)
    print(f"launches: compiled tier (the main path) {compiled_launches}")
    phase_params(ctx)
    phase_stages(ctx, on_results)
    phase_tiering(ctx, on_results)
    phase_ladder(ctx, on_results)
    observability = phase_observability(ctx, compiled_answers, q1_args)
    del compiled_answers
    phase_serving(ctx, tables, on_results, compiled_rows)
    phase_oracle(dev, ORACLE_SF, args.seed)
    os.environ["DSQL_COMPILE"] = "0"
    phase_functions(dev, args.seed)
    surface = phase_surface(ctx, tables) + phase_cliff(dev, args.seed)
    for row in surface:
        print("surface table: " + json.dumps(row))
    phase_frontend(ctx)
    phase_statements(ctx, tables, on_results[1])
    ooc = phase_ooc(dev, ctx, tables, on_results, args.seed)
    write = phase_write(dev, ctx, tables, args.sf, args.seed)
    del ctx
    mesh = phase_mesh(dev, base, tables, on_results, compiled_rows, args.sf,
                      args.seed)
    multi = phase_multiprocess(dev, base, on_results, args.sf, args.seed)
    system = phase_system(dev, base, args.sf, args.seed)
    host_boundary = phase_host_boundary(dev, base, tables)
    del tables
    store = phase_store(dev, base, args.sf, args.seed, populated)
    kernel1["launches"] = compiled_launches["segsum_fixedpoint"]
    kernel1["launches_out_of_core_q1"] = ooc["q1_launches"]
    kernel1["launches_write_path"] = write["launches"]["segsum_fixedpoint"]
    kernel1["launches_mesh"] = mesh["summary"]["kernel1_launches"].get(
        "segsum_fixedpoint", 0)
    kernel1["launches_multiprocess"] = multi["world1"]["kernel1_launches"]
    # rank 0's streamed Q1 (its merge) across cards: None on one card
    kernel1["launches_multiprocess_stream"] = multi["cards"].get(
        "stream_q1_launches")
    kernel1["launches_profiled_q1"] = observability["q1_launches"]
    kernel1["launches_autopilot"] = system["autopilot"]["served_launches"].get(
        "segsum_fixedpoint", 0)
    kernel1["launches_predict"] = host_boundary["models"]["launches"]
    kernel1["launches_program_store"] = store["kernel1_launches"]
    print(f"card: {card}")
    print(json.dumps({"kernels": [kernel1, kernel2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
