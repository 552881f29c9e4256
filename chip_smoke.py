"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-cards   # phase 25 (e) alone, several cards

Phases (any failure raises and the exit code is not 0):

1. the card: name and power limit (``nvidia-smi``), device name;
2. build the port's CUDA kernels (K1, K2, K3) from the sources in this
   checkout, with one ``nvcc`` call;
3. hold kernel K1 (the ring window) bit for bit against its plain
   PyTorch version at every shape of ``RING_SHAPES`` and every shape the
   main paths give it (``RING_MAIN_SHAPES``, ``tests/test_torch_cases.py``),
   with ``q_head`` in [0, Q) and in [-2Q, 2Q), and time it at each
   main-path shape beside its memory bound, a device ``copy_`` of the
   same byte count (the card's practical streaming rate), the plain
   version and ``torch.gather``;
4. hold kernel K2 (the timer-wheel scan) bit for bit against its plain
   version at both cfg4 shapes (the wheel build, N=100000 and 768
   buckets, on real entry keys; the stop wheel, 256 buckets, on stop
   packs with KEY_INF) and odd shapes, and through a sequence of calls
   that shows its workspace is left clean (build, every lane masked,
   stop wheel, build); time it beside its bound, the launch floor (a
   one-element ``fill_``), the plain version and the library calls;
4b. hold kernel K3 (the ingest's reactivation recurrence) bit for bit
   against its plain version on the inputs two real ingests on the card
   hand it (a 1,024-row queue flush on 16,384 slots, and a cluster
   server's first wave, 10,000 rows that all reactivate; each ingest
   held whole against the CPU's) and on synthetic rows at the int64
   edges, joined tags leaving the set among them, and on inputs that
   leave its block-parallel scan by each door (none, a wrap caught by
   the local check, a leaving tag, the running minimum crossing the
   trigger in a later tile, more rows than a tile), each case's exit
   row logged; time it at both real shapes beside its byte bound, the
   launch floor, the serial chain over the rows it walks, its plain
   version and the host recurrence it replaced (no library call
   computes it);
5. exactness: at a small shape the prefix-commit epochs' decision
   stream and final state equal the port's own serial engine;
6. the ``serve`` path: ``serve_only`` at the workload's full width
   (100,000 clients, a 320-slot ring, m=32 batches of up to k=65536
   decisions), launch counts reset just before and read just after; its
   first decisions are held against the serial engine at full width;
   then the epochs are timed on the card;
7. calendar exactness: at a small shape the wheel epoch's per-client
   counts and final state equal the serial engine's, the wheel equals
   the bucketed ladder, and one ladder level equals minstop;
8. the ``cfg4_wheel`` path (bench's ``cfg4_wheel`` row): bench's
   calibration on the wheel (``serve.cfg4_setup``: the warm round and 5
   iterations of 2 rounds toward a 0.5 reservation share) and then
   ``serve.cfg4_rounds(calendar_impl="wheel")`` at full width (100,000
   clients, ring 128, 64 waves, m=3 batches, 64 steps, 8 levels), launch
   counts reset just before the calibration and read after the rounds
   (K1 24 and K2 27 per round, the captured round's warm-up and the 11
   calibration rounds included); the
   calibrated rates' sum, the ``resv_inv`` digest and the measured
   reservation share printed; one full-width round with telemetry, SLO
   and provenance on,
   wheel equal to the bucketed ladder on every output, the state and
   the four accumulators, its decisions equal to the telemetry-off
   round's; then rounds are timed, ingest included;
9. knob exactness at small shapes: radix epochs equal sort epochs;
   ``tag_width=32`` prefix (sort and radix), chain and calendar epochs
   (all three schemes) equal ``tag_width=64`` on a high-rate state; a
   chain epoch on a variable-cost stream (chains fire) equals the
   serial engine, stream and final state;
10. the ``serve_radix`` path: the serve shape with radix selection, K1
    once per epoch, every output and the state equal to the sort serve
    of phase 6; then timed;
11. the ``tag_width=32`` path on the high-rate state (rates x1000,
    N=100,000, ring 128 preloaded 128 deep): every output equals
    ``tag_width=64``, no fallback, the first 512 decisions equal the
    serial engine's, both widths timed side by side; then one
    default-rate serve epoch at ``tag_width=32``, whose carry trips: one
    fallback, every batch from the trip on empty, the committed batches
    equal the int64 run's and the state equals that run's after them;
12. the ``chain`` paths (chain depth 4, m=8, k=65536), K1 once per
    batch, the first 512 expanded decisions equal to the serial
    engine's, the unit-length histogram, timed: on the serve state at
    20 ms (every unit one decision long: each request costs 1), then
    ``chain_vc`` on the same backlog with per-request costs 1..4
    (``serve.variable_cost_state``) at 0 ms, where units of two
    decisions occur among the checked ones;
13. the planner view: ``calendar_stop_ladder`` at the cfg4 shape after
    one round's ingest (8 levels) equals numpy's quantiles of the finite
    stop packs, is nondecreasing, and its rank-1 key is the minimum;
14. the ``cfg3`` path (bench's ``cfg3`` row): bench's calibration (the
    warm round and one iteration of 2 rounds; ``serve.cfg3_setup``), then
    ``serve.cfg3_rounds`` from the calibrated state and time at full
    width (10,000 clients, weights 1-4, reservation 100 ops/s, ring 256
    preloaded 128 deep, 32 waves in 100 ms rounds, m=32 prefix batches
    of k=4096) with telemetry, SLO (its contracts re-registered from the
    calibrated state) and provenance on, launch counts reset just before
    the calibration and read after the rounds (K1 once a round); the
    calibration and the first timed round held against a CPU twin
    (``sustained_twins``, a child process started as the phase begins,
    collected at the end: the calibrated rates, state and draws, every
    output, the state and the accumulators after the round);
    every round's guards, its metrics' decision row, and the growth of
    the ledger's and the SLO block's ops against its counts; timed
    rounds (median, mean and median-based rates); bench's derived
    scalars; then telemetry on against off, rounds alternated from one
    state: decisions, state and metrics equal, the time ratio printed;
15. the ``cfg3_stream`` path: one stream chunk of 8 rounds
    (``engine.stream``), launch-counted (K1 once an epoch), equal to the
    8 rounds of the round loop in the state, every per-round output and
    the four accumulators (the metrics but for ``ingest_drops``, which
    the chunk does not count); chunk and round loop timed from the same
    state; one chunk run under ``torch.cuda.set_sync_debug_mode("warn")``
    and its synchronizing operations counted;
16. the ``cfg4`` path (bench's ``cfg4`` row, minstop): bench's
    calibration (11 rounds, as phase 8's) and the rounds after it at
    full width with telemetry, SLO and provenance on, launch-counted
    together (K1 3 a round, K2 none), each checked as in phase 14, the
    calibration and first timed round held against the CPU twin, the
    measured reservation share printed; a stream chunk of 2
    (``cfg4_stream``) equal to the 2 rounds; timed rounds; the derived
    scalars; telemetry on against off over a round.  Then bench's rows
    whole (``serve.sustained_row``) at full width, cut in depth to
    ``ROW_CUT`` (cfg3: 12 rounds after 4 in 2 pairs; cfg4: 6 after 2 in
    2 pairs and 16 latency rounds; 2 conformance rounds each), with host
    spans and a watchdog (bench's: 2 s polls, a 60 s stall):
    launch-counted (K1 once a prefix round or a calendar batch, the
    calibration, conformance and latency rounds and the round the cost
    counter counts included; no K2); the
    SLO block rolled once a chain (``2 * reps`` rolls),
    ``latency_samples == latency_rounds``, a conformance-table line a
    client whose ops sum to the conformance rounds' decisions, the
    registry's warning counter equal to the watchdog's warnings; prints
    ``dps``, ``fill``, ``bounded_by``, the verdict, the latency keys and
    the warnings.  Then the cfg4 frontier (``serve.frontier``) at m = 2
    and 3 (``FRONTIER_CUT``: 4 rounds after 2 in 1 pair, 8 latency
    rounds a point), launch-counted (K1 m a round), with a
    ``FRONTIER_TARGET_MS`` pick;
17. the ``queue`` path: ``serve.serve_queue`` at full width (10,000
    clients behind ``TpuPullPriorityQueue(speculative_batch=64)``: a
    240,000-add bulk load, ``pull_batch``, ``pull_batch_stream``,
    ``pull_request`` with adds interleaved, client updates, removals,
    ``do_clean`` with erases and recycled slots, and a weight-phase
    window at 1 ms, before every queued reservation tag), launch counts
    reset just before and read just after (it launches neither K1 nor
    K2), held against the same sequence on the CPU: every ``PullReq``,
    counter, ledger, SLO and departed row and the final state field by
    field must be equal.  Every launch runs a program of the ``queue``
    cache (captured serial blocks, eager ingest); the phase prints the
    cache's compile records and the blocks' nodes, capture ms and pools;
18. the ``push`` path: ``serve.virtual_server`` (1,000 clients, 32
    service slots, the virtual-time embedding): the push queue on the
    card dispatches in the order the pull queue does on the CPU on the
    same arrivals, sched-ahead wakeups among them; then a threaded push
    queue whose sched-ahead thread dispatches a limit-deferred request;
19. the ``churn_flash_crowd`` path (bench's churn row,
    ``serve.churn_row``): 4,096 client ids on the flash_crowd scenario,
    64 epochs with a lifecycle boundary every 4 (capacity from 1,024,
    growing on demand), guarded prefix epochs of m=4 batches of k=256 in
    a 32-slot ring, 8 waves of 50 ms epochs, SLO windows and the burn-rate
    evaluator on, the admin API on a live HTTP endpoint and a real
    ``PUT /clients/{id}/qos`` at the halfway boundary; launch counts reset
    just before and read just after (K1 once an epoch, no K2), a span
    tracer beside it for the boundaries' wall share; held against the same
    row on the CPU (every output key but the wall clock); then its static
    variant on the card, and the row with SLO off: the same digest and
    decisions, the wall times side by side.  Then the ``churn_storm``
    scenario at the same shape, launch-counted and span-traced, so that
    idle eviction, the evicted clients' ledger read and compaction run on
    the card at full width (flash_crowd evicts and compacts nothing at
    this shape): it must evict and compact, equal its CPU twin on every
    output but the wall clock, and give its static variant's digest and
    decisions.

20. supervised epoch jobs (``robust.supervisor``) at full width, each
    in-process run launch-counted: ``supervised_prefix`` (N=100,000,
    ring 128 preloaded 64 deep, 2 epochs of m=8 prefix batches of
    k=65,536, 8 waves, a checkpoint every epoch, histograms, ledger,
    a 1,024-row flight ring, provenance and SLO on; about 0.22 GB of
    state and a snapshot as large, up to 4 kept): the bare run, the
    empty plan bit-identical to it, a sampled plan (two kills, a torn
    save, a rotted snapshot) crash-equivalent, and the stream loop's
    digest equal to the round loop's; ``supervised_prefix_short``, the
    same job (its bare run), held against its CPU twin on every field;
    ``supervised_spawn``, that short job in
    spawn mode with its child SIGKILLed just past half its decisions and
    resumed from a rotation snapshot, the resumed child's start (the
    parent's spawn to its initial state, its ``supervisor.child_start``
    span), the restore and the replay timed; ``supervised_ladder`` (the
    short job at tag32, client 0's tag 2^31 + 1 ns ahead, the ladder at
    threshold 1): one step to tag64, kept by a killed and resumed run;
    ``supervised_wheel`` (the wheel calendar at N=100,000, ring 128, m=3,
    k=64, 8 levels, 2 epochs) killed after epoch 1's snapshot, so K2 runs
    after a resume; ``supervised_churn`` (the churn row's shape as a
    stream job of 32 epochs, a checkpoint every 4) killed at half and
    equal to
    its CPU twin.  The checkpoint saves' wall share and the replay come
    from the supervisor's span log.  The SLO evaluator logs one line per
    alert to stderr, some 10^5 a roll at this width: the phase sends
    fd 2 to a file and prints the count (and the file's tail on a
    failure).
21. the simulators.  The device sim's closed-loop headline
    (``sim.device_sim.headline_setup``, ``benchmark/run_sweeps.py:356-443``
    with nothing cut: 100,000 clients in two halves of weight 1 and 3,
    reservation 2 ops/s, no limit, 80 ops/s goal, window 32, select range
    8, random selection; 8 servers at 500,000 iops with 2 threads, so
    8,192 serves a server a slice of 16.384 ms; a 64-slot ring, prefix
    serve, sort): its first 2 slices launch-counted (K1 once a prefix
    batch at w=1, no K2) and held against a CPU twin on every
    ``DeviceSim`` field; K1 at w=1 and w=8 on that state against its
    plain version (phase 29 (d) holds 2 slices with
    ``calendar_impl="minstop"`` (K1 at w=8) and 2 with ``"wheel"`` (4
    levels; K1 and K2) to this run); then the headline timed op
    by op (``device_sim_step``) and through the program the entry points
    run (``jit_device_sim_step``) in one call (ops per wall second
    differenced over chains of 4 and 10 launches of 2 slices, ms and
    read backs a slice, prefix batches launched and in a server's loop,
    the weight 3:1 ratio, the virtual seconds, 0 guard trips; K1 once a
    launched prefix batch).  Then ``dmc_sim`` on the card:
    ``configs/dmc_sim_example.conf`` in pull mode and
    ``configs/dmc_sim_8_6.conf`` in push mode, each cut to 50
    ``client_total_ops`` (nothing else changed: whole, they took 165
    and 65 s on the card), with ``--model dmclock-torch --ledger-check
    --slo-check`` (exit 0), each decision trace equal byte for byte to a
    CPU twin's; the reports, the wall and the decisions per second
    printed; the pull run's trace equal op for op (time, server, client,
    phase, cost) to the host oracle's, ``--model dmclock-delayed`` run
    in process on the same cut config, and so each client's phase
    split.  The twins (the device sim on four threads, each dmc_sim on
    one) start as the phase begins.
22. the multi-server mesh (``parallel.mesh``, ``parallel.cluster``,
    ``robust.cluster``, ``obs.capacity``): (a) bench's mesh row
    (``serve.mesh_row``) at its shape, 100,000 clients over 8 shards
    stacked on the card (12,500 a shard; the prefix engine at m=4,
    k=256, ring 16 preloaded 12 deep, Poisson(2) in 4 waves, 100 ms
    epochs, chunks of 8: 8 warm epochs, 24 timed, metrics and the SLO
    block on) at ``counter_sync_every`` 1 and 4, launch-counted (K1 once
    a shard-epoch), aggregate and per-shard decisions/s and the counter
    plane's syncs and bytes printed, the same decisions at both K, and
    the first chunk held against a CPU twin on every field; (b) the row
    under the fault plan ``MESH_FAULT_SPEC``, whose per-shard dropout
    and resync counts read off the device metric rows must equal
    ``plan_shard_events``; (c) one mesh chunk at 100,000 clients x 1
    shard equal to ``build_stream_chunk`` field by field; (d) a wheel
    calendar chunk at 2 shards x 10,000 clients (K1 and K2 per shard)
    equal to its CPU twin; (e) the cluster dry run (``serve.
    multichip_row``) at its width, 8 servers x 10,000 clients under both
    trackers, cut in depth (``MULTICHIP_CUT``), each round's decisions
    held against a CPU twin by digest, and ``robust_cluster_step`` under
    a single outage (``serve.cluster_outage``) equal to its twin (no K1
    or K2: the serial engine); (f) the capacity plane: the card's budget,
    ``plan_capacity`` and ``plan_mesh_shards`` for (a), and one shard's
    ``projected_hbm`` within 10% of the resident growth of its state,
    accumulators and one chunk's outputs (peak printed).  The twins run
    in a child process on four threads, started as the phase begins.
23. the supervised mesh (``robust.supervisor``, ``engine_loop="mesh"``)
    at the mesh row's width (``SUP_MESH``: 8 shards x 12,500, ring 16
    preloaded 12 deep, prefix m=4, k=256, Poisson(2) in 4 waves, 100 ms
    epochs, 16 epochs, a checkpoint every 4, histograms, ledger and SLO
    on), each in-process run launch-counted (K1 once a shard-epoch on
    the fused chunk): (a) ``supervised_mesh`` bare, then killed in
    process at 0.35 and at 0.75 of its decisions (phase 26 SIGKILLs a
    spawn child of a mesh job), each crash-equivalent
    to the bare run, and its first chunk (4 epochs) equal to a CPU twin;
    (b) ``supervised_mesh_chaos``, (a) under ``MESH_FAULT_SPEC``, killed
    once and crash-equivalent, its dropout, resync and fault rows equal
    to ``plan_shard_events``; (c) ``supervised_mesh_trip``, (a) cut to 8
    epochs at ``tag_width=32`` with client 0's tag 2^31 + 1 ns ahead:
    every chunk trips, is discarded and replays on the host loop on the
    card, and every result field equals the ``tag_width=64`` job's but
    the digest (the tripped epochs also hash their discarded attempt),
    the rebase-fallback row and ``mesh_fallbacks``; (d)
    ``supervised_mesh_churn``, ``churn_storm`` (4,096 ids, capacity
    1,024 a shard, growing) over 4 shards with ``placement="p2c"`` under
    ``MESH_FAULT_SPEC``, 32 epochs, killed at half and crash-equivalent,
    equal to a CPU twin, and at S=1 p2c equal to static.  Each job's wall,
    restarts, resumes, ``mesh_fallbacks`` and K1 launches are printed.
    The twins run in a child process on four threads, started as the
    phase begins; the SLO evaluator's alert lines go to a file.

24. control and network (``phase_control``), each leg launch-counted
    and held against a CPU twin in a child process (every key or field
    but the walls and latencies): bench's ``controller`` rows at their
    accelerator shape (192 ids, 48 epochs, three scenarios, both twins);
    ``controller_churn``, the ``supervised_churn`` population with the
    controller on, bare, then killed in process at each of the three
    controller stages of its first deciding boundary and a spawn child
    SIGKILLed after that boundary's journal append, each crash-
    equivalent; bench's ``rpc`` row on loopback sockets, clean and
    under ``RPC_CHAOS`` (``digest_match`` and ``chaos_exact``); ``rpc_full``,
    the serving loop at 100,000 clients (``RPC_FULL``, 4 epochs) fed by
    4 loadgen processes of 4,096 requests: live, serving from the first
    admitted op while the requests arrive, its journal's replay equal on
    the card (``digest_match``); then, as the uninterrupted reference,
    the same with every op admitted before the first take, and a serving
    child of that config SIGKILLed between boundary 1's fsync and its
    apply and resumed to the reference's digest and trace hash (each
    live leg's wall and its serving wall from the first take, the
    fsync's share and the journal's bytes a boundary printed); the CPU
    replays of the
    card's four traces; bench's ``mesh_rebalance`` row,
    then at the ``supervised_mesh_churn`` population (``REBAL_POP``); the
    cold-pick twin gate on the wheel calendar mesh (K1 and K2).
25. The mesh across devices: layouts of device groups
    (``make_mesh(S, devices=...)``, ``parallel/groups.py``), each leg held
    bit for bit against its stacked one-group twin of phases 22 and 23
    in this run: (a) bench's mesh row at full width over 8 and 4 groups
    of ``cuda:0`` at K=1, K=4 and under ``MESH_FAULT_SPEC`` (decisions/s
    beside the stacked row's, K1 256 each), the first chunk at 8 x 12,500
    field by field, the wheel chunk over 2 groups (K1 32, K2 40), and one
    epoch's counter sum over 1, 4 and 8 groups (CUDA events); (b) the
    supervised mesh over 8 groups, bare, then killed in process at half
    and resumed on one group, each crash-equivalent to
    phase 23's bare run; (c) the cut dry run over 8 groups, both
    trackers; (d) the device-sim headline's first 2 slices over 8 groups
    against one; (e) where two or more cards are visible, one group a
    card (the largest of 2, 4 and 8 that fits): (a)'s rows, their
    ``mesh.chunk`` legs each a captured graph, ``cluster.cluster_step``
    against the stacked program call by call (0 syncs a call, walls of
    both) and (d) op by op and through the program, with K1 and K2
    launched on the last card while ``cuda:0`` is current; with one card
    it prints that (e) did not run.  ``python3 chip_smoke.py
    --mesh-cards`` runs (e) alone after the build and its stacked
    references (with one card, a rehearsal over 4 groups of ``cuda:0``).
26. Migration and the controller over groups, then bench's session and
    the port's two entry scripts: (a) bench's ``mesh_rebalance`` row over
    4 and 2 groups of ``cuda:0`` against phase 24's stacked row; the
    supervised p2c job with the migrate rule at 8 shards (``MIG_JOB``)
    on the prefix engine, where a destination grows every group's stacks
    to one capacity, and on the wheel calendar, each over 8 and 4 groups
    equal to its stacked run on every result field; a spawn child over 8
    groups SIGKILLed at its
    second migration's handoff, resumed on one group from a snapshot,
    crash-equivalent; over real cards where two or more are visible
    (with one card it prints that this leg did not run); (b) ``python -m
    dmclock_tpu_torch.bench --mode all --cut-depth --spans`` at bench's
    card shapes (the rows cut in depth to ``ROW_CUT``): rc 0, one line,
    ``vs_baseline == round(value / 1e7, 4)``, the line's and the rows'
    keys against bench's lists (``SESSION_LINE_KEYS`` and the rest), the
    churn, cfg3 and cfg4 rows equal to this run's rows of phases 19, 14
    and 16 on every key but the walls (cfg4's conformance table byte for
    byte), serve's against a ``serve_row`` in process; ``--mode mesh
    --n-shards 4 --rebalance on`` over 4 groups of ``cuda:0`` against a
    stacked mesh row in process and phase 24's row; ``--device cuda:99``
    exits non-zero after its error line; (c) ``scripts/torch_silicon_parity.py
    --out``, ``match: true``; (d) ``scripts/torch_run_fullscale.py
    --record`` on ``dmc_sim_example.conf`` cut to ``FULLSCALE_OPS`` a
    client, the record read by its ``load_multichip`` with ``ok``.  The
    sessions, (c) and (d) run as children beside (a): their rates are not
    judged.
27. The sweeps (``scripts/torch_run_sweeps.py``, the device half of the
    JAX repo's ``benchmark/run_sweeps.py``) at full width: (a) K1 bit for
    bit against its plain version at each shape the sweeps give it
    (``RING_SWEEP_SHAPES``) and timed there; (b) the first epoch of each
    AtLimit Allow row (sorted m=21, k=49,152 and calendar m=8, steps 8
    over ``limited_state``, 100,000 clients, ring 256) and the calendar
    grid's first point ((m, steps) = (4, 8), ring 320) against a CPU twin
    started as the phase begins (``start_sweep_twins``), every output and
    state field but the rings (which no epoch writes) equal; (c) the
    rows through the script's functions, launch-counted each: the Allow
    rows whole (a limit-break asserted on both), the calendar grid whole,
    the regime rows with the serial floor cut from 4,096 steps to
    ``SWEEP_SERIAL_STEPS``, and the k/m grid's largest point (98,304 x
    64 on a 384-slot ring) with one rep.
28. The capacity plane's time axis (``obs/compile_plane.py``): (a) this
    process's build record (whether ``nvcc`` ran or a current library
    was found, the compile wall); (b) one serve epoch at ``COST_SHAPE``
    (N=4,096, ring 320, m=4, k=1,024) counted by the cost counter on the
    card and on the CPU, every total equal (the ops that differ printed
    on a failure), K1's recorded bytes equal to the formula its bound
    reads (``fastpath.ring_window_cost``; K2's bound reads
    ``kernels.wheel_scan_cost``); (c) the full-width counts, each with
    its ``cost_analysis``, ``roofline``, ``bound_class`` and bytes a
    launch over device ms a launch (the spans' and CUDA events') against
    ``MEM_RATE``: a ``serve_row`` with spans, phase 16's cfg3 and cfg4
    rows, and the cfg4_wheel round counted at the end of phase 8 beside
    its timed rounds' spans; phase 26's session line carries
    ``cost_analysis``, ``compile`` and ``capacity.bound_class``, its
    cfg3, cfg4 and serve counts equal to the rows in process; (d) the
    component profile's five rows (``scripts/torch_profile_fastpath.py``)
    at N=100,000, k=49,152, one differenced pair each (K1 642).
29. Captured programs (``obs/compile_plane.py``; the counterpart of the
    JAX package's jit caches): at full width ``bench.serve`` (a serve
    epoch, the state donated), ``bench.round`` (``serve.round_program``
    on cfg3, cfg4 minstop and cfg4_wheel, state and accumulators
    donated), ``stream.chunk`` (cfg3 8 rounds, cfg4 2, donated, as
    ``cfg3_stream``/``cfg4_stream`` capture them) and the ingest step,
    each captured (its warm-up under the sync debug mode's errors) and
    then replayed 3 times with changed inputs (a fresh state, then the
    chained one; new ``now``, ``t_base``, ``epoch0`` and draws), every
    replay under the sync debug mode's errors and held bit for bit
    against the eager body on the same inputs (the first replay against
    the first call's warm-up, the others against a run on a clone of
    their inputs), its K1 and K2
    launches equal to the eager body's and to the capture's record, a
    donated chain handed its static buffers; the capture record (graph
    nodes, warm-up and capture ms, the pool's bytes) and replay against
    eager ms (CUDA events) printed; a body that reads the card back
    fails to capture, naming its cache and entry.  (b) The guarded-run
    programs the same way (``phase_guarded_programs``): ``guarded.epoch``
    at the ``supervised_prefix`` shape with the five accumulators,
    ``guarded.serial`` (two blocks of ``kernels.SERIAL_BLOCK`` steps and
    a remainder at N=100,000), ``supervisor.ingest``, the host replay's
    pressure probe and the prefix runner's "attempt" at the serve shape;
    and, held at the start of the phase that then runs them so its jobs
    replay the capture, ``guarded.epoch`` at the ``supervised_wheel``
    shape (phase 20) and ``mesh.chunk`` at bench's mesh row at K=1, K=4
    and under ``MESH_FAULT_SPEC``, stacked (phase 22) and over 8 groups
    of ``cuda:0`` (phase 25).  Every phase that
    captured ends with ``release_programs()`` (``clear_compiled`` and
    ``empty_cache``).  Every sustained row, calibration and stream
    chunk of the earlier phases runs through these programs: their K1
    counts include the capture's warm-up round.  (c) The serial-engine
    programs (``phase_serial_programs``), each a
    ``compile_plane.InstrumentedJit`` captured whole (the device ingest
    with K3, the serial legs' blocks as child graphs or replayed between
    graph segments, the packing or the tracker folds), each call held
    against its body run under ``compile_plane.eager`` with 0 syncs: the
    ``queue`` cache's ``run`` (a ``pull_batch`` of two blocks and a
    remainder), ``run_h``, ``run_stream``, ``ingest``, ``ingest_run`` and
    ``ingest_run_stream`` on phase 17's final state (a 512-row batch of
    creates and reactivations); the dry run's ``cluster.cluster_step``
    (8 x 10,000, 32 decisions a step), ``cluster.robust_cluster_step``
    under a single outage and ``cluster.mesh_rounds`` at K=1; one
    server's leg alone under the sync debug mode's errors; then
    ``release_programs`` leaves no capture in these caches.  (d) The device sim's program
    (``phase_device_sim_programs``) at the headline's full width, 2
    slices each on the prefix, minstop and wheel paths: the first call
    equal to the op-by-op step, a replay on a fresh sim and one chained
    on its result held on every ``DeviceSim`` field against the body
    run under ``compile_plane.eager``, with its K1/K2 launches, batches
    and read backs, one synchronising operation a read back.  (e) The
    lifecycle programs (``phase_lifecycle_programs``) at the churn
    cells' shape against their eager bodies, 0 syncs: ``lifecycle.ops``,
    ``lifecycle.compact`` and the churn runner's serial leg; then
    ``run_serial_churn`` on ``churn_storm`` through them against the
    same run eagerly.  Phases 17-18, 21 and 22 (e) (and the
    dry run over groups in 25 (c)) run these programs: the queue's, the
    simulators' queues' and the dry run's (an unrecorded
    ``bare_step_jit``), each still held against its CPU twin or the
    host oracle.

The CPU runs of phases 17-20 run beside the card's, in a child process
on four CPU threads (``start_cpu_twins``) started only then, so the
earlier phases' host-paced timings have no CPU load beside them; the
card runs phases 17-19 before any is held against its twin, so the
twins have that time to finish.  The CPU twin of
``supervised_prefix_short`` runs in a second child, started as phase 20
begins (``start_cpu_sup_twin``).  The script stops the children on any
failure.

K1's ``launches`` in the kernel table is the sum over the paths that
launch it (phases 6, 8 and 14-16 with their calibration rounds, 10-13,
both runs of 19, the in-process runs of 20, 23 and 24, the device sim's
three runs in 21, the mesh runs of 22, the grouped runs of 25 and the
in-process runs of 26, the sweeps of 27, the counts and component
rows of 28 and the programs of 29), each count read right after that
path's run;
K2's is the ``cfg4_wheel`` path's (its calibration included), phase
20's wheel runs', the device sim's wheel runs (29 (d)), the mesh
wheel chunks' of 22 and 25, phase 24's wheel gate's, phase 26's wheel
migration jobs', phase 28's counted wheel round's and phase 29's wheel
round;
the queue paths (17, 18),
``dmc_sim`` and the
cluster runs of 22 add none.  K3's (phase 4b holds it against its plain
version on a real queue flush's and a 10,000-client cluster wave's
inputs and times it) is every path that ingests an op batch: the queue
and push phases (17, 18), ``dmc_sim`` (21), the dry run and the outage
(22 (e)), the dry run over groups (25 (c)) and the ingesting programs of
29 (c); no other path launches it.  The launches of the spawn children
and of phase 26's subprocesses are not counted (``LAUNCHES`` is per
process). Each kernel's entry also carries
``launches_by_path``. Serve's and the rows' rates are printed both as
the mean (summed decisions over summed event ms) and median-based (one
epoch's or round's decisions over the median ms). Prints the kernel
table as one JSON line, then as the last line ``{"ok": true, "device":
{...}}``. Exits non-zero without a result when CUDA is unavailable or
the package is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_SERVE, DEPTH, K_SERVE, M_SERVE, EPOCHS = 100_000, 320, 65536, 32, 3
TIMED_EPOCHS = 5
SERIAL_CHECK_STEPS = 512
K1_SOURCE = "dmclock_tpu_torch/engine/csrc/ring_window.cu"
K1_REPLACES = "dmclock_tpu/engine/fastpath.py:156"
K2_SOURCE = "dmclock_tpu_torch/engine/csrc/wheel_scan.cu"
K2_REPLACES = "dmclock_tpu/engine/kernels_pallas.py:59"
K3_SOURCE = "dmclock_tpu_torch/engine/csrc/ingest_scan.cu"
# K3 replaces no Pallas kernel: it is the recurrence of the JAX ingest's
# lax.scan over an op batch's rows
K3_REPLACES = "dmclock_tpu/engine/kernels.py:571 (ingest's lax.scan, no Pallas kernel)"
# K3's launches by path, each read right after its path's run
K3_PATHS: dict = {}
N_CFG4 = 100_000
CFG4_ROUNDS = 1          # main-path rounds, launch-counted
CFG4_TIMED = 1           # timed rounds after them
KEY_INF = (1 << 63) - 1
RING_HIGH = 128          # the high-rate state's ring, preloaded full
TIMED_WIDTHS = 3         # timed epochs of each tag width
M_CHAIN, CHAIN_DEPTH, CHAIN_NOW = 8, 4, 20_000_000
TIMED_CHAIN = 3
N_QUEUE, N_PUSH = 10_000, 1_000
N_CFG3 = 10_000
CHURN_SCENARIO = "flash_crowd"
STORM_SCENARIO = "churn_storm"   # the churn run that evicts and compacts
CFG3_ROUNDS = 4          # cfg3 main-path rounds, launch-counted
CFG3_TIMED = 4           # timed rounds of each of telemetry on and off
CFG4M_ROUNDS = 2         # cfg4 (minstop) main-path rounds
CFG4M_TIMED = 3          # timed minstop rounds with telemetry
CFG4M_ON_OFF = 3         # minstop rounds of each of telemetry on and off
MET_INGEST_DROPS = 7
# bench's timed structure of the sustained rows (serve.sustained_row) at
# full width, cut in depth: pairs of timed chains, 2 conformance rounds,
# cfg4's windowed latency rounds
ROW_CUT = {"cfg3": dict(rounds_lo=4, rounds=12, reps=2, latency_rounds=0),
           "cfg4": dict(rounds_lo=2, rounds=6, reps=2, latency_rounds=16)}
ROW_CAL = {"cfg3": 3, "cfg4": 11}        # bench's calibration rounds
# the frontier (serve.frontier) at cfg4's width over two of bench's
# points, each cut in depth, with a target-latency pick
FRONTIER_CUT = dict(points=((2, 64), (3, 64)), rounds_lo=2, rounds=4,
                    reps=1, latency_rounds=8)
FRONTIER_TARGET_MS = 400.0
# phase 20: supervised epoch jobs (robust.supervisor.EpochJob kwargs)
SUP_PREFIX = dict(engine="prefix", n=100_000, depth=64, ring=128, epochs=2,
                  m=8, k=65536, waves=8, arrival_lam=2.0, ckpt_every=1,
                  with_hists=True, with_ledger=True, flight_records=1024,
                  with_prov=True, with_slo=True)
# the spawn job and the twin of a CPU run: 2 epochs with a snapshot
# after each, since the depth cut supervised_prefix itself
SUP_SHORT = SUP_PREFIX
SUP_LADDER = dict(SUP_SHORT, tag_width=32, tag_spread_ns=2 ** 31 + 1,
                  ladder=True, ladder_threshold=1)
SUP_WHEEL = dict(engine="calendar", calendar_impl="wheel", n=100_000,
                 ring=128, depth=64, m=3, k=64, ladder_levels=8, epochs=2,
                 ckpt_every=1)
SUP_CHURN = dict(engine="prefix", n=4096, ring=32, epochs=32, m=4, k=256,
                 waves=8, dt_epoch_ns=50_000_000, seed=11, ckpt_every=4,
                 with_slo=True, engine_loop="stream")
SUP_CHURN_SPEC = dict(total_ids=4096, seed=11, base_lam=2.0,
                      compact_every=2)
MET_LADDER_STEPS, MET_SUPERVISOR_RESUMES = 15, 16

# device-memory rate of the H100 SXM (bytes/s, NVIDIA's data sheet),
# for the bound of a data-movement kernel
MEM_RATE = 3.35e12
# K3's serial walk (the rows from min(F, L) on), a row's least time:
# its loop-carried chain is 6 dependent int64 operations (the minimum
# with the running minimum, the compare with the trigger, low - t, the
# select, base + pd, the minimum it joins), each 2 dependent 32-bit
# instructions on sm_90, at an
# integer instruction's 4-cycle latency and the H100 SXM's 1.98 GHz
# boost clock (ns a row)
K3_CHAIN_NS = 6 * 2 * 4 / 1.98


def launched(ext) -> dict:
    """The kernels' launches since the last reset.  K3 (the ingest's
    reactivation recurrence) is in it only where it launched: the paths
    that ingest an op batch (the pull queue, the simulators' queues, the
    cluster), so a K1/K2 path's count compares as it did before K3."""
    return {k: v for k, v in ext.LAUNCHES.items() if v or k != "ingest_scan"}


def k3_taken(launches: dict, path: str) -> dict:
    """``launches`` without K3, whose count on an ingesting ``path`` must
    be positive and is recorded in :data:`K3_PATHS`."""
    out = dict(launches)
    n = out.pop("ingest_scan", 0)
    if n <= 0:
        raise AssertionError(f"{path}: K3 was launched no time "
                             f"({launches})")
    K3_PATHS[path] = K3_PATHS.get(path, 0) + n
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


def host_paced_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls between
    CUDA events: where the host enqueues slower than the card runs,
    this is the host's rate, not the card's."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int, warmup: int = 3, replays: int = 5) -> float:
    """Mean device time of one ``fn`` call: ``iters`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's launch cost is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (replays * iters)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    if "H100" not in name or "PCIe" in name or "NVL" in name:
        raise RuntimeError(f"{name!r} is not an H100 SXM: the bounds "
                           f"below use its memory rate")
    log(f"[card] torch.cuda.get_device_name(0) = {name}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")
    return smi


def phase_build(ext) -> None:
    t0 = time.perf_counter()
    lib = ext.build()
    log(f"[build] {lib.name} built in "
        f"{time.perf_counter() - t0:.3f} s")


def _k1_check(fp, gen, n: int, q: int, w: int) -> int:
    """K1 at ``(n, q, w)`` against its plain version, ``q_head`` in [0, Q)
    and in [-2Q, 2Q); returns the max abs error (0) or raises."""
    dev = torch.device("cuda")
    arr = torch.randint(-(1 << 50), 1 << 50, (n, q), generator=gen,
                        device=dev, dtype=torch.int64)
    cost = torch.randint(1, 1 << 20, (n, q), generator=gen, device=dev,
                         dtype=torch.int64)
    max_err = 0
    for lo, hi in ((0, q), (-2 * q, 2 * q)):
        q0 = torch.randint(lo, hi, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
        q0[: min(n, 3)] = q - 1                  # the wrap edge
        ka, kc = fp.ring_window_rows(arr, cost, q0, w)
        pa = fp._ring_window_torch(arr, q0, w)
        pc = fp._ring_window_torch(cost, q0, w)
        torch.cuda.synchronize()
        err = max(int((ka - pa).abs().max()), int((kc - pc).abs().max()))
        if ka.shape != (w, n) or not (torch.equal(ka, pa)
                                      and torch.equal(kc, pc)):
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"N={n} Q={q} w={w}, q_head in [{lo}, "
                                 f"{hi}): max err {err}")
        max_err = max(max_err, err)
    log(f"[k1] N={n} Q={q} w={w}: bit-identical to the plain version "
        f"(q_head in [0, Q) and in [-2Q, 2Q))")
    return max_err


def _k1_time(fp, gen, n: int, q: int, w: int, card: str) -> dict:
    """K1's device time at ``(n, q, w)`` beside its byte bound, a
    ``copy_`` of its window bytes, its plain version and ``torch.gather``
    x2, and back-to-back wrapper calls; the numbers as a dict."""
    dev = torch.device("cuda")
    arr = torch.randint(0, 1 << 40, (n, q), generator=gen, device=dev,
                        dtype=torch.int64)
    cost = torch.randint(1, 4, (n, q), generator=gen, device=dev,
                         dtype=torch.int64)
    q0 = torch.randint(0, q, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    idx_t = torch.remainder(
        q0.to(torch.int64)[None, :]
        + torch.arange(w, device=dev, dtype=torch.int64)[:, None], q)
    # the streaming yardstick: one device copy that reads and writes
    # as many window bytes as K1 does
    src = torch.ones((2 * n * w,), dtype=torch.int64, device=dev)
    dst = torch.empty_like(src)
    k_ms = cuda_ms(lambda: fp.ring_window_rows(arr, cost, q0, w), 50)
    c_ms = cuda_ms(lambda: dst.copy_(src), 50)
    p_ms = cuda_ms(lambda: (fp._ring_window_torch(arr, q0, w),
                            fp._ring_window_torch(cost, q0, w)), 20)
    # the library yardstick: torch.gather on the transposed ring
    # views with a precomputed [w, N] index, once per ring
    l_ms = cuda_ms(lambda: (torch.gather(arr.T, 0, idx_t),
                            torch.gather(cost.T, 0, idx_t)), 20)
    del src, dst
    # the formula the cost counter records for a K1 launch
    nbytes = fp.ring_window_cost(n, w)["bytes_accessed"]
    bound_ms = nbytes / MEM_RATE * 1e3
    h_ms = host_paced_ms(lambda: fp.ring_window_rows(arr, cost, q0, w), 50)
    log(f"[k1] N={n} Q={q} w={w} on {card}: device time per call "
        f"(CUDA graph replay): kernel {k_ms:.6f} ms = "
        f"{k_ms / bound_ms:.3f}x its bound {bound_ms:.6f} ms "
        f"({nbytes} bytes); copy_ of the same window bytes "
        f"{c_ms:.6f} ms = {c_ms / bound_ms:.3f}x the bound (kernel "
        f"{k_ms / c_ms:.3f}x the copy); plain {p_ms:.6f} ms, "
        f"torch.gather x2 {l_ms:.6f} ms; back-to-back wrapper calls "
        f"{h_ms:.6f} ms each (host-paced)")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                library_ms=l_ms, copy_ms=c_ms)


def phase_k1(fp, cases, card: str) -> dict:
    """K1 against its plain version; time at each main-path shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = max(_k1_check(fp, gen, n, q, w)
                  for n, q, w in cases.RING_SHAPES + cases.RING_MAIN_SHAPES)
    # time at each main-path shape; the kernel table reports the first,
    # serve's
    out = None
    for n, q, w in cases.RING_MAIN_SHAPES:
        t = _k1_time(fp, gen, n, q, w, card)
        if out is None:
            out = dict(name="ring_window", route="cuda", source=K1_SOURCE,
                       replaces=K1_REPLACES, launches=None,
                       max_abs_err=max_err, ms=t["ms"],
                       plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                       bound_by="bytes", library_ms=t["library_ms"])
    return out


def _cfg4_start(serve):
    """The cfg4 state before calibration and bench's warm-round draw
    (``default_rng(11)`` from the starting guess), both on the card:
    ``(state, draws int32[1, N])``."""
    c = serve.CFG4
    lam = serve.sustained_lam0("cfg4", N_CFG4)
    draw = np.minimum(np.random.default_rng(11).poisson(lam),
                      c["waves"]).astype(np.int32)
    return (serve.sustained_start("cfg4", N_CFG4, device="cuda"),
            torch.from_numpy(draw[None]).cuda())


def _k2_inputs(serve, fp, kernels, gen):
    """(label, keys, slot, nb) on the card: the two cfg4 shapes and the
    odd ones.  The wheel-build case is real: the entry keys and slots of
    a full-width cfg4 state after one round's ingest."""
    dev = torch.device("cuda")
    st, draws = _cfg4_start(serve)
    c = serve.CFG4
    ones = torch.ones((N_CFG4,), dtype=torch.int64, device=dev)
    wave_times = torch.arange(c["waves"], dtype=torch.int64, device=dev) \
        * (c["dt_round_ns"] // c["waves"])
    st = kernels.ingest_superwave(st, draws[0], wave_times, ones, ones,
                                  ones, anticipation_ns=0)
    now = kernels.as_scalar(c["dt_round_ns"], dev)
    cls, key = fp._classify(st, now, False)
    slot = fp._wheel_slots(cls, key,
                           now - ((fp._WHEEL_BUCKETS // 2) << fp._WHEEL_SHIFT))
    cases = [("cfg4 wheel build: entry keys", key, slot,
              3 * fp._WHEEL_BUCKETS)]

    def rand(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64)

    # stop packs: class bits at 58, most in a few 2^52 buckets, 20% KEY_INF
    n = N_CFG4
    pk = (rand(0, 3, n) << 58) | ((1 << 57) + rand(0, 1 << 40, n))
    pk = torch.where(rand(0, 5, n) == 0, KEY_INF, pk)
    cases.append(("cfg4 stop wheel: stop packs", pk,
                  torch.where(pk < KEY_INF,
                              kernels.wheel_slot(pk, 0, 52, 256), 256)
                  .to(torch.int32), 256))
    for n, nb in ((1, 768), (129, 256), (333, 768), (1000, 256)):
        keys = rand(-(1 << 62), 1 << 62, n)
        keys[::7] = KEY_INF
        cases.append((f"random N={n}", keys,
                      rand(0, nb + 1, n).to(torch.int32), nb))
    cases.append(("all lanes masked", rand(-9, 9, 500),
                  torch.full((500,), 768, dtype=torch.int32, device=dev),
                  768))
    cases.append(("all lanes in one bucket, negative keys",
                  -rand(1, 1 << 62, 777),
                  torch.full((777,), 5, dtype=torch.int32, device=dev), 256))
    return cases


def _k2_check(kernels, keys, slot, nb, label: str) -> int:
    """One K2 call against its plain version, exactly; returns the max
    abs error (0) or raises."""
    got = kernels.wheel_scan(keys, slot, nb)
    want = kernels._wheel_scan_torch(keys, slot, nb)
    torch.cuda.synchronize()
    worst = 0
    for name, g, w in zip(("cnt", "bmin", "val", "found"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"K2 {name} has dtype/shape "
                                 f"{g.dtype}{tuple(g.shape)}, plain "
                                 f"{w.dtype}{tuple(w.shape)}: {label}")
        # exact in Python ints: KEY_INF minus a negative key would wrap
        # in int64
        bad = (g != w).reshape(-1)
        err = max((abs(int(a) - int(b)) for a, b in zip(
            g.reshape(-1)[bad].tolist(), w.reshape(-1)[bad].tolist())),
            default=0)
        if err:
            raise AssertionError(f"K2 {name} differs from its plain "
                                 f"version: {label}, nb={nb}: max err "
                                 f"{err}")
        worst = max(worst, err)
    log(f"[k2] {label} (N={keys.shape[0]}, nb={nb}): bit-identical to the "
        f"plain version; occupied buckets {int((got[0] > 0).sum())}, "
        f"found {bool(got[3])}")
    return worst


def phase_k2(serve, fp, kernels, card: str) -> dict:
    """K2 against its plain version, then a call sequence that would
    show a workspace left dirty; time at both cfg4 shapes."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = _k2_inputs(serve, fp, kernels, gen)
    max_err = max(_k2_check(kernels, keys, slot, nb, label)
                  for label, keys, slot, nb in cases)
    build, stop = cases[0], cases[1]
    masked = ("stop wheel, every lane masked", stop[1],
              torch.full_like(stop[2], 256), 256)
    for label, keys, slot, nb in (build, masked, stop, build):
        max_err = max(max_err, _k2_check(kernels, keys, slot, nb,
                                         f"sequence: {label}"))
    one = torch.zeros((1,), dtype=torch.int64, device="cuda")
    floor_ms = cuda_ms(lambda: one.fill_(1), 50)
    log(f"[k2] launch floor on {card}: a one-element fill_ takes "
        f"{floor_ms:.6f} ms per call (CUDA graph replay)")
    out = None
    for label, keys, slot, nb in cases[:2]:
        n = keys.shape[0]
        slot64 = slot.to(torch.int64)
        ones = torch.ones_like(slot)
        k_ms = cuda_ms(lambda: kernels.wheel_scan(keys, slot, nb), 50)
        p_ms = cuda_ms(lambda: kernels._wheel_scan_torch(keys, slot, nb), 20)

        def library():
            # one call each: the count, the bucket min, the masked min
            torch.zeros((nb + 1,), dtype=torch.int32,
                        device="cuda").index_add_(0, slot64, ones)
            torch.full((nb + 1,), KEY_INF, dtype=torch.int64,
                       device="cuda").scatter_reduce_(0, slot64, keys,
                                                      "amin")
            torch.min(torch.where(slot < nb, keys, KEY_INF))
        l_ms = cuda_ms(library, 20)
        # each input read once (8 + 4 bytes a lane), each output written
        # once: counts, minima, the value and the flag; the formula the
        # cost counter records for a K2 launch
        nbytes = kernels.wheel_scan_cost(n, nb)["bytes_accessed"]
        bound_ms = nbytes / MEM_RATE * 1e3
        h_ms = host_paced_ms(lambda: kernels.wheel_scan(keys, slot, nb), 50)
        log(f"[k2] {label} N={n} nb={nb} on {card}: device time per call "
            f"(CUDA graph replay): kernel (one launch) {k_ms:.6f} ms = "
            f"{k_ms / bound_ms:.3f}x its bound {bound_ms:.6f} ms ({nbytes} "
            f"bytes), {k_ms / floor_ms:.3f}x the launch floor "
            f"{floor_ms:.6f} ms; plain {p_ms:.6f} ms, library (index_add_ "
            f"+ scatter_reduce_ amin + masked min) {l_ms:.6f} ms; "
            f"back-to-back wrapper calls {h_ms:.6f} ms each (host-paced)")
        # the kernel table reports the stop wheel: 24 of 27 launches
        out = dict(name="wheel_scan", route="cuda", source=K2_SOURCE,
                   replaces=K2_REPLACES, launches=None,
                   max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                   bound_ms=bound_ms, bound_by="bytes", library_ms=l_ms)
    return out


def _k3_state(n: int, q: int, live: int, rng, p_idle: float, max_depth: int):
    """A state of ``n`` slots on the card, ``live`` clients active (a
    ``p_idle`` share idle) with tags around 50 s and queues up to
    ``max_depth`` deep."""
    from dmclock_tpu_torch.engine import bridge
    from dmclock_tpu_torch.engine.state import init_state

    a = bridge.state_to_numpy(init_state(n, q, device="cpu"))
    t = 50 * 10 ** 9
    a["active"][:live] = True
    a["idle"][:live] = rng.random(live) < p_idle
    a["order"][:] = np.arange(n)
    a["weight_inv"][:live] = rng.integers(10 ** 6, 10 ** 9, live)
    a["resv_inv"][:live] = np.where(rng.random(live) < 0.3, 0, 10 ** 7)
    a["depth"][:live] = rng.integers(0, max_depth + 1, live)
    a["q_head"][:live] = rng.integers(0, q, live)
    for f in ("prev_resv", "prev_prop", "prev_limit", "prev_arrival",
              "head_resv", "head_prop", "head_arrival"):
        a[f][:live] = t + rng.integers(-10 ** 9, 10 ** 9, live)
    a["prop_delta"][:live] = rng.integers(0, 10 ** 8, live)
    return a


def _k3_queue_batch(rng, a, b: int, t: int) -> np.ndarray:
    """A queue flush of ``b`` rows against state arrays ``a``: creates
    of free slots with their first adds (reactivations), adds to active
    clients (the idle ones reactivate), a few slots created again after
    rows of their own, NOP padding; no queue past its ring."""
    add, create = 1, 2                 # kernels.OP_ADD, OP_CREATE
    q = a["q_arrival"].shape[1]
    depth = a["depth"].astype(np.int64).copy()
    free = list(np.flatnonzero(~a["active"])[:64])
    live = np.flatnonzero(a["active"])
    rows, made = [], []
    while len(rows) < b - b // 8:
        u = rng.random()
        if u < 0.1 and free:
            s = int(free.pop())
            made.append(s)
        elif u < 0.13 and made:
            s = int(rng.choice(made))
        else:
            s = int(rng.choice(made + list(rng.choice(live, 4))))
            if depth[s] < q - 1:
                rows.append((add, s, t + len(rows), 1 + s % 2, 1, 2, 0,
                             0, 0, 0))
                depth[s] += 1
            continue
        rows.append((create, s, 0, 0, 0, 0, 10 ** 7, 10 ** 8 + s, 0,
                     1_000_000 + len(rows)))
        depth[s] = 0
    rows += [(0,) * 10] * (b - len(rows))
    return np.asarray(rows, dtype=np.int64).T.copy()


def k3_real_batches() -> list:
    """The two real ingests whose K3 input phase 4b takes, as numpy from
    seed 3: ``[(label, state arrays, op rows)]`` -- a queue flush (1,024
    rows on the ``queue`` cell's 16,384 slots and ring 32: creates, adds,
    reactivations, slots created twice) and a cluster server's first
    wave (10,000 idle clients, one add each, every row a
    reactivation)."""
    rng = np.random.default_rng(3)
    qa = _k3_state(16_384, 32, 10_000, rng, 0.3, 8)
    qrows = _k3_queue_batch(rng, qa, 1024, 60 * 10 ** 9)
    wa = _k3_state(10_000, 4, 10_000, rng, 1.0, 0)
    wrows = np.zeros((10, 10_000), dtype=np.int64)
    wrows[0], wrows[1], wrows[2] = 1, np.arange(10_000), 60 * 10 ** 9
    wrows[3], wrows[4], wrows[5] = 1 + np.arange(10_000) % 2, 1, \
        1 + np.arange(10_000) % 3
    return [("queue flush", qa, qrows), ("cluster wave", wa, wrows)]


def _k3_inputs(kernels):
    """K3's inputs as the two ingests of :func:`k3_real_batches` on the
    card hand them to it, taken at the wrapper.  Each ingest is also
    held whole against the same ingest on the CPU.  Returns
    ``[(label, rows, count)]``."""
    from dmclock_tpu_torch.engine import bridge

    seen, real = [], kernels.ingest_scan

    def record(rows, count):
        seen.append((rows.clone(), count.clone()))
        return real(rows, count)

    out = []
    for label, arrays, rows in k3_real_batches():
        kernels.ingest_scan = record
        try:
            got = kernels.ingest(bridge.state_from_numpy(arrays, "cuda"),
                                 torch.from_numpy(rows).cuda(),
                                 anticipation_ns=0)
        finally:
            kernels.ingest_scan = real
        want = kernels.ingest(bridge.state_from_numpy(arrays, "cpu"),
                              torch.from_numpy(rows), anticipation_ns=0)
        for f, g, w in zip(got._fields, got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"the ingest of the {label} on the "
                                     f"card differs from the CPU's: {f}")
        rows_k3, count = seen.pop()
        log(f"[k3] {label}: the ingest of {rows.shape[1]} rows on the card "
            f"equals the CPU's on every field; {int(count)} reactivating "
            f"rows reach K3")
        out.append((label, rows_k3, count))
    return out


def _k3_check(kernels, rows, count, label: str) -> tuple:
    """One K3 call against its plain version on the first ``count``
    columns, exactly; returns the max abs error (0) and the kernel's
    exits ``(min(F, L), L, crossing row)`` (read back here only), or
    raises."""
    r = int(count)
    info = torch.empty((3,), dtype=torch.int64, device=rows.device)
    got = kernels._ingest_scan_launch(rows, count, rows.device, info)
    want = kernels._ingest_scan_torch(rows.cpu(), count.cpu())
    torch.cuda.synchronize()
    g, w = got.cpu()[:r].tolist(), want[:r].tolist()
    err = max((abs(a - b) for a, b in zip(g, w) if a != b), default=0)
    if err:
        raise AssertionError(f"K3 differs from its plain version: {label},"
                             f" {r} rows: max err {err}")
    exits = tuple(info.tolist())
    log(f"[k3] {label} ({r} of {rows.shape[1]} columns): bit-identical to "
        f"the plain version; leaves the scan at min(F, L) = {exits[0]} "
        f"(L = {exits[1]}, the count unless the scan stopped at L), P "
        f"crosses the trigger at row {exits[2]}, {r - exits[0]} rows "
        f"walked")
    return err, exits


def _k3_synthetic(gen, r: int, b: int, leaving: bool):
    """Random K3 rows on the card: tags near the int64 edges (wrapping
    ``low - t`` and ``base + pd``), both sides of the trigger, and with
    ``leaving`` joined tags that leave the set again."""
    dev = torch.device("cuda")

    def rand(lo, hi, n=r):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64)

    m = torch.where(rand(0, 4) == 0, KEY_INF, rand(-(1 << 62), 1 << 62))
    m = torch.where(rand(0, 9) == 0, -(1 << 63) + rand(0, 1000), m)
    base = rand(-(1 << 62), 1 << 62)
    end = torch.where(rand(0, 2) == 0, r, torch.arange(r, device=dev)
                      + rand(0, 7)) if leaving else torch.full_like(m, r)
    rows = torch.zeros((7, b), dtype=torch.int64, device=dev)
    rows[:, :r] = torch.stack([m, rand(0, 2), base, rand(0, 1 << 40),
                               rand(0, 5).clamp(max=1), rand(0, 1 << 62),
                               torch.clamp(end, max=r)])
    return rows, torch.tensor(r, device=dev)


def _old_host_recurrence(kernels, rows, count):
    """The recurrence as the ingest ran it before K3: ``[6, r]`` read back
    to the host, the Python loop, the shifts copied back."""
    r = int(count)
    vals = rows[:6, :r].cpu()
    low_p, any_r, out = KEY_INF, False, []
    for mk, a0, b, pd, act, t in vals.T.tolist():
        low = min(mk, low_p)
        if (a0 or any_r) and low < kernels.LOWEST_PROP_TAG_TRIGGER:
            pd = kernels._wrap64(low - t)
        out.append(pd)
        if act:
            low_p = min(low_p, kernels._wrap64(b + pd))
            any_r = True
    return torch.tensor(out, dtype=torch.int64).to(rows.device)


def _wall_ms(fn, reps: int = 3) -> float:
    """Mean host wall of ``fn()`` with the card synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_k3(kernels, card: str) -> dict:
    """K3 against its plain version on two real ingests' inputs, on
    synthetic rows at the int64 edges (joined tags leaving the set among
    them) and on the door cases of ``tests/test_torch_cases.py``
    (``K3_DOOR_CASES``), each of which must leave the kernel's scan by
    its own door, every door taken at least once: none, the local check
    (a wrap), a leaving tag, the running minimum crossing the trigger in
    a later tile, and more rows than one tile.  Its time at both real
    shapes beside its byte bound, the launch floor, the latency of the
    serial chain over the rows it walks, its plain version and the host
    recurrence it replaced (each call of those two a host loop, timed by
    the host's clock)."""
    import test_torch_cases as tc

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = _k3_inputs(kernels)
    max_err, exits = 0, {}
    for label, rows, count in cases:
        err, exits[label] = _k3_check(kernels, rows, count, label)
        max_err = max(max_err, err)
    for r, b, leaving in ((0, 64, False), (1, 1, False), (700, 1024, True),
                          (5000, 5000, False), (3000, 4096, True)):
        rows, count = _k3_synthetic(gen, r, b, leaving)
        err, _ = _k3_check(kernels, rows, count, f"synthetic, edges"
                           f"{', tags leaving the set' if leaving else ''}")
        max_err = max(max_err, err)
    taken = set()
    for label, r, b, opts, door in tc.K3_DOOR_CASES:
        rows = torch.from_numpy(tc.k3_rows(r, b, 24, **opts)).cuda()
        err, (s, lim, kt) = _k3_check(kernels, rows,
                                      torch.tensor(r, device="cuda"),
                                      f"door case, {label}")
        max_err = max(max_err, err)
        got = "none" if s == lim == r else "leaving" if s == lim else \
            "check"
        if got != door or ("cross_at" in opts and
                           kt != opts["cross_at"] + 1):
            raise AssertionError(f"K3 door case {label}: exits {s}, {lim}, "
                                 f"{kt}, not by its door ({door})")
        taken |= {door} | ({"crossing"} if "cross_at" in opts else set()) \
            | ({"tiles"} if s > tc.K3_TILE else set())
    missing = {"none", "check", "leaving", "crossing", "tiles"} - taken
    if missing:
        raise AssertionError(f"K3: no case left the scan by {missing}")
    one = torch.zeros((1,), dtype=torch.int64, device="cuda")
    floor_ms = cuda_ms(lambda: one.fill_(1), 50)
    times = {}
    for label, rows, count in cases:
        r = int(count)
        k_ms = cuda_ms(lambda: kernels.ingest_scan(rows, count), 20)
        rc, cc = rows.cpu(), count.cpu()
        p_ms = _wall_ms(lambda: kernels._ingest_scan_torch(rc, cc))
        o_ms = _wall_ms(lambda: _old_host_recurrence(kernels, rows, count))
        bound_ms = kernels.ingest_scan_cost(r)["bytes_accessed"] \
            / MEM_RATE * 1e3
        walked = r - exits[label][0]
        chain_ms = floor_ms + walked * K3_CHAIN_NS * 1e-6
        times[label] = dict(rows=r, ms=k_ms, plain_ms=p_ms, old_ms=o_ms,
                            bound_ms=bound_ms, chain_ms=chain_ms)
        log(f"[k3] {label} ({r} reactivating rows, {walked} walked) on "
            f"{card}: device time per call (CUDA graph replay) "
            f"{k_ms:.6f} ms = {k_ms / bound_ms:.3f}x its byte bound "
            f"{bound_ms:.6f} ms, {k_ms / floor_ms:.3f}x the launch floor "
            f"{floor_ms:.6f} ms, {k_ms / chain_ms:.3f}x the floor plus the "
            f"chain of its walked rows ({K3_CHAIN_NS:.3f} ns a row) "
            f"{chain_ms:.6f} ms; plain (a host loop) {p_ms:.6f} ms; the "
            f"host recurrence it replaced (read back, loop, copy back) "
            f"{o_ms:.6f} ms")
    w = times["cluster wave"]
    return dict(name="ingest_scan", route="cuda", source=K3_SOURCE,
                replaces=K3_REPLACES, launches=None, max_abs_err=max_err,
                ms=w["ms"], plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by="bytes", library_ms=None,
                queue_flush_ms=times["queue flush"]["ms"],
                chain_bound_ms=w["chain_ms"])


def _serial_matches(kernels, st0, now, slots, phases, costs, what: str,
                    final_state=None) -> None:
    """``slots``/``phases``/``costs``: the prefix path's committed stream
    (1-d); the serial engine from ``st0`` must make exactly these."""
    steps = int(slots.shape[0])
    st, _, ser = kernels.engine_run(st0, now, steps,
                                    allow_limit_break=False,
                                    anticipation_ns=0)
    if not bool((ser.type == kernels.RETURNING).all()):
        raise AssertionError(f"{what}: serial engine stopped serving")
    for name, a, b in (("slot", slots, ser.slot),
                       ("phase", phases.to(torch.int32), ser.phase),
                       ("cost", costs.to(torch.int64), ser.cost)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} stream differs from "
                                 f"the serial engine")
    if final_state is not None:
        for f, a, b in zip(st._fields, final_state, st):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: state field {f} differs "
                                     f"from the serial engine")
    log(f"[exact] {what}: {steps} decisions equal the serial engine"
        + (" and so does the final state" if final_state is not None
           else ""))


def phase_exact(serve, fp, kernels) -> None:
    # weight phase only; then both phases (every reservation tag
    # eligible at 20 ms, the weight phase after they are served)
    for n, now in ((256, 0), (128, 20_000_000)):
        st0 = serve._preloaded_state(n, 8, ring=8, device="cuda")
        ep = fp.scan_prefix_epoch(st0, now, 4, 64, anticipation_ns=0,
                                  with_metrics=True)
        if not bool(ep.guards_ok.all()):
            raise AssertionError("exactness phase: a guard tripped")
        served = ep.slot >= 0
        if int(served.sum()) != int(ep.count.sum()) or \
                int(ep.count.sum()) == 0:
            raise AssertionError("exactness phase: bad committed count")
        _serial_matches(kernels, st0, now, ep.slot[served],
                        ep.phase[served], ep.cost[served],
                        f"{n} clients, depth 8, k=64, m=4, now={now}, "
                        f"phases {sorted(set(ep.phase[served].tolist()))}",
                        final_state=ep.state)


def _variable_cost_state(serve, kernels, n: int = 32, waves: int = 60,
                         seed: int = 99):
    """A variable-cost stream on the card (rho, delta and cost drawn per
    client per wave, about 30% of clients arriving each wave): weight
    serves whose reservation debt pulls the next head under ``now``
    chain into constraint serves.  Returns ``(state, now)``."""
    from dmclock_tpu_torch.core.timebase import rate_to_inv_ns
    from dmclock_tpu_torch.engine import bridge

    rng = np.random.default_rng(seed)
    arrays = serve._fresh_arrays(n, 64)
    c = np.arange(n)
    arrays.update(
        active=np.ones(n, dtype=bool), idle=np.zeros(n, dtype=bool),
        order=c.astype(np.int64),
        resv_inv=np.asarray([rate_to_inv_ns(1.0 + i % 3) for i in c],
                            dtype=np.int64),
        weight_inv=np.asarray([rate_to_inv_ns(1.0 + i % 4) for i in c],
                              dtype=np.int64))
    st = bridge.state_from_numpy(arrays, "cuda")

    def dev(x):
        return torch.from_numpy(np.asarray(x)).to("cuda")

    t = 1_000_000_000
    for _ in range(waves):
        t += int(rng.integers(0, 200_000_000))
        counts = (rng.random(n) < 0.3).astype(np.int32)
        delta = rng.integers(1, 5, n)
        rho = np.minimum(rng.integers(1, 5, n), delta)
        cost = rng.integers(1, 4, n)
        st = kernels.ingest_superwave(st, dev(counts), dev([t]), dev(cost),
                                      dev(rho), dev(delta),
                                      anticipation_ns=0)
    return st, t


def phase_exact_knobs(serve, fp, kernels) -> None:
    """Small shapes on the card: radix == sort; tag32 == tag64 on a
    high-rate state for every epoch engine; a chain epoch on a
    variable-cost stream == the serial engine."""
    st0 = serve._preloaded_state(256, 8, ring=8, device="cuda")
    for now in (0, 20_000_000):
        kw = dict(anticipation_ns=0, with_metrics=True)
        a = fp.scan_prefix_epoch(st0, now, 4, 64, **kw)
        b = fp.scan_prefix_epoch(st0, now, 4, 64, select_impl="radix", **kw)
        _equal_tuples(b, a, f"radix vs sort epoch, now={now}")
        ca = fp.scan_chain_epoch(st0, now, 4, 64, chain_depth=4, **kw)
        cb = fp.scan_chain_epoch(st0, now, 4, 64, chain_depth=4,
                                 select_impl="radix", **kw)
        _equal_tuples(cb, ca, f"radix vs sort chain epoch, now={now}")
    log("[knobs] 256 clients: radix prefix and chain epochs equal sort "
        "epochs at now 0 and 20 ms (every output and the state)")

    hi = serve.high_rate_state(256, 128, device="cuda")
    now = 20_000       # every high-rate reservation tag (10 us) eligible
    runs = {
        "prefix sort": lambda w: fp.scan_prefix_epoch(
            hi, now, 4, 64, anticipation_ns=0, with_metrics=True,
            tag_width=w),
        "prefix radix": lambda w: fp.scan_prefix_epoch(
            hi, now, 4, 64, anticipation_ns=0, with_metrics=True,
            tag_width=w, select_impl="radix", window_m=2),
        "chain": lambda w: fp.scan_chain_epoch(
            hi, now, 4, 64, chain_depth=4, anticipation_ns=0,
            with_metrics=True, tag_width=w),
    }
    for impl in ("minstop", "bucketed", "wheel"):
        runs[f"calendar {impl}"] = functools.partial(
            lambda w, impl: fp.scan_calendar_epoch(
                hi, now, 2, steps=8, with_metrics=True, tag_width=w,
                calendar_impl=impl, ladder_levels=3), impl=impl)
    for name, run in runs.items():
        e32, e64 = run(32), run(64)
        if int(e32.metrics[MET_REBASE_FALLBACKS]) != 0 or \
                int(e32.count.sum()) == 0:
            raise AssertionError(f"tag32 {name}: tripped or served nothing")
        _equal_tuples(e32, e64, f"tag32 vs tag64 {name}")
    log(f"[knobs] high-rate 256 clients: tag_width=32 equals 64 for "
        f"{', '.join(runs)} (every output, metrics and the state)")

    st, now = _variable_cost_state(serve, kernels)
    m, k = 8, 16
    ep = fp.scan_chain_epoch(st, now, m, k, chain_depth=4,
                             anticipation_ns=0, with_metrics=True)
    cur, slots, phases, costs = st, [], [], []
    for i in range(m):
        b = fp.speculate_chain_batch(cur, now, k, chain_depth=4,
                                     anticipation_ns=0)
        if not (torch.equal(b.slot, ep.slot[i])
                and torch.equal(b.length.to(torch.int8), ep.length[i])):
            raise AssertionError(f"chain epoch batch {i} differs from "
                                 f"speculate_chain_batch")
        s, p, c, _ = fp.expand_units(b.slot, b.cls, b.length, cur)
        slots.append(s)
        phases.append(p)
        costs.append(c)
        cur = b.state
    total = int(ep.count.sum())
    lens = ep.length[ep.slot >= 0].to(torch.int64)
    dev = torch.device("cuda")
    _serial_matches(kernels, st, now,
                    torch.from_numpy(np.concatenate(slots)).to(dev),
                    torch.from_numpy(np.concatenate(phases)).to(dev),
                    torch.from_numpy(np.concatenate(costs)).to(dev),
                    f"chain epoch, variable-cost stream, {total} decisions, "
                    f"unit lengths {torch.bincount(lens).tolist()}",
                    final_state=ep.state)


def phase_serve(serve, kernels, ext, obsdev, card: str):
    """The sort serve at full width; returns ``(K1 launches, the
    result, the median epoch ms)``: later phases hold the radix serve
    and the int32 carry's trip against this result."""
    ext.reset_launches()
    res = serve.serve_only(N_SERVE, DEPTH, K_SERVE, M_SERVE, EPOCHS,
                           device="cuda")
    torch.cuda.synchronize()
    launches = launched(ext)
    log(f"[serve] kernel launches on the main path: {launches}")
    if launches != {"ring_window": EPOCHS, "wheel_scan": 0}:
        raise AssertionError(f"serve launched {launches} over {EPOCHS} "
                             f"epochs (want K1 once per epoch, no K2)")
    total = int(res.count.sum())
    met = obsdev.metrics_dict(res.metrics)
    if not bool(res.guards_ok.all()):
        raise AssertionError("serve: a rebase guard tripped")
    if met["decisions_total"] != total:
        raise AssertionError(f"serve: metrics say {met['decisions_total']}"
                             f" decisions, counts say {total}")
    if total < EPOCHS * K_SERVE:
        raise AssertionError(f"serve: only {total} decisions")
    if res.slot.shape != (EPOCHS, M_SERVE, K_SERVE):
        raise AssertionError(f"serve: slot shape {tuple(res.slot.shape)}")
    if int(res.slot.min()) < -1 or int(res.slot.max()) >= N_SERVE:
        raise AssertionError("serve: a slot outside the population")
    log(f"[serve] {EPOCHS} epochs: {total} decisions, per-batch counts "
        f"min {int(res.count.min())} max {int(res.count.max())}, "
        f"every guard held; metrics {json.dumps(met)}")

    # the first decisions of the full-width run against the serial
    # engine, from the same preloaded state
    st0 = serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH,
                                 device="cuda")
    served = res.slot[0] >= 0
    steps = SERIAL_CHECK_STEPS
    _serial_matches(kernels, st0, 0, res.slot[0][served][:steps],
                    res.phase[0][served][:steps],
                    res.cost[0][served][:steps],
                    f"full width N={N_SERVE}, first {steps} decisions")
    del st0

    # timing: each epoch between CUDA events, state built beforehand
    st = serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH, device="cuda")
    st = serve.serve_epochs(st, 1, k=K_SERVE, m=M_SERVE).state  # warm
    torch.cuda.synchronize()
    ms, decisions = [], []
    for _ in range(TIMED_EPOCHS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        r = serve.serve_epochs(st, 1, k=K_SERVE, m=M_SERVE)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        st = r.state
        ms.append(start.elapsed_time(end))
        decisions.append(int(r.count.sum()))
        if not bool(r.guards_ok.all()) or decisions[-1] < K_SERVE:
            raise AssertionError(f"serve: a timed epoch committed "
                                 f"{decisions[-1]} decisions or tripped "
                                 f"a guard")
        if obsdev.metrics_dict(r.metrics)["decisions_total"] \
                != decisions[-1]:
            raise AssertionError("serve: a timed epoch's metrics "
                                 "disagree with its counts")
        log(f"[serve] epoch: {decisions[-1]} decisions in {ms[-1]:.3f} ms "
            f"(events), {host_ms:.3f} ms (host clock)")
    med = statistics.median(ms)
    log(f"[serve] on {card}: N={N_SERVE} Q={DEPTH} k={K_SERVE} "
        f"m={M_SERVE}: median epoch {med:.3f} ms over {TIMED_EPOCHS}; "
        f"{_rates(decisions, ms)}")
    return launches["ring_window"], res, med


def _rates(decisions, ms) -> str:
    """Both rates of a run of timed epochs or rounds: the mean (summed
    decisions over summed event ms) and the median-based one (the
    decisions of one epoch over the median epoch ms)."""
    med = statistics.median(ms)
    return (f"mean rate {sum(decisions) / (sum(ms) / 1e3):.1f} decisions/s "
            f"(summed decisions over summed ms), median-based rate "
            f"{statistics.median(decisions) / (med / 1e3):.1f} decisions/s "
            f"(median decisions of one over the median {med:.3f} ms)")


def _timed_epoch(run, st):
    """One ``run(st)`` between CUDA events: ``(result, event ms, host
    ms)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    r = run(st)
    end.record()
    torch.cuda.synchronize()
    return r, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def _launch_counted(ext, run, want: dict, what: str,
                    ingests: bool = False):
    """``run()`` with the launch counts set to 0 just before and read
    just after; raises unless they equal ``want``.  An ``ingests`` path
    (one that ingests op batches) must also have launched K3, whose
    count goes to :data:`K3_PATHS`."""
    torch.cuda.synchronize()
    ext.reset_launches()
    res = run()
    torch.cuda.synchronize()
    launches = launched(ext)
    log(f"[{what}] kernel launches on the path: {launches}")
    got = k3_taken(launches, what) if ingests else launches
    if got != want:
        raise AssertionError(f"{what} launched {launches}, want {want}")
    return res, launches


def phase_serve_radix(serve, ext, obsdev, sort_res, sort_med: float,
                      card: str) -> int:
    """The serve shape with radix selection: K1 once per epoch, every
    output and the state equal to the sort serve; then timed."""
    res, launches = _launch_counted(
        ext, lambda: serve.serve_only(N_SERVE, DEPTH, K_SERVE, M_SERVE,
                                      EPOCHS, select_impl="radix",
                                      device="cuda"),
        {"ring_window": EPOCHS, "wheel_scan": 0}, "serve_radix")
    if not bool(res.guards_ok.all()):
        raise AssertionError("serve_radix: a rebase guard tripped")
    _equal_tuples(res, sort_res, "serve_radix vs the sort serve")
    total = int(res.count.sum())
    log(f"[serve_radix] {EPOCHS} epochs: {total} decisions; slot, phase, "
        f"cost, count, guards, metrics and the final state equal the sort "
        f"serve's")
    st = serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH, device="cuda")
    st = serve.serve_epochs(st, 1, k=K_SERVE, m=M_SERVE,
                            select_impl="radix").state      # warm
    ms, decisions = [], []
    for _ in range(TIMED_EPOCHS):
        r, ev, host = _timed_epoch(
            lambda s: serve.serve_epochs(s, 1, k=K_SERVE, m=M_SERVE,
                                         select_impl="radix"), st)
        st = r.state
        ms.append(ev)
        decisions.append(int(r.count.sum()))
        if not bool(r.guards_ok.all()) or decisions[-1] < K_SERVE or \
                obsdev.metrics_dict(r.metrics)["decisions_total"] \
                != decisions[-1]:
            raise AssertionError("serve_radix: a bad timed epoch")
        log(f"[serve_radix] epoch: {decisions[-1]} decisions in {ev:.3f} "
            f"ms (events), {host:.3f} ms (host clock)")
    med = statistics.median(ms)
    log(f"[serve_radix] on {card}: median epoch {med:.3f} ms over "
        f"{TIMED_EPOCHS} ({med / sort_med:.3f}x the sort serve's "
        f"{sort_med:.3f} ms); {_rates(decisions, ms)}")
    return launches["ring_window"]


def phase_tag32(serve, fp, kernels, ext, obsdev, sort_res,
                card: str) -> int:
    """``tag_width=32`` on the high-rate state equals ``tag_width=64``
    and never trips, and the first 512 decisions equal the serial
    engine's; both widths timed side by side; then the carry's trip on
    the default-rate serve state falls back exactly."""
    hi0 = serve.high_rate_state(N_SERVE, RING_HIGH, device="cuda")
    r32, launches = _launch_counted(
        ext, lambda: serve.serve_epochs(hi0, EPOCHS, k=K_SERVE, m=M_SERVE,
                                        tag_width=32),
        {"ring_window": EPOCHS, "wheel_scan": 0}, "serve tag32")
    r64 = serve.serve_epochs(hi0, EPOCHS, k=K_SERVE, m=M_SERVE)
    met = obsdev.metrics_dict(r32.metrics)
    if met["rebase_fallbacks"] != 0 or not bool(r32.guards_ok.all()):
        raise AssertionError(f"tag32 on the high-rate state tripped: "
                             f"{met}")
    _equal_tuples(r32, r64, "high-rate serve, tag32 vs tag64")
    served = r64.slot[0] >= 0
    steps = SERIAL_CHECK_STEPS
    _serial_matches(kernels, hi0, 0, r64.slot[0][served][:steps],
                    r64.phase[0][served][:steps],
                    r64.cost[0][served][:steps],
                    f"high-rate N={N_SERVE}, first {steps} decisions")
    log(f"[tag32] high-rate N={N_SERVE} ring {RING_HIGH}: {EPOCHS} epochs, "
        f"{int(r32.count.sum())} decisions; every output, the metrics and "
        f"the final state equal tag_width=64; rebase_fallbacks 0")
    del hi0
    st = {64: r64.state, 32: r32.state}
    ms = {64: [], 32: []}
    for _ in range(TIMED_WIDTHS):
        for width in (64, 32):
            r, ev, host = _timed_epoch(
                lambda s: serve.serve_epochs(s, 1, k=K_SERVE, m=M_SERVE,
                                             tag_width=width), st[width])
            st[width] = r.state
            ms[width].append(ev)
            if not bool(r.guards_ok.all()) or \
                    obsdev.metrics_dict(r.metrics)["rebase_fallbacks"]:
                raise AssertionError(f"tag{width}: a timed epoch tripped")
            log(f"[tag32] tag_width={width} epoch: {int(r.count.sum())} "
                f"decisions in {ev:.3f} ms (events), {host:.3f} ms (host "
                f"clock)")
    med = {w: statistics.median(v) for w, v in ms.items()}
    log(f"[tag32] on {card}: high-rate median epoch tag_width=64 "
        f"{med[64]:.3f} ms, tag_width=32 {med[32]:.3f} ms "
        f"({med[32] / med[64]:.3f}x) over {TIMED_WIDTHS} each, alternated")
    del st, r32, r64

    # the default-rate serve state: tags advance 0.25-1 s a serve, so the
    # carry trips inside the epoch
    st0 = serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH, device="cuda")
    ep = fp.scan_prefix_epoch(st0, 0, M_SERVE, K_SERVE, anticipation_ns=0,
                              with_metrics=True, tag_width=32)
    guards = ep.guards_ok.cpu()
    if bool(guards.all()):
        raise AssertionError("tag32 trip: the default-rate epoch never "
                             "tripped")
    g = int(torch.argmax((~guards).to(torch.int32)))
    met = obsdev.metrics_dict(ep.metrics)
    if met["rebase_fallbacks"] != 1:
        raise AssertionError(f"tag32 trip: rebase_fallbacks "
                             f"{met['rebase_fallbacks']}, want 1")
    if bool(guards[g:].any()) or int(ep.count[g:].abs().sum()) or \
            not bool((ep.slot[g:] == -1).all()):
        raise AssertionError("tag32 trip: a batch after the trip "
                             "committed or kept its guard")
    for f in ("count", "guards_ok", "slot", "phase", "cost"):
        a, b = getattr(ep, f)[:g], getattr(sort_res, f)[0][:g]
        if not torch.equal(a, b):
            raise AssertionError(f"tag32 trip: {f} of the {g} good batches "
                                 f"differs from the int64 run")
    if g:
        ref = fp.scan_prefix_epoch(st0, 0, g, K_SERVE, anticipation_ns=0)
        _equal_tuples(ep.state, ref.state, f"tag32 trip: state vs the "
                      f"int64 run after {g} batches")
    else:
        _equal_tuples(ep.state, st0, "tag32 trip: state vs the input")
    log(f"[tag32] default-rate serve state, one epoch at tag_width=32: "
        f"the carry tripped at batch {g} of {M_SERVE}; rebase_fallbacks 1, "
        f"batches {g}..{M_SERVE - 1} committed nothing, the {g} good "
        f"batches ({int(ep.count.sum())} decisions) equal the int64 run's "
        f"and the state equals that run's after {g} batches")
    return launches["ring_window"]


def phase_chain(serve, fp, kernels, ext, obsdev, card: str, *, tag: str,
                st0, now: int, chains: bool) -> int:
    """The chain engine at full width from ``st0`` at ``now``: K1 once
    per batch, guards, both phases, the first 512 expanded decisions
    against the serial engine, the unit-length histogram (with
    ``chains``: units of 2 or more decisions, some among the checked
    ones); then timed epochs."""
    res, launches = _launch_counted(
        ext, lambda: serve.chain_epochs(st0, 1, k=K_SERVE, m=M_CHAIN,
                                        chain_depth=CHAIN_DEPTH,
                                        now_ns=now),
        {"ring_window": M_CHAIN, "wheel_scan": 0}, tag)
    met = obsdev.metrics_dict(res.metrics)
    total = int(res.count.sum())
    if not bool(res.guards_ok.all()):
        raise AssertionError(f"{tag}: a rebase guard tripped")
    if met["decisions_total"] != total or \
            int(res.count[0, 0]) < SERIAL_CHECK_STEPS or \
            not met["decisions_reservation"] or not met["decisions_priority"]:
        raise AssertionError(f"{tag}: {total} decisions, batch 0 "
                             f"{int(res.count[0, 0])}, metrics {met}")
    units = res.slot >= 0
    if int(res.unit_count.sum()) != int(units.sum()) or \
            int(res.length[units].to(torch.int64).sum()) != total:
        raise AssertionError(f"{tag}: units and lengths disagree with "
                             f"counts")
    hist = torch.bincount(res.length[units].to(torch.int64)).tolist()
    # the first units of batch 0 cover the first 512 decisions
    lens = res.length[0, 0].to(torch.int64).cpu()
    u = int(torch.searchsorted(torch.cumsum(lens, 0),
                               SERIAL_CHECK_STEPS)) + 1
    if chains and (len(hist) < 3 or int(lens[:u].max()) < 2):
        raise AssertionError(f"{tag}: no unit of 2 or more decisions among "
                             f"the checked ones (histogram {hist})")
    slots, phases, costs, _ = fp.expand_units(
        res.slot[0, 0, :u], res.cls[0, 0, :u], res.length[0, 0, :u], st0)
    dev = torch.device("cuda")
    steps = SERIAL_CHECK_STEPS
    _serial_matches(kernels, st0, now,
                    torch.from_numpy(slots[:steps]).to(dev),
                    torch.from_numpy(phases[:steps]).to(dev),
                    torch.from_numpy(costs[:steps]).to(dev),
                    f"{tag}, full width N={N_SERVE}, first {steps} expanded "
                    f"decisions ({u} units, longest "
                    f"{int(lens[:u].max())})")
    log(f"[{tag}] N={N_SERVE} depth {DEPTH} k={K_SERVE} m={M_CHAIN} chain "
        f"depth {CHAIN_DEPTH} now={now}: {total} decisions in "
        f"{int(units.sum())} units, per-batch counts {res.count[0].tolist()};"
        f" unit-length histogram (index = length) {hist}; metrics "
        f"{json.dumps(met)}")
    st = res.state
    ms, decisions = [], []
    for _ in range(TIMED_CHAIN):
        r, ev, host = _timed_epoch(
            lambda s: serve.chain_epochs(s, 1, k=K_SERVE, m=M_CHAIN,
                                         chain_depth=CHAIN_DEPTH,
                                         now_ns=now), st)
        st = r.state
        ms.append(ev)
        decisions.append(int(r.count.sum()))
        if not bool(r.guards_ok.all()):
            raise AssertionError(f"{tag}: a timed epoch tripped a guard")
        log(f"[{tag}] epoch: {decisions[-1]} decisions in {ev:.3f} ms "
            f"(events), {host:.3f} ms (host clock)")
    rate = sum(decisions) / max(sum(ms) / 1e3, 1e-9)
    log(f"[{tag}] on {card}: median epoch {statistics.median(ms):.3f} ms "
        f"over {TIMED_CHAIN}, {rate:.1f} decisions/s")
    return launches["ring_window"]


def phase_stop_ladder(serve, fp, kernels, ext, card: str) -> int:
    """The planner view at the cfg4 shape after one round's ingest."""
    dev = torch.device("cuda")
    c = serve.CFG4
    levels = c["ladder_levels"]
    st, draws = _cfg4_start(serve)
    ones = torch.ones((N_CFG4,), dtype=torch.int64, device=dev)
    wave_times = torch.arange(c["waves"], dtype=torch.int64, device=dev) \
        * (c["dt_round_ns"] // c["waves"])
    st = kernels.ingest_superwave(st, draws[0], wave_times, ones, ones,
                                  ones, anticipation_ns=0)
    now = c["dt_round_ns"]
    (lad, stop), launches = _launch_counted(
        ext, lambda: fp.calendar_stop_ladder(st, now, steps=c["steps"],
                                             levels=levels),
        {"ring_window": 1, "wheel_scan": 0}, "stop ladder")
    stop_np = stop.cpu().numpy()
    fin = np.sort(stop_np[stop_np < KEY_INF])
    if fin.size == 0:
        raise AssertionError("stop ladder: no finite stop pack")
    ranks = [max(-(-i * fin.size // levels), 1) for i in
             range(1, levels + 1)]
    want = fin[[r - 1 for r in ranks]]
    got = lad.cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"stop ladder {got.tolist()} != numpy "
                             f"quantiles {want.tolist()}")
    if (np.diff(got) < 0).any():
        raise AssertionError("stop ladder: not nondecreasing")
    kth1 = int(kernels.radix_kth_key(stop, 1))
    if kth1 != int(fin[0]) or kth1 != int(stop.min()):
        raise AssertionError("stop ladder: the rank-1 key is not the min")
    ms = host_paced_ms(lambda: fp.calendar_stop_ladder(
        st, now, steps=c["steps"], levels=levels), 3, warmup=1)
    log(f"[ladder] cfg4 shape N={N_CFG4} steps {c['steps']} levels "
        f"{levels} after one round's ingest: {fin.size} finite stop packs;"
        f" the ladder equals numpy's quantiles at ranks {ranks}, is "
        f"nondecreasing; min(stop_pk) = rank-1 key = {kth1}, B_1 = "
        f"{int(got[0])}; {ms:.3f} ms a call on {card} (host-paced)")
    return launches["ring_window"]


# metric rows only the wheel writes (wheel_bucket_occupancy_hwm,
# wheel_reslots_total): left out where the wheel meets another scheme
WHEEL_ROWS = (17, 18)
MET_REBASE_FALLBACKS = 8


def _equal_tuples(a, b, what: str) -> None:
    """Every field of two result NamedTuples (a state field by field;
    metrics without the wheel's own rows)."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:   # an accumulator that was off
            if not (x is None and y is None):
                raise AssertionError(f"{what}: field {f} is None on one "
                                     f"side only")
            continue
        if isinstance(x, tuple):
            _equal_tuples(x, y, f"{what} {f}")
            continue
        if f == "metrics":
            keep = torch.ones(x.shape[-1], dtype=torch.bool, device=x.device)
            keep[list(WHEEL_ROWS)] = False
            x, y = x[..., keep], y[..., keep]
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: field {f} differs")


def phase_calendar_exact(serve, fp, kernels) -> None:
    """Small cfg4-like state on the card (Zipf weights, reservations,
    ingested tails): the wheel epoch against the serial engine, wheel ==
    bucketed, and one ladder level == minstop."""
    dev = torch.device("cuda")
    n, ring, depth0 = 48, 16, 8
    rates = np.full(n, 1200.0)
    rates[::5] = 0.0
    st = serve._sustained_setup(n, ring, depth0, rates,
                                serve._zipf_weights(n), device="cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    counts = torch.minimum(
        torch.randint(0, 9, (n,), generator=gen, device=dev,
                      dtype=torch.int32),
        (ring - st.depth).to(torch.int32))
    ones = torch.ones((n,), dtype=torch.int64, device=dev)
    st = kernels.ingest_superwave(
        st, counts, torch.arange(8, dtype=torch.int64, device=dev)
        * 6_250_000, ones, ones, ones, anticipation_ns=0)
    now = 50_000_000
    kw = dict(steps=6, with_metrics=True)
    ep = {impl: fp.scan_calendar_epoch(st, now, 2, calendar_impl=impl,
                                       ladder_levels=3, **kw)
          for impl in ("wheel", "bucketed")}
    _equal_tuples(ep["wheel"], ep["bucketed"], "wheel vs bucketed epoch")
    total = int(ep["wheel"].count.sum())
    resv = int(ep["wheel"].resv_count.sum())
    if not (0 < resv < total) or not bool(ep["wheel"].progress_ok.all()):
        raise AssertionError(f"calendar exactness: {total} decisions, "
                             f"{resv} reservation, or a stalled batch")
    ser_st, _, ser = kernels.engine_run(st, now, total,
                                        allow_limit_break=False,
                                        anticipation_ns=0)
    served = torch.bincount(ser.slot.to(torch.int64),
                            minlength=n).to(torch.int32)
    if not bool((ser.type == kernels.RETURNING).all()) or \
            not torch.equal(served, ep["wheel"].served):
        raise AssertionError("calendar exactness: per-client counts "
                             "differ from the serial engine")
    _equal_tuples(ep["wheel"].state, ser_st, "wheel epoch vs serial")
    one = fp.scan_calendar_epoch(st, now, 3, calendar_impl="wheel",
                                 ladder_levels=1, **kw)
    mins = fp.scan_calendar_epoch(st, now, 3, calendar_impl="minstop", **kw)
    for f in ("count", "resv_count", "progress_ok", "served",
              "level_count"):
        if not torch.equal(getattr(one, f), getattr(mins, f)):
            raise AssertionError(f"wheel L=1 vs minstop: {f} differs")
    _equal_tuples(one.state, mins.state, "wheel L=1 vs minstop")
    log(f"[cal-exact] {n} clients, ring {ring}: wheel epoch ({total} "
        f"decisions, {resv} reservation) equals the serial engine's "
        f"counts and state, equals bucketed on every output, and one "
        f"ladder level equals minstop ({int(mins.count.sum())} decisions)")


def _calibration_line(what: str, prep, t_cal: float) -> str:
    """What bench's calibration settled on, for the log."""
    import hashlib

    inv = prep.state.resv_inv.cpu().numpy()
    return (f"[{what}] bench's calibration on the card: {prep.cal_rounds} "
            f"rounds (the warm round, then "
            f"{(prep.cal_rounds - 1) // 2} x 2 calibration rounds) in "
            f"{t_cal:.3f} s; calibrated lam sum "
            f"{float(prep.lam.sum())!r}, resv_inv sha256 "
            f"{hashlib.sha256(inv.tobytes()).hexdigest()[:16]} (mean "
            f"{float(inv.mean())!r} ns), measured reservation share of "
            f"the last iteration {prep.resv_share!r}; timed rounds from "
            f"t0 {prep.t0}")


def phase_cfg4_wheel(serve, ext, obsdev, card: str) -> dict:
    """The ``cfg4_wheel`` path at full width: bench's calibration (11
    wheel rounds) and the rounds after it, launch-counted together; wheel
    == bucketed over one round with telemetry on (all four of bench's
    accumulators equal, and the decisions equal the counted round 0's,
    which ran with telemetry off), then timed rounds."""
    c = serve.CFG4
    levels = c["ladder_levels"]
    torch.cuda.synchronize()
    ext.reset_launches()
    t_cal = time.perf_counter()
    prep = serve.cfg4_setup(N_CFG4, CFG4_ROUNDS + CFG4_TIMED,
                            calendar_impl="wheel", device="cuda")
    t_cal = time.perf_counter() - t_cal
    state0, draws, base = prep.state, prep.draws, prep.t0
    res = serve.cfg4_rounds(state0, draws[:CFG4_ROUNDS],
                            calendar_impl="wheel", t0=base)
    torch.cuda.synchronize()
    launches = launched(ext)
    rounds = 1 + prep.cal_rounds + CFG4_ROUNDS
    log(f"[cfg4_wheel] kernel launches on the main path over the "
        f"capture's warm-up round, {prep.cal_rounds} calibration and "
        f"{CFG4_ROUNDS} rounds: {launches}")
    log(_calibration_line("cfg4_wheel", prep, t_cal))
    want = {"ring_window": rounds * c["m"] * levels,
            "wheel_scan": rounds * c["m"] * (1 + levels)}
    if launches != want:
        raise AssertionError(f"cfg4_wheel launches {launches}, want {want}")
    met = obsdev.metrics_dict(res.metrics)
    total = int(res.count.sum())
    if not bool(res.progress_ok.all()):
        raise AssertionError("cfg4_wheel: a batch made no progress")
    if met["decisions_total"] != total or total <= 0:
        raise AssertionError(f"cfg4_wheel: metrics say "
                             f"{met['decisions_total']} decisions, counts "
                             f"say {total}")
    if int(res.served.sum()) != total or \
            int(res.level_count.sum()) != total or \
            res.served.shape != (CFG4_ROUNDS, N_CFG4):
        raise AssertionError("cfg4_wheel: per-client or per-level counts "
                             "disagree with the batch counts")
    st = res.state
    if int(st.depth.min()) < 0 or int(st.depth.max()) > c["ring"]:
        raise AssertionError("cfg4_wheel: a queue depth outside [0, ring]")
    log(f"[cfg4_wheel] {CFG4_ROUNDS} rounds: {total} decisions, per-batch "
        f"counts {res.count.tolist()}, metrics {json.dumps(met)}")

    # one full-width round with telemetry on, wheel against bucketed,
    # from the same state and draws; the decisions equal the main path's
    # round 0 (telemetry off there)
    plane = serve.slo_plane("cfg4", N_CFG4, state=state0)
    tele = serve.tele_zero(N_CFG4, plane=plane, t0=base, device="cuda")
    rw = serve.cfg4_rounds(state0, draws[:1], calendar_impl="wheel",
                           tele=tele, t0=base)
    rb = serve.cfg4_rounds(state0, draws[:1], calendar_impl="bucketed",
                           tele=tele, t0=base)
    _equal_tuples(rw, rb, "full-width round with telemetry, wheel vs "
                  "bucketed")
    for f in ("count", "resv_count", "progress_ok", "served",
              "level_count"):
        if not torch.equal(getattr(rw, f)[0], getattr(res, f)[0]):
            raise AssertionError(f"cfg4_wheel round 0: {f} differs with "
                                 f"telemetry on")
    led = int(rw.tele.ledger[:, 0].sum())
    if led != int(rw.count.sum()):
        raise AssertionError("cfg4_wheel: the ledger's ops disagree")
    log(f"[cfg4_wheel] full-width round with telemetry, SLO and provenance "
        f"on: wheel equals bucketed on every output, the final state and "
        f"the histograms, ledger, SLO window and provenance blocks "
        f"({int(rw.count.sum())} decisions, ledger ops {led}), and its "
        f"decisions equal the telemetry-off round's")
    del rw, rb, state0

    # timed rounds: CUDA events around each round, ingest inside; the
    # rows' spans (a launch, then its synchronisation) beside them
    from dmclock_tpu_torch.obs.spans import SpanTracer, span

    tracer = SpanTracer()
    win = tracer.category_totals()
    ms, decisions, host = [], [], []
    met_t = obsdev.metrics_zero("cuda")
    for r in range(CFG4_ROUNDS, CFG4_ROUNDS + CFG4_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with span(tracer, "serve.round", "dispatch"):
            out = serve.cfg4_rounds(st, draws[r:r + 1],
                                    calendar_impl="wheel",
                                    t0=base + r * c["dt_round_ns"])
            end.record()
        with span(tracer, "serve.sync", "device_compute"):
            torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        st = out.state
        ms.append(start.elapsed_time(end))
        decisions.append(int(out.count.sum()))
        met_t = obsdev.metrics_combine(met_t, out.metrics)
        if not bool(out.progress_ok.all()):
            raise AssertionError("cfg4_wheel: a timed batch made no "
                                 "progress")
        log(f"[cfg4_wheel] round {r}: {decisions[-1]} decisions in "
            f"{ms[-1]:.3f} ms (events), {host[-1]:.3f} ms (host clock)")
    mt = obsdev.metrics_dict(met_t)
    if mt["decisions_total"] != sum(decisions):
        raise AssertionError("cfg4_wheel: timed metrics disagree with "
                             "counts")
    log(f"[cfg4_wheel] on {card}: N={N_CFG4} ring={c['ring']} "
        f"waves={c['waves']} m={c['m']} steps={c['steps']} levels={levels}"
        f": median round {statistics.median(ms):.3f} ms over {CFG4_TIMED},"
        f" {sum(decisions) / CFG4_TIMED:.1f} decisions per round; "
        f"{_rates(decisions, ms)}; ingest_drops {mt['ingest_drops']}, "
        f"reservation share "
        f"{mt['decisions_reservation'] / mt['decisions_total']:.6f}")
    # phase 28 (c): the cost counter's count of one round from the
    # calibrated state, telemetry, SLO and provenance on and zero
    # arrivals (what the cfg4_wheel row counts), beside the timed rounds'
    # spans; its launches are a path of their own
    row_cfg = serve._row_cfg("cfg4")
    round_fn, eng_kw = serve._round_body("cfg4", row_cfg, "wheel")
    t_end = base + (CFG4_ROUNDS + CFG4_TIMED) * c["dt_round_ns"]
    tele = serve.tele_zero(N_CFG4, plane=plane, t0=t_end, device="cuda")
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    cost = serve.count_round(round_fn, eng_kw, st, tele, t_end)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    if "error" in cost:
        raise AssertionError(f"cfg4_wheel: the cost count failed: {cost}")
    row = {"cost_analysis": cost,
           "spans": serve._span_summary(tracer, win, sum(host) / 1e3,
                                        CFG4_TIMED),
           "event_ms": statistics.median(ms),
           "count_launches": launched(ext), "count_s": count_s}
    return launches, row


# ----------------------------------------------------------------------
# the sustained rows with telemetry: cfg3, cfg3_stream, cfg4 (minstop)
# ----------------------------------------------------------------------

def _sustained_rounds(serve, workload: str, st, draws, tele, r0: int,
                      rounds: int, base: int = 0, **kw):
    """``rounds`` rounds from round ``r0`` (timed round ``r`` at ``base +
    r * dt``, ``base`` where calibration ended), one call each (so each
    round's accumulators are kept): ``(results, final state, final
    tele)``."""
    run = serve.cfg3_rounds if workload == "cfg3" else serve.cfg4_rounds
    dt = (serve.CFG3 if workload == "cfg3" else serve.CFG4)["dt_round_ns"]
    out = []
    for r in range(r0, r0 + rounds):
        res = run(st, draws[r:r + 1], t0=base + r * dt, tele=tele, **kw)
        st, tele = res.state, res.tele
        out.append(res)
    return out, st, tele


def _check_rounds(obsdev, what: str, results, tele0, guard: str) -> list:
    """Every round: the guards (or progress) hold, the metrics' decision
    row equals the counts, and the ledger's and the SLO block's ops
    grow by the round's decisions.  Returns the per-round decisions."""
    prev_led = int(tele0.ledger[:, 0].sum())
    prev_slo = int(tele0.slo[:, 0].sum())
    out = []
    for i, res in enumerate(results):
        total = int(res.count.sum())
        met = obsdev.metrics_dict(res.metrics)
        led = int(res.tele.ledger[:, 0].sum())
        slo = int(res.tele.slo[:, 0].sum())
        if not bool(getattr(res, guard).all()) or total <= 0 or \
                met["decisions_total"] != total or \
                led - prev_led != total or slo - prev_slo != total:
            raise AssertionError(
                f"{what} round {i}: {guard} {getattr(res, guard).tolist()},"
                f" {total} decisions, metrics {met['decisions_total']}, "
                f"ledger ops +{led - prev_led}, SLO ops +{slo - prev_slo}")
        prev_led, prev_slo = led, slo
        out.append(total)
    return out


def _timed_rounds(serve, workload: str, st, draws, tele, r0: int,
                  rounds: int, base: int = 0, **kw):
    """``rounds`` rounds between CUDA events, one each: ``(ms, host ms,
    decisions, state, tele)``."""
    run = serve.cfg3_rounds if workload == "cfg3" else serve.cfg4_rounds
    dt = (serve.CFG3 if workload == "cfg3" else serve.CFG4)["dt_round_ns"]
    ms, host, decisions = [], [], []
    for r in range(r0, r0 + rounds):
        res, ev, h = _timed_epoch(
            lambda s: run(s, draws[r:r + 1], t0=base + r * dt, tele=tele,
                          **kw), st)
        st, tele = res.state, res.tele
        ms.append(ev)
        host.append(h)
        decisions.append(int(res.count.sum()))
    return ms, host, decisions, st, tele


def _on_off(serve, obsdev, workload: str, st, draws, tele, r0: int,
            rounds: int, what: str, base: int = 0, **kw):
    """Telemetry on against off at full width: ``rounds`` rounds of each
    from the same state, alternated, each between CUDA events; every
    round's decisions, state and metrics equal.  Returns the on/off
    ratio of the median round times."""
    st_on = st_off = st
    tele_off = serve.Tele()
    ms_on, ms_off = [], []
    for r in range(r0, r0 + rounds):
        a = _timed_rounds(serve, workload, st_on, draws, tele, r, 1, base,
                          **kw)
        b = _timed_rounds(serve, workload, st_off, draws, tele_off, r, 1,
                          base, **kw)
        ms_on += a[0]
        ms_off += b[0]
        if a[2] != b[2]:
            raise AssertionError(f"{what}: round {r} decisions {a[2]} with "
                                 f"telemetry, {b[2]} without")
        _equal_tuples(a[3], b[3], f"{what} round {r}: state, telemetry on "
                      f"vs off")
        st_on, tele, st_off = a[3], a[4], b[3]
    # the decision outputs and the metrics, over one more round each
    run = serve.cfg3_rounds if workload == "cfg3" else serve.cfg4_rounds
    dt = (serve.CFG3 if workload == "cfg3" else serve.CFG4)["dt_round_ns"]
    r = r0 + rounds
    on = run(st_on, draws[r:r + 1], t0=base + r * dt, tele=tele, **kw)
    off = run(st_off, draws[r:r + 1], t0=base + r * dt, **kw)
    _equal_tuples(on._replace(tele=None), off._replace(tele=None),
                  f"{what}: telemetry on vs off")
    ratio = statistics.median(ms_on) / statistics.median(ms_off)
    log(f"[{what}] telemetry, SLO and provenance on against off, "
        f"{rounds + 1} full-width rounds each from the same state: "
        f"decisions, state and metrics equal; median round "
        f"{statistics.median(ms_on):.3f} ms on, "
        f"{statistics.median(ms_off):.3f} ms off (ratio {ratio:.3f}; "
        f"rounds on {[round(x, 3) for x in ms_on]}, off "
        f"{[round(x, 3) for x in ms_off]})")
    return ratio


def _scalars_line(serve, tele, st, t_end: int, dt: int) -> str:
    sc = serve.row_scalars(tele, st, t_end, dt)
    keys = ("tardiness_p50_ns", "tardiness_p90_ns", "tardiness_p99_ns",
            "tardiness_mean_ns", "tardiness_max_ns", "margin_p50_ns",
            "margin_p99_ns", "starvation_max_ns", "limit_gate_share",
            "starved_clients", "slo_window_totals")
    return json.dumps({k: sc.get(k, []) if k == "starved_clients"
                       else sc[k] for k in keys})


def _prepared_rounds(serve, workload: str, n: int, n_draws: int,
                     rounds: int, **kw):
    """Bench's calibration, fresh accumulators at the calibrated time
    with the SLO contracts re-registered from the calibrated state, then
    ``rounds`` rounds: ``(prep, tele0, calibration s, (results, state,
    tele))``."""
    t_cal = time.perf_counter()
    setup = serve.cfg3_setup if workload == "cfg3" else serve.cfg4_setup
    prep = setup(n, n_draws, device="cuda", **kw)
    t_cal = time.perf_counter() - t_cal
    tele0 = serve.tele_zero(n, plane=serve.slo_plane(workload, n,
                                                     state=prep.state),
                            t0=prep.t0, device="cuda")
    return prep, tele0, t_cal, _sustained_rounds(
        serve, workload, prep.state, prep.draws, tele0, 0, rounds,
        prep.t0, **kw)


def sustained_twins(out: str) -> None:
    """The CPU twins of phases 14 and 16 (in a child process): each row's
    calibration at full width and its first timed round with telemetry,
    SLO and provenance on; saved to ``out``."""
    from dmclock_tpu_torch import serve

    torch.set_num_threads(2)
    rows = {}
    for workload, n, kw in (("cfg3", N_CFG3, {}),
                            ("cfg4", N_CFG4,
                             dict(calendar_impl="minstop"))):
        setup = serve.cfg3_setup if workload == "cfg3" \
            else serve.cfg4_setup
        prep = setup(n, 1, device="cpu", **kw)
        tele = serve.tele_zero(n, plane=serve.slo_plane(workload, n,
                                                        state=prep.state),
                               t0=prep.t0, device="cpu")
        run = serve.cfg3_rounds if workload == "cfg3" \
            else serve.cfg4_rounds
        rows[workload] = _sustained_numpy(
            prep, run(prep.state, prep.draws, t0=prep.t0, tele=tele, **kw))
    torch.save(rows, out)


def start_sustained_twins(root: str, out: str) -> subprocess.Popen:
    code = ("import sys\n"
            f"sys.path.insert(0, {root!r})\n"
            "import chip_smoke\n"
            f"chip_smoke.sustained_twins({out!r})\n")
    return _cpu_child(code, out)


def _sustained_numpy(prep, first) -> dict:
    """A calibrated row (its calibrated rates, state and first timed
    round's draws) and its first timed round, as host numpy."""
    out = {"lam": np.asarray(prep.lam), "t0": np.asarray(prep.t0),
           "draw0": prep.draws[0].cpu().numpy()}
    out.update({f"prep.state.{f}": getattr(prep.state, f).cpu().numpy()
                for f in prep.state._fields})
    for f in first._fields:
        v = getattr(first, f)
        if torch.is_tensor(v):
            out[f"round0.{f}"] = v.cpu().numpy()
        elif f == "state":
            out.update({f"round0.state.{g}": getattr(v, g).cpu().numpy()
                        for g in v._fields})
        elif f == "tele":
            for g in v._fields:
                x = getattr(v, g)
                if torch.is_tensor(x):
                    out[f"round0.tele.{g}"] = x.cpu().numpy()
                elif x is not None:
                    out.update({f"round0.tele.{g}.{h}":
                                getattr(x, h).cpu().numpy()
                                for h in x._fields})
    return out


def check_sustained_twins(proc, out: str, rows: dict) -> None:
    """Phases 14 and 16's calibrated rows on the card against the CPU
    twins."""
    want = collect_cpu_twins(proc, out)
    for workload, got in rows.items():
        _same_numpy(got, want[workload], f"{workload} vs its CPU twin")
        log(f"[{workload}] the calibrated rates, state and first timed "
            f"round's draws, and the first timed round (every output, the "
            f"state and the four accumulators) equal the CPU twin's")


def _resv_share(obsdev, results) -> float:
    """The reservation-phase share of ``results``' decisions (their
    metrics rows)."""
    met = obsdev.metrics_zero("cuda")
    for res in results:
        met = obsdev.metrics_combine(met, res.metrics)
    md = obsdev.metrics_dict(met)
    return md["decisions_reservation"] / max(md["decisions_total"], 1)


def _row_k1(workload: str, cut: dict, window: int, m: int) -> int:
    """K1 launches of a sustained row: once a calendar batch (m a round)
    or once a prefix round, over the capture's warm-up round, the
    calibration, the timed chains, the conformance rounds, the latency
    rounds with their window and the one round the cost counter
    counts."""
    n_pre = cut["reps"] * (cut["rounds_lo"] + cut["rounds"]) \
        if cut["rounds_lo"] else cut["rounds"]
    rounds = 1 + ROW_CAL[workload] + n_pre + 2 + (
        cut["latency_rounds"] + window if cut["latency_rounds"] else 0) + 1
    return rounds * m


def phase_row(serve, ext, card: str, workload: str, n: int, tmp: str) -> int:
    """Bench's sustained row whole at full width (``serve.sustained_row``,
    cut in depth to ``ROW_CUT``): calibration, ``reps`` pairs of timed
    chains with the SLO block rolled once a chain, 2 conformance rounds
    with the per-client table, cfg4's latency rounds, the verdict and
    the tails; host spans on, watched by a watchdog with bench's
    settings.  Launch-counted (K1 once a prefix round or a calendar
    batch, no K2).  Checks: the SLO block rolled once a chain
    (``2 * reps``), ``latency_samples == latency_rounds``, the table has
    a line a client whose ``ops`` sum to the conformance rounds'
    decisions, the registry's warning counter equals the watchdog's
    warnings.  Returns the K1 launches."""
    from dmclock_tpu_torch.obs.registry import MetricsRegistry
    from dmclock_tpu_torch.obs.spans import SpanTracer
    from dmclock_tpu_torch.obs.watchdog import Watchdog

    cut = ROW_CUT[workload]
    m = serve.CFG4["m"] if workload == "cfg4" else 1   # K1 a round
    t_phase = time.perf_counter()
    tracer = SpanTracer()
    reg = MetricsRegistry()
    lines = []
    watchdog = Watchdog(tracer, interval_s=2.0, stall_after_s=60.0,
                        registry=reg, log=lines.append).start()
    path = os.path.join(tmp, f"{workload}_conformance.jsonl")
    torch.cuda.synchronize()
    ext.reset_launches()
    try:
        row = serve.sustained_row(workload, n, **cut, conformance_rounds=2,
                                  conformance_out=path, tracer=tracer,
                                  watchdog=watchdog, device="cuda")
    finally:
        watchdog.close()
    torch.cuda.synchronize()
    launches = launched(ext)
    want = {"ring_window": _row_k1(workload, cut,
                                   row.get("latency_window", 0), m),
            "wheel_scan": 0}
    log(f"[{workload} row] kernel launches on the path: {launches}")
    if launches != want:
        raise AssertionError(f"{workload} row launched {launches}, want "
                             f"{want}")
    if row["slo"]["rolls"] != 2 * cut["reps"]:
        raise AssertionError(f"{workload} row: {row['slo']['rolls']} SLO "
                             f"rolls, want one a chain ({2 * cut['reps']})")
    if row.get("latency_samples", 0) != cut["latency_rounds"]:
        raise AssertionError(f"{workload} row: {row.get('latency_samples')}"
                             f" latency samples, want "
                             f"{cut['latency_rounds']}")
    with open(path) as f:
        table = [json.loads(ln) for ln in f]
    ops = sum(r["ops"] for r in table)
    if len(table) != n or ops != row["conformance_decisions"] or ops <= 0:
        raise AssertionError(f"{workload} row: the conformance table has "
                             f"{len(table)} lines (want {n}) and {ops} ops "
                             f"(the rounds' decisions "
                             f"{row['conformance_decisions']})")
    counted = reg.counter("dmclock_watchdog_warnings_total").value
    if counted != len(watchdog.warnings):
        raise AssertionError(f"{workload} row: the registry counts "
                             f"{counted} watchdog warnings, the watchdog "
                             f"holds {len(watchdog.warnings)}")
    keys = ("dps", "decisions", "fill", "resv_phase_frac", "mean_depth",
            "bounded_by", "decisions_per_launch", "decisions_per_pass",
            "chain_ms", "sync_latency_ms", "event_round_ms_median",
            "event_round_ms_mean", "dispatch_ms_per_launch",
            "host_overhead_frac", "slo_violations_total",
            "slo_worst_share_err", "slo_window_tardiness_p99_ns",
            "slo_windows_closed", "conformance", "conformance_decisions",
            "latency_samples", "latency_window", "round_ms_p50",
            "round_ms_p99", "round_ms_mean", "tardiness_p50_ns",
            "tardiness_p99_ns", "margin_p50_ns", "margin_p99_ns",
            "starvation_max_ns", "limit_gate_share")
    log(f"[{workload} row] bench's timed structure at N={n} "
        f"({json.dumps(cut)}, 2 conformance rounds) on {card}: "
        + json.dumps({k: row[k] for k in keys if k in row}))
    log(f"[{workload} row] the SLO verdict {json.dumps(row['slo'])}; "
        f"starved_clients {len(row.get('starved_clients', []))} shown; "
        f"the watchdog {len(watchdog.warnings)} warnings ("
        f"{sorted(set(w['kind'] for w in watchdog.warnings))}), the "
        f"registry's counter {counted}; the last: "
        f"{json.dumps(watchdog.warnings[-3:])}")
    log(f"[time] {workload} row {time.perf_counter() - t_phase:.3f} s")
    return launches["ring_window"], row


def phase_frontier(serve, ext, card: str) -> int:
    """The cfg4 frontier (``serve.frontier``) at full width over
    ``FRONTIER_CUT``'s points, each row cut in depth, with a
    ``FRONTIER_TARGET_MS`` pick; launch-counted (K1 m a round).  Returns
    the K1 launches."""
    cut = dict(FRONTIER_CUT)
    points = cut.pop("points")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    ext.reset_launches()
    pick, rows = serve.frontier(points, n=N_CFG4, **cut,
                                target_latency_ms=FRONTIER_TARGET_MS,
                                device="cuda")
    torch.cuda.synchronize()
    launches = launched(ext)
    window = 4     # latency_rounds 8 < 20: the window is 4
    want = {"ring_window": sum(_row_k1("cfg4", cut, window, m)
                               for m, _ in points), "wheel_scan": 0}
    log(f"[frontier] kernel launches on the path: {launches}")
    if launches != want:
        raise AssertionError(f"frontier launched {launches}, want {want}")
    if [(r["m"], r["steps"]) for r in rows] != list(points) or \
            pick is None or any(r["decisions"] <= 0 for r in rows):
        raise AssertionError(f"frontier: rows {rows}, pick {pick}")
    for r in rows:
        log(f"[frontier] m={r['m']} steps={r['steps']} on {card}: "
            + json.dumps(r))
    log(f"[frontier] --target-latency {FRONTIER_TARGET_MS} ms pick: "
        f"{json.dumps(pick)}")
    log(f"[time] frontier phase {time.perf_counter() - t_phase:.3f} s")
    return launches["ring_window"]


def phase_cfg3(serve, ext, obsdev, card: str):
    """Bench's cfg3 row at full width with telemetry, SLO and provenance
    on: bench's calibration (3 rounds) and the rounds after it,
    launch-counted together (K1 once a round), every timed round
    checked, timed rounds, bench's derived scalars; then telemetry on
    against off.  Returns ``(K1 launches, state, tele, draws, next round,
    ratio, the calibrated t0, the twin's numpy)``."""
    c = serve.CFG3
    n_draws = CFG3_ROUNDS + CFG3_TIMED + max(CFG3_TIMED + 1,
                                             serve.STREAM_CHUNK)
    t_phase = time.perf_counter()
    (prep, tele0, t_cal, (results, st, tele)), launches = _launch_counted(
        ext, lambda: _prepared_rounds(serve, "cfg3", N_CFG3, n_draws,
                                      CFG3_ROUNDS),
        {"ring_window": 4 + CFG3_ROUNDS, "wheel_scan": 0}, "cfg3")
    log(_calibration_line("cfg3", prep, t_cal))
    base, draws = prep.t0, prep.draws
    twin = _sustained_numpy(prep, results[0])
    decisions = _check_rounds(obsdev, "cfg3", results, tele0, "guards_ok")
    met = obsdev.metrics_dict(results[-1].metrics)
    log(f"[cfg3] N={N_CFG3} ring={c['ring']} depth0={c['depth0']} "
        f"waves={c['waves']} m={c['m']} k={c['k']}: {CFG3_ROUNDS} rounds, "
        f"decisions {decisions}; every guard held, each round's metrics "
        f"decision row, ledger ops and SLO ops equal its counts; last "
        f"round's metrics {json.dumps(met)}")
    r = CFG3_ROUNDS
    ms, host, dec, st, tele = _timed_rounds(serve, "cfg3", st, draws, tele,
                                            r, CFG3_TIMED, base)
    r += CFG3_TIMED
    for i, (a, b, d) in enumerate(zip(ms, host, dec)):
        log(f"[cfg3] round {CFG3_ROUNDS + i}: {d} decisions in {a:.3f} ms "
            f"(events), {b:.3f} ms (host clock)")
    log(f"[cfg3] on {card}: median round {statistics.median(ms):.3f} ms "
        f"over {CFG3_TIMED} (telemetry, SLO and provenance on); "
        f"{_rates(dec, ms)}; K1 once a round "
        f"({launches['ring_window']} over {4 + CFG3_ROUNDS}: the "
        f"capture's warm-up, 3 calibration rounds and {CFG3_ROUNDS})")
    log(f"[cfg3] bench's derived scalars after {r} timed rounds: "
        + _scalars_line(serve, tele, st, base + r * c["dt_round_ns"],
                        c["dt_round_ns"]))
    ratio = _on_off(serve, obsdev, "cfg3", st, draws, tele, r, CFG3_TIMED,
                    "cfg3", base)
    log(f"[time] cfg3 phase {time.perf_counter() - t_phase:.3f} s")
    return launches["ring_window"], st, tele, draws, r, ratio, base, twin


def _capture_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: returns
    ``(result, the synchronizing operations reported)``.  PyTorch's
    one-time notice that the mode is a prototype is not one of them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]
    return res, syncs


def phase_cfg3_stream(serve, ext, obsdev, card: str, st, tele, draws,
                      r0: int, base: int) -> int:
    """``cfg3_stream``: one chunk of 8 rounds (launch-counted, K1 once an
    epoch) equals the 8 rounds of the round loop bit for bit (state,
    per-round outputs, histograms, ledger, SLO block, provenance; the
    metrics but for ``ingest_drops``, which the chunk does not count);
    the chunk and the round loop timed from the same state; then one
    chunk under the sync debug mode, its synchronizing operations
    counted.  Returns the chunk's K1 launches."""
    c = serve.CFG3
    chunk = serve.STREAM_CHUNK
    t_phase = time.perf_counter()
    dr = draws[r0:r0 + chunk]
    t0 = base + r0 * c["dt_round_ns"]
    stream, launches = _launch_counted(
        ext, lambda: serve.cfg3_stream(st, dr, t0=t0, tele=tele),
        {"ring_window": chunk, "wheel_scan": 0}, "cfg3_stream")
    rounds = serve.cfg3_rounds(st, dr, t0=t0, tele=tele)
    def no_drops(res):
        met = res.metrics.clone()
        met[MET_INGEST_DROPS] = 0
        return res._replace(metrics=met)

    _equal_tuples(no_drops(stream), no_drops(rounds),
                  "cfg3_stream chunk vs the round loop")
    drops = obsdev.metrics_dict(rounds.metrics)["ingest_drops"]
    log(f"[cfg3_stream] one chunk of {chunk} rounds equals the {chunk} "
        f"rounds of the round loop: state, count/guards/slot/phase/cost/lb "
        f"of every round, histograms, ledger, SLO window and provenance "
        f"blocks, and the metrics but ingest_drops (the round loop's "
        f"{drops}); {int(stream.count.sum())} decisions")
    ms_s, ms_r = [], []
    for _ in range(3):
        _, ev, _ = _timed_epoch(
            lambda s: serve.cfg3_stream(s, dr, t0=t0, tele=tele), st)
        ms_s.append(ev)
        _, ev, _ = _timed_epoch(
            lambda s: serve.cfg3_rounds(s, dr, t0=t0, tele=tele), st)
        ms_r.append(ev)
    dec = int(stream.count.sum())
    log(f"[cfg3_stream] on {card}: a chunk of {chunk} rounds "
        f"{[round(x, 3) for x in ms_s]} ms (events), the round loop over "
        f"the same rounds {[round(x, 3) for x in ms_r]} ms; median chunk "
        f"{statistics.median(ms_s):.3f} ms = "
        f"{statistics.median(ms_s) / chunk:.3f} ms a round "
        f"({statistics.median(ms_s) / statistics.median(ms_r):.3f}x the "
        f"round loop), {dec / (statistics.median(ms_s) / 1e3):.1f} "
        f"decisions/s")
    # the detector's control: one read back must be reported
    _, control = _capture_syncs(lambda: int(stream.count.sum()))
    if not control:
        raise AssertionError("cfg3_stream: the sync debug mode reported "
                             "no sync for a read back")
    again, syncs = _capture_syncs(
        lambda: serve.cfg3_stream(st, dr, t0=t0, tele=tele))
    if not torch.equal(again.count, stream.count):
        raise AssertionError("cfg3_stream: a rerun of the chunk differs")
    log(f"[cfg3_stream] synchronizing operations in one chunk under "
        f"torch.cuda.set_sync_debug_mode('warn'): {len(syncs)}"
        + (f": {sorted(set(syncs))}" if syncs else "")
        + f" (the control, one read back, reported {len(control)})")
    log(f"[time] cfg3_stream phase {time.perf_counter() - t_phase:.3f} s")
    return launches["ring_window"]


def phase_cfg4(serve, ext, obsdev, card: str):
    """Bench's ``cfg4`` row (minstop) at full width with telemetry, SLO
    and provenance on: bench's calibration (11 rounds toward a 0.5
    reservation share) and the rounds after it, launch-counted together
    (K1 3 a round, no K2), every timed round checked; a stream chunk of
    2 equals the 2 rounds; timed rounds; bench's derived scalars;
    telemetry on against off over a round.  Returns ``(K1 launches of
    the rounds, of the chunk, ratio, the twin's numpy)``."""
    c = serve.CFG4
    kw = dict(calendar_impl="minstop")
    t_phase = time.perf_counter()
    n_draws = CFG4M_ROUNDS + CFG4M_TIMED + CFG4M_ON_OFF + 1
    (prep, tele0, t_cal, (results, st, tele)), launches = _launch_counted(
        ext, lambda: _prepared_rounds(serve, "cfg4", N_CFG4, n_draws,
                                      CFG4M_ROUNDS, **kw),
        {"ring_window": (12 + CFG4M_ROUNDS) * c["m"], "wheel_scan": 0},
        "cfg4")
    log(_calibration_line("cfg4", prep, t_cal))
    state0, draws, base = prep.state, prep.draws, prep.t0
    twin = _sustained_numpy(prep, results[0])
    decisions = _check_rounds(obsdev, "cfg4", results, tele0, "progress_ok")
    log(f"[cfg4] minstop N={N_CFG4} ring={c['ring']} waves={c['waves']} "
        f"m={c['m']} steps={c['steps']}: {CFG4M_ROUNDS} rounds, decisions "
        f"{decisions}; every batch made progress, each round's metrics "
        f"decision row, ledger ops and SLO ops equal its counts; last "
        f"round's metrics "
        f"{json.dumps(obsdev.metrics_dict(results[-1].metrics))}")
    stream, slaunch = _launch_counted(
        ext, lambda: serve.cfg4_stream(state0, draws[:CFG4M_ROUNDS],
                                       tele=tele0, chunk=CFG4M_ROUNDS,
                                       t0=base, **kw),
        {"ring_window": CFG4M_ROUNDS * c["m"], "wheel_scan": 0},
        "cfg4_stream")
    for f in ("count", "resv_count", "progress_ok", "served",
              "level_count"):
        if not torch.equal(getattr(stream, f),
                           torch.cat([getattr(x, f) for x in results])):
            raise AssertionError(f"cfg4_stream: {f} differs from the "
                                 f"rounds")
    _equal_tuples(stream.state, st, "cfg4_stream state vs the rounds")
    _equal_tuples(stream.tele, tele, "cfg4_stream telemetry vs the rounds")
    log(f"[cfg4_stream] one chunk of {CFG4M_ROUNDS} rounds equals the "
        f"{CFG4M_ROUNDS} rounds: every per-round output, the state, the "
        f"histograms, ledger, SLO window and provenance blocks")
    r = CFG4M_ROUNDS
    ms, host, dec, st, tele = _timed_rounds(serve, "cfg4", st, draws, tele,
                                            r, CFG4M_TIMED, base, **kw)
    r += CFG4M_TIMED
    for i, (a, b, d) in enumerate(zip(ms, host, dec)):
        log(f"[cfg4] minstop round {CFG4M_ROUNDS + i}: {d} decisions in "
            f"{a:.3f} ms (events), {b:.3f} ms (host clock)")
    log(f"[cfg4] on {card}: minstop, telemetry, SLO and provenance on: "
        f"median round {statistics.median(ms):.3f} ms over {CFG4M_TIMED}, "
        f"{sum(dec) / len(dec):.1f} decisions per round; {_rates(dec, ms)};"
        f" K1 3 a round ({launches['ring_window']} over "
        f"{11 + CFG4M_ROUNDS}), K2 0; the measured reservation share of "
        f"the rounds after calibration {_resv_share(obsdev, results)!r}")
    log(f"[cfg4] bench's derived scalars after {r} timed rounds: "
        + _scalars_line(serve, tele, st, base + r * c["dt_round_ns"],
                        c["dt_round_ns"]))
    ratio = _on_off(serve, obsdev, "cfg4", st, draws, tele, r, CFG4M_ON_OFF,
                    "cfg4", base, **kw)
    log(f"[time] cfg4 (minstop) phase {time.perf_counter() - t_phase:.3f} s")
    return launches["ring_window"], slaunch["ring_window"], ratio, twin


def _cpu_child(code: str, out: str) -> subprocess.Popen:
    """``code`` in a child process with CUDA hidden from it, its stderr
    to ``out.err``."""
    with open(out + ".err", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.DEVNULL,
            stderr=err, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def start_cpu_twins(root: str, out: str) -> subprocess.Popen:
    """The CPU twins of phases 17-20 in a child process on four CPU
    threads, with CUDA hidden from it: the whole ``serve_queue`` sequence,
    the pull queue behind ``virtual_server``, both churn rows and the
    supervised churn job of phase 20, started
    as the card begins phase 17; the results go to ``out``
    (``torch.save``)."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {root!r})\n"
        "torch.set_num_threads(4)\n"
        "from dmclock_tpu_torch import serve\n"
        "t0 = time.perf_counter()\n"
        f"run = serve.serve_queue({N_QUEUE}, device='cpu')\n"
        "secs = time.perf_counter() - t0\n"
        f"pull = serve.virtual_server('pull', {N_PUSH}, device='cpu')\n"
        f"churn = serve.churn_row({CHURN_SCENARIO!r}, device='cpu')\n"
        f"storm = serve.churn_row({STORM_SCENARIO!r}, device='cpu')\n"
        "from dmclock_tpu_torch.lifecycle import make_spec\n"
        "from dmclock_tpu_torch.robust import supervisor as TS\n"
        f"spec = make_spec({CHURN_SCENARIO!r}, **{SUP_CHURN_SPEC!r})\n"
        f"sup = TS.run_job(TS.EpochJob(churn=spec, **{SUP_CHURN!r}),\n"
        "                 device='cpu')\n"
        "torch.save(dict(queue=run._asdict(), queue_s=secs, pull=pull,\n"
        "                churn=churn, storm=storm,\n"
        f"                sup_churn=sup._asdict()), {out!r})\n")
    return _cpu_child(code, out)


def start_cpu_sup_twin(root: str, out: str) -> subprocess.Popen:
    """The CPU twin of phase 20's ``supervised_prefix_short`` (bare, at
    full width) in a child process on four CPU threads; its result goes
    to ``out`` (``torch.save``)."""
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {root!r})\n"
        "torch.set_num_threads(4)\n"
        "from dmclock_tpu_torch.robust import supervisor as TS\n"
        f"res = TS.run_job(TS.EpochJob(**{SUP_SHORT!r}), device='cpu')\n"
        f"torch.save(res._asdict(), {out!r})\n")
    return _cpu_child(code, out)


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def collect_cpu_twins(proc: subprocess.Popen, out: str) -> dict:
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    if rc != 0:
        with open(out + ".err") as f:
            raise RuntimeError(f"the CPU twins failed (rc {rc}):\n"
                               f"{f.read()[-4000:]}")
    log(f"[twins] CPU twins in {os.path.basename(out)} collected (waited "
        f"{waited:.3f} s for them)")
    return torch.load(out, weights_only=False)


def phase_queue(serve, ext):
    """The pull queue at full width on the card, launch-counted; held
    against its CPU twin by ``check_queue``."""
    run, _ = _launch_counted(
        ext, lambda: serve.serve_queue(N_QUEUE, device="cuda"),
        {"ring_window": 0, "wheel_scan": 0}, "queue", ingests=True)
    return run


def check_queue(serve, run, card: str, twin) -> None:
    """Everything the card's queue run observed must equal the CPU
    twin's (``twin()``)."""
    cpu = serve.QueueRun(**twin()["queue"])
    for f in ("pulls", "removed", "counters", "ledger", "slo", "rolled",
              "departed", "stats"):
        a, b = getattr(run, f), getattr(cpu, f)
        if f == "stats":
            a, b = dict(a, device_mb=0), dict(b, device_mb=0)
        if a != b:
            raise AssertionError(f"queue: {f} on the card differs from the "
                                 f"CPU run")
    for f, a, b in zip(run.state._fields, run.state, cpu.state):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            raise AssertionError(f"queue: state field {f} on the card "
                                 f"differs from the CPU run")
    st, c, sec = run.stats, run.counters, run.seconds
    g = st["growth"]
    if (g["capacity"], g["ring"]) != (16384, 32) or st["decisions"] <= 0 \
            or min(c["spec_hits"], c["spec_refills"], c["spec_replays"],
                   c["slot_recycles"], st["weight_phase"]) <= 0 \
            or not run.departed:
        raise AssertionError(f"queue: growth {g}, counters {c}, weight "
                             f"phase {st['weight_phase']}")
    batch_s = sec["pull_batch_0"] + sec["pull_batch_1"]
    log(f"[queue] N={N_QUEUE} on {card}: {st['adds']} adds, capacity "
        f"{g['capacity']}, ring {g['ring']}, {g['segments']} ingest "
        f"segments in the bulk load ({c['ingest_segments']} in all); "
        f"{len(run.pulls)} PullReqs ({st['decisions']} decisions), "
        f"counters {json.dumps(c)}; every PullReq, counter, ledger/SLO/"
        f"departed row and the final state equal the CPU run "
        f"({twin()['queue_s']:.3f} s on four CPU threads)")
    log(f"[queue] on {card}, host-paced wall time (each launch reads "
        f"back): bulk load {sec['bulk_load']:.3f} s = "
        f"{st['adds'] / sec['bulk_load']:.1f} adds/s (flush included); "
        f"pull_batch {batch_s:.3f} s for {st['batch_decisions']} = "
        f"{st['batch_decisions'] / batch_s:.1f} decisions/s; stream "
        f"{sec['stream']:.3f} s; pull_request {sec['pull_request']:.3f} s ="
        f" {serve.QUEUE['pulls'] / sec['pull_request']:.1f} pulls/s, spec "
        f"hit share {st['hit_share']:.6f} (1,000 adds interleaved); admin "
        f"{sec['admin']:.3f} s, clean {sec['clean']:.3f} s; the "
        f"weight-phase window (pull_batch of 256 at 1 ms, before every "
        f"queued reservation tag): {st['weight_window']} PullReqs, "
        f"{st['weight_phase']} weight-phase decisions, {sec['weight']:.3f}"
        f" s, equal to the CPU run's; state "
        f"{st['device_mb']:.3f} MB on the card; CPU run stages "
        f"{json.dumps({k: round(v, 6) for k, v in cpu.seconds.items()})}")


def phase_push(serve, ext):
    """The push queue on the card in virtual time, launch-counted; held
    against the pull queue on the CPU by ``check_push``.  Then a
    sched-ahead wakeup on a real thread."""
    import threading

    from dmclock_tpu_torch.core.qos import ClientInfo
    from dmclock_tpu_torch.core.recs import ReqParams
    from dmclock_tpu_torch.core.timebase import sec_to_ns
    from dmclock_tpu_torch.engine.push_queue import TpuPushPriorityQueue

    t0 = time.perf_counter()
    (push, woke), _ = _launch_counted(
        ext, lambda: serve.virtual_server("push", N_PUSH, device="cuda"),
        {"ring_window": 0, "wheel_scan": 0}, "push", ingests=True)
    secs = time.perf_counter() - t0
    handled = []
    q = TpuPushPriorityQueue(
        lambda c: ClientInfo(0, 1, 10), lambda: True,
        lambda c, r, p, cost: handled.append(
            (r, threading.current_thread().name)), device="cuda")
    try:
        now = sec_to_ns(time.time())
        q.add_request("a", 1, ReqParams(), time_ns=now)
        q.add_request("b", 1, ReqParams(), time_ns=now)
        deadline = time.monotonic() + 30
        while len(handled) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        q.shutdown()
    if [r for r, _ in handled] != ["a", "b"] or \
            handled[1][1] != q._sched_thd.name:
        raise AssertionError(f"push: threaded run handled {handled}")
    log(f"[push] threaded: limit 10/s, the second request was dispatched "
        f"by {handled[1][1]!r} after its wakeup; thread joined")
    return push, woke, secs


def check_push(push, woke: int, secs: float, card: str, twin) -> None:
    """The push queue's dispatches on the card must equal the pull
    queue's on the CPU (``twin()``), on the same arrivals."""
    pull, pull_woke = twin()["pull"]
    phases = [sum(1 for d in push if d[3] == p) for p in (0, 1)]
    if push != pull or woke != pull_woke or len(push) != N_PUSH or \
            woke <= 0 or min(phases) <= 0:
        raise AssertionError(f"push: {len(push)} vs {len(pull)} dispatches,"
                             f" equal {push == pull}, wakeups {woke}/"
                             f"{pull_woke}, phases {phases}")
    log(f"[push] N={N_PUSH}, 32 slots, virtual time: {len(push)} "
        f"dispatches (reservation {phases[0]}, priority {phases[1]}), "
        f"{woke} sched-ahead wakeups; the push queue on {card} dispatches "
        f"in the order the pull queue does on the CPU; {secs:.3f} s")


def phase_churn(serve, ext, card: str):
    """Bench's churn row at its accelerator shape on the card,
    launch-counted (K1 once an epoch, no K2) with a span tracer beside
    it; then its static variant and the row with SLO off on the card,
    which must give the same digest and decisions.  Returns ``(row, K1
    launches)``."""
    from dmclock_tpu_torch.obs.spans import SpanTracer

    t_phase = time.perf_counter()
    epochs = serve.CHURN["epochs"]
    tracer = SpanTracer()
    row, launches = _launch_counted(
        ext, lambda: serve.churn_row(CHURN_SCENARIO, tracer=tracer,
                                     device="cuda"),
        {"ring_window": epochs, "wheel_scan": 0}, "churn_flash_crowd")
    boost = row["boost"]
    if boost is None or boost["http"] is not True \
            or not boost["share_gain"] > 1:
        raise AssertionError(f"churn: the live PUT failed: {boost}")
    span_s = {f"{name}|{cat}": v[1] / 1e9
              for (name, cat), v in tracer.name_stats().items()}
    bound_s = span_s.get("lifecycle.boundary|host_prep", 0.0)
    wait_s = span_s.get("guarded.device_wait|device_compute", 0.0)
    log(f"[churn] {CHURN_SCENARIO} on {card}: {row['decisions']} "
        f"decisions in {epochs} epochs, wall {row['wall_s']:.3f} s, "
        f"{row['dps']:.1f} decisions/s, {epochs / row['wall_s']:.2f} "
        f"epochs/s; peak clients {row['peak_clients']}, live "
        f"{row['live_clients']}, capacity {row['capacity']}, grows "
        f"{row['grows']}, compactions {row['compactions']}, evictions "
        f"{row['evictions']}, slot recycles {row['slot_recycles']}; "
        f"boost.http {boost['http']}, client {boost['client']} weight "
        f"{boost['weight_before']} -> {boost['weight_after']}, "
        f"share_gain {boost['share_gain']:.6f}; SLO violations "
        f"{row['slo_violations_total']}, windows closed "
        f"{row['slo_windows_closed']}; tardiness p99 "
        f"{row['tardiness_p99_ns']} ns")
    log(f"[churn] spans: lifecycle boundaries {bound_s:.6f} s = "
        f"{bound_s / row['wall_s']:.4f} of the row's wall; guarded "
        f"device waits {wait_s:.6f} s; every span total (s): "
        f"{json.dumps(span_s, sort_keys=True)}")
    static = serve.churn_row(CHURN_SCENARIO, static=True, device="cuda")
    if (static["digest"], static["decisions"]) != (row["digest"],
                                                   row["decisions"]):
        raise AssertionError(
            f"churn: the static variant differs: digest "
            f"{static['digest']} vs {row['digest']}, decisions "
            f"{static['decisions']} vs {row['decisions']}")
    log(f"[churn] static variant on the card: digest {row['digest']}, "
        f"{row['decisions']} decisions, equal to the dynamic run's "
        f"(static wall {static['wall_s']:.3f} s)")
    # the SLO windows and the evaluator only observe: the decisions are
    # the same without them, and the wall difference is their cost
    off = serve.churn_row(CHURN_SCENARIO, slo=False, device="cuda")
    if (off["digest"], off["decisions"]) != (row["digest"],
                                             row["decisions"]):
        raise AssertionError("churn: SLO off changed the decisions")
    log(f"[churn] SLO off on the card: the same digest and decisions, "
        f"wall {off['wall_s']:.3f} s against {row['wall_s']:.3f} s on "
        f"({row['wall_s'] / off['wall_s']:.3f}x)")
    log(f"[time] churn phase {time.perf_counter() - t_phase:.3f} s")
    return row, launches["ring_window"]


def phase_churn_storm(serve, ext, card: str):
    """The churn row on ``churn_storm`` at the same shape, launch-counted
    with a span tracer beside it for the boundaries' wall share:
    generations of clients register, idle out and are evicted, and the
    slots are compacted, all on the card at full width.  Its static
    variant on the card must give the same digest and decisions.
    Returns ``(row, K1 launches)``."""
    from dmclock_tpu_torch.obs.spans import SpanTracer

    t_phase = time.perf_counter()
    epochs = serve.CHURN["epochs"]
    tracer = SpanTracer()
    row, launches = _launch_counted(
        ext, lambda: serve.churn_row(STORM_SCENARIO, tracer=tracer,
                                     device="cuda"),
        {"ring_window": epochs, "wheel_scan": 0}, "churn_storm")
    if row["boost"] is None or row["boost"]["http"] is not True:
        raise AssertionError(f"churn_storm: the live PUT did not go over "
                             f"HTTP: {row['boost']}")
    if not (row["evictions"] > 0 and row["compactions"] > 0):
        raise AssertionError(
            f"churn_storm evicted {row['evictions']} and compacted "
            f"{row['compactions']} times; the run must do both")
    log(f"[storm] {STORM_SCENARIO} on {card}: {row['decisions']} decisions "
        f"in {epochs} epochs, wall {row['wall_s']:.3f} s, "
        f"{row['dps']:.1f} decisions/s; peak clients "
        f"{row['peak_clients']}, live {row['live_clients']}, capacity "
        f"{row['capacity']}, grows {row['grows']}, compactions "
        f"{row['compactions']}, evictions {row['evictions']}, slot "
        f"recycles {row['slot_recycles']}")
    stats = tracer.name_stats()
    bound_s = stats[("lifecycle.boundary", "host_prep")][1] / 1e9
    log(f"[storm] spans: lifecycle boundaries {bound_s:.6f} s = "
        f"{bound_s / row['wall_s']:.4f} of the row's wall")
    static = serve.churn_row(STORM_SCENARIO, static=True, device="cuda")
    if (static["digest"], static["decisions"]) != (row["digest"],
                                                   row["decisions"]):
        raise AssertionError(
            f"churn_storm: the static variant differs: digest "
            f"{static['digest']} vs {row['digest']}, decisions "
            f"{static['decisions']} vs {row['decisions']}")
    log(f"[storm] static variant on the card: digest {row['digest']}, "
        f"{row['decisions']} decisions, equal to the dynamic run's")
    log(f"[time] churn_storm phase {time.perf_counter() - t_phase:.3f} s")
    return row, launches["ring_window"]


def check_churn(row: dict, card: str, twin, key: str = "churn") -> None:
    """The card's churn row against the CPU twin's (``twin()[key]``):
    every key but the wall clocks (decisions, snapshot counters, the
    boost record, the conformance table, tardiness, the SLO block, the
    histogram block, the digest, the capacity record but for the
    roofline's peaks, which are the card's here and nominal in the twin,
    whose process sees no card, and the captures' wall; its
    ``bound_class`` and ``retraces`` are compared)."""
    want = twin()[key]
    for k in sorted(set(want) | set(row)):
        if k in ("wall_s", "dps", "roofline", "compile_ms_total"):
            continue
        if row.get(k) != want.get(k):
            raise AssertionError(f"{key}: {k} on the card differs from "
                                 f"the CPU: {str(row.get(k))[:300]} vs "
                                 f"{str(want.get(k))[:300]}")
    log(f"[{key}] equal to the CPU twin on every output but the wall "
        f"clocks and the roofline's peaks ({len(want) - 4} keys; CPU wall "
        f"{want['wall_s']:.3f} s, "
        f"card {row['wall_s']:.3f} s on {card})")


# ----------------------------------------------------------------------
# phase 20: supervised epoch jobs
# ----------------------------------------------------------------------

@contextlib.contextmanager
def _stderr_to(path: str):
    """fd 2, this process's and its children's, to ``path``."""
    sys.stderr.flush()
    saved = os.dup(2)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)
    os.close(fd)
    try:
        yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def _sup_run(ext, what: str, fn, k2: bool = False):
    """``fn()`` launch-counted (K1 must launch; K2 exactly when ``k2``)
    and wall-timed: ``(result, launches, wall s)``."""
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launched(ext)
    if launches["ring_window"] <= 0 or \
            (launches["wheel_scan"] > 0) != k2:
        raise AssertionError(f"{what} launched {launches}")
    log(f"[{what}] {res.decisions} decisions, {res.epochs} epochs, "
        f"restarts {res.restarts}, resumed from "
        f"{os.path.basename(res.resumed_from or '-')}, wall {wall:.3f} s, "
        f"kernel launches {launches}")
    return res, launches, wall


def _same_result(a, b, what: str, skip=("restarts", "resumed_from")):
    """Every field of two supervised results, arrays by dtype and
    value."""
    for f in a._fields:
        if f in skip:
            continue
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            same = (x is None) == (y is None) and (x is None or (
                np.asarray(x).dtype == np.asarray(y).dtype
                and np.array_equal(x, y)))
        else:
            same = x == y
        if not same:
            raise AssertionError(f"{what}: {f} differs: {str(x)[:200]} "
                                 f"vs {str(y)[:200]}")


def _spans(path: str) -> list:
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def _span_s(rows, name: str) -> float:
    return sum(r["dur"] for r in rows if r["name"] == name) / 1e9


def _replay_s(rows, kill_epoch: int):
    """The resumed incarnation's restore (its ``supervisor.resume``
    span) and the epochs it re-ran up to the one the kill ended
    (``supervisor.epoch`` spans after the resume)."""
    i = max(j for j, r in enumerate(rows) if r["name"] == "supervisor.resume")
    after = rows[i + 1:]
    epochs = [r for r in after if r["name"] == "supervisor.epoch"
              and r["args"]["epoch"] <= kill_epoch]
    return (rows[i]["dur"] / 1e9, sum(r["dur"] for r in epochs) / 1e9,
            [r["args"]["epoch"] for r in epochs])


def _ckpt_bytes(wd: str) -> int:
    paths = [os.path.join(wd, "ckpt", f)
             for f in os.listdir(os.path.join(wd, "ckpt"))
             if f.startswith("ckpt-") and not f.endswith(".sha256")]
    return max(os.path.getsize(p) for p in paths)


def phase_supervised(ext, card: str, tmp: str):
    """Phase 20: supervised jobs at full width (``robust.supervisor``).
    Returns ``({path: K1 launches}, {path: K2 launches}, the supervised
    churn result)`` over the in-process runs."""
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    t_phase = time.perf_counter()
    by_path = {}

    def job(kw, **extra):
        return TS.EpochJob(**dict(kw, **extra))

    def wd(name):
        path = os.path.join(tmp, name)
        os.makedirs(path)
        return path

    # supervised_prefix: bare, zero plan, sampled plan, stream
    spans0 = os.path.join(tmp, "spans_zero.jsonl")
    ref, l_ref, w_ref = _sup_run(
        ext, "supervised_prefix bare", lambda: TS.run_job(
            job(SUP_PREFIX), device="cuda"))
    # every epoch commits as many decisions (the backlog outlasts the
    # run), which places the spawn kill below in a known epoch
    per = ref.decisions // SUP_PREFIX["epochs"]
    if per <= 0 or ref.decisions != SUP_PREFIX["epochs"] * per \
            or ref.metrics[MET_LADDER_STEPS] != 0:
        raise AssertionError(f"supervised_prefix: {ref.decisions} "
                             f"decisions in {SUP_PREFIX['epochs']} epochs, "
                             f"ladder steps {ref.metrics[MET_LADDER_STEPS]}")
    st_bytes = sum(t.numel() * t.element_size() for t in
                   TS._job_state(job(SUP_PREFIX), "cuda"))
    w0 = wd("zero")
    zero, l_zero, w_zero = _sup_run(
        ext, "supervised_prefix zero plan", lambda: TS.run_supervised(
            job(SUP_PREFIX, span_log=spans0), w0, TH.zero_host_plan(),
            device="cuda"))
    _same_result(zero, ref, "supervised_prefix zero plan")
    if not np.array_equal(zero.metrics, ref.metrics) or zero.restarts:
        raise AssertionError("supervised_prefix: the zero plan moved the "
                             "metrics or restarted")
    rows = _spans(spans0)
    save_s = _span_s(rows, "supervisor.checkpoint_save")
    log(f"[supervised_prefix] state {st_bytes / 1e9:.4f} GB, snapshot "
        f"{_ckpt_bytes(w0) / 1e9:.4f} GB on disk, keep "
        f"{SUP_PREFIX.get('keep', 4)}; zero plan bit-identical to the bare "
        f"run (metrics included); checkpoint saves "
        f"{save_s:.3f} s = {save_s / w_zero:.4f} of the supervised wall "
        f"({w_zero:.3f} s; bare {w_ref:.3f} s, "
        f"{w_zero / w_ref:.3f}x) over "
        f"{sum(r['name'] == 'supervisor.checkpoint_save' for r in rows)} "
        f"saves on {card}")
    shutil.rmtree(w0)
    plan = TH.sample_host_plan(20, epochs=SUP_PREFIX["epochs"],
                               est_decisions=ref.decisions, kills=2,
                               save_kills=1, corrupt_saves=1)
    w1 = wd("plan")
    res, l_plan, w_plan = _sup_run(
        ext, "supervised_prefix sampled plan", lambda: TS.run_supervised(
            job(SUP_PREFIX), w1, plan, device="cuda"))
    TS.assert_crash_equivalent(res, ref)
    if res.restarts != TH.host_plan_events(plan)["restarts"]:
        raise AssertionError(f"supervised_prefix: {res.restarts} restarts "
                             f"under {TH.describe_host(plan)}")
    log(f"[supervised_prefix] plan {TH.describe_host(plan)} {tuple(plan)}: "
        f"crash-equivalent, {res.restarts} restarts, "
        f"{res.metrics[MET_SUPERVISOR_RESUMES]} resumes, wall "
        f"{w_plan:.3f} s")
    shutil.rmtree(w1)
    stream, l_stream, w_stream = _sup_run(
        ext, "supervised_prefix stream", lambda: TS.run_job(
            job(SUP_PREFIX, engine_loop="stream"), device="cuda"))
    TS.assert_crash_equivalent(stream, ref)
    log(f"[supervised_prefix] stream loop: digest {stream.digest[:16]} "
        f"equal to the round loop's, state and planes too (wall "
        f"{w_stream:.3f} s against {w_ref:.3f} s)")
    by_path.update(supervised_prefix=l_ref["ring_window"],
                   supervised_prefix_zero=l_zero["ring_window"],
                   supervised_prefix_plan=l_plan["ring_window"],
                   supervised_prefix_stream=l_stream["ring_window"])

    # supervised_prefix_short, the bare run above (held against its CPU
    # twin after the phase), then supervised_spawn: its child SIGKILLed
    # at half
    short, w_short = ref, w_ref
    spans1 = os.path.join(tmp, "spans_spawn.jsonl")
    w2 = wd("spawn")
    # just past half: the child dies after epoch 1, before its snapshot,
    # and the next resumes from epoch 0's
    kill = short.decisions // 2 + 1
    t0 = time.perf_counter()
    sp = TS.run_supervised(job(SUP_SHORT, span_log=spans1), w2,
                           TH.HostFaultPlan(kill_at_decisions=(kill,)),
                           mode="spawn", device="cuda")
    w_spawn = time.perf_counter() - t0
    TS.assert_crash_equivalent(sp, short)
    if sp.restarts != 1 or not sp.resumed_from.endswith("ckpt-00000001") \
            or sp.metrics[MET_SUPERVISOR_RESUMES] != 1:
        raise AssertionError(f"supervised_spawn: restarts {sp.restarts}, "
                             f"resumed from {sp.resumed_from}")
    kill_epoch = -(-kill // per) - 1
    rows = _spans(spans1)
    starts = [r["args"]["start_s"] for r in rows
              if r["name"] == "supervisor.child_start"]
    restore_s, replay_s, replayed = _replay_s(rows, kill_epoch)
    log(f"[supervised_spawn] child SIGKILLed at {kill} decisions (after "
        f"epoch {kill_epoch}), resumed from "
        f"{os.path.basename(sp.resumed_from)}: crash-equivalent; wall "
        f"{w_spawn:.3f} s (the same job bare in process {w_short:.3f} s); "
        f"the children's starts (spawn to initial state) "
        f"{', '.join(f'{x:.3f}' for x in starts)} s; the resumed child's "
        f"restore {restore_s:.3f} s and replay of epochs {replayed} "
        f"{replay_s:.3f} s (span tracer)")
    log("[supervised_spawn] the children's kernel launches are not "
        "counted: LAUNCHES is per process and the parent cannot see them")
    shutil.rmtree(w2)

    # supervised_ladder: tag32 -> tag64 once, kept across a resume
    lref, l_lad, w_lad = _sup_run(
        ext, "supervised_ladder bare", lambda: TS.run_job(
            job(SUP_LADDER), device="cuda"))
    want_step = [{"knob": "tag_width", "from": 32, "to": 64}]
    if lref.metrics[MET_LADDER_STEPS] != 1 or \
            [{k: s[k] for k in ("knob", "from", "to")}
             for s in lref.ladder_steps] != want_step:
        raise AssertionError(f"supervised_ladder: steps "
                             f"{lref.ladder_steps}")
    w3 = wd("ladder")
    # killed after epoch 1, before its snapshot: the resume restores
    # epoch 0's, which holds the step
    lres, l_lad2, _ = _sup_run(
        ext, "supervised_ladder killed", lambda: TS.run_supervised(
            job(SUP_LADDER), w3, TH.HostFaultPlan(
                kill_at_decisions=(3 * lref.decisions // 4,)),
            device="cuda"))
    TS.assert_crash_equivalent(lres, lref)
    if lres.restarts != 1 or lres.ladder_steps != [
            dict(want_step[0], reason="resumed")] \
            or not lres.resumed_from.endswith("ckpt-00000001"):
        raise AssertionError(f"supervised_ladder: resumed run "
                             f"{lres.restarts} restarts, steps "
                             f"{lres.ladder_steps}")
    log(f"[supervised_ladder] stepped tag32 -> tag64 once "
        f"({lref.ladder_steps[0]['reason']}); the killed run resumed at "
        f"tag64 and is crash-equivalent")
    shutil.rmtree(w3)
    by_path.update(supervised_ladder=l_lad["ring_window"],
                   supervised_ladder_killed=l_lad2["ring_window"])

    # phase 29 (b)'s guarded.epoch at the wheel jobs' shape, held first:
    # the jobs below replay its capture
    gk1, gk2, _ = held_guarded_epoch(ext, "wheel")
    by_path.update(gk1)

    # supervised_wheel: K2 carried through a resume
    wref, l_wh, _ = _sup_run(
        ext, "supervised_wheel bare", lambda: TS.run_job(
            job(SUP_WHEEL), device="cuda"), k2=True)
    w4 = wd("wheel")
    wres, l_wh2, _ = _sup_run(
        ext, "supervised_wheel killed", lambda: TS.run_supervised(
            job(SUP_WHEEL), w4,
            TH.HostFaultPlan(kill_at_save=((0, "done"),)), device="cuda"),
        k2=True)
    TS.assert_crash_equivalent(wres, wref)
    if wres.restarts != 1 or \
            not wres.resumed_from.endswith("ckpt-00000001"):
        raise AssertionError(f"supervised_wheel: {wres.restarts} restarts "
                             f"from {wres.resumed_from}")
    log("[supervised_wheel] killed after epoch 1's snapshot, resumed from "
        "ckpt-00000001: crash-equivalent")
    shutil.rmtree(w4)
    by_path.update(supervised_wheel=l_wh["ring_window"],
                   supervised_wheel_killed=l_wh2["ring_window"])
    k2 = dict(supervised_wheel=l_wh["wheel_scan"],
              supervised_wheel_killed=l_wh2["wheel_scan"], **gk2)

    # supervised_churn: the churn row's shape as a stream job
    from dmclock_tpu_torch.lifecycle import make_spec
    spec = make_spec(CHURN_SCENARIO, **SUP_CHURN_SPEC)
    cref, l_ch, w_ch = _sup_run(
        ext, "supervised_churn bare", lambda: TS.run_job(
            job(SUP_CHURN, churn=spec), device="cuda"))
    w5 = wd("churn")
    cres, l_ch2, w_ch2 = _sup_run(
        ext, "supervised_churn killed", lambda: TS.run_supervised(
            job(SUP_CHURN, churn=spec), w5,
            TH.HostFaultPlan(kill_at_decisions=(cref.decisions // 2,)),
            device="cuda"))
    TS.assert_crash_equivalent(cres, cref)
    if cres.restarts != 1:
        raise AssertionError(f"supervised_churn: {cres.restarts} restarts")
    log(f"[supervised_churn] {CHURN_SCENARIO} stream job: lifecycle "
        f"{cref.lifecycle}; killed at half and crash-equivalent (wall "
        f"{w_ch2:.3f} s against {w_ch:.3f} s bare)")
    shutil.rmtree(w5)
    by_path.update(supervised_churn=l_ch["ring_window"],
                   supervised_churn_killed=l_ch2["ring_window"])
    log(f"[time] supervised phase {time.perf_counter() - t_phase:.3f} s")
    return by_path, k2, cref, short


def check_supervised(res, card: str, twin, what: str) -> None:
    """A supervised job on the card against its CPU twin's run."""
    from dmclock_tpu_torch.robust import supervisor as TS

    _same_result(res, TS.SupervisedResult(**twin),
                 f"{what} against the CPU twin")
    log(f"[{what}] equal to the CPU twin on every field (digest "
        f"{res.digest[:16]}, state digest {res.state_digest[:16]}, "
        f"{res.decisions} decisions) on {card}")


# ----------------------------------------------------------------------
# phase 21: the simulators
# ----------------------------------------------------------------------

DS_N = 100_000           # the device sim headline's clients (8 servers)
DS_TWIN_SLICES = 2       # slices held against the CPU twin, and per
#                          calendar run
# (mode, config, client_total_ops): each config cut in client_total_ops
# alone (2,000 and 1,000 in the files) to fit the script's time: the
# card's serial engine takes 10-35 ms a decision here (PERF.md section 5)
SIM_RUNS = (("pull", "configs/dmc_sim_example.conf", 50),
            ("push", "configs/dmc_sim_8_6.conf", 50))


def _cut_conf(root: str, conf: str, total_ops: int, tmp: str) -> str:
    """``conf`` with every ``client_total_ops`` set to ``total_ops`` and
    nothing else changed, written under ``tmp``."""
    with open(os.path.join(root, conf)) as f:
        lines = f.read().splitlines()
    out = [f"client_total_ops = {total_ops}"
           if ln.split("=")[0].strip() == "client_total_ops" else ln
           for ln in lines]
    if out == lines:
        raise ValueError(f"{conf} sets no client_total_ops")
    path = os.path.join(tmp, f"cut_{total_ops}_" + os.path.basename(conf))
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path


def start_cpu_sim_twins(root: str, tmp: str) -> dict:
    """Phase 21's CPU twins, with CUDA hidden from them: the device sim
    headline's first ``DS_TWIN_SLICES`` slices at full width on four
    threads (its fields to ``ds_twin.pt``), and ``dmc_sim`` on each of
    ``SIM_RUNS`` on one thread (its decision trace and stdout beside
    it).  Returns ``{name: (process, output path)}``."""
    out = os.path.join(tmp, "ds_twin.pt")
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {root!r})\n"
        "torch.set_num_threads(4)\n"
        "from dmclock_tpu_torch.sim import device_sim as DS\n"
        f"_, sim, spec = DS.headline_setup({DS_N}, device='cpu')\n"
        f"sim = DS.device_sim_step(sim, spec, {DS_TWIN_SLICES})\n"
        f"torch.save(DS.device_sim_to_numpy(sim), {out!r})\n")
    procs = {"device_sim": (_cpu_child(code, out), out)}
    for mode, conf, total_ops in SIM_RUNS:
        trace = os.path.join(tmp, f"dmc_sim_{mode}_cpu.jsonl")
        with open(trace + ".out", "w") as so, \
                open(trace + ".err", "w") as se:
            procs[f"dmc_sim_{mode}"] = (subprocess.Popen(
                [sys.executable, "-m", "dmclock_tpu_torch.sim.dmc_sim",
                 "-c", _cut_conf(root, conf, total_ops, tmp),
                 "--server-mode", mode,
                 "--device", "cpu", "--trace", trace, "--ledger-check",
                 "--slo-check"], cwd=root, stdout=so, stderr=se,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                         OMP_NUM_THREADS="1")), trace)
    return procs


def _collect(proc: subprocess.Popen, out: str, what: str) -> float:
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    if rc != 0:
        with open(out + ".err") as f:
            raise RuntimeError(f"the CPU twin {what} failed (rc {rc}):\n"
                               f"{f.read()[-4000:]}")
    return time.perf_counter() - t0


def _sim_numpy_equal(a: dict, b: dict, what: str, path: str = "sim"):
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: {path} fields {sorted(a)} vs "
                             f"{sorted(b)}")
    for k in a:
        if isinstance(a[k], dict):
            _sim_numpy_equal(a[k], b[k], what, f"{path}.{k}")
        elif a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {path}.{k} differs "
                                 f"({a[k].dtype} vs {b[k].dtype})")


def _nbytes(sim) -> int:
    return sum(t.numel() * t.element_size()
               for part in sim for t in (part if isinstance(part, tuple)
                                         else (part,)))


def phase_device_sim(ext, fp, card: str):
    """The device sim at the headline's full width on the card: the
    prefix run's first slices launch-counted (K1 once a prefix batch at
    w=1, no K2) and kept for the twin and for phase 29 (d), which holds
    the minstop and wheel runs to it; K1 at w=1 and w=8 on that state
    against its plain version; then the headline timed op by op and
    through the program.  Returns ``(prefix fields, launches by path,
    headline rows)``."""
    from dmclock_tpu_torch.sim import device_sim as DS

    t_phase = time.perf_counter()
    by_path = {}

    _, sim, spec = DS.headline_setup(DS_N, device="cuda")
    counts = DS.StepCounts()
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    sim = DS.device_sim_step(sim, spec, DS_TWIN_SLICES, counts=counts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launched(ext)
    log(f"[device_sim] {DS_TWIN_SLICES} slices in {secs:.3f} s: "
        f"{counts.prefix_batches} prefix batches, {counts.read_backs} read "
        f"backs; kernel launches {launches}")
    if launches != {"ring_window": counts.prefix_batches, "wheel_scan": 0}:
        raise AssertionError(f"device_sim launched {launches}, want K1 "
                             f"{counts.prefix_batches}, no K2")
    by_path["device_sim"] = launches
    DS.check_guard_trips(sim)
    prefix = DS.device_sim_to_numpy(sim)
    ops = int(prefix["served_resv"].sum() + prefix["served_prop"].sum())
    log(f"[device_sim] headline on {card}: {DS_N} clients, "
        f"{spec.n_servers} servers, ring {sim.engine.ring_capacity}, "
        f"q {spec.q_per_slice} a slice of {spec.slice_ns} ns, "
        f"{spec.max_sends} sends a client a slice at most; state "
        f"{_nbytes(sim) / 1e9:.4f} GB on the card; {ops} ops in "
        f"{DS_TWIN_SLICES} slices, 0 guard trips")
    eng = DS.server_view(sim.engine, 0)
    for w in (1, 8):
        ka, kc = fp.ring_window_rows(eng.q_arrival, eng.q_cost,
                                     eng.q_head, w)
        pa = fp._ring_window_torch(eng.q_arrival, eng.q_head, w)
        pc = fp._ring_window_torch(eng.q_cost, eng.q_head, w)
        torch.cuda.synchronize()
        if not (torch.equal(ka, pa) and torch.equal(kc, pc)):
            raise AssertionError(f"K1 on the device sim state (w={w}) "
                                 "differs from its plain version")
    log("[device_sim] K1 at (100000, 64, 1) and (100000, 64, 8) on "
        "server 0's state after the slices: bit-identical to its plain "
        "version")
    del sim, eng, ka, kc, pa, pc
    # the headline op by op, then through the program, in one call
    rows = {}
    for what, program in (("device_sim_headline_eager", False),
                          ("device_sim_headline", True)):
        torch.cuda.synchronize()
        ext.reset_launches()
        row = DS.device_sim_headline(DS_N, device="cuda", program=program)
        torch.cuda.synchronize()
        by_path[what] = launched(ext)
        if row["guard_trips"] != 0:
            raise AssertionError(f"{what}: {row['guard_trips']} guard "
                                 "trips")
        if by_path[what] != {"ring_window": row["counts"]["prefix_batches"],
                             "wheel_scan": 0}:
            raise AssertionError(f"{what}: launched {by_path[what]}, "
                                 f"{row['counts']}")
        how = f"the program, prefix block {row['block']}" if program \
            else "op by op"
        log(f"[{what}] on {card} ({how}): "
            f"{row['ops_per_sec']:.1f} ops per wall second (differenced "
            f"over chains of {DS.HEADLINE_LO} and {DS.HEADLINE_HI} "
            f"launches of {DS.HEADLINE_SLICES} slices), "
            f"{row['ms_per_slice']:.3f} ms a slice, "
            f"{row['ops_per_slice']:.1f} ops a slice, "
            f"{row['read_backs_per_slice']:.3f} read backs a slice, "
            f"{row['prefix_batches_per_slice']:.3f} prefix batches "
            f"launched and {row['prefix_live_per_slice']:.3f} in a "
            f"server's loop a slice, K1 "
            f"{by_path[what]['ring_window'] / row['slices']:.3f} launches "
            f"a slice; weight 3:1 ratio {row['weight_ratio_3_1']:.6f}; "
            f"{row['total_ops']} ops in {row['virtual_s']:.6f} virtual s; "
            f"guard trips {row['guard_trips']}")
        rows[what] = row
        release_programs()
    a, b = rows["device_sim_headline_eager"], rows["device_sim_headline"]
    log(f"[device_sim_headline] on {card}: the program over op by op in "
        f"one call: ms a slice {b['ms_per_slice']:.3f} / "
        f"{a['ms_per_slice']:.3f} = "
        f"{b['ms_per_slice'] / a['ms_per_slice']:.4f}, ops per wall "
        f"second {b['ops_per_sec']:.1f} / {a['ops_per_sec']:.1f} = "
        f"{b['ops_per_sec'] / a['ops_per_sec']:.4f}, read backs a slice "
        f"{b['read_backs_per_slice']:.3f} / "
        f"{a['read_backs_per_slice']:.3f}")
    log(f"[time] device_sim phase {time.perf_counter() - t_phase:.3f} s")
    return prefix, by_path, rows


def phase_dmc_sim(ext, card: str, tmp: str) -> dict:
    """``dmc_sim`` on the card, in process: each of ``SIM_RUNS`` (its
    config cut in ``client_total_ops``) with ``--model dmclock-torch
    --ledger-check --slo-check`` and its decision trace; prints the
    reports, the wall and decisions per second.  Returns ``{mode:
    (trace path, launches)}``."""
    import contextlib
    import io

    from dmclock_tpu_torch.sim import dmc_sim

    out = {}
    root = os.path.dirname(os.path.abspath(__file__))
    for mode, conf, total_ops in SIM_RUNS:
        trace = os.path.join(tmp, f"dmc_sim_{mode}_card.jsonl")
        buf = io.StringIO()
        torch.cuda.synchronize()
        ext.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = dmc_sim.main(["-c", _cut_conf(root, conf, total_ops,
                                               tmp),
                               "--model", "dmclock-torch",
                               "--server-mode", mode, "--device", "cuda",
                               "--trace", trace, "--ledger-check",
                               "--slo-check"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"[dmc_sim {mode}] {line}")
        if rc != 0:
            raise AssertionError(f"dmc_sim {mode} on {conf}: rc {rc}")
        with open(trace) as f:
            rows = sum(1 for _ in f)
        launches = launched(ext)
        log(f"[dmc_sim {mode}] {conf} (client_total_ops {total_ops}) on "
            f"{card}: {rows} decisions in "
            f"{secs:.3f} s wall, {rows / secs:.3f} decisions/s; kernel "
            f"launches {launches} (the serial engine and the ingest: no "
            f"K1 or K2, K3 each flush)")
        if any(k3_taken(launches, f"dmc_sim_{mode}").values()):
            raise AssertionError(f"dmc_sim {mode} launched {launches}")
        out[mode] = (trace, launches)
    return out


def phase_oracle_trace(dmc: dict, card: str, tmp: str) -> None:
    """``dmc_sim`` with ``--model dmclock-delayed`` (the host oracle) on
    the pull run's cut config: its trace equals the card's
    ``dmclock-torch`` trace op for op (time, server, client, phase,
    cost; the oracle's rows also carry its tags), and so each client's
    phase split."""
    import contextlib
    import io

    from dmclock_tpu_torch.sim import dmc_sim

    root = os.path.dirname(os.path.abspath(__file__))
    mode, conf, total_ops = SIM_RUNS[0]
    trace = os.path.join(tmp, "dmc_sim_oracle.jsonl")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = dmc_sim.main(["-c", _cut_conf(root, conf, total_ops, tmp),
                           "--model", "dmclock-delayed", "--server-mode",
                           mode, "--device", "cpu", "--trace", trace])
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"dmc_sim dmclock-delayed: rc {rc}")

    def rows(path):
        with open(path) as f:
            out = [json.loads(ln) for ln in f]
        return [(r["t"], r["server"], r["client"], r["phase"], r["cost"])
                for r in out], sum(r["tag"] is not None for r in out)

    want, tagged = rows(trace)
    got, _ = rows(dmc[mode][0])
    if got != want or not want:
        diff = next((i for i, (a, b) in enumerate(zip(got, want))
                     if a != b), min(len(got), len(want)))
        raise AssertionError(f"dmclock-torch on the card diverges from "
                             f"the oracle at op {diff} of {len(want)}")
    split = {}
    for _, _, client, phase, _ in want:
        split.setdefault(client, {"reservation": 0, "priority": 0})[
            phase] += 1
    log(f"[dmc_sim oracle] {conf} (client_total_ops {total_ops}): the "
        f"host oracle (dmclock-delayed, {secs:.3f} s, {tagged} rows with "
        f"their tags) and dmclock-torch on {card} serve the same "
        f"{len(want)} ops op for op; each client's phase split "
        f"{json.dumps(split)}")


def check_sim_twins(procs: dict, prefix: dict, dmc: dict,
                    card: str) -> None:
    """Phase 21's card runs against their CPU twins: the device sim's
    every field, and each dmc_sim trace byte for byte."""
    proc, path = procs["device_sim"]
    waited = _collect(proc, path, "device_sim")
    twin = torch.load(path, weights_only=False)
    _sim_numpy_equal(prefix, twin, "device_sim vs the CPU twin")
    log(f"[device_sim] the first {DS_TWIN_SLICES} slices equal the CPU "
        f"twin on every DeviceSim field (waited {waited:.3f} s for it)")
    for mode, conf, _ in SIM_RUNS:
        proc, trace = procs[f"dmc_sim_{mode}"]
        waited = _collect(proc, trace, f"dmc_sim {mode}")
        with open(trace, "rb") as f:
            want = f.read()
        with open(dmc[mode][0], "rb") as f:
            got = f.read()
        if got != want:
            raise AssertionError(f"dmc_sim {mode} on {conf}: the card's "
                                 "trace differs from the CPU twin's")
        with open(trace + ".out") as f:
            wall = [ln for ln in f if "wall:" in ln]
        log(f"[dmc_sim {mode}] the card's trace equals the CPU twin's, "
            f"{want.count(b'{')} rows byte for byte (the twin's "
            f"{wall[0].strip() if wall else 'wall not printed'}; waited "
            f"{waited:.3f} s for it) on {card}")


# ----------------------------------------------------------------------
# phase 22: the multi-server mesh
# ----------------------------------------------------------------------

MESH_SHARDS = 8          # bench's mesh row: 100,000 clients over 8 shards
MESH_FAULT_SPEC = "seed=7,p_dropout=0.05,mean_outage_steps=2,p_dup=0.1"
MESH_S1_EPOCHS = 2       # the S=1 identity chunk at 100,000 clients
# the wheel on the mesh: 2 shards x 10,000 clients, 2 epochs of m=2
# calendar batches of 4 steps on 4 ladder levels
MESH_WHEEL = dict(n=10_000, shards=2, epochs=2, m=2, k=4, levels=4)
# the cluster dry run at its width (8 servers x 10,000 clients), cut in
# depth: 32 decisions a step (of 1,024), 2 closed-loop rounds (2 + 6)
# and 1 drain round (4); its QoS assertions need the full depth and run
# in the CPU tests
MULTICHIP_CUT = dict(n_servers=8, n_clients=10_000, decisions_per_step=32,
                     warmup=1, rounds=1, drain_rounds=1, check_qos=False)
OUTAGE = dict(n_servers=8, n_clients=10_000, steps=3, decisions_per_step=32)


def chunk_numpy(out) -> dict:
    """A MeshChunk (or StreamChunk) as a flat dict of host numpy."""
    host = {}
    for f in out._fields:
        v = getattr(out, f)
        if isinstance(v, dict):
            host.update({f"{f}.{k}": x.cpu().numpy() for k, x in v.items()})
        elif isinstance(v, tuple):
            host.update({f"{f}.{k}": x.cpu().numpy()
                         for k, x in zip(v._fields, v)})
        elif v is not None:
            host[f] = v.cpu().numpy()
    return host


def mesh_chunk_run(device, job, shards: int, epochs: int, devices=None,
                   **cfg):
    """One mesh chunk of ``shards`` copies of ``job``'s preloaded state
    from epoch 0 with the mesh row's draws (``serve.mesh_start``,
    ``serve.mesh_draws`` from PCG64(29)); returns the MeshChunk.
    ``devices`` lays the shards out in device groups (``device`` is then
    the first group's)."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.parallel import mesh as TM

    mesh = TM.make_mesh(shards, device) if devices is None \
        else TM.make_mesh(shards, devices=devices)
    fn = TM.build_mesh_chunk(
        mesh, engine=job.engine, epochs=epochs,
        m=job.m, k=job.k, dt_epoch_ns=job.dt_epoch_ns, waves=job.waves,
        calendar_impl=job.calendar_impl, ladder_levels=job.ladder_levels,
        **cfg)
    rng = np.random.Generator(np.random.PCG64(serve.MESH_SEED))
    state, cd, cr, vd, vr, slo = serve.mesh_start(job, shards, mesh.device,
                                                  mesh)
    return fn(state, cd, cr, vd, vr, 0, TM.place_shards(serve.mesh_draws(
        rng, shards, job.n, epochs, job.arrival_lam, mesh.device), mesh),
        slo=slo)


def groups_gather(tree):
    """A grouped tree (a MeshChunk's fields) as single stacks."""
    from dmclock_tpu_torch.parallel import groups

    return groups.gather(tree)


def mesh_wheel_job():
    from dmclock_tpu_torch import serve

    c = MESH_WHEEL
    return serve.mesh_job(c["n"], engine="calendar", calendar_impl="wheel",
                          m=c["m"], k=c["k"], ladder_levels=c["levels"])


def mesh_twins(out: str) -> None:
    """Phase 22's CPU runs (in a child process): (a)'s first chunk at
    8 x 12,500, (d)'s wheel chunk, the cut dry run under both trackers
    and the outage run; saved to ``out``."""
    from dmclock_tpu_torch import serve

    torch.set_num_threads(4)
    first = chunk_numpy(mesh_chunk_run(
        "cpu", serve.mesh_job(serve.MESH["clients"] // MESH_SHARDS),
        MESH_SHARDS, serve.MESH["chunk"]))
    wheel = chunk_numpy(mesh_chunk_run(
        "cpu", mesh_wheel_job(), MESH_WHEEL["shards"],
        MESH_WHEEL["epochs"]))
    mc = serve.multichip_row(**MULTICHIP_CUT, device="cpu")
    outage = serve.cluster_outage(**OUTAGE, device="cpu")
    torch.save(dict(first=first, wheel=wheel, multichip=mc,
                    outage=outage), out)


def start_mesh_twins(root: str, out: str) -> subprocess.Popen:
    code = ("import sys\n"
            f"sys.path.insert(0, {root!r})\n"
            "import chip_smoke\n"
            f"chip_smoke.mesh_twins({out!r})\n")
    return _cpu_child(code, out)


def _same_numpy(got: dict, want: dict, what: str) -> None:
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: fields {sorted(got)} vs "
                             f"{sorted(want)}")
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: {k} differs")


def _row_line(row: dict) -> str:
    return (f"{row['dps']:.1f} decisions/s ({row['decisions']} decisions "
            f"over {row['epochs']} epochs in {row['wall_s']:.6f} s wall); "
            f"per shard mean {row['dps_per_shard_mean']:.1f}, min "
            f"{row['dps_per_shard_min']:.1f}, max "
            f"{row['dps_per_shard_max']:.1f}; counter syncs "
            f"{row['counter_syncs']}, {row['counter_bytes_per_sync']} "
            f"bytes a sync, {row['counter_bytes_per_epoch']:.1f} bytes an "
            f"epoch executed ({row['counter_view_bytes_per_epoch']:.1f} "
            f"view bytes an epoch), collective skipping "
            f"{row['collective_skipping']}")


def capacity_probe() -> dict:
    """Phase 22 (f)'s measurement on the card: the growth of the
    allocator's requested bytes (``requested_bytes.all.current``, the
    sum of the live allocations' own sizes, whatever blocks earlier
    phases left cached) over one mesh shard's state, its histograms,
    ledger and SLO block and one chunk's outputs; beside it the
    ``memory_allocated`` growth (whole blocks, cached overhead included),
    the tensors' own bytes and the peak over the chunk."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.engine import stream as tstream
    from dmclock_tpu_torch.obs import capacity as obscap
    from dmclock_tpu_torch.obs import histograms as obshist
    from dmclock_tpu_torch.obs import slo as obsslo
    from dmclock_tpu_torch.robust.supervisor import _job_state

    c = serve.MESH
    n = c["clients"] // MESH_SHARDS
    job = serve.mesh_job(n)
    draws = torch.from_numpy(np.random.default_rng(5).poisson(
        2.0, (c["chunk"], n)).astype(np.int32)).cuda()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    req0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    st, h, led, win = (_job_state(job, "cuda"), obshist.hist_zero("cuda"),
                       obshist.ledger_zero(n, "cuda"),
                       obsslo.window_zero(n, "cuda"))
    res = tstream.build_stream_chunk(
        engine=job.engine, epochs=c["chunk"], m=job.m, k=job.k,
        dt_epoch_ns=job.dt_epoch_ns, waves=job.waves)(
            st, 0, draws, hists=h, ledger=led, slo=win)
    del st, h, led, win
    gc.collect()
    torch.cuda.synchronize()
    return {"grown": torch.cuda.memory_allocated() - base,
            "requested": torch.cuda.memory_stats()[
                "requested_bytes.all.current"] - req0,
            "live": obscap.tree_bytes([res.state, res.outs, res.hists,
                                       res.ledger, res.slo]),
            "peak": torch.cuda.max_memory_allocated() - base}


def phase_mesh(ext, card: str, twin_path: str, twins: subprocess.Popen):
    """Phase 22 (a)-(f) on the card; returns ``(K1 launches by path, K2
    launches by path, the stacked runs phase 25 holds its grouped ones
    to)``."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.engine import stream as tstream
    from dmclock_tpu_torch.obs import capacity as obscap
    from dmclock_tpu_torch.obs import slo as obsslo
    from dmclock_tpu_torch.obs.registry import MetricsRegistry
    from dmclock_tpu_torch.robust import faults as TF
    from dmclock_tpu_torch.robust.supervisor import _job_state

    t_phase = time.perf_counter()
    k1, k2 = {}, {}
    c = serve.MESH
    n_shard = c["clients"] // MESH_SHARDS
    epochs_run = (c["warmup_epochs"] // c["chunk"]
                  + c["epochs"] // c["chunk"]) * c["chunk"]

    def counted(path, fn, want_k1, want_k2=0, ingests=False):
        torch.cuda.synchronize()
        ext.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launched(ext)
        if ingests:
            got = k3_taken(got, path)
        if got != {"ring_window": want_k1, "wheel_scan": want_k2}:
            raise AssertionError(f"{path} launched {got}, want K1 "
                                 f"{want_k1}, K2 {want_k2}")
        k1[path], k2[path] = want_k1, want_k2
        log(f"[{path}] {secs:.3f} s; kernel launches {got}")
        return res

    # phase 29 (b)'s mesh chunks at the row's shape, held first: the
    # rows below replay their captures
    hk1, hk2, held = held_mesh_chunks(ext, serve, "stacked")
    k1.update(hk1)
    k2.update(hk2)

    # (a) the mesh row at bench's shape, counter_sync_every 1 then 4
    rows = {}
    for every in (1, 4):
        path = "mesh" if every == 1 else "mesh_k4"
        rows[every] = row = counted(
            path, lambda: serve.mesh_row(
                c["clients"], n_shards=MESH_SHARDS,
                counter_sync_every=every, registry=MetricsRegistry(),
                device="cuda"), MESH_SHARDS * epochs_run)
        log(f"[{path}] bench's mesh row on {card}: {c['clients']} clients "
            f"over {row['n_shards']} shards ({row['clients_per_shard']} a "
            f"shard), counter_sync_every {every}: {_row_line(row)}; "
            f"per-shard decisions/s {row['dps_per_shard']}")
    # the views are the counter plane's bookkeeping: the superwave
    # ingest carries unit rho/delta, so K moves no decision
    if rows[4]["decisions"] != rows[1]["decisions"]:
        raise AssertionError(f"mesh_k4: {rows[4]['decisions']} decisions, "
                             f"K=1 {rows[1]['decisions']}")
    first = chunk_numpy(mesh_chunk_run(
        "cuda", serve.mesh_job(n_shard), MESH_SHARDS, c["chunk"]))

    # (b) chaos: the same row with the fault plan inside the chunks
    spec = TF.parse_fault_spec(MESH_FAULT_SPEC)
    chaos = counted("mesh_chaos", lambda: serve.mesh_row(
        c["clients"], n_shards=MESH_SHARDS, fault_spec=spec,
        registry=MetricsRegistry(), device="cuda"),
        MESH_SHARDS * epochs_run)
    ev = TF.plan_shard_events(TF.plan_from_spec(spec, epochs_run,
                                                MESH_SHARDS))
    if chaos["fault_dropouts_per_shard"] != \
            ev["server_dropouts"].tolist() or \
            chaos["fault_resyncs_per_shard"] != \
            ev["tracker_resyncs"].tolist() or \
            chaos["faults_injected_total"] != \
            int(ev["faults_injected"].sum()):
        raise AssertionError(f"mesh_chaos: device fault rows "
                             f"{chaos['fault_dropouts_per_shard']} / "
                             f"{chaos['fault_resyncs_per_shard']} != plan "
                             f"{ev}")
    log(f"[mesh_chaos] {chaos['fault_plan']} on {card}: {_row_line(chaos)};"
        f" dropouts per shard {chaos['fault_dropouts_per_shard']}, "
        f"resyncs per shard {chaos['fault_resyncs_per_shard']}, "
        f"{chaos['faults_injected_total']} faults injected: equal to "
        f"plan_shard_events")

    # (c) S=1 identity at 100,000 clients against the stream chunk
    job1 = serve.mesh_job(c["clients"])
    one = counted("mesh_s1", lambda: chunk_numpy(mesh_chunk_run(
        "cuda", job1, 1, MESH_S1_EPOCHS)), MESH_S1_EPOCHS)
    rng = np.random.Generator(np.random.PCG64(serve.MESH_SEED))
    counts = np.stack([rng.poisson(job1.arrival_lam, (1, job1.n))
                       .astype(np.int32)[0]
                       for _ in range(MESH_S1_EPOCHS)])
    ref = tstream.build_stream_chunk(
        engine=job1.engine, epochs=MESH_S1_EPOCHS, m=job1.m, k=job1.k,
        dt_epoch_ns=job1.dt_epoch_ns, waves=job1.waves)(
            _job_state(job1, "cuda"), 0, torch.from_numpy(counts).cuda(),
            slo=obsslo.window_zero(job1.n, "cuda"))
    ref = chunk_numpy(ref)
    for key, want in ref.items():
        got = one[key][0]
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"mesh_s1: {key} differs from the "
                                 "stream chunk")
    if not np.array_equal(one["slo_merged"], ref["slo"]):
        raise AssertionError("mesh_s1: slo_merged differs")
    log(f"[mesh_s1] one mesh chunk of {MESH_S1_EPOCHS} epochs at "
        f"{c['clients']} clients x 1 shard equals build_stream_chunk on "
        f"the card field by field ({int(one['outs.count'].sum())} "
        f"decisions)")

    # (d) the wheel on the mesh: K2 per shard
    w = MESH_WHEEL
    per = w["shards"] * w["epochs"] * w["m"]
    wheel = counted("mesh_wheel", lambda: chunk_numpy(mesh_chunk_run(
        "cuda", mesh_wheel_job(), w["shards"], w["epochs"])),
        per * w["levels"], per * (w["levels"] + 1))

    # (e) the cluster dry run (cut) and the outage, on cluster_step
    mc = counted("multichip", lambda: serve.multichip_row(
        **MULTICHIP_CUT, device="cuda"), 0, ingests=True)
    outage = counted("cluster_outage", lambda: serve.cluster_outage(
        **OUTAGE, device="cuda"), 0, ingests=True)

    # (f) capacity
    budget = obscap.device_hbm_budget()
    cap_cfg = dict(ring=c["ring"], engine=c["engine"], m=c["m"], k=c["k"],
                   telemetry=True, slo=True, stream_chunk=c["chunk"])
    cap = obscap.plan_capacity(budget, **cap_cfg)
    plan = serve.plan_mesh_shards(c["clients"], device="cuda")
    proj = obscap.projected_hbm(n_shard, **cap_cfg)
    probe = capacity_probe()
    req = probe["requested"]
    log(f"[capacity] on {card}: device_hbm_budget {budget} bytes; "
        f"plan_capacity for the mesh row's shard configuration: "
        f"max_clients {cap['max_clients']} "
        f"({cap['bytes_per_client']:.3f} bytes a client, "
        f"{cap['fixed_bytes']:.1f} fixed); plan_mesh_shards({c['clients']})"
        f": shards_planned {plan['shards_planned']}; projected_hbm for one "
        f"shard ({n_shard} clients) {proj} bytes; the allocator's "
        f"requested bytes grew {req} over its state, accumulators and one "
        f"chunk's outputs ({req / proj:.4f}x; the live tensors' own bytes "
        f"{probe['live']}); memory_allocated growth {probe['grown']} "
        f"({probe['grown'] / proj:.4f}x, cached blocks reused whole), "
        f"peak {probe['peak']} bytes")
    if abs(req - proj) > 0.1 * proj:
        raise AssertionError(f"capacity: projected {proj} bytes, resident "
                             f"growth {req}: off by more than 10%")

    # the card's runs against the CPU twin
    want = collect_cpu_twins(twins, twin_path)
    _same_numpy(first, want["first"], "mesh chunk vs the CPU twin")
    log(f"[mesh] the first chunk at {MESH_SHARDS} x {n_shard} equals the "
        f"CPU twin on every field (state, outs, counters, views, "
        f"slo_merged; {int(first['outs.count'].sum())} decisions)")
    _same_numpy(wheel, want["wheel"], "mesh_wheel vs the CPU twin")
    log(f"[mesh_wheel] {w['shards']} x {w['n']} clients, {w['epochs']} "
        f"epochs: equal to the CPU twin on every field "
        f"({int(wheel['outs.count'].sum())} decisions)")
    for a, b in zip(mc["policies"], want["multichip"]["policies"]):
        if a != b:
            raise AssertionError(f"multichip {a['tracker']}: {a} != {b}")
        log(f"[multichip] {a['tracker']} on {card}: {a['servers']} servers"
            f" x {a['clients']} clients, {a['decisions_per_step']} "
            f"decisions a step, {a['rounds']} + {a['drain_rounds']} rounds:"
            f" {a['served']} served, class service {a['class_service']}, "
            f"drain shares {[round(x, 4) for x in a['weight_shares']]}; "
            f"digest {a['digest'][:16]} equal to the CPU twin's")
    _same_numpy({k: v for k, v in outage.items() if isinstance(v, np.ndarray)},
                {k: v for k, v in want["outage"].items()
                 if isinstance(v, np.ndarray)}, "cluster_outage")
    for key in ("digest", "metrics", "served"):
        if outage[key] != want["outage"][key]:
            raise AssertionError(f"cluster_outage: {key} differs")
    log(f"[cluster_outage] single_outage_plan on {card}: {outage['served']}"
        f" served, dropouts {outage['metrics']['server_dropouts']}, "
        f"resyncs {outage['metrics']['tracker_resyncs']}: equal to the CPU "
        f"twin (digest, metrics, views, clocks)")
    log(f"[time] mesh phase {time.perf_counter() - t_phase:.3f} s")
    return k1, k2, dict(rows=rows, chaos=chaos, first=first, wheel=wheel,
                        multichip=mc, held=held)


# ----------------------------------------------------------------------
# phase 23: the supervised mesh
# ----------------------------------------------------------------------

# serve.mesh_job's shape (the mesh row's per-shard job: ring 16 preloaded
# 12 deep, prefix m=4, k=256, Poisson(2) in 4 waves, 100 ms epochs) over
# 8 shards of 12,500, supervised: 16 epochs, a checkpoint every 4,
# histograms, ledger and SLO windows on
SUP_MESH = dict(engine="prefix", n=12_500, depth=12, ring=16, m=4, k=256,
                arrival_lam=2.0, waves=4, dt_epoch_ns=10 ** 8, epochs=16,
                ckpt_every=4, engine_loop="mesh", n_shards=MESH_SHARDS,
                with_hists=True, with_ledger=True, with_slo=True)
SUP_MESH_FIRST = dict(SUP_MESH, epochs=SUP_MESH["ckpt_every"])
# the trip: client 0's tag 2^31 + 1 ns ahead blows the tag32 window in
# every chunk (2 chunks)
SUP_MESH_TRIP = dict(SUP_MESH, epochs=8, tag_width=32,
                     tag_spread_ns=2 ** 31 + 1)
# the churn row's population (churn_storm, 4,096 ids, capacity 1,024 a
# shard, growing) over 4 shards with p2c placement under the mesh row's
# fault plan; 32 epochs of 50 ms, a boundary every 4
SUP_MESH_CHURN = dict(engine="prefix", n=4096, ring=32, epochs=32, m=4,
                      k=256, waves=8, dt_epoch_ns=50_000_000, seed=11,
                      ckpt_every=4, engine_loop="mesh", n_shards=4,
                      placement="p2c", fault_plan=MESH_FAULT_SPEC)
SUP_MESH_CHURN_SPEC = dict(total_ids=4096, seed=11, base_lam=2.0,
                           compact_every=2)


def sup_mesh_twins(out: str) -> None:
    """Phase 23's CPU runs (in a child process): the supervised mesh
    job's first chunk and the churn job; saved to ``out``."""
    from dmclock_tpu_torch.lifecycle import make_spec
    from dmclock_tpu_torch.robust import supervisor as TS

    torch.set_num_threads(4)
    first = TS.run_job(TS.EpochJob(**SUP_MESH_FIRST), device="cpu")
    spec = make_spec(STORM_SCENARIO, **SUP_MESH_CHURN_SPEC)
    churn = TS.run_job(TS.EpochJob(churn=spec, **SUP_MESH_CHURN),
                       device="cpu")
    torch.save(dict(first=first._asdict(), churn=churn._asdict()), out)


def start_sup_mesh_twins(root: str, out: str) -> subprocess.Popen:
    code = ("import sys\n"
            f"sys.path.insert(0, {root!r})\n"
            "import chip_smoke\n"
            f"chip_smoke.sup_mesh_twins({out!r})\n")
    return _cpu_child(code, out)


def _mesh_line(what: str, res, wall: float, launches) -> None:
    log(f"[{what}] wall {wall:.3f} s, {res.decisions} decisions, "
        f"restarts {res.restarts}, resumes "
        f"{res.metrics[MET_SUPERVISOR_RESUMES]}, mesh_fallbacks "
        f"{res.mesh_fallbacks} (chaos {res.mesh_chaos_fallbacks}), K1 "
        + ("not counted (spawn children)" if launches is None
           else f"{launches['ring_window']}"))


def phase_supervised_mesh(ext, card: str, tmp: str, twin_path: str,
                          twin_proc: subprocess.Popen):
    """Phase 23: the supervised mesh (``EpochJob(engine_loop="mesh")``)
    at the mesh row's width.  Returns ``({path: K1 launches}, the bare
    supervised_mesh result)`` over the in-process runs (no K2: the
    prefix engine)."""
    from dmclock_tpu_torch.lifecycle import make_spec
    from dmclock_tpu_torch.obs import device as obsdev
    from dmclock_tpu_torch.robust import faults as TF
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    t_phase = time.perf_counter()
    by_path = {}
    shard_epochs = SUP_MESH["epochs"] * SUP_MESH["n_shards"]

    def wd(name):
        path = os.path.join(tmp, name)
        os.makedirs(path)
        return path

    def run(path, fn, exact=None):
        res, launches, wall = _sup_run(ext, path, fn)
        if exact is not None and launches["ring_window"] != exact:
            raise AssertionError(f"{path}: K1 {launches['ring_window']}, "
                                 f"want {exact} (once a shard-epoch)")
        by_path[path] = launches["ring_window"]
        _mesh_line(path, res, wall, launches)
        return res

    def killed(path, job, ref, frac):
        w = wd(path)
        res = run(path, lambda: TS.run_supervised(
            job, w, TH.HostFaultPlan(
                kill_at_decisions=(int(ref.decisions * frac),)),
            device="cuda"))
        TS.assert_crash_equivalent(res, ref)
        if res.restarts != 1:
            raise AssertionError(f"{path}: {res.restarts} restarts")
        log(f"[{path}] killed at {frac} of its decisions, resumed: "
            f"crash-equivalent to the bare run")
        shutil.rmtree(w)
        return res

    # (a) supervised_mesh: bare, killed at 0.35 and 0.75, first chunk
    job = TS.EpochJob(**SUP_MESH)
    ref = run("supervised_mesh", lambda: TS.run_job(job, device="cuda"),
              shard_epochs)
    if ref.mesh_fallbacks or ref.decisions <= 0:
        raise AssertionError(f"supervised_mesh: {ref.decisions} decisions,"
                             f" {ref.mesh_fallbacks} fallbacks")
    for frac in (0.35, 0.75):
        killed(f"supervised_mesh_kill{int(frac * 100)}", job, ref, frac)
    first = run("supervised_mesh_first", lambda: TS.run_job(
        TS.EpochJob(**SUP_MESH_FIRST), device="cuda"),
        SUP_MESH_FIRST["epochs"] * SUP_MESH["n_shards"])

    # (b) supervised_mesh_chaos: the fault plan inside the chunks
    chaos_job = TS.EpochJob(**dict(SUP_MESH, fault_plan=MESH_FAULT_SPEC))
    chaos = run("supervised_mesh_chaos", lambda: TS.run_job(
        chaos_job, device="cuda"), shard_epochs)
    killed("supervised_mesh_chaos_killed", chaos_job, chaos, 0.5)
    plan = TF.plan_from_spec(TF.parse_fault_spec(MESH_FAULT_SPEC),
                             SUP_MESH["epochs"], SUP_MESH["n_shards"])
    ev = TF.plan_shard_events(plan)
    md = obsdev.metrics_dict(chaos.metrics)
    for key in ("server_dropouts", "tracker_resyncs", "faults_injected"):
        if md[key] != int(ev[key].sum()):
            raise AssertionError(f"supervised_mesh_chaos: {key} {md[key]},"
                                 f" plan {int(ev[key].sum())}")
    if not 0 < chaos.decisions < ref.decisions:
        raise AssertionError("supervised_mesh_chaos: decisions "
                             f"{chaos.decisions} vs clean {ref.decisions}")
    log(f"[supervised_mesh_chaos] {MESH_FAULT_SPEC}: dropouts "
        f"{md['server_dropouts']}, resyncs {md['tracker_resyncs']}, faults "
        f"{md['faults_injected']} equal plan_shard_events (per shard "
        f"{ev['server_dropouts'].tolist()} / "
        f"{ev['tracker_resyncs'].tolist()}); {chaos.decisions} decisions "
        f"against {ref.decisions} clean")

    # (c) supervised_mesh_trip: tag32 trips, replays on the host loop
    trip = run("supervised_mesh_trip", lambda: TS.run_job(
        TS.EpochJob(**SUP_MESH_TRIP), device="cuda"))
    wide = run("supervised_mesh_trip64", lambda: TS.run_job(
        TS.EpochJob(**dict(SUP_MESH_TRIP, tag_width=64)), device="cuda"),
        SUP_MESH_TRIP["epochs"] * SUP_MESH["n_shards"])
    if trip.mesh_fallbacks < 1:
        raise AssertionError("supervised_mesh_trip: no fallback")
    a = trip.metrics.copy()
    b = wide.metrics.copy()
    a[MET_REBASE_FALLBACKS] = b[MET_REBASE_FALLBACKS] = 0
    _same_result(trip._replace(metrics=a), wide._replace(metrics=b),
                 "supervised_mesh_trip vs tag_width=64",
                 skip=("restarts", "resumed_from", "digest",
                       "mesh_fallbacks"))
    log(f"[supervised_mesh_trip] tag_width=32 with client 0's tag 2^31 + 1"
        f" ns ahead: {trip.mesh_fallbacks} chunks discarded and replayed "
        f"on the host loop on the card ({trip.metrics[MET_REBASE_FALLBACKS]}"
        f" rebase resumes); every result field equals the tag_width=64 "
        f"job's but the digest (the tripped epochs also hash their "
        f"discarded attempt), that metric row and mesh_fallbacks")

    # (d) supervised_mesh_churn: p2c under the fault plan, killed at half
    spec = make_spec(STORM_SCENARIO, **SUP_MESH_CHURN_SPEC)
    cjob = TS.EpochJob(churn=spec, **SUP_MESH_CHURN)
    cref = run("supervised_mesh_churn", lambda: TS.run_job(
        cjob, device="cuda"),
        SUP_MESH_CHURN["epochs"] * SUP_MESH_CHURN["n_shards"])
    killed("supervised_mesh_churn_killed", cjob, cref, 0.5)
    log(f"[supervised_mesh_churn] {STORM_SCENARIO} over "
        f"{SUP_MESH_CHURN['n_shards']} shards, p2c under {MESH_FAULT_SPEC}:"
        f" placement counters {cref.placement_counters}; lifecycle "
        f"{ {k: v for k, v in cref.lifecycle.items() if k != 'shards'} }")
    s1 = dict(SUP_MESH_CHURN, n_shards=1, fault_plan=None)
    st1 = run("supervised_mesh_churn_s1", lambda: TS.run_job(
        TS.EpochJob(churn=spec, **dict(s1, placement="static")),
        device="cuda"))
    p1 = run("supervised_mesh_churn_s1_p2c", lambda: TS.run_job(
        TS.EpochJob(churn=spec, **s1), device="cuda"))
    if (st1.digest, st1.state_digest, st1.lifecycle) != \
            (p1.digest, p1.state_digest, p1.lifecycle) or \
            not np.array_equal(st1.metrics, p1.metrics):
        raise AssertionError("supervised_mesh_churn: S=1 p2c differs from "
                             "S=1 static")
    log("[supervised_mesh_churn] S=1 p2c equals S=1 static on the card "
        "(digest, state, metrics, lifecycle): loop-neutral")

    want = collect_cpu_twins(twin_proc, twin_path)
    check_supervised(first, card, want["first"], "supervised_mesh_first")
    check_supervised(cref, card, want["churn"], "supervised_mesh_churn")
    log(f"[time] supervised mesh phase {time.perf_counter() - t_phase:.3f}"
        f" s")
    return by_path, ref


# ----------------------------------------------------------------------
# phase 24: control and network
# ----------------------------------------------------------------------

# bench's controller row at its accelerator shape, all three scenarios
CTL_ROW = dict(total_ids=192, epochs=48, sides="both")
# the supervised_churn cell's population with the controller on
CTL_CHURN = dict(SUP_CHURN, controller=True)
# bench's rpc row at its accelerator shape; the chaos leg's spec
RPC_ROW = dict(n=32, epochs=16, requests=64, workers=4)
RPC_CHAOS = "seed=7,p_drop=0.1,p_dup=0.05,p_reorder=0.05"
# rpc_full: the supervised_prefix cell's state (0.2195 GB) behind the
# ingest server, fed by 4 loadgen workers of 4,096 requests over the
# 100,000 ids; the live leg serves from the first admitted op on, while
# the requests arrive; the kill leg and its uninterrupted reference wait
# for every op before the first take (a trace fixed by the schedule).
# Cut in depth to 4 epochs (2 boundaries) and 4,096 requests a worker
# to keep the script inside its time
RPC_FULL = dict(engine="prefix", n=100_000, depth=64, ring=128, epochs=4,
                m=8, k=65536, waves=8, ckpt_every=2)
RPC_LOAD = dict(workers=4, requests=4096, n_clients=100_000, max_nops=3,
                seed=7)
# bench's mesh_rebalance row at its shape, then at the supervised mesh
# churn cell's population (shard_skew, 4,096 ids over 4 shards, capacity
# 1,024 a shard growing, 32 epochs of m=4, k=256, ring 32, 8 waves)
REBAL_POP = dict(total_ids=4096, epochs=32, m=4, k=256, ring=32, waves=8,
                 seed=11)
# the cold-pick twin gate on the wheel calendar mesh
# (tests/test_placement.py's skew_job at 2 levels, k=4)
GATE_CTL = dict(sync_max=1, backlog_hi=10 ** 9, occ_lo=0.0, hysteresis=1,
                cooldown=8, migrate_skew_hi=1.5, migrate_pick="cold",
                migrate_max=4)
GATE_JOB = dict(engine="calendar", k=4, calendar_impl="wheel",
                ladder_levels=2, n=96, depth=6, ring=10, epochs=8, m=2,
                seed=5, arrival_lam=1.0, waves=2, ckpt_every=2,
                engine_loop="mesh", n_shards=4, placement="p2c",
                controller=GATE_CTL)
GATE_SPEC = dict(total_ids=64, seed=3, cold_frac=0.5, cold_until=10 ** 9)
# row keys that hold wall clocks (and so differ from a CPU twin); a
# row's ``compile_ms_total`` is its captures' wall (0 on the CPU)
_WALL_KEYS = ("dps", "dps_on", "dps_off", "wall_s", "wall_s_on",
              "wall_s_off", "recovered_dps", "lat_p50_ms", "lat_p99_ms",
              "compile_ms_total")


def _gate_jobs(overrides=None):
    from dmclock_tpu_torch.lifecycle import make_spec
    from dmclock_tpu_torch.robust import supervisor as TS

    spec = make_spec("shard_skew", **GATE_SPEC)
    if overrides is None:
        return TS.EpochJob(churn=spec, **GATE_JOB)
    return TS.EpochJob(churn=spec, **dict(
        GATE_JOB, placement={"mode": "p2c", "overrides": overrides},
        controller=dict(GATE_CTL, migrate_skew_hi=0.0)))


def control_twins(out: str) -> None:
    """Phase 24's CPU runs that need nothing from the card (in a child
    process): the controller rows, the controller churn job, both
    mesh_rebalance rows and the wheel gate's run A; saved to ``out``."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.lifecycle import make_spec
    from dmclock_tpu_torch.robust import supervisor as TS

    torch.set_num_threads(4)
    ctl = serve.controller_row(device="cpu", **CTL_ROW)
    spec = make_spec(CHURN_SCENARIO, **SUP_CHURN_SPEC)
    churn = TS.run_job(TS.EpochJob(churn=spec, **CTL_CHURN), device="cpu")
    rebal = serve.mesh_rebalance_row(device="cpu")
    pop = serve.mesh_rebalance_row(device="cpu", **REBAL_POP)
    gate = TS.run_job(_gate_jobs(), device="cpu")
    torch.save(dict(ctl=ctl, churn=churn._asdict(), rebal=rebal, pop=pop,
                    gate=gate._asdict()), out)


def start_control_twins(root: str, out: str) -> subprocess.Popen:
    code = ("import sys\n"
            f"sys.path.insert(0, {root!r})\n"
            "import chip_smoke\n"
            f"chip_smoke.control_twins({out!r})\n")
    return _cpu_child(code, out)


def rpc_twins(out: str, traces: dict) -> None:
    """The CPU replays of the card's journaled traces (in a child
    process): each rpc leg's record as the port's ``run_serve`` gives it
    on the CPU from the same admitted-counts trace."""
    from dmclock_tpu_torch.net.serve import RpcServeConfig, run_serve

    torch.set_num_threads(4)
    res = {}
    for name, (cfg, trace) in traces.items():
        res[name] = run_serve(RpcServeConfig(**dict(
            cfg, workdir=None, wait_ops=0, device="cpu")), trace=trace)
    torch.save(res, out)


def start_rpc_twins(root: str, out: str, traces: dict) -> subprocess.Popen:
    with open(out + ".in.json", "w") as fh:
        json.dump(traces, fh)
    code = ("import sys, json\n"
            f"sys.path.insert(0, {root!r})\n"
            "import chip_smoke\n"
            f"with open({out + '.in.json'!r}) as fh:\n"
            "    traces = json.load(fh)\n"
            f"chip_smoke.rpc_twins({out!r}, traces)\n")
    return _cpu_child(code, out)


def _same_row(got: dict, want: dict, what: str) -> None:
    """Two bench rows, every key but the wall clocks."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys differ: "
                             f"{sorted(set(got) ^ set(want))}")
    for key, value in want.items():
        if key not in _WALL_KEYS and got[key] != value:
            raise AssertionError(f"{what}: {key} differs: "
                                 f"{str(got[key])[:200]} vs "
                                 f"{str(value)[:200]}")


def _counted(ext, what: str, fn, by_k1: dict, by_k2: dict,
             k2: bool = False):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: K1 must launch, K2 exactly when ``k2``.  ``(result, wall)``."""
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = launched(ext)
    if n["ring_window"] <= 0 or (n["wheel_scan"] > 0) != k2:
        raise AssertionError(f"{what} launched {n}")
    by_k1[what] = n["ring_window"]
    if n["wheel_scan"]:
        by_k2[what] = n["wheel_scan"]
    log(f"[{what}] wall {wall:.3f} s, kernel launches {n}")
    return res, wall


class _TimedJournal:
    """Times the arrival journal's appends (the fsync'd writes) of every
    ``run_serve`` while it is installed in ``net.serve``."""

    def __init__(self):
        self.seconds = 0.0
        self.appends = 0
        self.first = None        # perf_counter at the first append

    @contextlib.contextmanager
    def installed(self):
        from dmclock_tpu_torch.net import journal as journal_mod
        from dmclock_tpu_torch.net import serve as serve_mod

        outer = self

        class Timed(journal_mod.ArrivalJournal):
            def append(self, entry):
                t0 = time.perf_counter()
                if outer.first is None:
                    outer.first = t0
                try:
                    return super().append(entry)
                finally:
                    outer.seconds += time.perf_counter() - t0
                    outer.appends += 1

        saved = serve_mod.ArrivalJournal
        serve_mod.ArrivalJournal = Timed
        try:
            yield self
        finally:
            serve_mod.ArrivalJournal = saved


def _loadgen(root: str, port: int) -> subprocess.Popen:
    """The module CLI's worker processes against ``port``."""
    L = RPC_LOAD
    return subprocess.Popen(
        [sys.executable, "-m", "dmclock_tpu_torch.net.loadgen", "--port",
         str(port), "--workers", str(L["workers"]), "--requests",
         str(L["requests"]), "--n-clients", str(L["n_clients"]),
         "--max-nops", str(L["max_nops"]), "--seed", str(L["seed"]),
         "--timeout-s", "5.0"], cwd=root, stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def _loadgen_done(proc: subprocess.Popen, want_ok: int) -> dict:
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        _stop(proc)
    merged = json.loads(out.strip().splitlines()[-1])
    if proc.returncode != 0 or merged.get("ok", 0) + merged.get(
            "dup", 0) != want_ok:
        raise AssertionError(f"loadgen rc {proc.returncode}: {merged}")
    return merged


def phase_control(ext, card: str, root: str, tmp: str):
    """Phase 24: the closed-loop controller, live migration and the RPC
    ingest front end on the card, each leg equal to a CPU twin.  Returns
    ``({path: K1 launches}, {path: K2 launches})`` over the in-process
    runs."""
    import dataclasses

    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.lifecycle import make_spec
    from dmclock_tpu_torch.net import loadgen
    from dmclock_tpu_torch.net.journal import ArrivalJournal
    from dmclock_tpu_torch.net.serve import (RpcServeConfig, make_server,
                                             run_serve)
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    t_phase = time.perf_counter()
    by_k1, by_k2 = {}, {}
    twin_out = os.path.join(tmp, "control_twins.pt")
    twin = start_control_twins(root, twin_out)
    rpc_twin = None
    try:
        # (a) bench's controller rows, both twins of every scenario
        ctl, _ = _counted(ext, "controller_rows", lambda: serve.controller_row(
            device="cuda", **CTL_ROW), by_k1, by_k2)
        for name, row in ctl.items():
            log(f"[{name}] decisions off {row['decisions_off']} / on "
                f"{row['decisions_on']}, dps off {row['dps_off']:.1f} / on "
                f"{row['dps_on']:.1f}, burn epochs off "
                f"{row['burn_epochs_off']} / on {row['burn_epochs_on']}, "
                f"controller decisions {row['controller_decisions']}, "
                f"knobs {row['controller_knobs']}, trajectory "
                f"{row['controller_trajectory']}")

        # (b) the controller on the supervised_churn population: bare,
        # then killed at every controller stage of the first boundary
        # that decides anything, in process; then a spawn child
        # SIGKILLed after that boundary's journal append
        spec = make_spec(CHURN_SCENARIO, **SUP_CHURN_SPEC)
        cjob = TS.EpochJob(churn=spec, **CTL_CHURN)
        cref, _ = _counted(ext, "controller_churn", lambda: TS.run_job(
            cjob, device="cuda"), by_k1, by_k2)
        if not cref.controller_trajectory:
            raise AssertionError("controller_churn decided nothing")
        b0 = cref.controller_trajectory[0][1]
        for mode, stages in (("trampoline", TH.CONTROLLER_STAGES),
                             ("spawn", ("after_journal",))):
            wd = os.path.join(tmp, f"controller_churn_kills_{mode}")
            os.makedirs(wd)
            plan = TH.HostFaultPlan(kill_at_controller=tuple(
                (b0, stage) for stage in stages))
            t0 = time.perf_counter()
            res = TS.run_supervised(cjob, wd, plan, mode=mode,
                                    device="cuda")
            wall = time.perf_counter() - t0
            TS.assert_crash_equivalent(res, cref)
            if res.restarts != len(stages) or res.controller_replays < 1:
                raise AssertionError(f"controller_churn {mode} kills: "
                                     f"restarts {res.restarts}, replays "
                                     f"{res.controller_replays}")
            log(f"[controller_churn] {cref.decisions} decisions, "
                f"trajectory {cref.controller_trajectory}, knobs "
                f"{cref.controller_knobs}; killed ({mode}) at "
                f"{', '.join(stages)} of boundary {b0}: {res.restarts} "
                f"restarts, {res.controller_replays} journaled decisions "
                f"replayed, crash-equivalent to the bare run (wall "
                f"{wall:.3f} s)")
            shutil.rmtree(wd)

        # (c) bench's rpc row, clean and under chaos
        t_rpc = time.perf_counter()
        traces, rows_rpc = {}, {}
        for name, spec_s in (("rpc", None), ("rpc_chaos", RPC_CHAOS)):
            grabbed = {}
            real = ArrivalJournal.counts_trace

            def keep(self, grabbed=grabbed, real=real):
                tr = real(self)
                if self.path is not None:
                    grabbed["trace"] = tr
                return tr

            ArrivalJournal.counts_trace = keep
            try:
                row, _ = _counted(ext, name, lambda spec_s=spec_s:
                                  serve.rpc_row(fault_spec=spec_s,
                                                device="cuda", **RPC_ROW)
                                  ["rpc"], by_k1, by_k2)
            finally:
                ArrivalJournal.counts_trace = real
            if not row["digest_match"] or not row["chaos_exact"]:
                raise AssertionError(f"{name}: {row}")
            cfg = dict(engine="prefix", n=RPC_ROW["n"],
                       epochs=RPC_ROW["epochs"], ckpt_every=2, m=2, k=32,
                       ring=16, waves=6, seed=17)
            traces[name] = (cfg, grabbed["trace"])
            rows_rpc[name] = row
            log(f"[{name}] {row['scenario']}: {row['decisions']} decisions,"
                f" {row['admitted_ops']} ops traced + {row['carry_ops']} "
                f"carried, digest_match {row['digest_match']}, chaos_exact "
                f"{row['chaos_exact']} (drops {row['chaos_drops']}, dups "
                f"{row['chaos_dups']}, reorders {row['chaos_reorders']} = "
                f"oracle {row['oracle_drops']}/{row['oracle_dups']}/"
                f"{row['oracle_reorders']}), wall {row['wall_s']:.3f} s, "
                f"lat p50 {row['lat_p50_ms']:.3f} / p99 "
                f"{row['lat_p99_ms']:.3f} ms")

        # (d) rpc_full: the serving loop at 100,000 clients
        scheds = loadgen.full_schedule(
            RPC_LOAD["seed"], workers=RPC_LOAD["workers"],
            requests=RPC_LOAD["requests"],
            n_clients=RPC_LOAD["n_clients"],
            max_nops=RPC_LOAD["max_nops"])
        total = sum(n for sc in scheds for _, _, n in sc)
        n_req = RPC_LOAD["workers"] * RPC_LOAD["requests"]

        def serve_live(name, cfg):
            """One live leg in process: the server, the loadgen
            processes against it, ``run_serve``; the record and the
            journal's trace."""
            timer = _TimedJournal()
            server = make_server(cfg).start()
            lg = None
            try:
                lg = _loadgen(root, server.port)
                with timer.installed():
                    res, wall = _counted(ext, name, lambda: run_serve(
                        cfg, server=server), by_k1, by_k2)
                t_end = time.perf_counter()
                merged = _loadgen_done(lg, n_req)
                admitted = server.counters["admitted_ops"]
            finally:
                server.stop()
                if lg is not None:
                    _stop(lg)
            if admitted != total or res["admitted_ops_traced"] + \
                    res["carry_ops"] > total:
                raise AssertionError(
                    f"{name}: {admitted} ops admitted of {total}, "
                    f"{res['admitted_ops_traced']} + {res['carry_ops']} "
                    f"journaled")
            journal = ArrivalJournal(cfg.workdir)
            jbytes = os.path.getsize(journal.path)
            lat = res["latency"]
            serving = t_end - timer.first
            log(f"[{name}] {RPC_FULL['n']} clients, {n_req} requests from "
                f"{RPC_LOAD['workers']} loadgen processes ({total} ops; "
                f"loadgen {merged}), first take after {cfg.wait_ops} "
                f"admitted ops: {res['admitted_ops_traced']} ops journaled "
                f"+ {res['carry_ops']} carried, {res['decisions']} "
                f"decisions, {res['boundaries']} boundaries; wall "
                f"{wall:.3f} s ({res['decisions'] / wall:.1f}/s), serving "
                f"from the first take {serving:.3f} s "
                f"({res['decisions'] / serving:.1f}/s); lat p50 "
                f"{lat['p50_ms']:.3f} / p99 {lat['p99_ms']:.3f} ms over "
                f"{lat['samples']} requests; {timer.appends} journal "
                f"appends (fsync'd) took {timer.seconds:.3f} s, "
                f"{timer.seconds / serving:.4f} of the serving wall; the "
                f"journal {jbytes} bytes, "
                f"{jbytes / max(len(journal), 1):.0f} a boundary")
            return res, journal.counts_trace()

        # the live leg: the loop serves while the requests arrive
        cfg = RpcServeConfig(**RPC_FULL, workdir=os.path.join(
            tmp, "rpc_full"), wait_ops=1, wait_timeout_s=300, device="cuda")
        live, trace = serve_live("rpc_full", cfg)
        replay, rwall = _counted(ext, "rpc_full_replay", lambda: run_serve(
            dataclasses.replace(cfg, workdir=None, wait_ops=0),
            trace=trace), by_k1, by_k2)
        if (replay["digest"], replay["trace_sha"], replay["decisions"]) \
                != (live["digest"], live["trace_sha"], live["decisions"]):
            raise AssertionError("rpc_full: the replay twin differs")
        log(f"[rpc_full] digest_match True: the journal's replay lands on "
            f"digest {replay['digest'][:16]}, trace_sha "
            f"{replay['trace_sha'][:16]} (replay {rwall:.3f} s)")
        traces["rpc_full"] = (dict(RPC_FULL), trace)

        # the kill between fsync and apply: a spawned serving child of the
        # waited config (every op admitted before the first take, so the
        # schedule fixes the trace), started now so that its CUDA start and
        # state build ride the in-process waited leg, its uninterrupted
        # reference; the child's load follows that leg
        cfg = dataclasses.replace(cfg, workdir=os.path.join(
            tmp, "rpc_full_waited"), wait_ops=total)
        wd2 = os.path.join(tmp, "rpc_full_kill")
        ccfg = dataclasses.replace(cfg, workdir=wd2)
        os.makedirs(wd2)
        cfg_json = os.path.join(tmp, "rpc_full_kill.json")
        with open(cfg_json, "w") as fh:
            json.dump(dataclasses.asdict(ccfg), fh)
        port_file = os.path.join(tmp, "rpc_full_kill.port")
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-m", "dmclock_tpu_torch.net.serve",
             "--config", cfg_json, "--out",
             os.path.join(tmp, "rpc_full_kill.out"), "--port-file",
             port_file, "--crash-after-fsync", "1"], cwd=root)
        lg = None
        try:
            ref, wtrace = serve_live("rpc_full_waited", cfg)
            traces["rpc_full_waited"] = (dict(RPC_FULL), wtrace)
            rpc_out = os.path.join(tmp, "rpc_twins.pt")
            rpc_twin = start_rpc_twins(root, rpc_out, traces)
            while not os.path.exists(port_file):
                if child.poll() is not None or \
                        time.perf_counter() - t0 > 300:
                    raise AssertionError("rpc_full_kill: no port")
                time.sleep(0.05)
            with open(port_file) as fh:
                lg = _loadgen(root, int(fh.read()))
            _loadgen_done(lg, n_req)
            rc = child.wait(timeout=600)
        finally:
            _stop(child)
            if lg is not None:
                _stop(lg)
        if rc != -9 or len(ArrivalJournal(wd2)) != 2:
            raise AssertionError(f"rpc_full_kill: rc {rc}, "
                                 f"{len(ArrivalJournal(wd2))} records")
        kwall = time.perf_counter() - t0
        server = make_server(ccfg).start()
        try:
            resumed, _ = _counted(ext, "rpc_full_resumed", lambda: run_serve(
                ccfg, server=server), by_k1, by_k2)
        finally:
            server.stop()
        if not resumed["resumed"] or \
                (resumed["digest"], resumed["trace_sha"]) != \
                (ref["digest"], ref["trace_sha"]):
            raise AssertionError("rpc_full_kill: the resumed run differs "
                                 "from the uninterrupted one")
        log(f"[rpc_full_kill] the serving child SIGKILLed between "
            f"boundary 1's fsync and its apply ({kwall:.3f} s from its "
            f"start, beside the waited leg), resumed in process: digest and"
            f" trace_sha equal the uninterrupted waited run's")
        shutil.rmtree(wd2)
        t_mesh = time.perf_counter()
        log(f"[time] rpc legs {t_mesh - t_rpc:.3f} s")

        # (e) bench's mesh_rebalance row, then at the churn population
        rebal, _ = _counted(ext, "mesh_rebalance", lambda: serve
                            .mesh_rebalance_row(device="cuda"), by_k1, by_k2)
        pop, _ = _counted(ext, "mesh_rebalance_pop", lambda: serve
                          .mesh_rebalance_row(device="cuda", **REBAL_POP),
                          by_k1, by_k2)
        for name, row in (("mesh_rebalance", rebal),
                          ("mesh_rebalance_pop", pop)):
            if row["migrations"] <= 0:
                raise AssertionError(f"{name}: no migration")
            log(f"[{name}] {row['total_ids']} ids over {row['n_shards']} "
                f"shards, {row['epochs']} epochs: decisions off "
                f"{row['decisions_off']} / on {row['decisions_on']} "
                f"(recovered {row['recovered_decisions']}), skew "
                f"{row['shard_skew_before']:.4f} -> "
                f"{row['shard_skew_after']:.4f}, per shard "
                f"{row['shard_decisions_off']} -> "
                f"{row['shard_decisions_on']}, {row['migrations']} "
                f"migrations, dps off {row['dps_off']:.1f} / on "
                f"{row['dps_on']:.1f}")
        # the cold-pick twin gate on the wheel calendar mesh
        a, _ = _counted(ext, "migration_wheel", lambda: TS.run_job(
            _gate_jobs(), device="cuda"), by_k1, by_k2, k2=True)
        ov = {str(cid): dst for _b, cid, _s, dst in a.migration_log}
        bt, _ = _counted(ext, "migration_wheel_twin", lambda: TS.run_job(
            _gate_jobs(ov), device="cuda"), by_k1, by_k2, k2=True)
        if not a.migrations or bt.migrations or a.digest != bt.digest:
            raise AssertionError(f"migration_wheel: {a.migrations} moves,"
                                 f" twin {bt.migrations}, digests "
                                 f"{a.digest[:16]} {bt.digest[:16]}")
        log(f"[migration_wheel] {a.migrations} cold movers off shard 0 "
            f"({a.migration_log}) on the wheel calendar mesh: the digest "
            f"equals the twin that placed them there from epoch 0")

        # the CPU twins
        want = collect_cpu_twins(twin, twin_out)
        for name, row in ctl.items():
            _same_row(row, want["ctl"][name], f"{name} against the CPU twin")
        log("[controller rows] equal to the CPU twin on every key but the "
            "walls")
        check_supervised(cref, card, want["churn"], "controller_churn")
        _same_row(rebal, want["rebal"], "mesh_rebalance against the CPU "
                  "twin")
        _same_row(pop, want["pop"], "mesh_rebalance_pop against the CPU "
                  "twin")
        log("[mesh_rebalance rows] equal to the CPU twins on every key but "
            "the walls (migration logs, per-shard decisions)")
        check_supervised(a, card, want["gate"], "migration_wheel")
        got = collect_cpu_twins(rpc_twin, rpc_out)
        for name, row in rows_rpc.items():
            if (got[name]["digest"], got[name]["decisions"]) != \
                    (row["digest"], row["decisions"]):
                raise AssertionError(f"{name}: the CPU replay differs "
                                     "from the card's live run")
        for key in replay:
            if key not in ("latency", "mode") and \
                    got["rpc_full"][key] != replay[key]:
                raise AssertionError(f"rpc_full: {key} differs from the "
                                     "CPU twin")
        for key in ("digest", "trace_sha", "decisions", "boundaries",
                    "admitted_ops_traced", "carry_ops", "ingest_drops"):
            if got["rpc_full_waited"][key] != ref[key]:
                raise AssertionError(f"rpc_full_waited: {key} differs from "
                                     "the CPU twin")
        log(f"[rpc twins] the CPU replays of the card's traces: rpc, "
            f"rpc_chaos, rpc_full and rpc_full_waited land on the card's "
            f"digests (rpc_full {replay['digest'][:16]}, trace_sha "
            f"{replay['trace_sha'][:16]}, {replay['decisions']} decisions; "
            f"waited {ref['digest'][:16]}, trace_sha "
            f"{ref['trace_sha'][:16]}, {ref['decisions']})")
    finally:
        for proc in (twin, rpc_twin):
            if proc is not None:
                _stop(proc)
    log(f"[time] control and network phase "
        f"{time.perf_counter() - t_phase:.3f} s")
    return by_k1, by_k2, rebal


# ----------------------------------------------------------------------
# phase 25: the mesh across devices
# ----------------------------------------------------------------------

# the layouts on one card: JAX's one shard a device (8 groups of one
# shard) and 4 groups of two, each naming cuda:0 -- the grouped code, its
# per-group stacks and its reductions between groups on one device
GROUP_LAYOUTS = (MESH_SHARDS, 4)


def _row_same(got: dict, want: dict, what: str) -> None:
    """Two mesh rows on every key but the wall clocks and the plan's
    layout keys (a group plans against its share of its device)."""
    skip = {"dps", "dps_per_shard", "dps_per_shard_mean",
            "dps_per_shard_min", "dps_per_shard_max", "wall_s",
            "devices", "n_groups", "hbm_budget_bytes",
            "max_clients_per_shard", "shards_planned"}
    for key in want:
        if key not in skip and got.get(key) != want[key]:
            raise AssertionError(f"{what}: {key} {got.get(key)} vs the "
                                 f"stacked row's {want[key]}")


def _reduction_ms(n: int, devices) -> tuple:
    """One epoch's counter sum (the delta/rho ``global_counters_from``
    over the per-shard counters restacked by the layout, the reduction
    within and between the groups) on the first group's device:
    ``(ms a sum back to back between CUDA events, device ms of one sum
    in a CUDA graph)``, 200 sums each."""
    from dmclock_tpu_torch.parallel import mesh as TM
    from dmclock_tpu_torch.parallel.tracker import global_counters_from

    mesh = TM.make_mesh(MESH_SHARDS, devices=devices)
    gen = torch.Generator().manual_seed(3)
    cd, cr = (TM.place_shards(torch.randint(
        0, 1 << 40, (MESH_SHARDS, n), generator=gen,
        dtype=torch.int64).to(mesh.device), mesh) for _ in range(2))
    cds = [TM.shard_view(cd, s) for s in range(MESH_SHARDS)]
    crs = [TM.shard_view(cr, s) for s in range(MESH_SHARDS)]

    def once():
        return global_counters_from(TM.restack_shards(cds, mesh),
                                    TM.restack_shards(crs, mesh))

    with torch.cuda.device(mesh.device):
        return host_paced_ms(once, 200), cuda_ms(once, 200, replays=1)


def _ds_slices(devices, slices: int) -> dict:
    """The device-sim headline's first ``slices`` slices (100,000
    clients x 8 servers) on a layout, as host numpy."""
    from dmclock_tpu_torch.parallel import cluster as CL
    from dmclock_tpu_torch.sim import device_sim as DS

    _cfg, sim, spec = DS.headline_setup(DS_N, device=devices[0])
    mesh = CL.make_mesh(spec.n_servers, devices=devices)
    sim = DS.device_sim_step(sim, spec, slices, mesh=mesh)
    return DS.device_sim_to_numpy(sim)


def _ds_program(devices, slices: int, one: dict) -> dict:
    """The device-sim headline's first ``slices`` slices through the
    program (``jit_device_sim_step``) over a layout: its first call
    (the legs' captures) and a replay on a fresh sim, each equal to
    ``one`` (the one-group op-by-op run) on every field, the replay's
    synchronising operations exactly its read backs.  Returns the
    record."""
    from dmclock_tpu_torch.parallel import cluster as CL
    from dmclock_tpu_torch.sim import device_sim as DS

    _cfg, sim, spec = DS.headline_setup(DS_N, device=devices[0])
    mesh = CL.make_mesh(spec.n_servers, devices=devices)
    sim = DS.shard_device_sim(sim, mesh)
    step = DS.jit_device_sim_step(spec, slices, devices=mesh.devices)
    step.program.clear_compiled()
    what = f"device_sim_program over {len(devices)} groups"
    ms, syncs, reads = [], [], []
    for i in range(2):
        counts = DS.StepCounts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def go():
            ev[0].record()
            out = step(_clone_tree(sim), counts=counts)
            ev[1].record()
            return out

        if i:
            out, s = _capture_syncs(go)
            syncs.append(len(s))
            if len(s) != counts.read_backs:
                raise AssertionError(f"{what}: {len(s)} synchronising "
                                     f"operations for {counts.read_backs} "
                                     f"read backs")
        else:
            out = go()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        reads.append(counts.read_backs)
        _same_tree_np(DS.device_sim_to_numpy(out), one,
                      f"{what} call {i + 1}")
        del out
    caps = step.program.captures()
    if len(caps) != len(step.program.legs):
        raise AssertionError(f"{what}: {len(caps)} captures for "
                             f"{len(step.program.legs)} legs")
    return dict(legs=len(caps), graph_nodes={
        leg.name: caps[j]["graph_nodes"]
        for j, leg in enumerate(step.program.legs) if leg.group == 0},
        devices=sorted({c["device"] for c in caps}),
        compile_ms=sum(c["compile_ms"] for c in caps),
        ms_first_call=ms[0], ms_replay=ms[1], read_backs=reads,
        syncs_a_replay=syncs)


def _same_tree_np(a: dict, b: dict, what: str, path: str = "") -> None:
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: fields differ at {path}")
    for k in a:
        if isinstance(a[k], dict):
            _same_tree_np(a[k], b[k], what, f"{path}.{k}")
        elif a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {path}.{k} differs")


def _path_counter(ext, k1: dict, k2: dict):
    """``counted(path, fn, want_k1, want_k2=0, ingests=False)``: run
    ``fn`` with the launch counts set to 0 just before and read just
    after (every card synchronised), hold K1 and K2 to the wants (none
    with ``want_k1=None``), keep them in ``k1``/``k2`` under ``path``
    and return ``fn``'s result."""

    def counted(path, fn, want_k1, want_k2=0, ingests=False):
        torch.cuda.synchronize()
        ext.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        secs = time.perf_counter() - t0
        got = launched(ext)
        if ingests:
            got = k3_taken(got, path)
        if want_k1 is not None and got != {"ring_window": want_k1,
                                           "wheel_scan": want_k2}:
            raise AssertionError(f"{path} launched {got}, want K1 "
                                 f"{want_k1}, K2 {want_k2}")
        k1[path], k2[path] = got["ring_window"], got["wheel_scan"]
        log(f"[{path}] {secs:.3f} s; kernel launches {got}")
        return res

    return counted


def _mesh_rows_over(counted, devices, tag: str, stacked: dict,
                    card: str) -> None:
    """Bench's mesh row over the layout ``devices`` at K=1, K=4 and
    under ``MESH_FAULT_SPEC``, each held to its stacked row in
    ``stacked`` on every key but the walls and the layout's, with its
    decisions/s beside the stacked row's."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.obs.registry import MetricsRegistry
    from dmclock_tpu_torch.robust import faults as TF

    c = serve.MESH
    epochs_run = (c["warmup_epochs"] // c["chunk"]
                  + c["epochs"] // c["chunk"]) * c["chunk"]
    spec = TF.parse_fault_spec(MESH_FAULT_SPEC)
    for suffix, kw, want in (
            ("", dict(counter_sync_every=1), stacked["rows"][1]),
            ("_k4", dict(counter_sync_every=4), stacked["rows"][4]),
            ("_chaos", dict(fault_spec=spec), stacked["chaos"])):
        path = f"mesh_{tag}{suffix}"
        row = counted(path, lambda: serve.mesh_row(
            c["clients"], n_shards=MESH_SHARDS, devices=devices,
            registry=MetricsRegistry(), **kw), MESH_SHARDS * epochs_run)
        _row_same(row, want, path)
        log(f"[{path}] bench's mesh row over {row['n_groups']} groups "
            f"({', '.join(row['devices'])}) on {card}: {_row_line(row)}; "
            f"stacked {want['dps']:.1f} decisions/s in this run "
            f"({row['dps'] / want['dps']:.4f}x); every other key equal to "
            f"the stacked row's")


def _cluster_cards(cards) -> dict:
    """``cluster.cluster_step`` at the cut dry run's shape (``OUTAGE``:
    8 servers, 32 decisions a step) over ``cards`` and stacked on
    ``cuda:0``: the first call and 3 chained calls each, every call
    after the first under the sync debug mode's errors (0 syncs a
    call), each grouped call equal to the stacked one.  Host walls
    around work that ends in a synchronisation of every card."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.parallel import cluster as CL
    from dmclock_tpu_torch.parallel import groups

    o = OUTAGE
    cfg = (o["decisions_per_step"], 3, 0, False, 50_000_000)
    rec, outs = {}, {}
    for name, devs in (("stacked", None), ("cards", cards)):
        mesh, cl, costs = serve.multichip_cluster(
            o["n_servers"], o["n_clients"], "orig", "cuda:0", devices=devs)
        costs = torch.from_numpy(costs).to("cuda:0")
        arr = torch.full((o["n_servers"], o["n_clients"]), 3,
                         dtype=torch.int32, device="cuda:0")
        prog = CL.mesh_step_jit({}, CL.cluster_step, mesh, cfg)
        walls, outs[name] = [], []
        for i in range(4):
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            if i:
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = prog(cl, arr, costs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            walls.append((time.perf_counter() - t0) * 1e3)
            outs[name].append(groups.gather(got, "cpu"))
            cl = got[0]
        rec[name] = dict(first_call_ms=walls[0], call_ms=walls[1:])
        if name == "cards":
            rec["legs"] = _legs_of(prog, cards, "cluster.cluster_step")
    for i, (a, b) in enumerate(zip(outs["cards"], outs["stacked"])):
        _same_leaves(a, b, f"cluster.cluster_step over cards, call {i}")
    return rec


def _legs_of(prog, devices, what: str) -> dict:
    """A grouped program over ``devices``: one leg a group on the
    group's device, each leg's every signature a captured graph (none
    run eagerly).  Returns the legs' count and their captures' nodes."""
    from dmclock_tpu_torch.obs import compile_plane

    devs = [torch.device(d) for d in devices]
    if not isinstance(prog, compile_plane.StagedJit) or \
            [leg.device for leg in prog.legs][:len(devs)] != devs:
        raise AssertionError(f"{what} over {devices}: not one leg a card")
    for leg in prog.legs:
        graphs = list(leg.program._programs.values())
        if not graphs or any(not hasattr(g, "segments") for g in graphs):
            raise AssertionError(f"{what} over {devices}: leg "
                                 f"{leg.name} {leg.group} did not run "
                                 f"captured")
    return dict(legs=len(prog.legs), graph_nodes=[
        c["graph_nodes"] for c in prog.captures()])


def phase_mesh_cards(counted, fp, kernels, card: str, stacked: dict,
                     one: dict, cards, tag: str = "cards") -> None:
    """Phase 25 (e): the grouped programs over real cards, one group a
    card.  Bench's mesh row at K=1, K=4 and under the fault plan, each
    equal to its stacked row with both rates side by side, its
    ``mesh.chunk`` programs one captured leg a card; the cluster step
    over the cards against the stacked one (walls of both); the
    device-sim headline's first slices op by op and through the program
    over the cards, equal to one group's (``one``); K1 and K2 launched on
    the last card with ``cuda:0`` current, equal to their plain
    versions.  ``tag`` names the paths (``<tag><D>``)."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.parallel import mesh as TM

    d = len(cards)
    tag = f"{tag}{d}"
    _mesh_rows_over(counted, cards, tag, stacked, card)
    chunks = [_legs_of(p, cards, "mesh.chunk")
              for key, p in TM._MESH_CHUNK_JIT_CACHE.items()
              if key[0].devices == tuple(torch.device(c) for c in cards)]
    if not chunks:
        raise AssertionError(f"no mesh.chunk program over {cards}")
    log(f"[mesh_{tag}] the rows' {len(chunks)} mesh.chunk programs over "
        f"{', '.join(cards)} ran captured, one leg a group: nodes a leg "
        f"{[c['graph_nodes'] for c in chunks]}")
    rec = counted(f"cluster_step_{tag}", lambda: _cluster_cards(cards),
                  None)
    log(f"[cluster_step_{tag}] cluster.cluster_step over "
        f"{', '.join(cards)} on {card}, equal to the stacked program call by call, 0 syncs a "
        f"call: " + json.dumps(rec))
    dsc = counted(f"device_sim_{tag}", lambda: _ds_slices(
        cards, DS_TWIN_SLICES), None)
    _same_tree_np(dsc, one, f"device_sim_{tag}")
    rec = counted(f"device_sim_program_{tag}",
                  lambda: _ds_program(cards, DS_TWIN_SLICES, one), None)
    ref = _ds_program(("cuda:0",), DS_TWIN_SLICES, one)
    log(f"[device_sim_program_{tag}] " + json.dumps(rec) + "; one group "
        f"in this call: first call {ref['ms_first_call']:.3f} ms, a replay "
        f"{ref['ms_replay']:.3f} ms")
    n_shard = serve.MESH["clients"] // MESH_SHARDS
    last = torch.device(cards[-1])
    with torch.cuda.device(0):
        ring = torch.randint(-(1 << 50), 1 << 50, (n_shard, 16),
                             dtype=torch.int64).to(last)
        q0 = torch.randint(0, 16, (n_shard,), dtype=torch.int32).to(last)
        ga, _gc = fp.ring_window_rows(ring, ring, q0, 4)
        keys = torch.randint(-(1 << 60), 1 << 60, (n_shard,),
                             dtype=torch.int64).to(last)
        slot = torch.randint(0, 769, (n_shard,), dtype=torch.int32).to(last)
        got = kernels.wheel_scan(keys, slot, 768)
        torch.cuda.synchronize(last)
    if not torch.equal(ga, fp._ring_window_torch(ring, q0, 4)) or \
            any(not torch.equal(a, b) for a, b in zip(
                got, kernels._wheel_scan_torch(keys, slot, 768))):
        raise AssertionError(f"K1/K2 on {last} differ from the plain "
                             "versions")
    log(f"[mesh_{tag}] the mesh row, the cluster step and the device sim "
        f"over {', '.join(cards)} equal the stacked runs, every mesh.chunk "
        f"and cluster-step leg ran captured, one graph a group a segment, "
        f"and the device sim's program too; K1 and K2 "
        f"launched on {last} with cuda:0 current equal their plain "
        f"versions")


def phase_mesh_groups(ext, fp, kernels, card: str, tmp: str,
                      stacked: dict, sup_ref):
    """Phase 25: the mesh across devices.  Every grouped leg is held bit
    for bit against its stacked one-group twin in this run (phases 22
    and 23 made most of them): (a) bench's mesh row over 8 and 4 groups
    of ``cuda:0`` at K=1, K=4 and under the fault plan, the first chunk
    field by field, the wheel chunk; (b) the supervised mesh over 8
    groups, bare and killed in process at half then resumed on one group; (c)
    the cut dry run over 8 groups; (d) 2 device-sim headline slices on 8
    groups and on 1; (e) on two or more cards, :func:`phase_mesh_cards`.
    Returns ``(K1 by path, K2 by path)``."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    t_phase = time.perf_counter()
    k1, k2 = {}, {}
    c = serve.MESH
    n_shard = c["clients"] // MESH_SHARDS
    counted = _path_counter(ext, k1, k2)

    # (a) the mesh row over groups on one card; phase 29 (b)'s mesh
    # chunks over 8 groups held first, so the 8-group rows replay them
    hk1, hk2, grecs = held_mesh_chunks(ext, serve, "groups")
    k1.update(hk1)
    k2.update(hk2)
    for tag, rec in grecs.items():
        want = stacked["held"][tag.replace("groups", "stacked")]
        log(f"[mesh_groups_program] {tag} on {card}: {rec['legs']} legs "
            f"({', '.join(rec['devices'])}), {rec['legs_a_call']} leg "
            f"replays a call, nodes a leg {rec['graph_nodes'][:2]}, 0 "
            f"syncs a call; replay "
            f"{', '.join(f'{x:.3f}' for x in rec['replay_ms'])} ms, its "
            f"eager body {', '.join(f'{x:.3f}' for x in rec['eager_ms'])}"
            f" ms, the stacked graph "
            f"{', '.join(f'{x:.3f}' for x in want['replay_ms'])} ms "
            f"(nodes {want['graph_nodes']}); first call "
            f"{rec['lower_ms']:.1f} ms warm-up + {rec['compile_ms']:.1f} ms"
            f" capture against {want['lower_ms']:.1f} + "
            f"{want['compile_ms']:.1f} ms")
    for d in GROUP_LAYOUTS:
        _mesh_rows_over(counted, ("cuda:0",) * d, f"groups{d}", stacked,
                        card)
    first = counted("mesh_groups_first", lambda: chunk_numpy(
        groups_gather(mesh_chunk_run(
            None, serve.mesh_job(n_shard), MESH_SHARDS, c["chunk"],
            devices=("cuda:0",) * MESH_SHARDS))),
        MESH_SHARDS * c["chunk"])
    _same_numpy(first, stacked["first"], "mesh_groups_first")
    w = MESH_WHEEL
    per = w["shards"] * w["epochs"] * w["m"]
    wheel = counted("mesh_groups_wheel", lambda: chunk_numpy(groups_gather(
        mesh_chunk_run(None, mesh_wheel_job(), w["shards"], w["epochs"],
                       devices=("cuda:0",) * w["shards"]))),
        per * w["levels"], per * (w["levels"] + 1))
    _same_numpy(wheel, stacked["wheel"], "mesh_groups_wheel")
    red = {d: _reduction_ms(n_shard, ("cuda:0",) * d)
           for d in (1,) + GROUP_LAYOUTS}
    log(f"[mesh_groups] the first chunk over {MESH_SHARDS} groups and the "
        f"wheel chunk over {w['shards']} equal their stacked twins field "
        f"by field; one epoch's counter sum over {n_shard} clients a shard"
        f" on {card} (CUDA events, 200 sums): "
        + ", ".join(f"{d} group{'s' if d > 1 else ''} {ms[0]:.6f} ms "
                    f"back to back ({ms[1]:.6f} ms device time)"
                    for d, ms in red.items()))

    # (b) the supervised mesh over 8 groups, killed and resumed on one
    groups8 = tuple(["cuda:0"] * MESH_SHARDS)
    job8 = TS.EpochJob(**dict(SUP_MESH, devices=groups8))
    res8, l8, wall8 = _sup_run(ext, "supervised_mesh_groups8",
                               lambda: TS.run_job(job8, device="cuda"))
    k1["supervised_mesh_groups8"] = l8["ring_window"]
    TS.assert_crash_equivalent(res8, sup_ref)
    wd = os.path.join(tmp, "groups_kill")
    os.makedirs(wd)
    t0 = time.perf_counter()
    try:
        TS.run_supervised(job8, wd, TH.HostFaultPlan(
            kill_at_decisions=(sup_ref.decisions // 2,)),
            max_restarts=0, device="cuda")
        raise AssertionError("supervised_mesh_groups_kill: no kill")
    except TS.SupervisorGaveUp:
        pass
    killed_s = time.perf_counter() - t0
    job1 = TS.EpochJob(**dict(SUP_MESH, devices=("cuda:0",)))
    res1, l1, wall1 = _sup_run(
        ext, "supervised_mesh_groups_resumed",
        lambda: TS.run_supervised(job1, wd, device="cuda"))
    k1["supervised_mesh_groups_resumed"] = l1["ring_window"]
    TS.assert_crash_equivalent(res1, sup_ref)
    if res1.resumed_from is None:
        raise AssertionError("supervised_mesh_groups_resumed: no resume")
    shutil.rmtree(wd)
    log(f"[supervised_mesh_groups] {SUP_MESH['n_shards']} x "
        f"{SUP_MESH['n']} over {MESH_SHARDS} groups on {card}: wall "
        f"{wall8:.3f} s, crash-equivalent to the stacked bare run; killed"
        f" in process at half ({killed_s:.3f} s), resumed on one group"
        f" from {os.path.basename(res1.resumed_from)} in process ({wall1:.3f}"
        f" s): crash-equivalent")

    # (c) the cut dry run over 8 groups
    mc = counted("multichip_groups8", lambda: serve.multichip_row(
        **MULTICHIP_CUT, devices=groups8), 0, ingests=True)
    for a, b in zip(mc["policies"], stacked["multichip"]["policies"]):
        if a != b:
            raise AssertionError(f"multichip_groups8 {a['tracker']}: "
                                 f"{a} != {b}")
    log(f"[multichip_groups8] the cut dry run over {MESH_SHARDS} groups: "
        f"both trackers equal the stacked run (digests "
        f"{[p['digest'][:16] for p in mc['policies']]})")

    # (d) the device-sim headline's first slices on 8 groups and on 1,
    # op by op and through the program
    one = _ds_slices(("cuda:0",), DS_TWIN_SLICES)
    ds8 = counted("device_sim_groups8", lambda: _ds_slices(
        groups8, DS_TWIN_SLICES), None)
    _same_tree_np(ds8, one, "device_sim_groups8")
    log(f"[device_sim_groups8] {DS_N} clients x 8 servers, "
        f"{DS_TWIN_SLICES} slices over 8 groups equal one group's on "
        f"every field ({int(one['served_resv'].sum() + one['served_prop'].sum())}"
        f" served)")
    rec = counted("device_sim_program_groups8", lambda: _ds_program(
        groups8, DS_TWIN_SLICES, one), None)
    log(f"[device_sim_program_groups8] the program over 8 groups on "
        f"{card}: " + json.dumps(rec))

    # (e) real cards
    count = torch.cuda.device_count()
    d_real = max(d for d in (1, 2, 4, 8) if d <= min(count, 8))
    if d_real < 2:
        log(f"[mesh_cards] not run: {count} CUDA device visible; the mesh "
            f"over real cards needs two or more (the legs above ran the "
            f"same grouped code over cuda:0)")
    else:
        phase_mesh_cards(counted, fp, kernels, card, stacked, one,
                         tuple(f"cuda:{i}" for i in range(d_real)))
    log(f"[time] mesh across devices phase "
        f"{time.perf_counter() - t_phase:.3f} s")
    return {p: n for p, n in k1.items() if n}, \
        {p: n for p, n in k2.items() if n}


# ----------------------------------------------------------------------
# phase 26: migration and the controller over groups, bench's session,
# the silicon gate and the full-scale record
# ----------------------------------------------------------------------

# the migrate rule alone over 8 shards (JAX tests/test_placement.py's
# gate at 8 shards): 64 ids, shard_skew, half of the hot shard's ids
# quiet; at 8 slots a shard a destination grows its capacity
MIG_CTL = dict(sync_max=1, backlog_hi=10 ** 9, occ_lo=0.0, hysteresis=1,
               cooldown=8, migrate_skew_hi=1.5, migrate_pick="cold",
               migrate_max=4)
MIG_JOB = dict(engine="prefix", k=16, select_impl="sort", n=96, depth=6,
               ring=10, epochs=8, m=2, seed=5, arrival_lam=1.0, waves=2,
               ckpt_every=2, engine_loop="mesh", n_shards=8,
               placement="p2c", controller=MIG_CTL)
MIG_SPEC = dict(total_ids=64, seed=3, capacity0=8, n_shards=8,
                cold_frac=0.5, cold_until=10 ** 9)
MIG_WHEEL = dict(engine="calendar", k=4, calendar_impl="wheel",
                 ladder_levels=2)
# bench's pick, firing every other boundary (moves at boundaries 2 and
# 8), 32 slots a shard so nothing grows: the kill at the second firing's
# handoff resumes from the snapshot of boundary 6
MIG_KILL = dict(controller=dict(MIG_CTL, migrate_pick="hot", cooldown=2))
MIG_KILL_CAP0 = 32
# the session's line at --mode all --spans on the card, and its rows'
# keys: bench's lists (bench.py main, bench_churn, bench_mesh,
# bench_mesh_rebalance), with the port's device name
SESSION_LINE_KEYS = {"metric", "value", "unit", "vs_baseline",
                     "conformance", "churn", "device_metrics",
                     "cost_analysis", "bounded_by", "spans", "slo",
                     "provenance", "tardiness_ns", "compile", "capacity",
                     "backend", "device", "fault_plan"}
SESSION_OPTIONAL = {"watchdog_warnings"}
SESSION_BLOCKS = {"cost_analysis": {"serve", "cfg3", "cfg4"},
                  "bounded_by": {"cfg3", "cfg4"},
                  "spans": {"serve", "cfg3", "cfg4"},
                  "slo": {"cfg3", "cfg4", "churn_flash_crowd"},
                  "provenance": {"cfg3", "cfg4"},
                  "tardiness_ns": {"cfg3", "cfg4", "churn_flash_crowd"},
                  "churn": {"churn_flash_crowd"}}
CHURN_ROW_KEYS = {"boost", "bound_class", "boundary_every", "capacity",
                  "compactions", "compile_ms_total", "conformance",
                  "decisions", "digest", "dps", "engine",
                  "epochs", "evictions", "grows", "live_clients",
                  "peak_clients", "projected_hbm_bytes", "qos_updates",
                  "registrations", "retraces", "roofline", "scenario",
                  "slo", "slo_boost_windows",
                  "slo_violations_total", "slo_window_tardiness_p99_ns",
                  "slo_windows_closed", "slo_worst_share_err",
                  "slot_recycles", "tardiness_max_ns", "tardiness_mean_ns",
                  "tardiness_p50_ns", "tardiness_p90_ns",
                  "tardiness_p99_ns", "total_ids", "wall_s"}
MESH_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "mesh", "compile",
                  "mesh_rebalance", "capacity", "backend", "device",
                  "fault_plan"}
MESH_ROW_KEYS = {"clients_per_shard", "clients_total",
                 "collective_skipping", "counter_bytes_per_epoch",
                 "counter_bytes_per_sync", "counter_sync_every",
                 "counter_syncs", "counter_view_bytes_per_epoch",
                 "decisions", "dps", "dps_per_shard", "dps_per_shard_max",
                 "dps_per_shard_mean", "dps_per_shard_min", "engine",
                 "engine_loop", "epochs", "fault_plan", "n_shards",
                 "projected_hbm_bytes_per_shard", "stream_chunk", "wall_s",
                 "workload"}
# the planner's budget keys, which a mesh row carries where the card
# reports its memory (``plan_mesh_shards``), and the layout's
MESH_PLAN_KEYS = {"shards_planned", "max_clients_per_shard",
                  "hbm_budget_bytes"}
MESH_LAYOUT_KEYS = {"devices", "n_groups"}
REBAL_ROW_KEYS = {"ckpt_every", "controller_knobs", "decisions_off",
                  "decisions_on", "dps", "dps_off", "dps_on", "engine",
                  "engine_loop", "epochs", "migration_log", "migrations",
                  "n_shards", "placement", "placement_counters",
                  "rebalance", "recovered_decisions", "recovered_dps",
                  "scenario", "shard_decisions_off", "shard_decisions_on",
                  "shard_skew_after", "shard_skew_before",
                  "shard_skew_final", "shard_skew_recovered", "total_ids",
                  "wall_s_off", "wall_s_on", "workload"}
# the compile plane's totals (bench's ``compile`` block), the cost
# counter's keys and the roofline's verdicts
COMPILE_TOTALS = {"entries", "compiles", "retraces", "lower_ms_total",
                  "compile_ms_total", "dispatch_fallbacks"}
COST_KEYS = {"flops", "bytes_accessed", "transcendentals"}
BOUND_CLASSES = {"compute_bound", "memory_bound", "dispatch_bound",
                 "unknown"}
# the session's mesh: bench's rebalance shape (4 shards), one shard a
# group of cuda:0
SESSION_MESH_SHARDS = 4
# the full-scale record's acceptance config, cut in depth: 100 ops a
# client of 2,000 (400 decisions), and the dry run at the CPU tests'
# width (8 servers x 60 clients, 64 decisions a step)
FULLSCALE_OPS = 100
FULLSCALE_DRYRUN = dict(clients=60, k=64)


def _session(root: str, args: list, out: str) -> subprocess.Popen:
    """``python -m dmclock_tpu_torch.bench`` with ``args``, its stdout to
    ``out`` and its stderr to ``out.err``."""
    with open(out, "w") as fo, open(out + ".err", "w") as fe:
        return subprocess.Popen(
            [sys.executable, "-m", "dmclock_tpu_torch.bench", *args],
            cwd=root, stdout=fo, stderr=fe)


def _script_proc(root: str, script: str, args: list,
                 out: str) -> subprocess.Popen:
    with open(out, "w") as fo, open(out + ".err", "w") as fe:
        return subprocess.Popen(
            [sys.executable, os.path.join(root, "scripts", script), *args],
            cwd=root, stdout=fo, stderr=fe)


def _finished(proc: subprocess.Popen, out: str, what: str, t0: float,
              rc: int = 0) -> list:
    """Wait for ``proc``; its stdout lines.  Raises with its stderr's
    tail unless it exited with ``rc`` (any non-zero when ``rc`` is
    None)."""
    got = proc.wait(timeout=900)
    with open(out) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    ok = got != 0 if rc is None else got == rc
    if not ok:
        with open(out + ".err", errors="replace") as f:
            raise AssertionError(f"{what}: rc {got}, want "
                                 f"{'non-zero' if rc is None else rc}:\n"
                                 f"{f.read()[-4000:]}")
    log(f"[{what}] rc {got} after {time.perf_counter() - t0:.3f} s")
    return lines


def _migration_groups(ext, card: str, tmp: str, root: str, rebal4,
                      k1: dict, k2: dict):
    """Phase 26 (a): live migration and the controller over groups of
    ``cuda:0``, each leg held to its stacked twin."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.lifecycle import make_spec
    from dmclock_tpu_torch.parallel import groups
    from dmclock_tpu_torch.robust import host_faults as TH
    from dmclock_tpu_torch.robust import supervisor as TS

    def job(over=None, devices=None, cap0=MIG_SPEC["capacity0"]):
        spec = make_spec("shard_skew", **dict(MIG_SPEC, capacity0=cap0))
        kw = dict(MIG_JOB, **(over or {}))
        if devices is not None:
            kw["devices"] = devices
        return TS.EpochJob(churn=spec, **kw)

    # bench's mesh_rebalance row (4 shards) over 4 and 2 groups against
    # phase 24's stacked row
    for d in (4, 2):
        row, _ = _counted(ext, f"mesh_rebalance_groups{d}", lambda: serve
                          .mesh_rebalance_row(device="cuda",
                                              devices=("cuda:0",) * d),
                          k1, k2)
        _same_row(row, rebal4, f"mesh_rebalance over {d} groups")
        log(f"[mesh_rebalance_groups{d}] {row['migrations']} migrations, "
            f"skew {row['shard_skew_before']:.4f} -> "
            f"{row['shard_skew_after']:.4f}: every key but the walls equal "
            f"to the stacked row")

    # the supervised p2c job, prefix (a destination grows) and wheel
    rebuild = groups.rebuild
    grows = []

    def spy(*a, **kw):
        grows.append(1)
        return rebuild(*a, **kw)

    for eng, over, wheel in (("prefix", None, False),
                             ("wheel", MIG_WHEEL, True)):
        ref, _ = _counted(ext, f"migration_{eng}8", lambda: TS.run_job(
            job(over), device="cuda"), k1, k2, k2=wheel)
        if ref.migrations <= 0:
            raise AssertionError(f"migration_{eng}8: no migration")
        for d in GROUP_LAYOUTS:
            grows.clear()
            groups.rebuild = spy
            try:
                got, _ = _counted(
                    ext, f"migration_{eng}8_groups{d}", lambda: TS.run_job(
                        job(over, devices=("cuda:0",) * d), device="cuda"),
                    k1, k2, k2=wheel)
            finally:
                groups.rebuild = rebuild
            _same_result(got, ref, f"migration_{eng}8 over {d} groups")
            if eng == "prefix" and not grows:
                raise AssertionError(f"migration_{eng}8 over {d} groups: "
                                     f"no destination grew")
        log(f"[migration_{eng}8] {ref.migrations} moves "
            f"{ref.migration_log} over 8 shards: over 8 and 4 groups of "
            f"cuda:0 every result field equal to the stacked run (digest "
            f"{ref.digest[:16]}, state {ref.state_digest[:16]}, "
            f"placement counters {ref.placement_counters})"
            + ("; a destination grew every shard of every group to one "
               "capacity" if eng == "prefix" else ""))

    # a spawn child over 8 groups SIGKILLed at the second firing's
    # handoff, resumed on one group in process
    kref, _ = _counted(ext, "migration_kill_ref", lambda: TS.run_job(
        job(MIG_KILL, cap0=MIG_KILL_CAP0), device="cuda"), k1, k2)
    wd = os.path.join(tmp, "migration_kill")
    os.makedirs(wd)
    job8 = job(MIG_KILL, devices=("cuda:0",) * 8, cap0=MIG_KILL_CAP0)
    with open(os.path.join(wd, TS.JOB_FILE), "w") as fh:
        json.dump({"job": job8.to_json(), "plan": TH.plan_to_json(None),
                   "device": "cuda", "spawned_ns": time.time_ns()}, fh)
    code = ("import os, signal, sys\n"
            f"sys.path.insert(0, {root!r})\n"
            "from dmclock_tpu_torch.lifecycle import placement as P\n"
            "from dmclock_tpu_torch.robust import supervisor as S\n"
            "seen = []\n"
            "def hook(stage):\n"
            "    if stage == 'handoff':\n"
            "        seen.append(stage)\n"
            "        if len(seen) == 2:\n"
            "            os.kill(os.getpid(), signal.SIGKILL)\n"
            "P._migrate_hook = hook\n"
            f"sys.exit(S._child_main({wd!r}))\n")
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", code], cwd=root,
                           capture_output=True, text=True, timeout=300)
    killed_s = time.perf_counter() - t0
    if child.returncode != -9:
        raise AssertionError(f"migration_kill: the child exited "
                             f"{child.returncode}, not SIGKILLed:\n"
                             f"{child.stderr[-3000:]}")
    res, _ = _counted(ext, "migration_kill_resumed", lambda: TS
                      .run_supervised(job(MIG_KILL, devices=("cuda:0",),
                                          cap0=MIG_KILL_CAP0), wd,
                                      device="cuda"), k1, k2)
    TS.assert_crash_equivalent(res, kref)
    if res.resumed_from is None or res.migration_log != kref.migration_log:
        raise AssertionError(f"migration_kill: resumed from "
                             f"{res.resumed_from}, log {res.migration_log}")
    shutil.rmtree(wd)
    log(f"[migration_kill] a spawn child over 8 groups SIGKILLed at its "
        f"second handoff ({killed_s:.3f} s), resumed on one group from "
        f"{os.path.basename(res.resumed_from)}: crash-equivalent to the "
        f"bare run ({kref.migrations} moves, {kref.migration_log})")

    count = torch.cuda.device_count()
    d_real = max(d for d in (1, 2, 4, 8) if d <= min(count, 8))
    if d_real < 2:
        log(f"[migration_cards] not run: {count} CUDA device visible; the "
            f"legs over real cards need two or more (the legs above ran "
            f"the same grouped code over cuda:0)")
    else:
        cards = tuple(f"cuda:{i}" for i in range(d_real))
        d4 = min(d_real, 4)
        row, _ = _counted(ext, f"mesh_rebalance_cards{d4}", lambda:
                          serve.mesh_rebalance_row(device="cuda",
                                                   devices=cards[:d4]),
                          k1, k2)
        _same_row(row, rebal4, f"mesh_rebalance over {d4} cards")
        for eng, over, wheel in (("prefix", None, False),
                                 ("wheel", MIG_WHEEL, True)):
            ref = TS.run_job(job(over), device="cuda")
            got, _ = _counted(ext, f"migration_{eng}8_cards{d_real}",
                              lambda: TS.run_job(job(over, devices=cards),
                                                 device="cuda"),
                              k1, k2, k2=wheel)
            _same_result(got, ref, f"migration_{eng}8 over {d_real} cards")
        log(f"[migration_cards] over {', '.join(cards)}: mesh_rebalance "
            f"and both migration jobs equal the stacked runs")


def _check_session_line(line: dict, refs: dict, srow: dict, table: str,
                        ref_table: str) -> None:
    """Phase 26 (b): the ``--mode all`` line against bench's key lists,
    and its rows' exact fields against this run's rows in process
    (``refs``: churn, cfg3, cfg4; ``srow`` a ``serve_row``); ``table``
    is the session's cfg4 conformance table, ``ref_table`` the row's."""
    keys = set(line) - SESSION_OPTIONAL
    if keys != SESSION_LINE_KEYS:
        raise AssertionError(f"session_all: keys differ from bench's: "
                             f"{sorted(keys ^ SESSION_LINE_KEYS)}")
    for block, want in SESSION_BLOCKS.items():
        if set(line[block]) != want:
            raise AssertionError(f"session_all: {block} has "
                                 f"{sorted(line[block])}")
    rows = {"serve", "cfg3", "cfg4", "churn_flash_crowd"}
    cap = line["capacity"]
    # the rows' programs are captured once at their full shapes; the
    # churn row's two programs, the ingest step and the guarded epoch,
    # are each captured again when its capacity moves (a new N, a
    # retrace as in the JAX package), no more often than it grows or
    # compacts
    churn_row = line["churn"]["churn_flash_crowd"]
    moves = churn_row["grows"] + churn_row["compactions"]
    if any(set(cap.get(f, {})) != rows for f in (
            "projected_hbm_bytes", "bound_class", "compile_ms_total",
            "retraces")) or not set(cap["bound_class"].values()) <= \
            BOUND_CLASSES or any(cap["retraces"][r] != 0 for r in (
                "serve", "cfg3", "cfg4")) or \
            not 0 <= cap["retraces"]["churn_flash_crowd"] <= 2 * moves:
        raise AssertionError(f"session_all: capacity {cap}")
    comp = line["compile"]
    if set(comp) != COMPILE_TOTALS or comp["compiles"] <= 0 or \
            comp["dispatch_fallbacks"] != 0 or \
            comp["retraces"] != cap["retraces"]["churn_flash_crowd"]:
        raise AssertionError(f"session_all: compile {comp}")
    for wl, ca in line["cost_analysis"].items():
        if set(ca) != COST_KEYS or ca["bytes_accessed"] <= 0:
            raise AssertionError(f"session_all: cost_analysis {wl} {ca}")
    churn = line["churn"]["churn_flash_crowd"]
    if set(churn) != CHURN_ROW_KEYS:
        raise AssertionError(f"session_all: churn row keys "
                             f"{sorted(set(churn) ^ CHURN_ROW_KEYS)}")
    if line["backend"] != "gpu" or \
            line["device"] != torch.cuda.get_device_name(0) or \
            line["vs_baseline"] != round(line["value"] / 1e7, 4) or \
            f"cfg4 100k-client Zipf resv-constrained " \
            f"{line['value'] / 1e6:.1f}M" not in line["metric"]:
        raise AssertionError(f"session_all: backend {line['backend']}, "
                             f"device {line['device']}, value "
                             f"{line['value']}, vs_baseline "
                             f"{line['vs_baseline']}")
    _same_row(churn, {k: v for k, v in refs["churn"].items()
                      if k != "_hist_block"}, "session churn row")
    for wl in ("cfg3", "cfg4"):
        row = refs[wl]
        got = {"slo": line["slo"][wl],
               "cost_analysis": line["cost_analysis"][wl],
               "provenance": line["provenance"][wl],
               "bounded_by": line["bounded_by"][wl],
               "projected_hbm_bytes":
                   line["capacity"]["projected_hbm_bytes"][wl],
               **{f"tardiness_{q}_ns": line["tardiness_ns"][wl][q]
                  for q in ("p50", "p90", "p99", "mean", "max")}}
        for key, value in got.items():
            if row[key] != value:
                raise AssertionError(f"session {wl}: {key} "
                                     f"{str(value)[:200]} vs the row in "
                                     f"process {str(row[key])[:200]}")
    if line["conformance"] != refs["cfg4"]["conformance"] or \
            line["device_metrics"] != refs["cfg4"]["device_metrics"]:
        raise AssertionError("session cfg4: conformance or device_metrics "
                             "differ from the row in process")
    with open(table, "rb") as f1, open(ref_table, "rb") as f2:
        if f1.read() != f2.read():
            raise AssertionError("session cfg4: the conformance table "
                                 "differs from the row in process")
    serve_clause = line["metric"].split("serve-only ")[1].split(";")[0]
    if f"(fill {srow['fill']:.2f})" not in serve_clause or \
            line["capacity"]["projected_hbm_bytes"]["serve"] != \
            srow["projected_hbm_bytes"] or \
            line["cost_analysis"]["serve"] != srow["cost_analysis"]:
        raise AssertionError(f"session serve: fill {srow['fill']}, its "
                             f"projected bytes or its cost_analysis "
                             f"differ")


def phase_session(ext, card: str, root: str, tmp: str, refs: dict):
    """Phase 26: (a) migration and the controller over groups
    (:func:`_migration_groups`); (b) bench's session, ``python -m
    dmclock_tpu_torch.bench --mode all --cut-depth --spans`` at bench's
    card shapes, its line's keys against bench's lists and its rows'
    exact fields against the same rows run in this process; then
    ``--mode mesh --rebalance on`` over 4 groups of ``cuda:0`` and
    ``--device cuda:99``, which must fail; (c) the silicon gate
    (``scripts/torch_silicon_parity.py``); (d) the full-scale record
    (``scripts/torch_run_fullscale.py --record``) on
    ``dmc_sim_example.conf`` cut in depth.  The sessions, (c) and (d)
    run as children beside (a), so their rates are not judged here.
    ``refs`` holds this run's rows of phases 14, 16,
    19 and 24 where they ran; a missing one is run here.  Returns
    ``({path: K1}, {path: K2})``."""
    import importlib.util

    from dmclock_tpu_torch import bench as tbench
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.obs.spans import SpanTracer

    if tbench.CUT_DEPTH["cfg3"] != {k: v for k, v in ROW_CUT["cfg3"]
                                    .items() if v} or \
            tbench.CUT_DEPTH["cfg4"] != ROW_CUT["cfg4"]:
        raise AssertionError("the session's --cut-depth is not ROW_CUT")
    t_phase = time.perf_counter()
    k1, k2 = {}, {}
    if refs.get("rebal") is None:
        refs["rebal"], _ = _counted(ext, "mesh_rebalance", lambda: serve
                                    .mesh_rebalance_row(device="cuda"),
                                    k1, k2)
    conf = os.path.join(tmp, "dmc_sim_example_cut.conf")
    with open(os.path.join(root, "configs", "dmc_sim_example.conf")) as f:
        text = f.read()
    with open(conf, "w") as f:
        f.write(text.replace("client_total_ops = 2000",
                             f"client_total_ops = {FULLSCALE_OPS}"))
    paths = {k: os.path.join(tmp, f"session_{k}.out")
             for k in ("parity", "fullscale", "mesh", "bad", "all")}
    parity_json = os.path.join(tmp, "silicon_parity.json")
    record = os.path.join(tmp, "multichip.json")
    c4_table = os.path.join(tmp, "session_cfg4_conformance.jsonl")
    t_bg = time.perf_counter()
    procs = {
        "all": _session(root, ["--mode", "all", "--cut-depth", "--spans",
                               "--conformance-out", c4_table],
                        paths["all"]),
        "parity": _script_proc(root, "torch_silicon_parity.py",
                               ["--out", parity_json], paths["parity"]),
        "fullscale": _script_proc(
            root, "torch_run_fullscale.py",
            ["--record", record, "--configs", conf, "--cluster", "off",
             "--n-devices", str(SESSION_MESH_SHARDS), "--rebalance", "on",
             "--dryrun-clients", str(FULLSCALE_DRYRUN["clients"]),
             "--dryrun-k", str(FULLSCALE_DRYRUN["k"])], paths["fullscale"]),
        "mesh": _session(root, ["--mode", "mesh", "--n-shards",
                                str(SESSION_MESH_SHARDS), "--rebalance",
                                "on", "--devices", ",".join(
                                    ["cuda:0"] * SESSION_MESH_SHARDS)],
                         paths["mesh"]),
        "bad": _session(root, ["--mode", "serve", "--device", "cuda:99"],
                        paths["bad"])}
    try:
        # (a) in this process, beside the children
        t_a = time.perf_counter()
        _migration_groups(ext, card, tmp, root, refs["rebal"], k1, k2)
        log(f"[time] phase 26 (a) {time.perf_counter() - t_a:.3f} s")

        # (c) the silicon gate
        lines = _finished(procs["parity"], paths["parity"],
                          "torch_silicon_parity", t_bg)
        rep = json.loads(lines[-1])
        with open(parity_json) as f:
            if json.load(f) != rep or rep["match"] is not True:
                raise AssertionError(f"silicon parity: {rep}")
        log(f"[silicon_parity] on {rep['device']}: {rep['shapes']}, "
            f"{rep['total_decisions']} decisions bit-exact, "
            f"{rep['wall_s']} s")
        # (d) the full-scale record
        lines = _finished(procs["fullscale"], paths["fullscale"],
                          "torch_run_fullscale", t_bg)
        summary = json.loads(lines[-1])
        spec = importlib.util.spec_from_file_location(
            "torch_run_fullscale",
            os.path.join(root, "scripts", "torch_run_fullscale.py"))
        fs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(fs)
        rec = fs.load_multichip(record)
        if not (summary["ok"] and rec["ok"] and rec["schema"] == 3
                and rec["mesh"] is not None
                and rec["rebalance"] is not None
                and rec["rebalance"]["migrations"] > 0):
            raise AssertionError(f"run_fullscale: {summary}, record "
                                 f"{ {k: rec[k] for k in ('ok', 'rc')} }")
        log(f"[run_fullscale] {summary['checks']}; the schema-v3 record "
            f"reads: mesh {rec['mesh']['n_shards']} shards "
            f"{rec['mesh']['dps']:.1f} decisions/s, rebalance "
            f"{rec['rebalance']['migrations']} migrations, the dry run "
            f"{len(rec['tail'])} characters")
        # (b) the mesh session over 4 groups, and the failing one
        lines = _finished(procs["mesh"], paths["mesh"], "session_mesh",
                          t_bg)
        if len(lines) != 1:
            raise AssertionError(f"session_mesh: {len(lines)} lines")
        line = json.loads(lines[0])
        mesh_keys = set(line["mesh"]) - MESH_PLAN_KEYS
        if set(line) != MESH_LINE_KEYS or \
                mesh_keys != MESH_ROW_KEYS | MESH_LAYOUT_KEYS or \
                set(line["mesh_rebalance"]) != REBAL_ROW_KEYS:
            raise AssertionError(
                f"session_mesh: keys {sorted(set(line) ^ MESH_LINE_KEYS)}, "
                f"mesh row "
                f"{sorted(mesh_keys ^ (MESH_ROW_KEYS | MESH_LAYOUT_KEYS))}, "
                f"rebalance row "
                f"{sorted(set(line['mesh_rebalance']) ^ REBAL_ROW_KEYS)}")
        from dmclock_tpu_torch.obs.registry import MetricsRegistry
        mesh4, _ = _counted(ext, "mesh_session_twin", lambda: serve.mesh_row(
            serve.MESH["clients"], n_shards=SESSION_MESH_SHARDS,
            registry=MetricsRegistry(), device="cuda"), k1, k2)
        _row_same(line["mesh"], mesh4, "session mesh row")
        _same_row(line["mesh_rebalance"], refs["rebal"],
                  "session mesh_rebalance")
        if line["value"] != round(line["mesh"]["dps"], 1) or \
                line["vs_baseline"] != round(line["mesh"]["dps"] / 1e7, 4):
            raise AssertionError(f"session_mesh: value {line['value']}")
        log(f"[session_mesh] --mode mesh --n-shards {SESSION_MESH_SHARDS} "
            f"--rebalance on over {line['mesh']['n_groups']} groups of "
            f"cuda:0: value {line['value']} (the stacked twin "
            f"{mesh4['dps']:.1f}), the mesh row and mesh_rebalance equal "
            f"to the stacked rows in process on every key but the walls")
        lines = _finished(procs["bad"], paths["bad"], "session_cuda99",
                          t_bg, rc=None)
        bad = json.loads(lines[-1])
        if bad["value"] != 0.0 or "error" not in bad:
            raise AssertionError(f"session --device cuda:99: {bad}")
        log(f"[session_cuda99] exits non-zero after its line: "
            f"{bad['error'][:120]}")

        # (b) the whole session
        lines = _finished(procs["all"], paths["all"], "session_all", t_bg)
        all_s = time.perf_counter() - t_bg
        if len(lines) != 1:
            raise AssertionError(f"session_all: {len(lines)} stdout lines")
        line = json.loads(lines[0])
        # the rows in this process the line is held to
        if refs.get("churn") is None:
            refs["churn"], _ = _counted(ext, "churn_session_twin", lambda:
                                        serve.churn_row(CHURN_SCENARIO,
                                                        tracer=SpanTracer(),
                                                        device="cuda"),
                                        k1, k2)
        for wl in ("cfg3", "cfg4"):
            if refs.get(wl) is None:
                _, refs[wl] = phase_row(serve, ext, card, wl,
                                        N_CFG3 if wl == "cfg3" else N_CFG4,
                                        tmp)
        srow, _ = _counted(ext, "serve_row_session_twin", lambda: serve
                           .serve_row(**tbench.CUT_DEPTH["serve"],
                                      device="cuda"), k1, k2)
        _check_session_line(line, refs, srow, c4_table,
                            os.path.join(tmp, "cfg4_conformance.jsonl"))
        log(f"[session_all] python -m dmclock_tpu_torch.bench --mode all "
            f"--cut-depth --spans on {card} in {all_s:.3f} s beside the "
            f"other legs (its rates are not judged): value "
            f"{line['value']} (cfg4), vs_baseline {line['vs_baseline']}; "
            f"{line['metric'].split(' -- ')[1]}")
        log(f"[session_all] cost_analysis {json.dumps(line['cost_analysis'])}"
            f"; compile {json.dumps(line['compile'])}; capacity "
            f"{json.dumps(line['capacity'])}")
        log(f"[session_all] the line's keys and every block's rows are "
            f"bench's; churn, cfg3 and cfg4 equal this run's rows in "
            f"process on every key but the walls (cfg4's conformance table "
            f"byte for byte), serve's fill and bytes equal a serve_row in "
            f"process (its dps {srow['dps']:.1f}, reps {srow['reps']}); "
            f"watchdog warnings {len(line.get('watchdog_warnings', []))}")
        log(f"[time] phase 26: (a) with (b), (c) and (d) beside it, the "
            f"--mode all session {all_s:.3f} s")
    finally:
        for p in procs.values():
            _stop(p)
    log(f"[time] session phase {time.perf_counter() - t_phase:.3f} s")
    return {p: n for p, n in k1.items() if n}, \
        {p: n for p, n in k2.items() if n}


# ----------------------------------------------------------------------
# phase 27: the sweeps at full width
# ----------------------------------------------------------------------

SWEEP_SERIAL_STEPS = 256       # the regime rows' serial floor (4,096 cut)
SWEEP_KM_POINT = ((98304, 64, 384),)   # the k/m grid's largest point
SWEEP_KM_REPS = 1
# fields no epoch writes (fastpath._EPOCH_INVARIANT's rings): left out of
# the twin comparison, which would otherwise ship 0.4 GB a state
SWEEP_SKIP = ("q_arrival", "q_cost")


def _sweeps_module(root: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_run_sweeps", os.path.join(root, "scripts",
                                         "torch_run_sweeps.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _epoch_numpy(ep) -> dict:
    """A prefix or calendar epoch's outputs and state as host numpy, the
    rings left out (``SWEEP_SKIP``)."""
    out = {}
    for f in ep._fields:
        v = getattr(ep, f)
        if torch.is_tensor(v):
            out[f] = v.cpu().numpy()
        elif f == "state":
            out.update({f"state.{g}": getattr(v, g).cpu().numpy()
                        for g in v._fields if g not in SWEEP_SKIP})
    return out


def sweep_first_epochs(sw, device) -> dict:
    """The first epoch of each Allow row and of the calendar grid's
    first point, at the script's full shapes, as host numpy."""
    al, cal = sw.FULL["allow"], sw.FULL["calendar"]
    out = {}
    ep = sw.scan_prefix_epoch(sw.limited_state(al["n"], al["depth"], device),
                              0, al["m"], al["k"], anticipation_ns=0,
                              allow_limit_break=True)
    out["allow_sorted"] = _epoch_numpy(ep)
    del ep
    ep = sw.scan_calendar_epoch(
        sw.limited_state(al["n"], al["depth"], device), 0, al["cal_m"],
        steps=al["cal_steps"], anticipation_ns=0, allow_limit_break=True)
    out["allow_calendar"] = _epoch_numpy(ep)
    del ep
    m, steps, _ = cal["points"][0]
    ep = sw.scan_calendar_epoch(
        sw._preloaded_state(cal["n"], cal["depth"], ring=cal["depth"],
                            device=device), 0, m, steps=steps,
        anticipation_ns=0)
    out["calendar"] = _epoch_numpy(ep)
    return out


def sweep_twins(root: str, out: str) -> None:
    """Phase 27's CPU runs (in a child process): the first epochs of
    :func:`sweep_first_epochs` on the CPU; saved to ``out``."""
    torch.set_num_threads(4)
    torch.save(sweep_first_epochs(_sweeps_module(root), "cpu"), out)


def start_sweep_twins(root: str, out: str) -> subprocess.Popen:
    code = ("import sys\n"
            f"sys.path.insert(0, {root!r})\n"
            "import chip_smoke\n"
            f"chip_smoke.sweep_twins({root!r}, {out!r})\n")
    return _cpu_child(code, out)


def phase_sweeps(ext, fp, cases, card: str, root: str, tmp: str):
    """Phase 27 (the module docstring).  Returns ``(K1 launches by path,
    K1's max abs error at the sweep shapes, the sweep shapes' timings)``."""
    t_phase = time.perf_counter()
    twin_out = os.path.join(tmp, "sweep_twins.pt")
    twin = start_sweep_twins(root, twin_out)
    try:
        sw = _sweeps_module(root)
        full = sw.FULL
        torch.cuda.synchronize()
        ext.reset_launches()
        first = sweep_first_epochs(sw, "cuda")
        torch.cuda.synchronize()
        by_path = {"sweep_twin_epochs": ext.LAUNCHES["ring_window"]}
        want = 1 + full["allow"]["cal_m"] + full["calendar"]["points"][0][0]
        if launched(ext) != {"ring_window": want, "wheel_scan": 0}:
            raise AssertionError(f"the sweeps' first epochs launched "
                                 f"{launched(ext)}, want K1 {want}")
        lb = int(first["allow_sorted"]["lb"].sum())
        log(f"[sweeps] first epochs on {card}: Allow sorted "
            f"{int(first['allow_sorted']['count'].sum())} decisions "
            f"({lb} limit-breaks), Allow calendar "
            f"{int(first['allow_calendar']['count'].sum())}, calendar "
            f"(4, 8) {int(first['calendar']['count'].sum())}; K1 {want}")
        if not lb:
            raise AssertionError("the sorted Allow epoch broke no limit")

        gen = torch.Generator(device="cuda").manual_seed(27)
        max_err = max(_k1_check(fp, gen, n, q, w)
                      for n, q, w in cases.RING_SWEEP_SHAPES)
        timings = {(n, q, w): _k1_time(fp, gen, n, q, w, card)
                   for n, q, w in cases.RING_SWEEP_SHAPES}
        torch.cuda.empty_cache()

        def counted(what: str, want: int, fn):
            torch.cuda.synchronize()
            ext.reset_launches()
            t0 = time.perf_counter()
            rows = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = launched(ext)
            log(f"[{what}] {secs:.3f} s, kernel launches {got}")
            if got != {"ring_window": want, "wheel_scan": 0}:
                raise AssertionError(f"{what} launched {got}, want K1 "
                                     f"{want} and no K2")
            by_path[what] = want
            torch.cuda.empty_cache()
            return rows

        al = full["allow"]
        rows = counted(
            "sweep_allow", 1 + al["sorted_epochs"] + 1
            + al["cal_m"] * (1 + al["cal_epochs"]),
            lambda: sw.tpu_allow_regime_row(**al, device="cuda"))
        for name, dps, fired, total in rows:
            log(f"[sweep_allow] {name} on {card}: {dps:.1f} decisions/s, "
                f"{total} decisions, limit-breaks fired {fired}")
            if not fired or not total:
                raise AssertionError(f"{name}: no limit-break fired")
        cal = full["calendar"]
        rows = counted(
            "sweep_calendar",
            sum(m * (1 + e) for m, _, e in cal["points"]),
            lambda: sw.tpu_calendar_sweep(**cal, device="cuda"))
        for m, steps, dps, total in rows:
            log(f"[sweep_calendar] m={m} steps={steps} on {card}: "
                f"{dps:.1f} decisions/s, {total} decisions")
        rg = dict(full["regime"], serial_steps=SWEEP_SERIAL_STEPS)
        lo = sw.lo_epochs(rg["epochs"], rg["k"], rg["m"],
                          rg["lo_decisions"])
        rows = counted(
            "sweep_regime", 2 * rg["reps"] * (1 + lo + max(rg["epochs"],
                                                           lo + 1))
            + 1 + rg["epochs"],
            lambda: sw.tpu_regime_sweep(**rg, device="cuda"))
        for name, dps, fill in rows:
            log(f"[sweep_regime] {name} on {card}: {dps:.1f} decisions/s, "
                f"fill {fill:.6f}")
        log(f"[sweep_regime] the serial floor ran {SWEEP_SERIAL_STEPS} "
            f"steps twice (cut from the script's 4,096)")
        km = dict(full["km"], grid=SWEEP_KM_POINT, reps=SWEEP_KM_REPS)
        want_km = 0
        for k, m, _ in km["grid"]:
            hi = max(2, km["chain_decisions"] // (m * k))
            lo = sw.lo_epochs(hi, k, m, km["lo_decisions"])
            want_km += km["reps"] * (1 + lo + max(hi, lo + 1))
        rows = counted("sweep_km", want_km,
                       lambda: sw.tpu_km_sweep(**km, device="cuda"))
        for k, m, dps, fill in rows:
            log(f"[sweep_km] k={k} m={m} ring {km['grid'][0][2]} on "
                f"{card}: {dps:.1f} decisions/s, fill {fill:.6f} "
                f"({km['reps']} rep)")

        want = collect_cpu_twins(twin, twin_out)
        for key, got in first.items():
            _same_numpy(got, want[key], f"sweep {key} vs its CPU twin")
        log("[sweeps] the first epochs of both Allow rows and of the "
            "calendar grid's first point equal the CPU twin's on every "
            "output and state field (the rings, which no epoch writes, "
            "left out)")
    finally:
        _stop(twin)
    log(f"[time] sweeps phase {time.perf_counter() - t_phase:.3f} s")
    return by_path, max_err, timings


# ----------------------------------------------------------------------
# phase 28: the capacity plane's time axis (build records, cost counts)
# ----------------------------------------------------------------------

# (b): one serve epoch counted on the card and on the CPU
COST_SHAPE = dict(n=4096, ring=320, m=4, k=1024)
PROFILE_K = 49152              # the component profile's k


def _module(root: str, name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _count_epoch(fp, serve, device: str) -> tuple:
    """Phase 28 (b): one serve epoch at ``COST_SHAPE`` under the cost
    counter: ``(totals, ops, decisions)``."""
    from dmclock_tpu_torch.obs.compile_plane import CostCounter

    c = COST_SHAPE
    st = serve._preloaded_state(c["n"], c["ring"], ring=c["ring"],
                                device=device)
    with CostCounter() as counter:
        ep = fp.scan_prefix_epoch(st, 0, c["m"], c["k"], anticipation_ns=0,
                                  with_metrics=True)
    return counter.cost_analysis(), counter.ops(), int(ep.count.sum())


def _event_ms(fn, reps: int = 2) -> float:
    """Median CUDA-event ms of ``fn()`` (a launch of a row's program)."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def phase_costs(ext, fp, card: str, root: str, rows: dict,
                wheel_row: dict):
    """Phase 28: (a) this process's build record from the compile plane;
    (b) one serve epoch at ``COST_SHAPE`` counted on the card and on the
    CPU, every total equal (the ops that differ printed on a failure),
    and K1's recorded bytes equal to the formula its bound reads; (c) the
    full-width counts: a ``serve_row`` with spans, phase 16's cfg3 and
    cfg4 rows and phase 8's cfg4_wheel round, each row's
    ``cost_analysis``, ``roofline`` and ``bound_class``, and its bytes a
    launch over its device ms a launch (the spans' and CUDA events')
    against ``MEM_RATE``; (d) the component profile's five rows
    (``scripts/torch_profile_fastpath.py``) at full width, one
    differenced pair each.  Returns ``({path: K1}, {path: K2})``."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.obs import capacity as obscap
    from dmclock_tpu_torch.obs import compile_plane
    from dmclock_tpu_torch.obs.spans import SpanTracer

    t_phase = time.perf_counter()
    k1, k2 = {}, {}
    # (a) the build record
    pl = compile_plane.plane()
    tot = pl.totals()
    builds = [e for e in pl.entries() if e["cache"] == ext.CACHE]
    if not builds or any(e["retraces"] for e in builds) or \
            tot["dispatch_fallbacks"] != 0:
        raise AssertionError(f"compile plane: {tot}")
    by_cache = {}
    for e in pl.entries():
        if e["cache"] != ext.CACHE:
            c = by_cache.setdefault(e["cache"], [0, 0, 0])
            c[0] += 1
            c[1] += e["compiles"]
            c[2] += e["retraces"]
    log(f"[costs] (a) the compile plane in this process: {json.dumps(tot)}"
        + "".join(f"; {e['entry']}: nvcc ran {e['compiles']} time(s), a "
                  f"current library was found {e['found']} time(s), "
                  f"compile {e['compile_ms']:.3f} ms, source hash and "
                  f"lookup {e['lower_ms']:.3f} ms" for e in builds)
        + "; captured programs (entries, captures, retraces) by cache: "
        + json.dumps(by_cache))

    # (b) the card's count of a serve epoch against the CPU's
    torch.cuda.synchronize()
    ext.reset_launches()
    card_tot, card_ops, card_dec = _count_epoch(fp, serve, "cuda")
    torch.cuda.synchronize()
    n_k1 = ext.LAUNCHES["ring_window"]
    k1["cost_serve_4096"] = n_k1
    cpu_tot, cpu_ops, cpu_dec = _count_epoch(fp, serve, "cpu")
    diff = {op: (card_ops.get(op), cpu_ops.get(op))
            for op in sorted(set(card_ops) | set(cpu_ops))
            if card_ops.get(op) != cpu_ops.get(op)}
    if card_tot != cpu_tot or card_dec != cpu_dec:
        raise AssertionError(
            f"phase 28 (b): the card's count {card_tot} ({card_dec} "
            f"decisions) differs from the CPU's {cpu_tot} ({cpu_dec}); "
            f"the ops that differ (card, cpu): {json.dumps(diff)[:6000]}")
    rec = card_ops["kernel:ring_window"]
    w = min(COST_SHAPE["m"], COST_SHAPE["ring"])
    formula = fp.ring_window_cost(COST_SHAPE["n"], w)
    if rec["calls"] != n_k1 or n_k1 < 1 or rec["bytes_accessed"] != \
            n_k1 * formula["bytes_accessed"] or formula["bytes_accessed"] \
            != 2 * (2 * COST_SHAPE["n"] * w * 8) + 4 * COST_SHAPE["n"]:
        raise AssertionError(f"phase 28 (b): K1 recorded {rec} over "
                             f"{n_k1} launches; its bound's formula "
                             f"{formula}")
    log(f"[costs] (b) one serve epoch at {json.dumps(COST_SHAPE)}: the "
        f"card's count equals the CPU's, {json.dumps(card_tot)} "
        f"({card_dec} decisions, {len(card_ops)} ops"
        + (f"; the op tables differ in {json.dumps(diff)[:2000]}"
           if diff else ", the op tables equal") + f"); K1 recorded "
        f"{rec['bytes_accessed']} bytes over {n_k1} launch(es), "
        f"{formula['bytes_accessed']} a launch, the bytes of its bound "
        f"(fastpath.ring_window_cost, which phase 3 reads)")

    # (c) the full-width counts
    def serve_path():
        row = serve.serve_row(reps=1, tracer=SpanTracer(), device="cuda")
        st = serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH,
                                    device="cuda")
        row["event_ms"] = _event_ms(lambda: fp.scan_prefix_epoch(
            st, 0, M_SERVE, K_SERVE, anticipation_ns=0, with_metrics=True))
        return row

    srow, _ = _counted(ext, "cost_serve_row", serve_path, k1, k2)
    wheel = dict(wheel_row)
    wheel["roofline"] = obscap.classify_bench_row(wheel)
    wheel["bound_class"] = wheel["roofline"]["bound_class"]
    table = {"serve": srow, "cfg3": rows["cfg3"], "cfg4": rows["cfg4"],
             "cfg4_wheel": wheel}
    for wl, row in table.items():
        ca = row["cost_analysis"]
        if "error" in ca or set(ca) != COST_KEYS or \
                ca["bytes_accessed"] <= 0 or \
                row["bound_class"] not in BOUND_CLASSES:
            raise AssertionError(f"phase 28 (c) {wl}: cost_analysis {ca}, "
                                 f"bound_class {row.get('bound_class')}")
        sp_ms = row["spans"]["device_ms_per_launch"]
        ev_ms = row.get("event_ms") or row.get("event_round_ms_median")
        rates = "; ".join(
            f"over {what} {ms:.6f} ms a launch "
            f"{ca['bytes_accessed'] / (ms / 1e3):.6g} B/s = "
            f"{ca['bytes_accessed'] / (ms / 1e3) / MEM_RATE:.6f} of "
            f"{MEM_RATE:.3g} B/s"
            for what, ms in (("the spans' device", sp_ms),
                             ("CUDA events'", ev_ms)) if ms)
        log(f"[costs] (c) {wl} on {card}: cost_analysis {json.dumps(ca)}, "
            f"bound_class {row['bound_class']}, roofline "
            f"{json.dumps(row['roofline'])}; "
            f"{ca['bytes_accessed']:.0f} bytes a launch {rates}")
    log(f"[costs] (c) the cfg4_wheel round's count took "
        f"{wheel_row['count_s']:.3f} s (launches {wheel_row['count_launches']})")
    k1["cost_cfg4_wheel"] = wheel_row["count_launches"]["ring_window"]
    k2["cost_cfg4_wheel"] = wheel_row["count_launches"]["wheel_scan"]

    # (d) the component profile, cut to one differenced pair a row
    pf = _module(root, "torch_profile_fastpath")
    peaks = obscap.device_peaks("cuda")
    torch.cuda.synchronize()
    ext.reset_launches()
    comp = pf.component_rows(N_SERVE, PROFILE_K, torch.device("cuda"), peaks,
                             reps=1)
    torch.cuda.synchronize()
    n = launched(ext)
    # the prefetch row: 2 x (64 + 256) steps and its counted step, and
    # the head select's window
    want = {"ring_window": 2 * (pf.IT_LO + pf.IT_HI) + 1 + 1,
            "wheel_scan": 0}
    if n != want or len(comp) != 5:
        raise AssertionError(f"phase 28 (d): launches {n}, want {want}; "
                             f"{len(comp)} rows")
    k1["profile_components"] = n["ring_window"]
    log(f"[costs] (d) the component profile at N={N_SERVE}, k={PROFILE_K} "
        f"on {card} (one pair of {pf.IT_LO} and {pf.IT_HI} steps each): "
        + json.dumps(comp))
    log(f"[time] costs phase {time.perf_counter() - t_phase:.3f} s")
    return k1, k2


# ----------------------------------------------------------------------
# phase 29: captured programs (obs/compile_plane.py)
# ----------------------------------------------------------------------

def _leaves(tree) -> list:
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(tree)


def _clone_tree(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda x: x.clone() if torch.is_tensor(x) else x, tree)


def _same_leaves(got, want, what: str) -> None:
    """Every leaf of two pytrees: tensors equal in dtype, shape and
    value, anything else equal."""
    a, b = _leaves(got), _leaves(want)
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} leaves against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if torch.is_tensor(x) != torch.is_tensor(y):
            raise AssertionError(f"{what}: leaf {i} differs in kind")
        if torch.is_tensor(x):
            if x.dtype != y.dtype or x.shape != y.shape or \
                    not torch.equal(x, y):
                raise AssertionError(f"{what}: leaf {i} differs")
        elif x != y:
            raise AssertionError(f"{what}: leaf {i} {x!r} != {y!r}")


def _legs_capture(name: str, prog, replays: int) -> dict:
    """A grouped program's captures (``compile_plane.StagedJit`` with
    one leg a group, one capture a leg) as one record: the nodes of
    each leg, the legs a call (each replayed ``replays`` times), the
    kernel launches a call, times, segments and bytes summed."""
    caps = prog.captures()
    if len(caps) != len(prog.legs):
        raise AssertionError(f"{name}: {len(caps)} captures for "
                             f"{len(prog.legs)} legs")
    launches, mem = {}, {}
    for c in caps:
        for k, v in c["launches"].items():
            launches[k] = launches.get(k, 0) + replays * v
        for k, v in c["memory_analysis"].items():
            mem[k] = mem.get(k, 0) + v
    return dict(graph_nodes=[c["graph_nodes"] for c in caps],
                legs=len(caps), legs_a_call=replays * len(caps),
                devices=sorted({c["device"] for c in caps}),
                launches=launches, segments=sum(c["segments"] for c in caps),
                child_graphs=sum(c["child_graphs"] for c in caps),
                lower_ms=sum(c["lower_ms"] for c in caps),
                compile_ms=sum(c["compile_ms"] for c in caps),
                memory_analysis=mem)


def _capture_of(name: str, prog, replays: int = 1) -> dict:
    """A program's one capture record; a serial program's blocks (each
    replayed ``replays`` times a call) as one record: nodes a block,
    launches, times and bytes summed; a grouped program's legs
    (:func:`_legs_capture`, each leg ``replays`` times a call)."""
    if getattr(prog, "legs", None):
        return _legs_capture(name, prog, replays)
    caps = prog.captures()
    want = len(getattr(prog, "_parts", ())) or 1
    if len(caps) != want:
        raise AssertionError(f"{name}: {len(caps)} captures, want {want}")
    if len(caps) == 1 and "replays" not in caps[0]:
        return caps[0]
    launches, mem = {}, {}
    for c in caps:
        for k, v in c["launches"].items():
            launches[k] = launches.get(k, 0) + c["replays"] * v
        for k, v in c["memory_analysis"].items():
            mem[k] = mem.get(k, 0) + v
    return dict(graph_nodes=[c["graph_nodes"] for c in caps],
                replays=[c["replays"] for c in caps], launches=launches,
                lower_ms=sum(c["lower_ms"] for c in caps),
                compile_ms=sum(c["compile_ms"] for c in caps),
                memory_analysis=mem)


def _held_program(ext, name: str, prog, calls, first, next_args,
                  replays: int = 1) -> dict:
    """``prog`` replayed on ``calls`` (its first call's arguments) and
    then on each call's successor (``next_args(args, out, i)``: the
    chained state, a new ``now``, ``epoch0`` or draws), each replay held
    bit for bit against the eager body on the same inputs (a grouped
    program's body with its legs run eagerly, ``compile_plane.eager``),
    the kernel launches of the replay and of the eager run counted and
    held equal.
    The first replay's eager run is the first call's warm-up (``first``:
    its result and launches); the others run the body on a clone of
    their inputs, both timed by CUDA events.  Every replay runs under
    ``set_sync_debug_mode("error")``: a synchronising operation raises.
    Returns the program's capture record and timings."""
    from dmclock_tpu_torch.obs import compile_plane

    cap = _capture_of(name, prog, replays)
    grouped = bool(getattr(prog, "legs", None))
    donated = getattr(prog, "donate_argnums", ())
    args = calls
    replay_ms, eager_ms = [], []
    chained = []
    for i in range(3):
        if donated:
            chained.append([t.data_ptr() for j in donated
                            for t in _leaves(args[j]) if torch.is_tensor(t)])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        if i == 0:
            want, eager_n = first
        else:
            ref_in = _clone_tree(args)
            torch.cuda.synchronize()
            ext.reset_launches()
            ev[0].record()
            if grouped:
                with compile_plane.eager():
                    want = prog.fn(*ref_in)
            else:
                want = prog.fn(*ref_in)
            ev[1].record()
            torch.cuda.synchronize()
            eager_n = launched(ext)
            del ref_in
        ext.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ev[2].record()
            got = prog(*args)
            ev[3].record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        replay_n = launched(ext)
        want_n = {k: cap["launches"].get(k, 0) for k in replay_n}
        if replay_n != eager_n or replay_n != want_n:
            raise AssertionError(f"{name} replay {i}: launches {replay_n}, "
                                 f"the eager body {eager_n}, the capture "
                                 f"{cap['launches']}")
        _same_leaves(got, want, f"{name} replay {i} against its eager body")
        if i:
            eager_ms.append(ev[0].elapsed_time(ev[1]))
        replay_ms.append(ev[2].elapsed_time(ev[3]))
        args = next_args(args, got, i)
        del want
    # every call after the first was a replay of the one capture
    _capture_of(name, prog, replays)
    # a donated chain: replays 2 and 3 were handed the buffers replay 1
    # returned, the program's static inputs, so nothing was copied in
    if donated and chained[1] != chained[2]:
        raise AssertionError(f"{name}: a chained replay's donated inputs "
                             f"are not the program's static buffers")
    ents = [e for e in _plane().entries() if e["cache"] == prog.cache and
            e["entry"] == prog.entry]
    rec = dict(graph_nodes=cap["graph_nodes"], launches=cap["launches"],
               **({"replays": cap["replays"]} if "replays" in cap else {}),
               **({k: cap[k] for k in ("legs", "legs_a_call", "devices")}
                  if grouped else {}),
               lower_ms=cap["lower_ms"], compile_ms=cap["compile_ms"],
               memory_analysis=cap["memory_analysis"],
               compiles=ents[0]["compiles"] if ents else None,
               retraces=ents[0]["retraces"] if ents else None,
               retrace_diff=ents[0]["last_retrace_diff"] if ents else None,
               replay_ms=replay_ms, eager_ms=eager_ms)
    log(f"[programs] {name} ({prog.cache} {prog.entry}): "
        + json.dumps(rec))
    return rec


def _plane():
    from dmclock_tpu_torch.obs import compile_plane

    return compile_plane.plane()


def release_programs() -> None:
    """Every captured program's graphs and static buffers dropped and
    the pools returned to the card (the end of a phase that captured)."""
    import gc

    from dmclock_tpu_torch.obs import compile_plane

    compile_plane.clear_compiled()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _program_finisher(ext, k1: dict, k2: dict, recs: dict):
    """``finish(path, name, prog, calls, next_args)``: the program's
    first call (the warm-up, whose result it returns, and the capture),
    launch-counted, its result cloned (a donated output is a static
    buffer the replays rewrite); then :func:`_held_program`; K1 and K2
    of the first call and the 3 replays into ``k1``/``k2`` by path, the
    record into ``recs``."""
    def first_call(prog, calls):
        torch.cuda.synchronize()
        ext.reset_launches()
        out = _clone_tree(prog(*calls))
        torch.cuda.synchronize()
        return out, launched(ext)

    def finish(path, name, prog, calls, nxt, replays=1):
        first = first_call(prog, calls)
        warm = first[1]
        rec = _held_program(ext, name, prog, calls, first, nxt, replays)
        n1 = warm["ring_window"] + 3 * rec["launches"].get("ring_window", 0)
        n2 = warm["wheel_scan"] + 3 * rec["launches"].get("wheel_scan", 0)
        if n1:
            k1[path] = n1
        if n2:
            k2[path] = n2
        recs[name] = rec

    return finish


def phase_programs(serve, ext, card: str) -> tuple:
    """Phase 29: the captured programs at full width, each held bit for
    bit against its eager body over 3 replays with changed inputs (a
    fresh then a chained state, new ``now``/``t_base``/``epoch0``, new
    draws), K1 and K2 counted a replay, 0 synchronising operations (the
    warm-up and every replay under the sync debug mode's errors), the
    capture record, the pool's bytes and replay against eager ms printed:
    ``bench.serve`` (the serve epoch), ``bench.round`` (cfg3, cfg4
    minstop, cfg4_wheel), ``stream.chunk`` (cfg3 8 rounds, cfg4 2) and
    the ingest step; then a body that reads the card back must fail to
    capture, naming its cache and entry.  Returns ``(K1 by path, K2 by
    path, records)``."""
    from dmclock_tpu_torch.engine import fastpath
    from dmclock_tpu_torch.engine import stream as tstream
    from dmclock_tpu_torch.obs import compile_plane

    t_phase = time.perf_counter()
    k1, k2, recs = {}, {}, {}
    rng = np.random.default_rng(29)
    finish = _program_finisher(ext, k1, k2, recs)

    # bench.serve: the serve epoch, the state donated
    knobs = dict(m=M_SERVE, k=K_SERVE, with_metrics=True,
                 select_impl="sort", tag_width=64, window_m=None)
    st = serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH, device="cuda")
    prog = compile_plane.InstrumentedJit(
        functools.partial(fastpath.scan_prefix_epoch, anticipation_ns=0,
                          **knobs),
        cache="bench.serve", entry=(N_SERVE, K_SERVE, M_SERVE, DEPTH,
                                    "sort", 64, None, True),
        donate_argnums=(0,))
    nows = [0, 0, 5_000_000]
    finish("programs_serve", "bench.serve", prog, (st, nows[0]),
           lambda a, out, i: (out.state, nows[min(i + 1, 2)]))
    del st, prog
    release_programs()

    # bench.round: cfg3, cfg4 minstop, cfg4_wheel, state and tele donated
    for name, workload, n, impl in (
            ("bench.round cfg3", "cfg3", N_CFG3, "minstop"),
            ("bench.round cfg4", "cfg4", N_CFG4, "minstop"),
            ("bench.round cfg4_wheel", "cfg4", N_CFG4, "wheel")):
        c = serve.CFG3 if workload == "cfg3" else serve.CFG4
        st = serve.sustained_start(workload, n, device="cuda")
        tele = serve.Tele(
            hists=serve.obshist.hist_zero("cuda"),
            ledger=serve.obshist.ledger_zero(n, "cuda"),
            slo=serve.obsslo.window_zero(n, "cuda"),
            prov=serve.obsprov.prov_init(n, 0, "cuda"))
        lam = serve.sustained_lam0(workload, n)
        draws = [torch.from_numpy(np.minimum(rng.poisson(lam), c["waves"])
                                  .astype(np.int32)).to("cuda")
                 for _ in range(3)]
        dt = c["dt_round_ns"]
        path = "programs_" + name.split()[1]
        entry, body = serve.round_entry(workload, n, c, impl,
                                        telemetry=True, slo=True)
        prog = compile_plane.InstrumentedJit(
            body, cache="bench.round", entry=entry, donate_argnums=(0, 3))
        finish(path, name, prog, (st, draws[0], 0, tele),
               lambda a, out, i: (out.state, draws[min(i + 1, 2)],
                                  (i + 1) * dt, serve._tele_of(out)))
        del st, tele, prog, body, draws
        release_programs()

    # stream.chunk: cfg3 8 rounds and cfg4 2 rounds, donated, as
    # serve.cfg3_stream / cfg4_stream capture them
    for name, workload, n, epochs in (("stream.chunk cfg3", "cfg3", N_CFG3,
                                       serve.STREAM_CHUNK),
                                      ("stream.chunk cfg4", "cfg4", N_CFG4,
                                       2)):
        c = serve.CFG3 if workload == "cfg3" else serve.CFG4
        kw = dict(k=c["k"], select_impl=c["select_impl"]) \
            if workload == "cfg3" else dict(
                k=c["steps"], calendar_impl="minstop",
                ladder_levels=c["ladder_levels"])
        st = serve.sustained_start(workload, n, device="cuda")
        lam = serve.sustained_lam0(workload, n)
        draws = [torch.from_numpy(np.minimum(
            rng.poisson(lam, (epochs, n)), c["waves"]).astype(np.int32))
            .to("cuda") for _ in range(3)]
        h, l = serve.obshist.hist_zero("cuda"), \
            serve.obshist.ledger_zero(n, "cuda")
        sl = serve.obsslo.window_zero(n, "cuda")
        pv = serve.obsprov.prov_init(n, 0, "cuda")
        path = "programs_chunk_" + workload
        fn = tstream.jit_stream_chunk(
            engine="prefix" if workload == "cfg3" else "calendar",
            epochs=epochs, m=c["m"], dt_epoch_ns=c["dt_round_ns"],
            waves=c["waves"], with_metrics=True, donate=True, **kw)
        fn.clear_compiled()
        finish(path, name, fn, (st, 0, draws[0], h, l, None, sl, pv),
               lambda a, out, i: (out.state, (i + 1) * epochs,
                                  draws[min(i + 1, 2)], out.hists,
                                  out.ledger, None, out.slo, out.prov))
        del st, draws, fn
        release_programs()

    # the ingest step (not donated) on cfg4's state
    c = serve.CFG4
    st = serve.sustained_start("cfg4", N_CFG4, device="cuda")
    lam = serve.sustained_lam0("cfg4", N_CFG4)
    draws = [torch.from_numpy(np.minimum(rng.poisson(lam), c["waves"])
                              .astype(np.int32)).to("cuda")
             for _ in range(3)]
    ing = tstream.jit_ingest_step(dt_epoch_ns=c["dt_round_ns"],
                                  waves=c["waves"])
    ing.clear_compiled()
    finish("programs_ingest", "stream.ingest", ing, (st, draws[0], 0),
           lambda a, out, i: (out, draws[min(i + 1, 2)],
                              (i + 1) * c["dt_round_ns"]))
    del st, draws, ing
    release_programs()

    # a body that reads the card back cannot be captured
    def reads_back(x):
        return x + int(x.sum())

    bad = compile_plane.instrumented_jit(reads_back, cache="programs.probe",
                                         entry=("reads_back",))
    try:
        bad(torch.ones(8, dtype=torch.int64, device="cuda"))
    except compile_plane.CaptureError as e:
        if "programs.probe" not in str(e) or "reads_back" not in str(e):
            raise AssertionError(f"a capture failure names neither its "
                                 f"cache nor its entry: {e}")
        log(f"[programs] a body that reads the card back raises at its "
            f"capture: {str(e).splitlines()[0][:200]}")
    else:
        raise AssertionError("a body that reads the card back was "
                             "captured")
    release_programs()
    log(f"[programs] on {card}: K1 by path {json.dumps(k1)}, K2 by path "
        f"{json.dumps(k2)}")
    log(f"[time] programs phase {time.perf_counter() - t_phase:.3f} s")
    return k1, k2, recs


# the serial resume at full width: two blocks and a remainder
SERIAL_STEPS_EXTRA = 17


def held_guarded_epoch(ext, which: str) -> tuple:
    """Phase 29 (b)'s ``guarded.epoch`` at the ``supervised_prefix``
    shape with the five accumulators (``which="prefix"``) or at the
    ``supervised_wheel`` shape (``"wheel"``), held as phase 29 (a) holds
    bench's programs; ``t`` a 0-d tensor as ``run_epoch_guarded`` passes
    it, so a job of that shape run after this replays the capture.
    Returns ``(K1 by path, K2 by path, records)``."""
    from dmclock_tpu_torch.engine import fastpath
    from dmclock_tpu_torch.obs import flight as obsflight
    from dmclock_tpu_torch.obs import histograms as obshist
    from dmclock_tpu_torch.obs import provenance as obsprov
    from dmclock_tpu_torch.obs import slo as obsslo
    from dmclock_tpu_torch.robust import guarded as TG
    from dmclock_tpu_torch.robust import supervisor as TS

    k1, k2, recs = {}, {}, {}
    finish = _program_finisher(ext, k1, k2, recs)
    job = TS.EpochJob(**(SUP_PREFIX if which == "prefix" else SUP_WHEEL))
    st = TS._job_state(job, "cuda")
    kw = fastpath.epoch_scan_kwargs(
        job.engine, k=job.k, calendar_impl=job.calendar_impl,
        ladder_levels=job.ladder_levels, with_metrics=True)
    tele = dict(hists=obshist.hist_zero("cuda"),
                ledger=obshist.ledger_zero(job.n, "cuda"),
                flight=obsflight.flight_init(job.flight_records, "cuda"),
                slo=obsslo.window_zero(job.n, "cuda"),
                prov=obsprov.prov_init(job.n, device="cuda")) \
        if which == "prefix" else {}
    prog = TG._jit_epoch(job.engine, job.m, kw, tuple(sorted(tele)))
    prog.clear_compiled()
    ts = [torch.full((), (i + 1) * job.dt_epoch_ns, dtype=torch.int64,
                     device="cuda") for i in range(3)]
    if tele:
        # the accumulators in the input dict's order, as run_epoch_guarded
        # passes them (a dict's key order is part of a signature)
        calls = (st, ts[0], tele)

        def nxt(a, out, i):
            return (out.state, ts[min(i + 1, 2)],
                    {f: getattr(out, f) for f in tele})
    else:
        calls = (st, ts[0])

        def nxt(a, out, i):
            return (out.state, ts[min(i + 1, 2)])
    finish("programs_guarded_" + which, "guarded.epoch " + which, prog,
           calls, nxt)
    return k1, k2, recs


def held_mesh_chunks(ext, serve, layout: str) -> tuple:
    """Phase 29 (b)'s ``mesh.chunk`` at bench's mesh row (8 x 12,500, a
    chunk of 8) at K=1, K=4 and under ``MESH_FAULT_SPEC``, stacked
    (``layout="stacked"``) or over 8 groups of ``cuda:0``, each held as
    phase 29 (a) holds bench's programs, with the arguments
    ``serve.mesh_row`` passes, so the rows run after this replay these
    captures.  Over groups the chunk is one leg a group, replayed once a
    segment (the epochs between two counter sums).  Returns ``(K1 by
    path, K2 by path, records)``."""
    from dmclock_tpu_torch.parallel import mesh as TM
    from dmclock_tpu_torch.robust import faults as TF

    k1, k2, recs = {}, {}, {}
    finish = _program_finisher(ext, k1, k2, recs)
    rng = np.random.default_rng(292)
    M = serve.MESH
    n = M["clients"] // MESH_SHARDS
    job = serve.mesh_job(n)
    chunk = M["chunk"]
    mesh = TM.make_mesh(MESH_SHARDS, "cuda") if layout == "stacked" \
        else TM.make_mesh(MESH_SHARDS, devices=("cuda:0",) * MESH_SHARDS)
    for tag, every, chaos in (("k1", 1, False), ("k4", 4, False),
                              ("chaos", 1, True)):
        fn = TM.jit_mesh_chunk(
            mesh, engine=M["engine"], epochs=chunk, m=M["m"], k=M["k"],
            dt_epoch_ns=M["dt_epoch_ns"], waves=M["waves"],
            with_metrics=True, counter_sync_every=every, ingest=True,
            with_faults=chaos, collective_skipping=not chaos and every > 1)
        fn.clear_compiled()
        state, cd, cr, vd, vr, w = serve.mesh_start(job, MESH_SHARDS, "cuda",
                                                    mesh)
        draws = [TM.place_shards(serve.mesh_draws(
            rng, MESH_SHARDS, n, chunk, M["arrival_lam"], "cuda"), mesh)
            for _ in range(3)]
        fcs = [None] * 3
        if chaos:
            plan = TF.plan_from_spec(TF.parse_fault_spec(MESH_FAULT_SPEC),
                                     3 * chunk, MESH_SHARDS)
            fcs = [TM.fault_inputs(TF.plan_chunk(plan, e0, e0 + chunk), mesh)
                   for e0 in range(0, 3 * chunk, chunk)]

        def nxt(a, out, i, draws=draws, fcs=fcs):
            j = min(i + 1, 2)
            return (out.state, out.cd, out.cr, out.view_d, out.view_r,
                    (i + 1) * chunk, draws[j], None, None, out.slo, None,
                    None, fcs[j])

        # a grouped chunk replays each group's leg once a segment
        segments = chunk // every if not chaos and every > 1 else chunk
        finish(f"programs_mesh_{layout}_{tag}", f"mesh.chunk {layout} {tag}",
               fn, (state, cd, cr, vd, vr, 0, draws[0], None, None, w, None,
                    None, fcs[0]), nxt, segments)
    return k1, k2, recs


def phase_guarded_programs(serve, ext, card: str) -> tuple:
    """Phase 29 (b): the guarded-run programs at full width, each held
    as phase 29 (a) holds bench's programs (3 replays with changed inputs
    against the eager body, 0 synchronising operations, K1 and K2
    counted, the capture record printed): ``guarded.epoch`` at the
    ``supervised_prefix`` shape with the five accumulators;
    ``guarded.serial`` at N=100,000, two blocks of
    ``kernels.SERIAL_BLOCK`` steps and a remainder; ``supervisor.ingest``
    at N=100,000; the host replay's pressure probe; the prefix runner's
    "attempt" at the serve shape.  Three more are held where a phase
    then runs them, so its jobs replay the capture instead of making
    their own: ``guarded.epoch`` at the ``supervised_wheel`` shape at
    the start of phase 20's wheel jobs (:func:`held_guarded_epoch`), and
    ``mesh.chunk`` at bench's mesh row stacked at the start of phase 22
    and over 8 groups at the start of phase 25
    (:func:`held_mesh_chunks`).  Returns ``(K1 by path, K2 by path,
    records)``."""
    from dmclock_tpu_torch.engine import fastpath, kernels
    from dmclock_tpu_torch.robust import guarded as TG
    from dmclock_tpu_torch.robust import supervisor as TS

    t_phase = time.perf_counter()
    k1, k2, recs = held_guarded_epoch(ext, "prefix")
    release_programs()
    finish = _program_finisher(ext, k1, k2, recs)
    rng = np.random.default_rng(291)

    # guarded.serial: two blocks and a remainder at N=100,000
    job = TS.EpochJob(**SUP_PREFIX)
    st = TS._job_state(job, "cuda")
    steps = 2 * kernels.SERIAL_BLOCK + SERIAL_STEPS_EXTRA
    prog = TG._jit_serial(steps, False, 0)
    prog.clear_compiled()
    finish("programs_guarded_serial", "guarded.serial", prog,
           (st, job.dt_epoch_ns),
           lambda a, out, i: (out[0], (i + 2) * job.dt_epoch_ns))
    del prog

    # supervisor.ingest on the same state, draws clamped to the waves
    draws = [torch.from_numpy(np.minimum(
        rng.poisson(job.arrival_lam, job.n), job.waves).astype(np.int32))
        .to("cuda") for _ in range(3)]
    ing = TS._jit_ingest(job)
    ing.clear_compiled()
    finish("programs_supervisor_ingest", "supervisor.ingest", ing,
           (st, draws[0], 0),
           lambda a, out, i: (out, draws[min(i + 1, 2)],
                              (i + 1) * job.dt_epoch_ns))

    # the host replay's pressure probe on that state
    probe = TG._pressure_probe()
    probe.clear_compiled()
    finish("programs_pressure_probe", "guarded.pressure_probe", probe,
           (st, job.dt_epoch_ns),
           lambda a, out, i: (a[0], (i + 2) * job.dt_epoch_ns))
    del st, draws, ing, probe
    release_programs()

    # fastpath.runner "attempt" at the serve shape
    st = serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH, device="cuda")
    fastpath.make_prefix_runner(K_SERVE)
    prog = fastpath._RUNNER_JIT_CACHE[("attempt", K_SERVE, 0, False, "sort")]
    prog.clear_compiled()
    finish("programs_runner", "fastpath.runner attempt", prog, (st, 0),
           lambda a, out, i: (out.state, (i + 1) * 5_000_000))
    del st, prog
    release_programs()
    log(f"[programs] guarded-run programs on {card}: K1 by path "
        f"{json.dumps(k1)}, K2 by path {json.dumps(k2)}")
    log(f"[time] guarded-run programs {time.perf_counter() - t_phase:.3f} s")
    return k1, k2, recs


def _whole_capture(name: str, prog, replays: int) -> dict:
    """The one capture of a program captured whole, or a grouped
    program's legs as one record (:func:`_legs_capture`)."""
    if getattr(prog, "legs", None):
        return _legs_capture(name, prog, replays)
    (cap,) = prog.captures()
    return cap


def _held_whole(ext, name: str, prog, calls, nxt,
                replays: int = 1) -> dict:
    """A program captured whole (``compile_plane.InstrumentedJit``) on
    the card: its first call (warm-up and capture; its serial legs'
    blocks child graphs of its graph, or, for a longer leg, replayed
    between its graph's segments), then 3 calls of the same
    signature with changed inputs (``nxt(args, out, i)``), each under
    the sync debug mode's errors (0 syncs a call) and held bit for bit
    against the body run eagerly (``compile_plane.eager``) on a clone of
    its inputs, both timed by CUDA events.  As in :func:`_held_program`,
    the launches of each replay and of its eager run are counted apart
    and held equal to each other and to the capture's; there is no K1 or
    K2, and K3 as often as the body ingests.  Only the first call's and
    the replays' K3 go to :data:`K3_PATHS`.  ``calls``/``nxt`` give
    ``(args, kwargs)``.  A grouped program (one leg a group, each
    replayed ``replays`` times a call) is held the same way, its legs'
    captures as one record.  Returns the record, printed."""
    from dmclock_tpu_torch.obs import compile_plane

    from torch.utils import _pytree as pytree

    def clone(tree):
        return pytree.tree_map(
            lambda x: x.clone() if torch.is_tensor(x) else x, tree)

    def no_k12(n, what):
        if n["ring_window"] or n["wheel_scan"]:
            raise AssertionError(f"{name} {what}: launched {n}")

    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    prog(*calls[0], **calls[1])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    warm = launched(ext)
    cap = _whole_capture(name, prog, replays)
    if warm != {k: cap["launches"].get(k, 0) for k in warm}:
        raise AssertionError(f"{name}: the first call launched {warm}, "
                             f"the capture {cap['launches']}")
    no_k12(warm, "first call")
    k3 = warm.get("ingest_scan", 0)
    plane0 = [e for e in _plane().entries() if e["cache"] == prog.cache
              and e["entry"] == prog.entry]
    args = calls
    replay_ms, eager_ms = [], []
    for i in range(3):
        ref = clone(args)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ext.reset_launches()
        ev[0].record()
        with compile_plane.eager():
            want = prog.fn(*ref[0], **ref[1])
        ev[1].record()
        torch.cuda.synchronize()
        eager_n = launched(ext)
        ext.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ev[2].record()
            got = prog(*args[0], **args[1])
            ev[3].record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        replay_n = launched(ext)
        want_n = {k: cap["launches"].get(k, 0) for k in replay_n}
        if replay_n != eager_n or replay_n != want_n:
            raise AssertionError(f"{name} call {i + 1}: launches "
                                 f"{replay_n}, the eager body {eager_n}, "
                                 f"the capture {cap['launches']}")
        no_k12(replay_n, f"call {i + 1}")
        k3 += replay_n.get("ingest_scan", 0)
        _same_leaves(got, want, f"{name} call {i + 1} against its eager "
                     f"body")
        eager_ms.append(ev[0].elapsed_time(ev[1]))
        replay_ms.append(ev[2].elapsed_time(ev[3]))
        args = nxt(args, got, i)
        del want, got, ref
    ents = [e for e in _plane().entries() if e["cache"] == prog.cache and
            e["entry"] == prog.entry]
    if ents and plane0 and ents[0]["compiles"] != plane0[0]["compiles"]:
        raise AssertionError(f"{name}: a later call of the signature "
                             f"compiled again")
    cap = _whole_capture(name, prog, replays)
    mem = cap.get("memory_analysis", {})
    rec = dict(**({k: cap[k] for k in ("legs", "legs_a_call", "devices")}
                  if "legs" in cap else {}),
               graph_nodes=cap["graph_nodes"], segments=cap["segments"],
               child_graphs=cap["child_graphs"],
               k3_a_replay=cap["launches"].get("ingest_scan", 0),
               lower_ms=cap["lower_ms"], compile_ms=cap["compile_ms"],
               pool_bytes=mem.get("pool_bytes", 0),
               static_bytes=mem.get("argument_bytes", 0),
               first_call_s=first_s, syncs_a_call=[0, 0, 0],
               replay_ms=replay_ms, eager_ms=eager_ms,
               compiles=ents[0]["compiles"] if ents else None,
               retraces=ents[0]["retraces"] if ents else None)
    if rec["k3_a_replay"]:
        K3_PATHS[f"programs {name}"] = k3
    log(f"[programs] {name} ({prog.cache} {prog.entry}): "
        + json.dumps(rec))
    return rec


def _queue_programs_line(what: str, before: dict) -> None:
    """The ``queue`` cache's records since ``before`` (the plane's
    compiles and retraces then) and the captures its programs and their
    serial legs hold: what a queue phase captured, and its pools."""
    from dmclock_tpu_torch.engine import kernels
    from dmclock_tpu_torch.engine import queue as TQ

    ents = [e for e in _plane().entries() if e["cache"] == "queue"]
    comp = sum(e["compiles"] for e in ents) - before.get("compiles", 0)
    retr = sum(e["retraces"] for e in ents) - before.get("retraces", 0)
    caps = [c for prog in TQ._JIT_CACHE.values() for c in prog.captures()
            if c.get("segments")]
    legs = [c for leg in kernels._SERIAL_LEGS.values()
            if hasattr(leg, "captures") for c in leg.captures()]
    mems = [c.get("memory_analysis", {}) for c in caps + legs]
    log(f"[programs] {what}: the queue cache's {len(TQ._JIT_CACHE)} "
        f"programs, {comp} compile records ({retr} retraces) in this "
        f"phase; {len(caps)} captures on the card "
        f"({sum(c['segments'] for c in caps)} graph segments, "
        f"{sum(c.get('graph_nodes') or 0 for c in caps)} graph nodes), "
        f"{len(legs)} serial blocks; "
        f"{sum(c['compile_ms'] for c in caps + legs):.1f} ms of capture, "
        f"{sum(c['lower_ms'] for c in caps + legs):.1f} ms of warm-up, "
        f"pools {sum(m.get('pool_bytes', 0) for m in mems)} bytes, static "
        f"inputs {sum(m.get('argument_bytes', 0) for m in mems)} bytes")


def _queue_plane_mark() -> dict:
    ents = [e for e in _plane().entries() if e["cache"] == "queue"]
    return dict(compiles=sum(e["compiles"] for e in ents),
                retraces=sum(e["retraces"] for e in ents))


def _queue_ops(queue_state, t: int, b: int = 512) -> torch.Tensor:
    """A ``b``-row op batch on the ``queue`` cell's final state (its
    depths and liveness read once, untimed): 32 creates of free slots,
    each followed by an add (a reactivation), 400 adds to clients with
    room (the idle ones reactivate), NOP padding."""
    act = queue_state.active.cpu().numpy()
    room = np.flatnonzero(act & (queue_state.depth.cpu().numpy() <= 24))
    free = np.flatnonzero(~act)[:32]
    pick = np.random.default_rng(292).choice(room, 400, replace=False)
    rows = [(2, s, 0, 0, 0, 0, 10 ** 7, 10 ** 8, 0, 10 ** 6 + s)
            for s in free]
    rows += [(1, s, t, 1 + s % 2, 1, 2, 0, 0, 0, 0)
             for s in list(free) + list(pick)]
    rows += [(0,) * 10] * (b - len(rows))
    return torch.from_numpy(np.asarray(rows, dtype=np.int64).T.copy()) \
        .to("cuda")


def phase_serial_programs(serve, ext, card: str, queue_state) -> dict:
    """Phase 29 (c): the serial-engine programs, each captured whole
    (``compile_plane.InstrumentedJit``), on the card and held by
    :func:`_held_whole`, 0 syncs a call: the ``queue`` cache's ``run`` (a
    ``pull_batch`` of two blocks and a remainder), ``run_h`` (a prefetch
    of a block), ``run_stream`` (2 windows of a block and a remainder),
    ``ingest`` and ``ingest_run`` (a ``pull_request``'s one step) on a
    512-row batch with creates and reactivations, and
    ``ingest_run_stream`` (2 windows of a block and a remainder) on it,
    on the ``queue`` cell's state (phase 17's final state, capacity
    16,384, ring 32); the dry run's ``cluster.cluster_step`` (8 x 10,000,
    32 decisions a step), stacked and over 8 groups of ``cuda:0`` (one
    leg a group, equal to the stacked program), and
    ``cluster.robust_cluster_step`` under the
    dry run's single outage, and ``cluster.mesh_rounds`` at K=1 (1
    round).  Then one server's serial leg at the dry-run shape, 3 calls
    under the sync debug mode's errors against ``engine_run``; last,
    ``release_programs`` drops every capture of these caches.  Returns
    the records."""
    from dmclock_tpu_torch.engine import kernels
    from dmclock_tpu_torch.engine import queue as TQ
    from dmclock_tpu_torch.obs import device as obsdev
    from dmclock_tpu_torch.parallel import cluster as CL
    from dmclock_tpu_torch.parallel import groups
    from dmclock_tpu_torch.robust import cluster as RC
    from dmclock_tpu_torch.robust import faults as TF

    t_phase = time.perf_counter()
    recs = {}
    steps = 2 * kernels.SERIAL_BLOCK + SERIAL_STEPS_EXTRA
    block = kernels.SERIAL_BLOCK
    t0 = serve.QUEUE["dt_round_ns"] + 7 * serve.QUEUE["stream_dt_ns"]

    def leg(n, **kw):
        return kernels.serial_leg(n, allow_limit_break=False,
                                  anticipation_ns=0, **kw)

    def next_t(a, out, i):
        return ((out[0], t0 + (i + 1) * 1_000), {})

    recs["queue run"] = _held_whole(
        ext, "queue run", TQ._shared_jit_run(steps, False, False, 0),
        ((queue_state, t0), {}), next_t)
    recs["queue run_h"] = _held_whole(
        ext, "queue run_h", TQ._shared_jit_run_horizon(block, False, 0),
        ((queue_state, t0), {}), next_t)
    wide = block + SERIAL_STEPS_EXTRA
    recs["queue run_stream"] = _held_whole(
        ext, "queue run_stream", TQ._shared_jit_run_stream(wide, 2, False,
                                                           0),
        ((queue_state, t0, 1_000_000), {}),
        lambda a, out, i: ((out[0], t0 + (i + 1) * 2_000_000, 1_000_000),
                           {}))
    ops = _queue_ops(queue_state, t0)
    recs["queue ingest"] = _held_whole(
        ext, "queue ingest", TQ._shared_jit_ingest(0),
        ((queue_state, ops), {}), lambda a, out, i: ((out, ops), {}))
    recs["queue ingest_run"] = _held_whole(
        ext, "queue ingest_run", TQ._shared_jit_ingest_run(1, False, False,
                                                           0),
        ((queue_state, ops, t0), {}),
        lambda a, out, i: ((out[0], ops, t0 + (i + 1) * 1_000), {}))
    recs["queue ingest_run_stream"] = _held_whole(
        ext, "queue ingest_run_stream",
        TQ._shared_jit_ingest_run_stream(wide, 2, False, 0),
        ((queue_state, ops, t0, 1_000_000), {}),
        lambda a, out, i: ((out[0], ops, t0 + (i + 1) * 2_000_000,
                            1_000_000), {}))
    del ops
    release_programs()

    # the dry run's cluster: a window of 3 a client a step
    o = OUTAGE
    mesh, cl, costs = serve.multichip_cluster(o["n_servers"],
                                              o["n_clients"], "orig",
                                              "cuda")
    k, adv = o["decisions_per_step"], 50_000_000
    costs = torch.from_numpy(costs).to("cuda")
    arr = torch.full((o["n_servers"], o["n_clients"]), 3,
                     dtype=torch.int32, device="cuda")
    cfg = (k, 3, 0, False, adv)
    prog = CL.mesh_step_jit(CL._ROUNDS_JIT_CACHE, CL.cluster_step, mesh, cfg)
    recs["cluster_step"] = _held_whole(
        ext, "cluster.cluster_step", prog, ((cl, arr, costs), {}),
        lambda a, out, i: ((out[0], arr, costs), {}))
    # the same step over 8 groups of cuda:0: one leg a group, held the
    # same way, and equal to the stacked program on the same cluster
    gmesh, gcl, _ = serve.multichip_cluster(
        o["n_servers"], o["n_clients"], "orig", "cuda",
        devices=("cuda:0",) * o["n_servers"])
    gprog = CL.mesh_step_jit(CL._ROUNDS_JIT_CACHE, CL.cluster_step, gmesh,
                             cfg)
    grec = recs["cluster_step groups8"] = _held_whole(
        ext, "cluster.cluster_step groups8", gprog,
        ((gcl, arr, costs), {}),
        lambda a, out, i: ((out[0], arr, costs), {}))
    _same_leaves(groups.gather(gprog(gcl, arr, costs)),
                 prog(cl, arr, costs), "cluster.cluster_step over 8 "
                 "groups against the stacked program")
    srec = recs["cluster_step"]
    log(f"[programs] cluster.cluster_step over 8 groups on {card}: "
        f"{grec['legs']} legs, nodes a leg {grec['graph_nodes'][:2]} "
        f"against {srec['graph_nodes']} in the stacked graph; replay "
        f"{', '.join(f'{x:.3f}' for x in grec['replay_ms'])} ms against "
        f"the stacked graph's "
        f"{', '.join(f'{x:.3f}' for x in srec['replay_ms'])} ms in this "
        f"call; equal to the stacked program")
    del gcl, gprog
    plan = TF.single_outage_plan(4, o["n_servers"], server=1, down_from=1,
                                 down_until=3)
    faults = [RC.fault_step_inputs(TF.plan_step(plan, t), mesh)
              for t in range(4)]
    prog = RC._jit_step(mesh, cfg)
    recs["robust_cluster_step"] = _held_whole(
        ext, "cluster.robust_cluster_step", prog,
        ((RC.init_robust(cl), arr, costs), {"fault": faults[0]}),
        lambda a, out, i: ((out[0], arr, costs), {"fault": faults[i + 1]}))
    views = CL.init_mesh_views(o["n_servers"], o["n_clients"],
                               device="cuda")
    met = torch.zeros((o["n_servers"], obsdev.NUM_METRICS),
                      dtype=torch.int64, device="cuda")
    rounds = CL.jit_mesh_rounds(mesh, epochs=1, decisions_per_step=k,
                                max_arrivals=3, advance_ns=adv)
    arr2 = arr.unsqueeze(0).contiguous()
    recs["mesh_rounds"] = _held_whole(
        ext, "cluster.mesh_rounds K=1", rounds.program,
        ((cl, arr2, costs) + views + (met,), {}),
        lambda a, out, i: ((out.cluster, arr2, costs, out.view_delta,
                            out.view_rho, out.metrics), {}))

    # one server's leg alone: 0 syncs, equal to engine_run
    server_leg = leg(k, advance_now=True)
    st = CL.shard_view(cl.engine, 0)
    now = CL.shard_view(cl.now, 0) + adv
    for i in range(3):
        want = kernels.engine_run(st, now, k, allow_limit_break=False,
                                  anticipation_ns=0, advance_now=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = server_leg(st, now)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _same_leaves(got, want, f"the server leg call {i}")
        st, now = got[0], got[1] + adv
    del cl, st, want, got
    release_programs()
    left = [p for p in list(kernels._SERIAL_LEGS.values()) +
            list(TQ._JIT_CACHE.values()) +
            list(CL._ROUNDS_JIT_CACHE.values()) +
            list(RC._STEP_JIT_CACHE.values())
            if hasattr(p, "captures") and p.captures()]
    if left:
        raise AssertionError(f"release_programs left {len(left)} "
                             f"programs' captures")
    log(f"[programs] serial-engine programs on {card}: every call equal "
        f"to its eager body with 0 syncs; release_programs reached the "
        f"queue, cluster and serial-leg caches")
    log(f"[time] serial-engine programs {time.perf_counter() - t_phase:.3f}"
        f" s")
    return recs


def _leg_captures(legs) -> dict:
    """The captures of a device-sim program's legs (``call.legs``): the
    nodes of the head, the tail and two servers' blocks, the warm-up and
    capture ms and the pools summed, and the static bytes of one graph
    (the legs share one set of donated buffers)."""
    by = {}
    for leg in legs:
        for c in leg.captures():
            name = getattr(leg.fn, "func", leg.fn).__name__.strip("_")
            by.setdefault(name, []).append(c)
    every = [c for caps in by.values() for c in caps]
    mems = [c.get("memory_analysis", {}) for c in every]
    return dict(graphs=len(every),
                graph_nodes={k: [c.get("graph_nodes") for c in caps][:2]
                             for k, caps in by.items()},
                lower_ms=sum(c["lower_ms"] for c in every),
                compile_ms=sum(c["compile_ms"] for c in every),
                pool_bytes=sum(m.get("pool_bytes", 0) for m in mems),
                static_bytes=max(m.get("argument_bytes", 0) for m in mems))


def phase_device_sim_programs(ext, card: str, prefix: dict) -> tuple:
    """Phase 29 (d): the device sim's step as a program
    (``sim.device_sim.jit_device_sim_step``) at the headline's full
    width, 2 slices on each of the prefix, minstop and wheel paths: the
    op-by-op step (``device_sim_step``) on each path equal to phase
    21's prefix run (``prefix``, its fields) on every field, the
    calendar schemes being exact; the program's first call (warm-up and
    capture) equal to it; then a replay on a fresh sim and one chained
    on its result (the donated buffers, nothing copied in), each held on
    every ``DeviceSim`` field against the program's body run eagerly
    (``compile_plane.eager()``) on the same inputs, with the same K1 and
    K2 launches, the same batches and read backs, and exactly one
    synchronising operation a read back (the block statuses); K1 =
    prefix batches + calendar batches x levels and K2 = calendar batches
    x (levels + 1) on every run.  Returns ``(K1 by path, K2 by path,
    records)``."""
    from dmclock_tpu_torch.obs import compile_plane
    from dmclock_tpu_torch.sim import device_sim as DS

    t_phase = time.perf_counter()
    k1, k2, recs = {}, {}, {}
    for impl in (None, "minstop", "wheel"):
        what = f"device_sim_program{'_' + impl if impl else ''}"
        _, sim0, spec = DS.headline_setup(DS_N, calendar_impl=impl,
                                          device="cuda")
        levels = spec.ladder_levels if impl == "wheel" else 1
        step = DS.jit_device_sim_step(spec, DS_TWIN_SLICES,
                                      devices=DS.sim_devices(sim0))
        n1 = n2 = 0

        def run(fn, sim, eager=False):
            nonlocal n1, n2
            counts = DS.StepCounts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ext.reset_launches()

            def go():
                ev[0].record()
                if eager:
                    with compile_plane.eager():
                        out = fn(sim, counts=counts)
                else:
                    out = fn(sim, counts=counts)
                ev[1].record()
                return out

            out, syncs = _capture_syncs(go)
            launches = launched(ext)
            n1 += launches["ring_window"]
            n2 += launches["wheel_scan"]
            want = {"ring_window": counts.prefix_batches
                    + counts.calendar_batches * levels,
                    "wheel_scan": counts.calendar_batches * (levels + 1)
                    if impl == "wheel" else 0}
            if launches != want:
                raise AssertionError(f"{what}: launched {launches}, its "
                                     f"batches say {want} ({counts})")
            return out, counts, launches, len(syncs), \
                ev[0].elapsed_time(ev[1])

        def op_by_op(sim, counts):
            return DS.device_sim_step(sim, spec, DS_TWIN_SLICES,
                                      counts=counts)

        ref, c_ref, l_ref, _, ms_ref = run(op_by_op, _clone_tree(sim0))
        ref = DS.device_sim_to_numpy(ref)
        _sim_numpy_equal(ref, prefix, f"{what}: the op-by-op step against "
                         f"phase 21's prefix run")
        first, c_first, _, _, ms_first = run(step, _clone_tree(sim0))
        _sim_numpy_equal(DS.device_sim_to_numpy(first), ref,
                         f"{what} first call against the op-by-op step")
        del first
        # the eager body: a fresh sim, then chained on its own result
        e1, c_e, l_e, s_e, ms_e = run(step, _clone_tree(sim0), eager=True)
        e1_np = DS.device_sim_to_numpy(e1)
        _sim_numpy_equal(e1_np, ref, f"{what} eager body against the "
                         f"op-by-op step")
        e2, c_e2, l_e2, s_e2, ms_e2 = run(step, e1, eager=True)
        e2_np = DS.device_sim_to_numpy(e2)
        del e1, e2
        r1, c_r, l_r, s_r, ms_r = run(step, _clone_tree(sim0))
        _sim_numpy_equal(DS.device_sim_to_numpy(r1), e1_np,
                         f"{what} replay 1 against its eager body")
        ptrs = [t.data_ptr() for t in _leaves(r1)]
        r2, c_r2, l_r2, s_r2, ms_r2 = run(step, r1)
        if [t.data_ptr() for t in _leaves(r2)] != ptrs:
            raise AssertionError(f"{what}: the chained replay's sim is not "
                                 f"the program's buffers")
        _sim_numpy_equal(DS.device_sim_to_numpy(r2), e2_np,
                         f"{what} replay 2 (chained) against its eager body")
        del r1, r2, sim0
        for got, want, lg, lw, sg, tag in (
                (c_r, c_e, l_r, l_e, s_r, "replay 1"),
                (c_r2, c_e2, l_r2, l_e2, s_r2, "replay 2")):
            if got != want or lg != lw:
                raise AssertionError(f"{what} {tag}: {got} and {lg} "
                                     f"against the eager body's {want} "
                                     f"and {lw}")
            if sg != got.read_backs:
                raise AssertionError(f"{what} {tag}: {sg} synchronising "
                                     f"operations for {got.read_backs} "
                                     f"read backs")
        if (c_r.prefix_live, c_r.calendar_live) != \
                (c_ref.prefix_batches, c_ref.calendar_batches):
            raise AssertionError(f"{what}: {c_r} in the loop against the "
                                 f"op-by-op step's {c_ref}")
        rec = dict(_leg_captures(step.legs), op_by_op=dataclasses.asdict(
            c_ref), replay=dataclasses.asdict(c_r),
            replay_chained=dataclasses.asdict(c_r2),
            syncs_a_call=[s_r, s_r2], launches_op_by_op=l_ref,
            launches_replay=[l_r, l_r2], ms_op_by_op=ms_ref,
            ms_first_call=ms_first, ms_eager_body=[ms_e, ms_e2],
            ms_replay=[ms_r, ms_r2])
        log(f"[programs] {what} ({DS_N} clients x {spec.n_servers} "
            f"servers, {DS_TWIN_SLICES} slices, prefix block "
            f"{DS.PREFIX_BLOCK}, calendar block {DS.CALENDAR_BLOCK}) on "
            f"{card}: " + json.dumps(rec))
        k1[what] = n1
        if n2:
            k2[what] = n2
        recs[what] = rec
        release_programs()
    log(f"[programs] device-sim program on {card}: every call equal to "
        f"the op-by-op step and to its eager body on every DeviceSim "
        f"field; K1 {k1}, K2 {k2}")
    log(f"[time] device-sim programs {time.perf_counter() - t_phase:.3f} s")
    return k1, k2, recs


LC_N, LC_RING, LC_ROWS = 4096, 32, 1024   # the churn cells' shape


def _lc_rows(rng, n: int, b: int) -> tuple:
    """``b`` op rows over ``n`` slots: registers, updates, evicts and
    idle marks in random order, the last quarter NOP padding."""
    live = b - b // 4
    kind = np.concatenate([rng.integers(1, 5, live),
                           np.zeros(b - live, dtype=np.int64)]) \
        .astype(np.int32)
    slot = rng.integers(0, n, b).astype(np.int32)
    vals = rng.integers(1, 10 ** 9, (4, b)).astype(np.int64)
    return kind, slot, vals[0], vals[1], vals[2], vals[3]


def phase_lifecycle_programs(ext, card: str) -> dict:
    """Phase 29 (e): the lifecycle plane's three programs at the churn
    cells' shape (4,096 slots, ring 32), each held by
    :func:`_held_program` against its eager body over 3 replays, 0
    synchronising operations: ``lifecycle.ops`` (``_OPS_JIT``, 1,024
    rows of registers, updates, evicts and idle marks with padding,
    chained), ``lifecycle.compact`` (``_COMPACT_JIT["take"]``: the
    state, a ledger and an SLO-sized block by a new permutation each
    call) and the churn runner's 16-step serial leg (``_RUN_JIT``).
    Then ``run_serial_churn`` on the ``churn_storm`` population (4,096
    ids, 8 epochs) through the programs against the same run eagerly:
    digest, decisions and counters equal, both timed.  Returns the
    records."""
    import dmclock_tpu_torch.lifecycle as L
    from dmclock_tpu_torch.engine import kernels
    from dmclock_tpu_torch.engine.state import init_state
    from dmclock_tpu_torch.lifecycle import plane as LP
    from dmclock_tpu_torch.lifecycle import slots as LS
    from dmclock_tpu_torch.obs import compile_plane

    t_phase = time.perf_counter()
    k1, k2, recs = {}, {}, {}
    finish = _program_finisher(ext, k1, k2, recs)
    rng = np.random.default_rng(29)
    state = init_state(LC_N, LC_RING, device="cuda")
    state = LP.apply_op_vector(
        state, np.full(LC_N, LP.LC_REGISTER, np.int32),
        np.arange(LC_N, dtype=np.int32), *rng.integers(
            1, 10 ** 9, (3, LC_N)), np.arange(LC_N))
    inputs = [LP.op_vector_inputs(state, *_lc_rows(rng, LC_N, LC_ROWS))
              for _ in range(4)]
    finish("lifecycle_ops", "lifecycle.ops", LP.ops_program(
        LC_N, LC_RING, LC_ROWS), (state,) + tuple(inputs[0]),
        lambda a, out, i: (out,) + tuple(inputs[i + 1]))
    led = torch.randint(0, 1 << 40, (LC_N, 5), dtype=torch.int64,
                        device="cuda")
    blk = torch.randint(0, 1 << 30, (LC_N, 32), dtype=torch.int32,
                        device="cuda")
    perms = [torch.from_numpy(rng.permutation(LC_N)).to("cuda")
             for _ in range(4)]
    finish("lifecycle_compact", "lifecycle.compact", LS.compact_program(),
           ((state, led, blk), perms[0]),
           lambda a, out, i: (out, perms[i + 1]))
    leg = kernels.serial_leg(16, allow_limit_break=False,
                             anticipation_ns=0)
    now = 10 ** 9
    _same_leaves(leg(state, now), kernels.engine_run(
        state, now, 16, allow_limit_break=False, anticipation_ns=0),
        "the churn runner's leg, first call")
    st = state
    for i in range(3):
        want = kernels.engine_run(st, now, 16, allow_limit_break=False,
                                  anticipation_ns=0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = leg(st, now)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _same_leaves(got, want, f"the churn runner's leg call {i}")
        st, now = got[0], now + 10 ** 8
    recs["lifecycle.run"] = dict(captures=[
        {k: c.get(k) for k in ("graph_nodes", "lower_ms", "compile_ms")}
        for c in leg.captures()])
    log(f"[programs] the churn runner's 16-step leg ({LC_N} slots): 3 "
        f"calls equal to engine_run, 0 syncs; "
        + json.dumps(recs["lifecycle.run"]))
    del state, st, want, got, led, blk
    spec = L.make_spec("churn_storm", total_ids=LC_N)
    walls = {}
    for tag in ("eager", "programs"):
        t0 = time.perf_counter()
        if tag == "eager":
            with compile_plane.eager():
                res = L.run_serial_churn(spec, epochs=8, every=2,
                                         device="cuda")
        else:
            res = L.run_serial_churn(spec, epochs=8, every=2,
                                     device="cuda")
        torch.cuda.synchronize()
        walls[tag] = (time.perf_counter() - t0, res[0], res[2],
                      dict(res[1].counters))
    if walls["eager"][1:] != walls["programs"][1:]:
        raise AssertionError(f"run_serial_churn through the programs "
                             f"{walls['programs'][1:]} against eagerly "
                             f"{walls['eager'][1:]}")
    log(f"[programs] run_serial_churn churn_storm ({LC_N} ids, 8 epochs) "
        f"on {card}: digest {walls['eager'][1][:16]}..., "
        f"{walls['eager'][2]} decisions, counters {walls['eager'][3]}, "
        f"equal through the programs; wall {walls['programs'][0]:.3f} s "
        f"(eagerly {walls['eager'][0]:.3f} s, the first run's captures "
        f"included)")
    release_programs()
    if k1 or k2:
        raise AssertionError(f"the lifecycle programs launched K1 {k1}, "
                             f"K2 {k2}")
    log(f"[time] lifecycle programs {time.perf_counter() - t_phase:.3f} s")
    return recs


def main_mesh_cards() -> int:
    """``chip_smoke.py --mesh-cards``: phase 25 (e) alone, for a machine
    with several cards: the build, the stacked references on ``cuda:0``
    (bench's mesh row at K=1, K=4 and under the fault plan, the
    device-sim headline's first slices), then
    :func:`phase_mesh_cards` over every visible card (2, 4 or 8 of
    them).  With one card it rehearses the same code over 4 groups of
    ``cuda:0``.  Prints the launches by path, the card line and a last
    line of its own."""
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.engine import _ext, fastpath, kernels
    from dmclock_tpu_torch.obs.registry import MetricsRegistry
    from dmclock_tpu_torch.robust import faults as TF

    t0 = time.perf_counter()
    card = phase_card()
    phase_build(_ext)
    k1, k2 = {}, {}
    counted = _path_counter(_ext, k1, k2)
    c = serve.MESH
    epochs_run = (c["warmup_epochs"] // c["chunk"]
                  + c["epochs"] // c["chunk"]) * c["chunk"]

    def row(path, **kw):
        return counted(path, lambda: serve.mesh_row(
            c["clients"], n_shards=MESH_SHARDS, devices=("cuda:0",),
            registry=MetricsRegistry(), **kw), MESH_SHARDS * epochs_run)

    stacked = dict(rows={1: row("mesh", counter_sync_every=1),
                         4: row("mesh_k4", counter_sync_every=4)},
                   chaos=row("mesh_chaos", fault_spec=TF.parse_fault_spec(
                       MESH_FAULT_SPEC)))
    one = _ds_slices(("cuda:0",), DS_TWIN_SLICES)
    count = torch.cuda.device_count()
    d = max(x for x in (1, 2, 4, 8) if x <= min(count, 8))
    if d < 2:
        log(f"[mesh_cards] {count} CUDA device visible: a rehearsal over 4 "
            f"groups of cuda:0")
        phase_mesh_cards(counted, fastpath, kernels, card, stacked, one,
                         ("cuda:0",) * 4, "rehearsal")
    else:
        phase_mesh_cards(counted, fastpath, kernels, card, stacked, one,
                         tuple(f"cuda:{i}" for i in range(d)))
    log(f"[time] mesh_cards {time.perf_counter() - t0:.3f} s after its "
        f"imports")
    print(json.dumps({"launches_by_path": {"ring_window": k1,
                                           "wheel_scan": k2}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "mode": "mesh_cards", "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    if sys.argv[1:] == ["--mesh-cards"]:
        return main_mesh_cards()
    from dmclock_tpu_torch import serve
    from dmclock_tpu_torch.engine import _ext, fastpath, kernels
    from dmclock_tpu_torch.obs import device as obsdev
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import test_torch_cases as cases

    assert (obsdev.MET_WHEEL_OCC_HWM, obsdev.MET_WHEEL_RESLOTS) == WHEEL_ROWS
    assert obsdev.MET_REBASE_FALLBACKS == MET_REBASE_FALLBACKS
    assert obsdev.MET_INGEST_DROPS == MET_INGEST_DROPS
    t_start = time.perf_counter()
    card = phase_card()
    phase_build(_ext)
    k1 = phase_k1(fastpath, cases, card)
    k2 = phase_k2(serve, fastpath, kernels, card)
    k3 = phase_k3(kernels, card)
    phase_exact(serve, fastpath, kernels)
    phase_exact_knobs(serve, fastpath, kernels)
    t_serve = time.perf_counter()
    serve_k1, sort_res, sort_med = phase_serve(serve, kernels, _ext, obsdev,
                                               card)
    radix_k1 = phase_serve_radix(serve, _ext, obsdev, sort_res, sort_med,
                                 card)
    tag32_k1 = phase_tag32(serve, fastpath, kernels, _ext, obsdev,
                           sort_res, card)
    del sort_res
    chain_k1 = phase_chain(
        serve, fastpath, kernels, _ext, obsdev, card, tag="chain",
        st0=serve._preloaded_state(N_SERVE, DEPTH, ring=DEPTH,
                                   device="cuda"),
        now=CHAIN_NOW, chains=False)
    chain_vc_k1 = phase_chain(
        serve, fastpath, kernels, _ext, obsdev, card, tag="chain_vc",
        st0=serve.variable_cost_state(N_SERVE, DEPTH, device="cuda"),
        now=0, chains=True)
    phase_calendar_exact(serve, fastpath, kernels)
    ladder_k1 = phase_stop_ladder(serve, fastpath, kernels, _ext, card)
    wheel, wheel_row = phase_cfg4_wheel(serve, _ext, obsdev, card)
    release_programs()
    t_rows = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sust_out = os.path.join(tmp, "sustained_twins.pt")
        sust_twin = start_sustained_twins(root, sust_out)
        twins = sup_twin = sim_twins = mesh_twin = sup_mesh_twin = None
        try:
            cfg3_k1, st3, tele3, draws3, r3, _, base3, cfg3_np = \
                phase_cfg3(serve, _ext, obsdev, card)
            stream_k1 = phase_cfg3_stream(serve, _ext, obsdev, card, st3,
                                          tele3, draws3, r3, base3)
            del st3, tele3, draws3
            release_programs()
            cfg4_k1, cfg4_stream_k1, _, cfg4_np = phase_cfg4(
                serve, _ext, obsdev, card)
            release_programs()
            t_row = time.perf_counter()
            cfg3_row_k1, cfg3_row = phase_row(serve, _ext, card, "cfg3",
                                              N_CFG3, tmp)
            release_programs()
            cfg4_row_k1, cfg4_row = phase_row(serve, _ext, card, "cfg4",
                                              N_CFG4, tmp)
            release_programs()
            frontier_k1 = phase_frontier(serve, _ext, card)
            release_programs()
            t_queue = time.perf_counter()
            out = os.path.join(tmp, "twins.pt")
            twins = start_cpu_twins(root, out)
            twin = functools.cache(lambda: collect_cpu_twins(twins, out))
            # both card runs first, so the twins have their time to finish
            qmark = _queue_plane_mark()
            run = phase_queue(serve, _ext)
            push = phase_push(serve, _ext)
            _queue_programs_line("the queue and push phases", qmark)
            t_churn = time.perf_counter()
            churn, churn_k1 = phase_churn(serve, _ext, card)
            storm, storm_k1 = phase_churn_storm(serve, _ext, card)
            # the four card runs first, so the twins have their time
            check_queue(serve, run, card, twin)
            check_push(*push, card, twin)
            queue_state = run.state
            del run, push
            check_churn(churn, card, twin)
            check_churn(storm, card, twin, "storm")
            release_programs()
            t_sup = time.perf_counter()
            out2 = os.path.join(tmp, "sup_twin.pt")
            sup_twin = start_cpu_sup_twin(root, out2)
            err = os.path.join(tmp, "supervised.err")
            try:
                with _stderr_to(err):
                    sup_k1, sup_k2, sup_churn, sup_short = \
                        phase_supervised(_ext, card, tmp)
            except BaseException:
                with open(err, errors="replace") as f:
                    sys.stderr.write(f.read()[-6000:])
                raise
            with open(err, errors="replace") as f:
                alerts = sum(ln.startswith("# slo:") for ln in f)
            log(f"[supervised] {alerts} SLO alert lines went to stderr "
                f"(kept in a file)")
            check_supervised(sup_churn, card, twin()["sup_churn"],
                             "supervised_churn")
            check_supervised(sup_short, card,
                             collect_cpu_twins(sup_twin, out2),
                             "supervised_prefix_short")
            release_programs()
            # phase 21: the simulators; their CPU twins start first
            t_sims = time.perf_counter()
            sim_twins = start_cpu_sim_twins(root, tmp)
            ds_prefix, ds_by_path, _ = phase_device_sim(_ext, fastpath,
                                                        card)
            qmark = _queue_plane_mark()
            dmc = phase_dmc_sim(_ext, card, tmp)
            _queue_programs_line("dmc_sim, both runs", qmark)
            phase_oracle_trace(dmc, card, tmp)
            check_sim_twins(sim_twins, ds_prefix, dmc, card)
            release_programs()
            # phase 22: the multi-server mesh; its CPU twins start first
            t_mesh = time.perf_counter()
            mesh_out = os.path.join(tmp, "mesh_twins.pt")
            mesh_twin = start_mesh_twins(root, mesh_out)
            mesh_k1, mesh_k2, mesh_stacked = phase_mesh(
                _ext, card, mesh_out, mesh_twin)
            release_programs()
            # phase 23: the supervised mesh; its CPU twins start first
            t_sup_mesh = time.perf_counter()
            sm_out = os.path.join(tmp, "sup_mesh_twins.pt")
            sup_mesh_twin = start_sup_mesh_twins(root, sm_out)
            err = os.path.join(tmp, "supervised_mesh.err")
            try:
                with _stderr_to(err):
                    sup_mesh_k1, sup_mesh_ref = phase_supervised_mesh(
                        _ext, card, tmp, sm_out, sup_mesh_twin)
            except BaseException:
                with open(err, errors="replace") as f:
                    sys.stderr.write(f.read()[-6000:])
                raise
            release_programs()
            # phase 24: control and network; its CPU twins start inside
            t_control = time.perf_counter()
            err = os.path.join(tmp, "control.err")
            try:
                with _stderr_to(err):
                    ctl_k1, ctl_k2, rebal = phase_control(_ext, card,
                                                          root, tmp)
            except BaseException:
                with open(err, errors="replace") as f:
                    sys.stderr.write(f.read()[-6000:])
                raise
            release_programs()
            # phase 25: the mesh across devices, held to the stacked
            # runs of phases 22 and 23
            t_groups = time.perf_counter()
            err = os.path.join(tmp, "groups.err")
            try:
                with _stderr_to(err):
                    grp_k1, grp_k2 = phase_mesh_groups(
                        _ext, fastpath, kernels, card, tmp, mesh_stacked,
                        sup_mesh_ref)
            except BaseException:
                with open(err, errors="replace") as f:
                    sys.stderr.write(f.read()[-6000:])
                raise
            release_programs()
            # phase 26: migration over groups, then bench's session and
            # the two entry scripts, held to this run's rows
            t_session = time.perf_counter()
            err = os.path.join(tmp, "session.err")
            try:
                with _stderr_to(err):
                    ses_k1, ses_k2 = phase_session(
                        _ext, card, root, tmp, dict(
                            churn=churn, cfg3=cfg3_row, cfg4=cfg4_row,
                            rebal=rebal))
            except BaseException:
                with open(err, errors="replace") as f:
                    sys.stderr.write(f.read()[-6000:])
                raise
            release_programs()
            check_sustained_twins(sust_twin, sust_out,
                                  dict(cfg3=cfg3_np, cfg4=cfg4_np))
            # phase 27: the sweeps; their CPU twin starts first
            t_sweeps = time.perf_counter()
            sweep_k1, sweep_err, sweep_ms = phase_sweeps(
                _ext, fastpath, cases, card, root, tmp)
            release_programs()
            # phase 28: the compile plane and the cost counts
            t_costs = time.perf_counter()
            cost_k1, cost_k2 = phase_costs(
                _ext, fastpath, card, root,
                dict(cfg3=cfg3_row, cfg4=cfg4_row), wheel_row)
            release_programs()
            # phase 29: the captured programs
            t_programs = time.perf_counter()
            prog_k1, prog_k2, _ = phase_programs(serve, _ext, card)
            gp_k1, gp_k2, _ = phase_guarded_programs(serve, _ext, card)
            prog_k1.update(gp_k1)
            prog_k2.update(gp_k2)
            t_serial = time.perf_counter()
            phase_serial_programs(serve, _ext, card, queue_state)
            t_dsp = time.perf_counter()
            dsp_k1, dsp_k2, _ = phase_device_sim_programs(_ext, card,
                                                          ds_prefix)
            prog_k1.update(dsp_k1)
            prog_k2.update(dsp_k2)
            phase_lifecycle_programs(_ext, card)
        finally:
            for proc in (sust_twin, twins, sup_twin, mesh_twin,
                         sup_mesh_twin):
                if proc is not None:
                    _stop(proc)
            for proc, _ in (sim_twins or {}).values():
                _stop(proc)
    t_end = time.perf_counter()
    log(f"[time] phases 6-13 took {t_rows - t_serve:.3f} s, the cfg3, "
        f"cfg3_stream and cfg4 (minstop) phases {t_row - t_rows:.3f} s, "
        f"the sustained rows and the frontier {t_queue - t_row:.3f} s, "
        f"the queue and push phases {t_churn - t_queue:.3f} s, the churn "
        f"phases {t_sup - t_churn:.3f} s, the supervised phase "
        f"{t_sims - t_sup:.3f} s, the simulators' phase "
        f"{t_mesh - t_sims:.3f} s, the mesh phase "
        f"{t_sup_mesh - t_mesh:.3f} s, the supervised mesh phase "
        f"{t_control - t_sup_mesh:.3f} s, the control and network phase "
        f"{t_groups - t_control:.3f} s, the mesh across devices "
        f"{t_session - t_groups:.3f} s, the session phase "
        f"{t_sweeps - t_session:.3f} s, the sweeps phase "
        f"{t_costs - t_sweeps:.3f} s, the costs phase "
        f"{t_programs - t_costs:.3f} s, the programs phase "
        f"{t_end - t_programs:.3f} s (the serial-engine programs "
        f"{t_dsp - t_serial:.3f} s of it, the device-sim and lifecycle "
        f"programs {t_end - t_dsp:.3f} s); the whole script "
        f"{t_end - t_start:.3f} s after its imports")
    # launches: each path's count, read right after that path's run
    by_path = dict(serve=serve_k1, serve_radix=radix_k1,
                   serve_tag32=tag32_k1, chain=chain_k1,
                   chain_vc=chain_vc_k1, stop_ladder=ladder_k1,
                   cfg4_wheel=wheel["ring_window"], cfg3=cfg3_k1,
                   cfg3_stream=stream_k1, cfg4=cfg4_k1,
                   cfg4_stream=cfg4_stream_k1, cfg3_row=cfg3_row_k1,
                   cfg4_row=cfg4_row_k1, frontier=frontier_k1,
                   churn_flash_crowd=churn_k1, churn_storm=storm_k1,
                   **sup_k1, **{p: n["ring_window"]
                                for p, n in ds_by_path.items()},
                   **{p: n for p, n in mesh_k1.items() if n},
                   **sup_mesh_k1, **ctl_k1, **grp_k1, **ses_k1,
                   **sweep_k1, **cost_k1, **prog_k1)
    k1["launches"] = sum(by_path.values())
    k1["launches_by_path"] = by_path
    k1["max_abs_err"] = max(k1["max_abs_err"], sweep_err)
    log("[k1] at the sweeps' shapes on " + card + ": " + "; ".join(
        f"N={n} Q={q} w={w} {t['ms']:.6f} ms = "
        f"{t['ms'] / t['bound_ms']:.3f}x its bound {t['bound_ms']:.6f} ms, "
        f"plain {t['plain_ms']:.6f}, torch.gather x2 {t['library_ms']:.6f}"
        for (n, q, w), t in sweep_ms.items()))
    # minstop, cfg3, the stream chunks, the queue and churn, and the
    # device sim but for its wheel run launch no K2
    k2_paths = dict(cfg4_wheel=wheel["wheel_scan"], **sup_k2,
                    **{p: n for p, n in mesh_k2.items() if n}, **ctl_k2,
                    **grp_k2, **ses_k2, **cost_k2, **prog_k2)
    k2["launches"] = sum(k2_paths.values())
    k2["launches_by_path"] = k2_paths
    # K3: every path that ingests an op batch (the queue, the push
    # queue, the simulators' queues, the cluster's dry run and outage,
    # the serial-engine programs)
    k3["launches"] = sum(K3_PATHS.values())
    k3["launches_by_path"] = dict(K3_PATHS)
    print(json.dumps({"kernels": [k1, k2, k3]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
