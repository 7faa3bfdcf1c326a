#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on the card and check it.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (the kernels build from ``csrc/`` at
first use). Phases, each of which fails the script on any mismatch:

1. the card's name and power limit; the kernel build (nvcc seconds,
   library paths, ptxas registers and spills of every kernel);
2. the fire-compaction kernel (K2) against its plain version at the
   slice shape (2^17 nodes, max_out 8, payload 1, window 8000, batch
   2^18): a sparse outbox, one dense enough to drop, and window 1; then
   n = 1000 and 5000, 2^20 nodes, S just below the fired count, a long
   sentinel tail, payload 7 (its staging above 48 KB of shared memory),
   the wide build (payloads past the 27 words the narrow build stages)
   at 32 words and at the widest K2 takes (1022) on 2^12 nodes, M 2, S
   2^13, and two calls in a row;
3. the mailbox-insertion kernel (K1) against its plain version: the
   slice shape (K 16, P 1, no src, commutative) on a batch that
   overfills some mailboxes, and the ordered mode with src (K 8, P 2);
   then the edges of its tiles in both modes, the ordered one also on
   mailboxes whose holes lie apart from ``counts``: 2^17 + 3 nodes, a
   tile that chunks with a node of 8192 entries after one with none, an
   empty batch, K 1, 40 and 130, P 0, 3 and 7, with and without the
   inbox src plane, and ordered with every ``counts`` at 0 and at K;
4. the main path: the gossip wave at 2^17 nodes (``bench.py``
   ``gossip_100k_insert``'s configuration) to quiescence through
   ``TorchEngine.run_quiet``, with the wave-done invariants and both
   kernels launched once per superstep;
5. card against CPU: an integer-link gossip wave at 2^14 nodes through
   ``run`` on both devices — equal traces and final states;
6. each kernel's time (CUDA events, cold L2, its launches queued before
   the start event fires), its plain version's time and its bound (bytes
   over 3.35 TB/s), K1 also in the ordered mode with src, K2's wide
   build at phase 2's two wide shapes; the timing floor, one empty
   launch;
7. where the main path's time goes: wall time per superstep against the
   device's kernel time under ``torch.profiler`` (the idle share);

then the fused-sparse engine's slice (kernel K3, Praos at 2^20 stake
nodes):

8. the sample-and-insert kernel (K3) against its plain version at the
   slice shape (2^20 nodes, K 16, P 2, no src, max_out 8, window 8000,
   the 2^23-wide batch of the main path, mailboxes overfilled), once per
   lowered link kind: Fixed, Uniform, SeededHashUniform and
   Quantize(LogNormal), a FixedDelay shorter than the window
   (``short_delay > 0``) and an epoch just below 2^32 µs (the carry);
   then the edges of its tiles: 2^20 + 3 nodes, one node with 8192
   entries after one with none, an empty batch, K 1, 40 and 130, P 0, 3
   and 7, with and without the inbox src plane;
9. the main path: Praos at 2^20 (``bench.py`` ``bench_praos_1m_fused``'s
   configuration, ``max_batch = n * max_out``) through
   ``FusedSparseEngine.run_quiet``, 16 warm supersteps then 256 timed,
   with its invariants and K3 launched once per superstep; then the same
   supersteps through ``run`` for the peak fired messages per superstep
   and an equal final state;
10. the card law, fused = general: Praos at 2^20 for 64 supersteps through
    ``TorchEngine`` (K2 + K1) and ``FusedSparseEngine`` (K3), every state
    leaf equal;
11. card against CPU for the fused engine: integer-link Praos at 2^14
    through ``run`` for 100 supersteps (half its run to quiescence),
    equal traces and final states;
12. the gossip wave of phase 4 through ``FusedSparseEngine``: the same
    supersteps, delivered count and final state as phase 4;
13. K3's time, its plain version's time and its bound: bytes over
    3.35 TB/s, or the draws' SASS instructions (``cuobjdump``) over the
    card's issue rates, whichever is longer;
14. where the Praos path's time goes, as phase 7;

then the static-topology slice (kernel K4, the dense token ring at 2^20):

15. the dense-ring superstep kernel (K4) against its plain version at
    2^20 nodes on seeded planes: dense, sparse, one forcing overflow, one
    past ``end_us`` (alive 0), and at 2^20 + 3 nodes;
16. the main path: the dense ring of ``bench.py`` ``_dense_ring(2^20)``
    (every node holds a token, think 0, ``FixedDelay(500)``, cap 2)
    through ``FusedRingEngine.run_quiet``, 16 warm then 8192 timed
    supersteps: overflow 0, ``(supersteps - 1) * n`` delivered, K4
    launched once per superstep and K1-K3 not at all;
17. fused = edge at 2^20: ``EdgeEngine.run_quiet`` against
    ``FusedRingEngine`` through ``to_edge_state``, every leaf, at 12 and
    64 supersteps of the dense ring, and on a sparse ring;
18. the edge engine on the card against the CPU at 2^14: ``run`` on a
    ``UniformDelay`` sparse ring (300 supersteps) and on a permutation
    (gather) topology (150), equal traces and final states;
19. K4's time, its plain version's time and its bound;
20. where the dense ring's time goes, on ``FusedRingEngine`` and on
    ``EdgeEngine``, as phase 7;

then the general engine's eager and lazy routing paths (K1 at the eager
width, steady gossip at 2^20):

21. the main path: steady gossip at 2^20 nodes (``bench.py``
    ``gossip_steady_1m``'s configuration: fanout 1, 1 ms rounds, window
    1, ``Quantize(UniformDelay(500, 4_500), 1_000)``, K 8) through
    ``TorchEngine.run_quiet`` on the eager path, 64 warm then 256 timed
    supersteps: ``bad_dst``, ``bad_delay``, ``short_delay`` and
    ``route_drop`` 0, every node infected, K1 launched once per superstep
    and K2/K3/K4 not at all;
22. eager = lazy at 2^20: the same run through ``run`` on the eager path
    and on the lazy one (``route_cap = n * max_out``) for 64 supersteps,
    equal traces and every state leaf, ``route_drop`` 0;
23. card against CPU at 2^14 through ``run`` (each case for half the
    supersteps of its run to its end), equal traces and final
    states: a droppy windowed gossip (eager, 3-key sort) with
    ``record_events``, whose ``events()`` are equal too, a lazy Praos
    whose ``route_cap`` is below its active count (``route_drop > 0``),
    steady gossip, socket-state on a droppy link (at 2^12: its state is
    n^2 words), and ping-pong (ordered inbox with src);
24. K1 on a steady-state superstep's own batch from phase 21 (S = 2^20
    entries over 2^20 nodes, K 8, P 1, no src, commutative; in the
    steady state every lane holds a message): bit-equal to its plain
    version, its time and its bound;
25. where the steady path's time goes, as phase 7;
26. K2 and K1 across the world axis (a fleet of B worlds in one launch)
    against their plain versions at the chaos fleet's shape (8 worlds of
    100 000 nodes, M 1, P 1, K 8, S 100 352), every world also against
    its own solo call: a world with an empty batch, one world that drops
    (K2) or whose hot nodes overflow (K1), B = 1 equal to the solo
    kernel, a ragged N (100 003), window 1 with P 0, ordered K1 with
    ``counts`` and src;
27. the main path of the world-axis slice: ``bench.py``
    ``gossip_100k_chaos``, 8 steady-gossip worlds of 100 000 nodes under
    8 fault schedules through ``TorchEngine(batch=..., faults=...)``,
    under the bench's gates — worlds 0 and 7 equal their solo faulted
    runs over 12 supersteps, deliveries after every world's faults heal
    — then, from 2 warm supersteps, ``run_quiet`` to quiescence with K2
    and K1 each launched once per fleet superstep, ``short_delay`` and
    ``route_drop`` 0, ``fault_dropped > 0`` and at most ``max(n // 500,
    8)`` nodes uninfected in every world;
28. fleet card against CPU at 2^12 nodes, 3 worlds, in each routing
    regime (75, 97 and 100 supersteps, half the longest world's run to
    its end or its budget of 200): adaptive and eager under per-world fault schedules,
    lazy under a link sweep;
29. the chaos fleet saved mid-run on the card (utils/checkpoint.py) and
    resumed equals the uninterrupted run; ``load_world_state`` of one
    world continued solo equals that world;
30. K2 and K1 on one chaos-fleet superstep's own arguments, taken at
    ``eng.stage``: bit-equal, their times and byte bounds (per world,
    summed over the 8);
31. where the chaos fleet's time goes, as phase 7;

then the run-mode planes (telemetry, integrity, the flight recorder and
controlled runs) on the torch engines:

32. the verified gossip wave at 100 000 nodes (``bench.py``
    ``gossip_100k_verify``): the detection gate (``flip:7:2``, budget 64,
    chunk 8: a rollback, and states, traces and digest chain equal the
    clean run's), then ``run_verified`` to quiescence under ``off``,
    ``guard``, ``digest`` and ``shadow`` with no false positive, each
    mode's wall and overhead fraction;
33. the flight recorder on the same wave (``record_cap`` 4096): ``off``,
    ``deliveries`` and ``full`` equal over 24 supersteps; events, dropped
    counts and overheads;
34. the main path of the planes' slice: the chaos fleet with
    ``telemetry="full", verify="digest", record="full"`` through
    ``run_verified`` from 2 warm supersteps to quiescence, one flip at a
    chunk boundary: a rollback, the final state = phase 27's, K1 and K2
    once per executed fleet superstep; worlds 0 and 7 over 12 supersteps
    = their solo runs' frames and flight logs; every fault action in each
    world's log (recorded with ``record_cap`` 2^18 over the fault
    windows, cut + down + purge events = ``fault_dropped``);
35. ``run_controlled`` on ``bench.py`` ``_bursty_gossip(100 000)``: the
    dynamic window at the undegraded 8 000 µs bound, clamped per superstep
    inside the degradation window (``short_delay`` 0), strictly fewer
    supersteps than the static engine at the degraded 2 000 µs with the
    same events, and its replay (the replay law); then the telemetry gate
    on ``gossip_100k_fused`` (K3): counters = off, the overhead fraction;
36. card against CPU with every plane on, 48 supersteps each run:
    ``TorchEngine`` adaptive (2^14),
    eager, lazy and a 3-world faulted fleet (2^12), ``FusedSparseEngine``
    and ``EdgeEngine`` (2^14): frames, flight logs, integrity records,
    decision traces, traces and states equal;
37. where the chaos fleet's time goes on the traced driver, planes off
    and with ``telemetry="full", record="deliveries"``; the state
    digest's time and launches over the fleet's state;

then speculation (the dynamic window, optimistic execution and its
rollback) on ``TorchEngine``:

38. the main path: ``bench.py`` ``gossip_100k_spec`` (burst gossip at
    100 000 nodes over ``Quantize(ParetoDelay(4 000, 1.2), 500)``) through
    ``run_speculative(2^14, chunk=64)`` under ``speculate="auto"`` to
    quiescence, against the conservative ``window="auto"`` run: the
    equivalence law on the canonical surface bit for bit, strictly fewer
    supersteps, overflow 0; both superstep counts, windows, chunks and
    rollbacks, both walls (each through its traced driver), and K1's and
    K2's launches, those of rolled-back chunks apart;
39. a speculative fleet with a masked rollback: 8 worlds of that gossip
    at 100 000 nodes under ``fixed:8000``, Pareto ``xm_us`` below 8 ms in
    the even worlds and above it in the odd ones: ``1 <= rerun_worlds <=
    7``, every world equal to its row of one conservative fleet run, K1
    and K2 once per fleet superstep;
40. speculation card against CPU at 2^12 nodes on an integer link with
    the same floor gap: solo ``auto``, a 2-world fleet under a shrink
    ``LinkWindow`` and a forced rollback — states, traces, decisions and
    ``last_run_speculation`` equal;
41. where a speculative chunk's time goes (phase 38's engine through the
    traced ``run`` at its widest committed window) beside the
    conservative engine's, as phase 7;

then the fault-tolerant sweep service (``timewarp_tpu_torch/sweep/``),
every bucket a ``TorchEngine(batch=...)`` on the card, each of its ``run``
calls recorded (phases 38 and 39 also time K2 and K1 on the superstep
they check):

42. ``bench.py`` ``sweep_hetero`` at 4096 nodes and 256 steps (its
    default 2000, and 1000 and 500, took chip_smoke past its time limit
    on slow hosts: three token rings, one faulted, and two windowed burst
    gossips)
    through ``SweepService`` twice, ``pack_mode="first-fit"`` and
    ``"predicted"``, each with ``inject="fail:2"`` and ``max_bucket=2``:
    a retry in each, every streamed record equal to the port's
    ``solo_result`` on the CPU, the bench's packing gates, K1 once per
    fleet superstep of every bucket ``run`` call and K2 as often on
    adaptive buckets; each bucket's regime, supersteps and launches;
43. the 8 worlds of ``bench.py`` ``gossip_100k_chaos`` as a pack (the
    ``--faults`` grammar) at a budget of 192 supersteps (they quiesce in
    304-515; each world gated past the last fault window's end, 120 ms),
    one bucket of 8 x 100 000 nodes, ``chunk=64``,
    ``verify="digest"``: with ``inject="fail:2"``, killed by ``die:3``
    and resumed, split 4 + 4 by ``oom:2`` — every streamed record equal to
    the world's solo run on the card and to world b's row of phase 27's
    fleet run from its initial state; K1 and K2 once per fleet superstep
    of every call; K2 and K1 bit-equal to their plain versions on the
    bucket's busiest superstep, and their times there; the phase's
    wall split into its pack lints, its construction lints and the rest;
44. ``tests/test_zsweep.py``'s ``PACK`` through the service on the card
    and on the CPU: equal results and journals, wall-clock fields aside;
45. what the service costs on phase 43's bucket: its service run's wall
    against the bare ``run_quiet`` of the same worlds, with one
    checkpoint write's and one state digest's time (printed, not
    gated), and the device's idle share over 16 of its chunked
    supersteps;

then the adversarial chaos search (``timewarp_tpu_torch/search/``) and the
run ledger, every fleet a ``TorchEngine(batch=...)`` on the card whose
``run`` calls are recorded (K2 = K1 = the call's fleet supersteps in
each):

46. ``bench.py`` ``search_gossip`` at its own size (64 nodes, budget 300,
    ``eventually-delivered``, population 8, 6 generations, seed 2,
    ``fork_k`` 2, a journal): the bench's gates (found, ``saving_frac >
    0``, the minimized repro re-failing solo on the card), the result
    equal to the reference's (``partition:0-3|4-63:1000:1001``, 28
    evaluations, every fork field), and the same campaign on the CPU:
    equal history, ``repro.json`` bytes and journal; world evaluations
    per second as the bench counts them;
47. the fork law at 100 000 nodes: ``chaos-0`` (the chaos pack's world 0)
    uninterrupted, and snapshotted at half its supersteps and forked into
    4 worlds (an empty suffix, a crash, a degrade, a partition): world 0 =
    the uninterrupted run, worlds 1-3 = their from-scratch solo runs,
    ``0 < saving_frac < 1``; K2 and K1 bit-equal to their plain versions
    on the fork fleet's busiest superstep, and their times there;
48. a campaign at 100 000 nodes: ``chaos-0`` without faults under
    ``convergence:LIMIT`` (its own quiescence instant), population 8, 3
    generations, ``fork_k`` 2, ``minimize_trials`` 2; a found repro
    re-fails solo on the card; then phase 46's and 48's journals and
    phase 42's predicted leg in the port's ``RunLedger``:
    ``fit_from_ledger`` = ``fit_rows``, the ``SweepWatch`` snapshot =
    ``status_fields``;

then the serving layer (``timewarp_tpu_torch/serve/``) and the network
stack (``net/``), every open bucket a ``TorchEngine(batch=...)`` on the
card whose ``run`` calls are recorded (K2 = K1 = the call's fleet
supersteps in each):

49. ``bench.py`` ``serve_gossip``'s eight configs (4096-node burst
    gossip, one faulted) at budgets 128/64, not the bench's 2000/1000
    (chip_smoke's time limit), into one 8-slot open bucket by a
    ``ServeCurator`` thread, half admitted before it starts and half
    while its first chunk runs, rebound onto the same engine; two legs,
    ``first-fit`` then ``predicted`` with an artifact fitted from the
    first leg's results: ``engine_builds`` 1 and one engine built, the
    late half's slots idle in the first ``run`` call and live in a later
    one (the bucket runs past its largest budget), every ``world_done``
    equal to its solo run on the CPU, one ``pack_decision`` before each
    admit naming its bucket (predicted); served configs/s, admissions/s,
    p50/p95 submit-to-``world_done``;
50. phase 43's chaos pack served at 100 000 nodes: four worlds admitted
    through a ``ServeFrontend``, the other four into the open bucket's
    reserved slots while curator ``a`` runs its first chunk, ``a``
    killed after its second chunk, which ran all eight (its lease left
    behind), curator ``b`` stealing the bucket after the lease TTL and
    draining it from the checkpoint: every streamed result equal to
    phase 43's solo runs, one ``world_done`` each, the steal journaled,
    each incarnation's engine builds as the rebuild rule counts them
    from the schedules, K2 and K1 bit-equal to their plain versions on
    the bucket's busiest superstep;
51. the wire and the multi-host sweep: two of phase 49's configs
    submitted over loopback TCP to the port's ``Rpc`` frontend under
    ``run_real_time`` with a curator thread on the card (the streamed
    records = phase 49's solo runs), and ``tests/test_zzzzzzzzzserve.py``'s
    multi-host pack through ``SweepService(host="a", inject="die:2")``
    then ``host="b"`` on the card and on the CPU: equal journals (the
    wall-clock fields and heartbeats aside), every result = its solo run;

then the multi-device slice (``timewarp_tpu_torch/parallel/``, the
sharded engines): two ranks of ``torch.distributed`` started by
``parallel.launch.spawn(..., backend="gloo", device="cuda")``, sharing
the card (NCCL refuses two ranks on one GPU; gloo ships each collective
through host copies), each phase's one-device run made first by this
process; every rank prints, for its phase, the wall a superstep, the
exchange's share of it (the ``all_to_all`` and the roll's sends with
their host staging, the device drained around each), the reductions'
share, and the device idle share of the rank and of the card (one minus
both ranks' kernel time over a profiled run's wall):

52. steady gossip at 2^20 (phase 21's configuration) on
    ``ShardedFusedSparseEngine`` and ``ShardedEngine`` over 2 ranks, 64
    supersteps through ``run``: both traces = ``TorchEngine``'s, the
    fused engine's gathered state = its final state leaf for leaf, the
    general engine's shard = the fused one's on each rank; K1 launched
    once per superstep on each rank (K1′: n_local = 2^19, S2 = D ·
    bucket_cap = 2^20) and K2-K4 not at all; K1′ on each rank's busiest
    superstep of the 64 against its plain version, bit-equal, and
    its time and bound there (bytes over 3.35 TB/s), one rank at a time;
    then ``ShardedFusedSparseEngine.run_verified`` for 32 supersteps in
    chunks of 8 under ``verify="digest"`` and ``"shadow"``, each with a
    flip on rank 1: = ``TorchEngine.run_verified`` with the same flip
    (trace, every leaf, the integrity record and its digest chain), K1′
    once per superstep the ranks ran;
53. the dense ring at 2^20 (phase 16's) on ``ShardedEdgeEngine``, 64
    supersteps = ``EdgeEngine``'s trace and every leaf;
54. the chaos fleet (phase 27's 8 worlds and schedules) on
    ``ShardedBatchedEngine``, 4 worlds a rank, to quiescence: every leaf
    of the gathered state = phase 27's final state, K2 and K1 once per
    fleet superstep on each rank; then ``run_verified`` (digest, 128
    fleet supersteps in chunks of 32, a flip on a world of rank 1) and
    ``run_stream`` (world b's budget 64 + 8b) = the one-device fleet's
    (traces, every leaf, integrity record; each world's ``on_quiesce``
    once, at its one-device superstep, with all 8 worlds);
55. the card's ranks against two CPU ranks at 2^12: ``ShardedEngine`` and
    ``ShardedFusedSparseEngine`` on a gossip wave, ``ShardedEdgeEngine``
    on a uniform ring, ``ShardedBatchedEngine`` on a 4-world faulted
    fleet; equal traces and every leaf; then the checkpoint leg: phase
    60's wave at 2^17 through the command line's rank path
    (``--engine sharded --save``, 48 supersteps) = the one-device run's
    summary and file, leaf for leaf, and a one-device ``--resume`` of it
    runs to the uninterrupted run's end;

then the analysis slice (``analysis/``, the oracle, ``obs/query.py``,
``obs/bisect.py``, ``obs/profiler.py``):

56. lint on the card: ``TorchEngine`` on the gossip wave at 2^17,
    ``FusedSparseEngine`` on Praos at 2^20, ``FusedRingEngine`` and
    ``EdgeEngine`` on the dense ring at 2^20, ``TorchEngine`` on steady
    gossip at 2^20, each built with ``lint="error"`` (the construction
    lint's ms printed), its superstep body scanned
    (``lint_engine_jaxpr``: no TW700) and its off modes proven neutral
    (TW705); every (code, severity) set = the same engine's at 2^12 on
    the CPU;
57. ``bisect_engines`` on phase 4's wave at 2^17 (32 supersteps in
    chunks of 16, the flip's chunk the last): none
    between two clean runs; against ``flip:2:2:time`` the pinned line
    names chunk 1 and superstep 16; at 2^12 the card's line = the CPU
    leg's; then the port's ``SuperstepOracle`` on the card =
    ``TorchEngine`` on the card at 1024 nodes (trace, states, wakes,
    counters); only the 2^17 bisection's launches join the kernels
    line's counts, the oracle leg's are printed apart;
58. world 0 of phase 27's chaos fleet solo, 8 supersteps around node
    3's reset crash recorded in full at 100 000 nodes: ``explain_delivery``
    of a delivery to node 3 is a well-formed chain (its send recorded
    and earlier, the crash window named); K2 and K1 once per recorded
    superstep; at 2^12 the ``FlightLog`` and chain = the CPU leg's;
59. ``profile_session`` around 16 supersteps of the gossip wave at 2^17:
    the Chrome trace parses and names K2 and K1 once per superstep;

then the command line and the cross-world twins (60-64, each phase
function's docstring), and the parity artifact and the examples:

65. ``tools/parity_cuda.py``'s ``run_row`` on the card for
    ``gossip-1024-burst-windowed`` with its fused and batched columns (K2
    and K1 once per superstep of the adaptive main run, K3 once per fused
    superstep, K2 and K1 across the 3 worlds) and ``gossip-64-drop`` with
    its faulted column (K1 once per superstep on the eager path, K2 not
    at all): the oracle on the CPU = the engines on the card, and every
    digest, flag and count = the reference's ``PARITY_TPU.json``; then
    ``examples/torch/chaos.py``, ``cross_world.py --nodes 12`` and
    ``token_ring.py --engine --nodes 8`` in this process on the card,
    each stdout = the same argv's on the CPU;

then the bench script:

66. ``bench_cuda.py --smoke`` on the card in this process for
    ``token_ring_dense``, ``gossip_100k_insert``, ``praos_1m_fused`` and
    ``gossip_100k_chaos`` (K4, K2 and K1, K3, K2 and K1 across 8
    worlds), every in-bench gate on: one line each with the bench
    line's keys, ``platform`` ``cuda``, the card's name and
    ``nvidia-smi``'s power limit; each of K1-K4 launched (the insert
    gate's kernel-against-plain and timing launches apart);

then the NCCL leg:

67. ``tools/multichip_cuda.py``'s rows 1-3 (``__graft_entry__.py``'s
    ``dryrun_multichip``: the token ring of 32 nodes through
    ``ShardedEdgeEngine``, gossip of 16 nodes through ``ShardedEngine``,
    burst gossip under a 2 000 µs window) in ONE NCCL rank on ``cuda:0``
    (``spawn(..., backend="nccl")``: every collective of ``MeshComm``
    on device tensors, the exchange's data moving only on the card),
    each equal to its one-device run on the card (traces, every leaf,
    the rows' invariants), K1 once per superstep on rows 2 and 3; the
    four-card rows are the tool's alone.

The card-against-CPU phases (5, 11, 18, 23, 28, 36, 40, 55, 56, 57,
58 and 65) run
their card legs here and take their CPU legs from a second process
(``chip_smoke.py --cpu-legs DIR``, started with the script, the card
hidden from it, two torch threads; phase 55's CPU ranks one thread each)
that runs every CPU leg in phase order while the card phases run, so that
the CPU legs' time is not on the script's wall; so do phases 42 and 49
take their solo twins (every config's ``solo_result``, run on the CPU
there). A phase's comparison with its CPU leg runs at the end of the
first phase after which the leg is done (or at the script's end); it
prints the leg's wall there and how long it was waited for (``CPU leg
...:``).

Wall-clock overheads are printed and gated at 2x at most (the host is
shared). Every phase prints its wall (``phase N wall_s=``), and the
script its total (``chip_smoke wall_s=``). Then one ``{"kernels": [...]}`` line (K1's ``launches`` summed
over its main paths, phases 4, 21, 27, 34, 38, 39, 42, 43, 46-51, 54 and
57-67, K2's over phases 4, 27, 34, 38, 39, 42, 43, 46-51, 54 and 57-66,
K3's over phases 9, 61, 65 and 66, K4's over phases 16 and 66;
K1′,
``mailbox_insert_per_shard``, phase 52's ranks' K1 launches (its verified
legs' included), its times from phase 52; every other time from phases 6, 13 and 19), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np

# the workload builders and kernel timing helpers: bench_cuda.py's, one copy
from bench_cuda import (  # noqa: E402
    HBM_BYTES_PER_S, bursty_gossip, chaos_fleet, dense_ring, gossip_wave,
    hetero_pack, host_state as _host_state, k1_bytes, nvidia_smi,
    praos_consensus, praos_link, search_base, serve_gossip_configs,
    spec_gossip, stage_args as _stage_args, stage_times, steady_gossip)
from bench_cuda import time_ms as _time_ms  # noqa: E402

SLICE_N, SLICE_M, SLICE_P, SLICE_W, SLICE_S = 1 << 17, 8, 1, 8_000, 1 << 18
SLICE_K = 16
# K2's wide build (payloads past the 27 words the narrow build stages on
# an H100) at a small shape: 2^12 nodes, 2 outbox slots, S = 2^13, at 32
# words and at the widest payload K2 takes
WIDE_N, WIDE_M, WIDE_S, WIDE_P = 1 << 12, 2, 1 << 13, (32, 1022)
K2_REPLACES = "timewarp_tpu/interp/jax_engine/pallas_insert.py:656"
K1_REPLACES = "timewarp_tpu/interp/jax_engine/pallas_insert.py:465"
K3_REPLACES = "timewarp_tpu/interp/jax_engine/pallas_insert.py:259"
# the fused slice: Praos at 2^20 stake nodes, payload 2, fanout 8
PRAOS_N, PRAOS_P, PRAOS_S = 1 << 20, 2, (1 << 20) * SLICE_M
# the static-topology slice: the dense token ring at 2^20 nodes
RING_N = 1 << 20
# the eager routing slice: steady gossip at 2^20 nodes
STEADY_N = 1 << 20
# the world-axis and faults slice: bench.py's chaos fleet, 8 worlds of
# 100 000 nodes
CHAOS_N, CHAOS_B = 100_000, 8
# the chaos pack's budget in phases 43 and 50: its worlds quiesce in
# 304-515 supersteps; 192 (three chunks of 64, about 190 ms of virtual
# time) covers every fault window (the last ends at 120 ms) and keeps
# chip_smoke inside its time limit on slow hosts
CHAOS_PACK_BUDGET = 192
K4_REPLACES = "timewarp_tpu/interp/jax_engine/fused_ring.py:468"
# the port's kernels as the profiler names them
PORT_KERNELS = ("fire_compact_kernel", "mailbox_insert_kernel",
                "sample_insert_kernel", "fused_ring_kernel")
# Instructions per clock of one SM of compute capability 9.0, by pipe (the
# CUDA C++ Programming Guide's arithmetic-instruction throughput table):
# 32-bit integer add, multiply-add, shift, compare and logic 64; float32
# add, multiply and FMA 128; special functions and conversions 16; and at
# most 128 instructions of any kind issued (4 schedulers of 32 lanes).
SM90_PER_CLOCK = {"int": 64, "fp32": 128, "mufu": 16, "any": 128}
SASS_INT = {"IADD3", "IADD", "IMAD", "IMUL", "IMNMX", "VIMNMX", "VIADD",
            "ISETP", "LOP3", "LOP", "SHF", "SHL", "SHR", "SEL", "LEA",
            "IABS", "POPC", "FLO", "PRMT", "BMSK", "SGXT", "BREV", "ISCADD"}
SASS_FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
             "FCHK", "FSWZADD"}
SASS_MUFU = {"MUFU", "F2I", "I2F", "F2F", "I2I", "FRND", "I2FP", "F2IP"}


def say(*parts) -> None:
    print(*parts, flush=True)


def _equal(name, got, want) -> int:
    """Bit-equality of two tensors (or tuples of them); returns the max
    absolute difference (0) for the kernels line."""
    import torch
    if isinstance(got, tuple):
        return max(_equal(f"{name}[{i}]", g, w)
                   for i, (g, w) in enumerate(zip(got, want)))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    diff = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain (max abs diff {diff})")
    return diff


# -- inputs, made with numpy from a seed ----------------------------------

def compact_inputs(device, n, M, P, frac, seed):
    import torch
    rng = np.random.default_rng(seed)
    pdst = np.where(rng.random((M, n)) < frac,
                    rng.integers(0, n, (M, n)), -1).astype(np.int32)
    woff = rng.integers(0, SLICE_W, n).astype(np.int32)
    pay = rng.integers(-2**31, 2**31 - 1, (M, P, n)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (pdst, woff, pay))


def insert_inputs(device, n, K, P, S, ordered, with_src, seed, frac=0.7,
                  hot=True, extra=(), counts=None, apart=False):
    """A mailbox half full (ordered: each node's first ``counts[d]`` rows
    kept, drawn at random unless ``counts`` gives one for every node; with
    ``apart`` its holes are drawn at random, apart from ``counts``, so
    that only ``counts`` tells the rows to fill) and
    a destination-sorted batch of width ``S``, a ``frac`` share valid,
    whose 64 hot destinations overfill their mailboxes (unless not
    ``hot``); ``extra`` adds ``(node, count)`` messages after removing
    that node's own (a count of 0 leaves the node none). Made with numpy
    from ``seed``."""
    import torch
    rng = np.random.default_rng(seed)
    I32MAX = 2**31 - 1
    if ordered:
        kept = rng.integers(0, K + 1, n).astype(np.int32)
        if counts is not None:
            kept[:] = counts
        live = rng.random((K, n)) < 0.5 if apart \
            else np.arange(K)[:, None] < kept[None, :]
        mb_rel = np.where(live, rng.integers(0, 1 << 20, (K, n)),
                          I32MAX).astype(np.int32)
    else:
        kept = None
        mb_rel = np.where(rng.random((K, n)) < 0.5,
                          rng.integers(0, 1 << 20, (K, n)),
                          I32MAX).astype(np.int32)
    n_msgs = int(S * frac)
    hot_nodes = rng.integers(0, n, 64) if hot else None
    dst = rng.integers(0, n, n_msgs - 64 * 24 if hot else n_msgs)
    if hot:
        dst = np.concatenate([dst, np.repeat(hot_nodes, 24)])
    for node, count in extra:
        dst = np.concatenate([dst[dst != node], np.full(count, node)])
    sd = np.full(S, n, np.int32)
    sd[:dst.size] = np.sort(dst)
    arrs = dict(
        sd=sd, counts=kept, mb_rel=mb_rel,
        drel=rng.integers(0, 1 << 20, S).astype(np.int32),
        src=rng.integers(0, n, S).astype(np.int32) if with_src else None,
        pay=rng.integers(-2**31, 2**31 - 1, (P, S)).astype(np.int32),
        mb_src=rng.integers(0, n, (K, n)).astype(np.int32),
        mb_payload=rng.integers(-2**31, 2**31 - 1, (K, P, n)).astype(np.int32))
    return {k: None if v is None else torch.from_numpy(v).to(device)
            for k, v in arrs.items()}


def insert_args(t, n):
    from timewarp_tpu_torch.interp.torch_engine.cuda_insert import \
        bucket_bounds
    start, cnt = bucket_bounds(t["sd"], n)
    return (start, cnt, t["counts"], t["drel"], t["src"], t["pay"],
            t["mb_rel"], t["mb_src"], t["mb_payload"])


# -- phases ---------------------------------------------------------------

def phase_compact(device, n=SLICE_N, S=SLICE_S):
    """K2 against its plain version: the slice shape (sparse, dense enough
    to drop, window 1), then the edges of the one-launch design: n below
    one segment, n = 5000 (blocks of one row), 2^20 nodes (more units a
    CTA than one batch of loads), S just below the fired count (the write
    order decides the drops), a long sentinel tail, and two calls in a
    row on different inputs."""
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    err = 0

    def check(tag, pdst, w, pay, S, want_drops):
        nonlocal err
        got = ci.fire_compact(pdst, w, pay, S)
        want = ci.fire_compact_plain(pdst, w, pay, S)
        err = max(err, _equal(f"K2 {tag}", got, want))
        drops = int(got[4])
        if want_drops != (drops > 0):
            raise AssertionError(f"K2 {tag}: drops={drops}")
        say(f"K2 {tag}: n={pdst.shape[1]} fired={int((pdst >= 0).sum())} "
            f"S={S} drops={drops} bit-equal")
        return got

    for tag, frac, window1, seed in (("sparse", 0.2, False, 1),
                                     ("dense", 0.6, False, 2),
                                     ("window 1", 0.2, True, 3)):
        pdst, woff, pay = compact_inputs(device, n, SLICE_M, SLICE_P, frac,
                                         seed)
        check(tag, pdst, None if window1 else woff, pay, S, tag == "dense")
    for tag, nn, P, frac, SS, drops, seed in (
            ("n 1000 < one segment, payload 3", 1000, 3, 0.3, 4096, False,
             20),
            ("n 5000 (RW 1)", 5000, SLICE_P, 0.3, 1 << 14, False, 21),
            ("n 2^20", 1 << 20, SLICE_P, 0.2, 1 << 21, False, 22),
            ("S just below fired", n, SLICE_P, 0.2, None, True, 23),
            ("long tail, payload 0", n, 0, 0.02, S, False, 24),
            ("payload 7, staging above 48 KB", n, 7, 0.2, S, False, 27)):
        pdst, woff, pay = compact_inputs(device, nn, SLICE_M, P, frac, seed)
        if SS is None:
            SS = int((pdst >= 0).sum()) - 1000
        check(tag, pdst, woff, pay, SS, drops)
    if WIDE_P[-1] != ci.COMPACT_MAX_P:
        raise AssertionError(f"WIDE_P ends at {WIDE_P[-1]}, K2 takes up to "
                             f"{ci.COMPACT_MAX_P}")
    for P in WIDE_P:
        # past the payload the narrow build stages: the wide build
        pdst, woff, pay = compact_inputs(device, WIDE_N, WIDE_M, P, 0.6, P)
        check(f"payload {P}, the wide build (narrow up to "
              f"{ci.compact_narrow_max(device.index or 0)})", pdst, woff,
              pay, WIDE_S, False)
    a, b = (compact_inputs(device, n, SLICE_M, SLICE_P, f, sd)
            for f, sd in ((0.3, 25), (0.1, 26)))
    first = ci.fire_compact(a[0], a[1], a[2], S)
    check("two calls in a row, the second", b[0], b[1], b[2], S, False)
    err = max(err, _equal("K2 two calls in a row, the first", first,
                          ci.fire_compact_plain(a[0], a[1], a[2], S)))
    return err


def k1_cases(n=SLICE_N, S=SLICE_S, ns=1 << 16):
    """K1's cases for phase 3: ``(tag, modes, insert_inputs keywords)``,
    the slice shape first, then the edges of the tile walk (tiles of 256
    nodes, 16 rows of a column staged in shared memory, an entry buffer of
    8 entries a node before a tile chunks); ``ns`` nodes where K or P is
    large. The mode "ordered-apart" is the ordered one on a mailbox whose
    holes are drawn apart from its ``counts``."""
    both = ("commutative", "ordered", "ordered-apart")
    ordered = both[1:]
    return [
        ("slice shape K 16, P 1", ("commutative",),
         dict(n=n, K=SLICE_K, P=SLICE_P, S=S, with_src=False, seed=4)),
        ("K 8, P 2, src", ordered,
         dict(n=n, K=8, P=2, S=S, with_src=True, seed=5)),
        ("n + 3 nodes, not a multiple of the tile", both,
         dict(n=n + 3, K=SLICE_K, P=SLICE_P, S=S, with_src=False, seed=40)),
        ("K 40, node 257 gets 8192 entries after node 256 none (tiles "
         "chunk)", both,
         dict(n=ns, K=40, P=1, S=32 * ns, with_src=True, seed=41, frac=0.9,
              extra=((256, 0), (257, 8192)))),
        ("empty batch", both,
         dict(n=n, K=SLICE_K, P=SLICE_P, S=n, with_src=False, seed=42,
              frac=0.0, hot=False)),
        ("K 1, P 3, src", both,
         dict(n=ns, K=1, P=3, S=4 * ns, with_src=True, seed=43)),
        ("K 40, P 0 (rows past the staged 16; tiles chunk)", both,
         dict(n=ns, K=40, P=0, S=32 * ns, with_src=False, seed=44,
              frac=0.9)),
        ("K 130, P 3, src, node 300 gets 200 entries (tiles chunk)", both,
         dict(n=ns, K=130, P=3, S=32 * ns, with_src=True, seed=45,
              frac=0.9, extra=((300, 200),))),
        ("K 16, P 7, src (an entry buffer above 48 KB)", both,
         dict(n=ns, K=SLICE_K, P=7, S=8 * ns, with_src=True, seed=46)),
        ("every counts 0, K 16, P 1, src", ordered,
         dict(n=n, K=SLICE_K, P=SLICE_P, S=S, with_src=True, seed=47,
              counts=0)),
        ("every counts K, K 16, P 1, src", ordered,
         dict(n=n, K=SLICE_K, P=SLICE_P, S=S, with_src=True, seed=48,
              counts=SLICE_K)),
        ("every counts 0, K 40, P 1", ordered,
         dict(n=ns, K=40, P=1, S=32 * ns, with_src=False, seed=49,
              frac=0.9, counts=0)),
        ("every counts K, K 130, P 1", ordered,
         dict(n=ns, K=130, P=1, S=8 * ns, with_src=False, seed=50,
              counts=130)),
    ]


def phase_insert(device, **sizes):
    """K1 against its plain version, bit for bit, in every case of
    :func:`k1_cases` (``sizes`` passed to it)."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    err = 0
    for tag, modes, kw in k1_cases(**sizes):
        for mode in modes:
            t = insert_inputs(device, ordered=mode != "commutative",
                              apart=mode == "ordered-apart", **kw)
            n = kw["n"]
            args = insert_args(t, n)
            got = ci.mailbox_insert(*args)
            want = ci.mailbox_insert_plain(*args)
            err = max(err, _equal(f"K1 {mode} {tag}", got, want))
            valid = int(args[1].sum())
            ovf = int(got[3])
            rows = torch.arange(kw["K"], device=device)[:, None]
            apart = mode != "ordered-apart" or bool(
                ((t["mb_rel"] == 2**31 - 1)
                 != (rows >= t["counts"][None, :])).any())
            say(f"K1 {mode} {tag}: n={n} K={kw['K']} P={kw['P']} "
                f"src={kw['with_src']} valid={valid} overflow={ovf} "
                "bit-equal")
            _require_all(f"K1 {mode} {tag}", {
                "valid == 0 iff the batch is empty":
                    (valid == 0) == tag.startswith("empty"),
                "overflow > 0 unless the batch is empty":
                    (ovf > 0) != tag.startswith("empty"),
                "every message overflows when every counts is K":
                    ovf == valid or "counts K," not in tag,
                "ordered-apart: holes other than the rows past counts":
                    apart})
    return err


def phase_main_path(device, n=SLICE_N, cap=SLICE_S):
    import torch
    from timewarp_tpu_torch.core.scenario import NEVER
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    sc, link = gossip_wave(n)
    eng = TorchEngine(sc, link, window="auto", insert_cap=cap, device=device)
    ci.reset_launches()
    fin = eng.run_quiet(1 << 20)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(ci.LAUNCHES)
    stats = eng.last_run_stats
    steps, delivered = stats["supersteps"], int(fin.delivered)
    missed = int((fin.states["hop"] < 0).sum())
    checks = {
        "quiesced": int(eng._next_event(fin)) >= NEVER,
        "short_delay == 0": int(fin.short_delay) == 0,
        "route_drop == 0": int(fin.route_drop) == 0,
        "bad_delay == 0": int(fin.bad_delay) == 0,
        f"missed {missed} <= n/500": missed <= max(n // 500, 8),
    }
    if device.type == "cuda":
        checks.update({f"{k} launched once per superstep":
                       launches[k] == steps
                       for k in ("fire_compact", "mailbox_insert")})
    say(f"main path: gossip wave n={n} window={eng.window} "
        f"insert_cap={cap} supersteps={steps} delivered={delivered} "
        f"overflow={int(fin.overflow)} wall_s={stats['wall_seconds']} "
        f"delivered_msgs_per_s={delivered / stats['wall_seconds']} "
        f"launches={launches}")
    _require_all("main path", checks)
    return launches, steps, fin


def _require_all(what, checks) -> None:
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{what} invariants failed: {bad}")


def _states_equal(what, a, b, sc=None) -> None:
    """Every leaf of two ``EngineState``s or ``EdgeState``s equal (any
    devices)."""
    _np_states_equal(what, _host_state(a, sc), _host_state(b, sc))


# -- card against CPU: each phase's CPU leg beside the card phases ----------

#: The card-against-CPU phases' legs, in phase order: ``leg(dev)`` runs a
#: phase's cases on one device and returns what the phase compares, on the
#: host. A phase runs its card leg itself and takes its CPU leg from
#: :class:`CpuLegs`: a second process, started with the script and hidden
#: from the card, that runs every CPU leg in this order while the card
#: phases run, so that the CPU legs' time is not on the script's wall.
CPU_LEGS = {}


def cpu_leg(key):
    """Register a leg function under ``key`` (see :data:`CPU_LEGS`)."""
    def register(fn):
        CPU_LEGS[key] = fn
        return fn
    return register


class CpuLegs:
    """The process that runs :data:`CPU_LEGS` on the CPU
    (``chip_smoke.py --cpu-legs DIR``, ``CUDA_VISIBLE_DEVICES`` empty, two
    torch threads), each leg's result pickled to ``DIR/<key>.pkl`` as it
    is done. :meth:`defer` holds a phase's card leg and its check until
    :meth:`drain` finds the CPU leg done (after every phase; at the end it
    waits); :meth:`get` waits for one leg. A leg that raised ends the
    process and fails the script, with the process's log. :meth:`stop`
    kills the process and every rank it started (its own session) if it
    still runs, and removes ``DIR``."""

    def __init__(self):
        import os
        import tempfile
        here = os.path.dirname(os.path.abspath(__file__))
        base = os.path.join(here, "build", "cpu-legs")
        os.makedirs(base, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="legs-", dir=base)
        self.log_path = os.path.join(self.dir, "legs.log")
        self.log = open(self.log_path, "w")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-legs",
             self.dir], stdout=self.log, stderr=subprocess.STDOUT, env=env,
            cwd=here, start_new_session=True)
        self.pending = []

    def defer(self, key, card, check):
        self.pending.append((key, card, check))

    def drain(self, wait=False):
        """Run the deferred checks whose CPU legs are done (``wait``:
        every one, waiting for its leg)."""
        import os
        keep = []
        for key, card, check in self.pending:
            if wait or self.proc.poll() not in (None, 0) or os.path.exists(
                    os.path.join(self.dir, f"{key}.pkl")):
                check(card, self.get(key))
            else:
                keep.append((key, card, check))
        self.pending = keep

    def get(self, key, timeout=1200.0):
        import os
        import pickle
        path = os.path.join(self.dir, f"{key}.pkl")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if self.proc.poll() is not None and not os.path.exists(path):
                with open(self.log_path) as f:
                    tail = f.read()[-6000:]
                raise AssertionError(
                    f"CPU leg {key}: the CPU legs' process exited with code "
                    f"{self.proc.returncode} before it; its log:\n{tail}")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"CPU leg {key}: not done in "
                                     f"{timeout} s")
            time.sleep(0.05)
        waited = time.perf_counter() - t0
        with open(path, "rb") as f:
            out, wall = pickle.load(f)
        say(f"CPU leg {key}: wall_s={wall} in the CPU legs' process, "
            f"waited_s={waited}")
        return out

    def stop(self):
        import os
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


#: the running :class:`CpuLegs`, or None: then :func:`vs_cpu` runs the
#: CPU leg in this process, after the card's
LEGS = None


def vs_cpu(key, device, check):
    """The card leg of the phase registered as ``key`` now; then
    ``check(card, cpu)`` against its CPU leg: at once without
    :data:`LEGS`, else as soon as the CPU legs' process has it (at a later
    phase's end, or at the script's)."""
    against_cpu(key, CPU_LEGS[key](device), check)


def against_cpu(key, card, check):
    """``check(card, cpu)`` for a card result ``card`` (a leg's, or one
    the phase made at its own sizes) against the CPU leg registered as
    ``key``: at once without :data:`LEGS`, else as soon as the CPU legs'
    process has it."""
    if LEGS is None:
        check(card, CPU_LEGS[key]("cpu"))
    else:
        LEGS.defer(key, card, check)


def cpu_legs_main(outdir) -> int:
    """``--cpu-legs DIR``: every leg of :data:`CPU_LEGS` on the CPU, in
    order, each result pickled with its wall."""
    import os
    import pickle

    import torch
    torch.set_num_threads(2)
    for key, leg in CPU_LEGS.items():
        t0 = time.perf_counter()
        out = leg("cpu")
        wall = time.perf_counter() - t0
        tmp = os.path.join(outdir, f"{key}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump((out, wall), f)
        os.replace(tmp, os.path.join(outdir, f"{key}.pkl"))
        print(f"CPU leg {key}: wall_s={wall}", flush=True)
    return 0


def _traced_leg(engine_cls, sc, link, dev, steps=1 << 16, **kw):
    """``run`` for ``steps`` supersteps (default: to quiescence) on
    ``dev``: the final state's leaves and the trace."""
    st, tr = engine_cls(sc, link, window="auto", seed=11, device=dev,
                        **kw).run(steps)
    return dict(state=_host_state(st, sc), trace=tr)


def _legs_equal(what, card, cpu) -> None:
    """Equal traces (per world for a fleet) and final states."""
    _same_traces(what, card["trace"], cpu["trace"])
    _np_states_equal(what, card["state"], cpu["state"])


@cpu_leg("wave")
def leg_wave(dev, n=1 << 14):
    """Phase 5's leg: an integer-link gossip wave to quiescence."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.delays import Quantize, UniformDelay
    sc = gossip(n, fanout=8, think_us=2_000, burst=True, end_us=5_000_000,
                mailbox_cap=8)
    link = Quantize(UniformDelay(8_000, 30_000), 1_000)
    return dict(_traced_leg(TorchEngine, sc, link, dev), n=n)


def phase_card_vs_cpu(device):
    def check(card, cpu):
        _legs_equal("card vs CPU", card, cpu)
        st = card["state"]
        say(f"card vs CPU: gossip n={card['n']} supersteps="
            f"{len(card['trace'])} delivered={int(st['delivered'])} "
            f"overflow={int(st['overflow'])} traces and states equal")
    vs_cpu("wave", device, check)


def phase_where_time_goes(tag, eng, warm, steps, run=None, mid=None):
    """``steps`` supersteps of ``eng``'s run from superstep ``warm`` (or
    from the state ``mid``): their wall time unprofiled, then the same
    supersteps under ``torch.profiler`` for the device's kernel time and
    launch count. ``run(k, state)`` drives them (default
    ``eng.run_quiet``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run = eng.run_quiet if run is None else run
    if mid is None:
        mid = run(warm, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps, mid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the device's activity only: the host's operator events are not read,
    # and recording them costs seconds of host time a phase
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(steps, mid)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    say(f"where the time goes, {tag}: {steps} supersteps from superstep "
        f"{warm}: "
        f"wall_ms_per_superstep={wall / steps * 1e3} "
        f"device_ms_per_superstep={dev_us / steps / 1e3} "
        f"device_idle_share={1 - dev_us / 1e6 / wall} "
        f"device_launches_per_superstep={launches / steps}")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # the eight longest, and the port's own kernels wherever they rank
    for i, e in enumerate(ranked):
        if i < 8 or any(k in e.key for k in PORT_KERNELS):
            say(f"  device_us_per_superstep={e.self_device_time_total / steps}"
                f" launches_per_superstep={e.count / steps} rank={i + 1} "
                f"{e.key[:90]}")


def time_k1(device, ordered, with_src, seed=4):
    """K1's time at the slice shape (K 16, P 1), its plain version's time
    and its bound (:func:`k1_bytes`)."""
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    t = insert_inputs(device, SLICE_N, SLICE_K, SLICE_P, SLICE_S, ordered,
                      with_src, seed)
    args = insert_args(t, SLICE_N)
    k1_bytes_ = k1_bytes(args)
    return dict(ms=_time_ms(lambda: ci.mailbox_insert(*args)),
                plain_ms=_time_ms(lambda: ci.mailbox_insert_plain(*args),
                                  queued=False),
                bound_ms=k1_bytes_ / HBM_BYTES_PER_S * 1e3, bytes=k1_bytes_)


def time_k2(device, n, M, P, S, frac, seed):
    """K2's time, its plain version's and its bound (the outbox planes
    read once, the fired lanes' payload words, the batch written) on
    inputs of :func:`compact_inputs`."""
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    pdst, woff, pay = compact_inputs(device, n, M, P, frac, seed)
    fired = int((pdst >= 0).sum())
    nbytes = (pdst.numel() + woff.numel()) * 4 + fired * P * 4 \
        + (3 + P) * S * 4
    return dict(ms=_time_ms(lambda: ci.fire_compact(pdst, woff, pay, S)),
                plain_ms=_time_ms(lambda: ci.fire_compact_plain(
                    pdst, woff, pay, S), queued=False),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)


def phase_times(device):
    import torch
    k2 = time_k2(device, SLICE_N, SLICE_M, SLICE_P, SLICE_S, 0.2, 1)
    k2_wide = {P: time_k2(device, WIDE_N, WIDE_M, P, WIDE_S, 0.6, P)
               for P in WIDE_P}
    k1, k1_ordered = (time_k1(device, ordered, ordered)
                      for ordered in (False, True))
    say(f"timing floor: one empty launch between the events, ms="
        f"{_time_ms(lambda: torch.cuda._sleep(0))}")
    for name, r in (("fire_compact", k2), *(
            (f"fire_compact wide build P={P} n={WIDE_N} M={WIDE_M} "
             f"S={WIDE_S}", r) for P, r in k2_wide.items()),
            ("mailbox_insert", k1),
            ("mailbox_insert ordered, src", k1_ordered)):
        say(f"time {name}: kernel_ms={r['ms']} plain_ms={r['plain_ms']} "
            f"bound_ms={r['bound_ms']} (bytes {r['bytes']} over 3.35 TB/s; "
            f"{nvidia_smi()}; no single PyTorch call computes this "
            "function: library_ms null)")
    return k2, k1


# -- the fused-sparse slice: K3 and Praos at 2^20 ---------------------------

def sample_inputs(device, n=PRAOS_N, K=SLICE_K, P=PRAOS_P, S=PRAOS_S,
                  seed=8, frac=0.6, hot=True, extra=(), src=False):
    """A mailbox half full and a batch of width ``S`` sorted by ``(dst,
    woff, smrank)``, a ``frac`` share valid, whose 64 hot destinations
    overfill their mailboxes (unless not ``hot``); ``extra`` adds
    ``(node, count)`` messages after removing that node's own (a count
    of 0 leaves the node none); ``src`` gives the inbox a src
    plane. Made with numpy from ``seed``, sorted on ``device``."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine.cuda_insert import \
        bucket_bounds
    from timewarp_tpu_torch.interp.torch_engine.engine import sort_batch
    rng = np.random.default_rng(seed)
    I32MAX = 2**31 - 1
    n_msgs = int(S * frac)

    def dev(a):
        return torch.from_numpy(a).to(device)
    parts = [rng.integers(0, n, n_msgs - 64 * 24 if hot else n_msgs)]
    if hot:
        parts.append(np.repeat(rng.integers(0, n, 64), 24))
    dst = np.concatenate(parts)
    for node, count in extra:
        dst = np.concatenate([dst[dst != node], np.full(count, node)])
    n_msgs = dst.size
    dst = dev(dst.astype(np.int32))
    woff = dev(rng.integers(0, SLICE_W, n_msgs).astype(np.int32))
    smrank = rng.permutation(n * SLICE_M)[:n_msgs] if n_msgs <= n * SLICE_M \
        else rng.integers(0, n * SLICE_M, n_msgs)
    smrank = dev(smrank.astype(np.int32))
    perm = sort_batch(dst, woff, smrank)

    def col(x, fill):
        out = torch.full((S,), fill, dtype=torch.int32, device=device)
        out[:n_msgs] = x[perm]
        return out
    sd = col(dst, n)
    start, cnt = bucket_bounds(sd, n)
    t = dict(
        start=start, cnt=cnt, sd=sd, woff=col(woff, 0),
        smrank=col(smrank, 0),
        pay=dev(rng.integers(-2**31, I32MAX, (P, S)).astype(np.int32)),
        mb_rel=dev(np.where(rng.random((K, n)) < 0.5,
                            rng.integers(0, 1 << 20, (K, n)),
                            I32MAX).astype(np.int32)),
        mb_src=torch.zeros((K, n), dtype=torch.int32, device=device),
        mb_payload=dev(rng.integers(-2**31, I32MAX, (K, P, n)).astype(
            np.int32)),
        inbox_src=src)
    if src:
        t["mb_src"] = dev(rng.integers(0, n, (K, n)).astype(np.int32))
    return t


def k3_call(fn, t, tt, link, s0=0x1234, s1=0x5678):
    """``fn`` (K3's wrapper or its plain version) on the inputs ``t``,
    epoch ``tt`` (a 0-d int64 tensor) and lowered ``link``."""
    return fn(t["start"], t["cnt"], t["sd"], t["woff"], t["smrank"],
              t["pay"], tt, t["mb_rel"], t["mb_src"], t["mb_payload"],
              link=link, s0=s0, s1=s1, M=SLICE_M, W=SLICE_W,
              inbox_src=t["inbox_src"])


def k3_links():
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        lower_link
    from timewarp_tpu_torch.net import delays as d
    qln = praos_link()
    return [("fixed", lower_link(d.FixedDelay(9_000)), 1 << 36),
            ("uniform", lower_link(d.UniformDelay(8_000, 30_000)), 1 << 36),
            ("seeded-hash", lower_link(d.SeededHashUniform(8_000, 30_000,
                                                           7)), 1 << 36),
            ("quantized-lognormal", lower_link(qln), 1 << 36),
            ("short fixed 3000 < W", lower_link(d.FixedDelay(3_000)),
             1 << 36),
            ("carry: t = 2^32 - 4000", lower_link(qln), 2**32 - 4_000)]


def phase_sample_insert(device, t):
    """K3 against its plain version on the inputs ``t`` (sample_inputs),
    per link kind."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    err = 0
    for tag, link, t0 in k3_links():
        tt = torch.tensor(t0, dtype=torch.int64, device=device)
        got = k3_call(ci.sample_insert, t, tt, link)
        want = k3_call(ci.sample_insert_plain, t, tt, link)
        torch.cuda.synchronize()
        unequal = int((got[0] != want[0]).sum())
        diff = max(int((g.long() - w.long()).abs().max())
                   for g, w in zip(got, want))
        ovf, bad, short = (int(x) for x in got[3:])
        say(f"K3 {tag}: S={t['sd'].numel()} valid={int(t['cnt'].sum())} "
            f"overflow={ovf} bad_delay={bad} short_delay={short} "
            f"max_abs_err={diff} unequal_drel={unequal}")
        err = max(err, _equal(f"K3 {tag}", got, want))
        _require_all(f"K3 {tag}", {
            "overflow > 0": ovf > 0,
            "short_delay > 0 iff the delay is below W":
                (short > 0) == tag.startswith("short")})
    return max(err, phase_sample_insert_edges(device))


def phase_sample_insert_edges(device, n=PRAOS_N, ns=1 << 18):
    """K3 against its plain version at the edges of the tiled design
    (tiles of 256 nodes, 16 rows of a column staged in shared memory,
    an entry buffer of 8 entries a node before a tile chunks), on the Praos link; ``ns`` nodes
    where K or P is large."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        lower_link
    link = lower_link(praos_link())
    tt = torch.tensor(1 << 36, dtype=torch.int64, device=device)
    err = 0
    for tag, kw in (
            ("n + 3 nodes, not a multiple of the tile",
             dict(n=n + 3, S=4 * n, seed=30)),
            ("node 257 gets 8192 entries (> 256 x 16), node 256 none",
             dict(n=n, S=4 * n, frac=0.5, seed=31,
                  extra=((256, 0), (257, 8192)))),
            ("empty batch", dict(n=n, S=n, frac=0.0, hot=False, seed=32)),
            ("K 1, P 3, src", dict(n=ns, K=1, P=3, S=4 * ns, src=True,
                                   seed=33)),
            ("K 40, P 0 (rows past the staged 16; tiles chunk)",
             dict(n=ns, K=40, P=0, S=32 * ns, frac=0.9, seed=34)),
            ("K 130, P 3, src (tiles chunk)",
             dict(n=ns, K=130, P=3, S=32 * ns, frac=0.9, src=True,
                  seed=35)),
            ("K 16, P 7, src (an entry buffer above 48 KB)",
             dict(n=ns, K=16, P=7, S=8 * ns, src=True, seed=36))):
        t = sample_inputs(device, **kw)
        got = k3_call(ci.sample_insert, t, tt, link)
        want = k3_call(ci.sample_insert_plain, t, tt, link)
        torch.cuda.synchronize()
        err = max(err, _equal(f"K3 {tag}", got, want))
        valid = int(t["cnt"].sum())
        say(f"K3 {tag}: n={t['cnt'].numel()} K={t['mb_rel'].shape[0]} "
            f"P={t['pay'].shape[0]} src={t['inbox_src']} valid={valid} "
            f"overflow={int(got[3])} bit-equal")
        if (valid == 0) != tag.startswith("empty"):
            raise AssertionError(f"K3 {tag}: valid={valid}")
    return err


def phase_praos_main_path(device, n=PRAOS_N, warm=16, steps=256):
    """The slice's main path: Praos at 2^20 through ``run_quiet``."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    sc, link = praos_consensus(n)
    max_batch = n * sc.max_out
    eng = FusedSparseEngine(sc, link, window="auto", max_batch=max_batch,
                            device=device)
    ci.reset_launches()
    mid = eng.run_quiet(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin = eng.run_quiet(steps, mid)
    wall = time.perf_counter() - t0           # run_quiet ends in a sync
    launches = dict(ci.LAUNCHES)
    delivered = int(fin.delivered) - int(mid.delivered)
    # the same supersteps traced: the fired messages of each, and the
    # traced driver's final state against the quiet one's
    traced, tr = eng.run(warm + steps)
    _states_equal("praos run vs run_quiet", traced, fin, sc)
    sent = np.asarray(tr.sent_count)
    slots = fin.states["slot"]
    total = int(fin.steps)
    checks = {
        "short_delay == bad_delay == route_drop == bad_dst == 0":
            int(fin.short_delay) == int(fin.bad_delay)
            == int(fin.route_drop) == int(fin.bad_dst) == 0,
        "two slots advanced": int(slots.min()) >= 2,
        "delivered > 0": delivered > 0}
    if device.type == "cuda":
        checks.update({
            "sample_insert launched once per superstep":
                launches["sample_insert"] == total,
            "no K1/K2 launch": launches["fire_compact"]
                == launches["mailbox_insert"] == 0})
    _require_all("praos main path", checks)
    say(f"praos main path: n={n} window={eng.window} max_batch={max_batch} "
        f"peak_fired_per_superstep={int(sent.max())} "
        f"supersteps={total} (timed {steps}) delivered={delivered} "
        f"overflow={int(fin.overflow)} slots={int(slots.min())}.."
        f"{int(slots.max())} best_chain={int(fin.states['best'].max())} "
        f"wall_s={wall} delivered_msgs_per_s={delivered / wall} "
        f"launches={launches}")
    return launches, eng


def phase_fused_equals_general(device, n=PRAOS_N, steps=64):
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    sc, link = praos_consensus(n)
    gen = TorchEngine(sc, link, window="auto", device=device).run_quiet(steps)
    fus = FusedSparseEngine(sc, link, window="auto",
                            max_batch=n * sc.max_out,
                            device=device).run_quiet(steps)
    _states_equal("fused vs general", fus, gen, sc)
    say(f"fused = general: praos n={n} supersteps={int(fus.steps)} "
        f"delivered={int(fus.delivered)} overflow={int(fus.overflow)} "
        "every state leaf equal")


@cpu_leg("fused")
def leg_fused(dev, n=1 << 14):
    """Phase 11's leg: integer-link Praos through ``FusedSparseEngine``."""
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    from timewarp_tpu_torch.models.praos import praos
    from timewarp_tpu_torch.net.delays import Quantize, UniformDelay
    sc = praos(n, slot_us=100_000, n_slots=6, leader_prob=4.0 / n,
               fanout=8, burst=True, mailbox_cap=16)
    link = Quantize(UniformDelay(8_000, 30_000), 1_000)
    # 100 supersteps, half of its 200 to quiescence (chip_smoke's time)
    return dict(_traced_leg(FusedSparseEngine, sc, link, dev, steps=100,
                            max_batch=n * sc.max_out), n=n)


def phase_fused_card_vs_cpu(device):
    def check(card, cpu):
        _legs_equal("fused card vs CPU", card, cpu)
        st = card["state"]
        say(f"fused card vs CPU: praos n={card['n']} supersteps="
            f"{len(card['trace'])} delivered={int(st['delivered'])} "
            f"overflow={int(st['overflow'])} traces and states equal")
    vs_cpu("fused", device, check)


def phase_fused_gossip(device, general, n=SLICE_N):
    """Phase 4's wave through the fused engine: nothing drops in either,
    so both compute the same function."""
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    sc, link = gossip_wave(n)
    eng = FusedSparseEngine(sc, link, window="auto", max_batch=n * sc.max_out,
                            device=device)
    fin = eng.run_quiet(1 << 20)
    _states_equal("fused gossip vs phase 4", fin, general, sc)
    say(f"fused gossip wave: n={n} supersteps={int(fin.steps)} "
        f"delivered={int(fin.delivered)} wall_s="
        f"{eng.last_run_stats['wall_seconds']}: phase 4's counts and state")


def sass_draw_counts(lib):
    """Instructions of one K3 draw on the main path's link, by pipe: the
    SASS of ``tw_k3_draw_probe`` (one Quantize(LogNormal) draw with its
    threefry chain, between one load pair and one store) up to its first
    EXIT. The slow paths of logf/cosf that the compiler places after it
    are not counted: no draw of this link takes them."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    body = sass.split("Function : tw_k3_draw_probe", 1)[1]
    body = body.split("Function : ", 1)[0]
    counts = {"int": 0, "fp32": 0, "mufu": 0, "other": 0}
    for pred, op in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body):
        if op == "NOP":
            continue
        kind = "int" if op in SASS_INT else "fp32" if op in SASS_FP32 \
            else "mufu" if op in SASS_MUFU else "other"
        counts[kind] += 1
        if op == "EXIT" and not pred:
            break
    counts["any"] = sum(counts.values())
    return counts


def phase_time_k3(device, t):
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        lower_link
    link = lower_link(praos_link())
    tt = torch.tensor(1 << 36, dtype=torch.int64, device=device)
    valid = int(t["cnt"].sum())
    # the entries that find a hole: only their payload need be read
    holes = (t["mb_rel"] == 2**31 - 1).sum(dim=0, dtype=torch.int32)
    inserted = int(torch.minimum(t["cnt"], holes).sum())
    planes = t["mb_rel"].numel() + t["mb_payload"].numel()
    # planes read and written once, start/cnt, woff and smrank of every
    # valid entry (each is drawn), the payload of each inserted one; the
    # dst column is not read (start/cnt stand in for it)
    k3_bytes = 2 * planes * 4 + (t["start"].numel() + t["cnt"].numel()) * 4 \
        + valid * 2 * 4 + inserted * PRAOS_P * 4
    bytes_ms = k3_bytes / HBM_BYTES_PER_S * 1e3
    # every valid entry is drawn once; the pipe that takes longest bounds
    from timewarp_tpu_torch.utils import build
    per_draw = sass_draw_counts(build.build_all()["sample_insert"].path)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    clocks = max(per_draw[k] / SM90_PER_CLOCK[k] for k in SM90_PER_CLOCK)
    ops_ms = valid * clocks / (sms * mhz * 1e6) * 1e3
    r = dict(ms=_time_ms(lambda: k3_call(ci.sample_insert, t, tt, link)),
             plain_ms=_time_ms(lambda: k3_call(ci.sample_insert_plain, t, tt,
                                               link), queued=False),
             bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bytes=k3_bytes)
    say(f"time sample_insert: kernel_ms={r['ms']} plain_ms={r['plain_ms']} "
        f"bound_ms={r['bound_ms']} bound_by={r['bound_by']} (bytes "
        f"{k3_bytes} over 3.35 TB/s: {bytes_ms} ms; {valid} draws of "
        f"{per_draw} SASS instructions, {clocks} SM clocks a draw at "
        f"{SM90_PER_CLOCK} a clock, {sms} SMs at {mhz} MHz: {ops_ms} ms; "
        f"{nvidia_smi()}; no single PyTorch call computes this function: "
        "library_ms null)")
    return r


# -- the static-topology slice: K4 and the dense ring at 2^20 --------------

def ring_planes(device, n, seed, fire, full, t0=3):
    """Seeded ``[10, n]`` K4 planes whose minimum is ``t0``: a ``fire``
    share of the nodes wakes at ``t0`` (holding tokens, the timer due), a
    ``full`` share has both queue slots taken and kept, and every slot
    holds random (stale) payload words."""
    import torch
    rng = np.random.default_rng(seed)
    I32MAX = 2**31 - 1

    def share(p, a, b):
        return np.where(rng.random(n) < p, a, b)
    slot_rel = share(0.2, t0, rng.integers(t0 + 1, t0 + 9, n))
    planes = np.stack([
        share(full, slot_rel, share(0.3, slot_rel, I32MAX)),
        share(full, rng.integers(t0 + 1, t0 + 9, n), I32MAX),
        rng.integers(-2**20, 2**20, n), rng.integers(-2**20, 2**20, n),
        rng.integers(0, 2, n), rng.integers(0, 2, n),
        share(fire, t0, share(0.5, rng.integers(t0 + 1, t0 + 9, n),
                              I32MAX)),
        share(fire, rng.integers(1, 3, n), rng.integers(0, 3, n)),
        rng.integers(-2**20, 2**20, n),
        share(fire, rng.integers(0, t0 + 1, n),
              share(0.5, I32MAX, rng.integers(t0, t0 + 9, n))),
    ]).astype(np.int32)
    planes[6, 0] = t0                      # the minimum is t0
    return torch.from_numpy(planes).to(device)


def phase_fused_ring_kernel(device, n=RING_N):
    """K4 against its plain version, bit for bit (planes and counts)."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_ring as cr
    err = 0
    for tag, nn, fire, full, alive, seed in (
            ("dense", n, 0.95, 0.0, True, 15),
            ("sparse", n, 0.02, 0.0, True, 16),
            ("overflow", n, 0.9, 0.5, True, 17),
            ("alive 0", n, 0.95, 0.2, False, 18),
            ("n = 2^20 + 3", n + 3, 0.5, 0.2, True, 19)):
        planes = ring_planes(device, nn, seed, fire, full)
        got, acc = cr.fused_ring(planes, 3, alive, 0, 500)
        want, counts = cr.fused_ring_plain(planes, 3, alive, 0, 500)
        torch.cuda.synchronize()
        err = max(err, _equal(f"K4 {tag}", (got, acc), (want, counts)))
        delivered, overflow = (int(x) for x in acc)
        say(f"K4 {tag}: n={nn} alive={alive} delivered={delivered} "
            f"overflow={overflow} bit-equal")
        _require_all(f"K4 {tag}", {
            "delivered > 0": delivered > 0,
            "overflow > 0 iff forced": (overflow > 0) == (tag == "overflow")
            or tag.startswith("n =")})
    return err


def phase_ring_main_path(device, n=RING_N, warm=16, steps=8192):
    """The slice's main path: the dense ring through ``run_quiet``."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
        FusedRingEngine
    sc, link = dense_ring(n)
    eng = FusedRingEngine(sc, link, device=device)
    ci.reset_launches()
    mid = eng.run_quiet(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin = eng.run_quiet(steps, mid)
    wall = time.perf_counter() - t0           # run_quiet ends in a sync
    launches = dict(ci.LAUNCHES)
    total = int(fin.steps)
    delivered = int(fin.delivered) - int(mid.delivered)
    checks = {
        "overflow == 0": int(fin.overflow) == 0,
        "all supersteps ran": total == warm + steps,
        "delivered == (supersteps - 1) * n":
            int(fin.delivered) == (total - 1) * n,
        "fused_ring launched once per superstep":
            launches["fused_ring"] == total,
        "no K1/K2/K3 launch": launches["fire_compact"]
            == launches["mailbox_insert"] == launches["sample_insert"] == 0}
    _require_all("ring main path", checks)
    say(f"ring main path: dense token ring n={n} supersteps={total} "
        f"(timed {steps}) delivered={delivered} overflow="
        f"{int(fin.overflow)} virtual_us={int(fin.base)} wall_s={wall} "
        f"delivered_msgs_per_s={delivered / wall} "
        f"wall_ms_per_superstep={wall / steps * 1e3} launches={launches}")
    return launches, eng, fin


def phase_fused_ring_equals_edge(device, n=RING_N):
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
        FusedRingEngine
    from timewarp_tpu_torch.net.delays import FixedDelay
    for tag, (sc, link), horizons in (
            ("dense", dense_ring(n), (12, 52)),
            ("sparse", (dense_ring(n, n_tokens=n // 64, think_us=1_700,
                                   bootstrap_us=900, end_us=80_000)[0],
                        FixedDelay(700)), (12, 52, 200))):
        edge = EdgeEngine(sc, link, device=device)
        fused = FusedRingEngine(sc, link, device=device)
        es, fs = edge.init_state(), fused.init_state()
        for k in horizons:
            es, fs = edge.run_quiet(k, es), fused.run_quiet(k, fs)
            _states_equal(f"fused vs edge, {tag} at {int(es.steps)}",
                               fused.to_edge_state(fs), es)
        say(f"fused ring = edge: {tag} ring n={n} supersteps="
            f"{int(es.steps)} delivered={int(es.delivered)} overflow="
            f"{int(es.overflow)} every leaf equal")


def perm_scatter(n, seed):
    """A static permutation topology (the edge engine's gather path):
    node i sends a running counter to perm[i] every 1 ms until 50 ms;
    receivers sum what they get."""
    import torch
    from timewarp_tpu_torch.core.scenario import NEVER, Outbox, Scenario
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)

    def step(state, inbox, now, i, key):
        got = torch.where(inbox.valid, inbox.payload[:, 0, :], 0).sum(
            dim=0, dtype=torch.int32)
        alive = now < 50_000
        sent = state["sent"]
        out = Outbox(valid=alive[None],
                     dst=torch.from_numpy(perm).to(i.device)[i.long()][None],
                     payload=torch.stack([sent + 1,
                                          torch.zeros_like(sent)])[None])
        return {"seen": state["seen"] + got, "sent": sent + 1}, out, \
            torch.where(alive, now + 1_000, NEVER)

    def init_batched(nn, device):
        z = torch.zeros(nn, dtype=torch.int32, device=device)
        return {"seen": z, "sent": z.clone()}, \
            torch.zeros(nn, dtype=torch.int64, device=device)

    return Scenario(name="perm-scatter", n_nodes=n, step=step,
                    init_batched=init_batched, payload_width=2, max_out=1,
                    mailbox_cap=8, static_dst=perm.reshape(n, 1),
                    commutative_inbox=True)


@cpu_leg("edge")
def leg_edge(dev, n=1 << 14):
    """Phase 18's leg: the edge engine on a sparse ring and a permutation."""
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
    from timewarp_tpu_torch.models.token_ring import token_ring
    from timewarp_tpu_torch.net.delays import UniformDelay
    out = {}
    for tag, sc, link, cap, steps in (
            ("uniform sparse ring",
             token_ring(n, n_tokens=64, think_us=10_000, bootstrap_us=1_000,
                        end_us=2_000_000, with_observer=False),
             UniformDelay(1_000, 5_000), 2, 300),
            ("permutation (gather)", perm_scatter(n, 7),
             UniformDelay(100, 2_500), 8, 150)):
        st, tr = EdgeEngine(sc, link, seed=11, cap=cap, device=dev).run(steps)
        out[tag] = dict(state=_host_state(st), trace=tr, n=n)
    return out


def phase_edge_card_vs_cpu(device):
    def check(card, cpu):
        for tag, c in card.items():
            _legs_equal(f"edge card vs CPU, {tag}", c, cpu[tag])
            say(f"edge card vs CPU: {tag} n={c['n']} supersteps="
                f"{len(c['trace'])} delivered={int(c['state']['delivered'])} "
                f"overflow={int(c['state']['overflow'])} traces and states "
                "equal")
    vs_cpu("edge", device, check)


def phase_time_k4(device, planes):
    """K4's time on the main path's planes, against 80 B a node."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_ring as cr
    n = planes.shape[1]
    out = torch.empty_like(planes)
    acc = torch.zeros(2, dtype=torch.int64, device=device)
    t = int(torch.minimum(planes[:2].amin(), planes[cr.WAKE].amin()))
    k4_bytes = 2 * planes.numel() * 4          # ten planes in, ten out
    r = dict(ms=_time_ms(lambda: cr.fused_ring(planes, t, True, 0, 500,
                                               out=out, acc=acc)),
             plain_ms=_time_ms(lambda: cr.fused_ring_plain(planes, t, True,
                                                           0, 500),
                               queued=False),
             bound_ms=k4_bytes / HBM_BYTES_PER_S * 1e3, bytes=k4_bytes)
    say(f"time fused_ring: n={n} kernel_ms={r['ms']} plain_ms="
        f"{r['plain_ms']} bound_ms={r['bound_ms']} (bytes {k4_bytes} over "
        "3.35 TB/s; no single PyTorch call computes this function: "
        "library_ms null)")
    return r


# -- the eager routing slice: steady gossip at 2^20 and K1 at its width ---

def phase_steady_main_path(device, n=STEADY_N, warm=64, steps=256):
    """The slice's main path: steady gossip through ``run_quiet``."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    sc, link = steady_gossip(n)
    eng = TorchEngine(sc, link, device=device)
    ci.reset_launches()
    mid = eng.run_quiet(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin = eng.run_quiet(steps, mid)
    wall = time.perf_counter() - t0           # run_quiet ends in a sync
    launches = dict(ci.LAUNCHES)
    total = int(fin.steps)
    delivered = int(fin.delivered) - int(mid.delivered)
    checks = {
        "eager path": not eng.adaptive and not eng.lazy,
        "all supersteps ran": total == warm + steps,
        "bad_dst == bad_delay == short_delay == route_drop == 0":
            int(fin.bad_dst) == int(fin.bad_delay) == int(fin.short_delay)
            == int(fin.route_drop) == 0,
        "every node infected": int((fin.states["hop"] < 0).sum()) == 0,
        "delivered > 0": delivered > 0}
    if device.type == "cuda":
        checks.update({
            "mailbox_insert launched once per superstep":
                launches["mailbox_insert"] == total,
            "no K2/K3/K4 launch": launches["fire_compact"]
                == launches["sample_insert"] == launches["fused_ring"] == 0})
    _require_all("steady main path", checks)
    say(f"steady main path: gossip n={n} window={eng.window} supersteps="
        f"{total} (timed {steps}) delivered={delivered} overflow="
        f"{int(fin.overflow)} (of {int(fin.delivered)} delivered in all) "
        f"virtual_us={int(fin.time)} wall_s={wall} "
        f"delivered_msgs_per_s={delivered / wall} "
        f"wall_ms_per_superstep={wall / steps * 1e3} launches={launches}")
    return launches, eng, fin


def phase_eager_equals_lazy(device, n=STEADY_N, steps=64):
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.trace.events import assert_traces_equal
    sc, link = steady_gossip(n)
    eager = TorchEngine(sc, link, device=device)
    lazy = TorchEngine(sc, link, route_cap=n * sc.max_out, device=device)
    _require_all("eager = lazy", {"the paths": not eager.lazy and lazy.lazy})
    (se, te), (sl, tl) = eager.run(steps), lazy.run(steps)
    assert_traces_equal(te, tl, "eager", "lazy")
    _states_equal("eager vs lazy", se, sl, sc)
    _require_all("eager = lazy", {"route_drop == 0": int(sl.route_drop) == 0})
    say(f"eager = lazy: steady gossip n={n} supersteps={len(te)} "
        f"delivered={int(se.delivered)} overflow={int(se.overflow)} "
        "traces and every state leaf equal")


@cpu_leg("routing")
def leg_routing(dev, n=1 << 14):
    """Phase 23's leg: each routing path and model through ``run``."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.models.ping_pong import ping_pong
    from timewarp_tpu_torch.models.praos import praos
    from timewarp_tpu_torch.models.socket_state import socket_state
    from timewarp_tpu_torch.net.links import parse_link
    droppy = parse_link("drop:0.15:quantize:1000:uniform:2000:30000")
    paced = gossip(n, fanout=6, think_us=3_000, gossip_interval=1_000,
                   end_us=400_000)
    cases = (
        # each budget half the supersteps of the case's run to its end or
        # its budget of 400 (173, 400, 120, 112, 101): chip_smoke's time
        ("droppy gossip, window auto (eager, 3-key sort), record_events",
         paced, droppy, dict(window="auto", record_events=1 << 16), 86,
         "route_drop == 0"),
        ("praos, route_cap 64 below its active count (lazy)",
         praos(n, slot_us=100_000, n_slots=6, leader_prob=4.0 / n, fanout=8,
               burst=True, mailbox_cap=16),
         parse_link("quantize:1000:uniform:8000:30000"),
         dict(window="auto", route_cap=64), 200, "route_drop > 0"),
        ("steady gossip, window 1 (eager)", *steady_gossip(n), {}, 60,
         "route_drop == 0"),
        # its state holds a counter per client on every node, n^2 words:
        # 64 MiB a copy at 2^12 nodes, 1 GiB at 2^14
        ("socket-state on a droppy link, window 1 (eager)",
         socket_state((n >> 2) - 1, seed=1, send_interval_us=20_000,
                      server_life_us=2_000_000, mailbox_cap=64),
         parse_link("drop:0.1:quantize:1000:uniform:3000:9000"), {}, 56,
         "route_drop == 0"),
        ("ping-pong (ordered inbox with src)", ping_pong(rounds=50),
         parse_link("uniform:500:2000"), {}, 50, "route_drop == 0"),
    )
    out = {}
    for tag, sc, link, kw, steps, drops in cases:
        eng = TorchEngine(sc, link, seed=11, device=dev, **kw)
        st, tr = eng.run(steps)
        out[tag] = dict(state=_host_state(st, sc), trace=tr, n=sc.n_nodes,
                        drops=drops, adaptive=eng.adaptive,
                        wall=eng.last_run_stats["wall_seconds"],
                        events=eng.events(st) if kw.get("record_events")
                        else None)
    return out


def phase_routing_card_vs_cpu(device):
    """Each new path and model, card against CPU through ``run``."""
    def check(card, cpu):
        for tag, c in card.items():
            g = cpu[tag]
            _legs_equal(f"card vs CPU, {tag}", c, g)
            st, drops = c["state"], c["drops"]
            rd = int(st["route_drop"])
            _require_all(f"card vs CPU, {tag}", {
                drops: rd > 0 if drops.endswith("> 0") else rd == 0,
                "delivered > 0": int(st["delivered"]) > 0,
                "not the adaptive regime": not c["adaptive"]
                and not g["adaptive"]})
            extra = ""
            if c["events"] is not None:
                if c["events"] != g["events"]:
                    raise AssertionError(f"card vs CPU, {tag}: events differ")
                extra = (f" events={len(c['events'][0])} (missing "
                         f"{c['events'][1]}) equal")
            say(f"card vs CPU: {tag}: n={c['n']} supersteps={len(c['trace'])} "
                f"delivered={int(st['delivered'])} overflow="
                f"{int(st['overflow'])} route_drop={rd} traces and states "
                f"equal{extra} (wall_s card {c['wall']}, CPU {g['wall']})")
    vs_cpu("routing", device, check)


def phase_k1_eager(device, eng, state):
    """K1 on the batch of one steady-state superstep from ``state``: its
    arguments taken where the engine's insertion stage receives them."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    taken = {}
    stage_insert = eng.stage.insert

    def take(sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload, counts):
        # the superstep's world axis is 1 on a solo engine: K1 is taken
        # at its solo shapes
        solo = [None if x is None else x[0] for x in (
            sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload, counts)]
        start, cnt = ci.bucket_bounds(solo[0], eng.stage.n)
        taken["args"] = (start, cnt, solo[7], solo[1],
                         solo[2] if eng.stage.inbox_src else None, solo[3],
                         *solo[4:7])
        taken["sd"] = solo[0]
        return stage_insert(sd, drel_s, src_s, pay_s, mb_rel, mb_src,
                            mb_payload, counts)
    eng.stage.insert = take
    try:
        eng.run_quiet(1, state)
    finally:
        del eng.stage.insert
    args = taken["args"]
    got = ci.mailbox_insert(*args)
    want = ci.mailbox_insert_plain(*args)
    torch.cuda.synchronize()
    err = _equal("K1 eager width", got, want)
    n = args[6].shape[1]
    S, valid = taken["sd"].numel(), int(args[1].sum())
    nbytes = k1_bytes(args)
    r = dict(ms=_time_ms(lambda: ci.mailbox_insert(*args)),
             plain_ms=_time_ms(lambda: ci.mailbox_insert_plain(*args),
                               queued=False),
             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
    say(f"K1 eager width: n={n} S={S} valid={valid} sentinel_tail="
        f"{S - valid} K={args[6].shape[0]} P={args[8].shape[1]} "
        f"src={args[4] is not None} overflow={int(got[3])} bit-equal "
        f"max_abs_err={err}")
    say(f"time mailbox_insert at the eager width: kernel_ms={r['ms']} "
        f"plain_ms={r['plain_ms']} bound_ms={r['bound_ms']} (bytes "
        f"{nbytes} over 3.35 TB/s; {nvidia_smi()}; no single PyTorch call "
        "computes this function: library_ms null)")
    return err, r


# -- the world axis and faults: the 8-world chaos fleet at 100 000 nodes ---

def fleet_compact_inputs(device, B, n, M, P, fracs, seed, window1=False):
    """B worlds' outboxes, world b a share ``fracs[b]`` of valid lanes."""
    import torch
    outs = [compact_inputs(device, n, M, P, f, seed + b)
            for b, f in enumerate(fracs)]
    pdst, woff, pay = (torch.stack(x) for x in zip(*outs))
    return pdst, None if window1 else woff, pay


def fleet_insert_inputs(device, B, n, K, P, S, ordered, with_src, seed,
                        shares, hot_world=None):
    """B worlds of :func:`insert_inputs`, world b a ``shares[b]`` share of
    its batch valid; ``hot_world``'s 64 hot destinations overfill their
    mailboxes (the other worlds' batches spread evenly)."""
    import torch
    worlds = [insert_inputs(device, n, K, P, S, ordered, with_src,
                            seed + b, frac=f, hot=b == hot_world)
              for b, f in enumerate(shares)]
    return {k: None if worlds[0][k] is None
            else torch.stack([w[k] for w in worlds]) for k in worlds[0]}


def phase_fleet_kernels(device, n=CHAOS_N, B=CHAOS_B):
    """K2 and K1 across the world axis against their plain versions at
    the chaos fleet's shape (8 worlds of 100 000 nodes, M 1, P 1, K 8, S
    100 352), one launch for every world, then the edge cases: B = 1
    equals the solo kernel; a world with an empty batch; one world that
    drops (K2) or overflows (K1) while the others do not; a ragged N
    (100 003); ordered K1 with ``counts`` and src; and every world of a
    fleet call equals its own solo call."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    S = -(-n // 1024) * 1024
    err2 = err1 = 0

    def k2(tag, pdst, woff, pay, SS, drops_in):
        nonlocal err2
        got = ci.fire_compact(pdst, woff, pay, SS)
        want = ci.fire_compact_plain(pdst, woff, pay, SS)
        err2 = max(err2, _equal(f"K2 fleet {tag}", got, want))
        drops = got[4].tolist() if pdst.dim() == 3 else [int(got[4])]
        _require_all(f"K2 fleet {tag}", {
            f"drops only in worlds {drops_in}":
                [b for b, d in enumerate(drops) if d > 0] == list(drops_in)})
        for b in range(pdst.shape[0] if pdst.dim() == 3 else 0):
            solo = ci.fire_compact(pdst[b], None if woff is None
                                   else woff[b], pay[b], SS)
            err2 = max(err2, _equal(f"K2 fleet {tag} world {b} vs solo",
                                    solo, tuple(g[b] for g in got)))
        say(f"K2 fleet {tag}: B={pdst.shape[0]} n={pdst.shape[-1]} "
            f"M={pdst.shape[-2]} P={pay.shape[-2]} S={SS} drops={drops} "
            "bit-equal, every world = its solo call")
        return got

    fracs = (0.3, 0.0, 0.5, 1.0, 0.1, 0.7, 0.02, 0.4)[:B]
    k2("chaos shape, world 1 empty", *fleet_compact_inputs(
        device, B, n, 1, 1, fracs, 60), S, ())
    one = fleet_compact_inputs(device, 1, n, 1, 1, (0.3,), 61)
    got1 = k2("B 1", *one, S, ())
    solo = ci.fire_compact(one[0][0], one[1][0], one[2][0], S)
    err2 = max(err2, _equal("K2 B 1 = solo kernel", solo,
                            tuple(g[0] for g in got1)))
    k2("one world drops, ragged n, M 4, P 2",
       *fleet_compact_inputs(device, 3, n + 3, 4, 2, (0.1, 0.9, 0.0), 62),
       2 * (n + 3), (1,))
    k2("window 1, P 0, 5 worlds",
       *fleet_compact_inputs(device, 5, 4099, 2, 0, (0.4, 0.4, 0.2, 0.0,
                                                    0.8), 63, window1=True),
       4096, (4,))

    def k1(tag, t, nn, empty, hot):
        nonlocal err1
        args = insert_args(t, nn)
        got = ci.mailbox_insert(*args)
        want = ci.mailbox_insert_plain(*args)
        err1 = max(err1, _equal(f"K1 fleet {tag}", got, want))
        ovf = got[3].tolist()
        valid = args[1].sum(dim=1).tolist()
        _require_all(f"K1 fleet {tag}", {
            "the empty world: no entry, no overflow": empty is None
            or valid[empty] == ovf[empty] == 0,
            "the hot world overflows the most": ovf[hot] == max(ovf) > 0})
        for b in range(args[6].shape[0]):
            solo = ci.mailbox_insert(*(None if x is None else x[b]
                                       for x in args))
            err1 = max(err1, _equal(f"K1 fleet {tag} world {b} vs solo",
                                    solo, tuple(g[b] for g in got)))
        say(f"K1 fleet {tag}: B={args[6].shape[0]} n={nn} "
            f"K={args[6].shape[1]} P={args[8].shape[2]} "
            f"src={args[4] is not None} ordered={args[2] is not None} "
            f"valid={valid} overflow={ovf} bit-equal, every world = its "
            "solo call")

    # the fleet shape: nearly every lane valid, as in the steady state;
    # world 1's batch is empty, the last world's 64 hot nodes overflow
    shares = (0.95, 0.0, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95)[:B]
    k1("chaos shape, world 1 empty, the last world's hot nodes overflow",
       fleet_insert_inputs(device, B, n, 8, 1, S, False, False, 70, shares,
                           hot_world=B - 1), n, 1, B - 1)
    t1 = fleet_insert_inputs(device, 1, n, 8, 1, S, False, False, 71,
                             (0.7,), hot_world=0)
    k1("B 1", t1, n, None, 0)
    a1 = insert_args(t1, n)
    err1 = max(err1, _equal("K1 B 1 = solo kernel", ci.mailbox_insert(
        *(None if x is None else x[0] for x in a1)),
        tuple(g[0] for g in ci.mailbox_insert(*a1))))
    k1("ordered with counts and src, ragged n, world 2 overflows",
       fleet_insert_inputs(device, 3, n + 3, 8, 2, S, True, True, 72,
                           (0.3, 0.0, 0.3), hot_world=2), n + 3, 1, 2)
    torch.cuda.synchronize()
    return err2, err1


def fleet_engine(device, n=CHAOS_N):
    """The chaos fleet's engine: ``(engine, scenario, link, spec, fleet,
    heal_us)``."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    sc, link, spec, fleet, heal_us = chaos_fleet(n)
    eng = TorchEngine(sc, link, window="auto", batch=spec, faults=fleet,
                      device=device)
    return eng, sc, link, spec, fleet, heal_us


def phase_chaos_main_path(device, n=CHAOS_N):
    """The slice's main path: the chaos fleet through ``run_quiet`` to
    quiescence, under the bench's own gates (bench.py:686-711): worlds 0
    and B - 1 equal their solo faulted runs over 12 supersteps;
    deliveries after every world's faults heal (a traced run of 192);
    then, timed from 2 warm supersteps, the run to quiescence with K2
    and K1 each launched exactly once per fleet superstep, ``short_delay``
    and ``route_drop`` 0, ``fault_dropped > 0`` in every world and at most
    ``max(n // 500, 8)`` nodes uninfected per world."""
    import torch
    from timewarp_tpu_torch.faults import eventually_delivered
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.batched import world_slice
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    eng, sc, link, spec, fleet, heal_us = fleet_engine(device, n)
    B = spec.B
    _require_all("chaos fleet", {
        "adaptive regime, window 1000": eng.adaptive and eng.window == 1000})
    gate = eng.run_quiet(12)
    for b in (0, B - 1):
        solo = TorchEngine(sc, link, seed=spec.seeds[b], window=eng.window,
                           faults=fleet.world_schedule(b),
                           device=device).run_quiet(12)
        _states_equal(f"chaos gate: world {b} vs its solo run", solo,
                      world_slice(gate, b), sc)
    _, traces = eng.run(192)
    for b, tr in enumerate(traces):
        if not eventually_delivered(tr, heal_us):
            raise AssertionError(f"world {b}: no deliveries after its "
                                 f"faults healed at {heal_us} µs")
    warm = eng.run_quiet(2)
    base = int(warm.delivered.sum())
    torch.cuda.synchronize()
    ci.reset_launches()
    fin = eng.run_quiet(1 << 20, warm)
    launches = dict(ci.LAUNCHES)
    stats = eng.last_run_stats
    wall = stats["wall_seconds"]
    iters = stats["fleet_supersteps"]
    delivered = int(fin.delivered.sum()) - base
    hops = fin.states["hop"]
    missed = (hops < 0).sum(dim=1).tolist()
    fault_dropped = fin.fault_dropped.tolist()
    checks = {
        "every world quiesced": not bool(eng.world_active(fin).any()),
        "short_delay == 0": int(fin.short_delay.sum()) == 0,
        "route_drop == 0": int(fin.route_drop.sum()) == 0,
        "fault_dropped > 0 in every world": min(fault_dropped) > 0,
        f"missed {missed} <= max(n // 500, 8)":
            max(missed) <= max(n // 500, 8),
        "K2 launched once per fleet superstep":
            launches["fire_compact"] == iters,
        "K1 launched once per fleet superstep":
            launches["mailbox_insert"] == iters,
        "no K3/K4 launch":
            launches["sample_insert"] == launches["fused_ring"] == 0}
    _require_all("chaos main path", checks)
    say(f"chaos main path: B={B} n={n} window={eng.window} fleet_supersteps="
        f"{iters} world_supersteps={(fin.steps - warm.steps).tolist()} "
        f"delivered={delivered} overflow={fin.overflow.tolist()} "
        f"fault_dropped={fault_dropped} route_drop="
        f"{fin.route_drop.tolist()} missed={missed} virtual_us="
        f"{fin.time.tolist()} wall_s={wall} aggregate_delivered_msgs_per_s="
        f"{delivered / wall} wall_ms_per_fleet_superstep={wall / iters * 1e3}"
        f" launches={launches}")
    return launches, eng, fin


@cpu_leg("fleet")
def leg_fleet(dev, n=1 << 12):
    """Phase 28's leg: a small fleet (2^12 nodes, 3 worlds) through ``run``
    in each routing regime: adaptive and eager with per-world fault
    schedules, lazy (which takes no faults) with a link sweep."""
    from timewarp_tpu_torch.faults import (FaultFleet, FaultSchedule,
                                           LinkWindow, NodeCrash, Partition)
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.links import parse_link
    half = n // 2
    fleet = FaultFleet(tuple(FaultSchedule((
        NodeCrash(3 + b, 10_000, 40_000 + 5_000 * b, reset_state=True),
        NodeCrash(half + b, 15_000, 35_000),
        Partition((tuple(range(half)), tuple(range(half, n))), 12_000,
                  30_000 + 2_000 * b),
        LinkWindow(None, None, 50_000, 70_000, scale=1.5 + 0.5 * b),
    )) for b in range(3)))
    steady = gossip(n, fanout=1, think_us=1_000, gossip_interval=1_000,
                    end_us=120_000, steady=True, mailbox_cap=8)
    burst = gossip(n, fanout=4, think_us=700, burst=True, end_us=400_000,
                   mailbox_cap=16)
    spec = BatchSpec(seeds=(3, 4, 9))
    # each budget half the longest world's supersteps to its end or its
    # budget of 400/200 (150, 194, 200): chip_smoke's time
    cases = (
        ("adaptive, faults (steady gossip, window auto)", steady,
         parse_link("quantize:1000:uniform:500:4500"),
         dict(window="auto", faults=fleet), 75),
        ("eager, faults (droppy link, window 1)", steady,
         parse_link("drop:0.1:quantize:1000:uniform:500:4500"),
         dict(faults=fleet), 97),
        ("lazy, link sweep (route_cap 64, window 3000)", burst,
         parse_link("quantize:1000:uniform:3000:9000"),
         dict(window=3_000, route_cap=64), 100),
    )
    out = {}
    for tag, sc, link, kw, steps in cases:
        bs = spec if "sweep" not in tag else BatchSpec(
            seeds=spec.seeds, link_params={"inner.lo": [3000, 4000, 3500],
                                           "inner.hi": [9000, 9000, 12000]})
        st, tr = TorchEngine(sc, link, batch=bs, device=dev, **kw).run(steps)
        out[tag] = dict(state=_host_state(st, sc), trace=tr, B=bs.B, n=n,
                        faults="faults" in kw)
    return out


def phase_fleet_card_vs_cpu(device):
    """A small fleet card against CPU through ``run`` in each routing
    regime (:func:`leg_fleet`)."""
    def check(card, cpu):
        for tag, c in card.items():
            _legs_equal(f"fleet card vs CPU, {tag}", c, cpu[tag])
            st = c["state"]
            fd = st["fault_dropped"].tolist()
            _require_all(f"fleet card vs CPU, {tag}", {
                "fault_dropped > 0 in every faulted world":
                    not c["faults"] or min(fd) > 0,
                "delivered > 0": int(st["delivered"].min()) > 0})
            say(f"fleet card vs CPU: {tag}: B={c['B']} n={c['n']} supersteps="
                f"{[len(t) for t in c['trace']]} delivered="
                f"{st['delivered'].tolist()} fault_dropped={fd} route_drop="
                f"{st['route_drop'].tolist()} traces and states equal")
    vs_cpu("fleet", device, check)


def phase_fleet_checkpoint(device, eng, steps=40):
    """The chaos fleet saved mid-run on the card and resumed equals the
    uninterrupted run; world b of the checkpoint, loaded into a solo
    engine with world b's schedule and continued, equals world b."""
    import os
    import tempfile
    from timewarp_tpu_torch.interp.torch_engine.batched import world_slice
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.utils import checkpoint as ck
    sc = eng.scenario
    full = eng.run_quiet(2 * steps)
    mid = eng.run_quiet(steps)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet.npz")
        ck.save_state(path, mid, meta={"seeds": list(eng.batch.seeds)})
        size = os.path.getsize(path)
        loaded, meta = ck.load_state(path, eng.init_state(),
                                     expect_meta={"seeds": list(
                                         eng.batch.seeds)})
        _states_equal("fleet checkpoint round trip", loaded, mid, sc)
        _states_equal("fleet resumed from its checkpoint",
                      eng.run_quiet(steps, loaded), full, sc)
        b = eng.batch.B - 3
        solo = TorchEngine(sc, eng.link, seed=eng.batch.seeds[b],
                           window=eng.window,
                           faults=eng.faults.world_schedule(b), device=device)
        wb, _ = ck.load_world_state(path, solo.init_state(), b)
        _states_equal(f"world {b} forked solo from the checkpoint",
                      solo.run_quiet(steps, wb), world_slice(full, b), sc)
    say(f"fleet checkpoint: B={eng.batch.B} n={sc.n_nodes} saved after "
        f"{steps} supersteps ({size} bytes), resumed = uninterrupted over "
        f"{steps} more; world {b} forked solo = world {b}")


def _time_stage_args(tag, a2, a1):
    """K2's and K1's times on captured stage arguments (``_stage_args``),
    their plain versions' times and their byte bounds (per world, summed
    over the worlds), printed under ``tag``. Returns ``(r2, r1)``."""
    r2, r1 = stage_times(a2, a1)
    B, M, n = a2[0].shape
    fired = (a2[0] >= 0).sum(dim=(1, 2)).tolist()
    for name, r, shape in (
            ("fire_compact", r2, f"B={B} n={n} M={M} P={a2[2].shape[2]} "
             f"S={a2[3]} fired={fired}"),
            ("mailbox_insert", r1, f"B={B} n={n} K={a1[6].shape[1]} "
             f"P={a1[8].shape[2]} S={a1[3].shape[1]} valid="
             f"{a1[1].sum(dim=1).tolist()}")):
        say(f"time {name}, {tag} ({shape}): kernel_ms={r['ms']} "
            f"plain_ms={r['plain_ms']} bound_ms={r['bound_ms']} (bytes "
            f"{r['bytes']} over 3.35 TB/s, per world summed over {B}; "
            f"{nvidia_smi()}; no single PyTorch call computes this "
            "function: library_ms null) bit-equal")
    return r2, r1


def phase_fleet_times(device, eng, state):
    """K2 and K1 on one chaos-fleet superstep's own arguments, taken where
    the engine's stage receives them (every world at once): bit-equal to
    their plain versions, their times and byte bounds (per world, summed
    over the B worlds)."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    a2, a1 = _stage_args(eng, lambda: eng.run_quiet(1, state))
    err2 = _equal("K2 fleet superstep", ci.fire_compact(*a2),
                  ci.fire_compact_plain(*a2))
    err1 = _equal("K1 fleet superstep", ci.mailbox_insert(*a1),
                  ci.mailbox_insert_plain(*a1))
    torch.cuda.synchronize()
    r2, r1 = _time_stage_args("across the world axis, one chaos-fleet "
                              "superstep", a2, a1)
    return max(err2, err1), r2, r1


# -- the run-mode planes: telemetry, integrity, flight recorder, dispatch ---

def _timed(fn):
    """``(result, wall seconds)`` of ``fn()``, the device drained at both
    ends."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_traces(what, a, b) -> None:
    from timewarp_tpu_torch.trace.events import assert_traces_equal
    for w, (x, y) in enumerate(zip(*(t if isinstance(t, list) else [t]
                                     for t in (a, b)))):
        assert_traces_equal(x, y, f"{what} w{w}", "other")


def _frames_equal(what, a, b) -> None:
    if isinstance(a, list):
        for w, (x, y) in enumerate(zip(a, b)):
            _frames_equal(f"{what} world {w}", x, y)
        return
    same = np.array_equal(a.t_us, b.t_us) and sorted(a.data) == sorted(
        b.data) and all(np.array_equal(a.data[k], b.data[k]) for k in a.data)
    if not same:
        raise AssertionError(f"{what}: telemetry frames differ")


def _flights_equal(what, a, b) -> None:
    if isinstance(a, list):
        for w, (x, y) in enumerate(zip(a, b)):
            _flights_equal(f"{what} world {w}", x, y)
        return
    cols = ("superstep", "t_sup", "kind", "src", "dst", "send_t", "t", "tag")
    if a.dropped != b.dropped or not all(
            np.array_equal(getattr(a, c), getattr(b, c)) for c in cols):
        raise AssertionError(f"{what}: flight logs differ")


def phase_verified_wave(device, n=100_000):
    """The verified gossip wave at 100 000 nodes (``bench.py``
    ``gossip_100k_verify``'s configuration): the detection gate of
    ``bench.py`` ``_verify_detection_gate`` — ``flip:7:2`` between chunks
    of a digest-mode run, budget 64, chunk 8: at least one rollback, and
    states, traces and ``digest_chain`` equal the clean run's — then
    ``run_verified`` to quiescence under each verify mode with no false
    positive, each mode's wall and its overhead fraction against
    ``off``."""
    from timewarp_tpu_torch.integrity import FlipInjector
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    sc, link = gossip_wave(n)

    def make(mode):
        return TorchEngine(sc, link, window="auto", verify=mode,
                           device=device)
    clean = make("digest")
    fc, tc = clean.run_verified(64, chunk=8)
    injected = make("digest")
    flip = FlipInjector("flip:7:2")
    fi, ti = injected.run_verified(64, chunk=8, inject=flip)
    rec = injected.last_run_integrity
    _require_all("verified wave: detection gate", {
        "the flip fired": flip.fired,
        "at least one rollback": rec["rollbacks"] >= 1,
        "digest chains equal": clean.last_run_stats["digest_chain"]
        == injected.last_run_stats["digest_chain"]})
    _same_traces("verified wave: clean vs recovered", tc, ti)
    _states_equal("verified wave: clean vs recovered", fc, fi, sc)
    say(f"verified wave: n={n} flip {flip.desc!r} detected: rollbacks="
        f"{rec['rollbacks']} violations={[v['kind'] for v in rec['violations']]}"
        " recovered states, traces and digest chain = the clean run's")
    make("off").run_verified(1 << 20, chunk=256)          # warm
    walls, fins = {}, {}
    for mode in ("off", "guard", "digest", "shadow"):
        eng = make(mode)
        (fin, _), walls[mode] = _timed(
            lambda: eng.run_verified(1 << 20, chunk=256))
        fins[mode] = fin
        rec = eng.last_run_integrity
        _require_all(f"verified wave: verify={mode}", {
            "no false positive": rec["rollbacks"] == 0
            and not rec["violations"]})
        if mode != "off":
            _states_equal(f"verified wave: {mode} vs off", fins["off"], fin,
                          sc)
        say(f"verified wave: verify={mode} to quiescence: supersteps="
            f"{eng.last_run_stats['supersteps']} chunks={rec['chunks']} "
            f"checks={rec['checks']} wall_s={walls[mode]} "
            f"overhead_frac={walls[mode] / walls['off'] - 1.0}")
    return walls


def phase_flight_wave(device, n=100_000, steps=24, cap=4096):
    """The flight recorder on the same wave (``bench.py``
    ``gossip_100k_record``, ``record_cap`` 4096): ``off``, ``deliveries``
    and ``full`` give equal states and trace rows over 24 supersteps;
    events and dropped counts per mode, and each mode's wall against
    ``off``."""
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    sc, link = gossip_wave(n)
    walls, base = {}, None
    for mode in ("off", "deliveries", "full", "off"):
        eng = TorchEngine(sc, link, window="auto", record=mode,
                          record_cap=cap, device=device)
        eng.run(steps)                                    # warm
        (run, walls[mode]) = _timed(lambda: eng.run(steps))
        if base is None:
            base = run
            continue
        _same_traces(f"flight wave: off vs {mode}", base[1], run[1])
        _states_equal(f"flight wave: record={mode}", base[0], run[0], sc)
        log = eng.last_run_flight
        say(f"flight wave: n={n} record={mode} supersteps={steps} "
            f"events={0 if log is None else len(log)} dropped="
            f"{0 if log is None else log.dropped} wall_s={walls[mode]} "
            f"overhead_frac={walls[mode] / walls['off'] - 1.0}")
    return walls


def planes_fleet_engine(device, n=CHAOS_N, cap=4096, **planes):
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    sc, link, spec, fleet, _ = chaos_fleet(n)
    return TorchEngine(sc, link, window="auto", batch=spec, faults=fleet,
                       record_cap=cap, device=device, **planes), sc


def phase_planes_main_path(device, quiet_fin, n=CHAOS_N, chunk=64,
                           window=(18, 116), cap_all=1 << 18):
    """The slice's main path: the chaos fleet with ``telemetry="full",
    verify="digest", record="full"`` (``record_cap`` 4096) through
    ``run_verified`` from 2 warm supersteps to quiescence, one
    ``FlipInjector`` flip at the third chunk boundary: at least one
    rollback, the final state = phase 27's plane-off run to quiescence
    (``quiet_fin``), K1 and K2 once per executed fleet superstep. Worlds
    0 and B - 1 over 12 supersteps equal their solo runs' frames and
    flight logs. Then every fault action in the flight log of each world
    whose schedule has it: the same fleet recorded with ``record_cap``
    2^18 (every event of a superstep) over the supersteps of the fault
    windows, each log's cut, down and purge events summing to the
    ``fault_dropped`` they account for. (A purge needs a mailbox entry
    older than its node's reset crash; every delivery into a down window
    is dropped at its send, so these schedules leave none: the count is
    printed, and tests/test_torch_flight.py holds the purge capture
    against the reference's on a state that has one.)"""
    import torch
    from timewarp_tpu_torch.integrity import FlipInjector
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.obs.flight import ACTION_NAMES, EV_FAULT
    planes = dict(telemetry="full", verify="digest", record="full")
    eng, sc = planes_fleet_engine(device, n, **planes)
    B = eng.B
    # worlds 0 and B - 1 = their solo runs, planes included
    _, _ = eng.run(12)
    frames, logs = eng.last_run_telemetry, eng.last_run_flight
    for b in (0, B - 1):
        solo = TorchEngine(sc, eng.link, seed=eng.batch.seeds[b],
                           window=eng.window,
                           faults=eng.faults.world_schedule(b),
                           record_cap=eng.record_cap, device=device,
                           **planes)
        solo.run(12)
        _frames_equal(f"planes main path: world {b} vs solo",
                      solo.last_run_telemetry, frames[b])
        _flights_equal(f"planes main path: world {b} vs solo",
                       solo.last_run_flight, logs[b])
    warm = eng.run_quiet(2)
    executed = []
    run = eng.run

    def counted(*a, **k):
        out = run(*a, **k)
        executed.append(eng.last_run_stats["fleet_supersteps"])
        return out
    eng.run = counted
    flip = FlipInjector("flip:7:3")
    torch.cuda.synchronize()
    ci.reset_launches()
    try:
        (fin, traces), wall = _timed(lambda: eng.run_verified(
            1 << 20, warm, chunk=chunk, inject=flip))
    finally:
        del eng.run
    launches = dict(ci.LAUNCHES)
    rec = eng.last_run_integrity
    iters = sum(executed)
    log = eng.last_run_flight
    _states_equal("planes main path = phase 27's plane-off run", quiet_fin,
                  fin, sc)
    _require_all("planes main path", {
        "the flip fired": flip.fired,
        "at least one rollback": rec["rollbacks"] >= 1,
        "every world quiesced": not bool(eng.world_active(fin).any()),
        "K2 launched once per executed fleet superstep":
            launches["fire_compact"] == iters,
        "K1 launched once per executed fleet superstep":
            launches["mailbox_insert"] == iters,
        "no K3/K4 launch":
            launches["sample_insert"] == launches["fused_ring"] == 0})
    say(f"planes main path: chaos fleet B={B} n={n} telemetry=full "
        f"verify=digest record=full record_cap={eng.record_cap} chunk={chunk}"
        f": flip {flip.desc!r}, rollbacks={rec['rollbacks']} violations="
        f"{[v['kind'] for v in rec['violations']]} chunks={rec['chunks']} "
        f"executed_fleet_supersteps={iters} committed="
        f"{eng.last_run_stats['fleet_supersteps']} wall_s={wall} "
        f"wall_ms_per_fleet_superstep={wall / iters * 1e3} "
        f"events={[len(x) for x in log]} dropped={[x.dropped for x in log]} "
        f"frames={[len(f) for f in eng.last_run_telemetry]} "
        f"launches={launches}; final state = phase 27's")
    # every fault action, from logs that drop nothing
    rec_eng, _ = planes_fleet_engine(device, n, cap=cap_all, record="full")
    st = rec_eng.run_quiet(window[0])
    counts = np.zeros((B, len(ACTION_NAMES)), np.int64)
    dropped = [0] * B
    fd0 = st.fault_dropped.cpu().numpy().astype(np.int64)
    done = window[0]
    while done < window[1]:
        st, _ = rec_eng.run(8, st)
        done += 8
        for b, lg in enumerate(rec_eng.last_run_flight):
            tags = lg.tag[lg.kind == EV_FAULT]
            counts[b] += [int((tags == t).sum()) for t in ACTION_NAMES]
            dropped[b] += lg.dropped
    fd = st.fault_dropped.cpu().numpy().astype(np.int64) - fd0
    names = list(ACTION_NAMES.values())
    col = {a: names.index(a) for a in names}
    say(f"planes main path: fault actions over supersteps {window[0]}-"
        f"{window[1]} (record_cap {cap_all}, dropped 0): " + "; ".join(
            f"world {b}: " + " ".join(f"{a}={int(counts[b, col[a]])}"
                                      for a in names)
            + f" fault_dropped={int(fd[b])}" for b in range(B)))
    _require_all("planes main path: fault actions", {
        "no event dropped at cap 2^18": max(dropped) == 0,
        "restart, cut and down in every world": all(
            counts[b, col[a]] > 0 for b in range(B)
            for a in ("restart", "cut", "down")),
        # a crash defers only a pending event, and steady gossip's idle
        # nodes may hold none when their window opens
        "defer in the fleet": counts[:, col["defer"]].sum() > 0,
        "cut + down + purge events = fault_dropped in every world": all(
            counts[b, col["cut"]] + counts[b, col["down"]]
            + counts[b, col["purge"]] == fd[b] for b in range(B))})
    return launches, eng


def _same_events(what, a, b, sc) -> None:
    """Two final states of the same events at different superstep
    granularity: every leaf equal but ``steps`` and ``time``, the mailbox
    planes compared in occupied slots only (an emptied slot keeps the
    src and payload of whatever message last held it)."""
    from timewarp_tpu_torch.interp.torch_engine.state_io import state_to_numpy
    sa, sb = state_to_numpy(a, sc), state_to_numpy(b, sc)
    live = sa["mb_rel"] < 2**31 - 1
    same = {
        "mb_src": np.array_equal(np.where(live, sa["mb_src"], 0),
                                 np.where(live, sb["mb_src"], 0)),
        "mb_payload": np.array_equal(
            np.where(live[..., None, :], sa["mb_payload"], 0),
            np.where(live[..., None, :], sb["mb_payload"], 0))}
    for name in sa:
        if name in ("steps", "time", "mb_src", "mb_payload"):
            continue
        x, y = sa[name], sb[name]
        same[name] = all(np.array_equal(x[k], y[k]) for k in x) \
            if name == "states" else np.array_equal(x, y)
    bad = [k for k, ok in same.items() if not ok]
    if bad:
        raise AssertionError(f"{what}: state {bad} differ")


def phase_controlled(device, n=100_000):
    """Controlled runs and the telemetry gate. ``bench.py``
    ``_bursty_gossip(100 000)`` through ``run_controlled`` under
    ``DispatchController(chunk=16, chunk_max=64)`` with
    ``telemetry="counters"``: the engine threads the dynamic window, so its
    bound is the undegraded 8 000 µs floor and each superstep that the
    degradation window overlaps is clamped to 2 000 µs on the device
    (``short_delay`` 0). It takes strictly fewer supersteps than the static
    ``TorchEngine(window="auto", faults=...)`` at the degraded 2 000 µs
    (``bench.py`` ``gossip_100k_auto``'s gate), with the same events (every
    leaf but ``steps`` and ``time``). Then a fresh engine replays the
    decision trace: equal states and trace digests (the replay law). Then
    ``bench.py`` ``_telemetry_gate`` on ``gossip_100k_fused``'s
    configuration (``FusedSparseEngine``, ``max_batch`` 2^18, K3):
    counters give the states and traces of off; the overhead fraction of
    the median of 3 traced runs of 24 supersteps each."""
    import statistics
    from timewarp_tpu_torch.dispatch import (DecisionTrace,
                                             DispatchController)
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    sc, link, faults = bursty_gossip(n)
    eng = TorchEngine(sc, link, window="auto", faults=faults,
                      telemetry="counters", device=device,
                      controller=DispatchController(chunk=16, chunk_max=64))
    (fin, tr), wall = _timed(lambda: eng.run_controlled(1 << 20))
    decisions = eng.last_run_decisions
    static = TorchEngine(sc, link, window="auto", faults=faults,
                         device=device)
    sfin, swall = _timed(lambda: static.run_quiet(1 << 20))
    _same_events("controlled vs static-auto", fin, sfin, sc)
    replay = TorchEngine(sc, link, window="auto", faults=faults,
                         device=device, controller=DispatchController(
                             mode="replay",
                             replay=DecisionTrace.of(decisions)))
    (rfin, rtr), rwall = _timed(lambda: replay.run_controlled(1 << 20))
    _same_traces("controlled: replay law", tr, rtr)
    _states_equal("controlled: replay law", fin, rfin, sc)
    windows = sorted({d.window_us for d in decisions})
    _require_all("controlled", {
        "the undegraded bound": eng._dyn_ok and eng.window == 8_000,
        "static-auto at the degraded floor": static.window == 2_000,
        "strictly fewer supersteps than static-auto":
            len(tr) < int(sfin.steps),
        "short_delay == 0 (the per-superstep clamp)":
            int(fin.short_delay) == 0,
        "windows within the bound, rung -1": all(
            1 <= d.window_us <= eng.window and d.rung_pin == -1
            for d in decisions),
        "replayed decisions equal": [d.to_json() for d in decisions]
        == [d.to_json() for d in replay.last_run_decisions]})
    say(f"controlled: bursty gossip n={n} bound={eng.window} supersteps="
        f"{len(tr)} static_auto_supersteps={int(sfin.steps)} (window "
        f"{static.window}) delivered={int(fin.delivered)} decisions="
        f"{len(decisions)} decision_windows={windows} chunk_lens="
        f"{[d.chunk_len for d in decisions]} wall_s={wall} "
        f"static_auto_run_quiet_wall_s={swall} replay_wall_s={rwall}; "
        "the static run's events, replay = the controlled run (states, "
        "trace digests)")
    wsc, wlink = gossip_wave(n)

    def fused(mode):
        return FusedSparseEngine(wsc, wlink, window="auto", max_batch=1 << 18,
                                 telemetry=mode, device=device)
    off, on = fused("off"), fused("counters")
    f_off, tr_off = off.run(24)
    f_on, tr_on = on.run(24)
    _same_traces("telemetry gate", tr_off, tr_on)
    _states_equal("telemetry gate", f_off, f_on, wsc)

    def med(e, st):
        return statistics.median(_timed(lambda: e.run(24, st))[1]
                                 for _ in range(3))
    w_off, w_on = med(off, f_off), med(on, f_on)
    overhead = w_on / w_off - 1.0
    _require_all("telemetry gate", {"overhead under 2x": overhead <= 1.0})
    say(f"telemetry gate: gossip_100k_fused n={n} max_batch={1 << 18} 24 "
        f"supersteps: counters = off (states, traces); wall_s off={w_off} "
        f"counters={w_on} overhead_frac={overhead}")
    return overhead


@cpu_leg("planes")
def leg_planes(dev, n=1 << 12):
    """Phase 36's leg: every plane on, at 2^12 to 2^14 nodes:
    ``TorchEngine`` adaptive, eager and lazy, solo, and a 3-world faulted
    fleet; ``FusedSparseEngine``; ``EdgeEngine``. Through ``run_verified``
    (``telemetry="full", verify="digest", record="full"``): traces,
    states, frames, flight logs and integrity records; through
    ``run_controlled`` (an auto controller): decision traces."""
    from timewarp_tpu_torch.dispatch import DispatchController
    from timewarp_tpu_torch.faults import (FaultFleet, FaultSchedule,
                                           LinkWindow, NodeCrash, Partition)
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.delays import UniformDelay
    from timewarp_tpu_torch.net.links import parse_link
    half = n // 2
    fleet = FaultFleet(tuple(FaultSchedule((
        NodeCrash(3 + b, 10_000, 40_000 + 5_000 * b, reset_state=True),
        NodeCrash(half + b, 15_000, 35_000),
        Partition((tuple(range(half)), tuple(range(half, n))), 12_000,
                  30_000 + 2_000 * b),
        LinkWindow(None, None, 50_000, 70_000, scale=1.5 + 0.5 * b),
    )) for b in range(3)))
    steady = gossip(n, fanout=1, think_us=1_000, gossip_interval=1_000,
                    end_us=80_000, steady=True, mailbox_cap=8)
    burst = gossip(n, fanout=4, think_us=700, burst=True, end_us=400_000,
                   mailbox_cap=16)
    wave = gossip(4 * n, fanout=8, think_us=2_000, burst=True,
                  end_us=400_000, mailbox_cap=16)
    qlink = parse_link("quantize:1000:uniform:500:4500")
    cases = (
        ("TorchEngine adaptive", TorchEngine, wave,
         parse_link("quantize:1000:uniform:8000:30000"),
         dict(window="auto")),
        ("TorchEngine eager", TorchEngine, steady,
         parse_link("drop:0.1:quantize:1000:uniform:500:4500"), {}),
        ("TorchEngine lazy", TorchEngine, burst,
         parse_link("quantize:1000:uniform:3000:9000"),
         dict(window=3_000, route_cap=64)),
        ("TorchEngine fleet, faults", TorchEngine, steady, qlink,
         dict(window="auto", batch=BatchSpec(seeds=(3, 4, 9)),
              faults=fleet)),
        ("FusedSparseEngine", FusedSparseEngine, wave,
         parse_link("quantize:1000:uniform:8000:30000"),
         dict(window="auto", max_batch=1 << 15)),
        ("EdgeEngine", EdgeEngine, dense_ring(4 * n)[0],
         UniformDelay(500, 2_000), {}),
    )
    out = {}
    for tag, cls, sc, link, kw in cases:
        eng = cls(sc, link, telemetry="full", verify="digest",
                  record="full", record_cap=1024, device=dev, **kw)
        # 48 supersteps each, half of a 96-superstep run (chip_smoke's
        # time)
        fin, tr = eng.run_verified(48, chunk=16)
        ctl = cls(sc, link, telemetry="counters", device=dev,
                  controller=DispatchController(chunk=8, chunk_max=32), **kw)
        ctl.run_controlled(48)
        out[tag] = dict(state=_host_state(fin, sc), trace=tr, n=sc.n_nodes,
                        frames=eng.last_run_telemetry,
                        flight=eng.last_run_flight,
                        integrity=eng.last_run_integrity,
                        decisions=[d.to_json()
                                   for d in ctl.last_run_decisions])
    return out


def phase_planes_card_vs_cpu(device):
    """Every plane on, card against CPU (:func:`leg_planes`): equal traces,
    states, frames, flight logs and integrity records (guard clean,
    digests and chain), and equal decision traces."""
    def check(card, cpu):
        for tag, c in card.items():
            g = cpu[tag]
            what = f"planes card vs CPU, {tag}"
            _legs_equal(what, c, g)
            _frames_equal(what, c["frames"], g["frames"])
            _flights_equal(what, c["flight"], g["flight"])
            ia, la, da = c["integrity"], c["flight"], c["decisions"]
            _require_all(what, {
                "integrity records equal (guard clean, digests, chain)":
                    ia == g["integrity"] and ia["rollbacks"] == 0,
                "decision traces equal": da == g["decisions"]})
            one = la[0] if isinstance(la, list) else la
            say(f"planes card vs CPU: {tag}: n={c['n']} chunks="
                f"{ia['chunks']} events={len(one)} dropped={one.dropped} "
                f"decisions={len(da)} "
                f"digest_chain[0]={ia['digest_chain'][0][:16]}"
                " traces, states, frames, flight logs, integrity records and "
                "decision traces equal")
    vs_cpu("planes", device, check)


def phase_planes_times(device, eng31, warm=96, steps=16):
    """Where the chaos fleet's time goes with the planes on: ``run`` (the
    traced driver) with ``telemetry="full", record="deliveries"`` against
    ``run`` with every plane off, each as phase 31 measures (wall, then
    the same supersteps under ``torch.profiler``): launches, device and
    wall ms per fleet superstep, the idle share. Then each plane alone
    against none, in turns, by wall; and the state digest's own time
    (CUDA events) and launches over the fleet's state."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from timewarp_tpu_torch.integrity.digest import host_digests
    mid = eng31.run_quiet(warm)
    rows = {}
    for tag, planes in (("planes off", {}),
                        ("telemetry=full record=deliveries",
                         dict(telemetry="full", record="deliveries"))):
        eng, _ = planes_fleet_engine(device, **planes)
        eng.run(4, mid)                                    # warm
        _, wall = _timed(lambda: eng.run(steps, mid))
        # the device's activity only, as phase_where_time_goes records it
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.run(steps, mid)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in kernels)
        launches = sum(e.count for e in kernels)
        rows[tag] = (wall, dev_us, launches)
        say(f"where the time goes, chaos fleet traced run, {tag}: {steps} "
            f"fleet supersteps from superstep {warm}: wall_ms_per_superstep="
            f"{wall / steps * 1e3} device_ms_per_superstep="
            f"{dev_us / steps / 1e3} device_idle_share="
            f"{1 - dev_us / 1e6 / wall} device_launches_per_superstep="
            f"{launches / steps}")
    # each plane alone on the traced driver, in turns (A..E, E..A, twice):
    # the shared host's wall spreads, so only turns within one call compare
    modes = (("off", {}), ("telemetry=full", dict(telemetry="full")),
             ("verify=guard", dict(verify="guard")),
             ("record=deliveries", dict(record="deliveries")),
             ("record=full", dict(record="full")))
    engs = [(tag, planes_fleet_engine(device, **planes)[0])
            for tag, planes in modes]
    for _, eng in engs:
        eng.run(2, mid)                                    # warm
    walls = {tag: [] for tag, _ in modes}
    for order in (engs, engs[::-1], engs, engs[::-1]):
        for tag, eng in order:
            walls[tag].append(_timed(lambda: eng.run(16, mid))[1] / 16 * 1e3)
    for tag, w in walls.items():
        say(f"chaos fleet traced run, {tag} alone: wall_ms_per_fleet_"
            f"superstep={sorted(w)} median={float(np.median(w))} "
            f"overhead_frac={float(np.median(w)) / float(np.median(walls['off'])) - 1.0}")
    u32 = eng31.scenario.u32_states
    host_digests(mid, eng31.batch, u32)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        host_digests(mid, eng31.batch, u32)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    d_launches = sum(e.count for e in kernels)
    d_dev = sum(e.self_device_time_total for e in kernels) / 1e3
    d_ms = _time_ms(lambda: host_digests(mid, eng31.batch, u32), reps=5,
                    queued=False)
    nbytes = sum(x.numel() * x.element_size() for x in
                 [*mid.states.values(), *(v for k, v in mid._asdict().items()
                                          if k != "states")])
    say(f"state digest over the chaos fleet's state ({nbytes} bytes, 8 "
        f"worlds): ms={d_ms} (CUDA events, its host read included) "
        f"device_ms={d_dev} launches={d_launches} ({nvidia_smi()})")
    return rows, d_ms


# the speculative slice: bench.py gossip_100k_spec at 100 000 nodes, its
# fleet of 8 worlds, and fixed:8000 for the masked rollback
SPEC_N, SPEC_B, SPEC_W = 100_000, 8, 8_000
# phase 39: Pareto xm_us of the even worlds (below W: they violate) and the
# odd ones (above W: never), the tail capped at 50 ms (at the floor, a
# superstep per 500 µs of the tail's span)
SPEC_XM_US, SPEC_CAP_US = (4_000, 9_000), 50_000


def _wave_done(what, eng, fin, n) -> None:
    """bench.py _assert_wave_done, and overflow 0: every world quiesced,
    ``short_delay`` and ``route_drop`` 0, at most ``max(n // 500, 8)`` nodes
    never infected in any world."""
    missed = (fin.states["hop"].reshape(-1, n) < 0).sum(dim=1).tolist()
    _require_all(what, {
        "quiesced": not bool(eng.world_active(fin).any()),
        "short_delay == 0": int(fin.short_delay.sum()) == 0,
        "route_drop == 0": int(fin.route_drop.sum()) == 0,
        "overflow == 0": int(fin.overflow.sum()) == 0,
        f"missed {missed} <= max(n // 500, 8)":
            max(missed) <= max(n // 500, 8)})


def _record_runs(eng):
    """Wrap ``eng.run`` (an instance attribute, so the speculative
    driver's ``self.run`` goes through it) to record each call: its start
    state and window, K2's and K1's launches during it, the fleet
    supersteps it executed (``last_run_stats``, set before a violation is
    raised) and whether it violated (a solo run raises, a fleet run's
    decode reports on ``last_run_spec``). Returns the list of records;
    ``del eng.run`` unwraps."""
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    calls, run = [], eng.run

    def record(max_steps, state=None, *, _dyn=None):
        before = dict(ci.LAUNCHES)
        call = dict(state=state, dyn=_dyn, violated=True)
        calls.append(call)
        try:
            out = run(max_steps, state, _dyn=_dyn)
            call["violated"] = eng.last_run_spec is not None
            return out
        finally:
            call["iters"] = eng.last_run_stats["fleet_supersteps"]
            for k in ("fire_compact", "mailbox_insert"):
                call[k] = ci.LAUNCHES[k] - before[k]
    eng.run = record
    return calls


def _once_per_superstep(what, calls) -> None:
    """Every recorded run call launched K2 and K1 exactly once per fleet
    superstep it executed, rolled back or committed."""
    _require_all(what, {
        f"call {i}: K2 = K1 = its {c['iters']} supersteps":
            c["fire_compact"] == c["mailbox_insert"] == c["iters"]
        for i, c in enumerate(calls)})


def phase_spec_kernels(tag, eng, state, dyn, steps):
    """K2 and K1 on the busiest superstep's own arguments of a chunk of
    ``steps`` supersteps from ``state`` at the window ``dyn`` (a
    speculating engine's ``run``, taken where the stage receives them; a
    straggler raises after the kernels ran, and is ignored), each
    bit-equal to its plain version; then their times at that shape."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.speculate import SpeculationViolation

    def drive():
        try:
            eng.run(steps, state, _dyn=dyn)
        except SpeculationViolation:
            pass
    a2, a1 = _stage_args(eng, drive)
    err2 = _equal(f"K2 {tag}", ci.fire_compact(*a2),
                  ci.fire_compact_plain(*a2))
    err1 = _equal(f"K1 {tag}", ci.mailbox_insert(*a1),
                  ci.mailbox_insert_plain(*a1))
    torch.cuda.synchronize()
    B, M, n = a2[0].shape
    say(f"K2 and K1 on the busiest superstep of a chunk of the {tag} "
        f"({steps} supersteps at {int(dyn.window)} us from virtual time "
        f"{state.time.cpu().tolist()} us): B={B} n={n} M={M} "
        f"P={a2[2].shape[2]} S={a2[3]} fired="
        f"{(a2[0] >= 0).sum(dim=(1, 2)).tolist()} K={a1[6].shape[1]} "
        f"valid={a1[1].sum(dim=1).tolist()}; bit-equal to their plain "
        f"versions max_abs_err={max(err2, err1)}")
    _time_stage_args(f"the busiest superstep of a chunk of the {tag}", a2,
                     a1)
    return err2, err1


def phase_spec_main_path(device, n=SPEC_N, chunk=64):
    """The speculative slice's main path: ``bench.py`` ``gossip_100k_spec``
    through ``TorchEngine(speculate="auto").run_speculative(2^14,
    chunk=64)`` to quiescence, and the conservative
    ``TorchEngine(window="auto")`` through ``run``: the equivalence law's
    right-hand side, and the wall beside the speculative one's (both
    traced; the bench times the conservative ``run_quiet``, a second
    wave of 3157 supersteps that chip_smoke's time limit leaves out).
    Gates: the wave done in both, the canonical surfaces equal bit for
    bit, strictly fewer supersteps, K2 and K1 launched once per superstep
    of every run call, the committed calls' supersteps the committed
    count and the rolled-back calls' the launches beyond it, one
    rolled-back call per rollback. Then K2 and K1 against their plain
    versions on the run's busiest committed superstep. The wall
    ratio is printed, not gated. Returns the launches, both engines, the
    kernels' errors and the start state and index of the first committed
    chunk at the widest window (phase 41's)."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.speculate import assert_spec_equiv, canonical_rows
    sc, link = spec_gossip(n)
    spec = TorchEngine(sc, link, window="auto", speculate="auto",
                       device=device)
    cons = TorchEngine(sc, link, window="auto", device=device)
    calls = _record_runs(spec)
    torch.cuda.synchronize()
    ci.reset_launches()
    try:
        (sfin, strc), wall_spec = _timed(
            lambda: spec.run_speculative(1 << 14, chunk=chunk))
    finally:
        del spec.run
    launches = dict(ci.LAUNCHES)
    si = spec.last_run_speculation
    committed = spec.last_run_stats["supersteps"]
    (cfin, ctrc), wall_cons = _timed(lambda: cons.run(1 << 14))
    _wave_done("speculative wave", spec, sfin, n)
    _wave_done("conservative wave", cons, cfin, n)
    assert_spec_equiv(canonical_rows(cfin, ctrc), canonical_rows(sfin, strc),
                      "gossip_100k_spec")
    _once_per_superstep("speculative main path", calls)
    kept = [c for c in calls if not c["violated"]]
    rolled = sum(c["iters"] for c in calls if c["violated"])
    decs = spec.last_run_decisions
    _require_all("speculative main path", {
        "floor 500, auto bound": spec.spec_floor == cons.window == 500
        and spec.window == 2**31 - 2,
        "strictly fewer supersteps": len(strc) < len(ctrc),
        "committed supersteps = trace rows": committed == len(strc),
        "committed calls' supersteps = committed supersteps":
            sum(c["iters"] for c in kept) == committed,
        "one committed call per decision": len(kept) == len(decs),
        "one rolled-back call per rollback":
            len(calls) - len(kept) == si["rollbacks"],
        "K2 launches = committed + rolled-back supersteps":
            launches["fire_compact"] == committed + rolled,
        "K1 launches = committed + rolled-back supersteps":
            launches["mailbox_insert"] == committed + rolled,
        "no K3/K4 launch":
            launches["sample_insert"] == launches["fused_ring"] == 0})
    viols = si["violations"]
    say(f"speculative main path: gossip_100k_spec n={n} chunk={chunk} "
        f"supersteps spec={len(strc)} conservative={len(ctrc)} "
        f"delivered={int(sfin.delivered)} windows={si['windows']} "
        f"chunks={si['chunks']} rollbacks={si['rollbacks']} violations="
        f"{[(v['chunk'], v['window_us'], v['count']) for v in viols]}"
        f" wall_s spec={wall_spec} conservative_run={wall_cons} "
        f"wall_ratio={wall_cons / wall_spec} launches={launches} "
        f"committed_launches_each={committed} rolled_back_launches_each="
        f"{rolled} run_calls={len(calls)} supersteps_per_call="
        f"{[(c['iters'], c['violated']) for c in calls]}; canonical "
        "surfaces equal")
    # the committed chunk that holds the run's busiest superstep (the
    # most messages sent), re-run from its start state at its window
    busy = int(np.searchsorted(np.cumsum([c["iters"] for c in kept]),
                               int(np.argmax(strc.sent_count)), "right"))
    errs = phase_spec_kernels("speculative main path", spec,
                              kept[busy]["state"], kept[busy]["dyn"],
                              kept[busy]["iters"])
    # the first committed chunk at the widest window the chain committed
    k = max(range(len(decs)), key=lambda i: (decs[i].window_us, -i))
    return launches, spec, cons, errs, (k, kept[k]["state"])


def phase_spec_fleet(device, n=SPEC_N, B=SPEC_B, W=SPEC_W, chunk=64,
                     xm_us=SPEC_XM_US, cap_us=SPEC_CAP_US):
    """A speculative fleet with a masked rollback: 8 worlds of the gossip
    at 100 000 nodes under ``speculate="fixed:8000"``, Pareto ``xm_us``
    ``xm_us[0]`` in the even worlds (below W: they violate) and
    ``xm_us[1]`` in the odd ones (above W: never), the tail capped at
    ``cap_us``. Gates: ``1 <=
    rerun_worlds <= 7``, rollbacks in every even world's committed chain
    and in no odd world's, K1 and K2 each launched once per fleet
    superstep of every run call (speculative chunks and masked re-runs),
    and every world's canonical row equal to its row of one conservative
    fleet run. Then K2 and K1 against their plain versions on the
    busiest superstep of the first chunk that violated. Returns the
    launches and the kernels' errors."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.speculate import assert_spec_equiv, canonical_rows
    sc, link = spec_gossip(n, cap_us)
    xm = np.array([xm_us[b % 2] for b in range(B)])
    batch = BatchSpec(seeds=tuple(range(B)), link_params={"inner.xm_us": xm})
    spec = TorchEngine(sc, link, window="auto", speculate=f"fixed:{W}",
                       batch=batch, device=device)
    calls = _record_runs(spec)
    torch.cuda.synchronize()
    ci.reset_launches()
    try:
        (sfin, strc), wall = _timed(
            lambda: spec.run_speculative(1 << 14, chunk=chunk))
    finally:
        del spec.run
    launches = dict(ci.LAUNCHES)
    si = spec.last_run_speculation
    iters = spec.last_run_stats["fleet_supersteps"]
    cons = TorchEngine(sc, link, window="auto", batch=batch, device=device)
    (cfin, ctrc), cwall = _timed(lambda: cons.run(1 << 14))
    _wave_done("speculative fleet", spec, sfin, n)
    assert_spec_equiv(canonical_rows(cfin, ctrc, B=B),
                      canonical_rows(sfin, strc, B=B), "speculative fleet")
    _once_per_superstep("speculative fleet", calls)
    _require_all("speculative fleet", {
        f"1 <= rerun_worlds {si['rerun_worlds']} <= {B - 1}":
            1 <= si["rerun_worlds"] <= B - 1,
        "rolled back in the xm < W worlds only": [
            any(d.obs.get("rolled_back") for d in chain)
            for chain in spec.last_run_decisions_world]
        == [b % 2 == 0 for b in range(B)],
        "run calls' supersteps = fleet supersteps":
            sum(c["iters"] for c in calls) == iters,
        "K2 launched once per fleet superstep":
            launches["fire_compact"] == iters,
        "K1 launched once per fleet superstep":
            launches["mailbox_insert"] == iters})
    say(f"speculative fleet: B={B} n={n} fixed:{W} xm_us={xm.tolist()} "
        f"cap_us={cap_us} fleet_supersteps={iters} chunks={si['chunks']} "
        f"rollbacks={si['rollbacks']} rerun_worlds={si['rerun_worlds']} "
        f"violating_worlds={sorted({v['world'] for v in si['violations']})}"
        f" world_supersteps={[len(t) for t in strc]} "
        f"conservative_world_supersteps={[len(t) for t in ctrc]} "
        f"wall_s={wall} conservative_wall_s={cwall} launches={launches} "
        f"supersteps_per_call={[(c['iters'], c['violated']) for c in calls]}"
        "; every world = its conservative fleet row")
    hit = next(c for c in calls if c["violated"])
    errs = phase_spec_kernels("speculative fleet", spec, hit["state"],
                              hit["dyn"], chunk)
    return launches, errs


@cpu_leg("spec")
def leg_spec(dev, n=1 << 12):
    """Phase 40's leg: speculation at 2^12 nodes (gossip, fanout 4, 10 ms
    incubation) on an integer link with the long-tail floor gap (delays
    uniform in [4 ms, 40 ms] from the message key's first word behind a
    1 ms grid: declared 1 000 µs, exact on every device): solo ``auto``, a
    2-world fleet under a shrink ``LinkWindow``, and a forced rollback
    (``fixed:16000``): states, traces, decisions (per world too) and
    ``last_run_speculation``."""
    import torch
    from timewarp_tpu_torch.faults import FaultFleet, FaultSchedule, LinkWindow
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.delays import FnDelay, Quantize

    class DropFree(FnDelay):
        # FnDelay's conservative can_drop would take the eager regime
        can_drop = False

    def gap(src, dst, t, key):
        return 4_000 + key[0] % 36_001, torch.zeros_like(dst, dtype=torch.bool)
    sc = gossip(n, fanout=4, think_us=10_000, burst=True, end_us=5_000_000,
                mailbox_cap=16)
    link = Quantize(DropFree(gap), 1_000)
    shrink = FaultSchedule((LinkWindow(None, None, 40_000, 80_000,
                                       scale=0.25),))
    cases = {
        "solo auto": dict(speculate="auto"),
        "fleet under a shrink window": dict(
            speculate="auto", batch=BatchSpec(seeds=(0, 1)),
            faults=FaultFleet((shrink, FaultSchedule(())))),
        "forced rollback": dict(speculate="fixed:16000")}
    out = {}
    for tag, kw in cases.items():
        eng = TorchEngine(sc, link, window="auto", seed=11, device=dev, **kw)
        fin, tr = eng.run_speculative(1 << 16, chunk=64)
        chains = eng.last_run_decisions_world
        out[tag] = dict(
            state=_host_state(fin, sc), trace=tr, n=n,
            spec=eng.last_run_speculation,
            decisions=[d.to_json() for d in eng.last_run_decisions],
            chains=None if chains is None else [[d.to_json() for d in c]
                                                for c in chains])
    return out


def phase_spec_card_vs_cpu(device):
    """Speculation card against CPU (:func:`leg_spec`): equal states,
    traces, decisions (per world too) and ``last_run_speculation``."""
    def check(card, cpu):
        for tag, c in card.items():
            g = cpu[tag]
            what = f"speculation card vs CPU, {tag}"
            _legs_equal(what, c, g)
            _require_all(what, {
                "last_run_speculation equal": c["spec"] == g["spec"],
                "decisions equal": c["decisions"] == g["decisions"],
                "per-world chains equal": None in (c["chains"], g["chains"])
                or c["chains"] == g["chains"]})
            si, ta = c["spec"], c["trace"]
            say(f"speculation card vs CPU: {tag} n={c['n']} supersteps="
                f"{[len(t) for t in ta] if isinstance(ta, list) else len(ta)} "
                f"windows={si['windows']} rollbacks={si['rollbacks']} "
                f"rerun_worlds={si['rerun_worlds']}; states, traces, "
                "decisions and speculation records equal")
    vs_cpu("spec", device, check)


def phase_spec_times(device, spec, cons, wide, steps=32, warm=16):
    """Where a speculative chunk's time goes: phase 38's speculating
    engine through the traced ``run`` (the causality plane's rows on) over
    the first ``steps`` supersteps of the first chunk its committed
    decision chain ran at its widest window — ``wide``, that chunk's index
    and start state as phase 38's run kept them — beside the conservative
    engine through the same driver from superstep ``warm``, as phase 7
    measures."""
    k, st = wide
    dec = spec.last_run_decisions[k]
    dyn = spec.dyn_values(dec)
    phase_where_time_goes(
        f"speculative chunk {k} at {dec.window_us} us (TorchEngine, "
        f"traced run, from virtual time {int(st.time)} us)",
        spec, int(st.steps), steps,
        run=lambda n, s: spec.run(n, s, _dyn=dyn)[0], mid=st)
    phase_where_time_goes(
        "conservative at 500 us (TorchEngine, traced run)", cons, warm,
        steps, run=lambda n, s: cons.run(n, s)[0])


# -- the sweep service: sweep_hetero and the 8-world chaos pack -------------

def chaos_pack(n=CHAOS_N, B=CHAOS_B, budget=1024):
    """``bench.py`` ``bench_gossip_100k_chaos``'s 8 worlds as pack JSON:
    world b's seed b and its fault schedule in the ``--faults`` grammar
    (:func:`chaos_fleet`'s schedules), ``budget`` supersteps (the default
    past the fleet's quiescence)."""
    from timewarp_tpu_torch.sweep import SweepPack
    half = n // 2
    params = {"nodes": n, "fanout": 1, "think_us": 1000,
              "gossip_interval": 1000, "end_us": 300_000, "steady": True,
              "mailbox_cap": 8}
    return SweepPack.from_json([{
        "id": f"chaos-{b}", "scenario": "gossip", "params": params,
        "link": "quantize:1000:uniform:500:4500", "window": "auto",
        "seed": b, "budget": budget,
        "faults": f"crash:{(7 * b + 3) % n}:20ms:{60 + 5 * b}ms:reset; "
                  f"crash:{(11 * b + half + 5) % n}:30ms:{70 + 5 * b}ms; "
                  f"partition:0-{half - 1}|{half}-{n - 1}:25ms:"
                  f"{70 + 2 * b}ms; degrade:all:all:80ms:120ms:"
                  f"{2.0 + 0.25 * b}"} for b in range(B)])


#: the modules whose ``build_bucket_engine`` the sweep's buckets and the
#: serving layer's open buckets come from
SWEEP_BUILDERS = ["timewarp_tpu_torch.sweep.runner",
                  "timewarp_tpu_torch.serve.worker"]


class BucketRecorder:
    """Wraps every bucket engine a sweep, a search or the serving layer
    builds (the ``build_bucket_engine`` of each module in ``targets``:
    :data:`SWEEP_BUILDERS` by default) so that each ``run`` call is recorded: its
    bucket, engine, budgets and start state, the fleet supersteps it
    executed, K2's and K1's launches during it and the messages its worlds
    sent. A context manager: the builders are restored on exit."""

    def __init__(self, targets=None):
        self.engines, self.calls, self.built = {}, [], []
        self.targets = targets

    def __enter__(self):
        import importlib

        from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
        from timewarp_tpu_torch.sweep.bucket import build_bucket_engine
        self._mods = [importlib.import_module(m) for m in (
            self.targets or SWEEP_BUILDERS)]
        self._saved = [m.build_bucket_engine for m in self._mods]

        def built(bucket, **kw):
            eng = build_bucket_engine(bucket, **kw)
            run = eng.run
            self.engines[bucket.bucket_id] = (eng, run)
            self.built.append(eng)

            def record(max_steps, state=None, **run_kw):
                before = dict(ci.LAUNCHES)
                call = dict(bucket=bucket.bucket_id, budgets=max_steps,
                            state=state, adaptive=eng.adaptive, eng=eng,
                            run=run)
                self.calls.append(call)
                try:
                    out = run(max_steps, state, **run_kw)
                    call["sent"] = sum(int(t.sent_count.sum())
                                       for t in out[1])
                    return out
                finally:
                    call["iters"] = eng.last_run_stats["fleet_supersteps"]
                    for k in ("fire_compact", "mailbox_insert"):
                        call[k] = ci.LAUNCHES[k] - before[k]
            eng.run = record
            return eng
        for m in self._mods:
            m.build_bucket_engine = built
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self._mods, self._saved):
            m.build_bucket_engine = fn
        for eng in self.built:
            del eng.run
        return False

    def check(self, what):
        """K1 once per fleet superstep of every run call, and K2 as often
        on buckets in the adaptive regime (none on the others)."""
        _require_all(what, {
            f"call {i} ({c['bucket']}): K1 = its {c['iters']} supersteps, "
            f"K2 = {'the same' if c['adaptive'] else '0'}":
                c["mailbox_insert"] == c["iters"]
                and c["fire_compact"] == c["iters"] * c["adaptive"]
            for i, c in enumerate(self.calls)})

    def per_bucket(self):
        out = {}
        for c in self.calls:
            o = out.setdefault(c["bucket"], dict(
                regime="adaptive" if c["adaptive"] else "eager", calls=0,
                fleet_supersteps=0, fire_compact=0, mailbox_insert=0))
            o["calls"] += 1
            for k in ("fleet_supersteps", "fire_compact", "mailbox_insert"):
                o[k] += c["iters" if k == "fleet_supersteps" else k]
        return out


def _survival(what, done, want) -> None:
    """Every streamed record equals its solo twin's (the sweep survival
    law), and every world streamed."""
    bad = [rid for rid in want if done.get(rid) != want[rid]]
    if bad:
        rid = bad[0]
        raise AssertionError(
            f"{what}: sweep survival law violated for {bad}; {rid}:\n"
            f"  solo:     {want[rid]}\n  streamed: {done.get(rid)}")


def _sweep_leg(device, pack, launches, jd=None, **kw):
    """One service run of ``pack`` in a fresh journal dir under
    ``build/`` (or the resume of the sweep in ``jd``), every bucket engine
    recorded and the launch counts reset just before it and added to
    ``launches`` just after. Returns ``(report, wall, scan, recorder,
    journal dir)``; the report is None when an injected kill ended the
    run."""
    import tempfile

    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.sweep import SweepJournal, SweepService
    from timewarp_tpu_torch.sweep.service import SweepKilled
    if jd is None:
        jd = tempfile.mkdtemp(prefix="sweep-", dir=_scratch())
        svc = SweepService(pack, jd, device=device, **kw)
    else:
        svc = SweepService.resume(jd, device=device, **kw)
    with BucketRecorder() as rec:
        torch.cuda.synchronize()
        ci.reset_launches()
        try:
            report, wall = _timed(svc.run)
        except SweepKilled:
            report, wall = None, None
        finally:
            for k in launches:
                launches[k] += ci.LAUNCHES[k]
    return report, wall, SweepJournal(jd).scan(), rec, jd


class LintClock:
    """The port's lint walls while the block runs: the pack lints
    (``lint_pack``, their scenario traces included), the construction
    lints that traced a scenario outside a pack lint (a cached report
    costs nothing and is not counted), how many scenarios were traced,
    and the block's wall."""

    def __enter__(self):
        import timewarp_tpu_torch.analysis as an
        self.an, orig = an, (an.lint_scenario, an.lint_pack)
        self.orig = orig
        self.pack_s = self.build_s = 0.0
        self.traced = 0
        depth = [0]

        def lint_scenario(*a, **kw):
            t = time.perf_counter()
            try:
                return orig[0](*a, **kw)
            finally:
                self.traced += 1
                if not depth[0]:
                    self.build_s += time.perf_counter() - t

        def lint_pack(*a, **kw):
            depth[0] += 1
            t = time.perf_counter()
            try:
                return orig[1](*a, **kw)
            finally:
                depth[0] -= 1
                self.pack_s += time.perf_counter() - t
        an.lint_scenario, an.lint_pack = lint_scenario, lint_pack
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall = time.perf_counter() - self.t0
        self.an.lint_scenario, self.an.lint_pack = self.orig
        return False

    def line(self, what):
        return (f"{what}: pack_lint_s={self.pack_s} construction_lint_s="
                f"{self.build_s} scenarios_traced={self.traced} rest_s="
                f"{self.wall - self.pack_s - self.build_s}")


def _scratch():
    """``build/`` beside this script (listed in .gitignore): sweep
    journals and checkpoints."""
    import os
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "sweeps")
    os.makedirs(d, exist_ok=True)
    return d


#: phase 42's size: bench.py sweep_hetero's 4096 nodes at 256 steps
HETERO_N, HETERO_STEPS = 4096, 256


@cpu_leg("hetero_solos")
def leg_hetero_solos(dev, n=HETERO_N, steps=HETERO_STEPS):
    """Phase 42's solo twins: ``solo_result`` of every config of the pack
    on ``dev`` (the CPU, in the CPU legs' process)."""
    from timewarp_tpu_torch.sweep import solo_result
    return {c.run_id: solo_result(c, device=dev)
            for c in hetero_pack(n, steps)[0].configs}


def phase_sweep_hetero(device, n=HETERO_N, steps=HETERO_STEPS):
    """``bench.py`` ``sweep_hetero`` on the card at its 4096 nodes and
    ``steps`` 256 (the bench's default 2000 took chip_smoke to 1074 s of
    its 1200 s, 1000 took it to 1084.6 s once phases 46-48 ran on a slow
    host, and 500 left it past 1200 s on one: its token rings run to
    their budgets at 15-20 ms a superstep, in both legs and in their solo
    runs): the pack through
    the port's ``SweepService`` twice, ``pack_mode="first-fit"`` and
    ``"predicted"``, each with ``inject="fail:2"``, ``max_bucket=2`` and
    the bench's chunk. Gates: ``report.ok`` and a retry in each leg;
    every streamed record equal to the port's ``solo_result`` on the CPU
    (:func:`leg_hetero_solos`);
    the bench's packing gates (``budget_efficiency`` strictly better,
    ``pad_waste_frac`` no worse, equal engine builds, one ``pack_decision``
    per bucket and none for first-fit); K1 once per fleet superstep of
    every bucket engine's ``run`` call and K2 as often on adaptive buckets.
    Returns the legs' K1/K2 launches and ``(journal dir, pack)`` of the
    predicted leg, whose journal is kept for phase 48's ledger."""
    import shutil

    from timewarp_tpu_torch.sweep.journal import util_rollup
    pack, chunk = hetero_pack(n, steps)
    want = LEGS.get("hetero_solos") \
        if LEGS is not None and (n, steps) == (HETERO_N, HETERO_STEPS) \
        else leg_hetero_solos("cpu", n, steps)
    launches = {"fire_compact": 0, "mailbox_insert": 0}
    legs = {}
    for mode in ("first-fit", "predicted"):
        report, wall, scan, rec, jd = _sweep_leg(
            device, pack, launches, chunk=chunk, inject="fail:2",
            max_bucket=2, pack_mode=mode)
        if mode == "predicted":
            keep = (jd, pack)
        else:
            shutil.rmtree(jd, ignore_errors=True)
        _require_all(f"sweep_hetero {mode}", {
            "report.ok": report.ok, "retries >= 1": report.retries >= 1})
        _survival(f"sweep_hetero {mode}", report.done, want)
        rec.check(f"sweep_hetero {mode}")
        legs[mode] = dict(
            report=report, wall=wall, roll=util_rollup(scan.util),
            builds=sum(int(u.get("engine_builds", 0))
                       for u in scan.util.values()),
            decisions=len(scan.pack_decisions), buckets=rec.per_bucket(),
            delivered=sum(r["delivered"] for r in report.done.values()))
    ff, pr = legs["first-fit"], legs["predicted"]
    _require_all("sweep_hetero packing", {
        "budget_efficiency strictly better":
            pr["roll"]["budget_efficiency"] > ff["roll"]["budget_efficiency"],
        "pad_waste_frac no worse":
            pr["roll"]["pad_waste_frac"] <= ff["roll"]["pad_waste_frac"]
            + 1e-9,
        "equal engine builds": pr["builds"] == ff["builds"],
        "no pack_decision for first-fit": ff["decisions"] == 0,
        "one pack_decision per bucket":
            pr["decisions"] == pr["report"].buckets})
    for mode, leg in legs.items():
        say(f"sweep_hetero {mode}: n={n} steps={steps} chunk={chunk} "
            f"report={leg['report'].to_json()} wall_s={leg['wall']} "
            f"delivered={leg['delivered']} aggregate_delivered_msgs_per_s="
            f"{leg['delivered'] / leg['wall']} rollup={leg['roll']} "
            f"engine_builds={leg['builds']} pack_decisions="
            f"{leg['decisions']} buckets={leg['buckets']}")
    say(f"sweep_hetero: every streamed record = its solo run on the CPU "
        f"(supersteps {[w['supersteps'] for w in want.values()]}); "
        f"launches={launches}")
    return launches, keep


def phase_chaos_pack(device, chaos_eng, n=CHAOS_N, B=CHAOS_B, chunk=64,
                     budget=CHAOS_PACK_BUDGET):
    """The 8 worlds of ``bench.py`` ``gossip_100k_chaos`` as a pack at
    ``budget`` supersteps each, one
    bucket (``max_bucket=8``), through the port's ``SweepService`` with
    ``chunk=64`` and ``verify="digest"``: with ``inject="fail:2"``; killed
    by ``inject="die:3"`` (``SweepKilled``) and resumed; and split 4 + 4
    from its checkpoint by ``inject="oom:2"``. Gates: each leg's report
    (a retry; the kill mid-bucket, no world lost or journaled twice across
    the resume; the split journaled); every streamed record equal to the
    world's solo run on the card and to world b's row of the chaos fleet
    run of phase 27's engine from its initial state for ``budget``
    supersteps (``chain_digest`` of its trace, its counters; that run's
    final state = the engine's ``run_quiet`` for as many, every world past
    the last fault window's end at 120 ms); K1 and
    K2 once per fleet superstep of every bucket ``run`` call; then K2 and
    K1 against their plain versions on the bucket's busiest superstep,
    and their times there. Returns the launches, the kernels' errors, the
    pack, the main leg's wall and ``bucket_util`` record and the worlds'
    solo results."""
    import shutil

    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.sweep import solo_result
    from timewarp_tpu_torch.sweep.spec import (DIGEST_ZERO, chain_digest,
                                               result_leaves, world_result)
    pack = chaos_pack(n, B, budget)
    # world b's row of the chaos fleet run (phase 27's engine), traced from
    # its initial state for the pack's budget
    fin, traces = chaos_eng.run(budget)
    _states_equal("chaos fleet traced run = run_quiet", fin,
                  chaos_eng.run_quiet(budget), chaos_eng.scenario)
    _require_all("chaos fleet rows", {
        f"every world {budget} supersteps":
            [len(t) for t in traces] == [budget] * B,
        "every world past the last fault window (120 ms)":
            min(int(t.times[-1]) for t in traces) >= 120_000})
    host = result_leaves(fin)
    rows = {c.run_id: world_result(c, fin, b, chain_digest(
        DIGEST_ZERO, traces[b]), len(traces[b]), host)
        for b, c in enumerate(pack.configs)}
    del fin, traces
    want = {c.run_id: solo_result(c, device=device) for c in pack.configs}
    _survival("chaos pack: solo runs = phase 27's fleet rows", rows, want)
    launches = {"fire_compact": 0, "mailbox_insert": 0}
    kw = dict(chunk=chunk, max_bucket=B, verify="digest")
    report, wall, scan, rec, jd = _sweep_leg(device, pack, launches,
                                             inject="fail:2", **kw)
    shutil.rmtree(jd, ignore_errors=True)
    _require_all("chaos pack, transient", {
        "report.ok": report.ok, "retries >= 1": report.retries >= 1,
        "one bucket": report.buckets == 1})
    _survival("chaos pack, transient", report.done, want)
    rec.check("chaos pack, transient")
    main = rec

    before = dict(launches)
    cut, _, mid, _, jd = _sweep_leg(device, pack, launches,
                                    inject="die:3", **kw)
    resumed, _, scan_res, rrec, _ = _sweep_leg(device, None, launches,
                                               jd=jd, **kw)
    shutil.rmtree(jd, ignore_errors=True)
    ids = [e["result"]["run_id"] for e in scan_res.events
           if e.get("ev") == "world_done"]
    _require_all("chaos pack, kill and resume", {
        "killed mid-bucket": cut is None and len(mid.done) < B,
        "resumed report.ok": resumed.ok,
        "no world lost": sorted(ids) == sorted(want),
        "no world journaled twice": len(ids) == len(set(ids))})
    _survival("chaos pack, resumed", resumed.done, want)
    rrec.check("chaos pack, resumed")
    kill_launches = {k: launches[k] - before[k] for k in launches}

    report_oom, _, scan_oom, orec, jd = _sweep_leg(device, pack, launches,
                                                   inject="oom:2", **kw)
    shutil.rmtree(jd, ignore_errors=True)
    _require_all("chaos pack, OOM split", {
        "report.ok": report_oom.ok, "one split": report_oom.splits == 1,
        "bucket_split journaled": scan_oom.splits == {
            "b0": ["b0.0", "b0.1"]},
        "4 + 4": sorted(orec.per_bucket()) == ["b0", "b0.0", "b0.1"]
        and [orec.engines[k][0].B for k in ("b0.0", "b0.1")]
        == [B // 2, B - B // 2]})
    _survival("chaos pack, OOM split", report_oom.done, want)
    orec.check("chaos pack, OOM split")

    # K2 and K1 on the main leg's busiest superstep: the committed call
    # that sent the most, re-driven from its start state
    busy = max((c for c in main.calls), key=lambda c: c["sent"])
    eng, run = main.engines[busy["bucket"]]
    a2, a1 = _stage_args(eng, lambda: run(busy["budgets"], busy["state"]))
    err2 = _equal("K2 chaos pack bucket", ci.fire_compact(*a2),
                  ci.fire_compact_plain(*a2))
    err1 = _equal("K1 chaos pack bucket", ci.mailbox_insert(*a1),
                  ci.mailbox_insert_plain(*a1))
    torch.cuda.synchronize()
    _time_stage_args("the chaos pack bucket's busiest superstep", a2, a1)
    for tag, r, st in (("transient", report, main), ("resumed", resumed,
                                                     rrec),
                       ("OOM split", report_oom, orec)):
        say(f"chaos pack {tag}: report={r.to_json()} buckets="
            f"{st.per_bucket()}")
    say(f"chaos pack: B={B} n={n} chunk={chunk} verify=digest wall_s={wall} "
        f"world_supersteps={[w['supersteps'] for w in want.values()]} "
        f"delivered={sum(w['delivered'] for w in want.values())} "
        f"kill_and_resume_launches={kill_launches} launches={launches}; "
        "every streamed record = its solo run = its row of phase 27's fleet")
    return launches, (err2, err1), pack, wall, scan.util["b0"], want


def phase_sweep_card_vs_cpu(device):
    """``tests/test_zsweep.py``'s ``PACK`` (token rings of 20 nodes, one
    faulted, and a windowed gossip of 24) through the port's service on
    the card and on the CPU, ``chunk=16`` and ``inject="fail:2"``: equal
    ``report.done`` and an equal journal, record for record, wall-clock
    fields left out."""
    import shutil
    import tempfile

    from timewarp_tpu_torch.sweep import SweepJournal, SweepPack, SweepService
    ring = {"nodes": 20, "n_tokens": 3, "think_us": 2000, "end_us": 70000,
            "mailbox_cap": 8}
    gossip = {"nodes": 24, "fanout": 3, "burst": True, "end_us": 90000,
              "mailbox_cap": 16, "think_us": 700}
    pack = SweepPack.from_json([
        {"id": "ring-a", "scenario": "token-ring", "params": ring,
         "link": "uniform:1000:5000", "seed": 0, "budget": 60},
        {"id": "ring-b", "scenario": "token-ring", "params": ring,
         "link": "uniform:2000:7000", "seed": 3, "budget": 90},
        {"id": "ring-c", "scenario": "token-ring", "params": ring,
         "link": "uniform:1000:5000", "seed": 7, "budget": 25,
         "faults": "crash:3:5ms:20ms"},
        {"id": "gos-a", "scenario": "gossip", "params": gossip,
         "link": "quantize:1000:uniform:3000:9000", "seed": 2,
         "window": "auto", "budget": 100}])
    out = []
    for dev in (device, "cpu"):
        jd = tempfile.mkdtemp(prefix="sweep-", dir=_scratch())
        report = SweepService(pack, jd, chunk=16, inject="fail:2",
                              device=dev).run()
        out.append((report, [{k: v for k, v in e.items() if k != "wall_s"}
                             for e in SweepJournal(jd).records()]))
        shutil.rmtree(jd, ignore_errors=True)
    (ra, ja), (rb, jb) = out
    _require_all("sweep card vs CPU", {
        "report.ok": ra.ok and rb.ok, "report.done equal": ra.done == rb.done,
        "journal equal, record for record": ja == jb})
    say(f"sweep card vs CPU: {len(pack.configs)} worlds, {len(ja)} journal "
        f"records equal, supersteps "
        f"{[r['supersteps'] for r in ra.done.values()]}")


def phase_sweep_cost(device, pack, wall, util, chunk=64, steps=16,
                     warm=64):
    """What the service costs on the chaos pack's bucket: the wall of
    phase 43's service run with ``inject="fail:2"`` (``wall``; its one
    retry costs a checkpoint reload and a 50 ms backoff) beside the wall
    of the bare ``TorchEngine(batch=...).run_quiet`` of the same worlds
    and budgets, and the bucket's chunk time (``util``, its
    ``bucket_util`` record: ``wall_s`` is the time inside ``run``); the
    rest is journal fsyncs, checkpoint writes, digests and the executor
    hop, so one checkpoint write's and one state digest's time are
    printed beside them. Printed, not gated. Then the device's idle share
    under ``torch.profiler`` for ``steps`` of the bucket's chunked
    supersteps (its traced ``run``)."""
    import os

    from timewarp_tpu_torch.integrity.digest import host_digests
    from timewarp_tpu_torch.sweep import plan_buckets
    from timewarp_tpu_torch.sweep.bucket import build_bucket_engine
    from timewarp_tpu_torch.utils.checkpoint import save_state
    bucket = plan_buckets(pack.configs, len(pack.configs))[0]
    eng = build_bucket_engine(bucket, device=device)
    fin, bare = _timed(lambda: eng.run_quiet(bucket.budgets))
    iters = eng.last_run_stats["fleet_supersteps"]
    # one checkpoint write and one state digest of the bucket's state, as
    # the runner makes them after every chunk
    path = os.path.join(_scratch(), "cost.npz")
    _, ckpt = _timed(lambda: save_state(path, fin, meta={"k": 1},
                                        scenario=eng.scenario))
    size = os.path.getsize(path)
    os.unlink(path)
    _, digest = _timed(lambda: host_digests(fin, eng.batch,
                                            eng.scenario.u32_states))
    say(f"sweep cost: chaos pack bucket B={bucket.B} chunk={chunk} "
        f"service_wall_s={wall} bucket_chunk_wall_s={util['wall_s']} "
        f"bare_run_quiet_wall_s={bare} service_over_bare_s={wall - bare} "
        f"service_over_bare_frac={(wall - bare) / bare} chunks="
        f"{util['chunks']} fleet_supersteps={iters} "
        f"checkpoint_write_s={ckpt} checkpoint_bytes={size} "
        f"state_digest_s={digest}")
    phase_where_time_goes(f"the chaos pack bucket's chunked supersteps "
                          f"(TorchEngine B={bucket.B}, traced run)", eng,
                          warm, steps, run=lambda k, s: eng.run(k, s)[0])


# -- adversarial chaos search on the torch engines ---------------------------

#: ``bench.py`` ``bench_search_gossip``'s campaign through the reference on
#: the CPU (``CampaignResult.to_json()`` without ``repro_path``); the tests'
#: ``tests/test_torch_search.py`` constants, re-derived there from the
#: reference by the ``slow`` case
SEARCH_REF = {
    "found": True, "counterexample": "partition:0-3|4-63:0:10248",
    "minimized": "partition:0-3|4-63:1000:1001", "generations": 2,
    "evaluations": 28,
    "fork": {"forks": 1, "fork_worlds": 2, "prefix_supersteps": 23,
             "suffix_supersteps": 47, "full_supersteps": 93,
             "confirmations": 0, "saving_frac": 0.2473}}
#: the chaos worlds' longest link delay: ``quantize:1000`` over
#: ``uniform:500:4500`` rounds up to at most 5000 µs
CHAOS_MAX_DELAY_US = 5_000
#: phase 48's minimization trials: each is a from-scratch run of one
#: 100 000-node world (about 300 supersteps), together most of the phase;
#: 2, not 16, keeps chip_smoke inside its 1200 s on the slowest hosts seen
#: (with 1 the minimizer kept the counterexample as found; with 2 it
#: shrank it)
CHAOS_MINIMIZE_TRIALS = 2
#: the modules whose ``build_bucket_engine`` the search's fleets come from
SEARCH_BUILDERS = ["timewarp_tpu_torch.sweep.bucket",
                   "timewarp_tpu_torch.search.fork"]


def _journal_records(jd):
    from timewarp_tpu_torch.sweep import SweepJournal
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in SweepJournal(jd).records()]


def _search_leg(device, launches, jd, **kw):
    """One ``ChaosSearch`` on ``device`` journaling into ``jd``, every
    fleet it builds recorded and the launch counts reset just before it
    and added to ``launches`` just after. Returns ``(result, wall,
    recorder)``."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.search import ChaosSearch
    search = ChaosSearch(journal_dir=jd, device=device, **kw)
    with BucketRecorder(SEARCH_BUILDERS) as rec:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        ci.reset_launches()
        try:
            result, wall = _timed(search.run)
        finally:
            for k in launches:
                launches[k] += ci.LAUNCHES[k]
    return result, wall, rec


def _rejudge(what, device, repro):
    """The repro re-fails its objective solo on ``device`` (its one fleet
    recorded: K2 = K1 = its supersteps)."""
    from timewarp_tpu_torch.search.objectives import rejudge_repro
    with BucketRecorder(SEARCH_BUILDERS) as rec:
        obj, violated, score = rejudge_repro(repro, device=device)
    _require_all(what, {f"the repro re-fails {obj.name} solo": violated})
    _once_per_superstep(what, rec.calls)
    return obj


def phase_search_gossip(device):
    """``bench.py`` ``search_gossip`` on the card at the bench's size (64
    nodes, budget 300, ``eventually-delivered``, population 8, 6
    generations, seed 2, ``fork_k`` 2, the default ``minimize_trials``, a
    journal dir): the bench's three gates (found, ``saving_frac > 0``, the
    minimized repro re-failing solo on the card); the result equal to the
    reference's (:data:`SEARCH_REF`); K2 = K1 = its fleet supersteps in
    every bucket ``run`` call; then the same campaign through the port on
    the CPU (its CPU leg ``search_cpu``): equal generation history,
    ``repro.json`` bytes and journal records (without ``ts``). Returns the
    launches and the card's journal dir (kept for phase 48's ledger)."""
    import os
    import tempfile

    kw = dict(base=search_base(), objective="eventually-delivered",
              population=8, generations=6, seed=2, fork_k=2)
    launches = {"fire_compact": 0, "mailbox_insert": 0}
    jd = tempfile.mkdtemp(prefix="search-", dir=_scratch())
    os.rmdir(jd)
    res, wall, rec = _search_leg(device, launches, jd, **kw)
    got = {k: v for k, v in res.to_json().items() if k != "repro_path"}
    _require_all("search_gossip", {
        "found": res.found, "saving_frac > 0": res.fork["saving_frac"] > 0,
        f"result {got} = the reference's": got == SEARCH_REF})
    _once_per_superstep("search_gossip", rec.calls)
    _rejudge("search_gossip", device, res.repro)
    evals = (res.evaluations + res.fork["fork_worlds"]
             + res.fork["confirmations"] + 1)
    say(f"search_gossip: n=64 budget=300 result={got} wall_s={wall} "
        f"world_evaluations={evals} world_evaluations_per_s={evals / wall} "
        f"(bench.py's count) run_calls={len(rec.calls)} fleet_supersteps="
        f"{sum(c['iters'] for c in rec.calls)} launches={launches}; = the "
        "reference's result")
    card = dict(generations=res.generations,
                repro=open(os.path.join(jd, "repro.json"), "rb").read(),
                records=_journal_records(jd))

    def check(card, cpu):
        _require_all("search_gossip card vs CPU", {
            "generation history equal":
                card["generations"] == cpu["generations"],
            "repro.json bytes equal": card["repro"] == cpu["repro"],
            "journal records equal": card["records"] == cpu["records"]})
        say(f"search_gossip card vs CPU: cpu_wall_s={cpu['wall']}; equal "
            "history, repro.json and journal")
    against_cpu("search_cpu", card, check)
    return launches, jd


@cpu_leg("search_cpu")
def leg_search_cpu(dev):
    """Phase 46's CPU campaign: ``bench.py`` ``search_gossip`` through the
    port on ``dev`` (the CPU, in the CPU legs' process): its generation
    history, ``repro.json`` bytes, journal records and wall."""
    import os
    import tempfile

    import torch
    kw = dict(base=search_base(), objective="eventually-delivered",
              population=8, generations=6, seed=2, fork_k=2)
    jd = tempfile.mkdtemp(prefix="search-cpu-", dir=_scratch())
    os.rmdir(jd)
    res, wall, _ = _search_leg(torch.device(dev),
                               {"fire_compact": 0, "mailbox_insert": 0},
                               jd, **kw)
    out = dict(generations=res.generations,
               repro=open(os.path.join(jd, "repro.json"), "rb").read(),
               records=_journal_records(jd), wall=wall)
    shutil.rmtree(jd, ignore_errors=True)
    return out


def _fork_world(cfg, fin, b, pre, suffix, host):
    """World ``b`` of a fork fleet's final state as the sweep's result
    record: the prefix trace's digest chain continued through the world's
    suffix trace."""
    from timewarp_tpu_torch.sweep.spec import (DIGEST_ZERO, chain_digest,
                                               world_result)
    return world_result(cfg, fin, b, chain_digest(chain_digest(
        DIGEST_ZERO, pre), suffix), len(pre) + len(suffix), host)


def phase_fork_law(device, n=CHAOS_N):
    """The fork law at full width: the chaos fleet's world 0
    (``chaos_pack``'s ``chaos-0``: 100 000 nodes, steady gossip, its own
    fault schedule, budget 1024). World 0 run uninterrupted as a one-world
    bucket with the search domain's ``fault_pad``; a second one-world
    bucket for half of its executed supersteps, ``save_state``d; a K=4
    fork fleet (``fork_bucket``, a wider pad) whose world 0's suffix is
    empty and whose worlds 1-3 add a crash, a degrade and a partition
    opening past ``t_fork + window``, admitted by ``load_fork_state`` and
    run by ``run_fork``. The crash opens one link delay later than the
    others (:data:`CHAOS_MAX_DELAY_US` past ``t_fork + window``): a crash
    drops the messages whose *deliver* time lands in its window when they
    are routed, so one opening sooner would also drop messages the
    snapshot already holds, and its world would differ from the
    from-scratch run — in the reference as in the port. Gates: world 0's
    digest chain and its ``time``, ``steps``, ``delivered``,
    ``overflow``, ``fault_dropped`` and ``short_delay`` equal the
    uninterrupted run's; worlds 1-3 each equal
    a from-scratch solo run of its whole schedule on the card
    (``solo_result``); ``0 < saving_frac < 1``; K2 = K1 = its fleet
    supersteps in every bucket ``run`` call. Then K2 and K1 on the fork
    fleet's busiest superstep, bit-equal to their plain versions, and
    their times there. Returns the launches, the kernels' errors and
    the times."""
    import os

    import torch
    from timewarp_tpu_torch.faults import (FaultSchedule, LinkWindow,
                                           NodeCrash, Partition)
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.search import (fork_bucket, load_fork_state,
                                           run_fork)
    from timewarp_tpu_torch.search.domain import candidate_config, domain_for
    from timewarp_tpu_torch.sweep import bucket as sb
    from timewarp_tpu_torch.sweep import solo_result
    from timewarp_tpu_torch.sweep.spec import (DIGEST_ZERO, chain_digest,
                                               resolve_window, result_leaves,
                                               world_result)
    from timewarp_tpu_torch.utils.checkpoint import save_state
    cfg = chaos_pack(n, 1).configs[0]
    dom, W = domain_for(cfg), resolve_window(cfg)
    launches = {"fire_compact": 0, "mailbox_insert": 0}
    with BucketRecorder(SEARCH_BUILDERS) as rec:
        torch.cuda.synchronize()
        ci.reset_launches()
        # the builder looked up under the recorder, which wraps it
        u = sb.Bucket("u", (cfg,), W, fault_pad=dom.table_pad)
        eng_u = sb.build_bucket_engine(u, device=device)
        fin_u, tr_u = eng_u.run_stream(u.budgets, chunk=64)
        executed = int(fin_u.steps[0])
        half = executed // 2
        eng_p = sb.build_bucket_engine(sb.Bucket("p", (cfg,), W,
                                                 fault_pad=dom.table_pad),
                                       device=device)
        st, tr_pre = eng_p.run(np.asarray([half], np.int64),
                               state=eng_p.init_state())
        ckpt = os.path.join(_scratch(), "fork-law.npz")
        save_state(ckpt, st, meta={"fork": "chaos-0"},
                   scenario=eng_p.scenario)
        t_fork = int(st.time[0])
        base = cfg.parse_faults()
        t0 = t_fork + W
        q = n // 4
        tc = t0 + CHAOS_MAX_DELAY_US
        suffixes = [
            (),
            (NodeCrash(17, tc, tc + 40_000, reset_state=True),),
            (LinkWindow(None, None, t0 + 2_000, t0 + 60_000, 3.0),),
            (Partition((tuple(range(q)), tuple(range(q, n))), t0 + 1_000,
                       t0 + 50_000),)]
        scheds = [FaultSchedule(tuple(base.events) + s) for s in suffixes]
        pad = tuple(p + 1 for p in dom.table_pad)
        feng, _ = fork_bucket(cfg, scheds, t_fork, fault_pad=pad,
                              device=device)
        state, t_fork2, _ = load_fork_state(feng, ckpt, 0)
        fr, fork_wall = _timed(lambda: run_fork(feng, state, cfg.budget,
                                                chunk=64))
        os.unlink(ckpt)
        for k in launches:
            launches[k] += ci.LAUNCHES[k]
    _once_per_superstep("fork law", rec.calls)
    host_u, host_f = result_leaves(fin_u), result_leaves(fr.final)
    want0 = world_result(cfg, fin_u, 0, chain_digest(DIGEST_ZERO, tr_u[0]),
                         len(tr_u[0]), host_u)
    got = [_fork_world(candidate_config(cfg, s, cfg.run_id if b == 0
                                        else f"fork{b}"),
                       fr.final, b, tr_pre[0], fr.traces[b], host_f)
           for b, s in enumerate(scheds)]
    solo = {b: solo_result(candidate_config(cfg, scheds[b], f"fork{b}"),
                           device=device) for b in (1, 2, 3)}
    _require_all("fork law at 100 000 nodes", {
        "t_fork read back": t_fork2 == t_fork,
        "prefix = half the executed supersteps":
            fr.prefix_supersteps == half,
        "world 0 = the uninterrupted run (digest chain, time, steps, "
        "delivered, overflow, fault_dropped, short_delay)": got[0] == want0,
        **{f"world {b} = its solo run": got[b] == solo[b] for b in solo},
        "the suffixes bite": len({g["trace_digest"] for g in got}) == 4,
        f"0 < saving_frac {fr.saving_frac} < 1": 0 < fr.saving_frac < 1})
    # K2 and K1 on the fork fleet's busiest superstep: the call that sent
    # the most, re-driven from its start state
    busy = max((c for c in rec.calls if c["bucket"] == "fork"),
               key=lambda c: c["sent"])
    a2, a1 = _stage_args(busy["eng"], lambda: busy["run"](busy["budgets"],
                                                          busy["state"]))
    err2 = _equal("K2 fork fleet", ci.fire_compact(*a2),
                  ci.fire_compact_plain(*a2))
    err1 = _equal("K1 fork fleet", ci.mailbox_insert(*a1),
                  ci.mailbox_insert_plain(*a1))
    torch.cuda.synchronize()
    r2, r1 = _time_stage_args("the fork fleet's busiest superstep", a2, a1)
    say(f"fork law: n={n} executed={executed} t_fork_us={t_fork} "
        f"prefix={fr.prefix_supersteps} suffix={fr.suffix_supersteps} "
        f"quiesced={fr.quiesced} saving_frac={fr.saving_frac} "
        f"fork_wall_s={fork_wall} run_calls={len(rec.calls)} "
        f"launches={launches}; world 0 = the uninterrupted run, worlds "
        f"1-3 = their solo runs (supersteps "
        f"{[solo[b]['supersteps'] for b in solo]})")
    return launches, (err2, err1), (r2, r1)


def phase_search_chaos(device, keep, n=CHAOS_N):
    """A campaign at full width: ``ChaosSearch`` on the card with base
    ``chaos-0`` without its faults, objective ``convergence:LIMIT`` (LIMIT
    the base's own quiescence instant from a solo card run: the tightest
    limit the fault-free world does not violate), population 8, 3
    generations, ``fork_k`` 2, ``minimize_trials``
    :data:`CHAOS_MINIMIZE_TRIALS`, a journal dir.
    Gates: the campaign completes; K2 = K1 = its fleet supersteps in every
    bucket ``run`` call; a counterexample, if found, re-fails solo on the
    card. Then the ledger: phase 46's and this campaign's journals and
    phase 42's predicted-packing leg (``keep``) ingested into the port's
    ``RunLedger``: the ``search`` records carry ``found``, ``minimized``
    and the ``search|gossip|`` key prefix; ``fit_from_ledger`` equals
    ``fit_rows`` over the sweep's ``training_rows``; the ``SweepWatch``
    snapshot equals ``status_fields``. Returns the launches."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from timewarp_tpu_torch.obs.ledger import RunLedger
    from timewarp_tpu_torch.obs.watch import SweepWatch
    from timewarp_tpu_torch.pack.predict import (fit_from_ledger, fit_rows,
                                                 training_rows)
    from timewarp_tpu_torch.sweep import SweepJournal, SweepPack, solo_result
    from timewarp_tpu_torch.sweep.journal import status_fields
    base = dataclasses.replace(chaos_pack(n, 1).configs[0],
                               run_id="chaos-base", faults=None)
    want, trace = solo_result(base, device=device, with_trace=True)
    limit = int(trace.times[-1])
    _require_all("chaos search base", {
        "the fault-free base quiesces in its budget":
            want["supersteps"] < base.budget})
    launches = {"fire_compact": 0, "mailbox_insert": 0}
    jd = tempfile.mkdtemp(prefix="search-chaos-", dir=_scratch())
    os.rmdir(jd)
    res, wall, rec = _search_leg(
        device, launches, jd, base=base, objective=f"convergence:{limit}",
        population=8, generations=3, seed=0, fork_k=2,
        minimize_trials=CHAOS_MINIMIZE_TRIALS)
    _once_per_superstep("chaos search", rec.calls)
    if res.found:
        _rejudge("chaos search", device, res.repro)
    found_gen = res.repro["found_gen"] if res.found else None
    say(f"chaos search: n={n} base supersteps={want['supersteps']} "
        f"LIMIT={limit} us (the base's quiescence instant) found="
        f"{res.found} found_gen={found_gen} counterexample="
        f"{res.counterexample} minimized={res.minimized} generations="
        f"{res.generations} evaluations={res.evaluations} fork={res.fork} "
        f"wall_s={wall} run_calls={len(rec.calls)} fleet_supersteps="
        f"{sum(c['iters'] for c in rec.calls)} launches={launches}")

    search_jd, sweep_jd, pack = keep
    led = RunLedger(tempfile.mkdtemp(prefix="ledger-", dir=_scratch()))
    recs = [led.get(led.add_source(d)[0]) for d in (search_jd, jd, sweep_jd)]
    scan = SweepJournal(sweep_jd).scan()
    snap = SweepWatch(sweep_jd).poll()
    rows = training_rows(pack.configs, scan.done)
    art = fit_from_ledger(led.root)
    _require_all("ledger over the journals", {
        "kinds": [r["kind"] for r in recs] == ["search", "search", "sweep"],
        "search keys": all(r["config_key"].startswith("search|gossip|")
                           for r in recs[:2]),
        "phase 46 found, minimized": recs[0]["search"]["found"] is True
        and recs[0]["search"]["minimized"] == SEARCH_REF["minimized"],
        "phase 48 found, minimized":
            recs[1]["search"]["found"] is res.found
            and recs[1]["search"]["minimized"] == res.minimized,
        "fit_from_ledger = fit_rows(training_rows)": art == fit_rows(rows),
        "SweepWatch = status_fields":
            {k: v for k, v in snap.items() if k != "watch"}
            == status_fields(scan, len(SweepPack.load(
                os.path.join(sweep_jd, "pack.json")).configs))})
    say(f"ledger: {len(led.index())} runs {[r['config_key'] for r in recs]}"
        f"; fit_from_ledger rows={art['rows']} sha={art['sha'][:12]} = "
        f"fit_rows; sweep watch = status (events {snap['events']})")
    for d in (jd, search_jd, sweep_jd, led.root):
        shutil.rmtree(d, ignore_errors=True)
    return launches


# -- the serving layer and the network stack ---------------------------------

#: ``bench.py`` ``bench_serve_gossip``'s size at chip_smoke's budgets: the
#: bench's 2000/1000 supersteps cut to 128/64 for chip_smoke's time limit:
#: its gossip at 4096 nodes is host-bound in the legs and the solo runs,
#: about 20 ms a fleet superstep (NVIDIA H100 80GB HBM3, 700.00 W)
SERVE_N, SERVE_STEPS = 4096, 128


def _in_thread(fn, **kw):
    """``fn(**kw)`` on a thread of its own; returns ``(thread, box)``, the
    box holding ``fn``'s result or exception once the thread ends."""
    import threading
    box = {}

    def target():
        try:
            box["out"] = fn(**kw)
        except BaseException as e:  # noqa: BLE001 — handed to the caller
            box["err"] = e
    th = threading.Thread(target=target, daemon=True)
    th.start()
    return th, box


def _join(what, th, box, timeout=600):
    th.join(timeout=timeout)
    _require_all(what, {"the thread ended in its time": not th.is_alive()})
    return box


def _await_bucket_start(root, th, timeout=300):
    """Wait until the journal in ``root`` holds a ``bucket_start``: the
    curator on thread ``th`` has built its open bucket's engine and runs
    the first chunk, so what is admitted from here on lands mid-bucket."""
    from timewarp_tpu_torch.sweep import SweepJournal
    t_end = time.monotonic() + timeout
    while th.is_alive() and time.monotonic() < t_end:
        if any(e.get("ev") == "bucket_start"
               for e in SweepJournal(root).records()):
            return
        time.sleep(0.005)
    raise AssertionError("the curator never started its bucket")


def _admitted_mid_bucket(rec, slots):
    """Each of ``slots`` idle (budget 0) in the recorder's first ``run``
    call and live in every slot in a later call on the same engine: the
    configs there were admitted by a rebind while the bucket ran."""
    calls = rec.calls
    return (len(rec.built) == 1 and bool(calls)
            and all(c["eng"] is rec.built[0] for c in calls)
            and all(int(calls[0]["budgets"][s]) == 0 for s in slots)
            and any(all(int(c["budgets"][s]) > 0 for s in slots)
                    for c in calls[1:]))


def _admit_latencies(scan):
    """Per world, submit -> ``world_done`` seconds from the journal's own
    ``ts`` stamps (one clock), and the first admit's and the last
    ``world_done``'s stamps."""
    t_admit, t_done = {}, {}
    for e in scan.events:
        if e.get("ev") == "admit" and e["run_id"] not in t_admit:
            t_admit[e["run_id"]] = float(e["ts"])
        elif e.get("ev") == "world_done":
            t_done[e["result"]["run_id"]] = float(e["ts"])
    lats = sorted(t_done[r] - t_admit[r] for r in t_done)
    return lats, min(t_admit.values()), max(t_done.values())


def _serve_leg(device, cfgs, launches, pack_mode, artifact, chunk):
    """One served leg: a ``ServeFrontend``'s admission book on a fresh
    journal dir under ``build/``, a ``ServeCurator`` thread on ``device``,
    half the configs admitted before the thread starts and half once its
    bucket has started (while the first chunk runs), then a drain; every
    open bucket recorded, the launch counts reset just before and added to
    ``launches`` just after. Returns ``(scan, recorder, wall, admission
    seconds, journal dir, the late half's slots)``."""
    import tempfile

    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.serve.curator import ServeCurator
    from timewarp_tpu_torch.serve.frontend import ServeFrontend
    from timewarp_tpu_torch.sweep import SweepJournal
    root = tempfile.mkdtemp(prefix="serve-", dir=_scratch())
    journal = SweepJournal(root, host="bench")
    front = ServeFrontend(journal, "bench", ("127.0.0.1", 0), slots=8,
                          pack_mode=pack_mode, pack_artifact=artifact)
    cur = ServeCurator(root, "bench", chunk=chunk, lease_ttl_s=60.0,
                       poll_s=0.02, journal=journal, pack_mode=pack_mode,
                       pack_artifact=artifact, device=device)
    with BucketRecorder() as rec:
        torch.cuda.synchronize()
        ci.reset_launches()
        try:
            t0 = time.perf_counter()
            for d in cfgs[:4]:
                front.admit(d)
            t_half = time.perf_counter()
            th, box = _in_thread(cur.run, max_seconds=600)
            _await_bucket_start(root, th)
            t1 = time.perf_counter()
            late = [front.admit(d)[2] for d in cfgs[4:]]
            t_admit = (t_half - t0) + (time.perf_counter() - t1)
            journal.append({"ev": "serve_drain", "host": "bench"})
            _join(f"serve {pack_mode}", th, box)
            wall = time.perf_counter() - t0
        finally:
            for k in launches:
                launches[k] += ci.LAUNCHES[k]
    journal.close()
    _require_all(f"serve {pack_mode}", {
        "the curator drained without an error": "err" not in box})
    return SweepJournal(root).scan(), rec, wall, t_admit, root, late


@cpu_leg("serve_solos")
def leg_serve_solos(dev, n=SERVE_N, steps=SERVE_STEPS):
    """Phase 49's solo twins: ``solo_result`` of every config of
    :func:`serve_gossip_configs` on ``dev`` (the CPU, in the CPU legs'
    process)."""
    from timewarp_tpu_torch.sweep.spec import RunConfig, solo_result
    return {c.run_id: solo_result(c, device=dev)
            for c in (RunConfig.from_json(d, 0)
                      for d in serve_gossip_configs(n, steps))}


def phase_serve_gossip(device, n=SERVE_N, steps=SERVE_STEPS):
    """``bench.py`` ``serve_gossip`` on the card (:func:`serve_gossip_configs`,
    chunk ``max(32, steps // 8)`` as the bench's): one 8-slot open bucket
    fed by a ``ServeFrontend`` and drained by a ``ServeCurator`` thread,
    half the configs admitted before it starts and half while it runs the
    first chunk; two legs, ``first-fit`` and then ``predicted`` with an
    artifact fitted from the first leg's own results (``training_rows`` ->
    ``fit_rows``). Gates on both legs: every config served, each
    ``world_done`` equal to its solo run on the CPU
    (:func:`leg_serve_solos`), ``engine_builds`` 1
    in every journaled ``bucket_util`` and one engine built, the late
    half admitted mid-bucket by a rebind (:func:`_admitted_mid_bucket`)
    and the bucket's fleet supersteps past the largest budget, K1 once per
    fleet superstep of every bucket ``run`` call and K2 as often; in the
    predicted leg one ``pack_decision`` before each admit, naming the
    bucket it landed in, and none in the first-fit leg. Prints served
    configs/s (first admit to last ``world_done``), admissions/s and the
    p50/p95 submit-to-``world_done`` latency. Returns the launches and the
    solo results."""
    import shutil

    from timewarp_tpu_torch.pack import fit_rows, training_rows
    from timewarp_tpu_torch.sweep.journal import util_rollup
    from timewarp_tpu_torch.sweep.spec import RunConfig
    cfgs = serve_gossip_configs(n, steps)
    rcfgs = [RunConfig.from_json(d, 0) for d in cfgs]
    want = LEGS.get("serve_solos") \
        if LEGS is not None and (n, steps) == (SERVE_N, SERVE_STEPS) \
        else leg_serve_solos("cpu", n, steps)
    launches = {"fire_compact": 0, "mailbox_insert": 0}
    chunk = max(32, steps // 8)
    artifact = None
    for mode in ("first-fit", "predicted"):
        scan, rec, wall, t_admit, root, late = _serve_leg(
            device, cfgs, launches, mode, artifact, chunk)
        shutil.rmtree(root, ignore_errors=True)
        _survival(f"serve {mode}", scan.done, want)
        builds = {b: u.get("engine_builds") for b, u in scan.util.items()}
        ran = sum(c["iters"] for c in rec.calls)
        checks = {
            "every config served": sorted(scan.done) == sorted(want),
            "engine_builds 1 in every bucket_util":
                bool(builds) and set(builds.values()) == {1},
            "one engine built per bucket": len(rec.built) == len(builds),
            "the late half admitted mid-bucket on the same engine":
                _admitted_mid_bucket(rec, late),
            "the bucket ran past the largest budget":
                ran > max(c.budget for c in rcfgs)}
        places = [e for e in scan.pack_decisions if e.get("kind") == "place"]
        if mode == "predicted":
            admits = {e["run_id"]: (i, e["bucket"])
                      for i, e in enumerate(scan.events)
                      if e.get("ev") == "admit"}
            pidx = {e["run_id"]: i for i, e in enumerate(scan.events)
                    if e.get("ev") == "pack_decision"
                    and e.get("kind") == "place"}
            checks.update({
                "one pack_decision per admission":
                    sorted(p["run_id"] for p in places) == sorted(want),
                "each decision before its admit, naming its bucket": all(
                    pidx[p["run_id"]] < admits[p["run_id"]][0]
                    and p["bucket"] == admits[p["run_id"]][1]
                    for p in places)})
        else:
            checks["no pack_decision for first-fit"] = not places
        _require_all(f"serve {mode}", checks)
        rec.check(f"serve {mode}")
        lats, first, last = _admit_latencies(scan)
        say(f"serve_gossip {mode}: n={n} budgets={steps}/{steps // 2} "
            f"(the bench's 2000/1000 cut for chip_smoke's time limit) "
            f"chunk={chunk} "
            f"wall_s={wall} served_configs_per_s={len(cfgs) / (last - first)} "
            f"admit_per_s={len(cfgs) / t_admit} p50_submit_to_done_s="
            f"{lats[len(lats) // 2]} p95_submit_to_done_s="
            f"{lats[min(len(lats) - 1, int(len(lats) * 0.95))]} "
            f"engine_builds={builds} rollup={util_rollup(scan.util)} "
            f"pack_decisions={len(places)} buckets={rec.per_bucket()}")
        if mode == "first-fit":
            rows = training_rows(rcfgs, scan.done)
            _require_all("serve training rows", {
                "one row per world": len(rows) == len(cfgs)})
            artifact = fit_rows(rows)
    say(f"serve_gossip: every world_done = its solo run on the CPU "
        f"(supersteps {[w['supersteps'] for w in want.values()]}); "
        f"launches={launches}")
    return launches, want


def _expected_builds(batches):
    """An open bucket's engine builds under the rebuild rule of
    ``serve/worker.py`` ``_rebuild`` (the reference's): one for the first
    batch of admissions, and one more for each later batch that grows the
    fault pad (crash, partition, link-window rows) or changes the fault
    fleet's static gates (a first faulted world, skew, reset, restarts),
    counted from the configs' schedules."""
    from timewarp_tpu_torch.faults.schedule import FaultFleet, FaultSchedule
    from timewarp_tpu_torch.sweep.spec import RunConfig
    members, builds, realized, gates0 = [], 0, None, None
    for batch in batches:
        members += [RunConfig.from_json(d, 0).parse_faults()
                    or FaultSchedule(()) for d in batch]
        pad = tuple(max(len(getattr(s, f)) for s in members)
                    for f in ("crashes", "partitions", "link_windows"))
        fleet = FaultFleet(tuple(members))
        gates = (any(s.events for s in members), fleet.has_skew,
                 fleet.has_reset, fleet.n_restarts)
        if realized is None or gates != gates0 \
                or any(p > q for p, q in zip(pad, realized)):
            builds += 1
        realized = pad if realized is None else tuple(
            max(p, q) for p, q in zip(pad, realized))
        gates0 = gates
    return builds


def phase_served_chaos(device, want, pack_wall, n=CHAOS_N, B=CHAOS_B,
                       chunk=64, ttl_s=3.0, budget=CHAOS_PACK_BUDGET):
    """Phase 43's chaos pack (``budget`` supersteps a world) served: a
    ``ServeFrontend`` on host ``a``
    admits four worlds into one 8-slot open bucket (``chunk`` 64); curator
    ``a`` runs on the card with ``die_after_chunks=3`` and a ``ttl_s``
    lease, and once its bucket has started (the first chunk running) the
    other four worlds are admitted into the bucket's reserved slots; ``a``
    admits them by a rebind after that chunk, runs its second chunk with
    all eight and dies with its lease unreleased; after the TTL curator
    ``b`` steals the bucket and drains it from the checkpoint. Gates: every
    streamed result equal to ``want`` (phase 43's solo runs, which equal
    phase 27's fleet rows); each run_id journaled once; ``a``'s two run
    calls, the late four idle in the first and live in the second
    (:func:`_admitted_mid_bucket`); the kill mid-bucket, every world
    stepped in the checkpoint it left and none yet done; the steal
    journaled (``lease_acquire`` by ``b`` with
    ``stolen_from: "a"``); each incarnation's engine builds as
    :func:`_expected_builds` counts them; K1 = K2 = the fleet supersteps of
    every bucket ``run`` call; K2 and K1 bit-equal to their plain versions
    on the busiest superstep of ``b``'s calls (every world active). Prints
    the wall, the checkpoint writes and the wall over phase 43's main leg
    (``pack_wall``). Returns the launches and the kernels' errors."""
    import shutil
    import tempfile

    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.serve.curator import CuratorKilled, ServeCurator
    from timewarp_tpu_torch.serve.frontend import ServeFrontend
    from timewarp_tpu_torch.serve.worker import checkpoint_meta
    from timewarp_tpu_torch.sweep import SweepJournal
    cfgs = [c.to_json() for c in chaos_pack(n, B, budget).configs]
    root = tempfile.mkdtemp(prefix="served-chaos-", dir=_scratch())
    launches = {"fire_compact": 0, "mailbox_insert": 0}
    ja = SweepJournal(root, host="a")
    front = ServeFrontend(ja, "a", ("127.0.0.1", 0), slots=B)
    cur_a = ServeCurator(root, "a", chunk=chunk, lease_ttl_s=ttl_s,
                         poll_s=0.02, journal=ja, die_after_chunks=3,
                         device=device)
    t0 = time.perf_counter()
    with BucketRecorder() as rec_a:
        torch.cuda.synchronize()
        ci.reset_launches()
        try:
            placed = [front.admit(d) for d in cfgs[:B // 2]]
            th, box = _in_thread(cur_a.run, max_seconds=600)
            _await_bucket_start(root, th)
            late = [front.admit(d) for d in cfgs[B // 2:]]
            ja.append({"ev": "serve_drain", "host": "a"})
            _join("served chaos, host a", th, box)
        finally:
            for k in launches:
                launches[k] += ci.LAUNCHES[k]
    ja.close()
    mid = SweepJournal(root).scan()
    at_kill = checkpoint_meta(ja.checkpoint_path(placed[0][1]))
    time.sleep(ttl_s + 0.5)                 # a's lease goes stale
    cur_b = ServeCurator(root, "b", chunk=chunk, lease_ttl_s=ttl_s,
                         poll_s=0.02, device=device)
    with BucketRecorder() as rec_b:
        torch.cuda.synchronize()
        ci.reset_launches()
        try:
            cur_b.run(max_seconds=600)
        finally:
            for k in launches:
                launches[k] += ci.LAUNCHES[k]
    wall = time.perf_counter() - t0
    scan = SweepJournal(root).scan()
    ids = [e["result"]["run_id"] for e in scan.events
           if e.get("ev") == "world_done"]
    steals = [e for e in scan.events if e.get("ev") == "lease_acquire"
              and e.get("stolen_from")]
    bids = {b for _, b, _ in placed + late}
    _require_all("served chaos pack", {
        "host a killed (CuratorKilled)":
            isinstance(box.get("err"), CuratorKilled),
        "one open bucket of 8 slots": bids == {placed[0][1]}
        and sorted(s for _, _, s in placed + late) == list(range(B)),
        "host a ran two chunks, the late four admitted mid-bucket by a "
        "rebind and live in the second": len(rec_a.calls) == 2
        and _admitted_mid_bucket(rec_a, [s for _, _, s in late]),
        "the kill landed mid-bucket, every world stepped and none done":
            not mid.done and at_kill is not None
            and all(int(x) > 0 for x in at_kill["supersteps"]),
        "every world served": sorted(scan.done) == sorted(want),
        "each run_id journaled once": sorted(ids) == sorted(want),
        "the steal journaled": len(steals) == 1
        and steals[0]["host"] == "b" and steals[0]["stolen_from"] == "a",
        "host b stole one bucket": cur_b.stolen == 1,
        "host a's engine builds = the rule's":
            len(rec_a.built) == _expected_builds([cfgs[:B // 2],
                                                  cfgs[B // 2:]]),
        "host b's engine builds = the rule's":
            len(rec_b.built) == _expected_builds([cfgs])})
    _survival("served chaos pack", scan.done, want)
    rec_a.check("served chaos pack, host a")
    rec_b.check("served chaos pack, host b")
    busy = max(rec_b.calls, key=lambda c: c["sent"])
    eng, run = rec_b.engines[busy["bucket"]]
    a2, a1 = _stage_args(eng, lambda: run(busy["budgets"], busy["state"]))
    err2 = _equal("K2 served chaos bucket", ci.fire_compact(*a2),
                  ci.fire_compact_plain(*a2))
    err1 = _equal("K1 served chaos bucket", ci.mailbox_insert(*a1),
                  ci.mailbox_insert_plain(*a1))
    torch.cuda.synchronize()
    ckpts = len(rec_a.calls) + len(rec_b.calls)
    shutil.rmtree(root, ignore_errors=True)
    say(f"served chaos pack: B={B} n={n} chunk={chunk} lease_ttl_s={ttl_s} "
        f"wall_s={wall} (the TTL wait included) phase43_main_leg_wall_s="
        f"{pack_wall} wall_over_phase43={wall / pack_wall} "
        f"checkpoint_writes={ckpts} supersteps_at_kill="
        f"{at_kill['supersteps']} "
        f"host_a={rec_a.per_bucket()} host_b={rec_b.per_bucket()} "
        f"engine_builds a={len(rec_a.built)} b={len(rec_b.built)} "
        f"steal={steals[0]} launches={launches}; every streamed result = "
        "its solo run = its row of phase 27's fleet")
    return launches, (err2, err1)


def _multi_host_pack():
    """``tests/test_zzzzzzzzzserve.py``'s multi-host pack: 64-node token
    rings, one faulted, one on another link."""
    from timewarp_tpu_torch.sweep import SweepPack
    ring = {"nodes": 64, "n_tokens": 4, "think_us": 2000,
            "end_us": 1 << 40, "mailbox_cap": 8}

    def cfg(i, seed, budget, **kw):
        return {"id": f"w{i}", "scenario": "token-ring", "params": ring,
                "link": "uniform:1000:5000", "seed": seed,
                "budget": budget, **kw}
    return SweepPack.from_json([
        cfg(0, 0, 96), cfg(1, 1, 64, faults="crash:3:5ms:40ms:reset"),
        cfg(2, 2, 48, link="uniform:2000:7000")])


def _multi_host_sweep(device, root, launches=None):
    """Host ``a`` killed by ``inject="die:2"`` holding its lease, host ``b``
    stealing after the TTL; the journal's records with the wall-clock
    fields (``ts``, ``seq``, ``wall_s``) and the heartbeats left out, and
    the recorders of both hosts (on the card)."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.sweep import SweepJournal, SweepService
    from timewarp_tpu_torch.sweep.service import SweepKilled
    pack = _multi_host_pack()
    recs, killed = [], False
    for host, kw in (("a", {"inject": "die:2"}),
                     ("b", {"peer_poll_us": 100_000})):
        with BucketRecorder() as rec:
            if launches is not None:
                torch.cuda.synchronize()
                ci.reset_launches()
            try:
                SweepService(pack, root, chunk=16, host=host,
                             lease_ttl_s=0.4, device=device, **kw).run()
            except SweepKilled:
                killed = True
            finally:
                if launches is not None:
                    for k in launches:
                        launches[k] += ci.LAUNCHES[k]
        recs.append(rec)
        if host == "a":
            time.sleep(0.5)                 # a's lease goes stale
    records = [{k: v for k, v in e.items()
                if k not in ("ts", "seq", "wall_s")}
               for e in SweepJournal(root).records()
               if e.get("ev") != "host_heartbeat"]
    return pack, killed, records, SweepJournal(root).scan(), recs


def phase_serve_wire(device, want, n=SERVE_N, steps=SERVE_STEPS):
    """(a) ``test_serve_tcp_roundtrip_streams_bit_identical``'s path on
    the card: the port's ``Rpc(Dialog(Transport(AioBackend())))`` frontend
    over loopback TCP under the port's ``run_real_time``, a curator thread
    on the card; two of phase 49's configs submitted, awaited and drained;
    each streamed record equal to phase 49's solo run (``want``), its
    bucket's run calls K1 = K2 = their fleet supersteps. (b) the multi-host
    sweep: ``_multi_host_pack`` through ``SweepService(host="a",
    inject="die:2")`` and then ``host="b"`` on the card and on the CPU:
    the kill and one steal in each, the journals equal record for record,
    every result equal to its solo run on the card. Returns the card's
    launches."""
    import shutil
    import socket
    import tempfile

    import torch
    from timewarp_tpu_torch.core.effects import Program, fork_, timeout
    from timewarp_tpu_torch.core.errors import TimeoutExpired
    from timewarp_tpu_torch.interp.aio.timed import run_real_time
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.manage.sync import Flag
    from timewarp_tpu_torch.net.backend import AioBackend
    from timewarp_tpu_torch.net.dialog import Dialog
    from timewarp_tpu_torch.net.rpc import Rpc
    from timewarp_tpu_torch.net.transfer import Transport
    from timewarp_tpu_torch.serve.curator import ServeCurator
    from timewarp_tpu_torch.serve.frontend import (ServeAwait, ServeDrain,
                                                   ServeFrontend, ServeSubmit)
    from timewarp_tpu_torch.sweep import SweepJournal, solo_result
    launches = {"fire_compact": 0, "mailbox_insert": 0}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = tempfile.mkdtemp(prefix="serve-wire-", dir=_scratch())
    journal = SweepJournal(root, host="alpha")
    front = ServeFrontend(journal, "alpha", ("127.0.0.1", port), slots=2,
                          poll_us=50_000)
    cur = ServeCurator(root, "alpha", chunk=32, lease_ttl_s=30.0,
                       poll_s=0.05, journal=journal, device=device)
    server = Rpc(Dialog(Transport(AioBackend())))
    client = Rpc(Dialog(Transport(AioBackend())))
    addr = ("127.0.0.1", port)
    configs = serve_gossip_configs(n, steps)[:2]
    results = {}

    def call_retry(req) -> Program:
        for _ in range(40):
            try:
                return (yield from timeout(
                    5_000_000, lambda: client.call(addr, req)))
            except TimeoutExpired:
                continue
        raise AssertionError("service never answered")

    def main() -> Program:
        yield from fork_(lambda: front.program(server, max_seconds=300))
        flags = []
        for d in configs:
            ack = yield from call_retry(
                ServeSubmit(json.dumps(d, sort_keys=True)))
            assert ack.run_id == d["id"], ack
            flag = Flag()
            flags.append(flag)

            def mk(rid=ack.run_id, flag=flag):
                def prog() -> Program:
                    r = yield from call_retry(ServeAwait(rid))
                    results[rid] = json.loads(r.record_json)
                    yield from flag.set()
                return prog
            yield from fork_(mk())
        for flag in flags:
            yield from flag.wait()
        yield from call_retry(ServeDrain())
        yield from client.dialog.transport.close(addr)

    with BucketRecorder() as rec:
        torch.cuda.synchronize()
        ci.reset_launches()
        try:
            th, box = _in_thread(cur.run, max_seconds=300)
            _, wall = _timed(lambda: run_real_time(main))
            _join("serve over TCP, curator", th, box, timeout=120)
        finally:
            for k in launches:
                launches[k] += ci.LAUNCHES[k]
    journal.close()
    shutil.rmtree(root, ignore_errors=True)
    _require_all("serve over TCP", {
        "the curator drained without an error": "err" not in box,
        "both records streamed": sorted(results) == ["w0", "w1"]})
    _survival("serve over TCP", {r: results[r]["result"] for r in results},
              {d["id"]: want[d["id"]] for d in configs})
    rec.check("serve over TCP")
    say(f"serve over TCP: 2 configs of phase 49 submitted, streamed and "
        f"drained over loopback TCP in {wall} s; every streamed record = "
        f"its solo run; buckets={rec.per_bucket()}")

    out = []
    for dev, count in ((device, launches), ("cpu", None)):
        jd = tempfile.mkdtemp(prefix="multi-host-", dir=_scratch())
        out.append(_multi_host_sweep(dev, jd, count))
        shutil.rmtree(jd, ignore_errors=True)
    (pack, ka, ra, sa, recs), (_, kb, rb, _, _) = out
    solo = {c.run_id: solo_result(c, device=device) for c in pack.configs}
    steals = [e for e in sa.events if e.get("ev") == "lease_acquire"
              and e.get("stolen_from")]
    _require_all("multi-host sweep", {
        "host a killed in both runs": ka and kb,
        "one steal, by b from a": len(steals) == 1
        and steals[0]["host"] == "b" and steals[0]["stolen_from"] == "a",
        "every world journaled once": sorted(
            e["result"]["run_id"] for e in sa.events
            if e.get("ev") == "world_done") == sorted(solo),
        "card journal = CPU journal, record for record": ra == rb})
    _survival("multi-host sweep", sa.done, solo)
    for host, r in zip("ab", recs):
        r.check(f"multi-host sweep, host {host}")
    say(f"multi-host sweep: 3 worlds, host a killed by die:2, host b stole "
        f"{steals[0]['bucket']}; {len(ra)} journal records equal on the card "
        f"and the CPU (ts, seq, wall_s and heartbeats aside); every result = "
        f"its solo run; launches={launches}")
    return launches


# -- multi-device: the sharded engines on torch.distributed ---------------

SHARD_D = 2              # gloo ranks sharing the card
SHARD_STEPS = 64         # supersteps of phases 52 and 53
K1P_REPLACES = "timewarp_tpu/interp/jax_engine/sharded.py:347"
#: phase 52's verified legs: 32 supersteps in chunks of 8, each mode with
#: a flip whose element lies on rank 1
SHARD_VERIFY = (("digest", "flip:2:2:mb_rel"), ("shadow", "flip:3:2:wake"))
SHARD_VERIFY_STEPS, SHARD_VERIFY_CHUNK = 32, 8
#: phase 54's verified and streamed legs: the chaos fleet for 128 fleet
#: supersteps in chunks of 32 (a flip on a world of rank 1), then
#: run_stream under per-world budgets (world b: 64 + 8b)
FLEET_VERIFY_FLIP, FLEET_VERIFY_STEPS, FLEET_CHUNK = "flip:2:2:mb_rel", 128, 32
FLEET_STREAM_BUDGETS = tuple(64 + 8 * b for b in range(CHAOS_B))
#: the checkpoint leg: phase 60's wave at 2^17 as the CLI expresses it,
#: without K2's batch cap (a knob of the general engine alone), saved by
#: the ranks after CK_STEPS supersteps
CK_STEPS = 48


def _comm_timers(comm):
    """Wrap ``comm``'s collectives in timers (the device drained before
    and after each, NCCL's stream included, so a collective's time is its
    own: with gloo, the copies to the host and back and the transport;
    with NCCL, its kernels on the device): seconds spent in the exchange
    (``all_to_all`` and the roll's sends) and in the reductions (pop-min,
    counters, liveness)."""
    import torch
    acc = {"exchange": 0.0, "reduce": 0.0}
    cuda = comm.device.type == "cuda"

    def wrap(name, key):
        f = getattr(comm, name)

        def timed(*a, **kw):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **kw)
            if cuda:
                torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            return out
        setattr(comm, name, timed)
    wrap("all_to_all", "exchange")
    wrap("_send_to", "exchange")
    wrap("_reduce", "reduce")
    return acc


def warm_transport(device):
    """Each collective the engines ride, once between every pair of
    ranks, before anything is timed: NCCL connects two ranks at their
    first exchange, which took the first supersteps of four ranks to
    hundreds of ms each."""
    import torch
    import torch.distributed as dist
    D = dist.get_world_size()
    x = torch.zeros(D * 256, dtype=torch.int32, device=device)
    dist.all_to_all_single(torch.empty_like(x), x)
    y = torch.zeros(8, dtype=torch.int64, device=device)
    dist.all_reduce(y)
    dist.all_gather([torch.empty_like(y) for _ in range(D)], y)
    dist.barrier()


def _rank_run(tag, run, comm, steps_of, prof_run):
    """``run()`` on every rank at once, timed between barriers, with the
    collectives' timers and the kernels' launches counted over it (the
    caller zeroes the counts just before); then, unless ``prof_run`` is
    None, ``prof_run(result)`` (a few supersteps more) under
    ``torch.profiler`` for each rank's device time, NCCL's kernels apart
    (they wait on the other ranks), and the idle share: of the rank's
    card (one minus its kernel time, NCCL's aside, over the profiled
    run's wall) and of each card over the ranks sharing it (their kernel
    time summed). Prints the rank's line; returns ``(result, record)``."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    cuda = comm.device.type == "cuda"
    acc = _comm_timers(comm)
    dist.barrier()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = steps_of(out)
    rec = dict(wall=wall, steps=steps, exchange_s=acc["exchange"],
               reduce_s=acc["reduce"], launches=dict(ci.LAUNCHES))
    if cuda and prof_run is not None:
        dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            prof_run(out)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t1
        dev_s = nccl_s = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if e.key.lower().startswith("nccl"):
                    nccl_s += e.self_device_time_total / 1e6
                else:
                    dev_s += e.self_device_time_total / 1e6
        card = torch.cuda.current_device()
        both = [None] * dist.get_world_size()
        dist.all_gather_object(both, (dev_s, pwall, card))
        mates = [(d, w) for d, w, c in both if c == card]
        rec.update(device_s=dev_s, nccl_s=nccl_s, card=card,
                   idle_share_rank=1 - dev_s / pwall,
                   idle_share_card=1 - sum(d for d, _ in mates)
                   / max(w for _, w in mates))
    transport = "host staging" if comm.gloo else "NCCL on the device"
    say(f"rank {dist.get_rank()} {tag}: supersteps={steps} wall_s={wall} "
        f"wall_ms_per_superstep={wall / max(steps, 1) * 1e3} "
        f"exchange_share={acc['exchange'] / wall} (all_to_all and roll "
        f"with {transport}, {acc['exchange']} s) reduce_share="
        f"{acc['reduce'] / wall} (pop-min, counters, liveness) "
        + (f"device_idle_share_rank={rec['idle_share_rank']} "
           f"device_idle_share_card={rec['idle_share_card']} (cuda:"
           f"{rec['card']}; NCCL kernels {rec['nccl_s']} s apart)"
           if "card" in rec else "device idle share not measured"
           + (" on the CPU" if not cuda else " (no profile)")))
    return out, rec


def _take_k1(eng, drive):
    """K1's arguments at the busiest superstep ``drive()`` runs on the
    node-sharded ``eng`` (the most entries K1 inserts), taken where the
    engine's stage receives them, at their solo shapes."""
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    taken = {"valid": -1}
    insert = eng.stage.insert

    def take(sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload, counts):
        start, cnt = ci.bucket_bounds(sd[0], eng.stage.n)
        valid = int(cnt.sum())
        if valid > taken["valid"]:
            taken.update(valid=valid, args=(
                start, cnt, None if counts is None else counts[0],
                drel_s[0], src_s[0] if eng.stage.inbox_src else None,
                pay_s[0], mb_rel[0], mb_src[0], mb_payload[0]))
        return insert(sd, drel_s, src_s, pay_s, mb_rel, mb_src, mb_payload,
                      counts)
    eng.stage.insert = take
    try:
        drive()
    finally:
        del eng.stage.insert
    return taken["args"], taken["valid"]


def rank_node_sharded(device, steps=SHARD_STEPS, n=STEADY_N,
                      engines=("fused", "general"), verified=True):
    """Phase 52 in one rank: steady gossip at ``n`` through
    ``ShardedFusedSparseEngine`` (K1′) and ``ShardedEngine`` (``engines``
    names which: the fused one always), ``run`` for ``steps`` supersteps
    each, K1 counted over each run, the two engines' shards of the state
    equal on the rank (the fused one's gathered for the caller); then K1′
    at the rank's busiest superstep of the same ``steps`` (a
    ``run_quiet`` from the start; the gossip saturates past superstep 32)
    against its plain version (bit-equal) and, one rank at a time, its
    time and bound; then, with ``verified``, the verified legs."""
    import torch
    import torch.distributed as dist
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.sharded import (
        ShardedEngine, ShardedFusedSparseEngine)
    from timewarp_tpu_torch.interp.torch_engine.state_io import \
        state_to_numpy
    from timewarp_tpu_torch.parallel import make_mesh
    rank = dist.get_rank()
    sc, link = steady_gossip(n)
    mesh = make_mesh()
    out = {}
    for name, cls in (("fused", ShardedFusedSparseEngine),
                      ("general", ShardedEngine)):
        if name not in engines:
            continue
        eng = cls(sc, link, mesh, device=device)
        ci.reset_launches()
        (st, tr), rec = _rank_run(
            f"phase 52 {cls.__name__} steady gossip n={n}",
            lambda: eng.run(steps), eng.comm, lambda r: len(r[1]),
            lambda r: eng.run_quiet(16, r[0]))
        rec["S"] = eng.stage.S
        if name == "fused":
            fused_shard = state_to_numpy(st, sc)
            g = state_to_numpy(eng.gather_state(st), sc)
        else:
            _np_states_equal(f"phase 52 rank {rank}: ShardedEngine's shard "
                             "vs ShardedFusedSparseEngine's",
                             fused_shard, state_to_numpy(st, sc))
            g = None
        out[name] = dict(rec, trace=tr, state=g if rank == 0 else None)
        if name == "fused":
            args, valid = _take_k1(eng, lambda: eng.run_quiet(steps))
            got = ci.mailbox_insert(*args)
            want = ci.mailbox_insert_plain(*args)
            torch.cuda.synchronize()
            err = _equal(f"K1' rank {rank}", got, want)
            r = {}
            for turn in range(dist.get_world_size()):
                if turn == rank:
                    nbytes = k1_bytes(args)
                    r = dict(ms=_time_ms(lambda: ci.mailbox_insert(*args)),
                             plain_ms=_time_ms(
                                 lambda: ci.mailbox_insert_plain(*args),
                                 queued=False),
                             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             bytes=nbytes)
                dist.barrier()
            say(f"rank {rank} K1' (mailbox_insert per shard) at its busiest "
                f"superstep: n_local={args[6].shape[1]} S2={args[3].numel()} "
                f"valid={valid} K={args[6].shape[0]} P={args[8].shape[1]} "
                f"overflow={int(got[3])} bit-equal max_abs_err={err} "
                f"kernel_ms={r['ms']} plain_ms={r['plain_ms']} bound_ms="
                f"{r['bound_ms']} (bytes {r['bytes']} over 3.35 TB/s; "
                f"{nvidia_smi()}; no single PyTorch call computes this "
                "function: library_ms null)")
            out["k1p"] = dict(r, err=err, valid=valid, n_local=args[6].shape[1],
                              S2=args[3].numel())
        del eng, st
        torch.cuda.empty_cache()
    if verified:
        out.update(rank_node_verified(device, sc, link, mesh))
    return out


def _count_runs(eng):
    """Wrap ``eng.run`` to sum the fleet supersteps (loop iterations) of
    every call: a chunked driver's chunks, shadow re-runs and rolled-back
    chunks included — what each kernel's launch count must equal."""
    box = [0]
    run = eng.run

    def counted(*a, **kw):
        got = run(*a, **kw)
        box[0] += eng.last_run_stats["fleet_supersteps"]
        return got
    eng.run = counted
    return box


def rank_node_verified(device, sc, link, mesh):
    """Phase 52's verified legs in one rank: ``ShardedFusedSparseEngine``
    (K1′) through ``run_verified`` for :data:`SHARD_VERIFY_STEPS` in chunks
    of :data:`SHARD_VERIFY_CHUNK` under each mode of :data:`SHARD_VERIFY`
    with its flip; K1 counted over the call, against the supersteps its
    ``run`` calls ran."""
    import torch
    import torch.distributed as dist
    from timewarp_tpu_torch.integrity import FlipInjector
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.sharded import \
        ShardedFusedSparseEngine
    from timewarp_tpu_torch.interp.torch_engine.state_io import \
        state_to_numpy
    out = {}
    for mode, spec in SHARD_VERIFY:
        eng = ShardedFusedSparseEngine(sc, link, mesh, verify=mode,
                                       device=device)
        ran, flip = _count_runs(eng), FlipInjector(spec)
        dist.barrier()
        torch.cuda.synchronize()
        ci.reset_launches()
        t0 = time.perf_counter()
        fin, tr = eng.run_verified(SHARD_VERIFY_STEPS,
                                   chunk=SHARD_VERIFY_CHUNK, inject=flip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ci.LAUNCHES)
        g = state_to_numpy(eng.gather_state(fin), sc)
        out[f"verify_{mode}"] = dict(
            trace=tr, rec=eng.last_run_integrity, ran=ran[0],
            flip=(flip.fired, flip.desc), launches=launches, wall=wall,
            state=g if dist.get_rank() == 0 else None)
        del eng, fin, g
        torch.cuda.empty_cache()
    return out


def rank_edge_sharded(device, steps=SHARD_STEPS, n=RING_N):
    """Phase 53 in one rank: the dense ring at ``n`` through
    ``ShardedEdgeEngine`` (the ring's delivery a roll over the ranks),
    the kernels' launches counted over the run."""
    import torch.distributed as dist
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.sharded import \
        ShardedEdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.state_io import \
        edge_state_to_numpy
    from timewarp_tpu_torch.parallel import make_mesh
    eng = ShardedEdgeEngine(*dense_ring(n), make_mesh(), device=device)
    ci.reset_launches()
    (st, tr), rec = _rank_run(f"phase 53 ShardedEdgeEngine dense ring n={n}",
                              lambda: eng.run(steps), eng.comm,
                              lambda r: len(r[1]),
                              lambda r: eng.run_quiet(16, r[0]))
    g = edge_state_to_numpy(eng.gather_state(st))
    return dict(rec, trace=tr, state=g if dist.get_rank() == 0 else None)


def rank_fleet_sharded(device, n=CHAOS_N):
    """Phase 54 in one rank: the chaos fleet (phase 27's 8 worlds and
    schedules) through ``ShardedBatchedEngine``, this rank's worlds to
    quiescence, K2 and K1 counted."""
    import torch.distributed as dist
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.sharded import \
        ShardedBatchedEngine
    from timewarp_tpu_torch.interp.torch_engine.state_io import \
        state_to_numpy
    from timewarp_tpu_torch.parallel import make_mesh
    sc, link, spec, fleet, _ = chaos_fleet(n)
    eng = ShardedBatchedEngine(sc, link, make_mesh(axis="worlds"),
                               batch=spec, faults=fleet, window="auto",
                               device=device)
    ci.reset_launches()
    fin, rec = _rank_run(
        f"phase 54 ShardedBatchedEngine chaos fleet B={spec.B} n={n}",
        lambda: eng.run_quiet(1 << 20), eng.shard_comm,
        lambda r: eng.last_run_stats["fleet_supersteps"],
        lambda r: eng.run_quiet(48))
    rec["local_worlds"] = int(fin.wake.shape[0])
    g = state_to_numpy(eng.gather_state(fin), sc)
    out = dict(rec, state=g if dist.get_rank() == 0 else None)
    out.update(rank_fleet_drivers(device, eng, spec, fleet))
    return out


def rank_fleet_drivers(device, eng, spec, fleet):
    """Phase 54's verified and streamed legs in one rank: the chaos fleet
    through ``run_verified`` (digest, :data:`FLEET_VERIFY_FLIP`) for
    :data:`FLEET_VERIFY_STEPS` fleet supersteps in chunks of
    :data:`FLEET_CHUNK`, then ``eng`` through ``run_stream`` under
    :data:`FLEET_STREAM_BUDGETS` (each ``on_quiesce``: world, its steps,
    the worlds in the state it got); K2 and K1 counted over each call."""
    import torch
    import torch.distributed as dist
    from timewarp_tpu_torch.integrity import FlipInjector
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.sharded import \
        ShardedBatchedEngine
    from timewarp_tpu_torch.interp.torch_engine.state_io import \
        state_to_numpy
    from timewarp_tpu_torch.parallel import make_mesh
    sc, link = eng.scenario, eng.link
    ver = ShardedBatchedEngine(sc, link, make_mesh(axis="worlds"),
                               batch=spec, faults=fleet, window="auto",
                               verify="digest", device=device)
    out = {}
    for name, e, call in (
            ("verified", ver, lambda: ver.run_verified(
                FLEET_VERIFY_STEPS, chunk=FLEET_CHUNK, inject=flip)),
            ("stream", eng, lambda: eng.run_stream(
                np.array(FLEET_STREAM_BUDGETS), chunk=FLEET_CHUNK,
                on_quiesce=lambda b, st: seen.append(
                    (b, int(st.steps[b]), int(st.wake.shape[0])))))):
        flip, seen = FlipInjector(FLEET_VERIFY_FLIP), []
        ran = _count_runs(e)
        dist.barrier()
        torch.cuda.synchronize()
        ci.reset_launches()
        t0 = time.perf_counter()
        fin, tr = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ci.LAUNCHES)
        g = state_to_numpy(e.gather_state(fin), sc)
        out[name] = dict(
            trace=tr, ran=ran[0], launches=launches, wall=wall, seen=seen,
            rec=e.last_run_integrity if name == "verified" else None,
            flip=(flip.fired, flip.desc) if name == "verified" else None,
            state=g if dist.get_rank() == 0 else None)
        del e.run                       # the engine's own run again
    return out


def rank_checkpoint(device, path):
    """The checkpoint leg in one rank: :data:`CLI_CK` through the command
    line's rank path (``cli.execute`` over the mesh, as ``cli.rank_main``
    runs it) for :data:`CK_STEPS` supersteps with ``--save path``: rank 0
    writes the gathered state. Returns the summary and the wall."""
    import torch.distributed as dist
    from timewarp_tpu_torch import cli
    from timewarp_tpu_torch.parallel import make_mesh
    D = dist.get_world_size()
    args = cli.run_parser().parse_args(
        CLI_CK + ["--engine", "sharded", "--devices", str(D),
                  "--steps", str(CK_STEPS), "--save", path])
    t0 = time.perf_counter()
    summary = cli.execute(args, device, None, mesh=make_mesh(D),
                          rank=dist.get_rank())
    return dict(summary=summary, wall=time.perf_counter() - t0)


def small_sharded_cases(device, n=1 << 12):
    """Phase 55 in one rank (card or CPU ranks alike): each sharded engine
    at 2^12 through ``run``: traces and gathered states."""
    import torch.distributed as dist
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.interp.torch_engine.sharded import (
        ShardedBatchedEngine, ShardedEdgeEngine, ShardedEngine,
        ShardedFusedSparseEngine)
    from timewarp_tpu_torch.interp.torch_engine.state_io import (
        edge_state_to_numpy, state_to_numpy)
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.models.token_ring import token_ring
    from timewarp_tpu_torch.net.delays import Quantize, UniformDelay
    from timewarp_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    wave = gossip(n, fanout=8, think_us=2_000, burst=True, end_us=5_000_000,
                  mailbox_cap=8)
    wlink = Quantize(UniformDelay(8_000, 30_000), 1_000)
    ring = token_ring(n, n_tokens=64, think_us=1_000, bootstrap_us=1_000,
                      end_us=400_000, with_observer=False)
    sc, link, _, fleet, _ = chaos_fleet(n, 4)
    out = {}
    for tag, eng, steps in (
            ("ShardedEngine gossip wave", ShardedEngine(
                wave, wlink, mesh, window="auto", seed=11, device=device),
             48),
            ("ShardedFusedSparseEngine gossip wave",
             ShardedFusedSparseEngine(wave, wlink, mesh, window="auto",
                                      seed=11, device=device), 48),
            ("ShardedEdgeEngine uniform ring", ShardedEdgeEngine(
                ring, UniformDelay(1_000, 5_000), mesh, seed=11,
                device=device), 100),
            ("ShardedBatchedEngine fleet, faults", ShardedBatchedEngine(
                sc, link, make_mesh(axis="worlds"),
                batch=BatchSpec(seeds=(0, 1, 2, 3)), faults=fleet,
                window="auto", device=device), 48)):
        (st, tr), rec = _rank_run(f"phase 55 {tag} n={n} on {device}",
                                  lambda: eng.run(steps), eng.shard_comm,
                                  lambda r: max(len(t) for t in r[1])
                                  if isinstance(r[1], list) else len(r[1]),
                                  lambda r: eng.run_quiet(16))
        g = eng.gather_state(st)
        g = edge_state_to_numpy(g) if tag.startswith("ShardedEdge") \
            else state_to_numpy(g, eng.scenario)
        out[tag] = dict(rec, trace=tr,
                        state=g if dist.get_rank() == 0 else None)
    return out


@cpu_leg("ranks")
def leg_ranks(dev, n=1 << 12):
    """Phase 55's CPU half: :func:`small_sharded_cases` in ``SHARD_D``
    gloo ranks on the CPU, one torch thread each (rank 0's result, which
    holds the gathered states)."""
    from timewarp_tpu_torch.parallel.launch import spawn
    return spawn("chip_smoke:small_sharded_cases", SHARD_D, backend="gloo",
                 device=dev, args=(n,), threads=1)[0]


def ranks_on_card(device, steps=SHARD_STEPS, sizes=None, ck_path=None,
                  phases=(52, 53, 54, 55), node_opts=None):
    """``phases`` of 52-55 (the card's half of 55) in one rank, and the
    checkpoint leg (``ck_path``), after :func:`warm_transport`: each
    between barriers, its wall measured on rank 0. ``sizes`` (the node
    counts of 52, 53, 54 and 55) defaults to the configurations' own;
    ``node_opts`` are :func:`rank_node_sharded`'s options."""
    import torch.distributed as dist
    n52, n53, n54, n55 = sizes or (STEADY_N, RING_N, CHAOS_N, 1 << 12)
    out, walls = {}, {}
    warm_transport(device)
    for phase, fn in ((52, lambda: rank_node_sharded(device, steps, n52,
                                                     **(node_opts or {}))),
                      (53, lambda: rank_edge_sharded(device, steps, n53)),
                      (54, lambda: rank_fleet_sharded(device, n54)),
                      (55, lambda: small_sharded_cases(device, n55)),
                      ("ck", lambda: rank_checkpoint(device, ck_path))):
        if phase not in phases and not (phase == "ck" and ck_path):
            continue
        dist.barrier()
        t0 = time.perf_counter()
        out[phase] = fn()
        dist.barrier()
        walls[phase] = time.perf_counter() - t0
    out["walls"] = walls
    return out


def _np_states_equal(what, a, b) -> None:
    for name in a:
        x, y = a[name], b[name]
        same = all(np.array_equal(x[k], y[k]) for k in x) \
            if name == "states" else np.array_equal(x, y)
        if not same:
            raise AssertionError(f"{what}: state.{name} differs")


def phase_sharded(device, chaos_fin, steps=SHARD_STEPS, sizes=None,
                  ranks=SHARD_D, backend="gloo", phases=(52, 53, 54, 55),
                  engines=("fused", "general"), verified=True):
    """Phases 52-55: the multi-device slice, ``ranks`` ranks of
    ``torch.distributed`` over ``backend`` started by
    ``parallel.launch.spawn`` (chip_smoke's own: 2 gloo ranks sharing the
    card; ``tools/multichip_cuda.py`` runs ``phases`` 52-54 on NCCL, one
    card a rank); each sharded run held equal to its one-device run over
    the same supersteps (every leaf of the gathered state, every counter,
    the trace's digest chain), the card ranks to CPU ranks at 2^12; the
    verified, streamed and checkpointed legs against theirs. ``sizes`` as
    :func:`ranks_on_card`'s; ``engines`` and ``verified`` as
    :func:`rank_node_sharded`'s. Returns ``(K1′ record, K1′ launches,
    K2/K1 launches of phase 54, {phase: every rank's result})``; ``chaos_fin``
    (phase 27's final fleet) is read only for 54."""
    import os

    import torch
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.state_io import (
        edge_state_to_numpy, state_to_numpy)
    from timewarp_tpu_torch.parallel.launch import spawn
    from timewarp_tpu_torch.trace.events import assert_traces_equal
    n52, n53, n54, n55 = sizes or (STEADY_N, RING_N, CHAOS_N, 1 << 12)
    # the one-device runs first, while the card is the script's alone
    if 52 in phases:
        sc, link = steady_gossip(n52)
        solo_st, solo_tr = TorchEngine(sc, link, device=device).run(steps)
        solo52 = state_to_numpy(solo_st, sc)
        del solo_st
        twins52 = solo_verified(device, sc, link) if verified else None
    if 53 in phases:
        ring_st, ring_tr = EdgeEngine(*dense_ring(n53),
                                      device=device).run(steps)
        solo53 = edge_state_to_numpy(ring_st)
        del ring_st
    if 54 in phases:
        want54 = state_to_numpy(chaos_fin, chaos_fleet(n54)[0])
        twins54 = solo_fleet_drivers(device, n54)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ck_path = os.path.join(_scratch(), "sharded_ck.npz") if 55 in phases \
        else None
    t0 = time.perf_counter()
    res = spawn("chip_smoke:ranks_on_card", ranks, backend=backend,
                device=device.type,
                args=(steps, sizes, ck_path, phases,
                      dict(engines=engines, verified=verified)))
    spawn_wall = time.perf_counter() - t0
    walls = res[0]["walls"]
    where = "the CPU" if device.type == "cpu" else "cuda:0" \
        if torch.cuda.device_count() == 1 \
        else f"{min(ranks, torch.cuda.device_count())} cards"
    say(f"sharded ranks: {ranks} {backend} ranks on {where} "
        f"spawn_and_run_s={spawn_wall} (phases {sum(walls.values())} s, the "
        "rest starting the ranks)")
    k1p, k1p_launches = None, 0
    fleet_launches = {"fire_compact": 0, "mailbox_insert": 0}

    # 52: node-sharded gossip = the one-device run, K1′ once per superstep
    if 52 in phases:
        r52 = [r[52] for r in res]
        _np_states_equal("phase 52 sharded fused vs one device", solo52,
                         r52[0]["fused"]["state"])
        for name in engines:
            assert_traces_equal(solo_tr, r52[0][name]["trace"], "one device",
                                f"sharded {name}")
            for r, rr in enumerate(r52):
                ln = rr[name]["launches"]
                _require_all(f"phase 52 {name} rank {r}", {
                    "K1 once per superstep":
                        ln["mailbox_insert"] == len(solo_tr),
                    "no K2/K3/K4": ln["fire_compact"] == ln["sample_insert"]
                    == ln["fused_ring"] == 0,
                    "the same trace on every rank": np.array_equal(
                        rr[name]["trace"].recv_hash, solo_tr.recv_hash)})
        _require_all("phase 52", {"S2 = D * bucket_cap in 1024-entry tiles":
                                  r52[0]["fused"]["S"] % 1024 == 0})
        k1p = max((rr["k1p"] for rr in r52), key=lambda r: r["ms"])
        k1p_launches = sum(rr[nm]["launches"]["mailbox_insert"]
                           for rr in r52 for nm in engines)
        fs = int(solo52["delivered"])
        say(f"phase 52: node-sharded steady gossip n={n52} over {ranks} "
            f"{backend} ranks, {len(solo_tr)} supersteps: "
            f"{' = '.join(ENGINE_NAMES[e] for e in engines)} = TorchEngine "
            f"(traces, every leaf, delivered={fs}, overflow="
            f"{int(solo52['overflow'])}); K1' launched {k1p_launches} times "
            "in all (once per superstep on each rank)")
        if verified:
            k1p_launches += check_node_verified(r52, twins52)
        say(f"phase 52 wall_s={walls[52]}")

    # 53: the sharded ring = EdgeEngine
    if 53 in phases:
        r53 = res[0][53]
        assert_traces_equal(ring_tr, r53["trace"], "EdgeEngine",
                            "sharded ring")
        _require_all("phase 53", {
            f"rank {r}: no kernel (EdgeEngine's torch ops)":
                not any(rr[53]["launches"].values())
            for r, rr in enumerate(res)})
        _np_states_equal("phase 53 sharded ring vs EdgeEngine", solo53,
                         r53["state"])
        say(f"phase 53: sharded dense ring n={n53} over {ranks} {backend} "
            f"ranks, {len(ring_tr)} supersteps = EdgeEngine (traces, every "
            f"leaf, delivered={int(solo53['delivered'])})")
        say(f"phase 53 wall_s={walls[53]}")

    # 54: the sharded chaos fleet = phase 27's worlds
    if 54 in phases:
        r54 = [r[54] for r in res]
        _np_states_equal("phase 54 sharded chaos fleet vs phase 27", want54,
                         r54[0]["state"])
        for r, rr in enumerate(r54):
            ln = rr["launches"]
            _require_all(f"phase 54 rank {r}", {
                f"{CHAOS_B // ranks} worlds a rank":
                    rr["local_worlds"] == CHAOS_B // ranks,
                "K2 and K1 once per fleet superstep":
                    ln["fire_compact"] == ln["mailbox_insert"] == rr["steps"],
                "no K3/K4": ln["sample_insert"] == ln["fused_ring"] == 0})
            for k in fleet_launches:
                fleet_launches[k] += ln[k]
        say(f"phase 54: sharded chaos fleet B={CHAOS_B} n={n54} over "
            f"{ranks} {backend} ranks of {CHAOS_B // ranks} worlds: every "
            "leaf = phase 27's fleet; fleet supersteps per rank "
            f"{[rr['steps'] for rr in r54]}, K2/K1 once per fleet superstep "
            "on each rank")
        for k, v in check_fleet_drivers(r54, twins54).items():
            fleet_launches[k] += v
        say(f"phase 54 wall_s={walls[54]}")

    # 55: the card's ranks = CPU ranks at 2^12
    if 55 in phases:
        t0 = time.perf_counter()
        cpu = LEGS.get("ranks") if LEGS is not None and sizes is None \
            else leg_ranks("cpu", n55)
        cpu_wall = time.perf_counter() - t0
        card = res[0][55]
        for tag, c in card.items():
            g = cpu[tag]
            ta, tb = (c["trace"], g["trace"])
            for w, (x, y) in enumerate(zip(*(t if isinstance(t, list)
                                             else [t] for t in (ta, tb)))):
                assert_traces_equal(x, y, f"card {tag} w{w}", "CPU ranks")
            _np_states_equal(f"phase 55 {tag}: card vs CPU ranks",
                             c["state"], g["state"])
            say(f"phase 55: {tag}: card ranks = CPU ranks (traces, every "
                f"leaf; {c['steps']} supersteps, card wall_s={c['wall']} "
                f"CPU wall_s={g['wall']})")
        say(f"phase 55 wall_s={walls[55] + cpu_wall}")
        check_sharded_checkpoint(res[0]["ck"], ck_path)
        say(f"phase 55 (checkpoint) wall_s={walls['ck']}")
    return k1p, k1p_launches, fleet_launches, {
        p: [r[p] for r in res] for p in phases if p != 55}


#: phase 52's engines by the name rank_node_sharded keys them
ENGINE_NAMES = {"fused": "ShardedFusedSparseEngine",
                "general": "ShardedEngine"}


def solo_verified(device, sc, link):
    """Phase 52's verified legs on one device: ``TorchEngine`` through
    ``run_verified`` under each mode of :data:`SHARD_VERIFY`, the same
    flip: ``{mode: (state, trace, integrity record, flip)}``."""
    from timewarp_tpu_torch.integrity import FlipInjector
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.state_io import \
        state_to_numpy
    out = {}
    for mode, spec in SHARD_VERIFY:
        eng = TorchEngine(sc, link, verify=mode, device=device)
        flip = FlipInjector(spec)
        (fin, tr), wall = _timed(lambda: eng.run_verified(
            SHARD_VERIFY_STEPS, chunk=SHARD_VERIFY_CHUNK, inject=flip))
        out[mode] = (state_to_numpy(fin, sc), tr, eng.last_run_integrity,
                     (flip.fired, flip.desc))
        say(f"phase 52: verify={mode} on one device (TorchEngine."
            f"run_verified): wall_s={wall}")
    return out


def check_node_verified(r52, twins):
    """Phase 52's verified legs against their one-device runs: on every
    rank the trace and the integrity record (digest chain, checks,
    rollbacks, violations) and the flip, rank 0's gathered state leaf for
    leaf; the flip found (a rollback); K1′ once per superstep the ranks'
    ``run`` calls ran, nothing else launched. Returns K1′'s launches."""
    from timewarp_tpu_torch.trace.events import assert_traces_equal
    total = 0
    for mode, _ in SHARD_VERIFY:
        want_st, want_tr, want_rec, want_flip = twins[mode]
        _np_states_equal(f"phase 52 verify={mode}: sharded vs one device",
                         want_st, r52[0][f"verify_{mode}"]["state"])
        for r, rr in enumerate(r52):
            got = rr[f"verify_{mode}"]
            assert_traces_equal(want_tr, got["trace"], "one device",
                                f"sharded verify={mode} rank {r}")
            ln = got["launches"]
            _require_all(f"phase 52 verify={mode} rank {r}", {
                "the integrity record = one device's": got["rec"]
                == want_rec,
                "the same flip": got["flip"] == want_flip,
                "the flip found and rolled back": want_rec["rollbacks"] >= 1,
                "K1' once per superstep run": ln["mailbox_insert"]
                == got["ran"],
                "no K2/K3/K4": ln["fire_compact"] == ln["sample_insert"]
                == ln["fused_ring"] == 0})
            total += ln["mailbox_insert"]
        g = r52[0][f"verify_{mode}"]
        say(f"phase 52: verify={mode} steady gossip over {len(r52)} ranks, "
            f"{SHARD_VERIFY_STEPS} supersteps in chunks of "
            f"{SHARD_VERIFY_CHUNK}, {g['flip'][1]}: = TorchEngine's "
            f"run_verified (trace, every leaf, integrity record: "
            f"rollbacks={want_rec['rollbacks']} checks={want_rec['checks']}"
            f" chain={want_rec['digest_chain'][0][:16]}); supersteps run "
            f"{g['ran']} a rank, K1' as many; wall_s={g['wall']} "
            f"({nvidia_smi()})")
    return total


def solo_fleet_drivers(device, n):
    """Phase 54's legs on one device: the chaos fleet through
    ``run_verified`` and ``run_stream`` as :func:`rank_fleet_drivers`
    runs them: ``{"verified": (state, traces, record, flip), "stream":
    (state, traces, on_quiesce calls)}``."""
    from timewarp_tpu_torch.integrity import FlipInjector
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.state_io import \
        state_to_numpy
    sc, link, spec, fleet, _ = chaos_fleet(n)
    ver = TorchEngine(sc, link, batch=spec, faults=fleet, window="auto",
                      verify="digest", device=device)
    flip = FlipInjector(FLEET_VERIFY_FLIP)
    (fin, tr), wall = _timed(lambda: ver.run_verified(
        FLEET_VERIFY_STEPS, chunk=FLEET_CHUNK, inject=flip))
    out = {"verified": (state_to_numpy(fin, sc), tr,
                        ver.last_run_integrity, (flip.fired, flip.desc))}
    del ver, fin
    seen = []
    eng = TorchEngine(sc, link, batch=spec, faults=fleet, window="auto",
                      device=device)
    (fin, tr), wall2 = _timed(lambda: eng.run_stream(
        np.array(FLEET_STREAM_BUDGETS), chunk=FLEET_CHUNK,
        on_quiesce=lambda b, st: seen.append(
            (b, int(st.steps[b]), int(st.wake.shape[0])))))
    out["stream"] = (state_to_numpy(fin, sc), tr, seen)
    say(f"phase 54: the chaos fleet on one device: run_verified wall_s="
        f"{wall}, run_stream wall_s={wall2}")
    return out


def check_fleet_drivers(r54, twins):
    """Phase 54's legs against their one-device runs: every world's trace
    on every rank, rank 0's gathered state leaf for leaf, the integrity
    record and the flip (found), each world's ``on_quiesce`` once at its
    one-device superstep with the whole fleet; K2 and K1 once per fleet
    superstep the ranks' ``run`` calls ran. Returns their launches."""
    from timewarp_tpu_torch.trace.events import assert_traces_equal
    launches = {"fire_compact": 0, "mailbox_insert": 0}
    for leg in ("verified", "stream"):
        want_st, want_tr = twins[leg][:2]
        _np_states_equal(f"phase 54 {leg}: sharded vs one device", want_st,
                         r54[0][leg]["state"])
        for r, rr in enumerate(r54):
            got = rr[leg]
            for b, (x, y) in enumerate(zip(want_tr, got["trace"])):
                assert_traces_equal(x, y, "one device",
                                    f"sharded {leg} rank {r} w{b}")
            ln = got["launches"]
            checks = {
                "K2 and K1 once per fleet superstep run":
                    ln["fire_compact"] == ln["mailbox_insert"] == got["ran"],
                "no K3/K4": ln["sample_insert"] == ln["fused_ring"] == 0}
            if leg == "verified":
                checks.update({
                    "the integrity record = one device's":
                        got["rec"] == twins[leg][2],
                    "the same flip": got["flip"] == twins[leg][3],
                    "the flip found and rolled back":
                        got["rec"]["rollbacks"] >= 1})
            else:
                checks.update({
                    "each world's on_quiesce once, at its one-device "
                    "superstep, with every world": got["seen"]
                    == twins[leg][2] and sorted(b for b, _, _ in got["seen"])
                    == list(range(CHAOS_B))})
            _require_all(f"phase 54 {leg} rank {r}", checks)
            for k in launches:
                launches[k] += ln[k]
        g = r54[0][leg]
        say(f"phase 54: the chaos fleet's {leg} driver over {len(r54)} ranks "
            f"= one device's (traces, every leaf"
            + (f", integrity record, {g['flip'][1]}, rollbacks="
               f"{g['rec']['rollbacks']}" if leg == "verified" else
               f", on_quiesce {g['seen']}")
            + f"); fleet supersteps run {g['ran']} a rank, K2 = K1 as many; "
            f"wall_s={g['wall']} ({nvidia_smi()})")
    return launches


def check_sharded_checkpoint(got, path):
    """The checkpoint leg: the ranks' ``--save`` (:data:`CLI_CK`, after
    :data:`CK_STEPS` supersteps) is the one-device run's file, leaf for
    leaf, with the same meta, and resumes on one device to the
    uninterrupted run."""
    import os
    one = path.replace(".npz", "_one.npz")
    t0 = time.perf_counter()
    rc1, s1 = _cli(CLI_CK + ["--steps", str(CK_STEPS), "--save", one])
    rc2, s2 = _cli(CLI_CK + ["--steps", "1048576", "--resume", path])
    rc3, s3 = _cli(CLI_CK + ["--steps", "1048576"])
    wall = time.perf_counter() - t0
    a, b = np.load(path), np.load(one)
    same = sorted(a.files) == sorted(b.files) and all(
        np.array_equal(a[k], b[k]) for k in a.files)
    sh = got["summary"]
    strip = ("device", "engine")
    _require_all("checkpoint", {
        "the one-device runs exit 0": rc1 == rc2 == rc3 == 0,
        "the ranks' summary = one device's": {
            k: v for k, v in sh.items() if k not in strip}
        == {k: v for k, v in s1[-1].items() if k not in strip},
        "the ranks' file = one device's (every leaf, tree, meta)": same,
        "resumed to the uninterrupted run": (s2[-1]["steps"],
                                             s2[-1]["virtual_time_us"])
        == (s3[-1]["steps"], s3[-1]["virtual_time_us"])
        and sh["delivered"] + s2[-1]["delivered"] == s3[-1]["delivered"]})
    say(f"checkpoint: {SHARD_D} ranks --save after {CK_STEPS} supersteps of "
        f"the 2^17 wave = one device's file ({os.path.getsize(path)} bytes)"
        f"; one-device --resume to the end ({s2[-1]['supersteps']} "
        f"supersteps) = the uninterrupted run ({s3[-1]['supersteps']}); "
        f"ranks wall_s={got['wall']}, one-device runs wall_s={wall}")
    for f in (path, one):
        os.remove(f)


# -- the analysis slice: lint, bisect, explain, profile ---------------------

def lint_builds(n_wave, n_praos, n_ring, n_steady):
    """Phase 56's engines by name: ``(class, scenario and link builder,
    keyword arguments)`` — the main paths' configurations."""
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_ring import \
        FusedRingEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    return {
        "general": (TorchEngine, lambda: gossip_wave(n_wave),
                    {"window": "auto"}),
        "fused": (FusedSparseEngine, lambda: praos_consensus(n_praos),
                  {"window": "auto", "max_batch": n_praos * SLICE_M}),
        "ring": (FusedRingEngine, lambda: dense_ring(n_ring), {}),
        "edge": (EdgeEngine, lambda: dense_ring(n_ring), {}),
        "steady": (TorchEngine, lambda: steady_gossip(n_steady), {}),
    }


def lint_engines(dev, sizes):
    """Each engine of :func:`lint_builds` built with ``lint="error"`` on
    ``dev``, its superstep body scanned (``lint_engine_jaxpr``) and its
    off modes proven neutral (``prove_mode_neutrality``): per engine the
    (code, severity) set of the three reports, the construction lint's
    ms (a fresh scenario object, so nothing is cached) and the scan's and
    proof's seconds."""
    from timewarp_tpu_torch.analysis import (check_scenario,
                                             lint_engine_jaxpr,
                                             prove_mode_neutrality)
    out = {}
    for name, (cls, make, kw) in lint_builds(*sizes).items():
        sc, link = make()
        t0 = time.perf_counter()
        rep = check_scenario(sc, "error", who=name)
        lint_ms = (time.perf_counter() - t0) * 1e3
        eng = cls(sc, link, lint="error", device=dev, **kw)
        if eng.lint_report is not rep:
            raise AssertionError(f"{name}: the construction lint was not "
                                 "the scenario's cached report")
        t1 = time.perf_counter()
        scan = lint_engine_jaxpr(eng, name)
        t2 = time.perf_counter()
        proof = prove_mode_neutrality(
            lambda **k: cls(sc, link, device=dev, **kw, **k), name)
        t3 = time.perf_counter()
        out[name] = dict(
            codes=sorted({(f.code, f.severity) for f in
                          rep.findings + scan.findings + proof.findings}),
            lint_ms=lint_ms, scan_s=t2 - t1, proof_s=t3 - t2,
            n=sc.n_nodes)
    return out


@cpu_leg("lint")
def leg_lint(dev, n=1 << 12):
    """Phase 56's leg: every engine's reports at 2^12."""
    return lint_engines(dev, (n, n, n, n))


def phase_lint(device):
    """Phase 56: lint on the card (the reference's ``lint`` and
    ``lint --jaxpr`` without the CLI). Every shipped engine at its main
    path's size, ``lint="error"``: clean, its body traceable (no TW700),
    its off modes neutral (TW705 proven); the (code, severity) sets equal
    the same engines' at 2^12 on the CPU."""
    card = lint_engines(device, (SLICE_N, PRAOS_N, RING_N, STEADY_N))
    for name, r in card.items():
        say(f"lint {name}: n={r['n']} construction_lint_ms={r['lint_ms']} "
            f"body_scan_s={r['scan_s']} neutrality_proof_s={r['proof_s']} "
            f"codes={r['codes']}")
    _require_all("lint on the card", {
        f"{name}: no TW700, TW705 proven":
            not any(c == "TW700" for c, _ in r["codes"])
            and ("TW705", "info") in r["codes"]
            and not any(s == "error" for _, s in r["codes"])
        for name, r in card.items()})

    def check(card, cpu):
        _require_all("lint card vs CPU", {
            f"{name}: the card's codes = the CPU's at 2^12":
                card[name]["codes"] == cpu[name]["codes"]
            for name in card})
        say("lint card vs CPU: every engine's (code, severity) set equal")
    against_cpu("lint", card, check)


def bisect_wave(dev, n, budget=32, chunk=16, flip="flip:2:2:time"):
    """``bisect_engines`` on the gossip wave at ``n`` nodes: the clean run
    against itself (None), then against a run with ``flip`` injected at
    its chunk: the pinned line and its fields."""
    from timewarp_tpu_torch.integrity import FlipInjector
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.obs.bisect import bisect_engines
    sc, link = gossip_wave(n)

    def make(record="off"):
        return TorchEngine(sc, link, window="auto", record=record,
                           record_cap=1 << 14, lint="off", device=dev)
    same = bisect_engines(make, make, budget, chunk=chunk)
    rep = bisect_engines(make, make, budget, chunk=chunk,
                         names=("clean", "corrupt"),
                         inject_b=lambda: FlipInjector(flip), basis="state")
    return dict(same=same, line=rep.line(), chunk=rep.chunk,
                superstep=rep.superstep, fields=rep.fields,
                delta=rep.only_a + rep.only_b)


@cpu_leg("bisect")
def leg_bisect(dev, n=1 << 12):
    """Phase 57's leg: the flip's bisection at 2^12."""
    return bisect_wave(dev, n)


def oracle_vs_engine(dev, n=1024, steps=1 << 12):
    """The port's ``SuperstepOracle`` against ``TorchEngine`` on ``dev``,
    the gossip wave at ``n`` nodes to quiescence: trace rows, final states
    and wakes, and the never-silent counters."""
    import torch
    from timewarp_tpu_torch.interp.ref.superstep import SuperstepOracle
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    sc, link = gossip_wave(n)
    oracle = SuperstepOracle(sc, link, window="auto", device=dev)
    otr = oracle.run(steps)
    st, etr = TorchEngine(sc, link, window="auto", device=dev).run(steps)
    _same_traces("oracle vs TorchEngine", otr, etr)
    _require_all("oracle vs TorchEngine", {
        **{f"state {k} equal": torch.equal(v, st.states[k])
           for k, v in oracle.states.items()},
        "wake equal": oracle.wake == st.wake.tolist(),
        **{f"{c} equal": getattr(oracle, f"{c}_total") == int(
            getattr(st, c)) for c in ("overflow", "bad_dst", "short_delay",
                                      "fault_dropped")}})
    return len(otr), int(st.delivered)


def phase_bisect(device, n=SLICE_N):
    """Phase 57: ``bisect_engines`` on the card at full width (phase 4's
    gossip wave, 2^17 nodes, 32 supersteps in chunks of 16): the clean run
    against itself reports none; against a run with ``flip:2:2:time`` (a
    bit of the epoch flipped as chunk 1 starts, before superstep 16) the
    pinned line names chunk 1 and superstep 16; at 2^12 the card's line
    equals the CPU leg's. Then the oracle leg: the
    port's ``SuperstepOracle`` on the card = ``TorchEngine`` on the card
    at 1024 nodes. Returns the 2^17 bisection's K2/K1 launches (the main
    path's; the 2^12 comparison's and the oracle leg's are not summed)."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    torch.cuda.synchronize()
    ci.reset_launches()
    full, full_s = _timed(lambda: bisect_wave(device, n))
    torch.cuda.synchronize()
    launches = dict(ci.LAUNCHES)
    say(f"bisect n={n} wall_s={full_s}: {full['line']}")
    _require_all("bisect on the card", {
        "clean vs clean: none": full["same"] is None,
        "the flip's chunk (1) named": full["chunk"] == 1
        and "chunk 1 " in full["line"],
        "superstep 16 named": full["superstep"] == 16
        and "superstep 16 " in full["line"],
        "a field clause": bool(full["fields"]),
        "K2 = K1 > 0": launches["fire_compact"] == launches[
            "mailbox_insert"] > 0})
    small, small_s = _timed(lambda: bisect_wave(device, 1 << 12))
    say(f"bisect n=4096 wall_s={small_s}")

    def check(card, cpu):
        _require_all("bisect card vs CPU at 2^12", {
            "none on both": card["same"] is None and cpu["same"] is None,
            "the pinned lines equal": card["line"] == cpu["line"]})
        say(f"bisect card vs CPU at 2^12: equal lines: {card['line']}")
    against_cpu("bisect", small, check)
    ci.reset_launches()
    (steps, delivered), oracle_s = _timed(lambda: oracle_vs_engine(device))
    torch.cuda.synchronize()
    say(f"oracle vs TorchEngine on the card: gossip wave n=1024 "
        f"supersteps={steps} delivered={delivered} wall_s={oracle_s}: "
        f"traces, states, wakes "
        f"and counters equal; its TorchEngine's launches (not summed): "
        f"{dict(ci.LAUNCHES)}")
    say(f"bisect n={n} launches (summed): {launches}")
    return launches


def explain_world(dev, n, lead=55, span=8, node=3):
    """World 0 of phase 27's chaos fleet solo on ``dev``: ``lead``
    supersteps unrecorded, then ``span`` recorded in full (around node
    ``node``'s reset crash, 20-60 ms, under the partition): the
    ``FlightLog``, the first delivery to ``node`` whose chain names the
    crash window with its send recorded, that chain, and the recorded
    run's K2/K1 launches and supersteps."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.obs.query import (chain_lines, explain_delivery,
                                              find_deliveries)
    sc, link, spec, fleet, _ = chaos_fleet(n)
    sched = fleet.world_schedule(0)
    kw = dict(seed=spec.seeds[0], window="auto", faults=sched, lint="off",
              device=dev)
    held = TorchEngine(sc, link, **kw).run_quiet(lead)
    rec = TorchEngine(sc, link, record="full",
                      record_cap=1 << (4 * n).bit_length(), **kw)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    ci.reset_launches()
    _, tr = rec.run(span, state=held)
    if on_card:
        torch.cuda.synchronize()
    launches = dict(ci.LAUNCHES)
    log = rec.last_run_flight
    res = None
    for nth in range(len(find_deliveries(log, dst=node))):
        got = explain_delivery(log, dst=node, nth=nth, faults=sched)
        steps = [c["step"] for c in got["chain"]]
        if "crash_window" in steps and not got["chain"][0].get("unknown"):
            res = got
            break
    if res is None:
        raise AssertionError(f"explain: no recorded delivery to node "
                             f"{node} with its send and the crash window "
                             f"(n={n})")
    cols = {c: getattr(log, c) for c in ("superstep", "t_sup", "kind", "src",
                                         "dst", "send_t", "t", "tag")}
    return dict(cols=cols, dropped=log.dropped, chain=res["chain"],
                lines=chain_lines(res), launches=launches,
                supersteps=len(tr), n=n)


@cpu_leg("explain")
def leg_explain(dev, n=1 << 12):
    """Phase 58's leg: the recorded chaos world at 2^12."""
    return explain_world(dev, n)


def phase_explain(device, n=CHAOS_N):
    """Phase 58: explain a delivery at 100 000 nodes. World 0 of phase
    27's chaos fleet recorded in full on the card over 8 supersteps
    around node 3's reset crash: ``explain_delivery`` for a delivery to
    node 3 gives a well-formed chain (its send recorded and before the
    delivery, the crash window and the deferrals named, the delivery
    last); K2 and K1 launched once per recorded superstep. At 2^12 the
    card's ``FlightLog`` and chain equal the CPU leg's."""
    full = explain_world(device, n)
    chain = full["chain"]
    send, deliver = chain[0], chain[-1]
    kinds = [c["step"] for c in chain]
    say(f"explain n={n}: {full['supersteps']} recorded supersteps, "
        f"{len(full['cols']['kind'])} events, dropped {full['dropped']}; "
        f"launches={full['launches']}")
    for line in full["lines"]:
        say(f"  {line}")
    _require_all("explain on the card", {
        "the send first, recorded": send["step"] == "send"
        and not send.get("unknown"),
        "the send precedes its delivery": send["t_us"] < deliver["t_us"]
        <= deliver["consumed_t_us"],
        "the delivery last": deliver["step"] == "deliver",
        "the crash window named": "crash_window" in kinds,
        "K2 = K1 = the recorded supersteps":
            full["launches"]["fire_compact"] == full["launches"][
                "mailbox_insert"] == full["supersteps"]})
    small = explain_world(device, 1 << 12)

    def check(card, cpu):
        _require_all("explain card vs CPU at 2^12", {
            **{f"FlightLog {c} equal": np.array_equal(v, cpu["cols"][c])
               for c, v in card["cols"].items()},
            "dropped equal": card["dropped"] == cpu["dropped"],
            "chains equal": card["lines"] == cpu["lines"]
            and card["chain"] == cpu["chain"]})
        say(f"explain card vs CPU at 2^12: {len(card['cols']['kind'])} "
            "events and the chain equal")
    against_cpu("explain", small, check)
    return full["launches"]


def phase_profile_session(device, n=SLICE_N, steps=16):
    """Phase 59: ``obs.profiler.profile_session`` around 16 supersteps of
    the gossip wave at 2^17 (after 8 warm ones): the Chrome trace it
    writes parses and names K2 and K1 once per superstep."""
    import os

    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.obs.profiler import TRACE_FILE, profile_session
    sc, link = gossip_wave(n)
    eng = TorchEngine(sc, link, window="auto", insert_cap=SLICE_S,
                      device=device)
    st = eng.run_quiet(8)
    torch.cuda.synchronize()
    logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "profile-session")
    shutil.rmtree(logdir, ignore_errors=True)
    ci.reset_launches()
    with profile_session(logdir) as got:
        st = eng.run_quiet(steps, st)
        torch.cuda.synchronize()
    launches = dict(ci.LAUNCHES)
    path = os.path.join(logdir, TRACE_FILE)
    with open(path) as f:
        doc = json.load(f)
    size = os.path.getsize(path)
    shutil.rmtree(logdir, ignore_errors=True)
    names = [e.get("name", "") for e in doc.get("traceEvents", [])
             if e.get("cat") == "kernel"]
    counts = {k: sum(k in nm for nm in names)
              for k in ("fire_compact_kernel", "mailbox_insert_kernel")}
    say(f"profile session: {steps} supersteps, trace {size} bytes, "
        f"{len(names)} kernel events, {counts}, launches={launches}")
    _require_all("profile session", {
        "a session ran": got == logdir,
        **{f"{k} once per superstep": c == steps
           for k, c in counts.items()},
        "K2 = K1 = the supersteps": launches["fire_compact"]
        == launches["mailbox_insert"] == steps})
    return launches


# -- the command line: python -m timewarp_tpu_torch and its subcommands ----

#: phase 60's argv: phase 4's gossip wave as the CLI expresses it (the
#: gossip builder's default 5 ms think time; a quantized lognormal whose
#: 8 ms grid is the window, as phase 4's 8 ms floor is)
CLI_WAVE = ["gossip", "--nodes", str(SLICE_N), "--burst", "--fanout", "8",
            "--mailbox-cap", "16", "--end-us", "5000000", "--window",
            "auto", "--link", "quantize:8000:lognormal:20000:0.6",
            "--insert-cap", str(SLICE_S), "--steps", "1048576"]
#: phase 61's fused-sparse Praos at 2^20 (K3): phase 9's sizes as the CLI
#: expresses them (the builder's default slot length)
CLI_PRAOS = ["praos", "--engine", "fused-sparse", "--nodes", str(PRAOS_N),
             "--burst", "--fanout", "8", "--mailbox-cap", "16",
             "--slots", "1073741824", "--leader-prob", str(4.0 / PRAOS_N),
             "--window", "auto", "--link",
             "quantize:8000:lognormal:20000:0.6", "--max-batch",
             str(PRAOS_S), "--steps", "32"]
#: phase 61's chaos fleet: 8 worlds of 100 000 nodes of steady gossip
#: under world 0's schedule of :func:`chaos_fleet` (the CLI replicates one
#: schedule to every world)
CLI_CHAOS_FAULTS = ("crash:3:20ms:60ms:reset; crash:50005:30ms:70ms; "
                    "partition:0-49999|50000-99999:25ms:70ms; "
                    "degrade:all:all:80ms:120ms:2.0:0")
CLI_CHAOS = ["gossip", "--nodes", str(CHAOS_N), "--steady", "--fanout", "1",
             "--mailbox-cap", "8", "--end-us", "300000", "--batch",
             str(CHAOS_B), "--window", "auto", "--link",
             "quantize:1000:uniform:500:4500", "--faults", CLI_CHAOS_FAULTS]
CLI_CK = [x for i, x in enumerate(CLI_WAVE) if x != "--insert-cap"
          and CLI_WAVE[i - 1] != "--insert-cap" and x != "--steps"
          and CLI_WAVE[i - 1] != "--steps"]
#: phase 63's steady gossip at 2^20 (phase 21's shape, the builder's
#: default think time), a few supersteps
CLI_STEADY = ["gossip", "--nodes", str(STEADY_N), "--steady", "--fanout",
              "1", "--mailbox-cap", "8", "--end-us", "1125899906842624",
              "--link", "quantize:1000:uniform:500:4500", "--steps", "16",
              "--lint", "off"]


class _ThreadStdout:
    """``sys.stdout`` for :func:`_cli`: a thread's writes go to its capture
    buffer while it has one, every other write to the real stream, so that
    two threads can each run the CLI at once."""

    def __init__(self, real):
        self.real, self.bufs = real, {}

    def _out(self):
        import threading
        return self.bufs.get(threading.get_ident(), self.real)

    def write(self, s):
        return self._out().write(s)

    def flush(self):
        self._out().flush()

    def __getattr__(self, name):
        return getattr(self.real, name)


def _cli(argv):
    """``timewarp_tpu_torch.cli.main(argv)`` in this process (any thread):
    ``(exit code, the JSON lines it printed)``."""
    import io
    import threading

    from timewarp_tpu_torch.cli import main as cli_main
    if not isinstance(sys.stdout, _ThreadStdout):
        sys.stdout = _ThreadStdout(sys.stdout)
    me, buf = threading.get_ident(), io.StringIO()
    sys.stdout.bufs[me] = buf
    try:
        rc = cli_main(list(argv))
    except SystemExit as e:
        rc = e.code
    finally:
        del sys.stdout.bufs[me]
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    return rc, lines


def _summary_equal(what, got, want) -> None:
    """A CLI summary against a library run's fields (``device`` and the
    keys the library side does not name aside)."""
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        raise AssertionError(f"{what}: the CLI's summary differs from the "
                             f"library run's: {bad}")


def _library_summary(eng, fin, tr):
    """The run CLI's summary fields of a library run."""
    if isinstance(tr, list):
        return {"supersteps": [len(t) for t in tr],
                "delivered": [t.total_delivered() for t in tr],
                "overflow": fin.overflow.tolist(),
                "route_drop": fin.route_drop.tolist(),
                "fault_dropped": fin.fault_dropped.tolist(),
                "steps": fin.steps.tolist(),
                "virtual_time_us": fin.time.tolist()}
    return {"supersteps": len(tr), "delivered": tr.total_delivered(),
            "overflow": int(fin.overflow), "steps": int(fin.steps),
            "virtual_time_us": int(fin.time)}


def _trace_rows(tr):
    return [[str(v) for v in tr.row(i)] for i in range(len(tr))]


def phase_cli_start(device):
    """Phase 60, started: ``python -m timewarp_tpu_torch`` with
    :data:`CLI_WAVE` and no ``--device`` as a subprocess (``--timings``,
    ``--trace-csv``), beside this process's phases 61-64; then the library
    run of the same configuration, K2 = K1 = its supersteps. Returns what
    :func:`phase_cli_finish` needs and the library run's launches."""
    import os
    import tempfile

    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.net.links import parse_link
    d = tempfile.mkdtemp(prefix="cli-", dir=_scratch())
    csv_path = os.path.join(d, "trace.csv")
    log = open(os.path.join(d, "stderr.log"), "w")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "timewarp_tpu_torch", *CLI_WAVE,
         "--trace-csv", csv_path, "--timings"], cwd=here,
        stdout=subprocess.PIPE, stderr=log, text=True)
    sc = gossip(SLICE_N, fanout=8, end_us=5_000_000, burst=True,
                mailbox_cap=16)
    eng = TorchEngine(sc, parse_link("quantize:8000:lognormal:20000:0.6"),
                      window="auto", insert_cap=SLICE_S, device=device)
    torch.cuda.synchronize()
    ci.reset_launches()
    (fin, tr), wall = _timed(lambda: eng.run(1 << 20))
    launches = dict(ci.LAUNCHES)
    _require_all("phase 60's library run", {
        "K2 = K1 = its supersteps": launches["fire_compact"]
        == launches["mailbox_insert"] == len(tr)})
    say(f"cli wave (library run): n={SLICE_N} supersteps={len(tr)} "
        f"delivered={tr.total_delivered()} wall_s={wall} launches="
        f"{launches}")
    return (proc, log, t0, d, csv_path, _library_summary(eng, fin, tr),
            _trace_rows(tr)), launches


def phase_cli_finish(started):
    """Phase 60, collected: the subprocess exited 0, its summary names
    ``cuda`` and equals the library run's (supersteps, delivered, the
    counters, ``virtual_time_us``), its ``--trace-csv`` rows equal the
    library run's trace; its own wall (launch to its last lap) and split
    (interpreter start = main's entry less the launch, then set-up,
    construction lint, build, run, output)."""
    import csv

    proc, log, t0, d, csv_path, want, rows = started
    out, _ = proc.communicate(timeout=600)
    log.close()
    with open(log.name) as f:
        err = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"python -m timewarp_tpu_torch exited "
                             f"{proc.returncode}: {err[-4000:]}")
    summary = json.loads(out.strip().splitlines()[-1])
    laps = next(json.loads(x)["timings"] for x in err.splitlines()
                if x.startswith('{"timings"'))
    with open(csv_path) as f:
        got_rows = list(csv.reader(f))[1:]
    _require_all("python -m timewarp_tpu_torch", {
        "ran on cuda with no --device": summary["device"] == "cuda",
        "trace CSV = the library run's trace": got_rows == rows})
    _summary_equal("python -m timewarp_tpu_torch", summary, want)
    shutil.rmtree(d, ignore_errors=True)
    split = {"interpreter_start_s": laps["entry_epoch_s"] - t0,
             **{k: v for k, v in laps.items() if k != "entry_epoch_s"}}
    # the process's own wall: from its launch to its last lap (it is
    # collected after phase 64, long after it ended)
    wall = sum(split.values())
    say(f"python -m timewarp_tpu_torch {' '.join(CLI_WAVE)}: wall_s={wall} "
        f"split={split}; summary={summary} = the library run's, trace "
        "CSV equal")


def phase_cli_runs(device):
    """Phase 61: ``cli.main`` in this process on the card. Fused-sparse
    Praos at 2^20 (:data:`CLI_PRAOS`, K3 once a superstep) = the library
    run's 32 supersteps; the 8-world chaos fleet (:data:`CLI_CHAOS`,
    ``--batch 8 --faults``) over 64 supersteps = the library run's worlds
    (K2 = K1 = the fleet supersteps); 32 supersteps ``--save``d then 32
    ``--resume``d = the 64 straight, every leaf of the checkpoints equal.
    Returns the CLI runs' launches."""
    import os
    import tempfile

    import torch
    from timewarp_tpu_torch.faults.schedule import parse_faults
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.batched import BatchSpec
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.interp.torch_engine.fused_sparse import \
        FusedSparseEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.models.praos import praos
    from timewarp_tpu_torch.net.links import parse_link
    launches = {"fire_compact": 0, "mailbox_insert": 0, "sample_insert": 0}

    def cli(what, argv):
        torch.cuda.synchronize()
        ci.reset_launches()
        (rc, lines), wall = _timed(lambda: _cli(argv))
        got = dict(ci.LAUNCHES)
        for k in launches:
            launches[k] += got[k]
        if rc != 0:
            raise AssertionError(f"{what}: exit {rc}")
        say(f"cli {what}: wall_s={wall} launches={got}")
        return lines[-1], got

    sc = praos(PRAOS_N, n_slots=1 << 30, leader_prob=4.0 / PRAOS_N, fanout=8,
               burst=True, mailbox_cap=16)
    link = parse_link("quantize:8000:lognormal:20000:0.6")
    fin, tr = FusedSparseEngine(sc, link, window="auto", max_batch=PRAOS_S,
                                device=device).run(32)
    got, n = cli("praos fused-sparse", CLI_PRAOS)
    _summary_equal("cli praos fused-sparse", got, _library_summary(
        None, fin, tr))
    _require_all("cli praos fused-sparse", {
        "on cuda": got["device"] == "cuda",
        "K3 once a superstep": n["sample_insert"] == got["supersteps"]})

    d = tempfile.mkdtemp(prefix="cli-", dir=_scratch())
    ck = {k: os.path.join(d, f"{k}.npz") for k in ("half", "resumed",
                                                   "straight")}
    sc = gossip(CHAOS_N, fanout=1, end_us=300_000, steady=True,
                mailbox_cap=8)
    eng = TorchEngine(sc, parse_link("quantize:1000:uniform:500:4500"),
                      window="auto", batch=BatchSpec.of(CHAOS_B),
                      faults=parse_faults(CLI_CHAOS_FAULTS), device=device)
    fin, tr = eng.run(64)
    straight, n = cli("chaos fleet", CLI_CHAOS + ["--steps", "64", "--save",
                                                  ck["straight"]])
    _summary_equal("cli chaos fleet", straight, _library_summary(
        eng, fin, tr))
    _require_all("cli chaos fleet", {
        "K2 = K1 = the fleet supersteps": n["fire_compact"]
        == n["mailbox_insert"] == eng.last_run_stats["fleet_supersteps"]})
    half, _ = cli("chaos --save", CLI_CHAOS + ["--steps", "32", "--save",
                                               ck["half"]])
    resumed, _ = cli("chaos --resume", CLI_CHAOS + [
        "--steps", "32", "--resume", ck["half"], "--save", ck["resumed"]])
    a, b = (dict(np.load(ck[k])) for k in ("resumed", "straight"))
    _require_all("cli --save/--resume", {
        "the same leaves": sorted(a) == sorted(b),
        **{f"leaf {k} equal": np.array_equal(a[k], b[k]) for k in b},
        "steps compose": resumed["steps"] == straight["steps"],
        "delivered compose": [x + y for x, y in zip(
            half["delivered"], resumed["delivered"])]
        == straight["delivered"]})
    shutil.rmtree(d, ignore_errors=True)
    say(f"cli runs: praos {got['supersteps']} supersteps = the library "
        f"run's; chaos fleet {straight['supersteps']} = the library run's "
        f"worlds; 32 + 32 resumed = 64 straight, {len(b)} leaves equal; "
        f"launches={launches}")
    return launches


def _cli_pack():
    """Phase 62's pack: two 2048-node token rings, budget 48."""
    ring = {"nodes": 2048, "n_tokens": 64, "think_us": 2000,
            "bootstrap_us": 1000, "end_us": 1 << 40, "mailbox_cap": 8}
    return [{"id": f"w{i}", "scenario": "token-ring", "params": ring,
             "link": "uniform:1000:5000", "seed": s, "budget": 48}
            for i, s in enumerate((0, 3))]


@cpu_leg("cli_sweep")
def leg_cli_sweep(dev):
    """Phase 62's sweep through the CLI on ``dev``: ``sweep run --verify``
    with a flip at chunk call 2 and a kill at call 3, ``sweep status``,
    ``sweep resume --verify`` (whose auto-bisect names the flip's chunk);
    the lines and the journal's records (wall-clock fields and heartbeats
    aside)."""
    import os
    import tempfile

    import torch
    dflag = ["--device", "cpu"] if torch.device(dev).type == "cpu" else []
    d = tempfile.mkdtemp(prefix="cli-sweep-", dir=_scratch())
    pack, jd = os.path.join(d, "pack.json"), os.path.join(d, "j")
    with open(pack, "w") as f:
        json.dump(_cli_pack(), f)
    common = ["--journal", jd, "--chunk", "8", "--lint", "off", "--verify"]
    run = _cli(["sweep", "run", pack, *common, "--inject",
                "flip:2:2:time;die:3", *dflag])
    status = _cli(["sweep", "status", "--journal", jd])
    resume = _cli(["sweep", "resume", *common, *dflag])
    from timewarp_tpu_torch.sweep import SweepJournal
    records = [{k: v for k, v in e.items() if k not in ("ts", "seq", "wall_s")}
               for e in SweepJournal(jd).records()
               if e.get("ev") != "host_heartbeat"]
    return dict(run=run, status=status, resume=resume, records=records,
                dir=d, jd=jd)


def _strip_wall(x):
    if isinstance(x, dict):
        return {k: _strip_wall(v) for k, v in x.items()
                if k not in ("wall_s", "wall_seconds", "ts", "compiles")}
    if isinstance(x, list):
        return [_strip_wall(v) for v in x]
    return x


def phase_cli_services(device):
    """Phase 62: the service subcommands on the card. ``sweep run`` (flip
    at chunk call 2, kill at 3: exit 1, killed) -> ``sweep status`` ->
    ``sweep resume --verify`` (exit 1: the flipped world's auto-bisect
    names chunk 1, supersteps 8..16); K1 once a superstep of every bucket
    run call, K2 as often on the adaptive regime's; the lines and journal
    = the CPU leg's. ``search run`` with
    ``bench.py`` ``search_gossip``'s campaign = phase 46's result
    (:data:`SEARCH_REF`), ``search repro`` reproduces; ``ledger add`` of
    the sweep's journal and ``pack fit`` over it; ``serve`` (a thread)
    and one ``submit --verify --drain`` over loopback. Returns the
    launches of the sweep, the search and the served bucket."""
    import os
    import socket
    import tempfile
    import threading

    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    launches = {"fire_compact": 0, "mailbox_insert": 0}

    def counted(fn):
        torch.cuda.synchronize()
        ci.reset_launches()
        try:
            return _timed(fn)
        finally:
            for k in launches:
                launches[k] += ci.LAUNCHES[k]

    with BucketRecorder() as rec:
        card, wall = counted(lambda: leg_cli_sweep(device))
    rc_run, out_run = card["run"]
    rc_res, out_res = card["resume"]
    mism = out_res[-1].get("verify_mismatches", [])
    rec.check("cli sweep")
    _require_all("cli sweep", {
        "run: exit 1, killed": rc_run == 1
        and out_run[-1].get("sweep") == "killed",
        "status: exit 0": card["status"][0] == 0,
        "resume: exit 1 on the flip": rc_res == 1,
        "the flipped world's auto-bisect names chunk 1, supersteps 8..16":
            len(mism) >= 1 and all(
                m["first_divergence"]["chunk"] == 1
                and m["first_divergence"]["supersteps"] == [8, 16]
                for m in mism)})
    say(f"cli sweep: wall_s={wall} run={out_run[-1]} status="
        f"{card['status'][1][-1]} first_divergence="
        f"{[m['first_divergence'] for m in mism]}")

    def check(card, cpu):
        _require_all("cli sweep card vs CPU", {
            f"{k} equal": _strip_wall(card[k]) == _strip_wall(cpu[k])
            for k in ("run", "status", "resume", "records")})
        say(f"cli sweep card vs CPU: lines, auto-bisects and "
            f"{len(card['records'])} journal records equal")
        shutil.rmtree(cpu["dir"], ignore_errors=True)
    against_cpu("cli_sweep", card, check)

    d = tempfile.mkdtemp(prefix="cli-svc-", dir=_scratch())
    base = search_base()
    search = ["search", "run", "gossip", "--params",
              json.dumps(dict(base.params)), "--link", base.link,
              "--seed", "0", "--window", "auto", "--budget",
              str(base.budget), "--objective", "eventually-delivered",
              "--population", "8", "--generations", "6", "--search-seed",
              "2", "--fork", "2", "--journal", os.path.join(d, "s")]
    (rc, lines), swall = counted(lambda: _cli(search))
    got = {k: v for k, v in lines[-1].items() if k != "repro_path"}
    rc_repro, repro = _cli(["search", "repro",
                            os.path.join(d, "s", "repro.json")])
    _require_all("cli search", {
        "exit 0 (found)": rc == 0,
        f"result {got} = phase 46's": got == SEARCH_REF,
        "repro reproduces": rc_repro == 0 and repro[-1]["reproduced"]})
    led = os.path.join(d, "led")
    rc_add, _ = _cli(["ledger", "add", card["jd"], "--ledger", led])
    rc_fit, fit = _cli(["pack", "fit", "--ledger", led])
    _require_all("cli pack fit", {
        "ledger add: exit 0": rc_add == 0,
        "fit: exit 0, a row per world": rc_fit == 0
        and fit[-1]["rows"] == 2})
    say(f"cli search: wall_s={swall} {got}; pack fit: {fit[-1]}")
    shutil.rmtree(card["dir"], ignore_errors=True)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = os.path.join(d, "cfgs.json")
    with open(cfg, "w") as f:
        json.dump(_cli_pack()[:1], f)
    from timewarp_tpu_torch.cli import main as cli_main
    from timewarp_tpu_torch.sweep import SweepJournal
    box = {}
    # the serve thread prints to this process's stdout (only one thread
    # may capture it); its exit code and journal are checked
    serve = threading.Thread(target=lambda: box.setdefault("rc", cli_main([
        "serve", "--journal", os.path.join(d, "sj"), "--hosts", "alpha",
        "--listen", f"127.0.0.1:{port}", "--slots", "2", "--chunk", "16",
        "--poll-s", "0.05", "--max-seconds", "300"])), daemon=True)
    t0 = time.perf_counter()
    with BucketRecorder() as srec:
        serve.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with socket.socket() as s:
                if s.connect_ex(("127.0.0.1", port)) == 0:
                    break
            time.sleep(0.05)
        rc_sub, sub = counted(lambda: _cli([
            "submit", cfg, "--connect", f"127.0.0.1:{port}", "--verify",
            "--drain"]))[0]
        serve.join(timeout=120)
    final = [x for x in sub if "streamed" in x]
    evs = [e.get("ev") for e in SweepJournal(os.path.join(d, "sj")).records()]
    srec.check("cli serve")
    _require_all("cli serve + submit", {
        "serve: exit 0, drained": not serve.is_alive()
        and box.get("rc") == 0,
        "one admit, one world_done journaled": evs.count("admit")
        == evs.count("world_done") == 1,
        "submit --verify: exit 0, the streamed result = its solo run":
            rc_sub == 0 and final and final[-1]["verified"] == 1})
    say(f"cli serve + submit: wall_s={time.perf_counter() - t0} "
        f"submit={final[-1]}; launches={launches}")
    shutil.rmtree(d, ignore_errors=True)
    return launches


def phase_cli_sharded_start(device):
    """Phase 63, started: ``--engine sharded --devices 2`` (two gloo ranks
    sharing the card, spawned by the CLI; :data:`CLI_STEADY`) in a thread
    beside phases 61 and 62 (the ranks' launches are theirs, not this
    process's counts)."""
    import threading
    box = {}

    def run():
        t0 = time.perf_counter()
        box["out"] = _cli(CLI_STEADY + ["--engine", "sharded",
                                        "--devices", "2"])
        box["wall"] = time.perf_counter() - t0
    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, box


def phase_cli_sharded(device, started):
    """Phase 63: steady gossip at 2^20 for 16 supersteps through the CLI
    on one device (K1 once a superstep); then the sharded run started
    beside phases 61 and 62: rank 0's summary = the one device's."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    torch.cuda.synchronize()
    ci.reset_launches()
    (rc1, one), wall1 = _timed(lambda: _cli(CLI_STEADY))
    n = dict(ci.LAUNCHES)
    th, box = started
    th.join(timeout=900)
    if "out" not in box:
        raise AssertionError("the sharded CLI run did not finish")
    (rc2, two), wall2 = box["out"], box["wall"]
    a = {k: v for k, v in one[-1].items() if k not in ("device", "engine")}
    b = {k: v for k, v in two[-1].items() if k not in ("device", "engine")}
    _require_all("cli sharded", {
        "both exit 0": rc1 == rc2 == 0,
        "the sharded summary = one device's": a == b,
        "ranks on the card": two[-1]["device"].startswith("cuda"),
        "one device: K1 once a superstep": n["mailbox_insert"]
        == one[-1]["supersteps"]})
    say(f"cli sharded --devices 2: wall_s={wall2} (one device "
        f"{wall1}); summary={b} = one device's")
    return n


def phase_cross_world(device):
    """Phase 64: the cross-world law on the card. The port's
    ``token_ring_net`` (64 nodes and the observer, fixed hops, 22 s) and
    ``gossip_net`` (16 nodes, a seeded (dst, t)-keyed link) under the
    port's DES give the event streams of their batched twins on
    ``TorchEngine`` on the card (``record_events``), µs for µs; K1 once a
    superstep, K2 as often on the adaptive path (the gossip's; the ring's
    window-1 single-send supersteps take the eager one)."""
    import torch
    from timewarp_tpu_torch.interp.ref.des import run_emulation
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    from timewarp_tpu_torch.models.gossip import gossip
    from timewarp_tpu_torch.models.gossip_net import (gossip_net,
                                                      gossip_net_ports)
    from timewarp_tpu_torch.models.token_ring import token_ring
    from timewarp_tpu_torch.models.token_ring_net import (OBSERVER_PORT,
                                                          token_ring_net)
    from timewarp_tpu_torch.net.backend import EmulatedBackend, endpoint_id
    from timewarp_tpu_torch.net.delays import (FixedDelay, FnDelay,
                                               SeededHashUniform)
    N, B, D, O, THINK, DUR = 64, 1_000_000, 2_000, 1_000, 3_000_000, 22_000_000
    obs = endpoint_id(f"127.0.0.1:{OBSERVER_PORT}")

    def fixed(o, d, observer):
        def fn(src, dst, t, key):
            hit = ((dst & 0xFFFFFFFF) == obs) if observer is None \
                else (dst == observer)
            dl = torch.where(hit, torch.full_like(dst, o, dtype=torch.int64),
                             torch.full_like(dst, d, dtype=torch.int64))
            return dl, torch.zeros_like(dl, dtype=torch.bool)
        return FnDelay(fn)
    launches = {"fire_compact": 0, "mailbox_insert": 0}

    def engine_events(sc, link, steps):
        eng = TorchEngine(sc, link, record_events=1 << 14, device=device)
        torch.cuda.synchronize()
        ci.reset_launches()
        st, tr = eng.run(steps)
        torch.cuda.synchronize()
        for k in launches:
            launches[k] += ci.LAUNCHES[k]
        _require_all("cross world engine", {
            "K1 = its supersteps, K2 as many on the adaptive path (else 0)":
                ci.LAUNCHES["mailbox_insert"] == len(tr)
                and ci.LAUNCHES["fire_compact"] == len(tr) * eng.adaptive,
            "no overflow": int(st.overflow) == 0})
        events, dropped = eng.events(st)
        _require_all("cross world events", {"none dropped": dropped == 0})
        return [e for e in events if e[0] == "recv"], len(tr)

    receipts = []
    notes, errors = run_emulation(token_ring_net(
        EmulatedBackend(fixed(O, D, None), seed=0), N, duration_us=DUR,
        passing_delay_us=THINK, bootstrap_us=B, prewarm=True,
        bootstrap_at=True, receipts=receipts))
    recvs, ring_steps = engine_events(
        token_ring(N, think_us=THINK + O + D, bootstrap_us=B, end_us=DUR),
        fixed(O, D, N), 800)
    ring = ([(t, i + 1, p) for (_, t, i, s, p) in recvs
             if i != N and t < DUR],
            [(t, p) for (_, t, i, s, p) in recvs if i == N and t < DUR])
    rnd = SeededHashUniform(3_000, 9_000, 7)
    got = []
    run_emulation(gossip_net(
        EmulatedBackend(rnd, connect_delays=FixedDelay(500), seed=0,
                        endpoint_ids=gossip_net_ports(16)),
        16, fanout=4, think_us=700, bootstrap_us=100_000,
        duration_us=900_000, prewarm=True, receipts=got))
    grecvs, gossip_steps = engine_events(
        gossip(16, fanout=4, think_us=700, burst=True,
               bootstrap_us=100_000, end_us=900_000, mailbox_cap=16),
        rnd, 4000)
    _require_all("cross world on the card", {
        "token ring: no errors, >= 6 notes": errors == [] and len(notes) >= 6,
        "token ring receipts and notes = the engine's": ring
        == (receipts, notes),
        "gossip deliveries = the engine's": sorted(
            (t, i) for t, i in got if t < 900_000) == sorted(
            (t, i) for (_, t, i, s, p) in grecvs if t < 900_000),
        "the wave spread": len(grecvs) >= 16})
    say(f"cross world on the card: token ring {len(receipts)} receipts and "
        f"{len(notes)} notes in {ring_steps} supersteps, gossip "
        f"{len(grecvs)} deliveries in {gossip_steps} supersteps = the net "
        f"twins' under the DES; launches={launches}")
    return launches


#: phase 65's parity rows and the columns each runs beside its main one
PARITY_ROWS = (("gossip-1024-burst-windowed", ("fused_sparse", "batched")),
               ("gossip-64-drop", ("faulted",)))
#: phase 65's engine examples (``examples/torch/``), each with its argv
ENGINE_EXAMPLES = (("chaos.py",), ("cross_world.py", "--nodes", "12"),
                   ("token_ring.py", "--engine", "--nodes", "8"))


def _parity_tool():
    """``tools/parity_cuda.py`` as a module."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "parity_cuda.py")
    spec = importlib.util.spec_from_file_location("parity_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples(device):
    """Each of :data:`ENGINE_EXAMPLES`' ``main`` in this process with
    ``--device device``: ``{argv: (exit code, stdout)}``."""
    import contextlib
    import io
    import os
    import runpy
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "torch")
    out = {}
    for script, *argv in ENGINE_EXAMPLES:
        main = runpy.run_path(os.path.join(here, script))["main"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([*argv, "--device", str(device)])
        out[" ".join((script, *argv))] = (rc, buf.getvalue())
    return out


@cpu_leg("examples")
def leg_examples(dev):
    """Phase 65's leg: the engine examples on the CPU."""
    return run_examples(dev)


def phase_parity_examples(device):
    """Phase 65: the parity artifact's rows and the engine examples on the
    card (module docstring). Returns K1-K3's launches of the phase."""
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    tool = _parity_tool()
    torch.cuda.synchronize()
    ci.reset_launches()
    rows = {name: tool.run_row(name, device, columns=cols)
            for name, cols in PARITY_ROWS}
    torch.cuda.synchronize()
    launches = {k: ci.LAUNCHES[k] for k in tool.KERNELS}
    for name, e in rows.items():
        say(f"parity {name}: {e['supersteps']} supersteps, {e['delivered']} "
            f"delivered, wall_s={e['wall_s']} oracle_wall_s="
            f"{e['oracle_wall_s']} launches={e['launches']}")
    wave, drop = (rows[name] for name, _ in PARITY_ROWS)
    lw, ld = wave["launches"], drop["launches"]
    _require_all("parity rows on the card", {
        **{f"{name}: the oracle = the engines, every column": tool.row_ok(e)
           for name, e in rows.items()},
        **{f"{name}: = PARITY_TPU.json": "reference_mismatch" not in e
           for name, e in rows.items()},
        "wave: K2 = K1 = its supersteps (adaptive)":
            lw["main"]["fire_compact"] == lw["main"]["mailbox_insert"]
            == wave["supersteps"],
        "wave: K3 = its supersteps (fused)":
            lw["fused_sparse"]["sample_insert"] == wave["supersteps"],
        "wave: K2 = K1 > 0 across the worlds":
            lw["batched"]["fire_compact"] == lw["batched"]["mailbox_insert"]
            > 0,
        "drop: K1 = its supersteps, K2 0 (eager)":
            ld["main"]["mailbox_insert"] == drop["supersteps"]
            and ld["main"]["fire_compact"] == 0,
        "drop: K1 > 0, K2 0 under faults":
            ld["faulted"]["mailbox_insert"] > 0
            and ld["faulted"]["fire_compact"] == 0,
        "K1, K2 and K3 each launched": all(launches.values()),
        "the rows' counts are the phase's": launches == {
            k: sum(c[k] for e in rows.values()
                   for c in e["launches"].values()) for k in launches}})

    ci.reset_launches()
    card = run_examples(device)
    torch.cuda.synchronize()
    for k in launches:
        launches[k] += ci.LAUNCHES[k]
    _require_all("examples on the card", {
        f"{argv}: exit 0": rc == 0 for argv, (rc, _) in card.items()})
    _require_all("examples launched K1", {
        "K1 > 0": ci.LAUNCHES["mailbox_insert"] > 0})

    def check(card, cpu):
        _require_all("examples: card vs CPU", {
            f"{argv}: stdout = the CPU's": card[argv] == cpu[argv]
            for argv in cpu})
        for argv, (_, out) in card.items():
            say(f"example {argv} on the card = its CPU run: "
                f"{out.splitlines()[0]}")
    against_cpu("examples", card, check)
    say(f"parity and examples: launches={launches}")
    return launches


#: phase 66's configs of ``bench_cuda.py --smoke``: K4; K2 and K1; K3; K2
#: and K1 across the world axis
BENCH_SMOKE = ("token_ring_dense", "gossip_100k_insert", "praos_1m_fused",
               "gossip_100k_chaos")
#: the keys of a ``bench_cuda.py --smoke`` line, beside a config's own
BENCH_SMOKE_KEYS = {"config", "config_key", "metric", "smoke", "ok",
                    "seconds", "schema", "platform", "device_kind",
                    "torch_version", "power_limit", "git_sha"}


def phase_bench_smoke(device):
    """Phase 66: ``bench_cuda.py --smoke`` for :data:`BENCH_SMOKE` on the
    card, in this process (module docstring). Returns K1-K4's launches of
    the configs' runs: the insert gate's comparisons and timings
    (``bench_cuda.CHECK_LAUNCHES``) are taken out."""
    import contextlib
    import io
    import os

    import bench_cuda
    import torch
    from timewarp_tpu_torch.interp.torch_engine import cuda_insert as ci
    checks = dict(bench_cuda.CHECK_LAUNCHES)
    prior = os.environ.get("TW_BENCH_CONFIG")
    os.environ["TW_BENCH_CONFIG"] = ",".join(BENCH_SMOKE)
    buf = io.StringIO()
    torch.cuda.synchronize()
    ci.reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            bench_cuda.main(["--smoke", "--device", str(device.type)])
    finally:
        if prior is None:
            del os.environ["TW_BENCH_CONFIG"]
        else:
            os.environ["TW_BENCH_CONFIG"] = prior
    torch.cuda.synchronize()
    launches = {k: ci.LAUNCHES[k] - bench_cuda.CHECK_LAUNCHES.get(k, 0)
                + checks.get(k, 0) for k in ci.LAUNCHES}
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    limit = bench_cuda.power_limit()
    kind = torch.cuda.get_device_name(0)
    for ln in lines:
        own = {k: v for k, v in ln.items() if k not in BENCH_SMOKE_KEYS}
        say(f"bench_cuda --smoke {ln['config']}: seconds={ln['seconds']} "
            f"{ln['metric']} power_limit={ln['power_limit']} "
            f"{json.dumps(own)}")
    _require_all("bench_cuda --smoke", {
        "one line a config": [ln["config"] for ln in lines]
        == list(BENCH_SMOKE),
        **{f"{ln['config']}: the line's keys, ok, platform cuda, "
           f"{kind}, {limit}":
           BENCH_SMOKE_KEYS <= set(ln) and ln["ok"] is True
           and ln["smoke"] is True and ln["platform"] == "cuda"
           and ln["config_key"].endswith("|cuda")
           and ln["device_kind"] == kind and ln["power_limit"] == limit
           for ln in lines},
        "K1, K2, K3 and K4 each launched": all(launches.values()),
        "the insert gate's checks counted apart":
            bench_cuda.CHECK_LAUNCHES["fire_compact"]
            > checks["fire_compact"]})
    say(f"bench_cuda --smoke: launches={launches} (the insert gate's "
        f"comparisons and timings apart: "
        f"{ {k: bench_cuda.CHECK_LAUNCHES[k] - checks[k] for k in checks} })")
    return launches


def _multichip_tool():
    """``tools/multichip_cuda.py`` as the module ``multichip_cuda`` (its
    directory on ``sys.path``, so that the ranks import it by name)."""
    import importlib
    import os
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module("multichip_cuda")


def phase_multichip_dryrun(device):
    """Phase 67: the multichip tool's rows 1-3 in one NCCL rank on the
    card against their one-device runs (module docstring), unprofiled (a
    rank's first profile costs about 10 s; the tool profiles). Returns
    K1-K4's launches of the rank's sharded runs."""
    tool = _multichip_tool()
    res, solo = tool.run_dryrun_rows(device, 1, "nccl", profile=False)
    launches = {k: sum(r[0]["launches"][k] for r in res.values())
                for k in res[1][0]["launches"]}
    for row, per in res.items():
        g = per[0]
        say(f"phase 67: row {row} {tool.ROWS[row]} in one NCCL rank on "
            f"cuda:0 = one device ({len(solo[row])} supersteps, "
            f"delivered={solo[row].total_delivered()}); wall_ms_per_superstep"
            f"={g['wall'] / max(g['steps'], 1) * 1e3} exchange_share="
            f"{g['exchange_s'] / g['wall']} reduce_share="
            f"{g['reduce_s'] / g['wall']} (idle share: the tool's, not "
            f"profiled here); launches={g['launches']}")
    _require_all("phase 67", {"K1 launched": launches["mailbox_insert"]
                              > 0})
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from timewarp_tpu_torch.utils import build
    global LEGS
    t_start = time.perf_counter()
    LEGS = CpuLegs()
    try:
        return run_phases(torch, build, t_start)
    finally:
        LEGS.stop()


def run_phases(torch, build, t_start) -> int:
    device = torch.device("cuda")
    smi = nvidia_smi()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    records = build.build_all()
    say(f"build: {time.perf_counter() - t0:.3f} s wall")
    for name, rec in records.items():
        regs = [ln.strip() for ln in rec.ptxas.splitlines()
                if "registers" in ln or "spill" in ln]
        say(f"build {name}: nvcc_s={rec.seconds:.3f} lib={rec.path} "
            f"ptxas={regs}")

    def timed(phase, fn, *a, **kw):
        out, wall = _timed(lambda: fn(*a, **kw))
        say(f"phase {phase} wall_s={wall}")
        LEGS.drain()
        return out

    err_k2 = timed(2, phase_compact, device)
    err_k1 = timed(3, phase_insert, device)
    launches, steps, gossip_fin = timed(4, phase_main_path, device)
    timed(5, phase_card_vs_cpu, device)
    k2, k1 = timed(6, phase_times, device)
    from timewarp_tpu_torch.interp.torch_engine.engine import TorchEngine
    sc, link = gossip_wave(SLICE_N)
    timed(7, phase_where_time_goes,
          "gossip wave (TorchEngine)",
          TorchEngine(sc, link, window="auto", insert_cap=SLICE_S,
                      device=device), warm=30, steps=10)

    k3_inputs = sample_inputs(device)
    err_k3 = timed(8, phase_sample_insert, device, k3_inputs)
    praos_launches, praos_eng = timed(9, phase_praos_main_path, device)
    launches["sample_insert"] = praos_launches["sample_insert"]
    timed(10, phase_fused_equals_general, device)
    timed(11, phase_fused_card_vs_cpu, device)
    timed(12, phase_fused_gossip, device, gossip_fin)
    k3 = timed(13, phase_time_k3, device, k3_inputs)
    timed(14, phase_where_time_goes, "praos (FusedSparseEngine)", praos_eng,
          warm=16, steps=32)

    err_k4 = timed(15, phase_fused_ring_kernel, device)
    ring_launches, ring_eng, ring_fin = timed(16, phase_ring_main_path,
                                              device)
    launches["fused_ring"] = ring_launches["fused_ring"]
    timed(17, phase_fused_ring_equals_edge, device)
    timed(18, phase_edge_card_vs_cpu, device)
    k4 = timed(19, phase_time_k4, device, ring_fin.planes)
    from timewarp_tpu_torch.interp.torch_engine.edge_engine import EdgeEngine

    def ring_profiles():
        phase_where_time_goes("dense ring (FusedRingEngine)", ring_eng,
                              warm=16, steps=256)
        phase_where_time_goes("dense ring (EdgeEngine)",
                              EdgeEngine(*dense_ring(RING_N), device=device),
                              warm=16, steps=32)
    timed(20, ring_profiles)

    steady_launches, steady_eng, steady_fin = timed(
        21, phase_steady_main_path, device)
    launches["mailbox_insert"] += steady_launches["mailbox_insert"]
    timed(22, phase_eager_equals_lazy, device)
    timed(23, phase_routing_card_vs_cpu, device)
    err_k1_eager, _ = timed(24, phase_k1_eager, device, steady_eng,
                            steady_fin)
    err_k1 = max(err_k1, err_k1_eager)
    timed(25, phase_where_time_goes, "steady gossip (TorchEngine, eager)",
          steady_eng, warm=64, steps=32)

    err_k2_fleet, err_k1_fleet = timed(26, phase_fleet_kernels, device)
    chaos_launches, chaos_eng, chaos_fin = timed(27, phase_chaos_main_path,
                                                 device)
    for k in ("fire_compact", "mailbox_insert"):
        launches[k] += chaos_launches[k]
    timed(28, phase_fleet_card_vs_cpu, device)
    timed(29, phase_fleet_checkpoint, device, chaos_eng)
    err_fleet, _, _ = timed(30, phase_fleet_times, device, chaos_eng,
                            chaos_eng.run_quiet(96))
    timed(31, phase_where_time_goes, "chaos fleet (TorchEngine, B 8, faults)",
          chaos_eng, warm=96, steps=32)
    err_k2 = max(err_k2, err_k2_fleet, err_fleet)
    err_k1 = max(err_k1, err_k1_fleet, err_fleet)

    timed(32, phase_verified_wave, device)
    timed(33, phase_flight_wave, device)
    planes_launches, _ = timed(34, phase_planes_main_path, device, chaos_fin)
    for k in ("fire_compact", "mailbox_insert"):
        launches[k] += planes_launches[k]
    timed(35, phase_controlled, device)
    timed(36, phase_planes_card_vs_cpu, device)
    timed(37, phase_planes_times, device, chaos_eng)

    spec_launches, spec_eng, cons_eng, spec_errs, wide = timed(
        38, phase_spec_main_path, device)
    fleet_launches, fleet_errs = timed(39, phase_spec_fleet, device)
    for k in ("fire_compact", "mailbox_insert"):
        launches[k] += spec_launches[k] + fleet_launches[k]
    err_k2 = max(err_k2, spec_errs[0], fleet_errs[0])
    err_k1 = max(err_k1, spec_errs[1], fleet_errs[1])
    timed(40, phase_spec_card_vs_cpu, device)
    timed(41, phase_spec_times, device, spec_eng, cons_eng, wide)

    hetero_launches, hetero_keep = timed(42, phase_sweep_hetero, device)
    with LintClock() as lint43:
        pack_launches, pack_errs, pack, pack_wall, pack_util, pack_want = \
            timed(43, phase_chaos_pack, device, chaos_eng)
    say(lint43.line("phase 43 split"))
    for k in ("fire_compact", "mailbox_insert"):
        launches[k] += hetero_launches[k] + pack_launches[k]
    err_k2 = max(err_k2, pack_errs[0])
    err_k1 = max(err_k1, pack_errs[1])
    timed(44, phase_sweep_card_vs_cpu, device)
    timed(45, phase_sweep_cost, device, pack, pack_wall, pack_util)

    search_launches, search_jd = timed(46, phase_search_gossip, device)
    fork_launches, fork_errs, _ = timed(47, phase_fork_law, device)
    csearch_launches = timed(48, phase_search_chaos, device,
                           (search_jd,) + hetero_keep)
    for k in ("fire_compact", "mailbox_insert"):
        launches[k] += (search_launches[k] + fork_launches[k]
                        + csearch_launches[k])
    err_k2 = max(err_k2, fork_errs[0])
    err_k1 = max(err_k1, fork_errs[1])

    serve_launches, serve_want = timed(49, phase_serve_gossip, device)
    served_launches, served_errs = timed(50, phase_served_chaos, device,
                                         pack_want, pack_wall)
    wire_launches = timed(51, phase_serve_wire, device, serve_want)
    for k in ("fire_compact", "mailbox_insert"):
        launches[k] += (serve_launches[k] + served_launches[k]
                        + wire_launches[k])
    err_k2 = max(err_k2, served_errs[0])
    err_k1 = max(err_k1, served_errs[1])

    k1p, k1p_launches, shard_fleet_launches, _ = phase_sharded(device,
                                                               chaos_fin)
    for k in ("fire_compact", "mailbox_insert"):
        launches[k] += shard_fleet_launches[k]

    timed(56, phase_lint, device)
    bisect_launches = timed(57, phase_bisect, device)
    explain_launches = timed(58, phase_explain, device)
    profile_launches = timed(59, phase_profile_session, device)
    for k in ("fire_compact", "mailbox_insert"):
        launches[k] += (bisect_launches[k] + explain_launches[k]
                        + profile_launches[k])

    started, wave_launches = timed(60, phase_cli_start, device)
    sharded = timed("63 (started)", phase_cli_sharded_start, device)
    cli_launches = timed(61, phase_cli_runs, device)
    svc_launches = timed(62, phase_cli_services, device)
    shard_launches = timed(63, phase_cli_sharded, device, sharded)
    world_launches = timed(64, phase_cross_world, device)
    timed("60 (collected)", phase_cli_finish, started)
    parity_launches = timed(65, phase_parity_examples, device)
    launches["sample_insert"] += parity_launches["sample_insert"]
    launches["sample_insert"] += cli_launches["sample_insert"]
    for k in ("fire_compact", "mailbox_insert"):
        launches[k] += (wave_launches[k] + cli_launches[k] + svc_launches[k]
                        + shard_launches[k] + world_launches[k]
                        + parity_launches[k])
    bench_launches = timed(66, phase_bench_smoke, device)
    for k in launches:
        launches[k] += bench_launches[k]
    nccl_launches = timed(67, phase_multichip_dryrun, device)
    for k in launches:
        launches[k] += nccl_launches[k]

    LEGS.drain(wait=True)
    say(f"chip_smoke wall_s={time.perf_counter() - t_start}")
    kernels = []
    for name, src, repl, err, r in (
            ("fire_compact", "timewarp_tpu_torch/csrc/fire_compact.cu",
             K2_REPLACES, err_k2, k2),
            ("mailbox_insert", "timewarp_tpu_torch/csrc/mailbox_insert.cu",
             K1_REPLACES, err_k1, k1),
            ("sample_insert", "timewarp_tpu_torch/csrc/sample_insert.cu",
             K3_REPLACES, err_k3, k3),
            ("fused_ring", "timewarp_tpu_torch/csrc/fused_ring.cu",
             K4_REPLACES, err_k4, k4)):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"), "library_ms": None})
    kernels.append({
        "name": "mailbox_insert_per_shard", "route": "cuda",
        "source": "timewarp_tpu_torch/csrc/mailbox_insert.cu",
        "replaces": K1P_REPLACES, "launches": k1p_launches,
        "max_abs_err": k1p["err"], "ms": k1p["ms"],
        "plain_ms": k1p["plain_ms"], "bound_ms": k1p["bound_ms"],
        "bound_by": "bytes", "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-legs"]:
        sys.exit(cpu_legs_main(sys.argv[2]))
    sys.exit(main())
