#!/usr/bin/env python3
"""Drive the PyTorch port (ppls_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 22     # the build and phase 22 alone
    python3 chip_smoke.py --phase 23     # the build and phase 23 alone
    python3 chip_smoke.py --phase 24     # the build and phase 24 alone
    python3 chip_smoke.py --phase 25     # the build and phase 25 alone

Phases, each of which must pass (any failure exits nonzero):

1. Device: the card's name and power limit.
2. Build: compile the three walk kernels from the checkout, one nvcc
   process per source, all started together, and load them: K1
   (csrc/walk_rf.cu, in-kernel refill), K2 (csrc/walk_ee.cu, early exit)
   and K3 (csrc/walk_seg.cu, fixed length), each with every integrand
   body of csrc/walk_step.cuh; the nvcc seconds per source are printed.
3. Kernels vs plain, at the flagship's shapes (lanes=16384): each kernel
   and its plain PyTorch segment run on identical copies, and every
   output must be bit-equal.
   a. K1 on a bred and dealt flagship bank (R=8), cap=256, in the
      trapezoid, scouting and Simpson step machines.
   b. K2 on the flagship's seeded lanes (bred, work-sorted, the first
      boundary refill), cap=256, thresh 0.80 * lanes, in the same three;
      its ptxas registers, and its co-resident blocks in all 24 (family,
      step machine) variants, which must hold the 128-block grid.
   c. K3, 256 steps on the same seeded lanes, trapezoid and Simpson,
      then 100 more launches of each with nvidia-smi's clocks.sm and
      power.draw sampled beside them: us per step, the step's dependent
      chain, the bound and its share, registers, clocks; then the
      reference's probe (tools/profile_walker.py) at lanes=16384, on
      restarted lanes that mostly park (not an all-live rate). K3 has no
      grid count, so its time per step against K2's with no exit on the
      seeded lanes is the share of K2's step that the count, its
      barriers and the speculative step's copy cost.
   Every record carries its operation bound with the kernels' FMA
   two-products (and with Dekker's, as the plain twins compute them)
   and the step's dependent chain at one warp per scheduler (in the log
   and report.json; the kernels line carries bound_ms alone).
   d. K1's theta variants (theta_block T > 1) on a bred, dealt theta bank
      of sin(theta x) on [0, 1], eps 1e-5, lanes/T slots of T thetas
      from linspace(1, 4, lanes), R=8, cap=256: trapezoid at T = 8, 64,
      128, 256 and 2048 (every vote scope: warp ballot, shared memory,
      the block, whole blocks voting through a word per group), scout
      at T = 32 and 2048. T = 256 against T = 128 is what the vote
      across blocks costs.
   e. K1's step attribution per step machine: us per step, the confirm
      share (confirm evals / 3 over live lane-steps), K1 against K2 on
      lanes doing the same work, the barrier from c., the T = 256 minus
      T = 128 gap from d.
4. Main path, in-kernel refill: ``integrate_family_walker`` at the
   flagship configuration (sin_recip_scaled, M=1024 thetas on [1e-4, 1],
   eps=1e-10, lanes=2^14, R=8, scout f32, double-buffered banks): a
   warm-up run, then a timed run with the launch counts read around it.
   Areas must be finite and within 1e-3 of the closed form, and the waste
   buckets must reconcile to lanes x kernel steps. The same configuration
   with scouting off must agree with the port's float64 bag engine within
   3e-9 on every 128th member. The scouting run's distance from the bag is
   printed, not held (see phase 5).
5. Scout schedule: at |theta/x| ~ 1e4 the float32 scout error exceeds
   the reference's guard band, so its decisive splits over-refine by
   rounding noise, in the reference walker as in the port. The
   configuration of tests/test_torch_walker.py's flagship-regime test
   (every 256th theta, lanes=1024), where the CPU port reproduces the
   reference walker's tasks and areas, runs on the card and on the CPU:
   the same tasks, kernel steps and waste, and areas within 1e-12.
6. Main path, boundary refill: the reference bench's fallback
   configuration (the flagship with refill_slots=0, scout f64, through
   K2): a warm-up run, then a timed run with the launch counts read
   around it. Finite areas, tasks == splits + leaves, reconciling waste,
   K2 launched, all 1024 areas within 1e-3 of the closed form and every
   128th within 3e-9 of the float64 bag. Once more with scout f32: its
   distance from the bag printed, the closed form held.
7. Simpson: the reference's real-chip Simpson configuration
   (tests/test_tpu_lane.py: 4 thetas on [1e-2, 1], eps 1e-12, 256 lanes)
   with boundary refill and with in-kernel refill: equal tasks and areas
   within 1e-12 of the port's float64 Simpson bag. Then the full-width
   flagship with the Simpson rule at refill_slots 0 and 8: within 1e-3
   of the closed form, its distance from the Simpson bag printed.
8. Profile: one more run of each main path under ``torch.profiler``:
   device busy time, idle share and the kernels that take it.
9. The reference's theta leg (tools/bench_history.py run_theta_proxies,
   its constants copied): a T = 1 solo sweep of 8 sample thetas, then
   T = 32, 256 and 2048 at lanes 2048, each batch embedding the samples.
   Each T must meet the per-theta quality contract (batched |area -
   exact| <= solo |area - exact| + eps at the samples), reconcile its
   waste and launch K1; T = 256 must cut bookkeeping (kernel steps plus
   rounds and segments) per theta at least 4x against the solo sweep.
10. Theta mode, card against CPU: tests/test_theta_walker.py's
   configuration (T = 8, eps 1e-6 and 1e-7, scout off and on) on both:
   equal tasks, kernel steps and waste, areas within 1e-12. Then the
   theta main path at the flagship's 16384 lanes (T = 2048, m = 8,
   thetas linspace(1, 4, 16384)): areas within 1e-3 of the closed form,
   reconciling waste, its wall, tasks/s and K1 launches, and one
   profiled run's device idle share.
11. The streaming engine (``StreamEngine``), the reference bench's stream
   leg at full width (bench.py:1055-1245, its sizes at bench.py:1098-1108):
   24 requests of sin(theta / x), theta = 1 + i/24, on [1e-4, 1], eps
   1e-10, slots 64, chunk 2^13, capacity 2^22, lanes 2^14, refill_slots 8,
   scout f32, double-buffered banks; one walker cycle (K1) per phase.
   a. Warm-up runs and 24 cold per-request walker calls.
   b. The saturated stream (all 24 admitted at phase 0) alternated three
      times with the batch walker on the same set (capacity 2^23), the
      launch counts read around each stream run: every area within 1e-3
      of the closed form, equal areas over the three runs; printed, not
      gated: requests/s, stream over batch tasks/s (medians), the
      cold/stream wall and boundary-proxy ratios, phases, K1 launches,
      host syncs per phase, lane efficiency, and |stream - cold|. With
      scouting the reference's schedule over-refines by rounding noise
      (phase 5), so its areas move with the schedule by up to ~1e-6, in
      the reference engine as in the port; the bench's gate |stream -
      cold| <= 1e-8 is held on the same leg with the ds walk (scouting
      off), against 24 cold ds calls. One more saturated run is
      profiled.
   c. The open-loop sweep at 0.5, 2 and 8 requests per phase (seed 17):
      p50/p99 latency in phases and seconds.
   d. The reference's overload leg (tools/bench_history.py:102-112: queue
      limit 6, three priority classes, quarantine on, seeded arrivals at 8
      per phase; without its fault plan), through K1 (refill_slots 2) and
      through K2 (refill_slots 0), on the card and on the CPU: equal shed
      records, per-request phases and tasks, areas within 1e-12.
12. The integrand bodies the kernels compile in beside the three of
   phases 3-11 (the range-reduced twins of sin(theta / x), cosh^4 and
   sin(theta x), gauss_center, quad_scaled), and the paths that run them.
   a. Each body against the plain segment at lanes=16384, cap=256, on its
      bank (ppls_tpu_torch/tools/time_k1.py body_bank: the flagship's
      domain; cosh^4 on [0, 5] with theta <= 2.5; sin(theta x) on [0, 1],
      theta from linspace(1, 4); Gaussians centred in [0.4995, 0.5005]
      on [0.4, 0.6]; theta x^2 on [0, 1], theta = 1 + i/4): K1 on a bred,
      dealt bank (R=8) and K2 on seeded lanes in the trapezoid, scouting
      and Simpson machines, K3 in trapezoid and Simpson, every output
      bit-equal; a reduced twin's reference twin on the same launches
      (kernel only) for the us/step of the two; K1's theta variant at
      T = 32 through the reduced sin(theta x).
   b. The flagship main path with reduced_integrands (the reduced
      sin(theta / x) twin) through K1 and through K2, under phases 4 and
      6's gates, its distance from their reference-twin areas printed,
      and its K1 time in the main path profiled.
   c. The reference problem through the reduced cosh^4 twin (theta = 1
      on [0, 5], eps 1e-6, lanes 2^14, R=2, scout f32, double buffer):
      within 1e-6 of 7583461.361497 (tests/test_reduced_integrands.py).
   d. gauss_center at the reference's real-chip check
      (tests/test_tpu_lane.py:215-230, lanes 256, K2): every peak above
      1e-3, within 3e-9 of the float64 bag, card = CPU (tasks, steps,
      waste and areas bit for bit).
   e. The reference bench's multihost single-engine run
      (tools/bench_history.py:133-142): quad_scaled over theta = 1 + i/4
      on [0, 1]; as configured (f64_rounds=2, no walk kernel) and with
      f64_rounds=0 (K1, R=2): card = CPU bit for bit, both modes' areas
      equal, the distance from theta/3 printed.
   f. Phase 11's saturated stream with reduced_integrands=True:
      requests/s against phase 11's, the closed form, and |stream - cold|
      <= 1e-8 on the ds walk.

13. Checkpoint and kill-and-resume (snapshots in a temporary directory of
   the checkout, removed at the end), each check in the same process as
   the run it is held to:
   a. phase 4's flagship through K1 with a snapshot every cycle: without
      a crash bit-equal to phase 4 (areas, tasks, splits, cycles, kernel
      steps, waste), its snapshot gone after; killed after 3 of its
      cycles and resumed with ``resume_family_walker``: bit-equal to
      phase 4, the two legs' K1 launches summing to phase 4's. Printed:
      the snapshot bytes per leg, the seconds of each snapshot's device
      read and file write and of the load, and the wall against a run
      without snapshots (host clock, noisy).
   b. the same on phase 6's fallback (refill_slots=0, scout f64) through
      K2.
   c. the reference problem through the float64 bag (cosh^4 on [0, 5],
      eps 1e-3), killed after 2 legs of 2 rounds and resumed: 6567 tasks
      and 7583461.801486, bit-equal to the run without snapshots.
   d. phase 11's stream leg in the open loop at 2 requests per phase,
      a snapshot every phase, killed after 3 phases, resumed with
      ``StreamEngine.resume`` and the rest of the arrivals replayed:
      areas, phases, completed records, stats rows and shed records
      bit-equal to the run without snapshots, K1 launches summing; with
      the synchronous and with the background writer.
   e. phase 12d's gauss_center (K2), cut to one segment of 8 steps per
      cycle, killed on the card after one cycle and resumed on the CPU:
      bit-equal to the card's run without a crash.
14. ``python -m ppls_tpu_torch serve`` (``ppls_tpu_torch/__main__.py``) at
   phase 11's stream leg (flags as ``serve_argv`` builds them: 24
   synthetic requests, thetas linspace(1, 2, 24, endpoint=False), the open
   loop at 2 requests per phase, seed 17), called in this process with its
   stdout captured unless it says otherwise; snapshots in a temporary
   directory of the checkout, removed at the end.
   a. Through K1: every retire record (area, admit, retire, phases) bit-
      equal to ``StreamEngine.run`` on the same requests in this process,
      the summary's completed, phases and totals equal to that run's, the
      ledger valid (``utils/artifact_schema.validate_serve_output_text``).
   b. With ``--checkpoint``, ``--checkpoint-every 1``, ``--events`` and a
      fault-plan SIGTERM at phase 3: terminated, its snapshot kept; the
      same command again without the plan: the two ledgers together equal
      14a's bit for bit, every rid once; both events segments balanced.
   c. Under ``--supervise`` and ``--watchdog`` 300 (the loop in a worker
      thread; far above a cold kernel build): tools/chaos_plan_ckpt.json
      (a corrupt snapshot, then a crash; the resume starts fresh) drains
      to 14a's ledger; a NaN-poisoned rid 2 and a crash at phase 4: rid 2
      retires failed with area null, every other rid bit-equal to a
      ``StreamEngine`` run with the same poison in this process and within
      1e-6 of 14a (with scouting the areas move with the work mix, phase
      5). Both summaries' recoveries and faults equal those of the same
      flags on the CPU at the CPU tests' size.
   d. Phase 11d's overload leg with the reference's fault plan (NaN at rid
      2, a 0.05 s straggler at phase 3) through K1 (R=2) and K2 (R=0):
      completed and shed records, the failed rid, the stats rows and the
      fired faults equal to the CPU's, areas within 1e-12.
   e. The real entry point: ``python -m ppls_tpu_torch serve`` in a
      subprocess with ``--checkpoint``, ``--metrics-port 0`` and
      ``--ingest-port 0``: ``/metrics`` and ``/health`` scraped, two
      requests posted and acknowledged with rids, SIGTERM after four
      retire lines; the same command again, stopped when every rid has
      retired: no acknowledged rid lost. The process start is taken apart
      in another fresh interpreter (import, CUDA context, K1 and K2 load).
   Printed for each: the serve wall, requests/s, p50/p99 latency in
   phases, host syncs per phase (not for 14e's processes), phases and
   completed; the snapshot bytes and load time at the restart, the
   supervisor's recovery wall, the POST and scrape round trips.
15. ``python -m ppls_tpu_torch`` (the root command) and ``python -m
   ppls_tpu_torch family``, called in this process through
   ``__main__.main(argv)`` on the card, the kernels' launches counted
   around each call; snapshots and traces in a temporary directory of the
   checkout, removed at the end.
   a. The reference problem (cosh^4 on [0, 5], eps 1e-3) through the host
      engine, the device engine and the spillover backend, each with
      ``--json``: 7583461.801486 at the reference's printed precision,
      6567 tasks (3283 splits, 3284 leaves), 15 rounds, depth 14; the C
      sequential driver and the single-process MPI stub give the same;
      ``--backend mpi`` runs only where ``mpirun`` is on PATH (printed
      either way, never counted as a pass without it); ``--rule
      simpson`` beside it, its global error printed.
   b. BASELINE's SIN_CONFIG, OSC_CONFIG and OSC_DEEP_CONFIG through both
      wavefront engines on the card: equal tasks, rounds and depth, areas
      within 1e-12 relative; the C driver on each within 1e-9 relative
      (the reference bench's gate 1), its task difference printed;
      OSC_DEEP_CONFIG at capacity 2^12 overflows (OSC_CONFIG's peak
      frontier, 2508, fits there) and comes back equal to the host
      engine. The device reads of every run are printed.
   c. The flagship from the shell at full width (``family --engine
      walker --m 1024 -a 1e-4 -b 1 --eps 1e-10 --capacity 8388608 --chunk
      32768``): through K1 (``--refill-slots 8 --scout-dtype f32
      --double-buffer``) and through K2 (``--refill-slots 0 --scout-dtype
      f64``), each line's ``areas_head`` and ``tasks`` bit-equal to
      phases 4 and 6, ``abs_error`` < 1e-3, each kernel launched; the bag
      at the CLI defaults card against CPU (equal counts, areas within
      1e-12); ``--theta-block 256`` on the bench theta leg's integrand
      (sin(theta x) on [0, 1], eps 1e-5, R = 8, 16384 thetas) equal to
      the same call in this process; the K1 flagship with
      ``--checkpoint`` equal to the run without, its snapshot gone.
   d. ``serve --spillover --spillover-limit 4`` on phase 11d's overload
      leg (24 requests at 8 per phase into 4 slots, queue limit 6, three
      priority classes) through K1: card against CPU (retire and shed
      records, spillover flags, summary counts; walker areas within
      1e-12, spillover areas, computed on the CPU either way, bit-equal);
      the spilled areas within 1e-9 of the walk's for the same thetas;
      SIGTERM at phase 3 with a non-empty spill queue in the kept
      snapshot, and the restart: the two ledgers together bit-equal to
      the uninterrupted run.
   e. ``--trace DIR`` around ``family --engine walker --m 64`` through K1:
      the Chrome trace is written, holds the CPU-side operator spans, and
      whether it names K1's launches is printed.
   Printed: the reference problem's walls (host, device, spillover, C),
   the CLI flagship's wall against its in-process run, the device reads
   and the spillover share of the overload leg, with the card's name and
   power limit.
16. The reference bench's timed pipeline and the walker and stream
   options that came with it (snapshots and event files in a temporary
   directory of the checkout, removed at the end):
   a. ``seed_family_walker_state`` once, ``REPEATS = 16`` runs
      (bench.py:119) queued with ``dispatch_family_walker`` on that seed
      and collected in order, at phase 4's configuration through K1:
      every run bit-equal to phase 4's (areas, tasks, splits, cycles,
      kernel steps, waste), the launches 16 x phase 4's. Printed: the
      wall of the 16, the deltas between collects, and one more run of
      the pipeline under ``torch.profiler`` (its idle share).
   b. The same with 4 queued runs at phase 6's fallback (refill_slots=0,
      scout f64) through K2, each bit-equal to phase 6's.
   c. ``nan_policy`` at full width: M families of theta x^2 on [0, 1]
      at eps 1e-9 whose float64 integrand turns NaN where theta > 8 and
      x > 0.5 (tests/test_faults.py:80), walked through quad_scaled's ds
      twin; member M/2's theta is 9.0. Through K1 (R=8, double buffer)
      and K2: "quarantine" marks exactly that family and every other
      area is bit-equal to the unpoisoned run; "raise" raises.
   d. ``sort_roots=False`` and ``sort_skip_ratio=0.0`` on the flagship
      through K1 (the ds walk, scout f64): within 3e-9 of the float64 bag
      on every 128th member and 1e-3 of the closed form; tasks and wall
      beside phase 4's ds run.
   e. ``serve --adapt --slo-config`` on phase 14's stream leg: records and
      ``knob_adapt``/``slo_burn`` events equal to the same configuration
      through ``StreamEngine`` in this process, the ``/health`` verdict
      of the port's metrics server; a SIGTERM restart from its snapshot
      losing no request, its events equal to the uninterrupted run's.
      On phase 15d's overload leg with CPU spillover at a spillover limit
      of 1, so that the spill backlog moves the adapter: records equal to
      the engine run on the CPU (areas within 1e-12), the adapter's and
      the SLO evaluator's events equal.
   f. ``device_kind()`` and the cadence tier every phase-16 walker run
      and the stream resolved: the hand tier (the tuning table has no
      rows for this card).
17. The 2D cubature (``parallel/cubature.py``, the reference bench's 2D
   leg, bench.py:679-761, at its sizes; no walk kernel is on this path,
   and none may launch in phases 17-18):
   a. gauss2d_peak on [0, 1]^2: Simpson at eps 1e-8 (chunk 2^12,
      capacity 2^21), global error <= 1e-6; trapezoid at 1e-10 (chunk
      2^13, capacity 2^22), <= 1e-5. Cells, rounds, depth, wall.
   b. gauss2d_ring, trapezoid, eps 1e-12, chunk 2^13, capacity 2^23,
      against the C rectangle bag (``run_seq_2d``) on the same bounds:
      global error <= 1e-6, cells and splits equal to C's exactly, area
      within 1e-9 of C's.
   c. One ``seed_rect_state``, 2 ``dispatch_2d`` runs on it, collected:
      each equal to 17b's; cells/s against C's, rounds and host syncs
      per run; one run of the ring at eps 1e-10 under ``torch.profiler``
      (device busy, idle share, top ops).
   d. Card against CPU at tests/test_bench_secondary.py's size
      (gauss2d_peak and gauss2d_ring, trapezoid, eps 1e-8, chunk 2^11,
      capacity 2^20): tasks, splits, rounds and depth equal, areas
      within 1e-12, cells equal to C's.
   e. ``python -m ppls_tpu_torch 2d --json`` in this process: area and
      cells bit-equal to ``integrate_2d`` with the same arguments (``2d
      --n-devices``: phase 20f).
18. The QMC lattice (``parallel/qmc.py``, the reference bench's QMC leg,
   bench.py:826-925):
   a. The six Genz families at N = 2^22, 8 shifts, d = 8
      (``genz_params(name, 8, seed=0)``): worst relative error <= 1e-2;
      points/s over the six, timed as bench.py:854-862; peak device
      memory.
   b. The numpy denominator (bench.py:791-823, copied as
      ``qmc_numpy_baseline``) on the oscillatory family with the same
      shifts (seed 17): within 1e-11 of the card's value; both points/s
      and their ratio.
   c. The error slope of the oscillatory family over N = 2^16 ... 2^22.
   d. Card against CPU at N = 2^16, six families: every shift's
      estimate within 1e-12 relative.
   e. ``python -m ppls_tpu_torch qmc --json`` (N = 2^18): every value
      bit-equal to ``integrate_qmc`` in this process.
19. The family engines across ranks (``parallel/mesh.py``,
   ``sharded_bag.py``, ``sharded_walker.py``). Every multi-rank launch
   has its own time limit (``DD_TIMEOUT``): a rank that hangs fails the
   phase.
   k. K1 (scouting, R = 8) and K2 (trapezoid) bit-equal to their plain
      segments at a dd rank's shapes (2^12 lanes, the dd leg's bank and
      lanes).
   a. The reference bench's dd leg at its size (bench.py:961-981): 64
      thetas 1 + i/64 on [1e-4, 1], eps 1e-10, chunk 2^12, capacity 2^20,
      lanes 2^12, roots_per_lane 12; the refill leg (R = 8, scout f32,
      double buffer: K1 on every rank) and the legacy leg (R = 0, scout
      f64: K2 on every rank), on 1 rank (in this process, NCCL) and on 4
      ranks of the one card (spawned, gloo staged through host memory).
      Each run within 1e-3 of the closed form; the ds (legacy) leg's
      every 8th member within 3e-9 of the float64 bag; tasks = splits +
      leaves; refill's collective rounds per cycle below legacy's; each
      rank launched its kernel. Printed per run: walls, tasks, cycles,
      tasks per rank, collective rounds, launches and host syncs per
      rank, the transport, rank 0's collective calls by kind beside the
      reference's census; one profiled world-1 run's idle share.
   b. Card against CPU at tests/test_sharded_walker.py's shapes, 4 ranks,
      both modes, the hand cadence on both: equal schedules (tasks,
      splits, cycles, kernel steps, collective rounds, tasks per rank),
      areas within 1e-12. The CPU calls run last in 19a's world of 4
      (gloo carries both devices), each rank at a CPU world's torch
      thread count: one world start for both.
   c. The refill leg on 4 ranks killed after one leg and resumed:
      bit-equal; the tests' shapes' 4-rank snapshot resumed on 2 ranks
      (``mesh_resize``) on the card and on the CPU, both in one world
      of 2: equal.
   d. ``family --engine sharded-walker-dd --n-devices 4`` (the refill
      leg's flags) and ``family --engine sharded-bag --n-devices 4``:
      areas, tasks and tasks per rank bit-equal to the in-process calls.
20. The offline tuning search on the card, and the single-integral
   wavefront (``parallel/sharded.py``), the 2D bag and the QMC lattice
   across ranks. The phase has one time limit (``ACROSS_TIMEOUT``) that
   every launch in it shares; its time is printed.
   a. ``ppls_tpu_torch/tools/tune_table.py``'s sweep (budget 16, the
      three tune workloads) on the card into a scratch table, its K1
      launches counted: every entry equal to the same sweep on the CPU
      apart from ``device_kind`` and ``recompiles``, its knobs, moves,
      acceptances, trials and gain the committed ``cpu`` row's; every
      workload resolves ``exact`` through the scratch table on the card.
      The committed table still resolves ``default`` on the card (phase
      16f) and phases 4 and 6 kept 13 K1 launches over 15,625 steps and
      163 K2 launches over 16,719.
   b. The reference problem (``QuadConfig()``) and BASELINE's OSC_CONFIG
      through ``sharded_integrate`` on 1 rank (NCCL, in this process):
      the host engine's tasks and rounds, areas within 1e-12 relative.
   c. The same two on 4 ranks sharing the card (gloo, host-staged; one
      spawned world runs every 4-rank call of 20c-e, their CPU twins
      last, at a CPU world's thread count): world 1's counts and areas
      within 1e-12, card = CPU, a kill-and-resume bit-equal and a
      snapshot of another eps refused.
      Printed: tasks per rank, collective calls by kind beside the
      reference's sites, rounds, host syncs, the engine wall.
   d. The bench's ring (phase 17, eps 1e-12) through
      ``integrate_2d_sharded`` on 1 rank: C's cells and splits; the ring
      at eps 1e-10 and gauss2d_peak at the tests' shapes on 4 ranks, card
      against CPU (cells, splits, rounds, tasks per rank equal, areas
      within 1e-12); a 4-rank kill-and-resume bit-equal.
   e. The six Genz families at N = 2^22 on 1 and 4 ranks: within 1e-12
      relative of phase 18's one-card estimates (1 rank bit-equal); card
      against CPU at N = 2^16 on 4 ranks; points/s of both.
   f. ``--engine sharded --n-devices 4``, ``2d --n-devices 4
      --checkpoint`` and ``qmc --n-devices 4`` (each starting its own
      ranks) bit-equal to the in-process calls.
21. The walker-dd stream (``StreamEngine(engine="walker-dd")``: a world
   of ranks that lives as long as the engine, ``parallel/mesh.py``
   ``World``). The phase has one time limit (``DD_STREAM_TIMEOUT``), which
   also bounds every command to the spawned ranks.
   k. K1 (scouting, R = 8) bit-equal to its plain segment on a dd-stream
      rank's bank (the stream leg's 24 requests at 2^14 lanes), 64 steps
      (LATE_CMP_CAP).
   a. The stream leg's configuration (phase 11: 24 requests of sin(theta
      / x) on [1e-4, 1], eps 1e-10, slots 64, chunk 2^13, capacity 2^22
      per rank, lanes 2^14, R = 8, scout f32, double buffer) with
      ``engine="walker-dd"`` on 1 rank (NCCL, in this process): every
      request retired within 1e-3 of the closed form; requests/s, p50/p99
      latency in phases, host syncs and collective calls per phase, K1
      launches per rank; the ds walk (scouting off): every 4th area
      within 3e-9 of the float64 bag; one profiled run's idle share.
   b. The same on 4 ranks sharing the card (gloo, host-staged: not a
      multi-GPU rate); at the CPU tests' size, 4 ranks on the card
      against 4 on the CPU: the same retire phases, phase rows and chip
      spans, areas within 1e-12 (the two worlds side by side).
   c. Kill after phase 3 and resume on 4 ranks: areas and the timeline
      bit-equal to the run without a crash; the snapshot resized onto 3
      ranks (``mesh_resize``): within 1e-9 with the ds walk; beside the
      resume, the dyadic family's undisturbed run on 1 CPU rank in this
      process (exact dyadic sums: the same bits at every world size and
      on either device; its resize is 21d's).
   d. ``serve --engine walker-dd --n-devices 4 --supervise`` with a
      ``chip_loss`` at phase 3 (the dyadic family): recoveries
      [("chip_loss", "resize_resume")], 3 ranks after it, no
      acknowledged request lost, areas bit-equal to 21c's undisturbed
      engine's.
   e. Deadline expiry on the dd stream (1 rank): the expired request
      retires ``deadline_exceeded``, its neighbour within 3e-9 of the
      float64 bag, a fresh request bit-equal to a solo run.
22. The pool dispatcher (``runtime/dispatch.py`` ``EngineDispatcher``:
   one stream engine per (eps band, rule, theta bucket) key, parked and
   unparked under a cap, slot credits leased between engines). The phase
   has one time limit (``DISPATCH_TIMEOUT``), which also bounds every
   command to a spawned rank and every serve process.
   k. K1 (trapezoid and Simpson, the ds walk, R = 8) and K2 bit-equal to
      their plain segments at a pooled engine's first phase (24
      requests, 16384 lanes), at most 64 steps (LATE_CMP_CAP).
   a. The reference bench's ``stream --hetero`` leg at its own
      configuration (16 requests over 4 keys, slots 4, seed 31) on the
      card and on the CPU: 9 turns with leasing off, 6 with leasing and
      overlapped boundaries (>= 1.2x the mean latency, a balanced ledger,
      an overlapped boundary), the serialized baseline's phases; card =
      CPU (turns, per-engine phases, ledger; areas < 1e-12); 0 recompiles
      and no library built.
   b. Full width: four keys (``e-10:trapezoid:t1``, ``e-9:trapezoid:t1``,
      ``e-10:trapezoid:t2`` theta pairs, ``e-10:simpson:t1``) of sin(theta
      / x) on [1e-4, 1], 24 requests each, every engine at the stream
      leg's width (slots 64, chunk 2^13, capacity 2^22, lanes 2^14, R = 8,
      double buffer, the ds walk), saturated and open loop (8 requests a
      turn, phase 11c's top rate), 4 and 2 live engines, leasing off, on
      with overlapped boundaries, on with serialized ones: every area
      within 1e-3 of the closed form, every 8th t1 trapezoid area within
      3e-9 of the float64 bag (each sampled theta through the bag once for
      both legs), K1 launched by every engine (saturated), 0 recompiles
      and no library built; overlapped = serialized boundaries bit for bit; a
      capped leased pool has a parked donor that completed its requests;
      capped against uncapped printed. Printed: requests/s, p50/p99
      latency in turns and seconds, turns, phases per engine, host syncs
      per turn, park and unpark seconds, boundary and overlap walls, the
      Simpson key's distance from the float64 Simpson bag, one profiled
      run's idle share, and the uncapped saturated rate against phase
      11's single engine. Then the three t1 keys with refill_slots=0
      through K2: the same gates.
   c. ``python -m ppls_tpu_torch serve --dispatch`` as processes,
      tools/ci.sh legs 5e and 5f (their requests, flags and crash plans;
      5f with ``--lease --overlap-boundaries``), on the card and on the
      CPU: ci.sh's summary assertions, the malformed line rejected, card
      = CPU (records equal, areas < 1e-12). They run while 22d runs.
   d. A walker-dd pool (tests/test_torch_dispatch.py's: two keys of the
      dyadic quad_scaled through one live engine, each engine two gloo
      ranks sharing the card): two parks and an unpark, card = CPU, no
      rank alive after ``close()`` (the card's pool and the CPU's side
      by side).
   Phases 21 and 22 count the worlds they start (``WorldStarts``): those
   that spawn ranks, and those of one rank in this process.

23. The multi-process cluster (``runtime/cluster.py``
   ``ClusterStreamEngine``: this process coordinates N worker processes,
   each a stream engine on ``cuda:0``; on one card the workers time-slice
   it, so no rate here is a multi-GPU rate). The phase has one time limit
   (``CLUSTER_TIMEOUT``), which also bounds every worker's start and RPC;
   after every run no worker process may be left alive.
   a. The reference bench's multihost leg (tools/bench_history.py:
      133-143: 8 quad_scaled requests, 2 processes, queue limit 2,
      spillover limit 2, worker 1 SIGKILLed at phase 1, the supervisor's
      host_loss arm), as given (f64_rounds=2) and through the walk
      (f64_rounds=0: K1 in every worker), on the card and on the CPU:
      records card = CPU, areas bit-equal to the single engine (dyadic),
      0 lost, none shed, spillover engaged, the survivor's K1 launches >
      0 in the walker run. The four clusters start at once and then run
      one after another. Printed: the redeal wall, spawn seconds per
      worker.
   b. Phase 11's stream leg (24 requests, eps 1e-10, slots 64, lanes
      2^14, R = 8, the ds walk) through 1 and 2 worker processes,
      saturated, after a warm-up run on the same cluster; then 2 processes
      through K2 (refill_slots=0); the three clusters start at once and
      each is timed alone: every area within 1e-3 of the closed
      form, every 8th within 3e-9 of the float64 bag, every worker
      launching its kernel and not the other. Printed: requests/s and
      p50/p99 latency (phases, s) against phase 11's single engine, the
      start and spawn seconds.
   c. ``python -m ppls_tpu_torch serve --processes`` as real processes,
      all nine started at once: tools/ci.sh leg 5d's flags at 1, 2 and
      4 processes, f64_rounds 2 and 0, on the card (the 2-process float64
      run with ``--metrics-port 0`` scraped live: coordinator retired =
      sum over workers + spillover = completed), at 2 processes on the
      CPU, and one ``--supervise`` run with a host_loss fault plan at
      phase 2. Areas bit-identical across process counts; card = CPU;
      recoveries [("host_loss", "resize_resume")], 0 lost, areas equal
      to the undisturbed run's.
24. The diagnosis and post-mortem tools (ppls_tpu_torch/tools/), run
   in this process through their functions, their printed lines logged
   (and written to chip_smoke_tools.txt). The phase has one time limit
   (``TOOLS_TIMEOUT``). With ``--phase 24`` its comparators (phases 4
   and 6's walks, phase 14a's serve command with a timeline) run first.
   a. ``analyze_occupancy --attribution`` at the flagship size, one mode
      at a time: the scout + double-buffer mode is phase 4's walk
      (166,590,262 tasks, 15,625 kernel steps, 13 K1 launches, the same
      area hash), the refill_slots=0 mode phase 6's (16,719 steps, 163
      K2 launches), every mode's buckets sum to lanes x kernel steps.
      Then ``analyze_occupancy``'s decomposition (round trip,
      initial_bag, solo runs, a pipeline of 5, five runs of one seed,
      occupancy, the headroom split against the K3 probe): its runs equal
      an ``integrate_family_walker`` call with the same arguments here
      (tasks, kernel steps, area hash).
   b. ``analyze_occupancy dd`` on one rank (NCCL in this process) and
      ``characterize_dd``: every dd run within 1e-3 of the closed form,
      both dd legs launching their kernel.
   c. The offline tools on phase 14's ledger (14a) and timeline (14b,
      killed and restarted): ``check_artifacts --serve`` and ``--events
      --rid-linkage`` and ``analyze_request --check`` exit 0,
      ``--from-events`` reconciles, and a ledger with one malformed line
      makes ``check_artifacts`` exit non-zero.
   d. K2's theta variant (theta_block T > 1; csrc/walk_ee.cu) against the
      plain theta segment, bit for bit, LATE_CMP_CAP (64) steps on seeded
      theta lanes of sin(theta / x) at lanes=16384: T = 2 and 4 in the
      trapezoid and scouting machines, T = 256 (the vote across blocks)
      in the trapezoid one; theta_overwalk > 0 in at least one case.
   e. ``profile_bag`` with PROFILE_BAG_K iterations: every component a
      finite, positive time.
25. The last of the reference's surface on the port. The phase has one
   time limit (``EXTRAS_TIMEOUT``), which also bounds its workers' start
   and RPCs.
   a. The host-level ds library (ops/ds.py): every function on
      DS_LIB_N (2^20) seeded pairs on the card and on the CPU, bit-equal
      (a difference names the function and its ulps per limb).
   b. ``segment_sum_auto(force_exact=True)`` on the card: m = 1024
      against four shards of 256 on dyadic leaves, every slice bit-equal,
      equal to the CPU's and to the exact sums. Then phase 19's dd-leg
      family (64 thetas of sin(theta / x) on [1e-4, 1], eps 1e-10, lanes
      2^12) through the single walker on K1 (R = 8, scout, double
      buffer) and on K2 (R = 0), each with ``PPLS_EXACT_SEGSUM`` 0 and 1:
      equal tasks, kernel steps, cycles and launches, areas within 1e-15
      relative.
   c. ``ClusterStreamEngine(jax_distributed=True)``: 2 workers sharing
      the card (the walk: K1 in each) beside the same cluster on the CPU,
      started at once: every hello's device picture (global devices =
      the sum of the local ones, ids 0..1, the platform), 2 requests
      served with card = CPU records, every card worker launched K1, no
      worker alive after ``close()``.

Before the last line it prints one JSON object describing each kernel
(time, plain time, bound, launches on its main paths; K1's theta times
per T under ``theta``; the stream's launches under ``stream_launches``;
phase 12's records per body and step machine under ``bodies`` and its
paths' launches under ``body_launches``; phase 13's under
``checkpoint_launches``; phase 14's in-process ones under
``serve_launches``; phase 15's under ``cli_launches``; phase 16's
under ``bench_launches``; phase 19's, every rank's, under
``dd_launches``, and 19k's records under ``dd``; phase 20a's under
``tune_launches``; phase 21's, every rank's, under ``dd_stream_launches``,
and 21k's record under ``dd_stream``; phase 22's under
``dispatch_launches``, and 22k's records under ``dispatch``; phase 23's,
the sum of every worker process's reported launches, under
``cluster_launches``; phase 24's tools' under ``tools_launches``, K2's
theta records (24d) under ``theta`` and their launches under
``theta_launches``, and the K3 probe's under ``tools_probe_launches``;
phase 25's, 25b's walker runs and 25c's workers, under
``surface_launches``) and the card's ``nvidia-smi`` name and power
limit; the last line is the ``{"ok": true, "device": ...}`` record.
The full report, the profiles and the build logs go to ``out_dir``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

M = 1024
EPS = 1e-10
BOUNDS = (1e-4, 1.0)
LANES = 1 << 14
REFILL_SLOTS = 8
ROOTS_PER_LANE = 12
CAPACITY = 1 << 23
CMP_CAP = 256                  # steps of the kernel-vs-plain launches
LATE_CMP_CAP = 64              # the same, in phases 21k, 22k and 24d
AREA_TOL_BAG = 3e-9
AREA_TOL_EXACT = 1e-3
AREA_TOL_DEVICES = 1e-12       # card vs CPU: float64 reduction order only
AREA_TOL_SIMPSON = 1e-12       # Simpson walker vs the float64 Simpson bag
SCHEDULE_STRIDE = 256          # phase 5: every 256th theta ...
SCHEDULE_LANES = 1024          # ... over 1024 lanes
SAMPLE_STRIDE = 128            # members held to the float64 bag
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
# operations/s outside the tensor cores (an FMA counted as two)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# cycles from a float32 add, multiply or FMA to its first dependent use on
# Hopper (the chain estimates take the card's top SM clock from nvidia-smi)
DEP_LATENCY_CYCLES = 4
# dependent operations of one IEEE float32 division on the sm_90a build
# (-prec-div=true): its fast path's depth in the SASS of K3's step loop,
# MUFU.RCP then the dependent FFMAs to the quotient, before FCHK sends
# the rare operand to the slow path (ppls_tpu_torch/tools/k3_split.py
# reads it with cuobjdump, division_depth)
DIV_CHAIN_OPS = 6
K3_SMI_RUNS = 100              # K3 launches timed beside nvidia-smi samples
STATE_BYTES = 26 * 4           # one lane's WalkState
MODES = ("step", "step_scout", "step_simpson")
DEVICE = "cuda"
# phase 3d: K1's theta variants, (T, step machine)
THETA_CMP = ((8, "step"), (64, "step"), (128, "step"), (256, "step"),
             (2048, "step"), (32, "step_scout"), (2048, "step_scout"))
# phase 9: the reference's theta leg, tools/bench_history.py:76-91
THETA_FAMILY = "sin_scaled"
THETA_EPS = 1e-5
THETA_BOUNDS = (0.0, 1.0)
THETA_RANGE = (1.0, 4.0)
THETA_LANES = 2048
THETA_SOLO_SAMPLES = 8
THETA_FULL_T = (32, 256, 2048)
THETA_KW = dict(capacity=1 << 16, roots_per_lane=8, refill_slots=8,
                seg_iters=64, min_active_frac=0.05)
GATE_THETA_MIN_REDUCTION = 4.0
# phase 10: tests/test_theta_walker.py's configuration, and the full
# lane count
THETA_TEST_T = 8
THETA_TEST_KW = dict(capacity=1 << 16, lanes=256, roots_per_lane=2,
                     refill_slots=2, seg_iters=2048, min_active_frac=0.05)
THETA_WIDE_T = 2048
THETA_WIDE_M = 8
# phase 11: the reference bench's stream leg at full width
# (bench.py:1098-1108), and its overload leg (tools/bench_history.py:
# 102-112), whose fault plan is left out
STREAM_FAMILY = "sin_recip_scaled"
STREAM_K = 24
STREAM_KW = dict(slots=64, chunk=1 << 13, capacity=1 << 22, lanes=LANES,
                 refill_slots=REFILL_SLOTS, scout_dtype="f32",
                 double_buffer=True)
STREAM_BATCH_KW = dict(capacity=CAPACITY, lanes=LANES,
                       refill_slots=REFILL_SLOTS, scout_dtype="f32",
                       double_buffer=True)
STREAM_COLD_TOL = 1e-8                 # bench.py:1166-1168
STREAM_ROUNDS = 3                      # batch / stream timing pairs
STREAM_SWEEP_RATES = (0.5, 2.0, 8.0)
STREAM_SWEEP_SEED = 17
SLO_EPS = 1e-6
SLO_BOUNDS = (1e-2, 1.0)
SLO_K = 24
SLO_RATE = 8.0
SLO_QUEUE_LIMIT = 6
SLO_SEED = 23
SLO_KW = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
              roots_per_lane=2, refill_slots=2, seg_iters=32,
              min_active_frac=0.05)
SLO_TENANTS = (("free", 0), ("std", 1), ("pro", 2))
# phase 12: the integrand bodies K1, K2 and K3 gained; each twin is
# "<family>" or "<family>@reduced" (its range-reduced twin), checked on
# the bank of ppls_tpu_torch/tools/time_k1.py body_bank
BODIES = ("sin_recip_scaled@reduced", "cosh4_scaled@reduced",
          "sin_scaled@reduced", "gauss_center", "quad_scaled")
BODY_RUNS = 4                          # kernel launches per median
BODY_THETA = ("sin_scaled@reduced", 32)   # K1's theta variant
# the reference problem through the reduced cosh^4 twin
# (tests/test_reduced_integrands.py:160-176) at full width
REF_PROBLEM_AREA = 7583461.361497
REF_PROBLEM_TOL = 1e-6
REF_PROBLEM_KW = dict(capacity=1 << 20, lanes=LANES, roots_per_lane=2,
                      refill_slots=2, scout_dtype="f32", double_buffer=True)
# gauss_center at the reference's real-chip check
# (tests/test_tpu_lane.py:215-230)
GAUSS_THETA = (0.4995, 0.5, 0.5005)
GAUSS_BOUNDS = (0.4, 0.6)
GAUSS_EPS = 1e-9
GAUSS_KW = dict(capacity=1 << 16, lanes=256, roots_per_lane=1, seg_iters=32,
                min_active_frac=0.05)
# the reference bench's multihost leg, its single-engine run
# (tools/bench_history.py:124-142, :558-561)
MULTIHOST_FAMILY = "quad_scaled"
MULTIHOST_EPS = 1e-9
MULTIHOST_K = 8
MULTIHOST_WKW = dict(slots=4, chunk=1 << 10, capacity=1 << 16, lanes=256,
                     roots_per_lane=2, refill_slots=2, seg_iters=32,
                     min_active_frac=0.05, f64_rounds=2)
# phase 14: `python -m ppls_tpu_torch serve` at phase 11's stream leg, in
# the open loop at 2 requests per phase
SERVE_RATE = 2.0
# 14c's per-attempt hang deadline: far above a cold kernel build (15-20 s,
# PERF.md section 6), so a build is never read as a hang
SERVE_WATCHDOG = 300
# the NaN-poisoned run against 14a: with scouting the schedule, and so the
# areas, move with the work mix (up to 7.3e-7, PERF.md section 6)
SERVE_SCHEDULE_TOL = 1e-6
# the CPU run that 14c's recoveries are held to: the CPU tests' size
# (tests/test_torch_serve.py), where the same flags run in seconds
CPU_SERVE = dict(eps=1e-6, a=1e-2, slots=4, chunk=512, capacity=1 << 16,
                 lanes=256, refill_slots=2, scout_dtype=None,
                 double_buffer=False, synthetic=8)
# the overload leg's fault plan (tools/bench_history.py:115-118)
SLO_FAULTS = ({"kind": "nan_poison", "at": 2},
              {"kind": "straggler", "at": 3, "seconds": 0.05})
# phase 15: the root command and `family`
REF_PRINTED = "7583461.801486"
REF_COUNTS = dict(tasks=6567, splits=3283, leaves=3284, rounds=15,
                  max_depth=14)
WAVEFRONT_TOL = 1e-12          # host against device engine, relative
C_GATE_REL = 1e-9              # the reference bench's gate 1
K1_FLAGS = ["--refill-slots", str(REFILL_SLOTS), "--scout-dtype", "f32",
            "--double-buffer"]
K2_FLAGS = ["--refill-slots", "0", "--scout-dtype", "f64"]
THETA_CLI_T = 256              # the bench theta leg's T, over 16384 thetas
SPILL_LIMIT = 4
SPILL_CONTRACT = 1e-9          # spillover against the walk (spillover.py)
TRACE_M = 64
# phase 16: the reference bench's timed pipeline (bench.py:119, :290-293,
# :416-441) and its fallback leg (bench.py:329-357)
BENCH_REPEATS = 16             # bench.py:119
FALLBACK_REPEATS = 4
# 16c: one of the M families poisoned (tests/test_faults.py:80, :421-423)
POISON_INDEX = M // 2
POISON_THETA = 9.0
POISON_BOUNDS = (0.0, 1.0)
POISON_EPS = 1e-9
# 16e: serve --slo-config's targets, and the overload leg's spillover
# limit (a spill backlog above it moves the adapter)
ADAPT_SPILL_LIMIT = 1
ADAPT_SLO = {"windows": {"fast": 2, "slow": 8},
             "burn_thresholds": {"fast": 1.0, "slow": 1.0},
             "slos": [{"slo": "p99_latency_phases", "target": 2,
                       "objective": 0.9},
                      {"slo": "shed_fraction", "objective": 0.9}]}
# phase 17: the reference bench's 2D leg (bench.py:704-761) at its sizes
BOUNDS_2D = (0.0, 1.0, 0.0, 1.0)
GATES_2D = (("simpson", "SIMPSON", 1e-8, 1 << 12, 1 << 21, 1e-6),
            ("trapezoid", "TRAPEZOID", 1e-10, 1 << 13, 1 << 22, 1e-5))
RING_EPS = 1e-12
RING_KW = dict(chunk=1 << 13, capacity=1 << 23)
RING_GATE = 1e-6
RING_PROFILE_EPS = 1e-10       # 17c's profiled run: 75 of the 761 rounds
RING_C_AREA_TOL = 1e-9
REPEATS_2D = 2                 # bench.py:654
# 17d: tests/test_bench_secondary.py:29-45's size, card against CPU
CPU_2D = dict(eps=1e-8, chunk=1 << 11, capacity=1 << 20)
AREA_TOL_2D = 1e-12
# phase 18: the reference bench's QMC leg (bench.py:826-925)
QMC_N = 1 << 22
QMC_SHIFTS = 8
QMC_DIM = 8
QMC_GATE = 1e-2
QMC_NUMPY_TOL = 1e-11          # tests/test_bench_secondary.py:80
QMC_CPU_N = 1 << 16
QMC_CPU_REL = 1e-12
# phase 19: the family engines across ranks; the reference bench's dd leg
# (bench.py:961-981) at its full size, and tests/test_sharded_walker.py's
# shapes for card against CPU
DD_FAMILY = "sin_recip_scaled"
DD_M = 64
DD_EPS = 1e-10
DD_KW = dict(chunk=1 << 12, capacity=1 << 20, lanes=1 << 12,
             roots_per_lane=12)
DD_LEGS = {"refill": dict(refill_slots=8, scout_dtype="f32",
                          double_buffer=True),
           "legacy": dict(refill_slots=0, scout_dtype="f64")}
DD_WORLDS = (1, 4)
DD_SAMPLE_STRIDE = 8           # members held to the float64 bag
DD_TEST_ARGS = (DD_FAMILY, [1.0], (1e-3, 1.0), 1e-9)
DD_TEST_KW = dict(chunk=1 << 8, capacity=1 << 16, lanes=256,
                  roots_per_lane=2, seg_iters=32, min_active_frac=0.05)
DD_TEST_LEGS = {"refill": dict(refill_slots=2), "legacy": {}}
DD_BAG_EPS = 1e-9              # 19d's sharded bag
DD_TIMEOUT = 600               # s, every multi-rank launch of phase 19
DD_CENSUS = "9 psum, 11 all_gather, 2 axis_index call sites"
# phase 20: the offline tuning search on the card; the single-integral
# wavefront, the 2D bag and the QMC lattice across ranks
ACROSS_TIMEOUT = 480           # s, the whole of phase 20, its launches too
ACROSS_N = 4
TUNE_BUDGET = 16               # bench.py tune's default budget
K1_MAIN = (13, 15625)          # phase 4: K1 launches, kernel steps
K2_MAIN = (163, 16719)         # phase 6: K2 launches, kernel steps
SHARDED_TOL = 1e-12            # relative: the wavefront across ranks
TEST_2D = dict(chunk=1 << 8, capacity=1 << 15)   # tests/test_cubature.py
TEST_2D_EPS = 1e-9
TEST_2D_RESUME_EPS = 1e-7
QMC_CLI_N = 1 << 18            # the qmc command's default lattice
# the reference's collective call sites per wavefront round
# (ppls_tpu/parallel/sharded.py:130, mesh.py strided_reshard): the loop
# condition's psum, the counts' and two columns' all_gathers, axis_index
SHARDED_SITES = "1 psum, 3 all_gather, 1 axis_index per round"
# phase 21: the walker-dd stream, the stream leg's configuration
# (STREAM_KW, STREAM_K) with engine="walker-dd", and the CPU tests' size
# (tests/test_torch_dd_stream.py) for card against CPU and the resumes
DD_STREAM_TIMEOUT = 420        # s, the whole of phase 21, its worlds too
DD_STREAM_SAMPLE = 4           # 21a's ds leg: every 4th area to the bag
DD_STREAM_TEST_EPS = 1e-9
DD_STREAM_TEST_BOUNDS = (1e-3, 1.0)
DD_STREAM_TEST_KW = dict(slots=8, chunk=1 << 8, capacity=1 << 16,
                         lanes=256, roots_per_lane=2, refill_slots=2,
                         seg_iters=32, min_active_frac=0.05)
DD_STREAM_TEST_ARR = [0, 0, 1, 2, 3, 4]
DD_STREAM_DYADIC = (1.0, 1.25, 1.5, 2.0, 0.75, 3.0)  # tests/test_faults.py
DD_STREAM_RESIZE_TOL = 1e-9    # the ds walk resized (tests/test_faults.py)
DD_STREAM_SERVE_RATE = 0.5     # 21d: requests per phase, past the loss
# phase 22: the pool dispatcher
DISPATCH_TIMEOUT = 360         # s, the whole of phase 22, its worlds too
# 22a: the reference bench's stream --hetero leg (tools/bench_history.py:
# 163-183, _hetero_requests :624) and its pins (tests/test_dispatch.py:
# 263-313: 9 turns lease off, 6 with lease and overlap)
HETERO_FAMILY = "sin_recip_scaled"
HETERO_BOUNDS = (1e-2, 1.0)
HETERO_K = 16
HETERO_RATE = 4.0
HETERO_SEED = 31
HETERO_MAX_ENGINES = 4
HETERO_SLOTS = 4
HETERO_EKW = dict(chunk=1 << 10, capacity=1 << 16, lanes=256,
                  roots_per_lane=2, refill_slots=2, seg_iters=32,
                  min_active_frac=0.05)
HETERO_SHAPES = ({"eps": 1e-6}, {"eps": 1e-7}, {"eps": 1e-6, "batch": 2},
                 {"eps": 1e-6, "rule": "simpson"})
HETERO_TURNS = {"off": 9, "lease": 6}
# 22b: the stream leg's engine width (phase 11's STREAM_KW, the ds walk)
# behind one pool; every key gets POOL_K requests
POOL_KEYS = ({"eps": 1e-10}, {"eps": 1e-9}, {"eps": 1e-10, "batch": 2},
             {"eps": 1e-10, "rule": "simpson"})
POOL_K = 24
POOL_EKW = dict(chunk=STREAM_KW["chunk"], capacity=STREAM_KW["capacity"],
                lanes=STREAM_KW["lanes"],
                refill_slots=STREAM_KW["refill_slots"], double_buffer=True)
POOL_SLOTS = STREAM_KW["slots"]
POOL_CAPS = (4, 2)
POOL_RATE = 8.0                # requests per turn, open loop (phase 11c's)
POOL_SAMPLE = 8                # every 8th t1 trapezoid area to the bag
# 22c: tools/ci.sh legs 5e and 5f (their requests, flags and chaos plans)
CI_DISPATCH_REQS = (
    {"theta": 1.0, "bounds": [1e-2, 1.0], "arrival_phase": 0},
    {"theta": 1.05, "bounds": [1e-2, 1.0], "eps": 1e-7, "arrival_phase": 0},
    {"theta": 1.1, "bounds": [1e-2, 1.0], "rule": "simpson",
     "arrival_phase": 0},
    {"theta": [1.15, 1.2], "bounds": [1e-2, 1.0], "arrival_phase": 1},
    {"theta": 1.25, "bounds": [1e-2, 1.0], "arrival_phase": 1},
    {"theta": 1.3, "bounds": [1e-2, 1.0], "eps": 1e-7, "arrival_phase": 2},
    {"theta": 1.35, "bounds": [1e-2, 1.0], "rule": "simpson",
     "arrival_phase": 2},
    {"theta": [1.4, 1.45], "bounds": [1e-2, 1.0], "arrival_phase": 3})
CI_DISPATCH_MALFORMED = {"theta": 1.5, "bounds": [1e-2, 1.0], "eps": 1e-20}
CI_DISPATCH_ARGS = (
    "--dispatch", "--max-engines", "4", "--supervise", "--eps", "1e-6",
    "-a", "1e-2", "-b", "1.0", "--slots", "4", "--chunk", "512",
    "--capacity", "65536", "--lanes", "256", "--refill-slots", "2",
    "--checkpoint-every", "1", "--watchdog", "120")
CI_DISPATCH_LEGS = {           # extra flags, fault plan, malformed line
    "5e": ((), [{"kind": "crash", "at": 1, "edge": "close"}], True),
    "5f": (("--lease", "--overlap-boundaries"),
           [{"kind": "crash", "at": 3, "edge": "close"}], False)}
# 22d: tests/test_torch_dispatch.py's walker-dd pool (the dyadic family)
DD_POOL_REQS = ((1.0, {}), (1.25, {}), (1.5, {"eps": 1e-8}),
                (2.0, {"eps": 1e-8}), (0.75, {}), (3.0, {}))
DD_POOL_ARR = [0, 0, 1, 1, 2, 3]
# phase 23: the multi-process cluster (runtime/cluster.py)
CLUSTER_TIMEOUT = 300          # s, the whole of phase 23, its workers too
# 23a: the reference bench's multihost leg (tools/bench_history.py:133-143)
MULTIHOST_PROCESSES = 2
MULTIHOST_QUEUE_LIMIT = 2
MULTIHOST_SPILL_LIMIT = 2
MULTIHOST_FAULTS = ({"kind": "host_loss", "at": 1, "chip": 1},)
# 23b: phase 11's stream leg with the ds walk, through 1 and 2 processes
CLUSTER_PROCESSES = (1, 2)
CLUSTER_SAMPLE = 8             # every 8th area to the float64 bag
# 23c: tools/ci.sh leg 5d (:410-416) at --processes 1, 2, 4
CLUSTER_SWEEP = (1, 2, 4)
CI_5D_ARGS = ("--family", "quad_scaled", "--theta",
              "1.0,1.25,1.5,2.0,0.75,3.0", "--arrival-rate", "2", "--seed",
              "0", "--eps", "1e-9", "-a", "0.0", "-b", "1.0", "--slots", "4",
              "--chunk", "1024", "--capacity", "65536", "--lanes", "256",
              "--refill-slots", "2")
CI_5D_HOST_LOSS = [{"kind": "host_loss", "at": 2, "chip": 1}]

# phase 24: the diagnosis and post-mortem tools (ppls_tpu_torch/tools/)
TOOLS_TIMEOUT = 300            # s, the whole of phase 24
# the flagship's task count (phase 4; K1_MAIN and K2_MAIN pin phases 4
# and 6's schedules), which the attribution tool's flagship mode walks
FLAGSHIP_TASKS = 166590262
K2_THETA_CMP = ((2, "step"), (2, "step_scout"), (4, "step"),
                (4, "step_scout"), (256, "step"))
K2_THETA_FAMILY = "sin_recip_scaled"
K2_THETA_BOUNDS = (1e-2, 1.0)
K2_THETA_EPS = 1e-7
K2_THETA_WALK = 16             # K1 plain steps before K2 takes the lanes
PROFILE_BAG_K = 10
# phase 25: the last of the reference's surface on the port
EXTRAS_TIMEOUT = 120           # s, the whole of phase 25, its workers too
DS_LIB_N = 1 << 20             # 25a's seeded pairs
SEGSUM_N = 1 << 16             # 25b's dyadic leaves ...
SEGSUM_M = 1024                # ... over one card's families ...
SEGSUM_SHARDS = 4              # ... and over four shards of 256
SEGSUM_AREA_TOL = 1e-15        # 25b: forced credit against the default
DIST_PROCESSES = 2             # 25c: the distributed workers
DIST_K = 2                     # 25c: requests served over their group


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mode_args(mode: str):
    """(rule, scout) of a step machine."""
    from ppls_tpu_torch.config import Rule
    return {"step": (Rule.TRAPEZOID, False),
            "step_scout": (Rule.TRAPEZOID, True),
            "step_simpson": (Rule.SIMPSON, False)}[mode]


def clone(inp: dict) -> dict:
    from ppls_tpu_torch.parallel.walker import WalkState
    out = dict(inp, state=WalkState(*(t.clone() for t in inp["state"])))
    for k in ("slot", "nslots"):
        if k in inp:
            out[k] = inp[k].clone()
    for k in ("bank", "resm"):
        if k in inp:
            out[k] = tuple(t.clone() for t in inp[k])
    return out


def timed(fn):
    """(fn(), milliseconds by CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def compare(what: str, outs_k, outs_p) -> float:
    """Require bit-equality of every output; returns the max abs error
    over the float outputs (0.0 when equal)."""
    import torch
    max_err = 0.0
    for a, b in zip(outs_k, outs_p):
        if a.dtype == torch.float32:
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
            max_err = max(max_err, float((a - b).abs().max()))
        else:
            same = torch.equal(a, b)
        if not same:
            raise AssertionError(f"{what}: kernel and plain segment differ")
    return max_err


def operation_counts(f_ds, fma=None) -> dict:
    """float32 arithmetic operations (add, sub, mul, div, neg, abs,
    round) of one ds eval, one scout eval and the non-eval work of one
    trapezoid and one Simpson step, counted by running the plain PyTorch
    twins on one lane under a counting function mode; and the depth of
    their longest chain of dependent operations (a select counted as
    one, a division as the DIV_CHAIN_OPS dependent operations of its
    SASS), the step's latency at one warp per scheduler.

    The twins compute each two-product in Dekker's form (17 operations,
    about 9 deep). With ``fma`` (default: the kernels' choice for this
    body, every body but gauss_center: csrc/walk_step.cuh fma_product,
    held by tests/test_torch_two_prod.py) the kernels' FMA form is
    counted in its place: a multiply and an FMA, 3 operations (the FMA
    counted as two, as the float32 peak counts it) and 2 deep. The
    Dekker counts stay beside them under ``dekker``."""
    import torch
    from torch.overrides import TorchFunctionMode
    from ppls_tpu_torch.ops import ds_kernel, scout_kernel
    from ppls_tpu_torch.parallel import walker as W

    if fma is None:
        from ppls_tpu_torch.models.integrands import KERNEL_GAUSS_CENTER
        fma = f_ds.kernel_family != KERNEL_GAUSS_CENTER
    divisions = {"div", "true_divide", "__rtruediv__", "__rdiv__"}
    arith = {"add", "sub", "mul", "neg", "abs", "round", "__radd__",
             "__rsub__", "__rmul__"} | divisions

    def depth(x):
        return getattr(x, "_chain", 0) if isinstance(x, torch.Tensor) else 0

    class Count(TorchFunctionMode):
        n = 0
        off = False

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if Count.off:
                return out
            name = getattr(func, "__name__", "")
            floats = any(isinstance(a, torch.Tensor) and a.is_floating_point()
                         for a in args)
            step = 1 if (name in arith and floats) or name == "where" else 0
            step = DIV_CHAIN_OPS if name in divisions and floats else step
            Count.n += 1 if name in arith and floats else 0
            d = step + max([depth(a) for a in args] + [0])
            if isinstance(out, torch.Tensor) and d:
                out._chain = d
            return out

    dekker = ds_kernel.two_prod

    def fma_two_prod(a, b):
        # the kernels' p = a * b, e = fma(a, b, -p): the same bits
        Count.off = True
        try:
            p, e = dekker(a, b)
        finally:
            Count.off = False
        Count.n += 3
        p._chain = 1 + max(depth(a), depth(b))
        e._chain = p._chain + 1
        return p, e

    def count(fn, *args):
        Count.n = 0
        with Count():
            out = fn(*args)
        leaves = out if isinstance(out, tuple) else (out,)
        return Count.n, max(depth(t) for t in leaves)

    one = torch.full((1,), 0.5, dtype=torch.float32)
    zero = torch.zeros(1, dtype=torch.float32)
    x, th = (one, zero), (one * 2, zero)
    s = W._fresh_lanes(1, "cpu")._replace(
        flags=torch.zeros(1, dtype=torch.int32),
        w_h=torch.full((1,), 0.25, dtype=torch.float32))

    def counts():
        ds_eval, ds_depth = count(f_ds, x, th)
        sc_eval, sc_depth = count(W.scout_twin(f_ds), x, th)
        trap, trap_depth = count(W._step_trap, s, f_ds, 1e-10)
        simpson, simpson_depth = count(W._step_simpson, s, f_ds, 1e-10)
        return dict(ds_eval=ds_eval, scout_eval=sc_eval,
                    step_overhead=trap - ds_eval,
                    simpson_overhead=simpson - ds_eval,
                    chain=dict(ds_eval=ds_depth, scout_eval=sc_depth,
                               step=trap_depth, simpson_step=simpson_depth))

    out = dict(counts(), fma=bool(fma))
    out["dekker"] = dict(out)
    if fma:
        ds_kernel.two_prod = scout_kernel.two_prod = fma_two_prod
        try:
            out.update(counts())
        finally:
            ds_kernel.two_prod = scout_kernel.two_prod = dekker
    return out


def bound_ms(n_bytes: int, live_steps: int, scout_evals: int,
             confirm_evals: int, ops: dict, mode: str):
    """Least time for a launch's work: the bytes it must move (inputs
    read once, outputs written once) over HBM bandwidth, or the float32
    operations this run's data needed over the float32 peak, whichever
    is larger. ``live_steps`` are the live (eval_active) lane-steps.
    Returns (bound_ms, "bytes" or "operations")."""
    if mode == "step_scout":
        n_ops = (scout_evals * ops["scout_eval"]
                 + confirm_evals * ops["ds_eval"]
                 + live_steps * ops["step_overhead"])
    elif mode == "step_simpson":
        n_ops = live_steps * (ops["ds_eval"] + ops["simpson_overhead"])
    else:
        n_ops = live_steps * (ops["ds_eval"] + ops["step_overhead"])
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = n_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def chain_us(ops: dict, mode: str) -> float:
    """The step's longest chain of dependent operations at
    DEP_LATENCY_CYCLES each and the card's top SM clock: the least time
    of one step at one warp per scheduler, where nothing hides a
    dependent operation's latency (a division counted as the
    DIV_CHAIN_OPS operations of its SASS fast path). The scouting step is
    its scout eval's chain and then the trapezoid step's (the confirm and
    the tail)."""
    c = ops["chain"]
    depth = {"step_scout": c["scout_eval"] + c["step"],
             "step_simpson": c["simpson_step"]}.get(mode, c["step"])
    return depth * DEP_LATENCY_CYCLES / (sm_clock_ghz() * 1e3)


@functools.lru_cache(maxsize=1)
def sm_clock_ghz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) / 1e3


def ptxas_registers(log: str) -> dict:
    """Registers per kernel variant from an nvcc -Xptxas -v log:
    {"FAM,MODE[,THETA]": registers}, the template arguments read from
    each entry's mangled name."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            args = re.findall(r"L[ib](\d+)E", entry.split("_kernel")[-1])
            regs[",".join(args)] = int(m.group(1))
            entry = None
    return regs


def regs_line(name: str, regs: dict, family: int) -> str:
    """One kernel's registers: per step machine of `family`, and the
    range over every variant."""
    own = {k: v for k, v in regs.items() if k.split(",")[0] == str(family)}
    return (f"{name} registers: family {family} {own}; all "
            f"{len(regs)} variants {min(regs.values())}-"
            f"{max(regs.values())}")


def k1_bytes(inp: dict) -> int:
    lanes = inp["slot"].shape[0]
    R = inp["bank"][0].shape[0]
    lane_in = STATE_BYTES + 2 * 4 + 3 * 4        # state, slot/nslots, resm
    bytes_in = lanes * lane_in + 7 * 4 * R * lanes
    bytes_out = lanes * (STATE_BYTES + 4 + 3 * 4) + 2 * 4 * R * lanes + 8 * 4
    return bytes_in + bytes_out


def kernel_runs(prepare, n: int = 5):
    """(last outputs, median ms, the n ms) of n launches after one
    warm-up launch, each on the fresh copies prepare() makes before it
    returns the launch, timed by CUDA events around the launch's device
    work (ppls_tpu_torch/tools/time_k1.py kernel_times)."""
    import numpy as np
    from ppls_tpu_torch.tools.time_k1 import kernel_times
    outs, ms = kernel_times([prepare() for _ in range(n + 1)])
    return outs[-1], float(np.median(ms[1:])), ms[1:]


def fmt_cmp(what: str, c: dict, times) -> str:
    """One log line of a kernel-versus-plain record (and of its reference
    twin's alternated launches, where it has them)."""
    line = (f"[smoke] {what}: bit-equal to the plain segment; "
            f"{c['counters'][0]} steps; kernel {c['ms']:.3f} ms (runs "
            f"{', '.join(f'{t:.3f}' for t in times)}), "
            f"{c['us_per_step']:.3f} us/step, plain {c['plain_ms']:.1f} ms, "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}; with Dekker "
            f"two-products {c['bound_dekker_ms']:.4f}), dependent chain "
            f"{c['chain_us_per_step']:.3f} us/step; counters "
            f"{c['counters']}")
    ref = c.get("reference_twin")
    if ref is not None:
        line += (f"; reference twin on the same inputs, alternated: "
                 f"{ref['ms']:.3f} ms (runs "
                 f"{', '.join(f'{t:.3f}' for t in ref['runs'])}), "
                 f"{ref['us_per_step']:.3f} us/step, {ref['steps']} "
                 f"steps; reduced / reference us/step {ref['ratio']:.3f}")
    return line


def cmp_k1(W, what, base, f_ds, eps, mode, ops, runs=5, theta_block=1,
           cap=CMP_CAP):
    """K1 on copies of one dealt bank, ``cap`` steps: the median of
    ``runs`` kernel launches (kernel_runs), then the plain segment,
    every output held bit-equal. Returns (record, the kernel ms of each
    run)."""
    rule, scout = mode_args(mode)
    kw = dict(theta_block=theta_block) if theta_block > 1 else {}

    def prepare(fn):
        inp = clone(base)

        def launch():
            resh, resl, ctr = fn(
                inp["state"], inp["slot"], inp["thresh"], cap,
                inp["batch"], inp["nslots"], inp["bank"], inp["resm"],
                f_ds=f_ds, eps=eps, scout=scout, rule=rule, **kw)
            return [*inp["state"], inp["slot"], *inp["resm"], resh, resl,
                    ctr]
        return launch

    outs_k, kernel_ms, times = kernel_runs(
        lambda: prepare(W.run_segment_rf), runs)
    outs_p, plain_ms = timed(prepare(W.segment_rf_plain))
    ctr = outs_k[-1].tolist()
    bound, bound_by = bound_ms(k1_bytes(base), ctr[1], ctr[6], ctr[7], ops,
                               mode)
    rec = dict(ms=kernel_ms, plain_ms=plain_ms,
               max_abs_err=compare(what, outs_k, outs_p), bound_ms=bound,
               bound_by=bound_by, counters=ctr,
               us_per_step=1e3 * kernel_ms / ctr[0],
               bound_dekker_ms=bound_ms(k1_bytes(base), ctr[1], ctr[6],
                                        ctr[7], ops["dekker"], mode)[0],
               chain_us_per_step=chain_us(ops, mode))
    return rec, times


def cmp_k2(W, what, base, f_ds, eps, mode, ops, runs=5, theta_block=1,
           cap=CMP_CAP):
    """K2 on copies of seeded lanes, ``cap`` steps at the seeding's exit
    threshold, as :func:`cmp_k1`; the waste must reconcile. With
    ``theta_block`` > 1 (K2's theta variant) the bound counts every live
    lane-step, theta_overwalk too: a retired lane still evaluates."""
    import torch
    rule, scout = mode_args(mode)
    kw = dict(theta_block=theta_block) if theta_block > 1 else {}

    def prepare(fn):
        inp = clone(base)

        def launch():
            ctr = fn(inp["state"], inp["thresh"], cap, f_ds=f_ds,
                     eps=eps, scout=scout, rule=rule, **kw)
            return [*inp["state"], ctr]
        return launch

    def kernel(*args, **kw):          # the wrapper's counters, as one tensor
        _, steps, waste, evals = W.run_segment_ee(*args, **kw)
        return torch.cat([steps.reshape(1), waste, evals])

    outs_k, kernel_ms, times = kernel_runs(lambda: prepare(kernel), runs)
    outs_p, plain_ms = timed(prepare(W.segment_ee_plain))
    ctr = outs_k[-1].tolist()
    lanes = base["state"].a_h.shape[0]
    if sum(ctr[1:5]) != ctr[0] * lanes:
        raise AssertionError(f"{what}: waste does not reconcile")
    n_bytes = 2 * lanes * STATE_BYTES + 7 * 4
    live = ctr[1] + ctr[4]
    bound, bound_by = bound_ms(n_bytes, live, ctr[5], ctr[6], ops, mode)
    rec = dict(ms=kernel_ms, plain_ms=plain_ms,
               max_abs_err=compare(what, outs_k, outs_p), bound_ms=bound,
               bound_by=bound_by, counters=ctr,
               us_per_step=1e3 * kernel_ms / ctr[0],
               bound_dekker_ms=bound_ms(n_bytes, live, ctr[5], ctr[6],
                                        ops["dekker"], mode)[0],
               chain_us_per_step=chain_us(ops, mode))
    return rec, times


def twin_pair(kernel, base, f_ds, ref_ds, eps, mode, runs):
    """The range-reduced twin ``f_ds`` and its reference twin ``ref_ds``
    on copies of the same K1 bank or K2 lanes, ``runs`` CAP-step launches
    each in alternation (ppls_tpu_torch/tools/time_k1.py _timed_pairs):
    the reference twin's median ms, runs and us/step, and the ratio of
    the two medians (reduced / reference)."""
    import numpy as np
    from ppls_tpu_torch.tools.time_k1 import (_timed_pairs, k1_prepare,
                                              k2_prepare)
    rule, scout = mode_args(mode)

    def prep(twin):
        if kernel == "k1":
            return k1_prepare(base, twin, eps, scout, rule=rule)
        return k2_prepare(base, twin, eps, scout, base["thresh"], rule=rule)
    got = _timed_pairs({"reduced": prep(f_ds), "reference": prep(ref_ds)},
                       runs)
    (red, red_steps), (ref, steps) = got["reduced"], got["reference"]
    ms = float(np.median(ref))
    return dict(ms=ms, runs=ref, steps=steps, us_per_step=1e3 * ms / steps,
                ratio=float(np.median(red)) / red_steps / (ms / steps))


def cmp_k3(W, what, base, f_ds, eps, mode, ops, runs=5):
    """K3 on copies of seeded lanes, CMP_CAP steps, held bit-equal to the
    plain segment and to K2 with no exit (thresh -1) on the same lanes,
    whose counters give the live lane-steps."""
    rule, _ = mode_args(mode)

    def prepare(fn):
        inp = clone(base)

        def launch():
            fn(inp["state"], CMP_CAP, f_ds=f_ds, eps=eps, rule=rule)
            return list(inp["state"])
        return launch

    outs_k, kernel_ms, times = kernel_runs(lambda: prepare(W.run_segment),
                                           runs)
    outs_p, plain_ms = timed(prepare(W.segment_plain))
    max_err = compare(what, outs_k, outs_p)
    twin = clone(base)
    _, steps, waste, evals = W.run_segment_ee(
        twin["state"], -1, CMP_CAP, f_ds=f_ds, eps=eps, scout=False,
        rule=rule)
    compare(f"{what} vs K2 with no exit", outs_k, list(twin["state"]))
    live = int(waste[0])
    bound, bound_by = bound_ms(2 * LANES * STATE_BYTES, live, 0, 0, ops,
                               mode)
    return dict(ms=kernel_ms, plain_ms=plain_ms, max_abs_err=max_err,
                bound_ms=bound, bound_by=bound_by, live_lane_steps=live,
                counters=[CMP_CAP], us_per_step=1e3 * kernel_ms / CMP_CAP,
                bound_dekker_ms=bound_ms(2 * LANES * STATE_BYTES, live, 0,
                                         0, ops["dekker"], mode)[0],
                chain_us_per_step=chain_us(ops, mode)), times


def phase_k1(W, f_theta, f_ds, theta, ops) -> dict:
    cmp = {}
    for mode in MODES:
        rule, scout = mode_args(mode)
        t0 = time.perf_counter()
        base = W.first_phase_inputs(
            f_theta, theta, BOUNDS, EPS, lanes=LANES,
            roots_per_lane=ROOTS_PER_LANE, refill_slots=REFILL_SLOTS,
            capacity=CAPACITY, scout=scout, rule=rule, device="cuda")
        log(f"[smoke] K1 {mode}: bank dealt in "
            f"{time.perf_counter() - t0:.1f} s: "
            f"{int(base['nslots'].sum())} roots over {LANES} lanes x "
            f"{REFILL_SLOTS} slots, thresh {base['thresh']}, batch "
            f"{base['batch']}")
        cmp[mode], times = cmp_k1(W, f"K1 {mode}", base, f_ds, EPS, mode,
                                  ops)
        log(fmt_cmp(f"K1 {mode}", cmp[mode], times))
    return cmp


def seeded_lanes(W, f_theta, theta, rule) -> dict:
    t0 = time.perf_counter()
    base = W.first_phase_inputs(
        f_theta, theta, BOUNDS, EPS, lanes=LANES,
        roots_per_lane=ROOTS_PER_LANE, refill_slots=0, capacity=CAPACITY,
        scout=False, rule=rule, device="cuda")
    log(f"[smoke] {rule.name} lanes seeded in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{int(((base['state'].flags & 4) == 0).sum())} of {LANES} lanes "
        f"hold a root, thresh {base['thresh']}")
    return base


def phase_k2(W, f_ds, seeded, ops, regs) -> tuple:
    """K2 against its plain segment in the three step machines, its
    registers, and its co-resident blocks in every variant (the
    cooperative grid of LANES lanes must fit, never shrunk): (records,
    blocks per variant)."""
    import torch
    cmp = {}
    for mode in MODES:
        cmp[mode], times = cmp_k2(W, f"K2 {mode}", seeded[mode_args(mode)[0]],
                                  f_ds, EPS, mode, ops)
        log(fmt_cmp(f"K2 {mode}", cmp[mode], times))
    log(f"[smoke] {regs_line('K2', regs, f_ds.kernel_family)}")
    index = torch.cuda.current_device()
    blocks = {f"{fam},{mode}": W._max_blocks("walk_ee", index, fam, mode, 0)
              for fam in range(8) for mode in range(3)}
    need = LANES // W.KERNEL_THREADS
    log(f"[smoke] K2 co-resident blocks: {min(blocks.values())}-"
        f"{max(blocks.values())} over {len(blocks)} variants (the grid "
        f"needs {need})")
    if min(blocks.values()) < need:
        raise AssertionError(f"K2: a variant holds fewer than {need} "
                             f"co-resident blocks: {blocks}")
    return cmp, blocks


def phase_k3(W, f_ds, seeded, ops, regs) -> dict:
    """K3 against its plain segment in both step machines; then
    K3_SMI_RUNS more launches of each with nvidia-smi's clocks.sm and
    power.draw sampled beside them; the summary line: us per step, the
    step's dependent chain, the bound and its share, registers,
    clocks."""
    from ppls_tpu_torch.tools.k3_split import SmiSampler
    cmp = {}
    for mode in ("step", "step_simpson"):
        rule = mode_args(mode)[0]
        cmp[mode], times = cmp_k3(W, f"K3 {mode}", seeded[rule], f_ds, EPS,
                                  mode, ops)
        log(fmt_cmp(f"K3 {mode} (and K2 with no exit)", cmp[mode], times)
            + f"; {cmp[mode]['live_lane_steps']} live lane-steps")

        def prepare(rule=rule):
            state = clone(seeded[rule])["state"]
            return lambda: W.run_segment(state, CMP_CAP, f_ds=f_ds, eps=EPS,
                                         rule=rule)
        with SmiSampler(0.05) as smi:
            _, burst_ms, _ = kernel_runs(prepare, K3_SMI_RUNS)
        c = cmp[mode]
        c.update(bound_share=c["bound_ms"] / c["ms"], burst_ms=burst_ms,
                 smi=smi.summary(), registers=regs[
                     f"{f_ds.kernel_family},{W.step_mode(rule, False)}"])
    log(f"[smoke] {regs_line('K3', regs, f_ds.kernel_family)}")
    t, sm = cmp["step"], cmp["step_simpson"]
    clk = t["smi"].get("clocks.sm", {})
    log(f"[smoke] K3 on the flagship's lanes: "
        f"trapezoid {t['us_per_step']:.4f} us/step, Simpson "
        f"{sm['us_per_step']:.4f} ({K3_SMI_RUNS} more launches: "
        f"{t['burst_ms']:.4f} / {sm['burst_ms']:.4f} ms); the step's "
        f"dependent chain (a division {DIV_CHAIN_OPS} operations) "
        f"{t['chain_us_per_step']:.4f} / {sm['chain_us_per_step']:.4f} "
        f"us/step; bound {t['bound_ms']:.4f} / {sm['bound_ms']:.4f} ms, "
        f"share {t['bound_share']:.3f} / {sm['bound_share']:.3f}; "
        f"registers {t['registers']} / {sm['registers']}; clocks.sm "
        f"{clk.get('median')} MHz (min {clk.get('min')}, max "
        f"{clk.get('max')}, {t['smi'].get('samples')} samples), power.draw "
        f"{t['smi'].get('power.draw', {}).get('median')} W")
    return cmp


def phase_barrier(W, f_ds, base, regs, pairs: int = 7) -> dict:
    """K2 with no exit (thresh -1) does K3's work step for step, plus
    the block reductions, the split count (arrive, then wait after the
    speculative step) and the state copy per step: the two alternated on
    copies of the same lanes, medians by CUDA events around each
    launch's device work."""
    import numpy as np
    from ppls_tpu_torch.tools.time_k1 import kernel_times

    def prepare_k2():               # with no exit
        state = clone(base)["state"]
        return lambda: W.run_segment_ee(state, -1, CMP_CAP, f_ds=f_ds,
                                        eps=EPS, scout=False)

    def prepare_k3():
        state = clone(base)["state"]
        return lambda: W.run_segment(state, CMP_CAP, f_ds=f_ds, eps=EPS)
    _, ms = kernel_times([prep() for _ in range(pairs + 1)
                          for prep in (prepare_k2, prepare_k3)])
    k2, k3 = ms[2::2], ms[3::2]          # the first pair warms up
    us2 = 1e3 * float(np.median(k2)) / CMP_CAP
    us3 = 1e3 * float(np.median(k3)) / CMP_CAP
    trap = f"{f_ds.kernel_family},0"
    out = dict(k2_us_per_step=us2, k3_us_per_step=us3,
               barrier_us_per_step=us2 - us3, barrier_share=1 - us3 / us2,
               k2_ms=k2, k3_ms=k3,
               k2_registers=regs["walk_ee"][trap + ",0"],   # T = 1
               k3_registers=regs["walk_seg"][trap])
    log(f"[smoke] barrier: K2 with no exit {us2:.3f} us/step "
        f"({out['k2_registers']} registers), K3 {us3:.3f} us/step "
        f"({out['k3_registers']} registers) on the same lanes ({pairs} "
        f"alternated pairs, K2 ms {', '.join(f'{t:.3f}' for t in k2)}; K3 "
        f"ms {', '.join(f'{t:.3f}' for t in k3)}): the grid count and "
        f"barrier cost {us2 - us3:.3f} us per step, "
        f"{out['barrier_share']:.3f} of K2's step")
    return out


def phase_k1_theta(W, f_theta, f_ds, ops) -> dict:
    """K1's theta variants against the plain theta segment, bit for bit,
    one bred and dealt theta bank per (T, step machine)."""
    import numpy as np
    cmp = {}
    for T, mode in THETA_CMP:
        _, scout = mode_args(mode)
        m = LANES // T
        theta = np.linspace(*THETA_RANGE, m * T).reshape(m, T)
        base = W.first_phase_inputs(
            f_theta, theta, THETA_BOUNDS, THETA_EPS, lanes=LANES,
            roots_per_lane=ROOTS_PER_LANE, refill_slots=REFILL_SLOTS,
            capacity=CAPACITY, scout=scout, theta_block=T, device=DEVICE)
        key = f"{T}" + ("_scout" if scout else "")
        cmp[key], times = cmp_k1(W, f"K1 theta T={T} {mode}", base, f_ds,
                                 THETA_EPS, mode, ops, theta_block=T)
        ctr = cmp[key]["counters"]
        if sum(ctr[1:6]) != ctr[0] * LANES:
            raise AssertionError(f"K1 theta T={T}: waste does not "
                                 f"reconcile")
        cmp[key].update(T=T, mode=mode, roots=int(base["nslots"].sum()) // T)
        log(fmt_cmp(f"K1 theta T={T} {mode}", cmp[key], times)
            + f"; {cmp[key]['roots']} roots dealt to {LANES // T} groups")
    a, b = cmp["128"], cmp["256"]
    log(f"[smoke] K1 theta, the vote across blocks: T=256 "
        f"{b['us_per_step']:.3f} us/step against T=128 "
        f"{a['us_per_step']:.3f} ({b['us_per_step'] - a['us_per_step']:+.3f}"
        f" us/step; 256-step launches {b['ms']:.3f} / {a['ms']:.3f} ms)")
    return cmp


def k1_attribution(k1: dict, k2: dict, barrier: dict, k1_theta: dict) -> dict:
    """Where K1's step goes, per step machine, from this run's 256-step
    launches: us per step; the confirm share (confirm evals / 3 over the
    live lane-steps: the lane-steps that ran the three-point ds confirm);
    K2's us per step on lanes that do the same work (the same steps, live
    lane-steps and evals), so K1's step minus K2's is K1's refill test,
    five-bucket classification and two-count barrier; the barrier (K2
    with no exit against K3, the same work without it); and theta mode's
    T = 256 minus T = 128 (the group vote across blocks)."""
    gap = k1_theta["256"]["us_per_step"] - k1_theta["128"]["us_per_step"]
    out = dict(barrier_us_per_step=barrier["barrier_us_per_step"],
               barrier_share=barrier["barrier_share"],
               theta_256_minus_128_us=gap)
    for mode in MODES:
        c1, c2 = k1[mode]["counters"], k2[mode]["counters"]
        same = (c1[0], c1[1], c1[6], c1[7]) == (c2[0], c2[1], c2[5], c2[6])
        share = c1[7] / 3 / c1[1] if c1[1] else 0.0
        us1, us2 = k1[mode]["us_per_step"], k2[mode]["us_per_step"]
        out[mode] = dict(us_per_step=us1, confirm_share=share,
                         k2_us_per_step=us2, k1_minus_k2_us=us1 - us2,
                         same_work_as_k2=same)
        log(f"[smoke] K1 step attribution, {mode}: {us1:.3f} us/step; "
            f"confirm share {share:.4f}; K2 {us2:.3f} us/step on lanes "
            f"doing {'the same' if same else 'other'} work (K1 - K2 "
            f"{us1 - us2:+.3f} us: refill test, classification, two "
            f"counts)")
    log(f"[smoke] K1 step attribution: the grid count and barrier "
        f"{barrier['barrier_us_per_step']:.3f} us/step ("
        f"{barrier['barrier_share']:.3f} of K2's step with no exit); "
        f"theta T=256 minus T=128 {gap:+.3f} us/step")
    return out


def check_walk(what: str, res, shape) -> None:
    import numpy as np
    areas = np.asarray(res.areas)
    if isinstance(shape, int):
        shape = (shape,)
    if not np.all(np.isfinite(areas)) or areas.shape != tuple(shape):
        raise AssertionError(f"{what}: non-finite or misshapen areas")
    mt = res.metrics
    if mt.tasks != mt.splits + mt.leaves:
        raise AssertionError(f"{what}: tasks != splits + leaves")
    att = res.attribution()
    if not att["reconciles"]:
        raise AssertionError(f"{what}: waste does not reconcile {att}")


def main_path(W, f_theta, f_ds, theta, kw, counter, what: str):
    """A warm-up run, then a timed run with every kernel's launch count
    set to 0 before and read after. Returns (result, wall s, launches)."""
    import torch
    t0 = time.perf_counter()
    W.integrate_family_walker(f_theta, f_ds, theta, BOUNDS, EPS, **kw)
    torch.cuda.synchronize()
    log(f"[smoke] {what} warm-up run: {time.perf_counter() - t0:.2f} s")
    kernels = (W.run_segment_rf, W.run_segment_ee, W.run_segment)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = W.integrate_family_walker(f_theta, f_ds, theta, BOUNDS, EPS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    check_walk(what, res, len(theta))
    if counter.launches <= 0:
        raise AssertionError(f"{what}: {counter.__name__} was never "
                             f"launched")
    return res, wall, launches


def profile_run(W, f_theta, f_ds, theta, kw, kernel: str, out_dir, tag,
                bounds=BOUNDS, eps=EPS):
    return profile_fn(lambda: W.integrate_family_walker(
        f_theta, f_ds, theta, bounds, eps, **kw), kernel, out_dir, tag)


def profile_fn(fn, kernel: str, out_dir, tag):
    """One run of ``fn`` under ``torch.profiler``: wall, device busy time,
    idle share and ``kernel``'s time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ppls_tpu_torch.utils.tracing import device_busy_us
    from ppls_tpu_torch.utils.tracing import device_self_us as dev_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    post_s = time.perf_counter() - t0 - wall_ms / 1e3
    busy_ms = device_busy_us(events) / 1e3
    # the sum over every entry, CPU ops included, as PR 11 and earlier
    # read it: each kernel twice
    all_ms = sum(dev_us(e) for e in events) / 1e3
    k_ms = sum(dev_us(e) for e in events if kernel in e.key) / 1e3
    by_dev = sorted(events, key=dev_us, reverse=True)
    with open(os.path.join(out_dir, f"chip_smoke_profile_{tag}.txt"),
              "w") as fh:
        for e in by_dev[:40]:
            fh.write(f"{dev_us(e) / 1e3:12.3f} ms  {e.count:8d}  {e.key}\n")
    if busy_ms > 0:
        log(f"[smoke] profile {tag}: wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}; "
            f"every entry summed: {all_ms:.1f} ms), {kernel} {k_ms:.1f} "
            f"ms; the profile's processing {post_s:.1f} s")
        for e in by_dev[:8]:
            log(f"[smoke]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
                f"{e.key[:80]}")
    else:
        log(f"[smoke] profile {tag}: the profiler recorded no device time "
            f"(device busy share not measured)")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernel_ms=k_ms,
                busy_ms_every_entry=all_ms, processing_s=post_s,
                idle_share=(1 - busy_ms / wall_ms) if busy_ms > 0 else None)


def concurrently(*fns):
    """Run each of ``fns`` on a thread of its own: their results, in
    order, once all ended (the first one's error raised)."""
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(len(fns)) as pool:
        futures = [pool.submit(fn) for fn in fns]
    return [f.result() for f in futures]


class WorldStarts:
    """Counts the ``mesh.World``s built while entered: ``spawned`` those
    of more than one rank (their ranks 1..n-1 spawned), ``single`` those
    of one rank in this process."""

    def __init__(self):
        self.spawned = self.single = 0

    def __enter__(self):
        from ppls_tpu_torch.parallel.mesh import World
        init = self._init = World.__init__
        lock = threading.Lock()

        def counting(world, n, *args, **kw):
            with lock:
                if int(n) > 1:
                    self.spawned += 1
                else:
                    self.single += 1
            init(world, n, *args, **kw)
        World.__init__ = counting
        return self

    def __exit__(self, *exc):
        from ppls_tpu_torch.parallel.mesh import World
        World.__init__ = self._init

    def as_dict(self) -> dict:
        return dict(spawned=self.spawned, single=self.single)


def counted(W, fn):
    """(fn(), wall s, launches): every kernel's launch count set to 0
    just before ``fn`` and read just after it."""
    import torch
    kernels = (W.run_segment_rf, W.run_segment_ee, W.run_segment)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k.__name__: k.launches for k in kernels}


def phase_theta_leg(W, f_theta, f_ds, family_exact) -> dict:
    """The reference bench's theta leg on the port: bookkeeping per
    theta (kernel steps plus rounds and segments, over T) against a
    T = 1 solo sweep, and the per-theta quality contract."""
    import numpy as np
    samples = np.linspace(*THETA_RANGE, THETA_SOLO_SAMPLES)
    ex_s = family_exact(THETA_FAMILY, *THETA_BOUNDS, samples)
    kw = dict(THETA_KW, lanes=THETA_LANES, device=DEVICE)
    solo_bk, solo_err = [], []
    t0 = time.perf_counter()
    for t, e in zip(samples, ex_s):
        r = W.integrate_family_walker(f_theta, f_ds, [t], THETA_BOUNDS,
                                      THETA_EPS, **kw)
        check_walk(f"theta leg solo {t}", r, 1)
        solo_bk.append(r.kernel_steps + r.metrics.rounds)
        solo_err.append(abs(float(r.areas[0]) - float(e)))
    t1_per_theta = float(np.mean(solo_bk))
    solo_err = np.asarray(solo_err)
    log(f"[smoke] theta leg: T=1 solo sweep of {THETA_SOLO_SAMPLES} thetas "
        f"({time.perf_counter() - t0:.2f} s): bookkeeping per theta "
        f"{t1_per_theta:.2f}, max |area - exact| {solo_err.max():.3e}")
    legs = {}
    for T in THETA_FULL_T:
        thetas = np.linspace(*THETA_RANGE, T)
        thetas[:THETA_SOLO_SAMPLES] = samples
        thetas = thetas.reshape(1, T)
        r, wall, launches = counted(W, lambda: W.integrate_family_walker(
            f_theta, f_ds, thetas, THETA_BOUNDS, THETA_EPS, theta_block=T,
            **kw))
        check_walk(f"theta leg T={T}", r, (1, T))
        ex = family_exact(THETA_FAMILY, *THETA_BOUNDS, thetas)
        err = float(np.max(np.abs(r.areas - ex)))
        sample_err = np.abs(r.areas[0, :THETA_SOLO_SAMPLES] - ex_s)
        bk = r.kernel_steps + r.metrics.rounds
        att = r.attribution()
        leg = dict(
            kernel_steps=r.kernel_steps, rounds_plus_segments=r.metrics.rounds,
            bookkeeping_per_theta=bk / T,
            reduction_vs_t1=t1_per_theta / max(bk / T, 1e-12),
            overwalk_share=att["buckets"]["theta_overwalk"]
            / max(att["lane_steps"], 1),
            wall_s=wall, tasks=r.metrics.tasks, cycles=r.cycles,
            launches=launches, max_abs_err=err,
            quality_vs_solo_ok=bool(np.all(sample_err
                                           <= solo_err + THETA_EPS)),
            reconciles=bool(att["reconciles"]))
        legs[T] = leg
        log(f"[smoke] theta leg T={T}: {leg['kernel_steps']} kernel steps, "
            f"{leg['rounds_plus_segments']} rounds + segments, bookkeeping "
            f"per theta {leg['bookkeeping_per_theta']:.3f} (reduction "
            f"{leg['reduction_vs_t1']:.2f}x vs T=1), theta_overwalk share "
            f"{leg['overwalk_share']:.4f}, wall {wall:.3f} s, "
            f"{r.metrics.tasks} tasks, K1 launches "
            f"{launches['run_segment_rf']}, max |area - exact| {err:.3e}, "
            f"quality vs solo {leg['quality_vs_solo_ok']}")
        if not (leg["quality_vs_solo_ok"] and leg["reconciles"]
                and launches["run_segment_rf"] > 0):
            raise AssertionError(f"theta leg T={T} failed: {leg}")
    if legs[256]["reduction_vs_t1"] < GATE_THETA_MIN_REDUCTION:
        raise AssertionError(f"theta leg T=256: reduction "
                             f"{legs[256]['reduction_vs_t1']:.2f} < "
                             f"{GATE_THETA_MIN_REDUCTION}")
    return dict(t1_bookkeeping_per_theta=t1_per_theta,
                solo_max_abs_err=float(solo_err.max()), legs=legs)


def phase_theta_card_cpu(W, f_theta, f_ds, family_exact, out_dir) -> dict:
    """Theta mode on the card against the plain segment on the CPU at
    tests/test_theta_walker.py's configuration; then the theta main path
    at the flagship's lane count, timed and profiled."""
    import numpy as np
    T = THETA_TEST_T
    theta = np.linspace(*THETA_RANGE, T).reshape(1, T)
    out = {}
    for eps in (1e-6, 1e-7):
        for scout in ("f64", "f32"):
            kw = dict(THETA_TEST_KW, theta_block=T, scout_dtype=scout)
            card, _, launches = counted(W, lambda: W.integrate_family_walker(
                f_theta, f_ds, theta, THETA_BOUNDS, eps, device=DEVICE, **kw))
            cpu = W.integrate_family_walker(f_theta, f_ds, theta,
                                            THETA_BOUNDS, eps, device="cpu",
                                            **kw)
            check_walk("theta test config (card)", card, (1, T))
            d = float(np.max(np.abs(card.areas - cpu.areas)))
            log(f"[smoke] theta test config eps {eps:g} scout {scout}: card "
                f"{card.metrics.tasks} tasks / {card.kernel_steps} steps / "
                f"waste {card.waste.tolist()}, CPU {cpu.metrics.tasks} / "
                f"{cpu.kernel_steps} / {cpu.waste.tolist()}; max |card - "
                f"CPU| {d:.3e} (tol {AREA_TOL_DEVICES}); K1 launches "
                f"{launches['run_segment_rf']}")
            if (card.metrics.tasks != cpu.metrics.tasks
                    or card.kernel_steps != cpu.kernel_steps
                    or not np.array_equal(card.waste, cpu.waste)
                    or not d < AREA_TOL_DEVICES
                    or launches["run_segment_rf"] <= 0):
                raise AssertionError(f"theta test config eps {eps} scout "
                                     f"{scout}: card and CPU differ")
            out[f"{eps:g}_{scout}"] = dict(
                tasks=card.metrics.tasks, kernel_steps=card.kernel_steps,
                waste=card.waste.tolist(), d_card_cpu=d)
    # the theta main path at the flagship's 16384 lanes
    T, m = THETA_WIDE_T, THETA_WIDE_M
    theta = np.linspace(*THETA_RANGE, m * T).reshape(m, T)
    kw = dict(THETA_KW, lanes=LANES, theta_block=T, device=DEVICE)
    W.integrate_family_walker(f_theta, f_ds, theta, THETA_BOUNDS, THETA_EPS,
                              **kw)                                # warm-up
    r, wall, launches = counted(W, lambda: W.integrate_family_walker(
        f_theta, f_ds, theta, THETA_BOUNDS, THETA_EPS, **kw))
    check_walk("theta main path", r, (m, T))
    exact = family_exact(THETA_FAMILY, *THETA_BOUNDS, theta)
    d_exact = float(np.max(np.abs(r.areas - exact)))
    att = r.attribution()
    log(f"[smoke] theta main path (K1, T={T}, m={m}, {LANES} lanes): wall "
        f"{wall:.3f} s, {r.metrics.tasks} per-theta tasks "
        f"({r.metrics.tasks / wall / 1e6:.3f} M/s), kernel steps "
        f"{r.kernel_steps}, cycles {r.cycles}, launches {launches}, host "
        f"syncs {r.host_syncs}, waste {att['buckets']}; max |area - closed "
        f"form| {d_exact:.3e} over {m * T} thetas (tol {AREA_TOL_EXACT})")
    if not d_exact < AREA_TOL_EXACT or not att["reconciles"] \
            or launches["run_segment_rf"] <= 0:
        raise AssertionError("theta main path failed")
    prof = profile_run(W, f_theta, f_ds, theta, kw, "walk_rf_kernel",
                       out_dir, "theta", bounds=THETA_BOUNDS, eps=THETA_EPS)
    out["wide"] = dict(wall_s=wall, tasks=r.metrics.tasks,
                       kernel_steps=r.kernel_steps, cycles=r.cycles,
                       launches=launches, host_syncs=r.host_syncs,
                       waste=att["buckets"], d_exact=d_exact, profile=prof)
    return out


def stream_sweep_arrivals(rate: float, k: int, seed: int):
    """The reference bench's seeded open-loop arrival phases."""
    import numpy as np
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, k)
    return [int(p) for p in np.floor(np.cumsum(gaps) - gaps[0]).astype(int)]


def overload_run(TS, device: str, over: dict):
    """The reference's overload leg (tools/bench_history.py
    run_stream_slo_proxies, its constants copied) without its fault
    plan, on ``device``."""
    reqs = []
    for i in range(SLO_K):
        tenant, pri = SLO_TENANTS[i % len(SLO_TENANTS)]
        reqs.append((1.0 + i / SLO_K, SLO_BOUNDS,
                     {"tenant": tenant, "priority": pri}))
    eng = TS.StreamEngine(STREAM_FAMILY, SLO_EPS,
                          queue_limit=SLO_QUEUE_LIMIT, quarantine=True,
                          device=device, **dict(SLO_KW, **over))
    return eng.run(reqs, arrival_phase=stream_sweep_arrivals(
        SLO_RATE, SLO_K, SLO_SEED))


def phase_stream(W, TS, f_theta, f_ds, family_exact, out_dir) -> dict:
    """The streaming engine on the card: the reference bench's stream leg
    at full width, the open-loop sweep, and the overload leg card
    against CPU."""
    import dataclasses
    import numpy as np
    import torch
    k = STREAM_K
    theta = 1.0 + np.arange(k) / k
    reqs = [(float(t), BOUNDS) for t in theta]
    exact = family_exact(STREAM_FAMILY, *BOUNDS, theta)
    ekw = dict(STREAM_KW, device=DEVICE)
    wkw = dict(STREAM_BATCH_KW, device=DEVICE)

    def engine(**over):
        return TS.StreamEngine(STREAM_FAMILY, EPS, **dict(ekw, **over))

    def cold_calls(**over):
        """(areas, wall s, rounds + segments, cycles) of K cold
        per-request walker calls after an m = 1 warm-up."""
        kw = dict(wkw, **over)
        W.integrate_family_walker(f_theta, f_ds, [theta[0]], BOUNDS, EPS, **kw)
        areas = np.empty(k)
        rounds = cycles = 0
        t0 = time.perf_counter()
        for i, t in enumerate(theta):
            r1 = W.integrate_family_walker(f_theta, f_ds, [t], BOUNDS, EPS,
                                           **kw)
            areas[i] = r1.areas[0]
            rounds += r1.metrics.rounds
            cycles += r1.cycles
        torch.cuda.synchronize()
        return areas, time.perf_counter() - t0, rounds, cycles

    # a. warm-ups and the K cold calls
    t0 = time.perf_counter()
    engine().run(reqs)
    W.integrate_family_walker(f_theta, f_ds, theta, BOUNDS, EPS, **wkw)
    torch.cuda.synchronize()
    log(f"[smoke] stream and batch warm-up runs: "
        f"{time.perf_counter() - t0:.2f} s")
    cold_areas, cold_wall, cold_rounds, cold_cycles = cold_calls()

    # b. the saturated stream against the batch walker on the same set,
    # alternated (batch, stream) x STREAM_ROUNDS; every stream run is
    # counted, the first one's record kept
    batch_walls, stream_walls, runs = [], [], []
    for _ in range(STREAM_ROUNDS):
        b, w, _ = counted(W, lambda: W.integrate_family_walker(
            f_theta, f_ds, theta, BOUNDS, EPS, **wkw))
        batch_walls.append(w)
        eng = engine()
        res_i, _, launches_i = counted(W, lambda: eng.run(reqs))
        stream_walls.append(res_i.wall_s)
        runs.append((eng, res_i, launches_i))
    eng, res, launches = runs[0]
    batch_wall = float(np.median(batch_walls))
    stream_wall = float(np.median(stream_walls))
    batch_rate = b.metrics.tasks / batch_wall
    log(f"[smoke] stream leg references: batch walker {b.metrics.tasks} "
        f"tasks in {batch_wall:.4f} s (median; runs "
        f"{', '.join(f'{x:.4f}' for x in batch_walls)}; "
        f"{batch_rate / 1e6:.2f} M tasks/s); {k} cold calls {cold_wall:.3f} "
        f"s, {cold_cycles} cycles, {cold_rounds} rounds + segments")
    reg = eng.telemetry.registry
    stream_tasks = int(reg.value("ppls_stream_tasks_total"))
    stream_rate = stream_tasks / stream_wall
    boundaries = int(reg.value("ppls_stream_rounds_total")
                     + reg.value("ppls_stream_segs_total"))
    occ = res.occupancy_summary(LANES)
    sync = res.host_syncs_per_phase
    d_cold = float(np.max(np.abs(res.areas - cold_areas)))
    d_exact = float(np.max(np.abs(res.areas - exact)))
    out = dict(
        requests_per_sec=k / stream_wall, wall_s=stream_wall,
        stream_walls=stream_walls, phases=res.phases, tasks=stream_tasks,
        stream_tasks_per_sec=stream_rate, batch_tasks_per_sec=batch_rate,
        vs_batch=stream_rate / batch_rate, batch_wall_s=batch_wall,
        batch_walls=batch_walls, batch_tasks=b.metrics.tasks,
        batch_cycles=b.cycles, batch_host_syncs=b.host_syncs,
        cold_wall_s=cold_wall, vs_cold_wall=cold_wall / stream_wall,
        cold_rounds_plus_segs=cold_rounds,
        stream_rounds_plus_segs=boundaries,
        boundary_proxy_ratio=cold_rounds / max(boundaries, 1),
        launches=launches, host_syncs=res.host_syncs,
        host_syncs_per_phase=sync,
        kernel_steps=int(reg.value("ppls_stream_wsteps_total")),
        lane_efficiency=occ["lane_efficiency"],
        walker_fraction=occ["walker_fraction"],
        waste=occ["attribution"]["buckets"], latency=res.latency_percentiles(),
        d_cold=d_cold, d_exact=d_exact)
    log(f"[smoke] stream saturated ({k} requests at phase 0): "
        f"{out['requests_per_sec']:.2f} req/s, wall {stream_wall:.4f} s "
        f"(median; runs {', '.join(f'{x:.4f}' for x in stream_walls)}), "
        f"{res.phases} phases (batch walker {b.cycles} cycles, "
        f"{b.host_syncs} host syncs), {stream_tasks} tasks "
        f"({stream_rate / 1e6:.2f} M tasks/s; stream/batch tasks/s "
        f"{out['vs_batch']:.3f}, reference target >= 0.9, not gated), "
        f"cold/stream wall {out['vs_cold_wall']:.2f}x, boundary proxy "
        f"{out['boundary_proxy_ratio']:.2f}x ({cold_rounds} / {boundaries}), "
        f"launches {launches}, kernel steps {out['kernel_steps']}, host "
        f"syncs {res.host_syncs} ({res.host_syncs / max(len(sync), 1):.2f} "
        f"per phase: {sync}), lane efficiency {occ['lane_efficiency']:.4f}, "
        f"walker fraction {occ['walker_fraction']:.4f}, waste {out['waste']}")
    log(f"[smoke] stream saturated: max |stream - cold| {d_cold:.3e} (not "
        f"held with scouting: the reference's scout schedule over-refines "
        f"by rounding noise, so areas move with the schedule, in the "
        f"reference engine as in the port; the ds walk below holds "
        f"{STREAM_COLD_TOL}); max |stream - closed form| {d_exact:.3e} (tol "
        f"{AREA_TOL_EXACT}); p50/p99 latency "
        f"{out['latency']['p50_phases']}/{out['latency']['p99_phases']} "
        f"phases")
    if (any(len(r.completed) != k for _, r, _ in runs)
            or any(not np.array_equal(r.areas, res.areas) for _, r, _ in runs)
            or not d_exact < AREA_TOL_EXACT
            or not occ["attribution"]["reconciles"]
            or launches["run_segment_rf"] <= 0):
        raise AssertionError(f"stream saturated run failed: {out}")
    # the same leg with the ds walk (scouting off): the bench's gate
    ds_cold, _, _, _ = cold_calls(scout_dtype="f64")
    ds_res, ds_wall, ds_launches = counted(
        W, lambda: engine(scout_dtype="f64").run(reqs))
    d_cold_ds = float(np.max(np.abs(ds_res.areas - ds_cold)))
    d_exact_ds = float(np.max(np.abs(ds_res.areas - exact)))
    out["ds_walk"] = dict(wall_s=ds_wall, phases=ds_res.phases,
                          tasks=ds_res.totals["tasks"], launches=ds_launches,
                          d_cold=d_cold_ds, d_exact=d_exact_ds)
    log(f"[smoke] stream saturated, scouting off: wall {ds_wall:.4f} s, "
        f"{ds_res.phases} phases, {ds_res.totals['tasks']} tasks, launches "
        f"{ds_launches}; max |stream - cold| {d_cold_ds:.3e} (tol "
        f"{STREAM_COLD_TOL}); max |stream - closed form| {d_exact_ds:.3e} "
        f"(tol {AREA_TOL_EXACT})")
    if (len(ds_res.completed) != k or not d_cold_ds <= STREAM_COLD_TOL
            or not d_exact_ds < AREA_TOL_EXACT
            or ds_launches["run_segment_rf"] <= 0):
        raise AssertionError(f"stream saturated, scouting off: "
                             f"{out['ds_walk']}")
    out["profile"] = profile_fn(lambda: engine().run(reqs),
                                "walk_rf_kernel", out_dir, "stream")

    # c. the open-loop sweep
    out["sweep"] = []
    for rate in STREAM_SWEEP_RATES:
        arrivals = stream_sweep_arrivals(rate, k, STREAM_SWEEP_SEED)
        rs, _, sweep_launches = counted(
            W, lambda: engine().run(reqs, arrival_phase=arrivals))
        lat = rs.latency_percentiles()
        socc = rs.occupancy_summary(LANES)
        d = float(np.max(np.abs(rs.areas - exact)))
        row = dict(offered_req_per_phase=rate,
                   requests_per_sec=rs.requests_per_sec, wall_s=rs.wall_s,
                   phases=rs.phases, **lat,
                   mean_live_requests=socc.get("mean_live_families", 0.0),
                   lane_efficiency=socc["lane_efficiency"],
                   host_syncs=rs.host_syncs,
                   launches=sweep_launches["run_segment_rf"], d_exact=d)
        out["sweep"].append(row)
        log(f"[smoke] stream load {rate}/phase: {rs.requests_per_sec:.2f} "
            f"req/s, {rs.phases} phases, p50/p99 {lat['p50_phases']}/"
            f"{lat['p99_phases']} phases, {lat['p50_s']:.4f}/"
            f"{lat['p99_s']:.4f} s, mean live requests "
            f"{row['mean_live_requests']:.2f}, lane efficiency "
            f"{row['lane_efficiency']:.4f}, K1 launches {row['launches']}, "
            f"max |area - closed form| {d:.3e}")
        if len(rs.completed) != k or not d < AREA_TOL_EXACT:
            raise AssertionError(f"stream load {rate}: {row}")

    # d. the overload leg, card against CPU, through K1 and K2
    out["overload"] = {}
    for tag, over, counter in (("k1", {}, "run_segment_rf"),
                               ("k2", dict(refill_slots=0),
                                "run_segment_ee")):
        card, _, ov_launches = counted(
            W, lambda: overload_run(TS, DEVICE, over))
        cpu = overload_run(TS, "cpu", over)

        def recs(r):
            return {c.rid: (c.submit_phase, c.admit_phase, c.retire_phase,
                            c.last_credited_phase, c.failed, c.failure)
                    for c in r.completed}

        sheds = [dataclasses.astuple(x) for x in card.shed]
        d = float(np.max(np.abs(card.areas - cpu.areas)))
        row = dict(completed=len(card.completed), shed=len(card.shed),
                   phases=card.phases, tasks=card.totals["tasks"],
                   launches=ov_launches[counter], d_card_cpu=d,
                   latency_by_class=card.class_latency_percentiles())
        out["overload"][tag] = row
        log(f"[smoke] overload leg through {counter}: {len(card.completed)} "
            f"completed, {len(card.shed)} shed, {card.phases} phases, card "
            f"{card.totals['tasks']} tasks / CPU {cpu.totals['tasks']}; "
            f"launches {ov_launches[counter]}; max |card - CPU| {d:.3e} (tol "
            f"{AREA_TOL_DEVICES}); per-class p99 "
            f"{ {c: v['p99_phases'] for c, v in row['latency_by_class'].items()} }")
        if (sheds != [dataclasses.astuple(x) for x in cpu.shed]
                or recs(card) != recs(cpu)
                or card.totals != cpu.totals or not d < AREA_TOL_DEVICES
                or len(card.completed) + len(card.shed) != SLO_K
                or ov_launches[counter] <= 0):
            raise AssertionError(f"overload leg ({tag}): card and CPU differ")
    return out


def twin(name: str):
    """(family, float64 form, ds twin) of "<family>" or
    "<family>@reduced"."""
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    fam, _, tag = name.partition("@")
    return fam, get_family(fam), get_family_ds(fam, reduced=tag == "reduced")


def phase_bodies(W, ops_of) -> dict:
    """12a. Each new integrand body against its plain segment at the
    flagship's lane count, on its own bank: K1 on a bred, dealt bank
    (R=8) and K2 on seeded lanes in the trapezoid, scouting and Simpson
    machines, K3 in trapezoid and Simpson; a reduced twin's reference
    twin runs the same K1 and K2 launches, alternated with them, for the
    two's us/step. Then K1's theta variant at T = 32 for one body."""
    import numpy as np
    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.tools.time_k1 import body_bank
    out = {}
    for name in BODIES:
        fam, f_theta, f_ds = twin(name)
        ref_ds = twin(fam)[2] if name.endswith("@reduced") else None
        theta, bounds, eps_trap, eps_simpson = body_bank(fam)
        ops = ops_of(f_ds)
        rec = out[name] = dict(k1={}, k2={}, k3={})

        def inputs(rule, scout, refill_slots):
            eps = eps_simpson if rule == Rule.SIMPSON else eps_trap
            # Simpson with Richardson is exact on theta x^2, so its breed
            # accepts every root: those lanes get the trapezoid's roots
            if fam == "quad_scaled" and rule == Rule.SIMPSON:
                rule = Rule.TRAPEZOID
            return W.first_phase_inputs(
                f_theta, theta, bounds, eps, lanes=LANES,
                roots_per_lane=ROOTS_PER_LANE, refill_slots=refill_slots,
                capacity=CAPACITY, scout=scout, rule=rule, device=DEVICE)

        t0 = time.perf_counter()
        seeded = {rule: inputs(rule, False, 0)
                  for rule in (Rule.TRAPEZOID, Rule.SIMPSON)}
        for mode in MODES:
            rule, scout = mode_args(mode)
            eps = eps_simpson if rule == Rule.SIMPSON else eps_trap
            bank = inputs(rule, scout, REFILL_SLOTS)
            for kernel, cmp, base in (("k1", cmp_k1, bank),
                                      ("k2", cmp_k2, seeded[rule])):
                what = f"{kernel.upper()} {name} {mode}"
                rec[kernel][mode], times = cmp(W, what, base, f_ds, eps,
                                               mode, ops, BODY_RUNS)
                if ref_ds is not None:
                    rec[kernel][mode]["reference_twin"] = twin_pair(
                        kernel, base, f_ds, ref_ds, eps, mode, BODY_RUNS)
                log(fmt_cmp(what, rec[kernel][mode], times)
                    + (f"; {int(base['nslots'].sum())} roots dealt"
                       if kernel == "k1" else ""))
            if mode != "step_scout":
                what = f"K3 {name} {mode}"
                rec["k3"][mode], times = cmp_k3(W, what, seeded[rule], f_ds,
                                                eps, mode, ops, BODY_RUNS)
                log(fmt_cmp(what + " (and K2 with no exit)", rec["k3"][mode],
                            times))
        log(f"[smoke] {name}: {len(theta)} thetas on {bounds}, eps "
            f"{eps_trap:g} (Simpson {eps_simpson:g}): "
            f"{time.perf_counter() - t0:.1f} s")
    name, T = BODY_THETA
    fam, f_theta, f_ds = twin(name)
    theta = np.linspace(*THETA_RANGE, LANES).reshape(LANES // T, T)
    base = W.first_phase_inputs(
        f_theta, theta, THETA_BOUNDS, THETA_EPS, lanes=LANES,
        roots_per_lane=ROOTS_PER_LANE, refill_slots=REFILL_SLOTS,
        capacity=CAPACITY, scout=False, theta_block=T, device=DEVICE)
    what = f"K1 theta T={T} {name} step"
    rec, times = cmp_k1(W, what, base, f_ds, THETA_EPS, "step",
                        ops_of(f_ds), BODY_RUNS, theta_block=T)
    ctr = rec["counters"]
    if sum(ctr[1:6]) != ctr[0] * LANES:
        raise AssertionError(f"{what}: waste does not reconcile")
    log(fmt_cmp(what, rec, times))
    out[name]["k1"][f"theta_{T}"] = rec
    return out


def phase_reduced_flagship(W, f_theta, theta, exact, sample, bag, ref,
                           kw, kw0, out_dir) -> dict:
    """12b. The flagship main path through the reduced sin(theta / x)
    twin: K1 (R=8, scouting, double buffer) and K2 (R=0, scout f64), with
    phases 4 and 6's gates, and its distance from their reference-twin
    areas (``ref``: the phase 4 scouting and ds runs and the phase 6
    run)."""
    import numpy as np
    import torch
    _, _, f_red = twin("sin_recip_scaled@reduced")
    out = {}
    res, wall, launches = main_path(W, f_theta, f_red, theta,
                                    dict(kw, scout_dtype="f32"),
                                    W.run_segment_rf,
                                    "reduced main path (K1)")
    t0 = time.perf_counter()
    res_ds = W.integrate_family_walker(f_theta, f_red, theta, BOUNDS, EPS,
                                       scout_dtype="f64", **kw)
    torch.cuda.synchronize()
    wall_ds = time.perf_counter() - t0
    areas, areas_ds = np.asarray(res.areas), np.asarray(res_ds.areas)
    out["k1"] = dict(
        wall_s=wall, tasks=res.metrics.tasks, kernel_steps=res.kernel_steps,
        cycles=res.cycles, launches=launches, host_syncs=res.host_syncs,
        lane_efficiency=res.lane_efficiency,
        d_exact=float(np.max(np.abs(areas - exact))),
        d_bag=float(np.max(np.abs(areas[sample] - bag.areas))),
        d_bag_ds=float(np.max(np.abs(areas_ds[sample] - bag.areas))),
        d_ref=float(np.max(np.abs(areas - ref["k1"]))),
        d_ref_ds=float(np.max(np.abs(areas_ds - ref["k1_ds"]))),
        ds_run=dict(wall_s=wall_ds, tasks=res_ds.metrics.tasks,
                    kernel_steps=res_ds.kernel_steps))
    k1 = out["k1"]
    log(f"[smoke] reduced main path (K1): wall {wall:.3f} s, "
        f"{res.metrics.tasks} tasks ({res.metrics.tasks / wall / 1e6:.2f} M "
        f"tasks/s), kernel steps {res.kernel_steps}, cycles {res.cycles}, "
        f"launches {launches}, host syncs {res.host_syncs}, lane efficiency "
        f"{res.lane_efficiency:.4f}; scouting off: {res_ds.metrics.tasks} "
        f"tasks, kernel steps {res_ds.kernel_steps}, wall {wall_ds:.3f} s")
    log(f"[smoke] reduced main path (K1) on {len(sample)} members: max "
        f"|walker(ds) - f64 bag| {k1['d_bag_ds']:.3e} (tol {AREA_TOL_BAG}); "
        f"max |walker(scout) - f64 bag| {k1['d_bag']:.3e} (not held, phase "
        f"5); all {M}: max |walker(scout) - closed form| {k1['d_exact']:.3e} "
        f"(tol {AREA_TOL_EXACT}); max |reduced - reference twin| scouting "
        f"{k1['d_ref']:.3e}, ds {k1['d_ref_ds']:.3e}")
    if not (k1["d_bag_ds"] < AREA_TOL_BAG
            and k1["d_exact"] < AREA_TOL_EXACT):
        raise AssertionError(f"reduced main path (K1) failed: {k1}")
    res0, wall0, launches0 = main_path(W, f_theta, f_red, theta,
                                       dict(kw0, scout_dtype="f64"),
                                       W.run_segment_ee,
                                       "reduced main path (K2)")
    areas0 = np.asarray(res0.areas)
    out["k2"] = k2 = dict(
        wall_s=wall0, tasks=res0.metrics.tasks,
        kernel_steps=res0.kernel_steps, cycles=res0.cycles,
        launches=launches0, host_syncs=res0.host_syncs,
        d_exact=float(np.max(np.abs(areas0 - exact))),
        d_bag=float(np.max(np.abs(areas0[sample] - bag.areas))),
        d_ref=float(np.max(np.abs(areas0 - ref["k2"]))))
    log(f"[smoke] reduced main path (K2): wall {wall0:.3f} s, "
        f"{res0.metrics.tasks} tasks, kernel steps {res0.kernel_steps}, "
        f"launches {launches0}, host syncs {res0.host_syncs}; max |walker - "
        f"f64 bag| on {len(sample)} members {k2['d_bag']:.3e} (tol "
        f"{AREA_TOL_BAG}); all {M}: max |walker - closed form| "
        f"{k2['d_exact']:.3e} (tol {AREA_TOL_EXACT}); max |reduced - "
        f"reference twin| {k2['d_ref']:.3e}")
    if not (k2["d_bag"] < AREA_TOL_BAG and k2["d_exact"] < AREA_TOL_EXACT):
        raise AssertionError(f"reduced main path (K2) failed: {k2}")
    out["profile_k1"] = profile_run(W, f_theta, f_red, theta,
                                    dict(kw, scout_dtype="f32"),
                                    "walk_rf_kernel", out_dir, "k1_reduced")
    return out


def phase_reference_problem(W) -> dict:
    """12c. The reference problem (cosh^4 on [0, 5], theta = 1) through
    the reduced cosh^4 twin at full width, held to the closed form."""
    _, f_theta, f_red = twin("cosh4_scaled@reduced")
    r, wall, launches = counted(W, lambda: W.integrate_family_walker(
        f_theta, f_red, [1.0], (0.0, 5.0), 1e-6, device=DEVICE,
        **REF_PROBLEM_KW))
    check_walk("reference problem (reduced cosh^4)", r, 1)
    rel = abs(float(r.areas[0]) - REF_PROBLEM_AREA) / REF_PROBLEM_AREA
    att = r.attribution()
    # live K1 lane-steps: each evaluates the reduced cosh^4 body on the card
    live = att["buckets"]["eval_active"]
    out = dict(area=float(r.areas[0]), rel_err=rel, wall_s=wall,
               tasks=r.metrics.tasks, kernel_steps=r.kernel_steps,
               launches=launches, scout_evals=r.scout_evals,
               confirm_evals=r.confirm_evals, live_lane_steps=live,
               walker_fraction=r.walker_fraction)
    log(f"[smoke] reference problem through the reduced cosh^4 twin "
        f"({LANES} lanes, R=2, scout f32, double buffer): area "
        f"{r.areas[0]:.6f}, |area - {REF_PROBLEM_AREA}| / area {rel:.3e} "
        f"(tol {REF_PROBLEM_TOL}), {r.metrics.tasks} tasks, kernel steps "
        f"{r.kernel_steps}, K1 live lane-steps {live} of "
        f"{att['lane_steps']} (scout evals {r.scout_evals}, ds confirm "
        f"evals {r.confirm_evals}), walker fraction "
        f"{r.walker_fraction:.4f}, launches {launches}, wall {wall:.3f} s")
    if not rel < REF_PROBLEM_TOL or launches["run_segment_rf"] <= 0 \
            or not live > 0 or not att["reconciles"]:
        raise AssertionError(f"reference problem failed: {out}")
    return out


def phase_gauss(W, integrate_family) -> dict:
    """12d. gauss_center at the reference's real-chip configuration
    (R=0: K2) on the card and on the CPU, and the float64 bag."""
    import numpy as np
    _, f_theta, f_ds = twin("gauss_center")
    card, wall, launches = counted(W, lambda: W.integrate_family_walker(
        f_theta, f_ds, GAUSS_THETA, GAUSS_BOUNDS, GAUSS_EPS, device=DEVICE,
        **GAUSS_KW))
    cpu = W.integrate_family_walker(f_theta, f_ds, GAUSS_THETA, GAUSS_BOUNDS,
                                    GAUSS_EPS, device="cpu", **GAUSS_KW)
    bag = integrate_family(f_theta, GAUSS_THETA, GAUSS_BOUNDS, GAUSS_EPS,
                           chunk=1 << 10, capacity=1 << 16, device=DEVICE)
    check_walk("gauss_center (card)", card, len(GAUSS_THETA))
    d_bag = float(np.max(np.abs(card.areas - bag.areas)))
    d_dev = float(np.max(np.abs(card.areas - cpu.areas)))
    same = dict(tasks=card.metrics.tasks == cpu.metrics.tasks,
                kernel_steps=card.kernel_steps == cpu.kernel_steps,
                waste=bool(np.array_equal(card.waste, cpu.waste)),
                areas_bits=bool(np.array_equal(card.areas, cpu.areas)))
    out = dict(areas=card.areas.tolist(), bag_areas=bag.areas.tolist(),
               d_bag=d_bag, d_card_cpu=d_dev, card_equals_cpu=same,
               tasks=card.metrics.tasks, bag_tasks=bag.metrics.tasks,
               kernel_steps=card.kernel_steps, launches=launches,
               walker_fraction=card.walker_fraction)
    log(f"[smoke] gauss_center ({GAUSS_THETA} on {GAUSS_BOUNDS}, eps "
        f"{GAUSS_EPS:g}, 256 lanes, K2): areas {card.areas}, bag "
        f"{bag.areas} ({bag.metrics.tasks} tasks); max |walker - f64 bag| "
        f"{d_bag:.3e} (tol {AREA_TOL_BAG}); card {card.metrics.tasks} tasks "
        f"/ {card.kernel_steps} steps, CPU {cpu.metrics.tasks} / "
        f"{cpu.kernel_steps}; card = CPU {same}, max |card - CPU| "
        f"{d_dev:.3e}; walker fraction {card.walker_fraction:.3f}, launches "
        f"{launches}")
    if (not np.all(bag.areas > 1e-3) or not d_bag < AREA_TOL_BAG
            or not all(same.values())
            or launches["run_segment_ee"] <= 0):
        raise AssertionError(f"gauss_center failed: {out}")
    return out


def phase_multihost_quad(W, TS) -> dict:
    """12e. The reference bench's multihost single-engine run: quad_scaled
    over theta = 1 + i/4 on [0, 1], on the card and on the CPU. As the
    bench configures it (f64_rounds=2) every phase is float64 bag rounds;
    with f64_rounds=0 the same requests walk K1 at R=2. The workload is
    dyadic: card = CPU bit for bit, and the two modes alike."""
    import numpy as np
    thetas = [1.0 + i / 4.0 for i in range(MULTIHOST_K)]
    reqs = [(t, (0.0, 1.0)) for t in thetas]
    out = {}
    for f64_rounds in (2, 0):
        kw = dict(MULTIHOST_WKW, f64_rounds=f64_rounds)
        card, wall, launches = counted(W, lambda: TS.StreamEngine(
            MULTIHOST_FAMILY, MULTIHOST_EPS, device=DEVICE, **kw).run(reqs))
        cpu = TS.StreamEngine(MULTIHOST_FAMILY, MULTIHOST_EPS, device="cpu",
                              **kw).run(reqs)
        d = float(np.max(np.abs(card.areas - np.asarray(thetas) / 3.0)))
        row = dict(areas=card.areas.tolist(), phases=card.phases,
                   tasks=card.totals["tasks"], wtasks=card.totals["wtasks"],
                   launches=launches, wall_s=wall, d_theta_over_3=d,
                   card_equals_cpu=bool(np.array_equal(card.areas,
                                                       cpu.areas)
                                        and card.totals == cpu.totals))
        out[f64_rounds] = row
        log(f"[smoke] multihost single engine (quad_scaled, f64_rounds "
            f"{f64_rounds}): {card.phases} phases, {row['tasks']} tasks "
            f"({row['wtasks']} walked), launches {launches}; card = CPU bit "
            f"for bit {row['card_equals_cpu']}; max |area - theta/3| "
            f"{d:.3e}")
        if (not row["card_equals_cpu"] or len(card.completed) != len(reqs)
                or not d < 1e-6
                or (f64_rounds == 0) != (launches["run_segment_rf"] > 0)):
            raise AssertionError(f"multihost single engine failed: {row}")
    if out[2]["areas"] != out[0]["areas"]:
        raise AssertionError("multihost single engine: the float64 and "
                             "walker modes' areas differ")
    return out


def phase_reduced_stream(W, TS, f_theta, family_exact, plain_rps) -> dict:
    """12f. Phase 11's saturated stream leg with reduced_integrands=True:
    requests/s against phase 11's (``plain_rps``), the closed form, and
    the bench's gate |stream - cold| <= 1e-8 on the ds walk."""
    import numpy as np
    import torch
    _, _, f_red = twin(STREAM_FAMILY + "@reduced")
    k = STREAM_K
    theta = 1.0 + np.arange(k) / k
    reqs = [(float(t), BOUNDS) for t in theta]
    exact = family_exact(STREAM_FAMILY, *BOUNDS, theta)

    def engine(**over):
        return TS.StreamEngine(STREAM_FAMILY, EPS, reduced_integrands=True,
                               **dict(STREAM_KW, device=DEVICE, **over))

    engine().run(reqs)                                  # warm-up
    runs = [counted(W, lambda: engine().run(reqs))
            for _ in range(STREAM_ROUNDS)]
    res, _, launches = runs[0]
    wall = float(np.median([r.wall_s for r, _, _ in runs]))
    d_exact = float(np.max(np.abs(res.areas - exact)))
    cold = np.array([W.integrate_family_walker(
        f_theta, f_red, [t], BOUNDS, EPS,
        **dict(STREAM_BATCH_KW, scout_dtype="f64", device=DEVICE)).areas[0]
        for t in theta])
    ds_res, ds_wall, ds_launches = counted(
        W, lambda: engine(scout_dtype="f64").run(reqs))
    torch.cuda.synchronize()
    d_cold_ds = float(np.max(np.abs(ds_res.areas - cold)))
    out = dict(requests_per_sec=k / wall, wall_s=wall,
               walls=[r.wall_s for r, _, _ in runs], phases=res.phases,
               tasks=res.totals["tasks"], launches=launches,
               host_syncs=res.host_syncs, d_exact=d_exact,
               vs_phase11_requests_per_sec=(k / wall) / plain_rps,
               ds_walk=dict(wall_s=ds_wall, phases=ds_res.phases,
                            launches=ds_launches, d_cold=d_cold_ds))
    log(f"[smoke] reduced stream saturated: {out['requests_per_sec']:.2f} "
        f"req/s (phase 11: {plain_rps:.2f}; ratio "
        f"{out['vs_phase11_requests_per_sec']:.3f}), wall {wall:.4f} s "
        f"(median; runs {', '.join(f'{r.wall_s:.4f}' for r, _, _ in runs)}),"
        f" {res.phases} phases, {res.totals['tasks']} tasks, launches "
        f"{launches}, host syncs {res.host_syncs}; max |stream - closed "
        f"form| {d_exact:.3e} (tol {AREA_TOL_EXACT}); scouting off: "
        f"{ds_res.phases} phases, launches {ds_launches}, max |stream - "
        f"cold| {d_cold_ds:.3e} (tol {STREAM_COLD_TOL})")
    if (any(len(r.completed) != k or not np.array_equal(r.areas, res.areas)
            for r, _, _ in runs)
            or not d_exact < AREA_TOL_EXACT
            or not d_cold_ds <= STREAM_COLD_TOL
            or launches["run_segment_rf"] <= 0
            or ds_launches["run_segment_rf"] <= 0):
        raise AssertionError(f"reduced stream failed: {out}")
    return out


class SnapshotProbe:
    """Times each snapshot's device read (``HostSyncs.pull_arrays``),
    file write and load, and records each written file's bytes, by
    wrapping the checkpoint functions the engines call while the probe
    is entered. With the background writer the write happens on its
    thread and is not timed."""

    def __init__(self, modules):
        self.modules = modules
        self.pulls, self.writes, self.loads, self.bytes = [], [], [], []

    def __enter__(self):
        from ppls_tpu_torch.utils.device import HostSyncs
        self._saved = [(m, n, getattr(m, n)) for m in self.modules
                       for n in ("save_family_checkpoint",
                                 "load_family_checkpoint")
                       if hasattr(m, n)]
        self._saved.append((HostSyncs, "pull_arrays",
                            HostSyncs.pull_arrays))
        for m, n, fn in self._saved:
            setattr(m, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self._saved:
            setattr(m, n, fn)

    def _wrap(self, name, fn):
        def timed_call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            dt = time.perf_counter() - t0
            if name == "pull_arrays":
                self.pulls.append(dt)
            elif name == "load_family_checkpoint":
                self.loads.append(dt)
            else:
                self.writes.append(dt)
                if kw.get("writer") is None:
                    self.bytes.append(os.path.getsize(a[0]))
            return out
        return timed_call

    def summary(self) -> dict:
        return dict(snapshots=len(self.writes), bytes=list(self.bytes),
                    pull_s=list(self.pulls), write_s=list(self.writes),
                    load_s=list(self.loads))


def same_walk(a, b) -> dict:
    """Which of two walker results' areas, tasks, splits, cycles, kernel
    steps and waste buckets are bit-equal."""
    import numpy as np
    return dict(areas=bool(np.array_equal(a.areas, b.areas)),
                tasks=a.metrics.tasks == b.metrics.tasks,
                splits=a.metrics.splits == b.metrics.splits,
                cycles=a.cycles == b.cycles,
                kernel_steps=a.kernel_steps == b.kernel_steps,
                waste=bool(np.array_equal(a.waste, b.waste)))


def ckpt_walker(W, what, args, kw, base, base_launches, counter, ckpt_dir,
                crash_legs=3) -> dict:
    """13a/13b. The main path of phase 4 or 6 again, snapshotting every
    cycle: once without a crash (bit-equal to ``base``, the snapshot
    gone after), once killed after ``crash_legs`` legs (fewer where the
    base run's last walking cycle comes sooner, so that the resumed leg
    walks too) and resumed with ``resume_family_walker``: bit-equal to
    ``base``, the two legs' launches of ``counter`` summing to
    ``base_launches``, each leg launching it. Its wall against a run
    without snapshots, on the host clock."""
    import numpy as np
    name = counter.__name__
    segs = base.cycle_stats[:, W.CYCLE_STAT_FIELDS.index("segments")]
    legs = min(crash_legs, int(np.nonzero(segs)[0][-1]))
    if legs < 1:
        raise AssertionError(f"{what}: only its first cycle walks, so no "
                             f"crash leaves a walking leg to resume")
    path = os.path.join(ckpt_dir, f"{name}.ckpt")
    plain, plain_wall, _ = counted(
        W, lambda: W.integrate_family_walker(*args, **kw))
    with SnapshotProbe([W]) as probe:
        ck, ck_wall, ck_launches = counted(W, lambda: W.integrate_family_walker(
            *args, checkpoint_path=path, checkpoint_every=1, **kw))
    left = os.path.exists(path)
    with SnapshotProbe([W]) as crash_probe:
        try:
            counted(W, lambda: W.integrate_family_walker(
                *args, checkpoint_path=path, checkpoint_every=1,
                _crash_after_legs=legs, **kw))
            crashed = False
        except RuntimeError as e:
            crashed = "simulated crash" in str(e)
        crash_launches = counter.launches
        res, res_wall, res_launches = counted(
            W, lambda: W.resume_family_walker(path, *args,
                                               checkpoint_every=1, **kw))
    same_ck, same_res = same_walk(ck, base), same_walk(res, base)
    sizes = probe.bytes
    out = dict(cycles=base.cycles, crash_after_legs=legs, crashed=crashed,
               plain_wall_s=plain_wall, checkpoint_wall_s=ck_wall,
               resumed_wall_s=res_wall, uninterrupted_equal=same_ck,
               resumed_equal=same_res, launches=dict(
                   checkpointed=ck_launches[name], crashed=crash_launches,
                   resumed=res_launches[name], base=base_launches),
               snapshot_left=left or os.path.exists(path),
               snapshot=probe.summary(), resume=crash_probe.summary(),
               plain_equal=same_walk(plain, base))
    log(f"[smoke] {what} checkpoint_every=1: {len(sizes)} snapshots, bytes "
        f"{sizes} (max {max(sizes) / 2**20:.2f} MiB), device read s "
        f"{[round(x, 4) for x in probe.pulls]}, write s "
        f"{[round(x, 4) for x in probe.writes]}; wall {ck_wall:.3f} s "
        f"against {plain_wall:.3f} s without snapshots (host clock, noisy); "
        f"bit-equal to the main path {same_ck}")
    log(f"[smoke] {what} killed after {legs} of {base.cycles} cycles, "
        f"resumed: load s {[round(x, 4) for x in crash_probe.loads]}, "
        f"bit-equal {same_res}; {name} launches {crash_launches} + "
        f"{res_launches[name]} (main path {base_launches}); resumed wall "
        f"{res_wall:.3f} s; snapshot left {out['snapshot_left']}")
    if (not all(same_ck.values()) or not all(same_res.values())
            or not crashed or out["snapshot_left"]
            or ck_launches[name] != base_launches
            or crash_launches + res_launches[name] != base_launches
            or crash_launches <= 0 or res_launches[name] <= 0):
        raise AssertionError(f"{what} checkpoint failed: {out}")
    return out


def ckpt_bag(integrate_family, resume_family, get_family, ckpt_dir) -> dict:
    """13c. The reference problem (cosh^4 on [0, 5], eps 1e-3) through the
    float64 bag on the card, killed after 2 legs of 2 rounds and
    resumed: 6567 tasks and 7583461.801486, bit-equal to the run without
    snapshots."""
    import numpy as np
    f = get_family("cosh4_scaled")
    args = (f, [1.0], (0.0, 5.0), 1e-3)
    kw = dict(chunk=1 << 10, capacity=1 << 16, device=DEVICE)
    path = os.path.join(ckpt_dir, "bag.ckpt")
    base = integrate_family(*args, **kw)
    try:
        integrate_family(*args, checkpoint_path=path, checkpoint_every=2,
                         _crash_after_legs=2, **kw)
        crashed = False
    except RuntimeError as e:
        crashed = "simulated crash" in str(e)
    res = resume_family(path, *args, checkpoint_every=2, **kw)
    out = dict(crashed=crashed, tasks=res.metrics.tasks,
               rounds=res.metrics.rounds, area=f"{res.areas[0]:.6f}",
               bit_equal=bool(np.array_equal(res.areas, base.areas)),
               snapshot_left=os.path.exists(path))
    log(f"[smoke] bag (reference problem) killed after 2 legs of 2 rounds, "
        f"resumed: {out}")
    if (not crashed or res.metrics.tasks != 6567
            or out["area"] != "7583461.801486" or not out["bit_equal"]
            or base.metrics.tasks != 6567 or out["snapshot_left"]):
        raise AssertionError(f"bag checkpoint failed: {out}")
    return out


def ckpt_stream(W, TS, ckpt_dir) -> dict:
    """13d. Phase 11's stream leg, open loop at 2 requests per phase:
    snapshots every phase, killed after 3 phases, resumed with
    ``StreamEngine.resume`` and the rest of the arrivals replayed; areas,
    phases, completed records, stats rows and shed records bit-equal to
    the run without snapshots. Once with the synchronous writer, once
    with the background writer."""
    import dataclasses

    import numpy as np
    k = STREAM_K
    reqs = [(float(t), BOUNDS) for t in 1.0 + np.arange(k) / k]
    arr = stream_sweep_arrivals(2.0, k, STREAM_SWEEP_SEED)
    ekw = dict(STREAM_KW, device=DEVICE)

    def records(res):
        return sorted((c.rid, c.failed, c.failure, c.submit_phase,
                       c.admit_phase, c.retire_phase, c.last_credited_phase,
                       c.first_seeded_phase) for c in res.completed)

    def replay(eng):
        j = eng.next_rid
        while not eng.idle or j < k:
            while j < k and arr[j] <= eng.phase:
                eng.submit(*reqs[j])
                j += 1
            eng.step()
        return eng.result()

    base, base_wall, base_launches = counted(
        W, lambda: TS.StreamEngine(STREAM_FAMILY, EPS, **ekw).run(
            reqs, arrival_phase=arr))
    out = dict(phases=base.phases, base_wall_s=base_wall,
               base_launches=base_launches)
    for background in (False, True):
        path = os.path.join(ckpt_dir, f"stream{int(background)}.ckpt")
        with SnapshotProbe([TS]) as probe:
            eng = TS.StreamEngine(STREAM_FAMILY, EPS, checkpoint_path=path,
                                  checkpoint_every=1,
                                  checkpoint_background=background, **ekw)
            try:
                _, crash_wall, crash_launches = counted(W, lambda: eng.run(
                    reqs, arrival_phase=arr, _crash_after_phases=3))
                crashed = False
            except RuntimeError as e:
                crashed = "simulated crash" in str(e)
                crash_launches = W.run_segment_rf.launches
            eng = TS.StreamEngine.resume(path, STREAM_FAMILY, EPS,
                                         checkpoint_every=1,
                                         checkpoint_background=background,
                                         **ekw)
            res, res_wall, res_launches = counted(W, lambda: replay(eng))
            eng.clear_snapshot()
        same = dict(
            areas=bool(np.array_equal(res.areas, base.areas)),
            phases=res.phases == base.phases,
            completed=records(res) == records(base),
            phase_stats=bool(np.array_equal(res.phase_stats,
                                            base.phase_stats)),
            shed=[dataclasses.astuple(x) for x in res.shed]
            == [dataclasses.astuple(x) for x in base.shed])
        row = dict(crashed=crashed, equal=same, snapshot=probe.summary(),
                   launches=dict(crashed=crash_launches,
                                 resumed=res_launches["run_segment_rf"]),
                   resumed_wall_s=res_wall)
        out["background" if background else "synchronous"] = row
        tag = "background" if background else "synchronous"
        log(f"[smoke] stream leg at 2 requests/phase ({base.phases} phases),"
            f" {tag} writer, killed after 3 phases and resumed: bit-equal "
            f"{same}; snapshot bytes {probe.bytes}, device read s "
            f"{[round(x, 4) for x in probe.pulls]}, write s "
            f"{[round(x, 4) for x in probe.writes]}, load s "
            f"{[round(x, 4) for x in probe.loads]}; run_segment_rf launches "
            f"{crash_launches} + {res_launches['run_segment_rf']} (without "
            f"snapshots {base_launches['run_segment_rf']})")
        if (not crashed or not all(same.values())
                or crash_launches + res_launches["run_segment_rf"]
                != base_launches["run_segment_rf"]):
            raise AssertionError(f"stream checkpoint failed: {row}")
    return out


def ckpt_card_to_cpu(W, ckpt_dir) -> dict:
    """13e. gauss_center at phase 12d's configuration, cut to one segment
    of 8 steps per cycle so that it has cycle boundaries: killed on the
    card after one cycle, resumed on the CPU, bit-equal to the card's
    run without a crash."""
    _, f_theta, f_ds = twin("gauss_center")
    kw = dict(GAUSS_KW, seg_iters=8, max_segments=1, max_cycles=256)
    args = (f_theta, f_ds, GAUSS_THETA, GAUSS_BOUNDS, GAUSS_EPS)
    path = os.path.join(ckpt_dir, "gauss.ckpt")
    card, _, launches = counted(W, lambda: W.integrate_family_walker(
        *args, device=DEVICE, **kw))
    try:
        counted(W, lambda: W.integrate_family_walker(
            *args, device=DEVICE, checkpoint_path=path, checkpoint_every=1,
            _crash_after_legs=1, **kw))
        crashed = False
    except RuntimeError as e:
        crashed = "simulated crash" in str(e)
    crash_launches = W.run_segment_ee.launches
    cpu = W.resume_family_walker(path, *args, device="cpu",
                                 checkpoint_every=1, **kw)
    same = same_walk(cpu, card)
    out = dict(cycles=card.cycles, crashed=crashed, equal=same,
               launches=launches, crash_launches=crash_launches,
               device=cpu.device)
    log(f"[smoke] gauss_center ({card.cycles} cycles, K2) killed on the "
        f"card after 1 cycle ({crash_launches} run_segment_ee launches), "
        f"resumed on the CPU: bit-equal to the card's run {same}")
    if (not crashed or not all(same.values()) or cpu.device != "cpu"
            or card.cycles < 2 or crash_launches <= 0):
        raise AssertionError(f"card-to-CPU resume failed: {out}")
    return out



# ---------------------------------------------------------------------------
# 14. python -m ppls_tpu_torch serve
# ---------------------------------------------------------------------------


def serve_argv(**over) -> list:
    """Phase 11's stream leg as ``serve`` flags: the open loop at
    SERVE_RATE requests per phase (seed STREAM_SWEEP_SEED), the
    synthetic thetas linspace(1, 2, STREAM_K, endpoint=False)."""
    kw = dict(STREAM_KW, family=STREAM_FAMILY, eps=EPS, a=BOUNDS[0],
              b=BOUNDS[1], synthetic=STREAM_K, arrival_rate=SERVE_RATE,
              seed=STREAM_SWEEP_SEED, device=DEVICE)
    kw.update(over)
    argv = ["serve"]
    for k, v in kw.items():
        flag = f"-{k}" if len(k) == 1 else "--" + k.replace("_", "-")
        if v is True:
            argv.append(flag)
        elif v is not None and v is not False:
            argv += [flag, str(v)]
    return argv


def serve_requests():
    """The CLI's synthetic request list and arrival phases, rebuilt."""
    import numpy as np
    theta = np.linspace(1.0, 2.0, STREAM_K, endpoint=False)
    return ([(float(t), BOUNDS) for t in theta],
            stream_sweep_arrivals(SERVE_RATE, STREAM_K, STREAM_SWEEP_SEED))


class ResultTap:
    """Keeps every ``StreamResult`` that ``StreamEngine.result`` returns
    while entered: the serve CLI's engines' host-sync counts."""

    def __init__(self, TS):
        self.TS, self.results = TS, []

    def __enter__(self):
        self._orig = orig = self.TS.StreamEngine.result

        def result(eng, *a, **kw):
            out = orig(eng, *a, **kw)
            self.results.append(out)
            return out

        self.TS.StreamEngine.result = result
        return self

    def __exit__(self, *exc):
        self.TS.StreamEngine.result = self._orig


def run_cli(W, TS, argv) -> dict:
    """``ppls_tpu_torch.__main__.main(argv)`` in this process, stdout and
    stderr captured, every kernel's launch count set to 0 before and read
    after: the ledger's records, the host wall, the launches, the
    engine's result."""
    import contextlib
    import io

    from ppls_tpu_torch import __main__ as cli
    out, err = io.StringIO(), io.StringIO()
    with ResultTap(TS) as tap, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc, wall, launches = counted(W, lambda: cli.main(argv))
    if rc != 0:
        raise AssertionError(f"ppls_tpu_torch {argv} exited {rc}: "
                             f"{err.getvalue()}")
    text = out.getvalue()
    recs = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    return dict(text=text, records=recs, summary=recs[-1], wall_s=wall,
                launches=launches, stderr=err.getvalue(),
                result=tap.results[-1] if tap.results else None)


def ledger(*runs) -> dict:
    """rid -> retire record over ``runs`` (a later line replaces an
    earlier one: a resume replays at least once)."""
    out = {}
    for run in runs:
        for r in run["records"]:
            if "rid" in r and "area" in r and not r.get("summary"):
                out[r["rid"]] = r
    return out


RECORD_KEYS = ("area", "admit_phase", "retire_phase", "phases_in_flight",
               "latency_phases", "failed", "failure", "theta")


def record_of(c) -> dict:
    """A ``CompletedRequest`` as the ledger's fields (latency_s aside)."""
    return dict(area=None if c.failed else c.area,
                admit_phase=c.admit_phase, retire_phase=c.retire_phase,
                phases_in_flight=c.phases_in_flight,
                latency_phases=c.latency_phases, failed=c.failed or None,
                failure=c.failure, theta=c.theta)


def same_records(got: dict, want: dict) -> list:
    """The rids whose ledger fields differ (areas bit for bit)."""
    bad = [rid for rid in set(got) | set(want)
           if rid not in got or rid not in want
           or {k: got[rid].get(k) for k in RECORD_KEYS}
           != {k: want[rid].get(k) for k in RECORD_KEYS}]
    return sorted(bad)


def serve_stats(what: str, run: dict) -> dict:
    """Phase 14's printed numbers of one serve run."""
    s = run["summary"]
    res = run["result"]
    syncs = res.host_syncs_per_phase if res is not None else []
    row = dict(wall_s=s["wall_s"], host_wall_s=run["wall_s"],
               requests_per_sec=s["requests_per_sec"],
               p50_phases=s["latency"].get("p50_phases"),
               p99_phases=s["latency"].get("p99_phases"),
               host_syncs_per_phase=(sum(syncs) / len(syncs) if syncs
                                     else None),
               phases=s["phases"], completed=s["completed"],
               launches=run["launches"])
    log(f"[smoke] serve {what}: wall {s['wall_s']} s (host "
        f"{run['wall_s']:.3f} s), {s['requests_per_sec']} req/s, p50/p99 "
        f"{row['p50_phases']}/{row['p99_phases']} phases, host syncs per "
        f"phase {row['host_syncs_per_phase']}, {s['phases']} phases, "
        f"{s['completed']} completed, launches {run['launches']}")
    return row


def serve_full_width(W, TS, ckpt_dir) -> dict:
    """14a and 14b: serve at the stream leg's width through K1, against
    an in-process StreamEngine run; then killed by a fault-plan SIGTERM
    and restarted from its snapshot."""
    import numpy as np

    from ppls_tpu_torch.utils.artifact_schema import (
        validate_events_text, validate_serve_output_text)
    reqs, arr = serve_requests()

    def engine_run():
        return counted(W, lambda: TS.StreamEngine(
            STREAM_FAMILY, EPS, **dict(STREAM_KW, device=DEVICE)).run(
                reqs, arrival_phase=arr))

    # in turns: engine, CLI, CLI, engine (the first CLI run is 14a's)
    eng_res, eng_wall, _ = engine_run()
    a = run_cli(W, TS, serve_argv())
    a2 = run_cli(W, TS, serve_argv())
    eng2, eng_wall2, _ = engine_run()
    want = {c.rid: record_of(c) for c in eng_res.completed}
    out = dict(a=serve_stats("14a (K1)", a), engine_walls_s=[eng_wall,
                                                            eng_wall2],
               cli_walls_s=[a["wall_s"], a2["wall_s"]],
               engine_requests_per_sec=eng_res.requests_per_sec)
    bad = same_records(ledger(a), want) + same_records(ledger(a2), want) \
        + same_records({c.rid: record_of(c) for c in eng2.completed}, want)
    problems = validate_serve_output_text(a["text"])
    log(f"[smoke] serve 14a against StreamEngine.run in this process, in "
        f"turns (engine, CLI, CLI, engine; host walls {eng_wall:.3f}, "
        f"{a['wall_s']:.3f}, {a2['wall_s']:.3f}, {eng_wall2:.3f} s; "
        f"{eng_res.phases} phases): records differing {bad}; summary "
        f"phases {a['summary']['phases']} / {eng_res.phases}, totals equal "
        f"{a['summary']['totals'] == eng_res.totals}; ledger problems "
        f"{problems}")
    if (bad or problems or a["summary"]["completed"] != len(reqs)
            or a["summary"]["phases"] != eng_res.phases
            or a["summary"]["totals"] != eng_res.totals
            or a["launches"]["run_segment_rf"] <= 0):
        raise AssertionError("serve 14a differs from the engine run")

    # 14b: SIGTERM at phase 3's open, then the same command again
    ck = os.path.join(ckpt_dir, "serve_b.ckpt")
    ev = os.path.join(ckpt_dir, "serve_b.jsonl")
    ckpt_flags = dict(checkpoint=ck, checkpoint_every=1, events=ev)
    b1 = run_cli(W, TS, serve_argv(
        fault_plan='[{"kind": "sigterm", "at": 3}]', **ckpt_flags))
    kept = os.path.exists(ck)
    snap_bytes = os.path.getsize(ck) if kept else 0
    events1 = validate_events_text(open(ev).read())
    with SnapshotProbe([TS]) as probe:
        b2 = run_cli(W, TS, serve_argv(**ckpt_flags))
    events2 = validate_events_text(open(ev).read())
    union = ledger(b1, b2)
    bad_b = same_records(union, ledger(a))
    out["b"] = dict(killed=serve_stats("14b killed", b1),
                    restarted=serve_stats("14b restart", b2),
                    terminated=b1["summary"].get("terminated"),
                    snapshot_bytes=snap_bytes,
                    load_s=probe.loads, retired_before_kill=len(ledger(b1)))
    log(f"[smoke] serve 14b: SIGTERM at phase 3 -> terminated "
        f"{out['b']['terminated']!r} after {b1['summary']['phases']} phases, "
        f"{len(ledger(b1))} retired, snapshot kept {kept} ({snap_bytes} "
        f"bytes); restart load s {[round(x, 4) for x in probe.loads]}, "
        f"{len(ledger(b2))} retired; union of the two ledgers against 14a: "
        f"records differing {bad_b}, rids {len(union)} of {len(reqs)}; "
        f"events problems {events1} / {events2}; snapshot cleared "
        f"{not os.path.exists(ck)}")
    if (out["b"]["terminated"] != "SIGTERM" or not kept or bad_b
            or len(union) != len(reqs) or events1 or events2
            or os.path.exists(ck) or not probe.loads
            or b2["summary"]["completed"] != len(reqs)):
        raise AssertionError(f"serve 14b failed: {out['b']}")
    out["launches"] = {k: a["launches"][k] + a2["launches"][k]
                       + b1["launches"][k] + b2["launches"][k]
                       for k in a["launches"]}
    out["ledger_a"] = ledger(a)
    # phase 24's offline tools read 14a's ledger and 14b's timeline (its
    # killed and restarted segments)
    with open(ev) as fh:
        out["artifacts"] = dict(ledger=a["text"], events=fh.read())
    return out


def serve_chaos(W, TS, base: dict, ckpt_dir) -> dict:
    """14c: under --supervise, a corrupt snapshot then a crash (the
    resume starts fresh), and a NaN-poisoned request then a crash; the
    recoveries held to the same flags on the CPU at the CPU tests'
    size."""
    import numpy as np
    reqs, arr = serve_requests()
    plans = {"corrupt": "@" + os.path.join(ROOT, "tools",
                                           "chaos_plan_ckpt.json"),
             "poison": json.dumps([{"kind": "nan_poison", "at": 2},
                                   {"kind": "crash", "at": 4}])}
    out, launches = {}, {}
    for tag, plan in plans.items():
        ck = os.path.join(ckpt_dir, f"serve_c_{tag}.ckpt")
        flags = dict(checkpoint=ck, checkpoint_every=1, supervise=True,
                     watchdog=SERVE_WATCHDOG, fault_plan=plan)
        run = run_cli(W, TS, serve_argv(**flags))
        got = ledger(run)
        s = run["summary"]
        cpu = run_cli(W, TS, serve_argv(**dict(
            flags, checkpoint=ck + ".cpu", device="cpu", **CPU_SERVE)))
        row = dict(stats=serve_stats(f"14c {tag}", run),
                   recoveries=s.get("recoveries"),
                   faults_injected=s.get("faults_injected"),
                   cpu_recoveries=cpu["summary"].get("recoveries"),
                   cpu_faults_injected=cpu["summary"].get("faults_injected"),
                   recovery_wall_s=run["wall_s"] - base["a"]["host_wall_s"])
        same_plan = (row["recoveries"] == row["cpu_recoveries"]
                     and row["faults_injected"] == row["cpu_faults_injected"]
                     and row["recoveries"] == [{"kind": "transient",
                                                "action": "backoff_resume"}])
        if tag == "corrupt":
            bad = same_records(got, base["ledger_a"])
            fresh = "starting fresh" in run["stderr"]
            log(f"[smoke] serve 14c corrupt snapshot + crash: resume "
                f"started fresh {fresh}; records differing from 14a {bad}; "
                f"recoveries {row['recoveries']}, faults "
                f"{row['faults_injected']} (CPU at the tests' size: "
                f"{row['cpu_recoveries']}, {row['cpu_faults_injected']}); "
                f"wall over 14a {row['recovery_wall_s']:.3f} s (backoff "
                f"0.25 s)")
            if bad or not fresh or not same_plan:
                raise AssertionError(f"serve 14c (corrupt) failed: {row}")
        else:
            # the in-process engine with the same poison and no crash
            from ppls_tpu_torch.runtime.faults import FaultInjector, FaultPlan
            poisoned = TS.StreamEngine(
                STREAM_FAMILY, EPS, quarantine=True,
                fault_injector=FaultInjector(FaultPlan.from_events(
                    [{"kind": "nan_poison", "at": 2}])),
                **dict(STREAM_KW, device=DEVICE)).run(
                    reqs, arrival_phase=arr)
            want = {c.rid: record_of(c) for c in poisoned.completed}
            bad = same_records(got, want)
            healthy = [r for r in got if r != 2]
            d14a = max(abs(got[r]["area"] - base["ledger_a"][r]["area"])
                       for r in healthy)
            bit_14a = all(got[r]["area"] == base["ledger_a"][r]["area"]
                          for r in healthy)
            row.update(d_14a=d14a, bit_equal_14a=bit_14a,
                       failed=[r for r in got if got[r].get("failed")])
            log(f"[smoke] serve 14c NaN poison at rid 2 + crash at phase 4: "
                f"failed rids {row['failed']} (area {got[2]['area']}); "
                f"records differing from the poisoned StreamEngine run "
                f"{bad}; healthy rids against 14a: bit-equal {bit_14a}, max "
                f"|d| {d14a:.3e} (tol {SERVE_SCHEDULE_TOL}: the scout "
                f"schedule moves with the work mix); recoveries "
                f"{row['recoveries']}, faults {row['faults_injected']} (CPU:"
                f" {row['cpu_recoveries']}, {row['cpu_faults_injected']})")
            if (bad or row["failed"] != [2] or got[2]["area"] is not None
                    or not d14a <= SERVE_SCHEDULE_TOL or not same_plan
                    or len(got) != len(reqs)):
                raise AssertionError(f"serve 14c (poison) failed: {row}")
        out[tag] = row
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out


def serve_overload_faults(W, TS) -> dict:
    """14d: phase 11d's overload leg with the reference's fault plan
    (tools/bench_history.py:115-118), through K1 (R=2) and K2 (R=0), card
    against CPU."""
    import dataclasses

    import numpy as np
    from ppls_tpu_torch.runtime.faults import FaultInjector, FaultPlan
    out, launches = {}, {}

    def run(device, over):
        reqs = []
        for i in range(SLO_K):
            tenant, pri = SLO_TENANTS[i % len(SLO_TENANTS)]
            reqs.append((1.0 + i / SLO_K, SLO_BOUNDS,
                         {"tenant": tenant, "priority": pri}))
        inj = FaultInjector(FaultPlan.from_events(
            [dict(e) for e in SLO_FAULTS]))
        res = TS.StreamEngine(
            STREAM_FAMILY, SLO_EPS, queue_limit=SLO_QUEUE_LIMIT,
            quarantine=True, fault_injector=inj, device=device,
            **dict(SLO_KW, **over)).run(
                reqs, arrival_phase=stream_sweep_arrivals(
                    SLO_RATE, SLO_K, SLO_SEED))
        return res, [e.describe() for e in inj.plan.events if e.fired]

    for tag, over, counter in (("k1", {}, "run_segment_rf"),
                               ("k2", dict(refill_slots=0),
                                "run_segment_ee")):
        (card, fired), wall, ov = counted(W, lambda: run(DEVICE, over))
        cpu, cpu_fired = run("cpu", over)

        def recs(r):
            return {c.rid: (c.submit_phase, c.admit_phase, c.retire_phase,
                            c.last_credited_phase, c.failed, c.failure)
                    for c in r.completed}

        ok = [c.rid for c in card.completed if not c.failed]
        a = {c.rid: c.area for c in card.completed}
        b = {c.rid: c.area for c in cpu.completed}
        d = max(abs(a[r] - b[r]) for r in ok)
        failed = sorted(c.rid for c in card.completed if c.failed)
        row = dict(completed=len(card.completed), shed=len(card.shed),
                   failed=failed, phases=card.phases, wall_s=wall,
                   launches=ov[counter], d_card_cpu=d, faults=fired,
                   requests_per_sec=card.requests_per_sec,
                   latency=card.latency_percentiles(),
                   host_syncs_per_phase=(card.host_syncs
                                         / max(len(card.host_syncs_per_phase),
                                               1)))
        same = (recs(card) == recs(cpu)
                and [dataclasses.astuple(x) for x in card.shed]
                == [dataclasses.astuple(x) for x in cpu.shed]
                and np.array_equal(card.phase_stats, cpu.phase_stats)
                and fired == cpu_fired)
        log(f"[smoke] serve 14d overload leg with its fault plan through "
            f"{counter}: {row['completed']} completed, {row['shed']} shed, "
            f"failed {failed}, {card.phases} phases, wall {wall:.3f} s, "
            f"{card.requests_per_sec:.2f} req/s, p50/p99 "
            f"{row['latency']['p50_phases']}/{row['latency']['p99_phases']} "
            f"phases, host syncs per phase "
            f"{row['host_syncs_per_phase']:.2f}, launches {ov[counter]}, "
            f"faults {fired}; card = CPU (records, sheds, stats rows, "
            f"faults) {same}, max |card - CPU| {d:.3e} (tol "
            f"{AREA_TOL_DEVICES})")
        if (not same or failed != [2] or not d < AREA_TOL_DEVICES
                or ov[counter] <= 0
                or len(card.completed) + len(card.shed) != SLO_K):
            raise AssertionError(f"serve 14d ({tag}) failed: {row}")
        out[tag] = row
        for k, v in ov.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out


def http(url: str, body: bytes = None):
    """(status, body, ms) of one request to the serve process."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    return status, text, 1e3 * (time.perf_counter() - t0)


class ServeProcess:
    """``python -m ppls_tpu_torch serve`` in a subprocess: stdout and
    stderr read on threads, every line timestamped."""

    def __init__(self, argv):
        import threading
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ppls_tpu_torch", *argv], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out, self.err = [], []
        self.lock = threading.Lock()
        self.threads = [threading.Thread(target=self._read, args=(f, dst),
                                         daemon=True)
                        for f, dst in ((self.proc.stdout, self.out),
                                       (self.proc.stderr, self.err))]
        for t in self.threads:
            t.start()

    def _read(self, f, dst):
        for ln in f:
            with self.lock:
                dst.append((time.perf_counter() - self.t0, ln))

    def lines(self):
        with self.lock:
            return list(self.out) + list(self.err)

    def wait_until(self, cond, what, timeout=300.0):
        """Poll ``cond()`` until it returns a true value, and return it."""
        t_end = time.perf_counter() + timeout
        while time.perf_counter() < t_end:
            exited = self.proc.poll() is not None
            hit = cond()
            if hit:
                return hit
            if exited:
                raise AssertionError(
                    f"serve process exited {self.proc.returncode} before "
                    f"{what}: {''.join(l for _, l in self.err)[-2000:]}")
            time.sleep(0.01)
        raise AssertionError(f"serve process: no {what} in {timeout} s")

    def wait_for(self, pred, what, timeout=300.0):
        """The first (t, line) of stdout or stderr that ``pred`` accepts."""
        return self.wait_until(
            lambda: next((x for x in self.lines() if pred(x[1])), None),
            what, timeout)

    def retired(self) -> dict:
        with self.lock:
            lines = [ln for _, ln in self.out]
        recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
        return {r["rid"]: r for r in recs
                if "area" in r and not r.get("summary")}

    def stop(self, timeout=120.0) -> dict:
        """SIGTERM, wait, and the summary line."""
        import signal
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=timeout)
        for t in self.threads:
            t.join(timeout=10)
        if rc != 0:
            raise AssertionError(f"serve process exited {rc}: "
                                 f"{''.join(l for _, l in self.err)[-2000:]}")
        return json.loads(self.out[-1][1])

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def serve_process_start() -> dict:
    """The pieces of a serve process's start, in a fresh interpreter:
    importing torch and the CLI, the CUDA context, loading K1 and K2."""
    code = (
        "import json, time\nt0 = time.perf_counter()\nimport torch\n"
        "import ppls_tpu_torch.__main__\nt1 = time.perf_counter()\n"
        f"dev = {DEVICE!r}\n"
        "torch.zeros(1, device=dev)\n"
        "if dev == 'cuda': torch.cuda.synchronize()\n"
        "t2 = time.perf_counter()\n"
        "from ppls_tpu_torch.utils import cuda_build as cb\n"
        "if dev == 'cuda': cb.load_walk_rf(); cb.load_walk_ee()\n"
        "t3 = time.perf_counter()\n"
        "print(json.dumps(dict(import_s=t1 - t0, context_s=t2 - t1, "
        "kernel_load_s=t3 - t2)))\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"start probe failed: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def serve_entry_point(ckpt_dir) -> dict:
    """14e: the real entry point. One ``serve`` process with --checkpoint,
    --metrics-port 0 and --ingest-port 0: /metrics and /health scraped,
    two requests posted and acknowledged, SIGTERM after a few retire
    lines; the same command again, stopped when every acknowledged rid
    has retired across the two ledgers."""
    import re

    from ppls_tpu_torch.utils.artifact_schema import \
        validate_serve_output_text
    ck = os.path.join(ckpt_dir, "serve_e.ckpt")
    argv = serve_argv(checkpoint=ck, metrics_port=0, ingest_port=0)
    start = serve_process_start()
    body = "".join(json.dumps({"theta": 1.0 + i / 7.0,
                               "bounds": list(BOUNDS), "tenant": "live"})
                   + "\n" for i in (1, 3)).encode()
    procs = []
    try:
        p1 = ServeProcess(argv)
        procs.append(p1)
        t_m, ln = p1.wait_for(lambda x: "metrics on" in x, "metrics URL")
        metrics_url = re.search(r"metrics on (\S+)", ln).group(1)
        _, ln = p1.wait_for(lambda x: "ingest on" in x, "ingest URL")
        ingest_url = re.search(r"ingest on (\S+)", ln).group(1)
        t_first, _ = p1.wait_for(lambda x: x.startswith('{"rid"'),
                                 "a first retire line")
        st, text, scrape_ms = http(metrics_url)
        health_url = metrics_url.rsplit("/", 1)[0] + "/health"
        hst, htext, health_ms = http(health_url)
        acks, post_ms = [], []
        while len(acks) < 2:
            pst, ptext, ms = http(ingest_url, body)
            post_ms.append(ms)
            recs = [json.loads(x) for x in ptext.splitlines() if x]
            if pst == 200 and all(r.get("accepted") for r in recs):
                acks = recs
            elif len(post_ms) > 50:
                raise AssertionError(f"ingest refused: {ptext}")
            else:
                time.sleep(0.05)
        p1.wait_until(lambda: len(p1.retired()) >= 4, "4 retire lines")
        s1 = p1.stop()
        snap_bytes = os.path.getsize(ck)
        r1 = p1.retired()
        total = STREAM_K + len(acks)
        p2 = ServeProcess(argv)
        procs.append(p2)
        t_first2, _ = p2.wait_for(lambda x: x.startswith('{"rid"'),
                                  "a first retire line after the restart")
        p2.wait_until(lambda: len({**r1, **p2.retired()}) >= total,
                      "every acknowledged rid retired")
        s2 = p2.stop()
    finally:
        for p in procs:
            p.kill()
    union = {**r1, **p2.retired()}
    acked = sorted(a["rid"] for a in acks)
    ledger_text = "".join(ln for p in procs for _, ln in p.out
                          if '"summary": true' not in ln) + json.dumps(s2)
    problems = validate_serve_output_text(ledger_text)
    out = dict(start=start, metrics_announce_s=t_m,
               first_retire_s=t_first, restart_first_retire_s=t_first2,
               scrape_ms=scrape_ms, scrape_status=st,
               scrape_bytes=len(text), health_ms=health_ms,
               health_status=hst, health=json.loads(htext),
               post_ms=post_ms, acked=acked, snapshot_bytes=snap_bytes,
               retired_before_kill=len(r1), terminated=s1.get("terminated"),
               restart=dict(completed=s2["completed"], phases=s2["phases"],
                            wall_s=s2["wall_s"],
                            requests_per_sec=s2["requests_per_sec"],
                            latency=s2["latency"]),
               killed=dict(completed=s1["completed"], phases=s1["phases"],
                           wall_s=s1["wall_s"],
                           requests_per_sec=s1["requests_per_sec"],
                           latency=s1["latency"]),
               lost=sorted(set(range(total)) - set(union)),
               ledger_problems=problems)
    log(f"[smoke] serve 14e process start: import {start['import_s']:.2f} s,"
        f" CUDA context {start['context_s']:.2f} s, K1+K2 load "
        f"{start['kernel_load_s']:.3f} s (a separate probe process, "
        f"{start['process_s']:.2f} s in all); the serve process: metrics "
        f"announced at {t_m:.2f} s, first retire line at {t_first:.2f} s "
        f"after spawn")
    log(f"[smoke] serve 14e: /metrics {st} ({len(text)} bytes) in "
        f"{scrape_ms:.1f} ms, /health {hst} {htext.strip()} in "
        f"{health_ms:.1f} ms; ingest POST of 2 requests acknowledged rids "
        f"{acked} in {post_ms[-1]:.1f} ms ({len(post_ms)} posts); SIGTERM "
        f"after {len(r1)} retire lines -> terminated "
        f"{s1.get('terminated')!r} (wall {s1['wall_s']} s, "
        f"{s1['requests_per_sec']} req/s, p50/p99 "
        f"{s1['latency'].get('p50_phases')}/{s1['latency'].get('p99_phases')}"
        f" phases), snapshot {snap_bytes} bytes; restart: first retire at "
        f"{t_first2:.2f} s after spawn, {s2['completed']} completed in "
        f"{s2['phases']} phases (wall {s2['wall_s']} s, "
        f"{s2['requests_per_sec']} req/s, p50/p99 "
        f"{s2['latency'].get('p50_phases')}/{s2['latency'].get('p99_phases')}"
        f" phases); lost acks {out['lost']}; ledger problems {problems}")
    if (out["lost"] or len(acked) != 2 or st != 200 or hst != 200
            or not out["health"].get("ok") or problems
            or s1.get("terminated") != "SIGTERM"
            or s2["completed"] != total):
        raise AssertionError(f"serve 14e failed: {out}")
    return out


def phase_serve(W, TS, ckpt_dir) -> dict:
    """14. ``python -m ppls_tpu_torch serve`` at the stream leg's width:
    14a-14e. Returns the records and phase 14's in-process launches."""
    import torch
    t0 = time.perf_counter()
    full = serve_full_width(W, TS, ckpt_dir)
    chaos = serve_chaos(W, TS, full, ckpt_dir)
    overload = serve_overload_faults(W, TS)
    entry = serve_entry_point(ckpt_dir)
    torch.cuda.synchronize()
    launches = {k: full["launches"][k] + chaos["launches"][k]
                + overload["launches"][k] for k in full["launches"]}
    full.pop("ledger_a")
    artifacts = full.pop("artifacts")
    seconds = time.perf_counter() - t0
    log(f"[smoke] phase 14 (serve): {seconds:.1f} s; in-process launches "
        f"{launches}")
    return dict(full=full, chaos=chaos, overload=overload, entry=entry,
                launches=launches, seconds=seconds, artifacts=artifacts)


def cli_json(W, TS, argv) -> tuple:
    """One root or ``family`` command on DEVICE: (its JSON line, the run
    of ``run_cli``)."""
    run = run_cli(W, TS, argv + ["--json", "--device", DEVICE])
    return run["records"][-1], run


def flagship_argv() -> list:
    """Phases 4 and 6's flagship as ``family`` flags."""
    return ["family", "--engine", "walker", "--m", str(M), "-a",
            str(BOUNDS[0]), "-b", str(BOUNDS[1]), "--eps", str(EPS),
            "--capacity", str(CAPACITY), "--chunk", str(1 << 15),
            "--theta0", "1", "--theta1", "2"]


def same_ref_problem(r) -> bool:
    return (f"{r['area']:.6f}" == REF_PRINTED
            and all(r[k] == v for k, v in REF_COUNTS.items()))


def cli_reference_problem(W, TS, smi: str) -> dict:
    """15a. The reference problem from the shell through the host engine,
    the device engine and the spillover backend; the C driver and the MPI
    stub; --backend mpi where mpirun exists; Simpson beside it."""
    from ppls_tpu_torch.backends import mpi_backend as MB
    from ppls_tpu_torch.config import REFERENCE_CONFIG
    out = {}
    for tag, extra in (("host", []), ("device", ["--engine", "device"]),
                       ("spillover", ["--backend", "spillover"]),
                       ("simpson", ["--rule", "simpson"])):
        r, run = cli_json(W, TS, extra)
        out[tag] = dict(area=r["area"], tasks=r["tasks"],
                        rounds=r["rounds"], max_depth=r["max_depth"],
                        global_error=r["global_error"],
                        engine_wall_s=r["wall_time_s"],
                        host_wall_s=run["wall_s"],
                        launches=run["launches"])
        if tag != "simpson" and not same_ref_problem(r):
            raise AssertionError(f"15a {tag}: not the reference's numbers: "
                                 f"{r}")
    for tag, fn in (("c_seq", MB.run_seq), ("mpi_stub", MB.run_mpi_stub)):
        t0 = time.perf_counter()
        res = fn(REFERENCE_CONFIG)
        m = res.metrics
        out[tag] = dict(area=res.area, tasks=m.tasks,
                        engine_wall_s=m.wall_time_s,
                        host_wall_s=time.perf_counter() - t0)
        if (f"{res.area:.6f}" != REF_PRINTED or m.tasks != 6567
                or m.splits != 3283 or m.max_depth != 14):
            raise AssertionError(f"15a {tag}: {out[tag]}")
    if MB.mpi_available():
        r, run = cli_json(W, TS, ["--backend", "mpi"])
        out["mpi"] = dict(area=r["area"], tasks=r["tasks"],
                          engine_wall_s=r["wall_time_s"])
        if f"{r['area']:.6f}" != REF_PRINTED or r["tasks"] != 6567:
            raise AssertionError(f"15a --backend mpi: {r}")
        mpi = "ran, the reference's numbers"
    else:
        out["mpi"] = None
        mpi = "not run (no mpirun on PATH; not counted)"
    log(f"[smoke] 15a reference problem from the shell: host, device, "
        f"spillover, C seq and MPI stub all {REF_PRINTED} with 6567 tasks, "
        f"15 rounds, depth 14; --backend mpi {mpi}; Simpson "
        f"{out['simpson']['area']:.6f} in {out['simpson']['tasks']} tasks, "
        f"global error {out['simpson']['global_error']:.3e} (trapezoid "
        f"{out['host']['global_error']:.3e})")
    log(f"[smoke] 15a walls ({smi}): engine host "
        f"{out['host']['engine_wall_s']:.4f} s, device "
        f"{out['device']['engine_wall_s']:.4f} s, spillover (CPU) "
        f"{out['spillover']['engine_wall_s']:.4f} s, C seq "
        f"{out['c_seq']['engine_wall_s']:.4f} s; whole CLI calls host "
        f"{out['host']['host_wall_s']:.3f} s, device "
        f"{out['device']['host_wall_s']:.3f} s, spillover "
        f"{out['spillover']['host_wall_s']:.3f} s")
    return out


def wavefront_configs(W) -> dict:
    """15b. BASELINE's configurations through both wavefront engines on
    the card, against the C driver; the deep one overflowing 2^12 slots."""
    from ppls_tpu_torch.backends.mpi_backend import run_seq
    from ppls_tpu_torch.config import OSC_CONFIG, OSC_DEEP_CONFIG, SIN_CONFIG
    from ppls_tpu_torch.parallel.device_engine import device_integrate
    from ppls_tpu_torch.runtime.host_frontier import integrate
    out, hosts = {}, {}
    for name, cfg in (("sin", SIN_CONFIG), ("osc", OSC_CONFIG),
                      ("osc_deep", OSC_DEEP_CONFIG)):
        h, wh, _ = counted(W, lambda: integrate(cfg, device=DEVICE))
        d, wd, _ = counted(W, lambda: device_integrate(cfg, device=DEVICE))
        c = run_seq(cfg)
        hosts[name] = h
        rel_hd = abs(h.area - d.area) / abs(h.area)
        rel_c = abs(d.area - c.area) / abs(c.area)
        same = all(getattr(h.metrics, k) == getattr(d.metrics, k)
                   for k in ("tasks", "splits", "rounds", "max_depth"))
        out[name] = dict(area=d.area, tasks=d.metrics.tasks,
                         rounds=d.metrics.rounds, rel_host_device=rel_hd,
                         rel_c=rel_c, c_tasks=c.metrics.tasks,
                         host_reads=h.host_syncs, device_reads=d.host_syncs,
                         host_wall_s=wh, device_wall_s=wd,
                         c_wall_s=c.metrics.wall_time_s,
                         global_error=d.global_error)
        log(f"[smoke] 15b {name} ({cfg.integrand} on [{cfg.a}, {cfg.b}], "
            f"eps {cfg.eps}, capacity {cfg.capacity}): {d.metrics.tasks} "
            f"tasks in {d.metrics.rounds} rounds on both engines {same}; "
            f"|host - device| / area {rel_hd:.3e} (tol {WAVEFRONT_TOL}); "
            f"|device - C| / area {rel_c:.3e} (tol {C_GATE_REL}), C tasks "
            f"{c.metrics.tasks} ({c.metrics.tasks - d.metrics.tasks:+d}); "
            f"device reads: host engine {h.host_syncs}, device engine "
            f"{d.host_syncs}; walls host {wh:.4f} s, device {wd:.4f} s, C "
            f"{c.metrics.wall_time_s:.4f} s; global error "
            f"{d.global_error:.3e}")
        if (not same or not rel_hd < WAVEFRONT_TOL or not rel_c < C_GATE_REL
                or d.state is None):
            raise AssertionError(f"15b {name} failed: {out[name]}")
    deep = OSC_DEEP_CONFIG.replace(capacity=1 << 12)
    d, wd, _ = counted(W, lambda: device_integrate(deep, device=DEVICE))
    fit = device_integrate(OSC_CONFIG.replace(capacity=1 << 12),
                           device=DEVICE)
    h = hosts["osc_deep"]
    out["overflow"] = dict(rerun_on_host=d.state is None, reads=d.host_syncs,
                           wall_s=wd, osc_fits=fit.state is not None)
    log(f"[smoke] 15b OSC_DEEP_CONFIG at capacity 2^12: overflowed and "
        f"reran on the host engine {d.state is None}, area equal to the host "
        f"engine's {d.area == h.area}, tasks {d.metrics.tasks}, reads "
        f"{d.host_syncs}, wall {wd:.4f} s; OSC_CONFIG at 2^12 fits (peak "
        f"frontier 2508) {fit.state is not None}")
    if (d.state is not None or d.area != h.area
            or d.metrics.tasks != h.metrics.tasks or fit.state is None):
        raise AssertionError(f"15b overflow failed: {out['overflow']}")
    return out


def cli_flagship(W, TS, k1_res, k2_res, walls, ckpt_dir, smi) -> dict:
    """15c. The flagship from the shell through K1 and K2 against phases 4
    and 6; the bag card against CPU; --theta-block 256 against the same
    call in this process; the K1 flagship with --checkpoint."""
    import numpy as np
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    out, launches = {}, {}

    def add(ls):
        for k, v in ls.items():
            launches[k] = launches.get(k, 0) + v

    for tag, flags, want, counter in (
            ("k1", K1_FLAGS, k1_res, "run_segment_rf"),
            ("k2", K2_FLAGS, k2_res, "run_segment_ee")):
        r, run = cli_json(W, TS, flagship_argv() + flags)
        add(run["launches"])
        head = [float(v) for v in np.asarray(want.areas)[:4]]
        ok = (r["areas_head"] == head and r["tasks"] == want.metrics.tasks
              and r["abs_error"] < AREA_TOL_EXACT
              and run["launches"][counter] > 0)
        out[tag] = dict(tasks=r["tasks"], abs_error=r["abs_error"],
                        cli_wall_s=run["wall_s"],
                        engine_wall_s=r["wall_time_s"],
                        in_process_wall_s=walls[tag],
                        launches=run["launches"], same=ok)
        log(f"[smoke] 15c CLI flagship through {counter}: {r['tasks']} "
            f"tasks, areas_head and tasks bit-equal to phase "
            f"{4 if tag == 'k1' else 6} {ok}, abs_error {r['abs_error']:.3e}"
            f", launches {run['launches']}; wall ({smi}): CLI call "
            f"{run['wall_s']:.3f} s (engine {r['wall_time_s']:.3f} s) "
            f"against {walls[tag]:.3f} s in process")
        if not ok:
            raise AssertionError(f"15c flagship ({tag}) failed: {r}")

    bag_card, run = cli_json(W, TS, ["family"])
    add(run["launches"])
    bag_cpu = run_cli(W, TS, ["family", "--json", "--device",
                              "cpu"])["records"][-1]
    d_bag = float(np.max(np.abs(np.asarray(bag_card["areas_head"])
                                - bag_cpu["areas_head"])))
    same_bag = all(bag_card[k] == bag_cpu[k] for k in (
        "tasks", "splits", "rounds", "max_depth", "m"))
    out["bag"] = dict(tasks=bag_card["tasks"], d_card_cpu=d_bag,
                      card_wall_s=bag_card["wall_time_s"],
                      cpu_wall_s=bag_cpu["wall_time_s"])
    log(f"[smoke] 15c family --engine bag at the CLI defaults: "
        f"{bag_card['tasks']} tasks, card = CPU counts {same_bag}, max "
        f"|card - CPU| {d_bag:.3e} (tol {AREA_TOL_DEVICES}), walls card "
        f"{bag_card['wall_time_s']:.3f} s, CPU {bag_cpu['wall_time_s']:.3f} s")
    if not same_bag or not d_bag < AREA_TOL_DEVICES:
        raise AssertionError(f"15c bag failed: {out['bag']}")

    m = LANES // THETA_CLI_T
    theta = np.linspace(THETA_RANGE[0], THETA_RANGE[1], LANES,
                        endpoint=False).reshape(m, THETA_CLI_T)
    r, run = cli_json(W, TS, [
        "family", "--engine", "walker", "--family", THETA_FAMILY, "-a",
        str(THETA_BOUNDS[0]), "-b", str(THETA_BOUNDS[1]), "--eps",
        str(THETA_EPS), "--refill-slots", str(REFILL_SLOTS), "--m",
        str(LANES), "--theta0", str(THETA_RANGE[0]), "--theta1",
        str(THETA_RANGE[1]), "--theta-block", str(THETA_CLI_T)])
    add(run["launches"])
    inproc = W.integrate_family_walker(
        get_family(THETA_FAMILY), get_family_ds(THETA_FAMILY), theta,
        THETA_BOUNDS, THETA_EPS, refill_slots=REFILL_SLOTS,
        theta_block=THETA_CLI_T, chunk=1 << 13, capacity=1 << 20,
        device=DEVICE)
    head = [float(v) for v in np.asarray(inproc.areas).reshape(-1)[:4]]
    ok = (r["areas_head"] == head and r["tasks"] == inproc.metrics.tasks
          and r["m"] == m and run["launches"]["run_segment_rf"] > 0)
    out["theta_block"] = dict(tasks=r["tasks"], m=r["m"],
                              abs_error=r["abs_error"],
                              launches=run["launches"], same=ok)
    log(f"[smoke] 15c --theta-block {THETA_CLI_T} ({THETA_FAMILY}, {LANES} "
        f"thetas in {m} slots): {r['tasks']} tasks, equal to the in-process "
        f"call {ok}, abs_error {r['abs_error']:.3e}, launches "
        f"{run['launches']}")
    if not ok:
        raise AssertionError(f"15c theta block failed: {r}")

    ck = os.path.join(ckpt_dir, "flagship_cli.ckpt")
    with SnapshotProbe([W]) as probe:
        r, run = cli_json(W, TS, flagship_argv() + K1_FLAGS
                          + ["--checkpoint", ck])
    add(run["launches"])
    head = [float(v) for v in np.asarray(k1_res.areas)[:4]]
    # the snapshot was written during the run (each write's file size
    # is read right after it) and deleted at its end
    written = probe.bytes
    ok = (r["areas_head"] == head and r["tasks"] == k1_res.metrics.tasks
          and len(written) > 0 and min(written) > 0
          and not os.path.exists(ck))
    out["checkpoint"] = dict(cli_wall_s=run["wall_s"], same=ok,
                             snapshots=len(written), bytes=written,
                             launches=run["launches"])
    log(f"[smoke] 15c CLI flagship with --checkpoint: equal to phase 4, "
        f"{len(written)} snapshots written ({written} bytes) and gone at "
        f"the end {ok}, wall {run['wall_s']:.3f} s, launches "
        f"{run['launches']}")
    if not ok:
        raise AssertionError("15c flagship with --checkpoint failed")
    out["launches"] = launches
    return out


def spill_serve_argv(device: str, **over) -> list:
    """Phase 11d's overload leg as ``serve`` flags, with CPU spillover."""
    kw = dict(family=STREAM_FAMILY, eps=SLO_EPS, a=SLO_BOUNDS[0],
              b=SLO_BOUNDS[1], synthetic=SLO_K, theta0=1.0, theta1=2.0,
              arrival_rate=SLO_RATE, seed=SLO_SEED, slots=SLO_KW["slots"],
              chunk=SLO_KW["chunk"], capacity=SLO_KW["capacity"],
              lanes=SLO_KW["lanes"], refill_slots=SLO_KW["refill_slots"],
              tenants=",".join(f"{t}:1:{p}" for t, p in SLO_TENANTS),
              quarantine=True, queue_limit=SLO_QUEUE_LIMIT, spillover=True,
              spillover_limit=SPILL_LIMIT, device=device)
    kw.update(over)
    argv = ["serve"]
    for k, v in kw.items():
        flag = f"-{k}" if len(k) == 1 else "--" + k.replace("_", "-")
        if v is True:
            argv.append(flag)
        elif v is not None and v is not False:
            argv += [flag, str(v)]
    return argv


def serve_ledger(run) -> dict:
    """(rid, shed) -> the ledger's record, without its latency
    seconds."""
    body = {(r["rid"], bool(r.get("shed"))):
            {k: v for k, v in r.items() if k != "latency_s"}
            for r in run["records"] if "rid" in r}
    return body


def cli_spillover(W, TS, ckpt_dir) -> dict:
    """15d. serve --spillover on the overload leg through K1: card against
    CPU, the spillover contract against the walk, SIGTERM with a queued
    spill and the restart."""
    import numpy as np
    card = run_cli(W, TS, spill_serve_argv(DEVICE))
    cpu = run_cli(W, TS, spill_serve_argv("cpu"))
    plain = run_cli(W, TS, spill_serve_argv(DEVICE, queue_limit=None,
                                            spillover=False,
                                            spillover_limit=None))
    a, b = serve_ledger(card), serve_ledger(cpu)
    keys = set(a) == set(b)
    d_walk, bad = 0.0, []
    for key, ra in a.items():
        rb = b.get(key, {})
        if {k: v for k, v in ra.items() if k != "area"} \
                != {k: v for k, v in rb.items() if k != "area"}:
            bad.append(key)
        elif "area" in ra and not ra.get("failed"):
            gap = abs(ra["area"] - rb["area"])
            if ra.get("spillover") is True:
                if gap != 0.0:
                    bad.append(key)
            else:
                d_walk = max(d_walk, gap)
    walk = {r["rid"]: r["area"] for r in plain["records"]
            if "area" in r and "rid" in r}
    spilled = [r for r in card["records"] if r.get("spillover") is True]
    d_spill = max((abs(r["area"] - walk[r["rid"]]) for r in spilled),
                  default=float("nan"))
    s_card, s_cpu = card["summary"], cpu["summary"]
    counts = ("completed", "shed", "phases", "spillover", "totals")
    same_summary = all(s_card[k] == s_cpu[k] for k in counts)
    out = dict(summary={k: s_card[k] for k in counts},
               spilled=len(spilled), d_walk_card_cpu=d_walk,
               d_spill_walk=d_spill, launches=card["launches"],
               wall_s=s_card["wall_s"], cpu_wall_s=s_cpu["wall_s"],
               plain_wall_s=plain["summary"]["wall_s"])
    share = s_card["spillover"]["spillover_fraction"]
    log(f"[smoke] 15d serve --spillover on the overload leg: "
        f"{s_card['completed']} completed, {s_card['shed']} shed, "
        f"{len(spilled)} on the CPU spillover (share {share:.3f}, "
        f"{s_card['spillover']['spillover_tasks']} tasks), "
        f"{s_card['phases']} phases, wall {s_card['wall_s']} s (CPU run "
        f"{s_cpu['wall_s']} s; without spillover {plain['summary']['wall_s']}"
        f" s in {plain['summary']['phases']} phases); card = CPU records "
        f"{keys and not bad} (walk areas max gap {d_walk:.3e}, tol "
        f"{AREA_TOL_DEVICES}; spillover areas bit-equal), summaries "
        f"{same_summary}; max |spillover - walk| {d_spill:.3e} (tol "
        f"{SPILL_CONTRACT}); launches {card['launches']}")
    if (not keys or bad or not same_summary or not spilled
            or not d_walk < AREA_TOL_DEVICES or not d_spill < SPILL_CONTRACT
            or card["launches"]["run_segment_rf"] <= 0):
        raise AssertionError(f"15d failed: {out}, bad {bad}")

    ck = os.path.join(ckpt_dir, "spill.ckpt")
    flags = dict(checkpoint=ck, checkpoint_every=1)
    k1 = run_cli(W, TS, spill_serve_argv(
        DEVICE, fault_plan='[{"kind": "sigterm", "at": 3}]', **flags))
    with np.load(ck) as z:
        totals = json.loads(bytes(z["meta"]).decode())["totals"]
    queued = len(totals["spill_queue"])
    k2 = run_cli(W, TS, spill_serve_argv(DEVICE, **flags))
    union = {**serve_ledger(k1), **serve_ledger(k2)}
    bad_r = sorted(str(k) for k in set(union) | set(a)
                   if union.get(k) != a.get(k))
    out["restart"] = dict(terminated=k1["summary"].get("terminated"),
                          spill_queue_at_kill=queued, differing=bad_r,
                          launches={k: k1["launches"][k] + k2["launches"][k]
                                    for k in k1["launches"]})
    log(f"[smoke] 15d SIGTERM at phase 3: terminated "
        f"{out['restart']['terminated']!r}, {queued} requests in the kept "
        f"snapshot's spill queue; restart: the two ledgers against the "
        f"uninterrupted run differ at {bad_r}; snapshot cleared "
        f"{not os.path.exists(ck)}")
    if (out["restart"]["terminated"] != "SIGTERM" or queued <= 0 or bad_r
            or os.path.exists(ck)):
        raise AssertionError(f"15d restart failed: {out['restart']}")
    out["launches"] = {k: card["launches"][k] + plain["launches"][k]
                       + out["restart"]["launches"][k]
                       for k in card["launches"]}
    return out


def cli_trace(W, TS, ckpt_dir) -> dict:
    """15e. --trace around a K1 family run: the Chrome trace, its CPU
    spans, and one K1 kernel event in it for each counted K1 launch."""
    d = os.path.join(ckpt_dir, "trace")
    argv = ["--trace", d] + flagship_argv() + K1_FLAGS
    argv[argv.index("--m") + 1] = str(TRACE_M)
    r, run = cli_json(W, TS, argv)
    path = os.path.join(d, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    cpu_ops = sum(1 for e in events
                  if str(e.get("name", "")).startswith("aten::"))
    k1_events = sum(1 for e in events if "walk_rf" in str(e.get("name", ""))
                    and e.get("cat") == "kernel")
    out = dict(bytes=os.path.getsize(path), events=len(events),
               cpu_ops=cpu_ops, k1_kernel_events=k1_events,
               launches=run["launches"], wall_s=run["wall_s"])
    log(f"[smoke] 15e --trace: {out['bytes']} bytes, {len(events)} events, "
        f"{cpu_ops} CPU operator spans, K1 kernel events {k1_events} (K1 "
        f"launches counted {run['launches']['run_segment_rf']}), wall "
        f"{run['wall_s']:.3f} s")
    # CUPTI sees the ctypes-launched kernels: one kernel event for each
    # counted K1 launch
    n_k1 = run["launches"]["run_segment_rf"]
    if not cpu_ops or n_k1 <= 0 or k1_events != n_k1:
        raise AssertionError(f"15e failed: {out}")
    return out


def phase_cli(W, TS, k1_res, k2_res, walls, ckpt_dir, smi) -> dict:
    """15. The root command and ``family`` from the shell: 15a-15e.
    Returns the records and phase 15's launches."""
    import torch
    t0 = time.perf_counter()
    out = dict(reference=cli_reference_problem(W, TS, smi),
               wavefront=wavefront_configs(W),
               flagship=cli_flagship(W, TS, k1_res, k2_res, walls, ckpt_dir,
                                     smi),
               spillover=cli_spillover(W, TS, ckpt_dir),
               trace=cli_trace(W, TS, ckpt_dir))
    torch.cuda.synchronize()
    parts = ([v["launches"] for v in out["reference"].values()
              if isinstance(v, dict) and "launches" in v]
             + [out["flagship"]["launches"], out["spillover"]["launches"],
                out["trace"]["launches"]])
    out["launches"] = {k: sum(p.get(k, 0) for p in parts)
                       for k in parts[0]}
    out["seconds"] = time.perf_counter() - t0
    log(f"[smoke] phase 15 (root command and family): {out['seconds']:.1f} "
        f"s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the reference bench's timed pipeline, nan_policy, the sort
# options, serve --adapt --slo-config, the tuning table on the card
# ---------------------------------------------------------------------------


def bench_pipeline(W, what, args, kw, base, base_launches, counter, repeats,
                   out_dir, tag) -> dict:
    """16a/16b: one seed (``seed_family_walker_state``), ``repeats`` runs
    queued with ``dispatch_family_walker`` on it and collected in order,
    every kernel's launch count set to 0 before the queue and read after
    the last collect. Each run must be bit-equal to ``base`` and the
    launches ``repeats`` times ``base_launches``. Then one more run of
    the pipeline under ``torch.profiler``."""
    import numpy as np
    import torch

    from ppls_tpu_torch.runtime.tune import last_resolution
    theta, bounds = args[2], args[3]
    seed = W.seed_family_walker_state(
        theta, bounds, capacity=kw["capacity"], lanes=kw["lanes"],
        roots_per_lane=kw["roots_per_lane"], device=kw["device"])
    torch.cuda.synchronize()
    kernels = (W.run_segment_rf, W.run_segment_ee, W.run_segment)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    queued = [W.dispatch_family_walker(*args, _state_override=seed, **kw)
              for _ in range(repeats)]
    tier = last_resolution()["tier"]
    t_queue = time.perf_counter() - t0
    runs, done = [], []
    for d in queued:
        runs.append(W.collect_family_walker(d))
        torch.cuda.synchronize()
        done.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    deltas = [done[0]] + [b - a for a, b in zip(done, done[1:])]
    differ = [i for i, r in enumerate(runs)
              if not all(same_walk(r, base).values())]
    want = {k: repeats * v for k, v in base_launches.items()}
    prof = profile_fn(lambda: W.collect_family_walker(
        W.dispatch_family_walker(*args, _state_override=seed, **kw)),
        "walk_rf_kernel" if counter is W.run_segment_rf
        else "walk_ee_kernel", out_dir, tag)
    row = dict(repeats=repeats, wall_s=done[-1], queue_s=t_queue,
               collect_deltas_s=deltas,
               wall_time_s=[r.metrics.wall_time_s for r in runs],
               median_delta_s=float(np.median(deltas)), launches=launches,
               tasks=base.metrics.tasks, differing_runs=differ, tier=tier,
               profile=prof)
    log(f"[smoke] 16 {what}: {repeats} dispatches on one seed queued in "
        f"{t_queue * 1e3:.1f} ms, collected in {done[-1]:.3f} s (per run: "
        f"median {row['median_delta_s']:.3f} s, deltas "
        f"{[round(x, 4) for x in deltas]}); launches {launches} (phase "
        f"{'4' if counter is W.run_segment_rf else '6'} x {repeats}: "
        f"{want}); runs differing from that phase's run {differ}; cadence "
        f"tier {tier}; profiled run idle share {prof['idle_share']}")
    if (differ or launches != want or launches[counter.__name__] <= 0
            or len(runs) != repeats):
        raise AssertionError(f"16 {what}: the pipeline differs: {row}")
    return row


def _poison(x, th):
    """tests/test_faults.py:80: NaN where theta > 8 and x > 0.5, theta x^2
    elsewhere (float64; the kernels walk quad_scaled's ds twin)."""
    import torch
    return torch.where((th > 8.0) & (x > 0.5), torch.nan, th * x * x)


def phase_quarantine(W, get_family_ds) -> dict:
    """16c: nan_policy at full width through K1 and K2: one of M families
    poisoned; quarantine marks exactly it, every other area is bit-equal
    to the unpoisoned run, "raise" raises."""
    import numpy as np
    fd = get_family_ds("quad_scaled")
    theta = 1.0 + np.arange(M) / M
    poisoned = theta.copy()
    poisoned[POISON_INDEX] = POISON_THETA
    healthy = np.arange(M) != POISON_INDEX
    out, launches = {}, {}
    for tag, over, counter in (
            ("k1", dict(refill_slots=REFILL_SLOTS, double_buffer=True),
             W.run_segment_rf),
            ("k2", dict(refill_slots=0), W.run_segment_ee)):
        kw = dict(capacity=CAPACITY, lanes=LANES,
                  roots_per_lane=ROOTS_PER_LANE, device=DEVICE, **over)
        base = W.integrate_family_walker(_poison, fd, theta, POISON_BOUNDS,
                                         POISON_EPS, **kw)
        res, wall, ov = counted(W, lambda: W.integrate_family_walker(
            _poison, fd, poisoned, POISON_BOUNDS, POISON_EPS,
            nan_policy="quarantine", **kw))
        failed = [] if res.failed is None else \
            [int(i) for i in np.flatnonzero(res.failed)]
        same = bool(np.array_equal(res.areas[healthy], base.areas[healthy]))
        try:
            W.integrate_family_walker(_poison, fd, poisoned, POISON_BOUNDS,
                                      POISON_EPS, nan_policy="raise", **kw)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        exact = theta[healthy] / 3.0
        row = dict(failed=failed, healthy_bit_equal=same, raised=raised,
                   tasks=res.metrics.tasks, base_tasks=base.metrics.tasks,
                   wall_s=wall, launches=ov[counter.__name__],
                   d_exact=float(np.max(np.abs(res.areas[healthy] - exact))))
        log(f"[smoke] 16c nan_policy through {counter.__name__}: theta "
            f"{POISON_THETA} at member {POISON_INDEX} of {M}: failed "
            f"{failed}, the other {M - 1} areas bit-equal to the unpoisoned "
            f"run {same} (max |area - theta/3| {row['d_exact']:.3e}), "
            f"{res.metrics.tasks} tasks ({base.metrics.tasks} unpoisoned), "
            f"wall {wall:.3f} s, launches {ov[counter.__name__]}; "
            f"nan_policy='raise': {raised!r}")
        if (base.failed is not None or failed != [POISON_INDEX] or not same
                or raised is None or "non-finite" not in raised
                or ov[counter.__name__] <= 0):
            raise AssertionError(f"16c ({tag}) failed: {row}")
        out[tag] = row
        for k, v in ov.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out


def phase_sort_options(W, f_theta, f_ds, theta, kw, exact, sample, bag,
                       ds_run, ds_wall) -> dict:
    """16d: sort_roots=False and sort_skip_ratio=0.0 on the flagship
    through K1, the ds walk (scout f64): within 3e-9 of the float64 bag on
    every 128th member and 1e-3 of the closed form; tasks and wall beside
    phase 4's ds run."""
    import numpy as np
    out, launches = {}, {}
    for tag, over in (("unsorted", dict(sort_roots=False)),
                      ("always_sort", dict(sort_skip_ratio=0.0))):
        r, wall, ov = counted(W, lambda: W.integrate_family_walker(
            f_theta, f_ds, theta, BOUNDS, EPS, scout_dtype="f64",
            **dict(kw, **over)))
        check_walk(f"16d {tag}", r, len(theta))
        areas = np.asarray(r.areas)
        d_bag = float(np.max(np.abs(areas[sample] - bag.areas)))
        d_exact = float(np.max(np.abs(areas - exact)))
        srows = int(r.cycle_stats[:, W.CYCLE_STAT_FIELDS.index(
            "sort_rows")].sum())
        row = dict(tasks=r.metrics.tasks, wall_s=wall,
                   kernel_steps=r.kernel_steps, cycles=r.cycles,
                   sort_rows=srows, d_bag=d_bag, d_exact=d_exact,
                   launches=ov["run_segment_rf"])
        log(f"[smoke] 16d {tag} (K1, ds walk): {r.metrics.tasks} tasks "
            f"(phase 4's ds run {ds_run.metrics.tasks}), wall {wall:.3f} s "
            f"({ds_wall:.3f}), kernel steps {r.kernel_steps} "
            f"({ds_run.kernel_steps}), cycles {r.cycles}, rows scored by "
            f"the sort {srows}, K1 launches {ov['run_segment_rf']}; max "
            f"|walker - f64 bag| {d_bag:.3e} (tol {AREA_TOL_BAG}), max "
            f"|walker - closed form| {d_exact:.3e} (tol {AREA_TOL_EXACT})")
        if (not d_bag < AREA_TOL_BAG or not d_exact < AREA_TOL_EXACT
                or ov["run_segment_rf"] <= 0
                or (srows == 0) != (tag == "unsorted")):
            raise AssertionError(f"16d ({tag}) failed: {row}")
        out[tag] = row
        for k, v in ov.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    return out


def _named_events(path, *names) -> list:
    """The (name, attrs) of the events file's ``names`` events, each
    once (a restart replays from its snapshot), in phase order."""
    seen, out = set(), []
    with open(path, encoding="utf-8") as fh:
        for ln in fh:
            r = json.loads(ln)
            if r.get("ev") != "event" or r.get("name") not in names:
                continue
            key = json.dumps([r["name"], r["attrs"]], sort_keys=True)
            if key not in seen:
                seen.add(key)
                out.append((r["name"], r["attrs"]))
    return sorted(out, key=lambda e: (e[1]["phase"], e[0],
                                      json.dumps(e[1], sort_keys=True)))


def _health_verdict(eng) -> dict:
    """GET /health of the port's metrics server with ``eng.slo_health``
    as its verdict."""
    from ppls_tpu_torch.obs.server import MetricsServer
    srv = MetricsServer(lambda: eng.telemetry.registry, port=0,
                        health_fn=eng.slo_health)
    try:
        status, text, _ms = http(srv.url.rsplit("/", 1)[0] + "/health")
    finally:
        srv.close()
    return dict(status=status, verdict=json.loads(text))


def phase_serve_adapt(W, TS, ckpt_dir) -> dict:
    """16e: ``serve --adapt --slo-config`` on phase 14's stream leg (the
    card CLI against the same configuration through ``StreamEngine`` in
    this process; a SIGTERM restart from its snapshot) and on the overload
    leg (the card CLI against the in-process engine on the CPU)."""
    from ppls_tpu_torch.obs.telemetry import Telemetry
    slo = json.dumps(ADAPT_SLO)
    names = ("knob_adapt", "slo_burn")
    out, launches = {}, {}

    def add(ov):
        for k, v in ov.items():
            launches[k] = launches.get(k, 0) + v

    # the stream leg on the card
    reqs, arr = serve_requests()
    ev = [os.path.join(ckpt_dir, f"adapt_{k}.jsonl")
          for k in ("cli", "eng", "sig")]
    a = run_cli(W, TS, serve_argv(adapt=True, slo_config=slo, events=ev[0]))
    tel = Telemetry(events_path=ev[1])
    eng = TS.StreamEngine(STREAM_FAMILY, EPS, telemetry=tel, adapt=True,
                          slo_config=ADAPT_SLO,
                          **dict(STREAM_KW, device=DEVICE))
    res, eng_wall, eov = counted(W, lambda: eng.run(reqs,
                                                    arrival_phase=arr))
    tel.close()
    health = _health_verdict(eng)
    want = {c.rid: record_of(c) for c in res.completed}
    bad = same_records(ledger(a), want)
    ev_cli, ev_eng = _named_events(ev[0], *names), \
        _named_events(ev[1], *names)
    tier = eng.telemetry.registry.value("ppls_tuning_resolution",
                                        tier="default")
    # SIGTERM at phase 3's open, then the same command again
    ck = os.path.join(ckpt_dir, "adapt.ckpt")
    flags = dict(adapt=True, slo_config=slo, checkpoint=ck,
                 checkpoint_every=1, events=ev[2])
    b1 = run_cli(W, TS, serve_argv(
        fault_plan='[{"kind": "sigterm", "at": 3}]', **flags))
    kept = os.path.exists(ck)
    b2 = run_cli(W, TS, serve_argv(**flags))
    union = ledger(b1, b2)
    bad_b = same_records(union, ledger(a))
    ev_sig = _named_events(ev[2], *names)
    for run in (a, b1, b2):
        add(run["launches"])
    add(eov)
    out["stream"] = dict(
        cli=serve_stats("16e stream leg --adapt --slo-config", a),
        engine_wall_s=eng_wall, records_differing=bad,
        events_equal=ev_cli == ev_eng, knob_adapt=[
            e for n, e in ev_cli if n == "knob_adapt"],
        slo_burn=[e for n, e in ev_cli if n == "slo_burn"], health=health,
        tuning_tier_default=tier, restart=dict(
            terminated=b1["summary"].get("terminated"), snapshot_kept=kept,
            retired_before=len(ledger(b1)), records_differing=bad_b,
            rids=len(union), events_equal=ev_sig == ev_cli))
    s = out["stream"]
    log(f"[smoke] 16e stream leg, serve --adapt --slo-config on the card "
        f"against StreamEngine in this process: records differing {bad}, "
        f"knob_adapt/slo_burn events equal {s['events_equal']} "
        f"(knob_adapt {s['knob_adapt']}); slo_burn events {s['slo_burn']}; "
        f"/health {health}; SIGTERM at phase 3 -> "
        f"{s['restart']['terminated']!r}, snapshot kept {kept}, restart: "
        f"records differing {bad_b}, rids {len(union)} of {len(reqs)}, "
        f"events across the restart equal {s['restart']['events_equal']}")
    if (bad or not s["events_equal"] or health["status"] not in (200, 503)
            or health["verdict"]["ok"] != (health["status"] == 200)
            or s["restart"]["terminated"] != "SIGTERM" or not kept or bad_b
            or len(union) != len(reqs) or not s["restart"]["events_equal"]
            or tier != 1.0 or a["launches"]["run_segment_rf"] <= 0):
        raise AssertionError(f"16e stream leg failed: {s}")

    # the overload leg: the card CLI against the in-process CPU engine
    ev_o = [os.path.join(ckpt_dir, f"adapt_over_{k}.jsonl")
            for k in ("card", "cpu")]
    o = run_cli(W, TS, spill_serve_argv(
        DEVICE, adapt=True, slo_config=slo, events=ev_o[0],
        spillover_limit=ADAPT_SPILL_LIMIT))
    add(o["launches"])
    reqs_o = []
    for i in range(SLO_K):
        t, p = SLO_TENANTS[i % len(SLO_TENANTS)]
        reqs_o.append((float(1.0 + i / SLO_K), SLO_BOUNDS,
                       {"tenant": t, "priority": p}))
    # the engine as serve builds it: serve has no sizing flags beyond these
    ckw = {k: SLO_KW[k] for k in ("slots", "chunk", "capacity", "lanes",
                                  "refill_slots")}
    tel = Telemetry(events_path=ev_o[1])
    cpu = TS.StreamEngine(
        STREAM_FAMILY, SLO_EPS, telemetry=tel, adapt=True,
        slo_config=ADAPT_SLO, queue_limit=SLO_QUEUE_LIMIT, quarantine=True,
        spillover=True, spillover_limit=ADAPT_SPILL_LIMIT, device="cpu",
        **ckw).run(
            reqs_o, arrival_phase=stream_sweep_arrivals(SLO_RATE, SLO_K,
                                                        SLO_SEED))
    tel.close()
    got = ledger(o)
    d = max(abs(got[c.rid]["area"] - c.area) for c in cpu.completed
            if not c.failed)
    keys = ("admit_phase", "retire_phase", "failed", "spillover")
    bad_o = sorted(c.rid for c in cpu.completed
                   if {k: got.get(c.rid, {}).get(k) for k in keys}
                   != dict({k: v for k, v in record_of(c).items()
                            if k in keys}, spillover=c.spillover or None))
    ev_card, ev_cpu = _named_events(ev_o[0], *names), \
        _named_events(ev_o[1], *names)
    out["overload"] = dict(
        cli=serve_stats("16e overload leg --adapt --slo-config", o),
        records_differing=bad_o, d_card_cpu=d,
        events_equal=ev_card == ev_cpu,
        knob_adapt=[e for n, e in ev_card if n == "knob_adapt"],
        slo_burn=[e for n, e in ev_card if n == "slo_burn"],
        shed=o["summary"]["shed"], cpu_shed=len(cpu.shed),
        spilled=o["summary"]["spillover"]["spillover_completed"])
    v = out["overload"]
    log(f"[smoke] 16e overload leg, serve --adapt --slo-config on the card "
        f"against the engine on the CPU: records differing {bad_o}, max "
        f"|card - CPU| {d:.3e} (tol {AREA_TOL_DEVICES}), knob_adapt/"
        f"slo_burn events equal {v['events_equal']}; knob_adapt "
        f"{v['knob_adapt']}; slo_burn {v['slo_burn']}")
    if (bad_o or not d < AREA_TOL_DEVICES or not v["events_equal"]
            or v["shed"] != v["cpu_shed"] or not v["knob_adapt"]
            or o["launches"]["run_segment_rf"] <= 0):
        raise AssertionError(f"16e overload leg failed: {v}")
    out["launches"] = launches
    return out


def phase_bench(W, TS, get_family_ds, base, out_dir, ckpt_dir) -> dict:
    """16. The reference bench's timed pipeline through K1 (16a) and its
    fallback leg through K2 (16b), nan_policy (16c), the sort options
    (16d), ``serve --adapt --slo-config`` (16e) and the tuning table's
    tier on the card (16f). ``base`` holds phases 4 and 6's runs."""
    from ppls_tpu_torch.runtime import tune
    t0 = time.perf_counter()
    out = dict(
        k1=bench_pipeline(W, "16a bench pipeline (K1)", base["args"],
                          dict(base["kw"], scout_dtype="f32"), base["k1"],
                          base["k1_launches"], W.run_segment_rf,
                          BENCH_REPEATS, out_dir, "bench_k1"),
        k2=bench_pipeline(W, "16b fallback leg (K2)", base["args"],
                          dict(base["kw0"], scout_dtype="f64"), base["k2"],
                          base["k2_launches"], W.run_segment_ee,
                          FALLBACK_REPEATS, out_dir, "bench_k2"),
        quarantine=phase_quarantine(W, get_family_ds),
        sort=phase_sort_options(W, *base["args"][:3], base["kw"],
                                base["exact"], base["sample"], base["bag"],
                                base["ds_run"], base["ds_wall"]),
        serve=phase_serve_adapt(W, TS, ckpt_dir))
    # 16f: the table's rows are keyed by device kind; this card has none
    kind = tune.device_kind(DEVICE)
    tiers = dict(k1=out["k1"]["tier"], k2=out["k2"]["tier"])
    for tag, args, kw in (
            ("flagship", base["args"], dict(base["kw"], scout_dtype="f32")),
            ("fallback", base["args"], dict(base["kw0"],
                                            scout_dtype="f64"))):
        W.dispatch_family_walker(*args, **kw)
        tiers[tag] = tune.last_resolution()["tier"]
    out["tuning"] = dict(device_kind=kind, tiers=tiers,
                         stream_tier_default=out["serve"]["stream"][
                             "tuning_tier_default"])
    log(f"[smoke] 16f tuning table on the card: device_kind {kind!r}, "
        f"tiers {tiers}, the stream's ppls_tuning_resolution gauge "
        f"tier=default {out['tuning']['stream_tier_default']}")
    if any(t != "default" for t in tiers.values()):
        raise AssertionError(f"16f: a cadence resolved off the hand tier "
                             f"on the card: {tiers}")
    out["launches"] = {
        k: (out["k1"]["launches"][k] + out["k2"]["launches"][k]
            + out["quarantine"]["launches"][k] + out["sort"]["launches"][k]
            + out["serve"]["launches"][k])
        for k in out["k1"]["launches"]}
    out["seconds"] = time.perf_counter() - t0
    log(f"[smoke] phase 16: {out['seconds']:.1f} s; launches "
        f"{out['launches']}")
    return out


def phase_2d(out_dir) -> dict:
    """17. The 2D cubature: the reference bench's gates (17a), the ring
    against the C rectangle bag (17b), the pipelined timing and one
    profiled run (17c), card against CPU (17d), the ``2d`` command
    (17e)."""
    import torch
    from ppls_tpu_torch import __main__ as CLI
    from ppls_tpu_torch.backends.mpi_backend import run_seq_2d
    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.models.integrands import get_integrand_2d
    from ppls_tpu_torch.parallel import cubature as C2
    t_phase = time.perf_counter()
    out = {"gates": {}}
    peak = get_integrand_2d("gauss2d_peak")
    exact = peak.exact(*BOUNDS_2D)
    for tag, rule, eps, chunk, cap, gate in GATES_2D:
        r = C2.integrate_2d(peak.fn, BOUNDS_2D, eps, rule=Rule[rule],
                            chunk=chunk, capacity=cap, exact=exact,
                            device=DEVICE)
        m = r.metrics
        log(f"[smoke] 17a gauss2d_peak {tag} eps {eps:g}: {m.tasks} cells, "
            f"{m.rounds} rounds, depth {m.max_depth}, wall "
            f"{m.wall_time_s:.3f} s, global error {r.global_error:.3e} "
            f"(gate {gate:g})")
        if not r.global_error <= gate:
            raise AssertionError(f"17a: 2D {tag} global error "
                                 f"{r.global_error:.3e} > {gate:g}")
        out["gates"][tag] = dict(cells=m.tasks, splits=m.splits,
                                 rounds=m.rounds, depth=m.max_depth,
                                 wall_s=m.wall_time_s,
                                 global_error=r.global_error)

    # 17b: the timed workload against the C twin
    ring = get_integrand_2d("gauss2d_ring")
    ring_exact = ring.exact(*BOUNDS_2D)
    kw = dict(RING_KW, rule=Rule.TRAPEZOID)
    c = run_seq_2d("gauss2d_ring", *BOUNDS_2D, RING_EPS)
    c_rate = c["tasks"] / c["wall_time_s"]
    res = C2.integrate_2d(ring.fn, BOUNDS_2D, RING_EPS, exact=ring_exact,
                          device=DEVICE, **kw)
    m = res.metrics
    d_c = abs(res.area - c["area"])
    log(f"[smoke] 17b gauss2d_ring trapezoid eps {RING_EPS:g}: {m.tasks} "
        f"cells, {m.splits} splits, {m.rounds} rounds, depth "
        f"{m.max_depth}, wall {m.wall_time_s:.3f} s, global error "
        f"{res.global_error:.3e} (gate {RING_GATE:g}); C: {c['tasks']} "
        f"cells, {c['splits']} splits, {c['wall_time_s']:.3f} s "
        f"({c_rate / 1e6:.3f} M cells/s); |area - C| {d_c:.3e} (tol "
        f"{RING_C_AREA_TOL:g}); {time.perf_counter() - t_phase:.1f} s into "
        f"the phase")
    if not res.global_error <= RING_GATE:
        raise AssertionError(f"17b: ring global error "
                             f"{res.global_error:.3e}")
    if (m.tasks, m.splits) != (c["tasks"], c["splits"]):
        raise AssertionError(f"17b: cells/splits {m.tasks}/{m.splits} != "
                             f"C's {c['tasks']}/{c['splits']}")
    if not d_c <= RING_C_AREA_TOL:
        raise AssertionError(f"17b: ring area {d_c:.3e} from C's")
    out["ring"] = dict(cells=m.tasks, splits=m.splits, rounds=m.rounds,
                       depth=m.max_depth, wall_s=m.wall_time_s,
                       global_error=res.global_error, d_c=d_c,
                       host_syncs=res.host_syncs, c=c)

    # 17c: one prebuilt seed, REPEATS_2D dispatches, collected in order
    seed = C2.seed_rect_state(BOUNDS_2D, kw["chunk"], kw["capacity"],
                              device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = [C2.dispatch_2d(ring.fn, BOUNDS_2D, RING_EPS, exact=ring_exact,
                         device=DEVICE, _state_override=seed, **kw)
          for _ in range(REPEATS_2D)]
    rs = [C2.collect_2d(d) for d in ds]
    wall = time.perf_counter() - t0
    cells = sum(r.metrics.tasks for r in rs)
    rate = cells / wall
    if any(r.area != res.area or r.metrics.tasks != m.tasks for r in rs):
        raise AssertionError("17c: a pipelined run differs from 17b's")
    # profiled: the ring at RING_PROFILE_EPS (same chunk and store, so
    # the same rounds' shape; the timed run's ~150k profiler events take
    # ~45 s to process)
    prof = profile_fn(lambda: C2.integrate_2d(
        ring.fn, BOUNDS_2D, RING_PROFILE_EPS, device=DEVICE,
        _state_override=seed, **kw), "Sort", out_dir, "ring_2d")
    log(f"[smoke] 17c pipelined: {REPEATS_2D} runs, {cells} cells in "
        f"{wall:.3f} s: {rate / 1e6:.3f} M cells/s, {rate / c_rate:.3f}x "
        f"C's; {m.rounds} rounds and {rs[0].host_syncs} host syncs a run "
        f"({rs[0].host_syncs / m.rounds:.4f} per round); profiled run (eps "
        f"{RING_PROFILE_EPS:g}): busy {prof['busy_ms']:.1f} ms of "
        f"{prof['wall_ms']:.1f}, idle share {prof['idle_share']}")
    out["pipeline"] = dict(repeats=REPEATS_2D, cells=cells, wall_s=wall,
                           cells_per_s=rate, c_cells_per_s=c_rate,
                           vs_c=rate / c_rate, rounds=m.rounds,
                           host_syncs_per_run=rs[0].host_syncs,
                           profile=prof)

    # 17d: card against CPU at the tests' size, and both against C
    out["card_cpu"] = {}
    for name in ("gauss2d_peak", "gauss2d_ring"):
        f = get_integrand_2d(name).fn
        kw_d = dict(rule=Rule.TRAPEZOID, chunk=CPU_2D["chunk"],
                    capacity=CPU_2D["capacity"])
        card = C2.integrate_2d(f, BOUNDS_2D, CPU_2D["eps"], device=DEVICE,
                               **kw_d)
        cpu = C2.integrate_2d(f, BOUNDS_2D, CPU_2D["eps"], device="cpu",
                              **kw_d)
        cc = run_seq_2d(name, *BOUNDS_2D, CPU_2D["eps"])
        a, b = card.metrics, cpu.metrics
        d = abs(card.area - cpu.area)
        log(f"[smoke] 17d {name} eps {CPU_2D['eps']:g}: card {a.tasks} "
            f"cells / {a.rounds} rounds ({a.wall_time_s:.3f} s), CPU "
            f"{b.tasks} / {b.rounds} ({b.wall_time_s:.3f} s), C "
            f"{cc['tasks']} ({cc['wall_time_s']:.3f} s); |card - CPU| "
            f"{d:.3e} (tol {AREA_TOL_2D:g}); "
            f"{time.perf_counter() - t_phase:.1f} s into the phase")
        if ((a.tasks, a.splits, a.rounds, a.max_depth)
                != (b.tasks, b.splits, b.rounds, b.max_depth)
                or a.tasks != cc["tasks"] or not d <= AREA_TOL_2D):
            raise AssertionError(f"17d: {name} card and CPU differ")
        out["card_cpu"][name] = dict(cells=a.tasks, rounds=a.rounds,
                                     d_area=d)

    # 17e: the 2d command in this process, against integrate_2d
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = CLI.main(["2d", "--json", "--device", DEVICE])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    direct = C2.integrate_2d(peak.fn, BOUNDS_2D, 1e-8, exact=exact,
                             device=DEVICE)
    if rc != 0 or rec["area"] != direct.area \
            or rec["tasks"] != direct.metrics.tasks:
        raise AssertionError(f"17e: 2d --json {rec} differs from "
                             f"integrate_2d's {direct.area!r}")
    log(f"[smoke] 17e 2d --json: area {rec['area']!r}, {rec['tasks']} cells "
        f"(equal to integrate_2d); 2d --n-devices: phase 20f")
    out["cli"] = dict(area=rec["area"], tasks=rec["tasks"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] phase 17: {out['seconds']:.1f} s")
    return out


def qmc_numpy_baseline(n, shifts, a, u) -> dict:
    """Host numpy twin of the device QMC leg on the oscillatory Genz
    family (bench.py:791-823): the same Korobov lattice and shift set,
    vectorized numpy on the host CPU, chunked so the (n, d) block never
    materializes."""
    import numpy as np
    from ppls_tpu_torch.parallel.qmc import KOROBOV_A
    a_gen = KOROBOV_A[n]
    d = a.shape[0]
    z = np.empty(d, dtype=np.int64)
    zj = 1
    for j in range(d):
        z[j] = zj
        zj = (zj * a_gen) % n
    block = 1 << 19
    t0 = time.perf_counter()
    estimates = []
    for shift in shifts:
        total = 0.0
        for s0 in range(0, n, block):
            k = np.arange(s0, min(s0 + block, n), dtype=np.int64)
            x = (((k[:, None] % n) * z[None, :]) % n) / float(n)
            x = (x + shift[None, :]) % 1.0
            total += float(np.sum(np.cos(2.0 * np.pi * u[0] + x @ a)))
        estimates.append(total / n)
    wall = time.perf_counter() - t0
    points = n * len(shifts)
    return {"points": points, "wall_s": wall,
            "points_per_sec": points / wall,
            "value": float(np.mean(estimates))}


def phase_qmc(out_dir) -> dict:
    """18. The QMC lattice: six Genz families at N = 2^22 (18a), the
    numpy denominator (18b), the error slope (18c), card against CPU
    (18d), the ``qmc`` command (18e)."""
    import numpy as np
    import torch
    from ppls_tpu_torch import __main__ as CLI
    from ppls_tpu_torch.models.genz import GENZ, genz_params
    from ppls_tpu_torch.parallel.qmc import KOROBOV_A, integrate_qmc
    t_phase = time.perf_counter()
    out = {"families": {}}
    kw = dict(n_points=QMC_N, n_shifts=QMC_SHIFTS, device=DEVICE)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    worst = 0.0
    for name, fam in sorted(GENZ.items()):
        a, u = genz_params(name, QMC_DIM, seed=0)
        exact = fam.exact(a, u)
        integrate_qmc(fam.fn, a, u, **kw)              # first call
        r = integrate_qmc(fam.fn, a, u, exact=exact, **kw)
        rel = abs(r.value - exact) / max(abs(exact), 1e-300)
        worst = max(worst, rel)
        out["families"][name] = dict(value=r.value, exact=exact, rel=rel,
                                     std_error=r.std_error,
                                     wall_s=r.metrics.wall_time_s)
        log(f"[smoke] 18a {name}: value {r.value:+.10e}, rel error "
            f"{rel:.3e}, stderr {r.std_error:.2e}, wall "
            f"{r.metrics.wall_time_s * 1e3:.2f} ms")
    if not worst <= QMC_GATE:
        raise AssertionError(f"18a: worst rel error {worst:.3e}")
    t0 = time.perf_counter()
    evals = 0
    for name, fam in sorted(GENZ.items()):
        a, u = genz_params(name, QMC_DIM, seed=0)
        evals += integrate_qmc(fam.fn, a, u, **kw).metrics.integrand_evals
    wall = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if DEVICE == "cuda" else None)
    log(f"[smoke] 18a: worst rel error {worst:.3e} (gate {QMC_GATE:g}); "
        f"{evals / wall / 1e6:.1f} M points/s over the six families "
        f"({evals} points in {wall:.3f} s); peak device memory "
        f"{peak_gb} GB")
    out.update(worst_rel=worst, points_per_s=evals / wall,
               timed_points=evals, timed_wall_s=wall, peak_gb=peak_gb)

    # 18b: the numpy denominator, oscillatory on both sides
    a_osc, u_osc = genz_params("oscillatory", QMC_DIM, seed=0)
    osc = GENZ["oscillatory"]
    t0 = time.perf_counter()
    r_osc = integrate_qmc(osc.fn, a_osc, u_osc, **kw)
    osc_rate = QMC_N * QMC_SHIFTS / (time.perf_counter() - t0)
    shifts = np.random.default_rng(17).random((QMC_SHIFTS, QMC_DIM))
    cpu = qmc_numpy_baseline(QMC_N, shifts, a_osc, u_osc)
    d_np = abs(cpu["value"] - r_osc.value)
    log(f"[smoke] 18b oscillatory: device {osc_rate / 1e6:.1f} M points/s, "
        f"numpy {cpu['points_per_sec'] / 1e6:.2f} M points/s ("
        f"{cpu['wall_s']:.2f} s) -> {osc_rate / cpu['points_per_sec']:.1f}x; "
        f"|numpy - device| {d_np:.3e} (tol {QMC_NUMPY_TOL:g})")
    if not d_np <= QMC_NUMPY_TOL:
        raise AssertionError(f"18b: numpy value {d_np:.3e} from the card's")
    out["numpy"] = dict(device_points_per_s=osc_rate,
                        numpy_points_per_s=cpu["points_per_sec"],
                        numpy_wall_s=cpu["wall_s"],
                        ratio=osc_rate / cpu["points_per_sec"], d=d_np)

    # 18c: the error slope, oscillatory over every lattice size
    errs = {}
    exact_osc = osc.exact(a_osc, u_osc)
    for nn in sorted(k for k in KOROBOV_A if k <= QMC_N):
        rr = integrate_qmc(osc.fn, a_osc, u_osc, n_points=nn,
                           n_shifts=QMC_SHIFTS, device=DEVICE)
        errs[nn] = float(abs(rr.value - exact_osc))
    xs = np.log2(np.array(sorted(errs), dtype=np.float64))
    ys = np.log2(np.maximum([errs[k] for k in sorted(errs)], 1e-300))
    slope = float(np.polyfit(xs, ys, 1)[0])
    log(f"[smoke] 18c error slope (oscillatory): "
        f"{ {int(np.log2(k)): v for k, v in sorted(errs.items())} } -> "
        f"d log2 err / d log2 N {slope:.3f}")
    out["slope"] = dict(abs_error_by_log2n={int(np.log2(k)): v
                                            for k, v in errs.items()},
                        slope=slope)

    # 18d: card against CPU, every shift's estimate
    out["card_cpu"] = {}
    for name, fam in sorted(GENZ.items()):
        a, u = genz_params(name, QMC_DIM, seed=0)
        card = integrate_qmc(fam.fn, a, u, n_points=QMC_CPU_N,
                             device=DEVICE)
        host = integrate_qmc(fam.fn, a, u, n_points=QMC_CPU_N, device="cpu")
        rel = float(np.max(np.abs(card.estimates - host.estimates)
                           / np.abs(host.estimates)))
        out["card_cpu"][name] = rel
        if not rel <= QMC_CPU_REL:
            raise AssertionError(f"18d: {name} card and CPU estimates "
                                 f"{rel:.3e} apart")
    log(f"[smoke] 18d card against CPU at N = {QMC_CPU_N}: max relative "
        f"difference per family {out['card_cpu']} (tol {QMC_CPU_REL:g})")

    # 18e: the qmc command in this process, against integrate_qmc
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = CLI.main(["qmc", "--json", "--device", DEVICE])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    for name, fam in sorted(GENZ.items()):
        a, u = genz_params(name, QMC_DIM, seed=0)
        direct = integrate_qmc(fam.fn, a, u, device=DEVICE)
        if rc != 0 or rec["families"][name]["value"] != direct.value:
            raise AssertionError(f"18e: qmc --json {name} "
                                 f"{rec['families'][name]} differs from "
                                 f"integrate_qmc's {direct.value!r}")
    log(f"[smoke] 18e qmc --json (N = {rec['n_points']}): six values equal "
        f"to integrate_qmc's")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] phase 18: {out['seconds']:.1f} s")
    return out


def cpu_threads(n: int) -> int:
    """The torch threads of each rank of a CPU world of ``n``
    (``mesh.launch``'s): what a CPU call run inside a card's world sets
    first, so its reductions split as in a CPU world."""
    return max(1, (os.cpu_count() or 1) // n)


def dd_cadence(W, leg_kw: dict) -> dict:
    """The hand tier's cadence for a dd leg, passed explicitly where a
    CPU run is held against the card (the CPU has tuning-table rows the
    card has not; phase 5 does the same)."""
    scout = leg_kw.get("scout_dtype") == "f32"
    exit_frac, suspend_frac = W.resolve_cadence(
        None, None, scout, leg_kw.get("refill_slots", 0))
    return dict(exit_frac=exit_frac, suspend_frac=suspend_frac)


def dd_kernels(W, ops) -> dict:
    """19k: K1 (scouting, R = 8) and K2 (trapezoid) against their plain
    segments at a dd rank's shapes: the bench dd leg's bred bank and
    seeded lanes at 2^12 lanes."""
    import numpy as np
    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    f_theta, f_ds = get_family(DD_FAMILY), get_family_ds(DD_FAMILY)
    theta = 1.0 + np.arange(DD_M) / DD_M
    kw = dict(lanes=DD_KW["lanes"], roots_per_lane=DD_KW["roots_per_lane"],
              capacity=DD_KW["capacity"], device="cuda")
    out = {}
    base = W.first_phase_inputs(f_theta, theta, BOUNDS, DD_EPS,
                                refill_slots=8, scout=True, **kw)
    out["k1"], times = cmp_k1(W, "K1 step_scout (dd)", base, f_ds, DD_EPS,
                              "step_scout", ops)
    log(fmt_cmp(f"K1 step_scout at a dd rank's shapes ({DD_KW['lanes']} "
                f"lanes, R 8)", out["k1"], times))
    seeded = W.first_phase_inputs(f_theta, theta, BOUNDS, DD_EPS,
                                  refill_slots=0, scout=False,
                                  rule=Rule.TRAPEZOID, **kw)
    out["k2"], times = cmp_k2(W, "K2 step (dd)", seeded, f_ds, DD_EPS,
                              "step", ops)
    log(fmt_cmp(f"K2 step at a dd rank's shapes ({DD_KW['lanes']} lanes)",
                out["k2"], times))
    return out


def dd_record(what: str, r, exact, bag, sample, wall_s) -> dict:
    """One dd run, checked and logged: the closed form, the float64 bag
    (held only on the ds leg), tasks = splits + leaves, the waste, and
    every rank's K1 or K2 launches."""
    import numpy as np
    m = r.mesh
    d_ex = float(np.max(np.abs(r.areas - exact)))
    d_bag = float(np.max(np.abs(r.areas[sample] - bag)))
    check_walk(what, r, len(exact))
    kernel = "run_segment_rf" if r.refill_slots else "run_segment_ee"
    other = "run_segment_ee" if r.refill_slots else "run_segment_rf"
    if not d_ex < AREA_TOL_EXACT:
        raise AssertionError(f"{what}: {d_ex:.3e} from the closed form")
    if min(m["launches"][kernel]) <= 0 or max(m["launches"][other]) != 0:
        raise AssertionError(f"{what}: launches per rank {m['launches']}")
    rec = dict(wall_s=wall_s, engine_wall_s=r.metrics.wall_time_s,
               tasks=r.metrics.tasks, cycles=r.cycles,
               kernel_steps=r.kernel_steps,
               tasks_per_chip=r.metrics.tasks_per_chip,
               collective_rounds=r.collective_rounds,
               collective_rounds_per_cycle=r.collective_rounds_per_cycle,
               launches=m["launches"], host_syncs=m["host_syncs"],
               transport=dict(backend=m["backend"],
                              host_staged=m["host_staged"]),
               collective_calls=m["collective_calls"], d_exact=d_ex,
               d_bag=d_bag, lane_efficiency=r.lane_efficiency)
    log(f"[smoke] {what}: wall {wall_s:.3f} s (engine "
        f"{r.metrics.wall_time_s:.3f} s), {r.metrics.tasks} tasks, "
        f"{r.cycles} cycles, {r.kernel_steps} kernel steps, per rank "
        f"{r.metrics.tasks_per_chip}; collective rounds "
        f"{r.collective_rounds} ({r.collective_rounds_per_cycle:.3f} per "
        f"cycle); {kernel} launches per rank {m['launches'][kernel]}; host "
        f"syncs per rank {m['host_syncs']}; transport {m['backend']}"
        f"{' staged through host memory' if m['host_staged'] else ''}; "
        f"collective calls of rank 0 {m['collective_calls']} (the "
        f"reference's census: {DD_CENSUS}); {d_ex:.3e} from the closed "
        f"form, every {DD_SAMPLE_STRIDE}th member {d_bag:.3e} from the "
        f"float64 bag")
    return rec


def dd_same(what: str, a, b, tol: float) -> float:
    """Raise unless two dd runs have the same schedule (tasks, splits,
    cycles, kernel steps, collective rounds, tasks per rank) and areas
    within ``tol``; returns the areas' largest difference."""
    import numpy as np
    got = [(x.metrics.tasks, x.metrics.splits, x.cycles, x.kernel_steps,
            x.collective_rounds, x.metrics.tasks_per_chip) for x in (a, b)]
    d = float(np.max(np.abs(np.asarray(a.areas) - np.asarray(b.areas))))
    if got[0] != got[1] or not d <= tol:
        raise AssertionError(f"{what}: {got[0]} vs {got[1]}, areas {d:.3e}")
    return d


def dd_launches(*recs) -> dict:
    """Every rank's K1 and K2 launches summed over dd runs."""
    return {k: sum(sum(r.mesh["launches"][k]) for r in recs)
            for k in ("run_segment_rf", "run_segment_ee")}


def phase_dd(W, TS, ckpt_dir, out_dir) -> dict:
    """19: the family engines across ranks (module docstring)."""
    import numpy as np
    import torch
    from ppls_tpu_torch.models.integrands import family_exact, get_family
    from ppls_tpu_torch.parallel import mesh as MESH
    from ppls_tpu_torch.parallel import sharded_walker as SW
    from ppls_tpu_torch.parallel.bag_engine import integrate_family
    from ppls_tpu_torch.parallel.sharded_bag import integrate_family_sharded
    MESH.LAUNCH_TIMEOUT_S = DD_TIMEOUT       # the CLI's launches too
    t_phase = time.perf_counter()
    theta = 1.0 + np.arange(DD_M) / DD_M
    args = (DD_FAMILY, theta, BOUNDS, DD_EPS)
    exact = family_exact(DD_FAMILY, *BOUNDS, theta)
    sample = np.arange(0, DD_M, DD_SAMPLE_STRIDE)
    bag = integrate_family(get_family(DD_FAMILY), theta[sample], BOUNDS,
                           DD_EPS, chunk=1 << 15, capacity=1 << 22,
                           device=DEVICE).areas
    out, runs = {"runs": {}}, {}
    card = dict(device=DEVICE)

    # a. world 1 in this process (NCCL on the card), a warm-up each leg
    for leg, lkw in DD_LEGS.items():
        kw = dict(DD_KW, **lkw, n_devices=1, **card)
        SW.integrate_family_walker_dd(*args, **kw)
        t0 = time.perf_counter()
        r = SW.integrate_family_walker_dd(*args, **kw)
        torch.cuda.synchronize()
        runs[(1, leg)] = r
        out["runs"][f"1/{leg}"] = dd_record(
            f"19a dd {leg}, world 1", r, exact, bag, sample,
            time.perf_counter() - t0)
    out["profile"] = profile_fn(
        lambda: SW.integrate_family_walker_dd(
            *args, **DD_KW, **DD_LEGS["refill"], n_devices=1, **card),
        "walk_rf_kernel", out_dir, "dd_world1_refill")

    # a, b, c, d on 4 ranks of the card: one launch, every call in order
    paths = {k: os.path.join(ckpt_dir, f"dd_{k}.ckpt")
             for k in ("resume", "resize")}
    test_kw = {leg: dict(DD_TEST_KW, **lkw, **dd_cadence(W, lkw))
               for leg, lkw in DD_TEST_LEGS.items()}
    w4 = dict(n_devices=4, device=DEVICE)
    refill4 = dict(DD_KW, **DD_LEGS["refill"], **w4)
    calls = [("warm_refill", SW.integrate_family_walker_dd, args, refill4),
             ("warm_legacy", SW.integrate_family_walker_dd, args,
              dict(DD_KW, **DD_LEGS["legacy"], **w4)),
             ("refill", SW.integrate_family_walker_dd, args, refill4),
             ("legacy", SW.integrate_family_walker_dd, args,
              dict(DD_KW, **DD_LEGS["legacy"], **w4)),
             ("crash", SW.integrate_family_walker_dd, args,
              dict(refill4, checkpoint_path=paths["resume"],
                   checkpoint_every=1, _crash_after_legs=1)),
             ("resume", SW.resume_family_walker_dd,
              (paths["resume"], *args), dict(refill4, checkpoint_every=1)),
             ("bag", integrate_family_sharded,
              (DD_FAMILY, theta, BOUNDS, DD_BAG_EPS),
              dict(chunk=DD_KW["chunk"], capacity=DD_KW["capacity"], **w4)),
             ("test_refill", SW.integrate_family_walker_dd, DD_TEST_ARGS,
              dict(test_kw["refill"], **w4)),
             ("test_legacy", SW.integrate_family_walker_dd, DD_TEST_ARGS,
              dict(test_kw["legacy"], **w4)),
             ("test_crash", SW.integrate_family_walker_dd, DD_TEST_ARGS,
              dict(test_kw["refill"], checkpoint_path=paths["resize"],
                   checkpoint_every=1, _crash_after_legs=2, **w4)),
             # 19b's CPU twins, last, in the same world (gloo carries
             # both), each rank at a CPU world's thread count
             ("cpu_threads", torch.set_num_threads, (cpu_threads(4),), {})]
    calls += [(f"cpu_{leg}", SW.integrate_family_walker_dd, DD_TEST_ARGS,
               dict(test_kw[leg], n_devices=4, device="cpu"))
              for leg in ("refill", "legacy")]
    t0 = time.perf_counter()
    got = MESH.launch(MESH.run_calls, 4, DEVICE,
                      ([c[1:] for c in calls],), timeout=DD_TIMEOUT)
    w4_wall = time.perf_counter() - t0
    got = {c[0]: g for c, g in zip(calls, got)}
    for k, g in got.items():
        if isinstance(g, Exception) and k not in ("crash", "test_crash"):
            raise AssertionError(f"19 world 4 {k}: {g!r}")
    log(f"[smoke] 19 world 4 on one card: {len(calls)} calls (19b's CPU "
        f"twins among them) in {w4_wall:.1f} s (4 spawned ranks, their "
        f"start included)")
    for leg in DD_LEGS:
        runs[(4, leg)] = r = got[leg]
        out["runs"][f"4/{leg}"] = dd_record(
            f"19a dd {leg}, world 4 (one card)", r, exact, bag, sample,
            r.metrics.wall_time_s)
        dd_same(f"19a {leg} world 4, warm-up against the timed run",
                r, got[f"warm_{leg}"], 0.0)
    for w in DD_WORLDS:
        ds_leg = out["runs"][f"{w}/legacy"]
        if not ds_leg["d_bag"] < AREA_TOL_BAG:
            raise AssertionError(f"19a world {w}: the ds leg is "
                                 f"{ds_leg['d_bag']:.3e} from the bag")
        rf, lg = runs[(w, "refill")], runs[(w, "legacy")]
        if not rf.collective_rounds_per_cycle \
                < lg.collective_rounds_per_cycle:
            raise AssertionError(f"19a world {w}: refill's collective "
                                 f"rounds per cycle are not below legacy's")

    # b. card against CPU at the tests' shapes, 4 ranks each
    out["card_cpu"] = {}
    for leg in ("refill", "legacy"):
        out["card_cpu"][leg] = dd_same(
            f"19b {leg}: card against CPU", got[f"test_{leg}"],
            got[f"cpu_{leg}"], AREA_TOL_DEVICES)
    log(f"[smoke] 19b card = CPU at the tests' shapes, 4 ranks, both "
        f"modes (areas {out['card_cpu']})")

    # c. kill-and-resume on 4 ranks; the 4-rank snapshot resumed on 2
    if not isinstance(got["crash"], RuntimeError):
        raise AssertionError(f"19c: the crash run returned {got['crash']}")
    dd_same("19c refill resumed after one leg against the uninterrupted "
            "run", got["resume"], runs[(4, "refill")], 0.0)
    shutil.copy(paths["resize"], paths["resize"] + ".cpu")
    rkw = dict(test_kw["refill"], mesh_resize=True, checkpoint_every=1,
               n_devices=2)
    # the card's resume and the CPU's in one world of 2
    r2 = MESH.launch(MESH.run_calls, 2, DEVICE, ([
        (SW.resume_family_walker_dd, (paths["resize"], *DD_TEST_ARGS),
         dict(rkw, device=DEVICE)),
        (torch.set_num_threads, (cpu_threads(2),), {}),
        (SW.resume_family_walker_dd,
         (paths["resize"] + ".cpu", *DD_TEST_ARGS),
         dict(rkw, device="cpu"))],), timeout=DD_TIMEOUT)
    resized = {"card": r2[0], "cpu": r2[2]}
    for where, r in resized.items():
        if isinstance(r, Exception):
            raise AssertionError(f"19c the {where}'s resize: {r!r}")
    out["resize"] = dd_same("19c a 4-rank snapshot on 2 ranks, card "
                            "against CPU", resized["card"], resized["cpu"],
                            AREA_TOL_DEVICES)
    log(f"[smoke] 19c kill-and-resume bit-equal on 4 ranks; the 4-rank "
        f"snapshot on 2 ranks: card = CPU ({resized['card'].metrics.tasks}"
        f" tasks, per rank {resized['card'].metrics.tasks_per_chip})")

    # d. the CLI against the in-process calls
    dd_argv = ["family", "--engine", "sharded-walker-dd", "--n-devices",
               "4", "--m", str(DD_M), "-a", str(BOUNDS[0]), "-b",
               str(BOUNDS[1]), "--eps", str(DD_EPS), "--chunk",
               str(DD_KW["chunk"]), "--capacity", str(DD_KW["capacity"]),
               "--theta0", "1", "--theta1", "2", "--refill-slots",
               str(DD_LEGS["refill"]["refill_slots"]), "--scout-dtype",
               DD_LEGS["refill"]["scout_dtype"], "--double-buffer"]
    bag_argv = ["family", "--engine", "sharded-bag", "--n-devices", "4",
                "--m", str(DD_M), "-a", str(BOUNDS[0]), "-b",
                str(BOUNDS[1]), "--eps", str(DD_BAG_EPS), "--chunk",
                str(DD_KW["chunk"]), "--capacity", str(DD_KW["capacity"]),
                "--theta0", "1", "--theta1", "2"]
    out["cli"] = {}
    for name, argv, want in (("sharded-walker-dd", dd_argv,
                              runs[(4, "refill")]),
                             ("sharded-bag", bag_argv, got["bag"])):
        rec, run = cli_json(W, TS, argv)
        head = [float(v) for v in np.asarray(want.areas)[:4]]
        if rec["areas_head"] != head or rec["tasks"] != want.metrics.tasks \
                or rec["tasks_per_chip"] != want.metrics.tasks_per_chip:
            raise AssertionError(f"19d {name}: {rec} against {head}")
        out["cli"][name] = dict(wall_s=run["wall_s"], tasks=rec["tasks"])
        log(f"[smoke] 19d family --engine {name} --n-devices 4: bit-equal "
            f"to the in-process call ({rec['tasks']} tasks, CLI wall "
            f"{run['wall_s']:.2f} s)")
    # every rank's launches in the timed runs, the resumed leg, the
    # tests' shapes and the resized resume
    out["launches"] = dd_launches(*runs.values(), got["resume"],
                                  got["test_refill"], got["test_legacy"],
                                  resized["card"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] 19 done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: the tuning search on the card; the wavefront, the 2D bag and the
# QMC lattice across ranks
# ---------------------------------------------------------------------------


class Deadline:
    """Phase 20's one time limit: every launch in it gets what is left."""

    def __init__(self, seconds: float):
        self.end = time.perf_counter() + seconds

    def left(self) -> float:
        left = self.end - time.perf_counter()
        if left <= 0:
            raise TimeoutError(f"phase 20 ran past its {ACROSS_TIMEOUT} s")
        return left


def _strip_device(e: dict) -> dict:
    """A tuning entry without what differs between devices by design."""
    out = {k: v for k, v in e.items() if k != "device_kind"}
    out["provenance"] = {k: v for k, v in e["provenance"].items()
                         if k != "recompiles"}
    return out


def across_tune(W, base, ckpt_dir) -> dict:
    """20a. ``tools/tune_table.py``'s sweep on the card into a scratch
    table, held to the same sweep on the CPU and to the committed rows'
    decisions; the committed table still gives the card the hand tier."""
    from ppls_tpu_torch.runtime import tune
    from ppls_tpu_torch.tools import tune_table
    paths = {d: os.path.join(ckpt_dir, f"tune_{d}.json")
             for d in ("card", "cpu")}
    rec, wall, launches = counted(W, lambda: tune_table.run_sweep(
        paths["card"], TUNE_BUDGET, device=DEVICE))
    t0 = time.perf_counter()
    cpu_rec = tune_table.run_sweep(paths["cpu"], TUNE_BUDGET, device="cpu")
    cpu_wall = time.perf_counter() - t0
    tables = {}
    for d, path in paths.items():
        with open(path, encoding="utf-8") as fh:
            tables[d] = json.load(fh)["entries"]
    with open(tune.DEFAULT_TABLE_PATH, encoding="utf-8") as fh:
        committed = json.load(fh)["entries"]
    out = {"families": {}}
    for fam, _eps, _b in tune.TUNE_WORKLOADS:
        fc = rec["tuning"]["families"][fam]
        key_cpu = cpu_rec["tuning"]["families"][fam]["key"]
        card, cpu = tables["card"][fc["key"]], tables["cpu"][key_cpu]
        com = committed[key_cpu]
        if _strip_device(card) != _strip_device(cpu):
            raise AssertionError(f"20a {fam}: the card's entry differs from "
                                 f"the CPU's: {card} / {cpu}")
        moves = [(t["moved"], t["accepted"]) for t in
                 card["provenance"]["path"]]
        if (card["knobs"] != com["knobs"]
                or moves != [(t["moved"], t["accepted"])
                             for t in com["provenance"]["path"]]
                or any(card["provenance"][k] != com["provenance"][k]
                       for k in ("trials", "improved"))):
            raise AssertionError(f"20a {fam}: the card's decisions differ "
                                 f"from the committed row's")
        same = _strip_device(card) == _strip_device(com)
        out["families"][fam] = dict(
            key=fc["key"], knobs=card["knobs"], baseline=card["baseline"],
            tuned=card["tuned"], tier_after=fc["tier_after"],
            recompiles=card["provenance"]["recompiles"],
            committed_numbers_equal=same)
        log(f"[smoke] 20a {fam}: {card['provenance']['trials']} trials, "
            f"knobs {card['knobs']} (the committed row's), baseline "
            f"{card['baseline']} -> tuned {card['tuned']}; equal to the CPU "
            f"sweep's entry; every number the committed row's: {same}; tier "
            f"after the write {fc['tier_after']}, recompiles "
            f"{card['provenance']['recompiles']}")
    # the committed table has no row for this card: still the hand tier
    tiers = {}
    for fam, eps, _b in ((("flagship", EPS, None),)
                         + tuple(tune.TUNE_WORKLOADS)):
        sig = tune.workload_signature(
            "sin_recip_scaled" if fam == "flagship" else fam, eps,
            "trapezoid", scout=True, refill_slots=REFILL_SLOTS)
        tiers[fam] = tune.resolve_cadence_tuned(
            None, None, True, REFILL_SLOTS, signature=sig,
            device=DEVICE)[2]
    k1 = (base["k1_launches"]["run_segment_rf"], base["k1"].kernel_steps)
    k2 = (base["k2_launches"]["run_segment_ee"], base["k2"].kernel_steps)
    log(f"[smoke] 20a the sweep on the card: {wall:.1f} s, K1 launches "
        f"{launches['run_segment_rf']} (K2 {launches['run_segment_ee']}, K3 "
        f"{launches['run_segment']}); the same sweep on this machine's CPU "
        f"{cpu_wall:.1f} s; the committed table on the card: tiers {tiers}; "
        f"phase 4 K1 {k1}, phase 6 K2 {k2} (launches, kernel steps)")
    if any(t != "default" for t in tiers.values()):
        raise AssertionError(f"20a: the committed table moved a cadence on "
                             f"the card: {tiers}")
    if k1 != K1_MAIN or k2 != K2_MAIN:
        raise AssertionError(f"20a: phases 4/6 moved: {k1}, {k2}")
    if launches["run_segment_rf"] <= 0:
        raise AssertionError("20a: the trials launched no K1")
    out.update(wall_s=wall, cpu_wall_s=cpu_wall, launches=launches,
               tiers=tiers, value=rec["value"])
    return out


def sharded_rec(r) -> dict:
    """What phase 20 prints and keeps of a run across ranks."""
    m = r.metrics
    return dict(area=r.area, tasks=m.tasks, splits=m.splits,
                rounds=m.rounds, tasks_per_chip=m.tasks_per_chip,
                wall_s=m.wall_time_s, host_syncs=getattr(r, "host_syncs", 0),
                mesh=getattr(r, "mesh", None))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def same_counts(what: str, a, b, tol: float, keys=("tasks", "splits",
                                                  "rounds")) -> float:
    """Equal counts (and per-rank tasks when both have as many ranks),
    areas within ``tol`` relative; returns the relative distance."""
    for k in keys:
        if getattr(a.metrics, k) != getattr(b.metrics, k):
            raise AssertionError(f"{what}: {k} {getattr(a.metrics, k)} != "
                                 f"{getattr(b.metrics, k)}")
    d = _rel(a.area, b.area)
    if not d <= tol:
        raise AssertionError(f"{what}: areas {a.area!r} / {b.area!r}")
    return d


def across_world1(W) -> dict:
    """20b. The reference problem and OSC_CONFIG through the wavefront on
    one rank (NCCL, in process), against the host engine; 20d's ring on
    one rank against phase 17's C counts."""
    import torch
    from ppls_tpu_torch.config import OSC_CONFIG, QuadConfig
    from ppls_tpu_torch.parallel import cubature as C2
    from ppls_tpu_torch.parallel.sharded import sharded_integrate
    from ppls_tpu_torch.runtime.host_frontier import integrate
    out, runs = {}, {}
    for name, cfg in (("reference", QuadConfig()), ("osc", OSC_CONFIG)):
        host = integrate(cfg, device=DEVICE)
        sharded_integrate(cfg, n_devices=1, device=DEVICE)     # warm-up
        t0 = time.perf_counter()
        r = sharded_integrate(cfg, n_devices=1, device=DEVICE)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        d = same_counts(f"20b {name} world 1 against the host engine", r,
                        host, SHARDED_TOL)
        if name == "reference" and f"{r.area:.6f}" != REF_PRINTED:
            raise AssertionError(f"20b: {r.area!r}")
        runs[name] = r
        out[name] = dict(sharded_rec(r), call_s=call_s, d_host=d,
                         host_wall_s=host.metrics.wall_time_s)
        log(f"[smoke] 20b {name} on 1 rank ({r.mesh['backend']}): area "
            f"{r.area:.6f}, {r.metrics.tasks} tasks in {r.metrics.rounds} "
            f"rounds (the host engine's; |area - host| / area {d:.3e}, tol "
            f"{SHARDED_TOL:g}); engine wall {r.metrics.wall_time_s:.4f} s "
            f"({call_s:.3f} s around the call), host engine "
            f"{host.metrics.wall_time_s:.4f} s; host syncs {r.host_syncs}; "
            f"collective calls {r.mesh['collective_calls']} (the "
            f"reference's sites: {SHARDED_SITES})")
    ring = C2.integrate_2d_sharded(
        "gauss2d_ring", BOUNDS_2D, RING_EPS, rule=C2.Rule.TRAPEZOID,
        n_devices=1, device=DEVICE, **RING_KW)
    torch.cuda.synchronize()
    out["ring"] = sharded_rec(ring)
    return out, runs


def across_calls(paths: dict, device: str, card: bool) -> dict:
    """Phase 20's calls for one world of ``ACROSS_N`` ranks: the wavefront
    (20c), the 2D bag (20d), the QMC lattice (20e), and on the card the
    kill-and-resume cases and 20f's in-process twins."""
    from ppls_tpu_torch.config import OSC_CONFIG, QuadConfig, Rule
    from ppls_tpu_torch.models.genz import GENZ, genz_params
    from ppls_tpu_torch.models.integrands import get_integrand_2d
    from ppls_tpu_torch.parallel import cubature as C2
    from ppls_tpu_torch.parallel.qmc import integrate_qmc
    from ppls_tpu_torch.parallel.sharded import (resume_sharded,
                                                 sharded_integrate)
    w = dict(n_devices=ACROSS_N, device=device)
    t2 = dict(TEST_2D, rule=Rule.TRAPEZOID, **w)
    calls = {
        "reference": (sharded_integrate, (QuadConfig(),), w),
        "osc": (sharded_integrate, (OSC_CONFIG,), w),
        "ring": (C2.integrate_2d_sharded,
                 ("gauss2d_ring", BOUNDS_2D, RING_PROFILE_EPS),
                 dict(RING_KW, rule=Rule.TRAPEZOID, **w)),
        "peak": (C2.integrate_2d_sharded, ("gauss2d_peak", BOUNDS_2D,
                                           TEST_2D_EPS), t2),
    }
    for name in sorted(GENZ):
        a, u = genz_params(name, QMC_DIM, seed=0)
        calls[f"qmc_cpu_n/{name}"] = (integrate_qmc, (GENZ[name].fn, a, u),
                                      dict(n_points=QMC_CPU_N, **w))
        if card:
            calls[f"qmc/{name}"] = (integrate_qmc, (GENZ[name].fn, a, u),
                                    dict(n_points=QMC_N,
                                         n_shifts=QMC_SHIFTS, **w))
            calls[f"qmc_cli/{name}"] = (integrate_qmc,
                                        (GENZ[name].fn, a, u),
                                        dict(n_points=QMC_CLI_N, **w))
    if not card:
        return calls
    ref = QuadConfig()
    peak = get_integrand_2d("gauss2d_peak")
    calls.update({
        "crash": (sharded_integrate, (ref,),
                  dict(w, checkpoint_path=paths["wave"],
                       checkpoint_every=4, _crash_after_legs=2)),
        "wrong_eps": (resume_sharded, (paths["wave"], ref.replace(eps=1e-4)),
                      w),
        "resume": (resume_sharded, (paths["wave"], ref),
                   dict(w, checkpoint_every=4)),
        "peak_base": (C2.integrate_2d_sharded,
                      ("gauss2d_peak", BOUNDS_2D, TEST_2D_RESUME_EPS), t2),
        "peak_crash": (C2.integrate_2d_sharded,
                       ("gauss2d_peak", BOUNDS_2D, TEST_2D_RESUME_EPS),
                       dict(t2, checkpoint_path=paths["2d"],
                            checkpoint_every=3, _crash_after_legs=2)),
        "peak_resume": (C2.resume_2d_sharded,
                        (paths["2d"], "gauss2d_peak", BOUNDS_2D,
                         TEST_2D_RESUME_EPS), dict(t2, checkpoint_every=3)),
        # the 2d command's defaults (20f)
        "cli_2d": (C2.integrate_2d_sharded, ("gauss2d_peak", BOUNDS_2D, 1e-8),
                   dict(chunk=1 << 12, capacity=1 << 20,
                        exact=peak.exact(*BOUNDS_2D), **w)),
    })
    return calls


def across_cli(W, TS, got, ckpt_dir) -> dict:
    """20f. The three commands, each starting its own world of
    ``ACROSS_N`` ranks, against the in-process calls of 20c-e."""
    from ppls_tpu_torch.models.genz import GENZ
    path = os.path.join(ckpt_dir, "cli_2d.ckpt")
    n = str(ACROSS_N)
    out = {}
    rec, run = cli_json(W, TS, ["--engine", "sharded", "--n-devices", n])
    want = got["reference"]
    if (rec["area"] != want.area or rec["tasks"] != want.metrics.tasks
            or rec["tasks_per_chip"] != want.metrics.tasks_per_chip):
        raise AssertionError(f"20f --engine sharded: {rec}")
    out["sharded"] = dict(wall_s=run["wall_s"], area=rec["area"])
    rec, run = cli_json(W, TS, ["2d", "--n-devices", n, "--checkpoint", path])
    want = got["cli_2d"]
    if (rec["area"] != want.area or rec["tasks"] != want.metrics.tasks
            or os.path.exists(path)):
        raise AssertionError(f"20f 2d --n-devices: {rec}")
    out["2d"] = dict(wall_s=run["wall_s"], area=rec["area"])
    rec, run = cli_json(W, TS, ["qmc", "--n-devices", n])
    for name in sorted(GENZ):
        if rec["families"][name]["value"] != got[f"qmc_cli/{name}"].value:
            raise AssertionError(f"20f qmc --n-devices {name}: {rec}")
    out["qmc"] = dict(wall_s=run["wall_s"])
    log(f"[smoke] 20f --engine sharded, 2d --checkpoint and qmc at "
        f"--n-devices {n}: bit-equal to the in-process calls; CLI walls "
        f"(each starting its ranks) "
        f"{ {k: round(v['wall_s'], 2) for k, v in out.items()} } s")
    return out


def phase_across(W, TS, base, report, ckpt_dir, out_dir) -> dict:
    """20: the tuning search on the card (20a); the single-integral
    wavefront (20b-c), the 2D bag (20d) and the QMC lattice (20e) across
    ranks, and their commands (20f)."""
    import numpy as np
    import torch
    from ppls_tpu_torch.models.genz import GENZ, genz_params
    from ppls_tpu_torch.parallel import mesh as MESH
    from ppls_tpu_torch.parallel.qmc import integrate_qmc
    t_phase = time.perf_counter()
    deadline = Deadline(ACROSS_TIMEOUT)
    out = {"tune": across_tune(W, base, ckpt_dir)}
    before = {k.__name__: k.launches for k in (
        W.run_segment_rf, W.run_segment_ee, W.run_segment)}
    out["world1"], w1_runs = across_world1(W)
    w1 = out["world1"]
    c_ring = report["cubature_2d"]["ring"]["c"]
    if (w1["ring"]["tasks"], w1["ring"]["splits"]) != (c_ring["tasks"],
                                                       c_ring["splits"]):
        raise AssertionError(f"20d: the ring on 1 rank {w1['ring']} against "
                             f"C's {c_ring['tasks']}/{c_ring['splits']}")
    one_card = report["cubature_2d"]["pipeline"]["cells_per_s"]
    ring_rate = w1["ring"]["tasks"] / w1["ring"]["wall_s"]
    log(f"[smoke] 20d the ring (eps {RING_EPS:g}) on 1 rank: "
        f"{w1['ring']['tasks']} cells, {w1['ring']['splits']} splits (C's), "
        f"{w1['ring']['rounds']} rounds, engine wall "
        f"{w1['ring']['wall_s']:.3f} s: {ring_rate / 1e6:.3f} M cells/s "
        f"(phase 17c, one device: {one_card / 1e6:.3f}); host syncs "
        f"{w1['ring']['host_syncs']}")

    paths = {k: os.path.join(ckpt_dir, f"across_{k}.ckpt")
             for k in ("wave", "2d")}
    MESH.LAUNCH_TIMEOUT_S = deadline.left()     # the commands' launches too
    calls = across_calls(paths, DEVICE, True)
    # the CPU twins run last in the same world (gloo carries both), each
    # rank at a CPU world's thread count
    cpu_calls = across_calls(paths, "cpu", False)
    t0 = time.perf_counter()
    res = MESH.launch(MESH.run_calls, ACROSS_N, DEVICE, (
        list(calls.values())
        + [(torch.set_num_threads, (cpu_threads(ACROSS_N),), {})]
        + list(cpu_calls.values()),), timeout=deadline.left())
    w4_wall = time.perf_counter() - t0
    got = dict(zip(calls, res[:len(calls)]))
    cpu = dict(zip(cpu_calls, res[len(calls) + 1:]))
    for k, g in got.items():
        if isinstance(g, Exception) and k not in ("crash", "wrong_eps",
                                                  "peak_crash"):
            raise AssertionError(f"20 world {ACROSS_N} {k}: {g!r}")
    for k, g in cpu.items():
        if isinstance(g, Exception):
            raise AssertionError(f"20 CPU call {k}: {g!r}")
    log(f"[smoke] 20 world {ACROSS_N} on one card (gloo, host-staged: not a "
        f"multi-GPU rate): {len(calls)} card calls and {len(cpu_calls)} CPU "
        f"calls in {w4_wall:.1f} s, their start included")

    # c. the wavefront on 4 ranks: against world 1, the CPU, and resumed
    out["world4"] = {}
    for name in ("reference", "osc"):
        r = got[name]
        d1 = same_counts(f"20c {name}: 4 ranks against 1", r,
                         w1_runs[name], SHARDED_TOL)
        dc = same_counts(f"20c {name}: card against CPU", r, cpu[name],
                         SHARDED_TOL, keys=("tasks", "splits", "rounds",
                                            "tasks_per_chip"))
        out["world4"][name] = dict(sharded_rec(r), d_world1=d1, d_cpu=dc)
        log(f"[smoke] 20c {name} on {ACROSS_N} ranks: area {r.area:.6f}, "
            f"{r.metrics.tasks} tasks in {r.metrics.rounds} rounds, per rank "
            f"{r.metrics.tasks_per_chip}; engine wall "
            f"{r.metrics.wall_time_s:.4f} s (1 rank "
            f"{w1[name]['wall_s']:.4f}); host syncs {r.host_syncs}; "
            f"collective calls {r.mesh['collective_calls']} ({SHARDED_SITES}"
            f" in the reference); |4 ranks - 1| / area {d1:.3e}, |card - "
            f"CPU| / area {dc:.3e}")
    if not isinstance(got["crash"], RuntimeError) \
            or not isinstance(got["wrong_eps"], ValueError):
        raise AssertionError(f"20c: {got['crash']!r} / {got['wrong_eps']!r}")
    res, base4 = got["resume"], got["reference"]
    if (res.area != base4.area
            or res.metrics.tasks_per_chip != base4.metrics.tasks_per_chip
            or os.path.exists(paths["wave"])):
        raise AssertionError("20c: the resumed wavefront differs")
    log("[smoke] 20c kill-and-resume on 4 ranks bit-equal; a snapshot of "
        "another eps refused")

    # d. the 2D bag on 4 ranks: card against CPU, and resumed
    out["2d"] = {"ring_world1": w1["ring"]}
    for name in ("ring", "peak"):
        d = same_counts(f"20d {name}: card against CPU", got[name],
                        cpu[name], AREA_TOL_2D,
                        keys=("tasks", "splits", "rounds", "tasks_per_chip"))
        out["2d"][name] = dict(sharded_rec(got[name]), d_cpu=d)
        r = got[name]
        log(f"[smoke] 20d {name} on {ACROSS_N} ranks: {r.metrics.tasks} "
            f"cells ({r.metrics.splits} splits) in {r.metrics.rounds} "
            f"rounds, per rank {r.metrics.tasks_per_chip}, engine wall "
            f"{r.metrics.wall_time_s:.3f} s "
            f"({r.metrics.tasks / r.metrics.wall_time_s / 1e6:.3f} M "
            f"cells/s); card = CPU (|area| rel {d:.3e})")
    res, b2 = got["peak_resume"], got["peak_base"]
    if (not isinstance(got["peak_crash"], RuntimeError)
            or res.area != b2.area
            or res.metrics.tasks_per_chip != b2.metrics.tasks_per_chip
            or os.path.exists(paths["2d"])):
        raise AssertionError("20d: the resumed 2D run differs")
    log("[smoke] 20d kill-and-resume on 4 ranks bit-equal")

    # e. the QMC lattice on 1 and 4 ranks, against phase 18 and the CPU
    out["qmc"] = {}
    t1 = t4 = 0.0
    for name in sorted(GENZ):
        a, u = genz_params(name, QMC_DIM, seed=0)
        kw = dict(n_points=QMC_N, n_shifts=QMC_SHIFTS, device=DEVICE)
        one = integrate_qmc(GENZ[name].fn, a, u, **kw)       # phase 18's
        r1 = integrate_qmc(GENZ[name].fn, a, u, n_devices=1, **kw)
        r4 = got[f"qmc/{name}"]
        t1 += r1.metrics.wall_time_s
        t4 += r4.metrics.wall_time_s
        rel = float(np.max(np.abs(r4.estimates - one.estimates)
                           / np.abs(one.estimates)))
        rc = float(np.max(np.abs(got[f"qmc_cpu_n/{name}"].estimates
                                 - cpu[f"qmc_cpu_n/{name}"].estimates)
                          / np.abs(cpu[f"qmc_cpu_n/{name}"].estimates)))
        if (not np.array_equal(r1.estimates, one.estimates)
                or not rel <= QMC_CPU_REL or not rc <= QMC_CPU_REL):
            raise AssertionError(f"20e {name}: {rel:.3e} / {rc:.3e}")
        out["qmc"][name] = dict(rel_world1=rel, rel_cpu=rc,
                                wall4_s=r4.metrics.wall_time_s,
                                wall1_s=r1.metrics.wall_time_s)
    pts = 6 * QMC_N * QMC_SHIFTS
    out["qmc_rates"] = dict(world1=pts / t1, world4=pts / t4)
    log(f"[smoke] 20e six Genz families at N = 2^22: 4 ranks within "
        f"{max(v['rel_world1'] for v in out['qmc'].values()):.3e} relative "
        f"of one card (world 1 bit-equal to phase 18); card = CPU at N = "
        f"2^16 on 4 ranks; points/s (each rank's own wall, rank 0's): 1 "
        f"rank {pts / t1 / 1e6:.1f} M, {ACROSS_N} ranks on one card "
        f"{pts / t4 / 1e6:.1f} M")
    for k in (W.run_segment_rf, W.run_segment_ee, W.run_segment):
        if k.launches != before[k.__name__]:
            raise AssertionError(f"phase 20b-e launched {k.__name__}")
    out["cli"] = across_cli(W, TS, got, ckpt_dir)
    deadline.left()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] 20 done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: the walker-dd stream across ranks
# ---------------------------------------------------------------------------


def dd_stream_surface(path) -> tuple:
    """The deterministic surface of a dd stream's events file: retire
    records without the wall latency, phase spans, per-rank chip spans
    (tests/test_torch_dd_stream.py's)."""
    retires, phases, chips = [], [], []
    with open(path, encoding="utf-8") as fh:
        for ln in fh:
            r = json.loads(ln)
            if r["ev"] == "event" and r.get("name") == "retire":
                a = dict(r["attrs"])
                a.pop("latency_s", None)
                retires.append(a)
            elif r["ev"] == "span_close":
                a = r.get("attrs") or {}
                if "wsteps" in a and "live_rows" in a:
                    chips.append(a)
                elif a.get("tasks") is not None:
                    phases.append(a)
    return sorted(retires, key=lambda a: a["rid"]), phases, chips


def dd_stream_drive(eng, reqs, arrivals, copy_at=None, copy_to=None):
    """Submit ``reqs`` on their arrival phases and run phases until every
    request retired; with ``copy_at`` the snapshot written at the close
    of that phase (what a kill right after it leaves) is copied to
    ``copy_to``."""
    k = eng.next_rid
    while not eng.idle or k < len(reqs):
        while k < len(reqs) and arrivals[k] <= eng.phase:
            eng.submit(*reqs[k])
            k += 1
        eng.step()
        if copy_at is not None and eng.phase == copy_at:
            shutil.copy(eng.checkpoint_path, copy_to)
    return eng.result()


def dd_stream_launches(res) -> list:
    """K1 launches per rank of one dd stream run (every rank must have
    launched; K2 never runs on this path)."""
    m = res.mesh
    if min(m["launches"]["run_segment_rf"]) <= 0 \
            or max(m["launches"]["run_segment_ee"]) != 0:
        raise AssertionError(f"21: launches per rank {m['launches']}")
    return m["launches"]["run_segment_rf"]


def dd_stream_leg(what, res, exact, wall_s) -> dict:
    """One full-width dd stream run, checked and logged: every request
    retired, within the closed form's tolerance; requests/s, latency,
    host syncs and collective calls per phase, K1 launches per rank."""
    import numpy as np
    m = res.mesh
    if len(res.completed) != len(exact) or any(c.failed
                                              for c in res.completed):
        raise AssertionError(f"{what}: {len(res.completed)} of "
                             f"{len(exact)} requests retired")
    d_ex = float(np.max(np.abs(res.areas - exact)))
    if not d_ex < AREA_TOL_EXACT:
        raise AssertionError(f"{what}: {d_ex:.3e} from the closed form")
    launches = dd_stream_launches(res)
    ph = max(res.phases, 1)
    lat = res.latency_percentiles()
    rec = dict(wall_s=wall_s, requests_per_sec=len(exact) / wall_s,
               phases=res.phases, latency=lat, d_exact=d_ex,
               tasks=res.totals["tasks"], launches_per_rank=launches,
               host_syncs_per_rank=m["host_syncs"],
               host_syncs_per_phase=res.host_syncs / ph,
               collective_calls_per_phase={
                   k: sum(v) / len(v) / ph
                   for k, v in m["collective_calls"].items()},
               transport=dict(backend=m["backend"],
                              host_staged=m["host_staged"]),
               crounds=res.totals["crounds"])
    log(f"[smoke] {what}: {rec['requests_per_sec']:.2f} req/s (wall "
        f"{wall_s:.3f} s), {res.phases} phases, p50/p99 latency "
        f"{lat['p50_phases']}/{lat['p99_phases']} phases "
        f"({lat['p50_s']:.4f}/{lat['p99_s']:.4f} s), {rec['tasks']} tasks, "
        f"{res.totals['crounds']} collective rounds; host syncs per phase "
        f"(rank 0) {rec['host_syncs_per_phase']:.2f}, per rank "
        f"{m['host_syncs']}; collective calls per phase and rank "
        f"{ {k: round(v, 2) for k, v in rec['collective_calls_per_phase'].items()} }; "
        f"K1 launches per rank {launches}; transport {m['backend']}"
        f"{' staged through host memory' if m['host_staged'] else ''}; "
        f"max |area - closed form| {d_ex:.3e}")
    return rec


def phase_dd_stream(W, TS, ckpt_dir, out_dir, ops) -> dict:
    """21: the walker-dd stream (module docstring). Every spawned world is
    bounded by ``DD_STREAM_TIMEOUT`` (a rank that hangs fails its
    command), and so is the phase."""
    import numpy as np
    import torch
    from ppls_tpu_torch.models.integrands import (family_exact, get_family,
                                                  get_family_ds)
    from ppls_tpu_torch.obs.telemetry import Telemetry
    from ppls_tpu_torch.parallel import mesh as MESH
    from ppls_tpu_torch.parallel.bag_engine import integrate_family
    MESH.WORLD_TIMEOUT_S = DD_STREAM_TIMEOUT
    t_phase = time.perf_counter()

    def check_time(step):
        spent = time.perf_counter() - t_phase
        if spent > DD_STREAM_TIMEOUT:
            raise TimeoutError(f"phase 21 ran past its {DD_STREAM_TIMEOUT} "
                               f"s at {step} ({spent:.0f} s)")

    k = STREAM_K
    theta = 1.0 + np.arange(k) / k
    reqs = [(float(t), BOUNDS) for t in theta]
    exact = family_exact(STREAM_FAMILY, *BOUNDS, theta)
    ekw = dict(STREAM_KW, engine="walker-dd", device=DEVICE)
    out = {"legs": {}, "launches": {}}

    # k. K1 bit-equal to its plain segment at a dd-stream rank's bank
    f_theta, f_ds = get_family(STREAM_FAMILY), get_family_ds(STREAM_FAMILY)
    base = W.first_phase_inputs(
        f_theta, theta, BOUNDS, EPS, refill_slots=STREAM_KW["refill_slots"],
        scout=True, lanes=STREAM_KW["lanes"], roots_per_lane=ROOTS_PER_LANE,
        capacity=STREAM_KW["capacity"], device="cuda")
    out["k1"], times = cmp_k1(W, "K1 step_scout (dd stream)", base, f_ds,
                              EPS, "step_scout", ops, cap=LATE_CMP_CAP)
    log(fmt_cmp(f"K1 step_scout at a dd-stream rank's bank ({k} requests, "
                f"{STREAM_KW['lanes']} lanes, R {STREAM_KW['refill_slots']})",
                out["k1"], times))

    # a. world 1 (NCCL, in this process): a warm-up, the timed run, the
    # ds-walk leg against the float64 bag, one profiled run
    def world(n, **over):
        return TS.StreamEngine(STREAM_FAMILY, EPS, n_devices=n,
                               **dict(ekw, **over))

    def timed_run(eng):
        """A run of the K requests on ``eng``, which may have run before
        (a warm engine: its ranks started, its kernels loaded): this
        run's own requests, phases, counters and per-rank mesh counts,
        as a ``StreamResult``, and its wall."""
        a = eng.result()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b = eng.result()

        def minus(x, y):
            if isinstance(x, dict):
                return {k: minus(v, (y or {}).get(k)) for k, v in x.items()}
            if isinstance(x, list):
                return [u - v for u, v in zip(x, y or [0] * len(x))]
            return x
        return TS.StreamResult(
            completed=b.completed[len(a.completed):],
            phases=b.phases - a.phases, wall_s=wall,
            totals={k: b.totals[k] - a.totals[k] for k in b.totals},
            phase_stats=None, host_syncs=b.host_syncs - a.host_syncs,
            mesh=dict(b.mesh, **minus(
                {k: b.mesh[k] for k in ("host_syncs", "collective_calls",
                                        "launches")}, a.mesh))), wall

    eng1 = world(1)
    try:
        timed_run(eng1)                       # warm-up
        res1, wall1 = timed_run(eng1)
        out["legs"]["1"] = dd_stream_leg("21a dd stream, world 1 (NCCL)",
                                         res1, exact, wall1)
        out["profile"] = profile_fn(lambda: timed_run(eng1),
                                    "walk_rf_kernel", out_dir,
                                    "dd_stream_world1")
        out["launches"]["1"] = sum(
            eng1.result().mesh["launches"]["run_segment_rf"])
    finally:
        eng1.close()
    sample = np.arange(0, k, DD_STREAM_SAMPLE)
    bag = integrate_family(f_theta, theta[sample], BOUNDS, EPS,
                           chunk=1 << 15, capacity=1 << 22,
                           device=DEVICE).areas
    with world(1, scout_dtype="f64") as eng:
        t0 = time.perf_counter()
        res_ds = eng.run(reqs)
        torch.cuda.synchronize()
        wall_ds = time.perf_counter() - t0
    d_bag = float(np.max(np.abs(res_ds.areas[sample] - bag)))
    out["ds"] = dict(wall_s=wall_ds, d_bag=d_bag, phases=res_ds.phases,
                     launches=dd_stream_launches(res_ds))
    out["launches"]["1_ds"] = sum(out["ds"]["launches"])
    log(f"[smoke] 21a ds walk (scouting off), world 1: every "
        f"{DD_STREAM_SAMPLE}th area {d_bag:.3e} from the float64 bag (tol "
        f"{AREA_TOL_BAG}), {res_ds.phases} phases, wall {wall_ds:.3f} s")
    if not d_bag < AREA_TOL_BAG:
        raise AssertionError(f"21a ds walk: {d_bag:.3e} from the bag")
    check_time("21a")

    # b. world 4 on the one card (gloo, host-staged): the same gates, the
    # world started by a warm-up run
    t0 = time.perf_counter()
    eng4 = world(4)
    try:
        timed_run(eng4)                       # warm-up, the ranks' start
        start4 = time.perf_counter() - t0
        res4, wall4 = timed_run(eng4)
        out["legs"]["4"] = dd_stream_leg(
            "21b dd stream, world 4 on one card (gloo; not a multi-GPU "
            "rate)", res4, exact, wall4)
        out["legs"]["4"]["start_and_warm_up_s"] = start4
        out["launches"]["4"] = sum(
            eng4.result().mesh["launches"]["run_segment_rf"])
    finally:
        eng4.close()
    log(f"[smoke] 21b world 4: its start and warm-up run {start4:.1f} s")
    check_time("21b full width")

    # b/c. at the tests' size: card against CPU, 4 ranks each (the card's
    # run snapshots every phase; its phase-3 snapshot is what a kill
    # after phase 3 leaves), then the resumes
    test_kw = dict(DD_STREAM_TEST_KW, engine="walker-dd",
                   **dd_cadence(W, DD_STREAM_TEST_KW))
    t_reqs = [(float(t), DD_STREAM_TEST_BOUNDS)
              for t in 1.0 + np.arange(6) / 6.0]
    paths = {name: os.path.join(ckpt_dir, f"dds_{name}")
             for name in ("card.ckpt", "card3.ckpt", "card3_resize.ckpt",
                          "card.jsonl", "cpu.jsonl", "resumed.jsonl",
                          "dya.jsonl")}

    def events_run(fam, n, dev, events, reqs_, **over):
        tel = Telemetry(events_path=events)
        try:
            with TS.StreamEngine(fam, DD_STREAM_TEST_EPS, n_devices=n,
                                 device=dev, telemetry=tel,
                                 **dict(test_kw, **over)) as eng:
                ck = over.get("checkpoint_path")
                res = dd_stream_drive(eng, reqs_, DD_STREAM_TEST_ARR,
                                      3 if ck else None,
                                      ck and ck.replace(".ckpt", "3.ckpt"))
        finally:
            tel.close()
        return res, dd_stream_surface(events)

    # the card's world and the CPU's start and run side by side
    (card, card_s), (cpu, cpu_s) = concurrently(
        lambda: events_run(STREAM_FAMILY, 4, DEVICE, paths["card.jsonl"],
                           t_reqs, checkpoint_path=paths["card.ckpt"],
                           checkpoint_every=1),
        lambda: events_run(STREAM_FAMILY, 4, "cpu", paths["cpu.jsonl"],
                           t_reqs))
    d_cc = float(np.max(np.abs(card.areas - cpu.areas)))
    same = (card_s[2] == cpu_s[2] and np.array_equal(card.phase_stats,
                                                     cpu.phase_stats)
            and [(r["rid"], r["retire_phase"]) for r in card_s[0]]
            == [(r["rid"], r["retire_phase"]) for r in cpu_s[0]])
    log(f"[smoke] 21b card against CPU, 4 ranks, the tests' size: "
        f"{card.phases} phases, retire phases, phase rows and "
        f"{len(card_s[2])} chip spans {'equal' if same else 'DIFFER'}, "
        f"areas {d_cc:.3e} apart (tol {AREA_TOL_DEVICES})")
    if not same or not d_cc <= AREA_TOL_DEVICES:
        raise AssertionError("21b: card and CPU differ")
    out["card_cpu"] = dict(d_areas=d_cc, phases=card.phases,
                           chip_spans=len(card_s[2]),
                           launches=dd_stream_launches(card))
    out["launches"]["card_cpu"] = sum(out["card_cpu"]["launches"])
    check_time("21b card = CPU")

    # c. kill-and-resume at world 4; resize 4 -> 3 (the ds walk). Beside
    # the resume, the dyadic family's undisturbed run, 21d's comparator,
    # on one CPU rank in this process: its areas are exact dyadic sums,
    # the same bits at every world size and on either device. (Card
    # engines never run side by side here: a rank 0 counts its launches
    # on this process's counters.)
    shutil.copy(paths["card3.ckpt"], paths["card3_resize.ckpt"])

    def resume4():
        tel = Telemetry(events_path=paths["resumed.jsonl"])
        try:
            with TS.StreamEngine.resume(
                    paths["card3.ckpt"], STREAM_FAMILY, DD_STREAM_TEST_EPS,
                    n_devices=4, device=DEVICE, telemetry=tel,
                    checkpoint_every=1, **test_kw) as eng:
                return dd_stream_drive(eng, t_reqs, DD_STREAM_TEST_ARR)
        finally:
            tel.close()

    dya_reqs = [(t, (0.0, 1.0)) for t in DD_STREAM_DYADIC]
    resumed, (dya, _s) = concurrently(
        resume4, lambda: events_run("quad_scaled", 1, "cpu",
                                    paths["dya.jsonl"], dya_reqs))
    r_s = dd_stream_surface(paths["resumed.jsonl"])
    n3 = 3 * 4                              # the first 3 phases' chip spans
    same = (np.array_equal(resumed.areas, card.areas)
            and r_s[1] == card_s[1][3:] and r_s[2] == card_s[2][n3:]
            and [r for r in card_s[0] if r["retire_phase"] >= 3] == r_s[0])
    log(f"[smoke] 21c kill after phase 3 and resume on 4 ranks: areas, "
        f"phase spans, chip spans and retire records "
        f"{'bit-equal' if same else 'DIFFER'} to the run without a crash")
    if not same:
        raise AssertionError("21c: the resumed run differs")
    with TS.StreamEngine.resume(
            paths["card3_resize.ckpt"], STREAM_FAMILY, DD_STREAM_TEST_EPS,
            mesh_resize=True, n_devices=3, device=DEVICE,
            checkpoint_every=1, **test_kw) as eng:
        ds3 = dd_stream_drive(eng, t_reqs, DD_STREAM_TEST_ARR)
    d_ds3 = float(np.max(np.abs(ds3.areas - card.areas)))
    log(f"[smoke] 21c resize 4 -> 3 ranks: the ds walk {d_ds3:.3e} from "
        f"the 4-rank run (tol {DD_STREAM_RESIZE_TOL}); the dyadic family's "
        f"resize is 21d's")
    if not d_ds3 < DD_STREAM_RESIZE_TOL:
        raise AssertionError("21c: the resized resume differs")
    out["resume"] = dict(d_resize_ds=d_ds3)
    out["launches"]["resume"] = sum(
        sum(dd_stream_launches(r)) for r in (resumed, ds3))
    check_time("21c")

    # d. serve --engine walker-dd --n-devices 4 --supervise, a chip loss at
    # phase 3, on the dyadic family: resize-resumed onto 3 ranks
    ck = os.path.join(ckpt_dir, "dds_serve.ckpt")
    argv = (["serve", "--engine", "walker-dd", "--n-devices", "4",
             "--supervise", "--family", "quad_scaled", "--eps",
             str(DD_STREAM_TEST_EPS), "-a", "0", "-b", "1", "--theta",
             ",".join(str(t) for t in DD_STREAM_DYADIC), "--arrival-rate",
             str(DD_STREAM_SERVE_RATE), "--seed", "0", "--checkpoint", ck,
             "--checkpoint-every", "1", "--fault-plan",
             json.dumps([{"kind": "chip_loss", "at": 3}]),
             "--device", DEVICE]
            + [f for key in ("slots", "chunk", "capacity", "lanes",
                             "refill_slots")
               for f in (f"--{key.replace('_', '-')}",
                         str(DD_STREAM_TEST_KW[key]))])
    run = run_cli(W, TS, argv)
    summ = run["summary"]
    got = ledger(run)
    want = {c.rid: c.area for c in dya.completed}
    lost = sorted(set(want) - set(got))
    rec_ok = all(got[r]["area"] == a for r, a in want.items() if r in got)
    recov = [(r["kind"], r["action"]) for r in summ.get("recoveries", [])]
    log(f"[smoke] 21d serve --engine walker-dd --n-devices 4 --supervise, "
        f"chip_loss at phase 3: recoveries {recov}, world after "
        f"{summ['mesh']['world']}, {summ['completed']} completed, lost "
        f"acknowledged requests {lost}, records "
        f"{'equal' if rec_ok else 'DIFFER from'} the undisturbed engine's "
        f"(wall {run['wall_s']:.2f} s)")
    if recov != [("chip_loss", "resize_resume")] or lost or not rec_ok \
            or summ["mesh"]["world"] != 3:
        raise AssertionError(f"21d: {summ}")
    out["serve"] = dict(recoveries=recov, lost=lost, wall_s=run["wall_s"],
                        launches=summ["mesh"]["launches"],
                        completed=summ["completed"])
    out["launches"]["serve"] = sum(
        summ["mesh"]["launches"]["run_segment_rf"])
    check_time("21d")

    # e. deadline expiry on the dd stream (world 1 on the card)
    dl_kw = dict(n_devices=1, device=DEVICE, **test_kw)
    with TS.StreamEngine(STREAM_FAMILY, DD_STREAM_TEST_EPS, **dl_kw) as eng:
        eng.submit(1.0, DD_STREAM_TEST_BOUNDS, deadline_phases=1)
        eng.submit(1.9, DD_STREAM_TEST_BOUNDS)
        done = {c.rid: c for c in eng.drain()}
        eng.submit(1.5, DD_STREAM_TEST_BOUNDS)
        fresh = eng.drain()[0]
        dl_l = sum(dd_stream_launches(eng.result()))
    with TS.StreamEngine(STREAM_FAMILY, DD_STREAM_TEST_EPS, **dl_kw) as eng:
        solo = eng.run([(1.5, DD_STREAM_TEST_BOUNDS)])
    dl_bag = integrate_family(f_theta, [1.9], DD_STREAM_TEST_BOUNDS,
                              DD_STREAM_TEST_EPS, chunk=1 << 10,
                              capacity=1 << 17, device=DEVICE).areas[0]
    ok = (done[0].failure == "deadline_exceeded"
          and np.isfinite(done[1].area)
          and abs(done[1].area - dl_bag) < AREA_TOL_BAG
          and fresh.area == solo.completed[0].area)
    log(f"[smoke] 21e deadline expiry: rid 0 {done[0].failure}, rid 1 "
        f"{abs(done[1].area - dl_bag):.3e} from the float64 bag, a fresh "
        f"request {'bit-equal' if fresh.area == solo.completed[0].area else 'NOT equal'} "
        f"to a solo run")
    if not ok:
        raise AssertionError("21e: deadline expiry")
    out["launches"]["deadline"] = dl_l + sum(dd_stream_launches(solo))
    out["seconds"] = time.perf_counter() - t_phase
    check_time("21e")
    log(f"[smoke] 21 done in {out['seconds']:.1f} s; K1 launches (every "
        f"rank) {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 22: the pool dispatcher
# ---------------------------------------------------------------------------


def pool_key(eng) -> str:
    """A pooled stream engine's key string."""
    import math
    from ppls_tpu_torch.runtime.dispatch import EngineKey
    return str(EngineKey(round(math.log10(eng.eps)), eng.rule.value,
                         eng._theta_block))


@contextlib.contextmanager
def engine_launches(W, TS):
    """K1 and K2 launches per pooled engine key while entered: the
    launches inside each engine's ``step_begin`` and ``step_finish``."""
    counts = {}
    orig = {name: getattr(TS.StreamEngine, name)
            for name in ("step_begin", "step_finish")}

    def wrap(fn):
        def step_half(eng, *args):
            n0 = (W.run_segment_rf.launches, W.run_segment_ee.launches)
            try:
                return fn(eng, *args)
            finally:
                c = counts.setdefault(pool_key(eng), [0, 0])
                c[0] += W.run_segment_rf.launches - n0[0]
                c[1] += W.run_segment_ee.launches - n0[1]
        return step_half

    for name, fn in orig.items():
        setattr(TS.StreamEngine, name, wrap(fn))
    try:
        yield counts
    finally:
        for name, fn in orig.items():
            setattr(TS.StreamEngine, name, fn)


def timed_parks(disp) -> dict:
    """Wrap ``disp``'s park and unpark: the host seconds of each, after a
    synchronise."""
    import torch
    walls = {"park": [], "unpark": []}
    for name in walls:
        fn = getattr(disp, f"_{name}")

        def timed_call(keystr, fn=fn, name=name):
            t0 = time.perf_counter()
            try:
                return fn(keystr)
            finally:
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
        setattr(disp, f"_{name}", timed_call)
    return walls


def pool_requests(shapes, k: int, bounds, per_key: bool):
    """Mixed-shape (theta, bounds, kwargs) requests: ``k`` in all cycling
    over ``shapes`` (the hetero leg, thetas 1 + i / k), or ``k`` per
    shape, interleaved (22b, thetas 1 + i / k for every key)."""
    reqs = []
    n = k * len(shapes) if per_key else k
    for j in range(n):
        shape = shapes[j % len(shapes)]
        i = j // len(shapes) if per_key else j
        b = int(shape.get("batch", 1))
        th = (tuple(1.0 + (i + q / (2.0 if per_key else 8.0)) / k
                    for q in range(b)) if b > 1 else 1.0 + i / k)
        kw = {"eps": shape["eps"]}
        if "rule" in shape:
            kw["rule"] = shape["rule"]
        reqs.append((th, bounds, kw))
    return reqs


def pool_record(disp, res) -> dict:
    """The schedule-defined surface of one pool run: turns, per-request
    turns, per-engine state and counts, parks, the lease ledger."""
    ls = disp.lease_summary()
    return dict(
        turns=res.phases,
        requests=sorted((c.rid, c.submit_phase, c.admit_phase,
                         c.retire_phase) for c in res.completed),
        engines={k: {f: v[f] for f in ("state", "phases", "completed",
                                       "routed", "lease_donated",
                                       "lease_received")}
                 for k, v in disp.engines_summary().items()},
        parks=sum(c.value for _, c in disp._c_park.items()),
        ledger={k: ls[k] for k in ("donated", "received", "balanced",
                                   "by_donor", "by_borrower", "boundaries",
                                   "overlapped")})


def pool_areas(res):
    """Every request's areas in rid order, flat (a theta pair gives
    two)."""
    import numpy as np
    out = []
    for c in sorted(res.completed, key=lambda c: c.rid):
        out.extend(c.areas if c.areas is not None else [c.area])
    return np.asarray(out)


def hetero_serialized(TS, device: str, ekw: dict) -> tuple:
    """The reference bench's serialized baseline: each key's requests on
    its own engine, run to completion one key after another. Returns
    (summed phases, areas by rid)."""
    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.runtime.dispatch import EngineKey, canonical_key
    reqs = pool_requests(HETERO_SHAPES, HETERO_K, HETERO_BOUNDS, False)
    groups = {}
    for rid, (theta, bounds, kw) in enumerate(reqs):
        key = str(canonical_key(kw["eps"], kw.get("rule", "trapezoid"),
                                theta))
        groups.setdefault(key, []).append((rid, theta, bounds))
    phases, areas = 0, {}
    for keystr in sorted(groups):
        key = EngineKey.parse(keystr)
        eng = TS.StreamEngine(HETERO_FAMILY, key.eps, slots=HETERO_SLOTS,
                              rule=Rule(key.rule),
                              theta_block=key.theta_block, device=device,
                              **ekw)
        r = eng.run([(th, b) for _, th, b in groups[keystr]])
        for (rid, _, _), c in zip(groups[keystr],
                                  sorted(r.completed, key=lambda c: c.rid)):
            areas[rid] = c.area
        phases += r.phases
    return phases, areas


def dispatch_hetero(W, TS) -> dict:
    """22a: the reference bench's hetero leg at its own configuration on
    the card and on the CPU: the pins, card = CPU, no library built."""
    import numpy as np
    from ppls_tpu_torch.runtime.dispatch import EngineDispatcher
    from ppls_tpu_torch.utils import cuda_build
    reqs = pool_requests(HETERO_SHAPES, HETERO_K, HETERO_BOUNDS, False)
    arr = stream_sweep_arrivals(HETERO_RATE, HETERO_K, HETERO_SEED)
    ekw = dict(HETERO_EKW, **dd_cadence(W, HETERO_EKW))
    out = {"launches": {"run_segment_rf": 0, "run_segment_ee": 0}}
    builds0 = cuda_build.builds_done()
    runs = {}
    for tag, over in (("off", {}),
                      ("lease", dict(lease=True, overlap_boundaries=True))):
        for where, dev in (("card", DEVICE), ("cpu", "cpu")):
            disp = EngineDispatcher(HETERO_FAMILY, slots=HETERO_SLOTS,
                                    max_engines=HETERO_MAX_ENGINES,
                                    device=dev, engine_kw=ekw, **over)
            if where == "card":
                res, wall, l = counted(
                    W, lambda: disp.run(reqs, arrival_phase=arr))
                for k in out["launches"]:
                    out["launches"][k] += l[k]
            else:
                res = disp.run(reqs, arrival_phase=arr)
            runs[tag, where] = (disp, res)
            if disp.recompiles() != 0 or len(res.completed) != HETERO_K:
                raise AssertionError(f"22a {tag} on {where}: "
                                     f"{disp.recompiles()} recompiles")
    (ser_card, a_card), wall_s, l = counted(
        W, lambda: hetero_serialized(TS, DEVICE, ekw))
    for k in out["launches"]:
        out["launches"][k] += l[k]
    ser_cpu, a_cpu = hetero_serialized(TS, "cpu", ekw)
    for tag in ("off", "lease"):
        (dc, rc), (dp, rp) = runs[tag, "card"], runs[tag, "cpu"]
        same = pool_record(dc, rc) == pool_record(dp, rp)
        d = float(np.max(np.abs(pool_areas(rc) - pool_areas(rp))))
        lat = [c.retire_phase - c.submit_phase for c in rc.completed]
        rec = pool_record(dc, rc)
        out[tag] = dict(turns=rc.phases, mean_latency_turns=float(
            np.mean(lat)), ledger=rec["ledger"], d_card_cpu=d,
            card_equals_cpu=same, wall_s=rc.wall_s)
        log(f"[smoke] 22a hetero leg, {tag}: {rc.phases} turns (pinned "
            f"{HETERO_TURNS[tag]}), mean latency {np.mean(lat):.3f} turns, "
            f"lease ledger donated {rec['ledger']['donated']} / received "
            f"{rec['ledger']['received']}, boundaries "
            f"{rec['ledger']['boundaries']} ({rec['ledger']['overlapped']} "
            f"overlapped); card against CPU: turns, per-engine phases and "
            f"ledger {'equal' if same else 'DIFFER'}, areas {d:.3e} apart "
            f"(tol {AREA_TOL_DEVICES}); wall {rc.wall_s:.3f} s")
        if not same or not d < AREA_TOL_DEVICES \
                or rc.phases != HETERO_TURNS[tag]:
            raise AssertionError(f"22a {tag}: {out[tag]}")
    gain = out["off"]["mean_latency_turns"] / out["lease"][
        "mean_latency_turns"]
    d_ser = max(abs(a_card[r] - a_cpu[r]) for r in a_card)
    out["serialized"] = dict(phases=ser_card, d_card_cpu=d_ser,
                             turns_speedup=ser_card / out["lease"]["turns"])
    log(f"[smoke] 22a serialized baseline: {ser_card} phases (CPU "
        f"{ser_cpu}; areas {d_ser:.3e} apart), pool speedup in turns "
        f"{ser_card / out['lease']['turns']:.2f}x (lease) / "
        f"{ser_card / out['off']['turns']:.2f}x (off); lease mean-latency "
        f"gain {gain:.2f}x (>= 1.2); libraries built "
        f"{cuda_build.builds_done() - builds0}; launches {out['launches']}")
    lease = out["lease"]["ledger"]
    if (ser_card != ser_cpu or not d_ser < AREA_TOL_DEVICES or gain < 1.2
            or not lease["donated"] == lease["received"] >= 1
            or lease["overlapped"] < 1
            or cuda_build.builds_done() != builds0
            or out["launches"]["run_segment_rf"] <= 0):
        raise AssertionError(f"22a: {out}")
    return out


def pool_run(W, TS, reqs, arr, ekw, cap, over, events=None):
    """One full-width pool run on the card: (dispatcher, result, host
    wall, launches, per-engine launches, park/unpark seconds)."""
    from ppls_tpu_torch.obs.telemetry import Telemetry
    from ppls_tpu_torch.runtime.dispatch import EngineDispatcher
    tel = Telemetry(events_path=events) if events else None
    disp = EngineDispatcher(STREAM_FAMILY, slots=POOL_SLOTS, max_engines=cap,
                            device=DEVICE, engine_kw=ekw, telemetry=tel,
                            **over)
    walls = timed_parks(disp)
    try:
        with engine_launches(W, TS) as per_engine:
            res, wall, launches = counted(
                W, lambda: disp.run(reqs, arrival_phase=arr))
    finally:
        disp.close()
        if tel is not None:
            tel.close()
    return disp, res, wall, launches, per_engine, walls


def pool_leg(W, TS, what, keys, ekw, counter, exact, bag, s_bag, out_dir,
             ckpt_dir, profile) -> dict:
    """22b at one refill mode: the pool over ``keys`` saturated and open
    loop, uncapped and capped, lease off, lease and overlap, lease with
    serialized boundaries; every gate of the module docstring."""
    import json as _json
    import numpy as np
    from ppls_tpu_torch.utils import cuda_build
    reqs = pool_requests(keys, POOL_K, BOUNDS, True)
    n = len(reqs)
    arrivals = {"saturated": None,
                "open": stream_sweep_arrivals(POOL_RATE, n,
                                              STREAM_SWEEP_SEED)}
    caps = (len(keys),) + tuple(c for c in POOL_CAPS if c < len(keys))
    builds0 = cuda_build.builds_done()
    out = {"runs": {}, "launches": {"run_segment_rf": 0,
                                    "run_segment_ee": 0}}
    pool_run(W, TS, reqs, None, ekw, caps[0], {})          # warm-up
    results = {}
    for arr_name, arr in arrivals.items():
        for cap in caps:
            for tag, over in (("off", {}),
                              ("lease", dict(lease=True,
                                             overlap_boundaries=True)),
                              ("lease_sync", dict(lease=True))):
                if tag == "lease_sync" and arr_name != "saturated":
                    continue
                name = f"{arr_name}/{cap}/{tag}"
                ev = os.path.join(ckpt_dir, f"pool_{len(out['runs'])}.jsonl")
                disp, res, wall, launches, per_eng, walls = pool_run(
                    W, TS, reqs, arr, ekw, cap, over, events=ev)
                for k in out["launches"]:
                    out["launches"][k] += launches[k]
                results[name] = (disp, res)
                areas = pool_areas(res)
                d_ex = float(np.max(np.abs(areas - exact)))
                by_rid = {c.rid: c for c in res.completed}
                d_bag = max(abs(by_rid[r].area - a) for r, a in bag.items())
                lat = res.latency_percentiles()
                ls = disp.lease_summary()
                rec = dict(
                    wall_s=wall, requests_per_sec=n / wall, turns=res.phases,
                    latency=lat, host_syncs_per_turn=res.host_syncs
                    / max(res.phases, 1),
                    phases_per_engine={k: v["phases"] for k, v in
                                       disp.engines_summary().items()},
                    per_engine_launches=per_eng, parks=len(walls["park"]),
                    park_s=walls["park"], unpark_s=walls["unpark"],
                    boundary_wall_s=ls["boundary_wall_s"],
                    overlap_wall_s=ls["overlap_wall_s"],
                    boundaries=ls["boundaries"], overlapped=ls["overlapped"],
                    donated=ls["donated"], d_exact=d_ex, d_bag=d_bag,
                    launches=launches)
                grants = [g for g in (_json.loads(ln) for ln in open(ev))
                          if g.get("ev") == "event"
                          and g.get("name") == "lease_grant"]
                rec["parked_donors"] = sorted(
                    {g["attrs"]["donor"] for g in grants
                     if g["attrs"]["donor_parked"]})
                out["runs"][name] = rec
                log(f"[smoke] 22b {what} {name}: {rec['requests_per_sec']:.2f}"
                    f" req/s (wall {wall:.3f} s), {res.phases} turns, p50/p99 "
                    f"latency {lat['p50_phases']}/{lat['p99_phases']} turns "
                    f"({lat['p50_s']:.4f}/{lat['p99_s']:.4f} s), phases per "
                    f"engine {rec['phases_per_engine']}, host syncs per turn "
                    f"{rec['host_syncs_per_turn']:.2f}, parks "
                    f"{len(walls['park'])} "
                    f"({', '.join(f'{t:.3f}' for t in walls['park'])} s), "
                    f"unparks {len(walls['unpark'])} "
                    f"({', '.join(f'{t:.3f}' for t in walls['unpark'])} s); "
                    f"boundaries {ls['boundaries']} ({ls['overlapped']} "
                    f"overlapped), boundary wall {ls['boundary_wall_s']:.4f} "
                    f"s, overlap wall {ls['overlap_wall_s']:.4f} s; lease "
                    f"donated {ls['donated']} (parked donors "
                    f"{rec['parked_donors']}); {counter} launches per engine "
                    f"{ {k: v[0 if counter == 'run_segment_rf' else 1] for k, v in per_eng.items()} }; "
                    f"max |area - closed form| {d_ex:.3e}; every "
                    f"{POOL_SAMPLE}th t1 trapezoid area {d_bag:.3e} from the "
                    f"float64 bag")
                # every engine walks its saturated backlog in the kernel;
                # in the open loop a lone request may drain in the bag
                j = 0 if counter == "run_segment_rf" else 1
                walked = [v[j] for v in per_eng.values()]
                if (len(res.completed) != n or disp.recompiles() != 0
                        or not d_ex < AREA_TOL_EXACT
                        or not d_bag < AREA_TOL_BAG
                        or set(per_eng) != set(rec["phases_per_engine"])
                        or any(v[1 - j] != 0 for v in per_eng.values())
                        or (min(walked) <= 0 if arr_name == "saturated"
                            else sum(walked) <= 0)
                        or not ls["balanced"]):
                    raise AssertionError(f"22b {what} {name}: {rec}")
                if tag == "lease" and cap < len(keys):
                    summ = disp.engines_summary()
                    if not rec["parked_donors"] or any(
                            summ[k]["completed"] != summ[k]["routed"]
                            or summ[k]["completed"] != POOL_K
                            for k in rec["parked_donors"]):
                        raise AssertionError(
                            f"22b {what} {name}: no parked donor, or one "
                            f"that did not complete its requests: {summ}")
    # overlap = sync at each cap; capped against uncapped, printed
    for cap in caps:
        a = results[f"saturated/{cap}/lease"]
        b = results[f"saturated/{cap}/lease_sync"]
        ra, rb = pool_record(*a), pool_record(*b)
        for r in (ra, rb):
            r["ledger"].pop("overlapped")
        same = (np.array_equal(pool_areas(a[1]), pool_areas(b[1]))
                and ra == rb)
        log(f"[smoke] 22b {what} cap {cap}: overlapped boundaries against "
            f"serialized ones {'bit-equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"22b {what}: overlap != sync at cap {cap}")
    for arr_name in arrivals:
        for cap in caps[1:]:
            for tag in ("off", "lease"):
                a = pool_areas(results[f"{arr_name}/{cap}/{tag}"][1])
                b = pool_areas(results[f"{arr_name}/{caps[0]}/{tag}"][1])
                d = float(np.max(np.abs(a - b)))
                out["runs"][f"{arr_name}/{cap}/{tag}"]["d_uncapped"] = d
                log(f"[smoke] 22b {what} {arr_name}/{cap}/{tag} against "
                    f"the uncapped pool: "
                    f"{'bit-equal' if d == 0 else f'{d:.3e} apart'} (not "
                    f"held: parking may move the turn a request reaches "
                    f"its engine)")
    base = {c.rid: c for c in results[f"saturated/{caps[0]}/off"][1]
            .completed}
    out["simpson_d_bag"] = max(abs(base[r].area - a)
                               for r, a in s_bag.items())
    log(f"[smoke] 22b {what}: every {POOL_SAMPLE}th Simpson area "
        f"{out['simpson_d_bag']:.3e} from the float64 Simpson bag (printed, "
        f"not held, as phase 7 at full width)")
    if profile:
        out["profile"] = profile_fn(
            lambda: pool_run(W, TS, reqs, None, ekw, caps[0], {}),
            "walk_rf_kernel", out_dir, "dispatch_pool")
    if cuda_build.builds_done() != builds0:
        raise AssertionError(f"22b {what}: a library was built")
    return out


def dispatch_full_width(W, TS, stream_rep, ckpt_dir, out_dir) -> dict:
    """22b: the stream leg's engines behind one pool, through K1 and,
    with refill_slots=0 on the three t1 keys, through K2."""
    import numpy as np
    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.models.integrands import family_exact, get_family
    from ppls_tpu_torch.parallel.bag_engine import integrate_family
    f_theta = get_family(STREAM_FAMILY)
    out, bag_areas = {}, {}
    for tag, keys, ekw, counter in (
            ("K1", POOL_KEYS, POOL_EKW, "run_segment_rf"),
            ("K2", tuple(k for k in POOL_KEYS if "batch" not in k),
             dict(POOL_EKW, refill_slots=0, double_buffer=False),
             "run_segment_ee")):
        reqs = pool_requests(keys, POOL_K, BOUNDS, True)
        thetas = [t for th, _, _ in reqs
                  for t in (th if isinstance(th, tuple) else (th,))]
        exact = family_exact(STREAM_FAMILY, *BOUNDS, np.asarray(thetas))
        # every POOL_SAMPLE-th request of each t1 key: the trapezoid
        # ones against the float64 bag (held), Simpson's against the
        # float64 Simpson bag (printed)
        bags = ({}, {})
        for shape in keys:
            if "batch" in shape:
                continue
            rids = [r for r, (_, _, kw) in enumerate(reqs)
                    if kw == shape][::POOL_SAMPLE]
            rule = Rule(shape.get("rule", "trapezoid"))
            # the K2 leg's sampled thetas are among the K1 leg's: each
            # (eps, rule, theta) runs through the bag once
            key = (shape["eps"], rule)
            need = [reqs[r][0] for r in rids
                    if key + (reqs[r][0],) not in bag_areas]
            if need:
                areas = integrate_family(
                    f_theta, need, BOUNDS, shape["eps"], rule=rule,
                    chunk=1 << 15, capacity=1 << 22, device=DEVICE).areas
                bag_areas.update((key + (t,), float(a))
                                 for t, a in zip(need, areas))
            bags[rule == Rule.SIMPSON].update(
                (r, bag_areas[key + (reqs[r][0],)]) for r in rids)
        out[tag] = pool_leg(W, TS, tag, keys, ekw, counter, exact, bags[0],
                            bags[1], out_dir, ckpt_dir, profile=(tag == "K1"))
    single = STREAM_K / stream_rep["ds_walk"]["wall_s"]
    sat = out["K1"]["runs"][f"saturated/{len(POOL_KEYS)}/off"]
    out["single_engine_requests_per_sec"] = single
    log(f"[smoke] 22b pool saturated, K1, uncapped: "
        f"{sat['requests_per_sec']:.2f} req/s over {len(POOL_KEYS)} keys "
        f"against phase 11's single engine (the same width, the ds walk, "
        f"{STREAM_K} requests) {single:.2f} req/s: "
        f"{sat['requests_per_sec'] / single:.3f}x")
    return out


def ci_dispatch_argv(leg: str, reqs_path: str, ckpt: str, events: str,
                     device: str) -> list:
    extra, plan, _ = CI_DISPATCH_LEGS[leg]
    return ([sys.executable, "-m", "ppls_tpu_torch", "serve",
             *CI_DISPATCH_ARGS, *extra, "--requests", reqs_path,
             "--checkpoint", ckpt, "--events", events, "--fault-plan",
             json.dumps(plan), "--device", device])


def dispatch_serve(ckpt_dir) -> dict:
    """22c: ``python -m ppls_tpu_torch serve --dispatch`` as real
    processes, tools/ci.sh legs 5e and 5f, on the card and on the CPU
    (all four at once): ci.sh's summary assertions, card = CPU."""
    procs = {}
    env = dict(os.environ, PPLS_TUNING_TABLE="off")
    for leg, (_, _, malformed) in CI_DISPATCH_LEGS.items():
        path = os.path.join(ckpt_dir, f"ci_{leg}.jsonl")
        with open(path, "w") as fh:
            for r in CI_DISPATCH_REQS + ((CI_DISPATCH_MALFORMED,)
                                         if malformed else ()):
                fh.write(json.dumps(r) + "\n")
        for where, dev in (("card", DEVICE), ("cpu", "cpu")):
            tag = f"{leg}_{where}"
            argv = ci_dispatch_argv(
                leg, path, os.path.join(ckpt_dir, f"{tag}.ckpt"),
                os.path.join(ckpt_dir, f"{tag}_events.jsonl"), dev)
            procs[leg, where] = (subprocess.Popen(
                argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), time.perf_counter())
    # each process's wall ends when it exits (its few lines of output fit
    # the pipes); a process past the phase's limit is killed
    ends = {}
    while len(ends) < len(procs):
        for key, (proc, t0) in procs.items():
            if key not in ends and proc.poll() is not None:
                ends[key] = time.perf_counter() - t0
        if time.perf_counter() - min(t for _, t in procs.values()) \
                > DISPATCH_TIMEOUT:
            for p, _ in procs.values():
                p.kill()
            raise TimeoutError(f"22c: serve ran past {DISPATCH_TIMEOUT} s")
        time.sleep(0.05)
    runs = {}
    for key, (proc, _) in procs.items():
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"22c {key}: exit {proc.returncode}: "
                                 f"{se[-2000:]}")
        recs = [json.loads(ln) for ln in so.splitlines()
                if ln.startswith("{")]
        runs[key] = dict(records=recs, summary=recs[-1], wall_s=ends[key])
    out = {}
    for leg in CI_DISPATCH_LEGS:
        card, cpu = runs[leg, "card"], runs[leg, "cpu"]
        s = card["summary"]
        got, want = ledger(card), ledger(cpu)
        d = max(abs(got[r]["area"] - want[r]["area"]) for r in want)
        same = (sorted(got) == sorted(want) == list(range(8)) and all(
            {k: got[r].get(k) for k in RECORD_KEYS if k != "area"}
            == {k: want[r].get(k) for k in RECORD_KEYS if k != "area"}
            for r in want))
        rej = [r for r in card["records"] if r.get("rejected")]
        L = s["leases"]
        out[leg] = dict(completed=s["completed"], keys=len(s["engines"]),
                        attempts=s.get("attempts"), recompiles=s["recompiles"],
                        leases={k: L[k] for k in ("donated", "received",
                                                  "overlapped",
                                                  "boundaries")},
                        d_card_cpu=d, rejected=[r["error"] for r in rej],
                        process_wall_s=card["wall_s"],
                        cpu_process_wall_s=cpu["wall_s"])
        log(f"[smoke] 22c serve --dispatch, ci.sh leg {leg}: "
            f"{s['completed']} completed over {len(s['engines'])} keys, "
            f"recompiles {s['recompiles']}, attempts {s.get('attempts')}, "
            f"leases donated {L['donated']} / received {L['received']}, "
            f"{L['overlapped']}/{L['boundaries']} boundaries overlapped; "
            f"rejected {out[leg]['rejected']}; card against CPU records "
            f"{'equal' if same else 'DIFFER'}, areas {d:.3e} apart (tol "
            f"{AREA_TOL_DEVICES}); process walls {card['wall_s']:.1f} s "
            f"(card) / {cpu['wall_s']:.1f} s (CPU)")
        ok = (same and d < AREA_TOL_DEVICES and s["recompiles"] == 0
              and s["completed"] == 8 and len(s["engines"]) >= 3
              and sum(e["completed"] for e in s["engines"].values()) == 8
              and s.get("attempts", 1) >= 2
              and {e["kind"] for e in s["faults_injected"]} == {"crash"}
              and rej == [r for r in cpu["records"] if r.get("rejected")])
        if leg == "5e":
            ok = ok and len(rej) == 1 and "eps" in rej[0]["error"]
        else:
            ok = (ok and L["enabled"] and L["overlap_boundaries"]
                  and L["donated"] == L["received"] >= 1 and L["balanced"]
                  and L["overlapped"] >= 1 and L["overlap_fraction"] > 0)
        if not ok:
            raise AssertionError(f"22c leg {leg}: {out[leg]}")
    return out


def dispatch_dd(W) -> dict:
    """22d: tests/test_torch_dispatch.py's walker-dd pool on the card (two
    gloo ranks sharing it) and on the CPU: two keys through one live
    engine, parked and unparked; card = CPU; no rank left alive."""
    from ppls_tpu_torch.runtime.dispatch import EngineDispatcher
    ekw = dict({k: v for k, v in DD_STREAM_TEST_KW.items() if k != "slots"},
               engine="walker-dd", n_devices=2,
               **dd_cadence(W, DD_STREAM_TEST_KW))
    reqs = [(t, (0.0, 1.0), kw) for t, kw in DD_POOL_REQS]
    out = {}
    runs = {}

    def pool(where, dev):
        """One pool's run on ``dev``; the card's launches counted (the
        CPU's plain segments count none)."""
        disp = EngineDispatcher(
            "quad_scaled", slots=DD_STREAM_TEST_KW["slots"], max_engines=1,
            default_eps=DD_STREAM_TEST_EPS, device=dev, engine_kw=ekw)
        worlds = []
        park = disp._park

        def keep_world(keystr):
            worlds.append(disp._engines[keystr]._world)
            park(keystr)

        def run():
            return disp.run(reqs, arrival_phase=DD_POOL_ARR)

        disp._park = keep_world
        walls = timed_parks(disp)
        try:
            if where == "card":
                res, wall, launches = counted(W, run)
            else:
                t0 = time.perf_counter()
                res, launches = run(), {}
                wall = time.perf_counter() - t0
            worlds += [e._world for e in disp._engines.values()]
        finally:
            disp.close()
        alive = [p.pid for w in worlds for p in w._procs if p.is_alive()]
        runs[where] = res
        out[where] = dict(parks=len(walls["park"]), park_s=walls["park"],
                          unpark_s=walls["unpark"], wall_s=wall,
                          launches=launches, worlds=len(worlds),
                          alive_after_close=alive, turns=res.phases,
                          recompiles=disp.recompiles())
        if alive or len(walls["park"]) != 2 or len(walls["unpark"]) != 1 \
                or disp.recompiles() != 0:
            raise AssertionError(f"22d on {where}: {out[where]}")

    # the card's pool and the CPU's start their worlds side by side
    concurrently(lambda: pool("card", DEVICE), lambda: pool("cpu", "cpu"))

    def recs(r):
        return sorted((c.rid, c.submit_phase, c.admit_phase, c.retire_phase,
                       c.last_credited_phase) for c in r.completed)

    card, cpu = runs["card"], runs["cpu"]
    d = float(max(abs(a - b) for a, b in zip(card.areas, cpu.areas)))
    same = recs(card) == recs(cpu) and card.phases == cpu.phases
    out["d_card_cpu"] = d
    log(f"[smoke] 22d walker-dd pool (2 ranks per engine sharing the card "
        f"over gloo, max_engines 1): {card.phases} turns, parks "
        f"{out["card"]['parks']} "
        f"({', '.join(f'{t:.2f}' for t in out["card"]['park_s'])} s), "
        f"unparks {len(out["card"]['unpark_s'])} "
        f"({', '.join(f'{t:.2f}' for t in out["card"]['unpark_s'])} s, a "
        f"new world each), {out["card"]['worlds']} worlds, none alive after "
        f"close; card against CPU records {'equal' if same else 'DIFFER'}, "
        f"areas {d:.3e} apart (tol {AREA_TOL_DEVICES}); rank 0's launches "
        f"{out["card"]['launches']}")
    if not same or not d < AREA_TOL_DEVICES:
        raise AssertionError(f"22d: card and CPU differ: {out}")
    return out


def dispatch_kernels(W, ops) -> dict:
    """22k: K1 (trapezoid and Simpson, the ds walk) and K2 bit-equal to
    their plain segments at a pooled engine's shapes: the first phase of
    the e-10 keys' requests at the stream leg's width."""
    import numpy as np
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    f_theta, f_ds = get_family(STREAM_FAMILY), get_family_ds(STREAM_FAMILY)
    theta = 1.0 + np.arange(POOL_K) / POOL_K
    eps = POOL_KEYS[0]["eps"]
    out = {}
    for name, refill, mode in (("k1", POOL_EKW["refill_slots"], "step"),
                               ("k1_simpson", POOL_EKW["refill_slots"],
                                "step_simpson"),
                               ("k2", 0, "step")):
        rule, scout = mode_args(mode)
        base = W.first_phase_inputs(
            f_theta, theta, BOUNDS, eps, refill_slots=refill,
            scout=scout, rule=rule, lanes=POOL_EKW["lanes"],
            roots_per_lane=ROOTS_PER_LANE, capacity=POOL_EKW["capacity"],
            device=DEVICE)
        cmp = cmp_k1 if refill else cmp_k2
        out[name], times = cmp(W, f"22k {name} {mode} (pool engine)", base,
                               f_ds, eps, mode, ops, cap=LATE_CMP_CAP)
        log(fmt_cmp(f"22k {'K1' if refill else 'K2'} {mode} at a pooled "
                    f"engine's first phase ({POOL_K} requests, "
                    f"{POOL_EKW['lanes']} lanes, R {refill})", out[name],
                    times))
    return out


def phase_dispatch(W, TS, ckpt_dir, out_dir, ops, stream_rep) -> dict:
    """22: the pool dispatcher (module docstring), bounded by
    ``DISPATCH_TIMEOUT`` (every spawned world too)."""
    from ppls_tpu_torch.parallel import mesh as MESH
    MESH.WORLD_TIMEOUT_S = DISPATCH_TIMEOUT
    t_phase = time.perf_counter()

    def check_time(step):
        spent = time.perf_counter() - t_phase
        log(f"[smoke] 22: {step} at {spent:.1f} s")
        if spent > DISPATCH_TIMEOUT:
            raise TimeoutError(f"phase 22 ran past its {DISPATCH_TIMEOUT} "
                               f"s at {step} ({spent:.0f} s)")

    out = {"kernels": dispatch_kernels(W, ops)}
    check_time("22k")
    out["hetero"] = dispatch_hetero(W, TS)
    check_time("22a")
    out["pool"] = dispatch_full_width(W, TS, stream_rep, ckpt_dir, out_dir)
    check_time("22b")
    # 22c's serve processes run while 22d's pools start their worlds
    out["serve"], out["dd"] = concurrently(
        lambda: dispatch_serve(ckpt_dir), lambda: dispatch_dd(W))
    check_time("22c and 22d")
    out["launches"] = {k: (out["hetero"]["launches"][k]
                           + out["pool"]["K1"]["launches"][k]
                           + out["pool"]["K2"]["launches"][k]
                           + out["dd"]["card"]["launches"][k])
                       for k in ("run_segment_rf", "run_segment_ee")}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] 22 done in {out['seconds']:.1f} s; launches "
        f"{out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 23: the multi-process cluster
# ---------------------------------------------------------------------------


def cluster_workers_alive() -> list:
    """The pids of cluster worker processes still alive (zombies aside):
    every phase 23 run must leave none."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as fh:
                cmd = fh.read()
            with open(f"/proc/{d}/stat") as fh:
                state = fh.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if b"ppls_tpu_torch.runtime.cluster" in cmd and state != "Z":
            pids.append(int(d))
    return pids


def no_workers_left(what: str) -> None:
    alive = cluster_workers_alive()
    if alive:
        raise AssertionError(f"{what}: cluster workers still alive {alive}")


def cluster_record(c) -> dict:
    """A cluster's completed record as the ledger's fields, with its
    spillover mark."""
    return dict(record_of(c), spillover=bool(c.spillover))


def start_clusters(specs: dict) -> dict:
    """Start several clusters at once (each constructor spawns its
    workers and waits for their hellos; the workers' interpreter and
    torch imports overlap): name -> (engine, start s). If one fails,
    every engine that started is closed."""
    import concurrent.futures as cf
    from ppls_tpu_torch.runtime.cluster import ClusterStreamEngine

    def start(kw):
        t0 = time.perf_counter()
        eng = ClusterStreamEngine(**kw)
        return eng, time.perf_counter() - t0

    with cf.ThreadPoolExecutor(len(specs)) as ex:
        futs = {name: ex.submit(start, kw) for name, kw in specs.items()}
    out, err = {}, None
    for name, fut in futs.items():
        try:
            out[name] = fut.result()
        except Exception as e:  # noqa: BLE001 -- raised after the cleanup
            err = err or e
    if err is not None:
        for eng, _ in out.values():
            eng.close()
        raise err
    return out


def cluster_multihost(eng, inj, start_s: float) -> dict:
    """23a, one run on a started cluster: the reference bench's multihost
    leg (2 processes, queue limit 2, spillover limit 2, worker 1
    SIGKILLed at phase 1 through ``inj`` and recovered by the
    supervisor's host_loss arm). Closes the cluster."""
    from ppls_tpu_torch.runtime import guard
    thetas = [1.0 + i / 4.0 for i in range(MULTIHOST_K)]
    reqs = [(t, (0.0, 1.0)) for t in thetas]

    def loop():
        k = eng.next_rid
        while not eng.idle or k < len(reqs):
            while k < len(reqs):
                eng.submit(*reqs[k])
                k += 1
            eng.step()
        return eng.result()

    def resize_fn(exc):
        eng.recover_host_loss(exc)
        return loop

    sup = guard.Supervisor(loop, resize_fn=resize_fn, log=lambda m: None,
                           sleep=lambda s: None)
    try:
        t0 = time.perf_counter()
        res = sup.run()
        wall = time.perf_counter() - t0
        return dict(
            records={c.rid: cluster_record(c) for c in res.completed},
            areas=res.areas, shed=len(res.shed),
            completed=len(res.completed),
            recoveries=[list(r) for r in sup.recoveries],
            survivors=eng.manifest.process_ids,
            manifest=eng.manifest.describe()["processes"],
            spillover=eng.spillover_summary(),
            redeal_wall_s=eng.redeal_walls[0] if eng.redeal_walls else None,
            spawn_s=dict(eng.spawn_walls), start_s=start_s, wall_s=wall,
            launches=eng.launches())
    finally:
        eng.close()


def cluster_card_cpu(TS) -> dict:
    """23a: the multihost leg as given (f64_rounds=2) and through the walk
    (f64_rounds=0: K1 on every worker), on the card and on the CPU; the
    four clusters are started at once, then run one after another."""
    import numpy as np
    from ppls_tpu_torch.runtime.faults import FaultInjector, FaultPlan
    thetas = [1.0 + i / 4.0 for i in range(MULTIHOST_K)]
    reqs = [(t, (0.0, 1.0)) for t in thetas]
    injectors = {(f, dev): FaultInjector(FaultPlan.from_events(
        [dict(e) for e in MULTIHOST_FAULTS]))
        for f in (2, 0) for dev in (DEVICE, "cpu")}
    started = start_clusters({key: dict(
        family=MULTIHOST_FAMILY, eps=MULTIHOST_EPS,
        n_processes=MULTIHOST_PROCESSES,
        worker_kw=dict(MULTIHOST_WKW, f64_rounds=key[0]),
        fault_injector=inj, queue_limit=MULTIHOST_QUEUE_LIMIT,
        spillover=True, spillover_limit=MULTIHOST_SPILL_LIMIT,
        device=key[1], spawn_timeout=CLUSTER_TIMEOUT,
        rpc_timeout=CLUSTER_TIMEOUT) for key, inj in injectors.items()})
    out = {}
    try:
        for f64_rounds in (2, 0):
            single = TS.StreamEngine(
                MULTIHOST_FAMILY, MULTIHOST_EPS, device=DEVICE,
                **dict(MULTIHOST_WKW, f64_rounds=f64_rounds)).run(reqs)
            card, cpu = (cluster_multihost(started[f64_rounds, dev][0],
                                           injectors[f64_rounds, dev],
                                           started[f64_rounds, dev][1])
                         for dev in (DEVICE, "cpu"))
            bad = [r for r in set(card["records"]) | set(cpu["records"])
                   if card["records"].get(r) != cpu["records"].get(r)]
            bit = bool(np.array_equal(card["areas"], single.areas))
            lost = MULTIHOST_K - card["completed"] - card["shed"]
            k1 = {p: card["launches"][str(p)]["run_segment_rf"]
                  for p in card["survivors"]}
            row = dict(card={k: v for k, v in card.items()
                             if k not in ("records", "areas")},
                       cpu_spawn_s=cpu["spawn_s"], records_differ=bad,
                       areas_bit_equal_single=bit, lost=lost,
                       survivor_k1=k1)
            out[f64_rounds] = row
            log(f"[smoke] 23a multihost leg, f64_rounds {f64_rounds}: "
                f"recoveries {card['recoveries']}, survivors "
                f"{card['survivors']}, {card['completed']} completed "
                f"({card['spillover']['spillover_completed']} on the CPU "
                f"spillover, {card['spillover']['spillover_tasks']} tasks), "
                f"{card['shed']} shed, lost {lost}; areas bit-equal to the "
                f"single engine {bit}; card = CPU records "
                f"{'equal' if not bad else f'DIFFER at {bad}'}; redeal wall "
                f"{card['redeal_wall_s']:.4f} s; spawn s per worker, four "
                f"clusters started together (card) "
                f"{ {p: round(s, 2) for p, s in card['spawn_s'].items()} }, "
                f"(CPU) "
                f"{ {p: round(s, 2) for p, s in cpu['spawn_s'].items()} }; "
                f"survivors' K1 launches {k1}; run wall "
                f"{card['wall_s']:.2f} s")
            if (bad or not bit or lost or card["shed"]
                    or card["recoveries"] != [["host_loss",
                                               "resize_resume"]]
                    or card["spillover"]["spillover_completed"] <= 0
                    or (f64_rounds == 0 and min(k1.values()) <= 0)):
                raise AssertionError(f"23a f64_rounds {f64_rounds}: {row}")
    finally:
        for eng, _ in started.values():
            eng.close()
    no_workers_left("23a")
    return out


def cluster_timed_run(eng, reqs):
    """A run of ``reqs`` on a cluster that may have run before: this run's
    completed records, wall, and its result for the latency quantiles."""
    import torch
    n0, p0 = len(eng.completed), eng.phase
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from ppls_tpu_torch.runtime.stream import StreamResult
    done = eng.completed[n0:]
    res = StreamResult(completed=done, phases=eng.phase - p0, wall_s=wall,
                       totals={}, phase_stats=None)
    return res, wall


def cluster_full_width(TS, stream_rep) -> dict:
    """23b: phase 11's stream leg (24 requests, the ds walk) through 1 and
    2 worker processes on the one card, saturated, a warm-up run first;
    then 2 processes through K2 (refill_slots=0)."""
    import numpy as np
    from ppls_tpu_torch.models.integrands import family_exact, get_family
    from ppls_tpu_torch.parallel.bag_engine import integrate_family
    k = STREAM_K
    theta = 1.0 + np.arange(k) / k
    reqs = [(float(t), BOUNDS) for t in theta]
    exact = family_exact(STREAM_FAMILY, *BOUNDS, theta)
    sample = np.arange(0, k, CLUSTER_SAMPLE)
    bag = integrate_family(get_family(STREAM_FAMILY), theta[sample], BOUNDS,
                           EPS, chunk=1 << 15, capacity=1 << 22,
                           device=DEVICE).areas
    single_wall = stream_rep["ds_walk"]["wall_s"]
    out = {"single_engine": dict(wall_s=single_wall,
                                 requests_per_sec=k / single_wall)}
    legs = [(f"K1/{n}", n, dict(STREAM_KW, scout_dtype="f64"),
             "run_segment_rf") for n in CLUSTER_PROCESSES]
    legs.append(("K2/2", 2, dict(STREAM_KW, scout_dtype="f64",
                                 refill_slots=0, double_buffer=False),
                 "run_segment_ee"))
    # the three clusters start at once; each is then timed alone while
    # the others' workers wait on their sockets
    started = start_clusters({tag: dict(
        family=STREAM_FAMILY, eps=EPS, n_processes=n, worker_kw=wkw,
        device=DEVICE, spawn_timeout=CLUSTER_TIMEOUT,
        rpc_timeout=CLUSTER_TIMEOUT) for tag, n, wkw, _k in legs})
    try:
        for tag, n, wkw, kernel in legs:
            eng, start_s = started[tag]
            try:
                _warm, warm_wall = cluster_timed_run(eng, reqs)
                res, wall = cluster_timed_run(eng, reqs)
                launches = eng.launches()
                spawn = dict(eng.spawn_walls)
            finally:
                eng.close()
            out[tag] = full_width_leg(tag, n, kernel, res, wall, warm_wall,
                                      launches, spawn, start_s, exact,
                                      sample, bag, single_wall)
    finally:
        for eng, _ in started.values():
            eng.close()
    no_workers_left("23b")
    return out


def full_width_leg(tag, n, kernel, res, wall, warm_wall, launches, spawn,
                   start_s, exact, sample, bag, single_wall) -> dict:
    """One 23b leg's numbers, logged and gated."""
    import numpy as np
    k = len(exact)
    areas = np.array([c.area for c in sorted(res.completed,
                                             key=lambda c: c.rid)])
    d_ex = float(np.max(np.abs(areas - exact)))
    d_bag = float(np.max(np.abs(areas[sample] - bag)))
    lat = res.latency_percentiles()
    other = ("run_segment_ee" if kernel == "run_segment_rf"
             else "run_segment_rf")
    row = dict(processes=n, wall_s=wall, warm_up_wall_s=warm_wall,
               requests_per_sec=k / wall, phases=res.phases,
               latency=lat, d_exact=d_ex, d_bag=d_bag,
               launches=launches, spawn_s=spawn, start_s=start_s,
               vs_single=(k / wall) / (k / single_wall))
    log(f"[smoke] 23b {tag} process(es) on one card ({kernel}; "
        f"{'the workers time-slice one card: not a multi-GPU rate' if n > 1 else 'one worker'}"
        f"): {k / wall:.2f} req/s (wall {wall:.3f} s; warm-up run "
        f"{warm_wall:.3f} s), {row['vs_single']:.3f}x phase 11's single "
        f"engine ({k / single_wall:.2f} req/s), {res.phases} phases, "
        f"p50/p99 latency {lat['p50_phases']}/{lat['p99_phases']} "
        f"phases ({lat['p50_s']:.4f}/{lat['p99_s']:.4f} s); start "
        f"{start_s:.2f} s, spawn s per worker "
        f"{ {p: round(s, 2) for p, s in spawn.items()} }; launches "
        f"{launches}; {d_ex:.3e} from the closed form, every "
        f"{CLUSTER_SAMPLE}th {d_bag:.3e} from the float64 bag")
    if (len(res.completed) != k or not d_ex < AREA_TOL_EXACT
            or not d_bag < AREA_TOL_BAG
            or sorted(launches) != [str(p) for p in range(n)]
            or min(v[kernel] for v in launches.values()) <= 0
            or max(v[other] for v in launches.values()) != 0):
        raise AssertionError(f"23b {tag}: {row}")
    return row


def ci_5d_argv(p: int, f64_rounds: int, device: str, *extra) -> list:
    return (["serve", "--processes", str(p), "--f64-rounds",
             str(f64_rounds), *CI_5D_ARGS, *extra, "--device", device])


def cluster_metrics_run(argv) -> tuple:
    """One serve process with ``--metrics-port 0`` scraped live; the
    final sample, inside the ``PPLS_SERVE_METRICS_HOLD`` window, holds
    the reconciliation invariant. Returns (records, the invariant's
    numbers)."""
    old = os.environ.get("PPLS_SERVE_METRICS_HOLD")
    os.environ["PPLS_SERVE_METRICS_HOLD"] = "1"
    try:
        proc = ServeProcess(argv + ["--metrics-port", "0"])
    finally:
        if old is None:
            os.environ.pop("PPLS_SERVE_METRICS_HOLD")
        else:
            os.environ["PPLS_SERVE_METRICS_HOLD"] = old
    try:
        _t, line = proc.wait_for(lambda ln: "metrics on http" in ln,
                                 "the metrics URL", CLUSTER_TIMEOUT)
        url = re.search(r"metrics on (http://\S+)", line).group(1)
        samples = 0

        def summary():
            nonlocal samples
            status, _text, _ms = http(url)
            samples += status == 200
            return next((json.loads(ln) for _, ln in proc.lines()
                         if ln.startswith("{") and '"summary"' in ln), None)
        summ = proc.wait_until(summary, "the summary", CLUSTER_TIMEOUT)
        status, expo, _ms = http(url)
        rc = proc.proc.wait(timeout=60)
    finally:
        proc.kill()
    if rc != 0 or status != 200:
        raise AssertionError(f"23c metrics run exited {rc} / {status}")
    vals = {}
    for ln in expo.splitlines():
        m = re.match(r'ppls_stream_retired_total\{process="([^"]+)"\} (\S+)',
                     ln)
        if m:
            vals[m.group(1)] = float(m.group(2))
    workers = sum(v for p, v in vals.items() if p != "coordinator")
    spill = summ["spillover"]["spillover_completed"]
    inv = dict(coordinator=vals.get("coordinator"), workers=workers,
               spillover=spill, completed=summ["completed"],
               samples=samples)
    if not (inv["coordinator"] == workers + spill == summ["completed"]):
        raise AssertionError(f"23c: the federation does not reconcile {inv}")
    recs = [json.loads(ln) for _, ln in sorted(proc.out)
            if ln.startswith("{")]
    return dict(records=recs, summary=summ), inv


def cluster_serve(ckpt_dir) -> dict:
    """23c: ``python -m ppls_tpu_torch serve --processes`` as real
    processes, all started at once: ci.sh leg 5d at 1, 2 and 4 processes
    with f64_rounds 2 and 0 on the card (the 2-process float64 run with
    ``--metrics-port 0``, scraped live), at 2 processes on the CPU, and
    one ``--supervise`` run with a host_loss fault plan."""
    runs = {(p, f, DEVICE): ci_5d_argv(p, f, DEVICE)
            for f in (2, 0) for p in CLUSTER_SWEEP}
    runs.update({(2, f, "cpu"): ci_5d_argv(2, f, "cpu") for f in (2, 0)})
    # the float64 mode's 7 phases outlast the fault's phase 2
    runs["supervise"] = ci_5d_argv(2, 2, DEVICE, "--supervise",
                                   "--fault-plan",
                                   json.dumps(CI_5D_HOST_LOSS))
    metrics_key = (2, 2, DEVICE)
    env = dict(os.environ, PPLS_TUNING_TABLE="off")
    procs = {}
    t0 = time.perf_counter()
    for key, argv in runs.items():
        if key == metrics_key:
            continue
        tag = "_".join(str(k) for k in key) if isinstance(key, tuple) \
            else key
        fo = open(os.path.join(ckpt_dir, f"serve_{tag}.out"), "w+")
        fe = open(os.path.join(ckpt_dir, f"serve_{tag}.err"), "w+")
        procs[key] = (subprocess.Popen(
            [sys.executable, "-m", "ppls_tpu_torch", *argv], cwd=ROOT,
            env=env, stdout=fo, stderr=fe), fo, fe)
    done = {}
    try:
        done[metrics_key], inv = cluster_metrics_run(runs[metrics_key])
        for key, (proc, fo, fe) in procs.items():
            rc = proc.wait(timeout=max(CLUSTER_TIMEOUT
                                       - (time.perf_counter() - t0), 1))
            fo.seek(0)
            fe.seek(0)
            if rc != 0:
                raise AssertionError(f"23c {key}: exit {rc}: "
                                     f"{fe.read()[-2000:]}")
            recs = [json.loads(ln) for ln in fo.read().splitlines()
                    if ln.startswith("{")]
            done[key] = dict(records=recs, summary=recs[-1])
    finally:
        for proc, fo, fe in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fo.close()
            fe.close()
    wall = time.perf_counter() - t0
    no_workers_left("23c")
    out = {"federation": inv, "wall_s": wall, "runs": {},
           "launches": {"run_segment_rf": 0, "run_segment_ee": 0}}
    log(f"[smoke] 23c {len(runs)} serve --processes processes at once "
        f"(the 2-process float64 run with --metrics-port 0): {wall:.1f} s "
        f"to the last exit; {inv['samples']} live scrapes, coordinator "
        f"retired {inv['coordinator']} = workers {inv['workers']} + "
        f"spillover {inv['spillover']} = completed {inv['completed']}; no "
        f"worker left alive")
    for key, run in done.items():
        s = run["summary"]
        out["runs"][str(key)] = dict(completed=s["completed"],
                                     phases=s["phases"],
                                     manifest=s["manifest"],
                                     launches=s["launches"],
                                     wall_s=s["wall_s"])
        if key == "supervise" or key[2] == DEVICE:
            for v in s["launches"].values():
                for kk in out["launches"]:
                    out["launches"][kk] += v[kk]
    for f in (2, 0):
        sweep = [{r: v["area"] for r, v in ledger(done[p, f, DEVICE]).items()}
                 for p in CLUSTER_SWEEP]
        same = all(a == sweep[0] for a in sweep[1:]) and len(sweep[0]) == 6
        bad = same_records(ledger(done[2, f, "cpu"]),
                           ledger(done[2, f, DEVICE]))
        log(f"[smoke] 23c --processes {list(CLUSTER_SWEEP)}, f64_rounds {f}: "
            f"areas {'bit-identical' if same else 'DIFFER'} across process "
            f"counts; card = CPU (2 processes) "
            f"{'records equal' if not bad else f'DIFFER at {bad}'}; "
            f"launches "
            f"{[done[p, f, DEVICE]['summary']['launches'] for p in CLUSTER_SWEEP]}")
        if not same or bad:
            raise AssertionError(f"23c f64_rounds {f}: sweep {sweep}, "
                                 f"card/CPU {bad}")
        out[f"sweep_f64_{f}"] = sweep[0]
    s = done["supervise"]["summary"]
    got, want = ledger(done["supervise"]), ledger(done[2, 2, DEVICE])
    recov = [(r["kind"], r["action"]) for r in s.get("recoveries", [])]
    lost = sorted(set(want) - set(got))
    equal = all(got[r]["area"] == want[r]["area"] for r in want if r in got)
    log(f"[smoke] 23c serve --processes 2 --supervise, host_loss at phase "
        f"2: recoveries {recov}, manifest after {s['manifest']}, "
        f"{s['completed']} completed, lost {lost}, areas "
        f"{'equal' if equal else 'DIFFER from'} the undisturbed run's; "
        f"redeal walls {s['redeal_walls_s']} s")
    if recov != [("host_loss", "resize_resume")] or lost or not equal \
            or s["manifest"]["processes"] != 1:
        raise AssertionError(f"23c supervise: {s}")
    out["supervise"] = dict(recoveries=recov, lost=lost,
                            redeal_walls_s=s["redeal_walls_s"])
    return out


def phase_cluster(W, TS, ckpt_dir, stream_rep) -> dict:
    """23: the multi-process cluster (module docstring), bounded by
    ``CLUSTER_TIMEOUT``."""
    t_phase = time.perf_counter()

    def check_time(step):
        spent = time.perf_counter() - t_phase
        log(f"[smoke] 23: {step} at {spent:.1f} s")
        if spent > CLUSTER_TIMEOUT:
            raise TimeoutError(f"phase 23 ran past its {CLUSTER_TIMEOUT} "
                               f"s at {step} ({spent:.0f} s)")

    no_workers_left("23 (before)")
    out = {"multihost": cluster_card_cpu(TS)}
    check_time("23a")
    out["full_width"] = cluster_full_width(TS, stream_rep)
    check_time("23b")
    out["serve"] = cluster_serve(ckpt_dir)
    check_time("23c")
    launches = {k: 0 for k in ("run_segment_rf", "run_segment_ee")}
    recs = ([out["multihost"][f]["card"]["launches"] for f in (2, 0)]
            + [out["full_width"][t]["launches"]
               for t in out["full_width"] if "/" in t])
    for rec in recs:
        for v in rec.values():
            for kk in launches:
                launches[kk] += v[kk]
    for kk in launches:
        launches[kk] += out["serve"]["launches"][kk]
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] 23 done in {out['seconds']:.1f} s; workers' launches "
        f"{launches}")
    return out


# ---------------------------------------------------------------------------
# phase 24: the diagnosis and post-mortem tools
# ---------------------------------------------------------------------------


def area_hash(areas) -> str:
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(areas, dtype=np.float64)).tobytes()).hexdigest()[:16]


def tool_call(W, what: str, fn, out_dir):
    """``fn()`` with its printed lines captured, every kernel's launch
    count set to 0 just before and read just after: (its value, the
    lines, the launches). The lines are logged and appended to
    ``chip_smoke_tools.txt`` in ``out_dir``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value, wall, launches = counted(W, fn)
    lines = buf.getvalue().splitlines()
    with open(os.path.join(out_dir, "chip_smoke_tools.txt"), "a") as fh:
        fh.write(f"### {what} ({wall:.2f} s, launches {launches})\n"
                 + buf.getvalue())
    for ln in lines:
        if ln.strip():
            log(f"[smoke] {what} | {ln}")
    log(f"[smoke] {what}: {wall:.2f} s, launches {launches}")
    return value, lines, launches


def tools_attribution(W, f_theta, f_ds, base, out_dir) -> dict:
    """24a, ``analyze_occupancy --attribution`` on the card, one mode at a
    time: the flagship mode against phase 4's run (``base["k1"]``) and
    FLAGSHIP_TASKS and K1_MAIN, the refill_slots=0 mode against phase 6's
    (``base["k2"]``) and K2_MAIN, every mode's buckets against lanes x
    kernel steps."""
    from ppls_tpu_torch.tools import analyze_occupancy as AO
    out = {}
    for mode_kw, label in AO.ATTRIBUTION_MODES:
        recs, _, launches = tool_call(
            W, f"24a attribution {label}",
            lambda: AO.attribution(DEVICE, modes=((mode_kw, label),)),
            out_dir)
        r = recs[0]["result"]
        att = r.attribution()
        if sum(att["buckets"].values()) != r.kernel_steps * r.lanes \
                or not att["reconciles"]:
            raise AssertionError(f"24a {label}: buckets do not reconcile")
        out[label] = dict(tasks=r.metrics.tasks, kernel_steps=r.kernel_steps,
                          launches=launches, buckets=att["buckets"],
                          lane_efficiency=r.lane_efficiency,
                          area_hash=area_hash(r.areas),
                          wall_s=r.metrics.wall_time_s)
    pins = (dict(tasks=FLAGSHIP_TASKS, launches=K1_MAIN[0],
                 kernel_steps=K1_MAIN[1]),
            dict(launches=K2_MAIN[0], kernel_steps=K2_MAIN[1]))
    for label, key, pin, kernel in (
            (AO.ATTRIBUTION_MODES[2][1], "k1", pins[0], "run_segment_rf"),
            (AO.ATTRIBUTION_MODES[0][1], "k2", pins[1], "run_segment_ee")):
        got, (want, want_launches) = out[label], base[key]
        same = dict(tasks=got["tasks"] == want.metrics.tasks,
                    kernel_steps=got["kernel_steps"] == want.kernel_steps,
                    launches=got["launches"][kernel] == want_launches,
                    area_hash=got["area_hash"] == area_hash(want.areas))
        pinned = {k: {"tasks": got["tasks"], "kernel_steps":
                      got["kernel_steps"], "launches":
                      got["launches"][kernel]}[k] == v
                  for k, v in pin.items()}
        log(f"[smoke] 24a {label}: {got['tasks']} tasks, "
            f"{got['kernel_steps']} kernel steps, {kernel} "
            f"{got['launches'][kernel]}, area hash {got['area_hash']}; "
            f"against phase {4 if key == 'k1' else 6}'s run {same}, pinned "
            f"{pin}: {pinned}")
        if not all(same.values()) or not all(pinned.values()):
            raise AssertionError(f"24a {label}: not phase "
                                 f"{4 if key == 'k1' else 6}'s walk")
    return out


def tools_decompose(W, f_theta, f_ds, out_dir) -> dict:
    """24a, ``analyze_occupancy``'s decomposition on the card; its solo
    runs against an ``integrate_family_walker`` call with the same
    arguments in this process."""
    import numpy as np
    from ppls_tpu_torch.tools import analyze_occupancy as AO
    dec, _, launches = tool_call(W, "24a decomposition",
                                 lambda: AO.decompose(DEVICE), out_dir)
    theta = 1.0 + np.arange(AO.M) / AO.M
    ref = W.integrate_family_walker(f_theta, f_ds, theta, AO.BOUNDS, AO.EPS,
                                    capacity=AO.CAPACITY, refill_slots=8,
                                    device=DEVICE)
    want = (ref.metrics.tasks, ref.kernel_steps, area_hash(ref.areas))
    got = [(r.metrics.tasks, r.kernel_steps, area_hash(r.areas))
           for r in dec["solo"] + dec["pipeline"] + [dec["warm_up"]]]
    log(f"[smoke] 24a decomposition: solo, pipeline and warm-up runs "
        f"(tasks, kernel steps, area hash) {sorted(set(got))} against the "
        f"same call here {want}; RTT {dec['rtt_s'] * 1e3:.3f} ms; "
        f"re-dispatched tasks {dec['redispatch_tasks']}; kernel ceiling "
        f"{dec['ceiling'] / 1e9:.3f} G lane-steps/s, kernel_ceiling_frac "
        f"{dec.get('kernel_ceiling_frac')}")
    if any(g != want for g in got) or len(set(dec["redispatch_tasks"])) != 1:
        raise AssertionError("24a: the decomposition's runs differ from "
                             "the same call in this process")
    keep = ("rtt_s", "rtts_s", "initial_bag_s", "solo_walls_s",
            "pipeline_s", "pipeline_deltas_s", "redispatch_tasks",
            "redispatch_s", "occupancy", "ceiling", "kernel_ceiling_frac")
    return dict({k: dec.get(k) for k in keep}, launches=launches,
                probe={k: dec["probe"].get(k) for k in (
                    "lane_steps_per_sec", "us_per_step", "launches")},
                tasks=want[0], kernel_steps=want[1])


def tools_dd(W, family_exact, out_dir) -> dict:
    """24b, ``analyze_occupancy dd`` (one rank: NCCL in this process) and
    ``characterize_dd``: every dd run's areas within AREA_TOL_EXACT of
    the closed form."""
    import numpy as np
    from ppls_tpu_torch.tools import analyze_occupancy as AO
    from ppls_tpu_torch.tools import characterize_dd as CD
    dd, _, dd_launches = tool_call(W, "24b analyze_occupancy dd",
                                   lambda: AO.dd(DEVICE), out_dir)
    m = dd["refill"].areas.shape[0]
    ex = family_exact(AO.FAMILY, *AO.BOUNDS, 1.0 + np.arange(m) / m)
    errs = {leg: float(np.max(np.abs(dd[leg].areas - ex)))
            for leg in ("refill", "legacy")}
    rows, _, cd_launches = tool_call(W, "24b characterize_dd",
                                     lambda: CD.characterize(DEVICE),
                                     out_dir)
    ex = family_exact(CD.FAMILY, *CD.BOUNDS, 1.0 + np.arange(CD.M) / CD.M)
    for row in rows:
        errs[row["name"]] = max(float(np.max(np.abs(r.areas - ex)))
                                for r in row["runs"])
    log(f"[smoke] 24b: max |area - closed form| per run {errs} (tol "
        f"{AREA_TOL_EXACT})")
    if not all(e < AREA_TOL_EXACT for e in errs.values()):
        raise AssertionError("24b: a dd run misses the closed form")
    if dd_launches["run_segment_rf"] <= 0 \
            or dd_launches["run_segment_ee"] <= 0:
        raise AssertionError(f"24b: a dd leg launched no kernel "
                             f"{dd_launches}")
    return dict(world=dd["world"], err=errs,
                legs={leg: dict(tasks=dd[leg].metrics.tasks,
                                wall_s=dd[f"wall_{leg}_s"],
                                cycles=dd[leg].cycles,
                                collective_rounds=dd[leg].collective_rounds)
                      for leg in ("refill", "legacy")},
                ceiling=dd["ceiling"], dd_launches=dd_launches,
                characterize={row["name"]: dict(
                    tasks=row["tasks"], wall_s=row["wall_s"],
                    rate=row["rate"], walls_s=row["walls_s"])
                    for row in rows},
                characterize_launches=cd_launches)


def tools_offline(ckpt_dir, artifacts) -> dict:
    """24c: check_artifacts, analyze_request and --from-events on phase
    14's serve ledger and timeline; a malformed ledger line must fail."""
    from ppls_tpu_torch.tools import analyze_occupancy as AO
    from ppls_tpu_torch.tools import analyze_request as AR
    from ppls_tpu_torch.tools import check_artifacts as CA
    led = os.path.join(ckpt_dir, "serve_14a.jsonl")
    ev = os.path.join(ckpt_dir, "serve_14b_events.jsonl")
    bad = os.path.join(ckpt_dir, "serve_14a_malformed.jsonl")
    lines = artifacts["ledger"].splitlines()
    i = next(j for j, ln in enumerate(lines) if '"rid"' in ln)
    for path, text in ((led, artifacts["ledger"]),
                       (ev, artifacts["events"]),
                       (bad, "\n".join(lines[:i] + [lines[i][:40]]
                                       + lines[i + 1:]) + "\n")):
        with open(path, "w") as fh:
            fh.write(text)
    runs = {}
    for name, fn, argv in (
            ("check_artifacts --serve", CA.main, ["--serve", led]),
            ("check_artifacts --events --rid-linkage", CA.main,
             ["--events", ev, "--rid-linkage"]),
            ("analyze_request --check", AR.main, [ev, "--check"]),
            ("analyze_occupancy --from-events", AO.main,
             ["--from-events", ev]),
            ("check_artifacts --serve (malformed line)", CA.main,
             ["--serve", bad])):
        o, e = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            rc = fn(argv)
        runs[name] = dict(rc=rc, out=o.getvalue(), err=e.getvalue())
        for ln in (o.getvalue() + e.getvalue()).splitlines():
            if ln.strip():
                log(f"[smoke] 24c {name} | {ln}")
        log(f"[smoke] 24c {name}: exit {rc}")
    want = {name: (1 if "malformed" in name else 0) for name in runs}
    ok = {name: (runs[name]["rc"] != 0 if want[name] else
                 runs[name]["rc"] == 0) for name in runs}
    recon = [ln for ln in runs["analyze_occupancy --from-events"][
        "out"].splitlines() if "reconciliation:" in ln]
    if not all(ok.values()) or not recon \
            or not all("-> OK" in ln for ln in recon):
        raise AssertionError(f"24c: offline tools {ok}, {recon}")
    return {name: r["rc"] for name, r in runs.items()}


def tools_k2_theta(W, ops_of) -> dict:
    """24d: K2's theta variant against the plain theta segment, bit for
    bit, on seeded theta lanes at the flagship's width: a bred and dealt
    theta bank of sin(theta / x) (each group's thetas spread over 0.5 /
    T) walked K2_THETA_WALK steps by the plain K1 segment, then
    LATE_CMP_CAP K2 steps per (T, step machine); theta_overwalk > 0
    somewhere."""
    import numpy as np
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    f_theta = get_family(K2_THETA_FAMILY)
    f_ds = get_family_ds(K2_THETA_FAMILY)
    ops = ops_of(f_ds)
    cmp = {}
    for T, mode in K2_THETA_CMP:
        _, scout = mode_args(mode)
        m = LANES // T
        theta = (1.0 + np.arange(m) / m)[:, None] \
            + 0.5 * np.arange(T)[None, :] / T
        inp = W.first_phase_inputs(
            f_theta, theta, K2_THETA_BOUNDS, K2_THETA_EPS, lanes=LANES,
            roots_per_lane=ROOTS_PER_LANE, refill_slots=REFILL_SLOTS,
            capacity=CAPACITY, scout=scout, theta_block=T, device=DEVICE)
        W.segment_rf_plain(inp["state"], inp["slot"], inp["thresh"],
                           K2_THETA_WALK, inp["batch"], inp["nslots"],
                           inp["bank"], inp["resm"], f_ds=f_ds,
                           eps=K2_THETA_EPS, scout=scout, theta_block=T)
        base = dict(state=inp["state"], thresh=LANES // 8)
        key = f"{T}" + ("_scout" if scout else "")
        cmp[key], times = cmp_k2(W, f"K2 theta T={T} {mode}", base, f_ds,
                                 K2_THETA_EPS, mode, ops, theta_block=T,
                                 cap=LATE_CMP_CAP)
        cmp[key].update(T=T, mode=mode)
        log(fmt_cmp(f"K2 theta T={T} {mode}", cmp[key], times))
    over = {k: c["counters"][4] for k, c in cmp.items()}
    log(f"[smoke] 24d K2 theta_overwalk per case {over}")
    if not any(over.values()):
        raise AssertionError("24d: no K2 theta case walked a retired lane")
    return cmp


def tools_profile_bag(out_dir) -> dict:
    """24e: ``profile_bag`` at its sizes with PROFILE_BAG_K iterations:
    every component a finite, positive time."""
    import math
    from ppls_tpu_torch.tools import profile_bag as PB
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        us = PB.profile(DEVICE, PROFILE_BAG_K)
    for ln in buf.getvalue().splitlines():
        log(f"[smoke] 24e profile_bag | {ln}")
    with open(os.path.join(out_dir, "chip_smoke_tools.txt"), "a") as fh:
        fh.write(f"### 24e profile_bag (K={PROFILE_BAG_K})\n"
                 + buf.getvalue())
    if len(us) != 13 or not all(math.isfinite(v) and v > 0
                                for v in us.values()):
        raise AssertionError(f"24e: profile_bag times {us}")
    return us


def phase_tools(W, TS, ckpt_dir, out_dir, base, artifacts) -> dict:
    """24: the diagnosis and post-mortem tools on the card (module
    docstring), bounded by ``TOOLS_TIMEOUT``. ``base`` holds phases 4 and
    6's runs and their K1 / K2 launches; ``artifacts`` phase 14's ledger
    and timeline."""
    import torch
    from ppls_tpu_torch.models.integrands import (family_exact, get_family,
                                                  get_family_ds)
    t_phase = time.perf_counter()
    with open(os.path.join(out_dir, "chip_smoke_tools.txt"), "w"):
        pass

    def check_time(step):
        spent = time.perf_counter() - t_phase
        log(f"[smoke] 24: {step} at {spent:.1f} s")
        if spent > TOOLS_TIMEOUT:
            raise TimeoutError(f"phase 24 ran past its {TOOLS_TIMEOUT} s at "
                               f"{step} ({spent:.0f} s)")

    f_theta = get_family("sin_recip_scaled")
    f_ds = get_family_ds("sin_recip_scaled")
    out = {"attribution": tools_attribution(W, f_theta, f_ds, base,
                                            out_dir)}
    out["decomposition"] = tools_decompose(W, f_theta, f_ds, out_dir)
    check_time("24a")
    out["dd"] = tools_dd(W, family_exact, out_dir)
    check_time("24b")
    out["offline"] = tools_offline(ckpt_dir, artifacts)
    check_time("24c")
    out["k2_theta"], _, theta_launches = counted(
        W, lambda: tools_k2_theta(W, operation_counts))
    out["k2_theta_launches"] = theta_launches["run_segment_ee"]
    check_time("24d")
    out["profile_bag_us"] = tools_profile_bag(out_dir)
    torch.cuda.synchronize()
    check_time("24e")
    paths = ([v["launches"] for v in out["attribution"].values()]
             + [out["decomposition"]["launches"],
                out["dd"]["dd_launches"],
                out["dd"]["characterize_launches"]])
    out["launches"] = {k: sum(p[k] for p in paths)
                       for k in ("run_segment_rf", "run_segment_ee",
                                 "run_segment")}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] 24 done in {out['seconds']:.1f} s; the tools' launches "
        f"{out['launches']} (K3: the probes), K2 theta "
        f"{out['k2_theta_launches']}")
    return out


def tools_base(W, f_theta, f_ds, theta) -> dict:
    """Phases 4 and 6's runs for ``--phase 24`` alone: the flagship (K1)
    and its refill_slots=0 fallback (K2) with their launches."""
    kw = dict(capacity=CAPACITY, lanes=LANES, roots_per_lane=ROOTS_PER_LANE,
              device=DEVICE)
    out = {}
    for key, over in (("k1", dict(refill_slots=REFILL_SLOTS,
                                  double_buffer=True, scout_dtype="f32")),
                      ("k2", dict(refill_slots=0, scout_dtype="f64"))):
        res, _, launches = counted(W, lambda: W.integrate_family_walker(
            f_theta, f_ds, theta, BOUNDS, EPS, **kw, **over))
        kernel = "run_segment_rf" if key == "k1" else "run_segment_ee"
        out[key] = (res, launches[kernel])
    return out


def tools_serve_artifacts(W, TS, ckpt_dir) -> dict:
    """For ``--phase 24`` alone: phase 14a's serve command with a
    timeline (its ledger and events)."""
    ev = os.path.join(ckpt_dir, "serve_14_events.jsonl")
    run = run_cli(W, TS, serve_argv(events=ev))
    with open(ev) as fh:
        return dict(ledger=run["text"], events=fh.read())


# ---------------------------------------------------------------------------
# phase 25: the host-level ds library, exact segment sums on demand, the
# workers' distributed bootstrap
# ---------------------------------------------------------------------------


def f32_ulps(a, b) -> int:
    """The largest distance in float32 ulps between two float32 arrays
    (0 where bit-equal; NaNs at the same lanes count 0)."""
    import numpy as np
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)

    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs(ordered(a) - ordered(b))
    return int(np.max(np.where(both_nan, 0, d), initial=0))


def surface_ds_lib() -> dict:
    """25a: every function of the host-level ds library (ops/ds.py) on
    DS_LIB_N seeded pairs, on the card and on the CPU: bit-equal, or the
    function and its ulps named."""
    import numpy as np
    import torch
    from ppls_tpu_torch.ops import ds as DS
    rng = np.random.default_rng(25)
    n = DS_LIB_N

    def split(x):
        hi = x.astype(np.float32)
        return hi, (x - hi.astype(np.float64)).astype(np.float32)

    sign = rng.choice([-1.0, 1.0], n)
    x = split(rng.uniform(-100.0, 100.0, n))
    y = split(rng.uniform(0.1, 100.0, n) * sign)
    big = split(rng.uniform(-2e4, 2e4, n))
    ex = split(rng.uniform(-85.0, 5.0, n))
    cond = rng.random(n) < 0.5
    cases = {
        "two_sum": ("two_sum", (x[0], y[0])),
        "quick_two_sum": ("quick_two_sum", (x[0], y[1])),
        "two_prod": ("two_prod", (x[0], y[0])),
        "ds_neg": ("ds_neg", (x,)),
        "ds_add": ("ds_add", (x, y)),
        "ds_sub": ("ds_sub", (x, y)),
        "ds_add_f32": ("ds_add_f32", (x, y[0])),
        "ds_mul": ("ds_mul", (x, y)),
        "ds_mul_f32": ("ds_mul_f32", (x, y[0])),
        "ds_mul_pow2": ("ds_mul_pow2", (x, 0.125)),
        "ds_div": ("ds_div", (x, y)),
        "ds_abs": ("ds_abs", (y,)),
        "ds_lt": ("ds_lt", (x, (x[0], y[1]))),
        "ds_gt": ("ds_gt", (x, (x[0], y[1]))),
        "ds_where": ("ds_where", (cond, x, y)),
        "ds_sin": ("ds_sin", (big,)),
        "ds_cos": ("ds_cos", (big,)),
        "ds_exp": ("ds_exp", (ex,)),
        "ds_const": ("ds_const", (-1.0 / 3.0, x[0])),
        "ds_zero_like": ("ds_zero_like", (x[0],)),
    }

    def on(dev, v):
        if isinstance(v, tuple):
            return tuple(on(dev, p) for p in v)
        if isinstance(v, np.ndarray):
            return torch.from_numpy(v).to(dev)
        return v

    out, bad = {}, {}
    for name, (fn, args) in cases.items():
        got = []
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            r = getattr(DS, fn)(*on(dev, args))
            r = r if isinstance(r, tuple) else (r,)
            got.append([v.cpu().numpy() for v in r])
            if dev == DEVICE:
                torch.cuda.synchronize()
                card_s = time.perf_counter() - t0
        ulps = [0 if c.dtype == np.bool_ else f32_ulps(c, h)
                for c, h in zip(*got)]
        same = all(np.array_equal(c.view(np.uint8), h.view(np.uint8))
                   for c, h in zip(*got))
        out[name] = dict(bit_equal=same, ulps=ulps, card_s=card_s)
        if not same:
            bad[name] = ulps
    log(f"[smoke] 25a the ds library on {n} seeded pairs, card against "
        f"CPU: {len(cases) - len(bad)} of {len(cases)} functions "
        f"bit-equal{'' if not bad else f'; DIFFER (ulps per limb) {bad}'}")
    if bad:
        raise AssertionError(f"25a: card != CPU in {bad}")
    return out


def surface_segsum(W) -> dict:
    """25b: ``segment_sum_auto(force_exact=True)`` on the card (one card's
    m = SEGSUM_M against SEGSUM_SHARDS shards, and the CPU), then phase
    19's dd-leg family through the single walker on K1 and through K2
    with PPLS_EXACT_SEGSUM=1 and without it: the same schedule, areas
    within SEGSUM_AREA_TOL relative."""
    import numpy as np
    import torch
    from ppls_tpu_torch.models.integrands import get_family, get_family_ds
    from ppls_tpu_torch.ops import reduction as R
    rng = np.random.default_rng(26)
    n, m = SEGSUM_N, SEGSUM_M
    m_local = m // SEGSUM_SHARDS
    fam = rng.integers(0, m, n).astype(np.int32)
    leaf = rng.integers(-(1 << 20), 1 << 20, n) * 2.0 ** -24   # dyadic

    def forced(f, v, mm, dev):
        return R.segment_sum_auto(
            torch.from_numpy(f).to(dev), torch.from_numpy(v).to(dev), mm,
            len(v), force_exact=True).cpu().numpy()
    whole = forced(fam, leaf, m, DEVICE)
    shards_equal = []
    for d in range(SEGSUM_SHARDS):
        pick = (fam // m_local) == d
        local = forced(fam[pick] % m_local, leaf[pick], m_local, DEVICE)
        shards_equal.append(bool(np.array_equal(
            local, whole[d * m_local:(d + 1) * m_local])))
    truth = np.zeros(m)
    np.add.at(truth, fam, leaf)
    cpu_equal = bool(np.array_equal(whole, forced(fam, leaf, m, "cpu")))
    out = dict(shards_equal=shards_equal, cpu_equal=cpu_equal,
               truth_equal=bool(np.array_equal(whole, truth)))
    log(f"[smoke] 25b segment_sum_auto(force_exact=True) on the card: m "
        f"{m} against {SEGSUM_SHARDS} shards of {m_local}: slices "
        f"bit-equal {shards_equal}; = the CPU's {cpu_equal}; = the exact "
        f"sums {out['truth_equal']}")
    if not (all(shards_equal) and cpu_equal and out["truth_equal"]):
        raise AssertionError(f"25b: forced sums {out}")

    f_theta, f_ds = get_family(DD_FAMILY), get_family_ds(DD_FAMILY)
    theta = 1.0 + np.arange(DD_M) / DD_M
    launches = {"run_segment_rf": 0, "run_segment_ee": 0}
    prev = os.environ.get("PPLS_EXACT_SEGSUM")
    try:
        for leg, lkw in DD_LEGS.items():
            kernel = ("run_segment_rf" if lkw["refill_slots"]
                      else "run_segment_ee")
            runs = {}
            for knob in ("0", "1"):
                os.environ["PPLS_EXACT_SEGSUM"] = knob
                runs[knob] = counted(W, lambda: W.integrate_family_walker(
                    f_theta, f_ds, theta, BOUNDS, DD_EPS, **DD_KW, **lkw,
                    device=DEVICE))
                launches[kernel] += runs[knob][2][kernel]
            (a, wa, la), (b, wb, lb) = runs["0"], runs["1"]
            rel = float(np.max(np.abs(b.areas - a.areas)
                               / np.abs(a.areas)))
            rec = dict(tasks=(a.metrics.tasks, b.metrics.tasks),
                       kernel_steps=(a.kernel_steps, b.kernel_steps),
                       cycles=(a.cycles, b.cycles),
                       launches=(la[kernel], lb[kernel]), max_rel=rel,
                       walls=(wa, wb))
            out[leg] = rec
            log(f"[smoke] 25b {DD_M} thetas of {DD_FAMILY} (phase 19's dd "
                f"leg) on the single walker, {leg} ({kernel}): default / "
                f"PPLS_EXACT_SEGSUM=1 tasks {rec['tasks']}, kernel steps "
                f"{rec['kernel_steps']}, cycles {rec['cycles']}, launches "
                f"{rec['launches']}, areas {rel:.3e} apart relative (tol "
                f"{SEGSUM_AREA_TOL}); walls {wa:.3f} / {wb:.3f} s")
            if (len(set(rec["tasks"])) != 1
                    or len(set(rec["kernel_steps"])) != 1
                    or len(set(rec["cycles"])) != 1
                    or len(set(rec["launches"])) != 1
                    or rec["launches"][0] <= 0
                    or not rel <= SEGSUM_AREA_TOL):
                raise AssertionError(f"25b {leg}: {rec}")
    finally:
        if prev is None:
            os.environ.pop("PPLS_EXACT_SEGSUM", None)
        else:
            os.environ["PPLS_EXACT_SEGSUM"] = prev
    out["launches"] = launches
    return out


def surface_cluster() -> dict:
    """25c: a DIST_PROCESSES-worker ``ClusterStreamEngine(jax_distributed=
    True)`` sharing the card (the walk: K1 in every worker) beside the
    same cluster on the CPU, both started at once: the hellos' device
    pictures meet tests/test_cluster.py:478's invariants, DIST_K
    requests served with card = CPU records, every card worker launched
    K1, and no worker alive after ``close()``."""
    reqs = [(1.0 + i / 4.0, (0.0, 1.0)) for i in range(DIST_K)]
    started = start_clusters({dev: dict(
        family=MULTIHOST_FAMILY, eps=MULTIHOST_EPS,
        n_processes=DIST_PROCESSES,
        worker_kw=dict(MULTIHOST_WKW, f64_rounds=0), jax_distributed=True,
        device=dev, spawn_timeout=EXTRAS_TIMEOUT,
        rpc_timeout=EXTRAS_TIMEOUT) for dev in (DEVICE, "cpu")})
    got = {}
    try:
        for dev, (eng, start_s) in started.items():
            infos = [w.hello.get("jax_distributed") for w in eng._workers]
            res = eng.run(reqs)
            got[dev] = dict(
                infos=infos, start_s=start_s,
                records={c.rid: cluster_record(c) for c in res.completed},
                launches=eng.launches())
    finally:
        for eng, _ in started.values():
            eng.close()
    no_workers_left("25c")
    card, cpu = got[DEVICE], got["cpu"]
    k1 = {p: v["run_segment_rf"] for p, v in card["launches"].items()}
    problems = []
    for dev, g in ((DEVICE, card), ("cpu", cpu)):
        infos = g["infos"]
        platform = "cpu" if dev == "cpu" else "gpu"
        if (any(i is None for i in infos)
                or any(i["global_devices"]
                       != sum(j["local_devices"] for j in infos)
                       for i in infos)
                or sorted(i["process_id"] for i in infos)
                != list(range(DIST_PROCESSES))
                or any(i["platform"] != platform for i in infos)):
            problems.append(f"{dev} pictures {infos}")
    if card["records"] != cpu["records"] or len(card["records"]) != DIST_K:
        problems.append("records")
    if sorted(k1) != [str(p) for p in range(DIST_PROCESSES)] \
            or min(k1.values()) <= 0:
        problems.append(f"K1 launches {k1}")
    log(f"[smoke] 25c {DIST_PROCESSES}-worker cluster with "
        f"jax_distributed=True (one gloo group over the coordinator's "
        f"store, the workers sharing the card): pictures {card['infos']}; "
        f"{len(card['records'])} requests served, card = CPU records "
        f"{card['records'] == cpu['records']}; workers' K1 launches {k1}; "
        f"start {card['start_s']:.1f} s (card), {cpu['start_s']:.1f} s "
        f"(CPU); no worker alive after close()")
    if problems:
        raise AssertionError(f"25c: {problems}")
    return dict(card=card, cpu_infos=cpu["infos"],
                launches={"run_segment_rf": sum(k1.values()),
                          "run_segment_ee": sum(
                              v["run_segment_ee"]
                              for v in card["launches"].values())})


def phase_surface(W) -> dict:
    """25: the host-level ds library, exact segment sums on demand and the
    workers' distributed bootstrap (module docstring), bounded by
    ``EXTRAS_TIMEOUT``."""
    t_phase = time.perf_counter()

    def check_time(step):
        spent = time.perf_counter() - t_phase
        log(f"[smoke] 25: {step} at {spent:.1f} s")
        if spent > EXTRAS_TIMEOUT:
            raise TimeoutError(f"phase 25 ran past its {EXTRAS_TIMEOUT} s "
                               f"at {step} ({spent:.0f} s)")

    out = {"ds_lib": surface_ds_lib()}
    check_time("25a")
    out["segsum"] = surface_segsum(W)
    check_time("25b")
    out["cluster"] = surface_cluster()
    check_time("25c")
    out["launches"] = {k: out["segsum"]["launches"][k]
                       + out["cluster"]["launches"][k]
                       for k in ("run_segment_rf", "run_segment_ee")}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[smoke] 25 done in {out['seconds']:.1f} s; launches "
        f"{out['launches']}")
    return out


def main_phase(phase: str) -> int:
    """``python3 chip_smoke.py --phase 22`` (or ``23``, ``24``, ``25``):
    the build, its comparators and that phase, in one process. Phases 22
    and 23 compare with phase 11's single-engine ds stream (the median of
    three runs after a warm-up); phase 24 with phases 4 and 6's walks and
    phase 14a's serve command with a timeline; phase 25 needs none."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ppls_tpu_torch.models.integrands import get_family_ds
    from ppls_tpu_torch.parallel import walker as W
    from ppls_tpu_torch.runtime import stream as TS
    from ppls_tpu_torch.utils.cuda_build import load_all_kernels
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    kind, smi = torch.cuda.get_device_name(0), nvidia_smi_line()
    log(f"[smoke] device: {kind} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    load_all_kernels()
    log(f"[smoke] build: {time.perf_counter() - t0:.1f} s")
    ops = operation_counts(get_family_ds(STREAM_FAMILY))
    walls = []
    if phase in ("22", "23"):
        theta = 1.0 + np.arange(STREAM_K) / STREAM_K
        reqs = [(float(t), BOUNDS) for t in theta]
        kw = dict(STREAM_KW, scout_dtype="f64", device=DEVICE)
        TS.StreamEngine(STREAM_FAMILY, EPS, **kw).run(reqs)
        walls = [counted(W, lambda: TS.StreamEngine(STREAM_FAMILY, EPS,
                                                    **kw).run(reqs))[1]
                 for _ in range(3)]
        log(f"[smoke] single-engine ds stream (phase 11's, {STREAM_K} "
            f"requests): walls {', '.join(f'{w:.4f}' for w in walls)} s")
        stream_rep = {"ds_walk": {"wall_s": float(np.median(walls)),
                                  "walls": walls}}
    ckpt_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        if phase == "25":
            rep = phase_surface(W)
        elif phase == "24":
            from ppls_tpu_torch.models.integrands import get_family
            f_theta = get_family("sin_recip_scaled")
            base = tools_base(W, f_theta, get_family_ds("sin_recip_scaled"),
                              1.0 + np.arange(M) / M)
            rep = phase_tools(W, TS, ckpt_dir, out_dir, base,
                              tools_serve_artifacts(W, TS, ckpt_dir))
        elif phase == "22":
            with WorldStarts() as worlds:
                rep = phase_dispatch(W, TS, ckpt_dir, out_dir, ops,
                                     stream_rep)
            rep["worlds_started"] = worlds.as_dict()
            log(f"[smoke] worlds started: {worlds.as_dict()}")
        else:
            rep = phase_cluster(W, TS, ckpt_dir, stream_rep)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    rep.update(device=kind, smi=smi, single_engine_walls=walls)
    name = {"22": "dispatch", "23": "cluster", "24": "tools",
            "25": "surface"}[phase]
    with open(os.path.join(out_dir, f"chip_smoke_{name}.json"), "w") as fh:
        json.dump(rep, fh, indent=1, default=str)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import numpy as np
    import torch

    if sys.argv[1:] in (["--phase", "22"], ["--phase", "23"],
                        ["--phase", "24"], ["--phase", "25"]):
        return main_phase(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ppls_tpu_torch.config import Rule
    from ppls_tpu_torch.models.integrands import (family_exact, get_family,
                                                  get_family_ds)
    from ppls_tpu_torch.parallel import walker as W
    from ppls_tpu_torch.parallel.bag_engine import (integrate_family,
                                                    resume_family)
    from ppls_tpu_torch.runtime import stream as TS
    from ppls_tpu_torch.runtime import tune
    from ppls_tpu_torch.tools.profile_walker import kernel_ceiling_slope
    from ppls_tpu_torch.utils.cuda_build import load_all_kernels

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t_start = time.perf_counter()
    report = {}

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[smoke] device: {kind} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # 2. build, all kernels at once
    t0 = time.perf_counter()
    built = load_all_kernels()
    log(f"[smoke] build: {time.perf_counter() - t0:.1f} s for "
        f"{len(built)} kernels in parallel")
    regs = {}
    for name, b in built.items():
        log(f"[smoke] {name}: {b.build_seconds:.1f} s -> {b.path}")
        with open(os.path.join(out_dir, f"{name}_build.log"), "w") as fh:
            fh.write(b.log)
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[smoke]   ptxas: {line.strip()}")
        regs[name] = ptxas_registers(b.log)
    log(f"[smoke] top SM clock {sm_clock_ghz():.3f} GHz (nvidia-smi "
        f"clocks.max.sm): the dependent-chain estimates use it at "
        f"{DEP_LATENCY_CYCLES} cycles per operation")

    f_theta = get_family("sin_recip_scaled")
    f_ds = get_family_ds("sin_recip_scaled")
    theta = 1.0 + np.arange(M) / M
    exact = family_exact("sin_recip_scaled", *BOUNDS, theta)
    sample = np.arange(0, M, SAMPLE_STRIDE)

    # 3. kernels vs plain on the card
    ops = operation_counts(f_ds)
    dk = ops["dekker"]
    log(f"[smoke] float32 ops ({'FMA' if ops['fma'] else 'Dekker'} "
        f"two-products, as the kernels): ds eval {ops['ds_eval']}, scout "
        f"eval {ops['scout_eval']}, trapezoid step overhead "
        f"{ops['step_overhead']}, Simpson step overhead "
        f"{ops['simpson_overhead']}; dependent chains {ops['chain']}; with "
        f"Dekker two-products (the plain twins): {dk['ds_eval']}, "
        f"{dk['scout_eval']}, {dk['step_overhead']}, "
        f"{dk['simpson_overhead']}; chains {dk['chain']}")
    k1 = phase_k1(W, f_theta, f_ds, theta, ops)
    seeded = {rule: seeded_lanes(W, f_theta, theta, rule)
              for rule in (Rule.TRAPEZOID, Rule.SIMPSON)}
    k2, k2_blocks = phase_k2(W, f_ds, seeded, ops, regs["walk_ee"])
    k3 = phase_k3(W, f_ds, seeded, ops, regs["walk_seg"])
    barrier = phase_barrier(W, f_ds, seeded[Rule.TRAPEZOID], regs)
    probe = kernel_ceiling_slope(lanes=LANES)
    log(f"[smoke] K3 probe on restarted lanes that mostly park, not a "
        f"ceiling (lanes {LANES}, {probe['launches']} launches): "
        f"{probe['lane_steps_per_sec'] / 1e9:.3f} G lane-steps/s, "
        f"{probe['us_per_step']:.3f} us per step")
    log(f"[smoke] us per step, trapezoid, 256-step launches on the "
        f"flagship's lanes: K1 {k1['step']['us_per_step']:.3f} (its bank), "
        f"K2 {k2['step']['us_per_step']:.3f}, K3 "
        f"{k3['step']['us_per_step']:.3f} (all live); probe (mostly "
        f"parked) {probe['us_per_step']:.3f}; barrier share of K2's step "
        f"{barrier['barrier_share']:.3f}")
    f_theta_sc = get_family(THETA_FAMILY)
    f_ds_sc = get_family_ds(THETA_FAMILY)
    ops_sc = operation_counts(f_ds_sc)
    log(f"[smoke] float32 ops, {THETA_FAMILY}: ds eval {ops_sc['ds_eval']}, "
        f"scout eval {ops_sc['scout_eval']}, trapezoid step overhead "
        f"{ops_sc['step_overhead']}")
    k1_theta = phase_k1_theta(W, f_theta_sc, f_ds_sc, ops_sc)
    attribution = k1_attribution(k1, k2, barrier, k1_theta)
    log("[smoke] library_ms: no single PyTorch call computes a walk "
        "segment, so there is none")
    report.update(k1=k1, k2=k2, k3=k3, probe=probe, barrier_share=barrier,
                  k1_theta=k1_theta, k1_attribution=attribution,
                  registers=regs, k2_coresident_blocks=k2_blocks, ops=ops)

    # 4. main path, in-kernel refill: the flagship, scouting on,
    # double-buffered banks
    kw = dict(capacity=CAPACITY, lanes=LANES, refill_slots=REFILL_SLOTS,
              roots_per_lane=ROOTS_PER_LANE, double_buffer=True,
              device="cuda")
    res, wall, launches = main_path(W, f_theta, f_ds, theta,
                                    dict(kw, scout_dtype="f32"),
                                    W.run_segment_rf, "main path (K1)")
    mt = res.metrics
    areas = np.asarray(res.areas)
    att = res.attribution()
    log(f"[smoke] main path (K1): wall {wall:.3f} s, {mt.tasks} tasks "
        f"({mt.tasks / wall / 1e6:.2f} M tasks/s), kernel steps "
        f"{res.kernel_steps}, cycles {res.cycles}, launches {launches}, "
        f"host syncs {res.host_syncs} (per cycle "
        f"{res.host_syncs_per_cycle}), lane efficiency "
        f"{res.lane_efficiency:.4f}, walker fraction "
        f"{res.walker_fraction:.4f}, scout evals {res.scout_evals}, "
        f"confirm evals {res.confirm_evals}")
    log(f"[smoke] waste buckets: {att['buckets']}")

    # the same configuration with scouting off: the ds walk holds the
    # float64 bag. The scouting run's distance from the bag is printed
    # only; phase 5 checks its schedule.
    t0 = time.perf_counter()
    res_ds = W.integrate_family_walker(f_theta, f_ds, theta, BOUNDS, EPS,
                                       scout_dtype="f64", **kw)
    torch.cuda.synchronize()
    wall_ds = time.perf_counter() - t0
    bag = integrate_family(f_theta, theta[sample], BOUNDS, EPS,
                           capacity=1 << 22, device="cuda")
    d_exact = float(np.max(np.abs(areas - exact)))
    d_bag_ds = float(np.max(np.abs(np.asarray(res_ds.areas)[sample]
                                   - bag.areas)))
    d_bag = float(np.max(np.abs(areas[sample] - bag.areas)))
    err_w = float(np.max(np.abs(areas[sample] - exact[sample])))
    err_b = float(np.max(np.abs(bag.areas - exact[sample])))
    log(f"[smoke] scouting off: wall {wall_ds:.3f} s, "
        f"{res_ds.metrics.tasks} tasks, kernel steps "
        f"{res_ds.kernel_steps}, lane efficiency "
        f"{res_ds.lane_efficiency:.4f}; scouting on: "
        f"{mt.tasks - res_ds.metrics.tasks:+d} tasks")
    log(f"[smoke] on {len(sample)} members: max |walker(ds) - f64 bag| "
        f"{d_bag_ds:.3e} (tol {AREA_TOL_BAG}); max |walker(scout) - f64 "
        f"bag| {d_bag:.3e} (not held: over-refinement, phase 5); max "
        f"|walker(scout) - closed form| {err_w:.3e}, the bag's {err_b:.3e}; "
        f"all {M}: max |walker(scout) - closed form| {d_exact:.3e} (tol "
        f"{AREA_TOL_EXACT})")
    if not d_bag_ds < AREA_TOL_BAG:
        raise AssertionError("ds walk: areas disagree with the f64 bag")
    if not d_exact < AREA_TOL_EXACT:
        raise AssertionError("main path: areas disagree with closed form")
    report["main_k1"] = dict(
        wall_s=wall, tasks=mt.tasks, kernel_steps=res.kernel_steps,
        cycles=res.cycles, launches=launches, host_syncs=res.host_syncs,
        host_syncs_per_cycle=res.host_syncs_per_cycle, waste=att["buckets"],
        lane_efficiency=res.lane_efficiency,
        walker_fraction=res.walker_fraction,
        seg_stats=res.seg_stats.tolist(),
        cycle_stats=res.cycle_stats.tolist(),
        ds_run=dict(wall_s=wall_ds, tasks=res_ds.metrics.tasks,
                    kernel_steps=res_ds.kernel_steps,
                    waste=res_ds.attribution()["buckets"]),
        d_bag_ds=d_bag_ds, d_bag=d_bag, err_w=err_w, err_b=err_b,
        d_exact=d_exact)

    # 5. scout schedule: the card against the plain segment on the CPU at
    # the configuration where the CPU port reproduces the reference walker
    sub = theta[::SCHEDULE_STRIDE]
    skw = dict(kw, lanes=SCHEDULE_LANES, capacity=1 << 22,
               scout_dtype="f32")
    t0 = time.perf_counter()
    on_card = W.integrate_family_walker(f_theta, f_ds, sub, BOUNDS, EPS,
                                        **skw)
    # the CPU leg walks the card's cadence: the tuning table's rows are
    # keyed by device, and its cpu rows would give the CPU another one
    cad = tune.last_resolution()
    skw.update(device="cpu", exit_frac=cad["exit_frac"],
               suspend_frac=cad["suspend_frac"])
    on_cpu = W.integrate_family_walker(f_theta, f_ds, sub, BOUNDS, EPS,
                                       **skw)
    sub_bag = integrate_family(f_theta, sub, BOUNDS, EPS, capacity=1 << 22,
                               device="cuda")
    d_dev = float(np.max(np.abs(on_card.areas - on_cpu.areas)))
    log(f"[smoke] scout schedule on {len(sub)} members, "
        f"{SCHEDULE_LANES} lanes ({time.perf_counter() - t0:.1f} s): card "
        f"{on_card.metrics.tasks} tasks / {on_card.kernel_steps} steps, "
        f"CPU {on_cpu.metrics.tasks} / {on_cpu.kernel_steps}, max |card - "
        f"CPU| {d_dev:.3e} (tol {AREA_TOL_DEVICES}); vs the f64 bag: "
        f"{on_card.metrics.tasks - sub_bag.metrics.tasks:+d} tasks, |card "
        f"- bag| per member "
        f"{np.array2string(np.abs(on_card.areas - sub_bag.areas), precision=3)}")
    if (on_card.metrics.tasks != on_cpu.metrics.tasks
            or on_card.kernel_steps != on_cpu.kernel_steps
            or not np.array_equal(on_card.waste, on_cpu.waste)):
        raise AssertionError("scout schedule: card and CPU walks differ")
    if not d_dev < AREA_TOL_DEVICES:
        raise AssertionError("scout schedule: card and CPU areas differ")
    report["schedule"] = dict(tasks=on_card.metrics.tasks,
                              bag_tasks=sub_bag.metrics.tasks,
                              d_card_cpu=d_dev,
                              d_bag=np.abs(on_card.areas
                                           - sub_bag.areas).tolist())

    # 6. main path, boundary refill: the reference bench's fallback
    kw0 = dict(capacity=CAPACITY, lanes=LANES, refill_slots=0,
               roots_per_lane=ROOTS_PER_LANE, device="cuda")
    res0, wall0, launches0 = main_path(W, f_theta, f_ds, theta,
                                       dict(kw0, scout_dtype="f64"),
                                       W.run_segment_ee,
                                       "main path (K2)")
    # each kernel's launches over the two main paths' timed runs; K3 is
    # on neither (its only caller is the probe)
    main_launches = {k: launches[k] + launches0[k] for k in launches}
    if main_launches["run_segment"] != 0:
        raise AssertionError(f"K3 ran on a main path: {main_launches}")
    mt0 = res0.metrics
    areas0 = np.asarray(res0.areas)
    occ = res0.occupancy_summary()
    d_exact0 = float(np.max(np.abs(areas0 - exact)))
    d_bag0 = float(np.max(np.abs(areas0[sample] - bag.areas)))
    segments = int(res0.cycle_stats[:, W.CYCLE_STAT_FIELDS.index(
        "segments")].sum())
    log(f"[smoke] main path (K2): wall {wall0:.3f} s, {mt0.tasks} tasks "
        f"({mt0.tasks / wall0 / 1e6:.2f} M tasks/s), kernel steps "
        f"{res0.kernel_steps}, segments {segments}, cycles "
        f"{res0.cycles}, launches {launches0}, host syncs "
        f"{res0.host_syncs} (per cycle {res0.host_syncs_per_cycle}), lane "
        f"efficiency {res0.lane_efficiency:.4f}, est. occupancy "
        f"{occ['est_occupancy']}, walker fraction "
        f"{res0.walker_fraction:.4f}")
    log(f"[smoke] waste buckets: {res0.attribution()['buckets']}; "
        f"occupancy {occ}")
    log(f"[smoke] main path (K2): max |walker - f64 bag| on {len(sample)} "
        f"members {d_bag0:.3e} (tol {AREA_TOL_BAG}); all {M}: max |walker "
        f"- closed form| {d_exact0:.3e} (tol {AREA_TOL_EXACT})")
    if not d_bag0 < AREA_TOL_BAG:
        raise AssertionError("main path (K2): areas disagree with the bag")
    if not d_exact0 < AREA_TOL_EXACT:
        raise AssertionError("main path (K2): areas disagree with the "
                             "closed form")
    t0 = time.perf_counter()
    res0s = W.integrate_family_walker(f_theta, f_ds, theta, BOUNDS, EPS,
                                      scout_dtype="f32", **kw0)
    torch.cuda.synchronize()
    wall0s = time.perf_counter() - t0
    check_walk("boundary refill, scout f32", res0s, M)
    areas0s = np.asarray(res0s.areas)
    d_exact0s = float(np.max(np.abs(areas0s - exact)))
    d_bag0s = float(np.max(np.abs(areas0s[sample] - bag.areas)))
    log(f"[smoke] boundary refill, scout f32: wall {wall0s:.3f} s, "
        f"{res0s.metrics.tasks} tasks ({res0s.metrics.tasks - mt0.tasks:+d}"
        f"), kernel steps {res0s.kernel_steps}; max |walker - f64 bag| "
        f"{d_bag0s:.3e} (not held: over-refinement, phase 5); max |walker "
        f"- closed form| {d_exact0s:.3e} (tol {AREA_TOL_EXACT})")
    if not d_exact0s < AREA_TOL_EXACT:
        raise AssertionError("boundary refill, scout f32: areas disagree "
                             "with the closed form")
    report["main_k2"] = dict(
        wall_s=wall0, tasks=mt0.tasks, kernel_steps=res0.kernel_steps,
        segments=segments, cycles=res0.cycles,
        launches=launches0, host_syncs=res0.host_syncs,
        host_syncs_per_cycle=res0.host_syncs_per_cycle,
        waste=res0.attribution()["buckets"], occupancy=occ,
        lane_efficiency=res0.lane_efficiency,
        walker_fraction=res0.walker_fraction, d_bag=d_bag0,
        d_exact=d_exact0, seg_stats=res0.seg_stats.tolist(),
        scout_run=dict(wall_s=wall0s, tasks=res0s.metrics.tasks,
                       kernel_steps=res0s.kernel_steps, d_bag=d_bag0s,
                       d_exact=d_exact0s))

    # 7. Simpson: the reference's real-chip configuration, both refill
    # modes, against the float64 Simpson bag; then the full-width flagship
    s_theta = 1.0 + np.arange(4) / 4.0
    s_bounds, s_eps = (1e-2, 1.0), 1e-12
    s_kw = dict(capacity=1 << 16, lanes=256, roots_per_lane=1, seg_iters=32,
                min_active_frac=0.05, rule=Rule.SIMPSON, device="cuda")
    s_bag = integrate_family(f_theta, s_theta, s_bounds, s_eps,
                             rule=Rule.SIMPSON, chunk=1 << 10,
                             capacity=1 << 16, device="cuda")
    report["simpson_lane"] = {}
    for tag, over in (("boundary", {}),
                      ("in-kernel", dict(refill_slots=2, roots_per_lane=2))):
        r = W.integrate_family_walker(f_theta, f_ds, s_theta, s_bounds,
                                      s_eps, **dict(s_kw, **over))
        check_walk(f"Simpson lane config ({tag})", r, len(s_theta))
        d = float(np.max(np.abs(r.areas - s_bag.areas)))
        log(f"[smoke] Simpson lane config, {tag} refill: {r.metrics.tasks} "
            f"tasks (bag {s_bag.metrics.tasks}), max |walker - Simpson bag| "
            f"{d:.3e} (tol {AREA_TOL_SIMPSON}), walker fraction "
            f"{r.walker_fraction:.3f}")
        if r.metrics.tasks != s_bag.metrics.tasks or not d < AREA_TOL_SIMPSON:
            raise AssertionError(f"Simpson lane config ({tag}): walker and "
                                 f"Simpson bag differ")
        report["simpson_lane"][tag] = dict(tasks=r.metrics.tasks, d_bag=d)
    f_bag = integrate_family(f_theta, theta[sample], BOUNDS, EPS,
                             rule=Rule.SIMPSON, capacity=1 << 22,
                             device="cuda")
    report["simpson_flagship"] = {}
    for R in (0, REFILL_SLOTS):
        counter = W.run_segment_rf if R else W.run_segment_ee
        before = counter.launches
        t0 = time.perf_counter()
        r = W.integrate_family_walker(
            f_theta, f_ds, theta, BOUNDS, EPS, rule=Rule.SIMPSON,
            capacity=CAPACITY, lanes=LANES, refill_slots=R,
            roots_per_lane=ROOTS_PER_LANE, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        check_walk(f"Simpson flagship (R={R})", r, M)
        d_ex = float(np.max(np.abs(np.asarray(r.areas) - exact)))
        d_b = float(np.max(np.abs(np.asarray(r.areas)[sample]
                                  - f_bag.areas)))
        d_bag_ex = float(np.max(np.abs(f_bag.areas - exact[sample])))
        n = counter.launches - before
        log(f"[smoke] Simpson flagship, refill_slots={R}: wall {wall_s:.3f} "
            f"s, {r.metrics.tasks} tasks, kernel steps {r.kernel_steps}, "
            f"{counter.__name__} launches {n}; max |walker - closed form| "
            f"{d_ex:.3e} (tol {AREA_TOL_EXACT}); max |walker - Simpson bag| "
            f"on {len(sample)} members {d_b:.3e} (bag {f_bag.metrics.tasks} "
            f"tasks, {d_bag_ex:.3e} from the closed form there)")
        if n <= 0 or not d_ex < AREA_TOL_EXACT:
            raise AssertionError(f"Simpson flagship (R={R}) failed")
        report["simpson_flagship"][R] = dict(
            wall_s=wall_s, tasks=r.metrics.tasks,
            kernel_steps=r.kernel_steps, launches=n, d_exact=d_ex, d_bag=d_b,
            d_bag_exact=d_bag_ex)

    # 8. where the time goes: one more run of each main path, profiled
    report["profile_k1"] = profile_run(W, f_theta, f_ds, theta,
                                       dict(kw, scout_dtype="f32"),
                                       "walk_rf_kernel", out_dir, "k1")
    report["profile_k2"] = profile_run(W, f_theta, f_ds, theta,
                                       dict(kw0, scout_dtype="f64"),
                                       "walk_ee_kernel", out_dir, "k2")

    # 9. the reference's theta leg; 10. theta mode, card against CPU, and
    # the theta main path at full width
    report["theta_leg"] = phase_theta_leg(W, f_theta_sc, f_ds_sc,
                                          family_exact)
    report["theta_card_cpu"] = phase_theta_card_cpu(
        W, f_theta_sc, f_ds_sc, family_exact, out_dir)
    # 11. the streaming engine
    report["stream"] = phase_stream(W, TS, f_theta, f_ds, family_exact,
                                    out_dir)
    # 12. the integrand bodies K1, K2 and K3 gained, and the paths that
    # run them
    report["bodies"] = phase_bodies(W, operation_counts)
    report["reduced_flagship"] = phase_reduced_flagship(
        W, f_theta, theta, exact, sample, bag,
        dict(k1=areas, k1_ds=np.asarray(res_ds.areas), k2=areas0), kw, kw0,
        out_dir)
    red = report["reduced_flagship"]
    log(f"[smoke] main-path K1 (profiler): reduced twin "
        f"{red['profile_k1']['kernel_ms']:.1f} ms, reference twin "
        f"{report['profile_k1']['kernel_ms']:.1f} ms (phase 8); walls "
        f"{red['k1']['wall_s']:.3f} / {wall:.3f} s")
    report["reference_problem"] = phase_reference_problem(W)
    report["gauss"] = phase_gauss(W, integrate_family)
    report["multihost_quad"] = phase_multihost_quad(W, TS)
    report["reduced_stream"] = phase_reduced_stream(
        W, TS, f_theta, family_exact, report["stream"]["requests_per_sec"])
    # 13. checkpoint and kill-and-resume, on the card and card to CPU
    ckpt_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        wargs = (f_theta, f_ds, theta, BOUNDS, EPS)
        report["checkpoint"] = ckpt = dict(
            flagship=ckpt_walker(
                W, "flagship (K1)", wargs, dict(kw, scout_dtype="f32"), res,
                launches["run_segment_rf"], W.run_segment_rf, ckpt_dir),
            fallback=ckpt_walker(
                W, "fallback (K2)", wargs, dict(kw0, scout_dtype="f64"),
                res0, launches0["run_segment_ee"], W.run_segment_ee,
                ckpt_dir),
            bag=ckpt_bag(integrate_family, resume_family, get_family,
                         ckpt_dir),
            stream=ckpt_stream(W, TS, ckpt_dir),
            card_to_cpu=ckpt_card_to_cpu(W, ckpt_dir))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    # phase 13's launches: each walker's three runs, the stream's crashed
    # and resumed legs (both writers), gauss_center's card runs
    ckpt_launches = {
        "run_segment_rf": (
            sum(ckpt["flagship"]["launches"][k]
                for k in ("checkpointed", "crashed", "resumed"))
            + sum(ckpt["stream"][w]["launches"][k]
                  for w in ("synchronous", "background")
                  for k in ("crashed", "resumed"))),
        "run_segment_ee": (
            sum(ckpt["fallback"]["launches"][k]
                for k in ("checkpointed", "crashed", "resumed"))
            + ckpt["card_to_cpu"]["launches"]["run_segment_ee"]
            + ckpt["card_to_cpu"]["crash_launches"])}
    # 14. python -m ppls_tpu_torch serve (its snapshots in another
    # temporary directory of the checkout)
    serve_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        report["serve"] = phase_serve(W, TS, serve_dir)
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    serve_artifacts = report["serve"].pop("artifacts")
    serve_launches = report["serve"]["launches"]
    if serve_launches["run_segment"] != 0:
        raise AssertionError(f"K3 ran on the serve path: {serve_launches}")
    # 15. python -m ppls_tpu_torch and its family command
    cli_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        report["cli"] = phase_cli(W, TS, res, res0,
                                  dict(k1=wall, k2=wall0), cli_dir, smi)
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    cli_launches = report["cli"]["launches"]
    if cli_launches["run_segment"] != 0:
        raise AssertionError(f"K3 ran on the CLI path: {cli_launches}")
    # 16. the reference bench's pipeline, nan_policy, the sort options,
    # serve --adapt --slo-config, the tuning table's tier on the card
    bench_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        report["bench"] = phase_bench(W, TS, get_family_ds, dict(
            args=(f_theta, f_ds, theta, BOUNDS, EPS), kw=kw, kw0=kw0,
            k1=res, k1_launches=launches, k2=res0, k2_launches=launches0,
            exact=exact, sample=sample, bag=bag, ds_run=res_ds,
            ds_wall=wall_ds), out_dir, bench_dir)
    finally:
        shutil.rmtree(bench_dir, ignore_errors=True)
    bench_launches = report["bench"]["launches"]
    if bench_launches["run_segment"] != 0:
        raise AssertionError(f"K3 ran on phase 16's paths: {bench_launches}")
    # 17. the 2D cubature; 18. the QMC lattice (neither reaches a walk
    # kernel: their launches stay out of the kernel rows)
    before = {k.__name__: k.launches for k in (
        W.run_segment_rf, W.run_segment_ee, W.run_segment)}
    report["cubature_2d"] = phase_2d(out_dir)
    report["qmc"] = phase_qmc(out_dir)
    for k in (W.run_segment_rf, W.run_segment_ee, W.run_segment):
        if k.launches != before[k.__name__]:
            raise AssertionError(f"phases 17-18 launched {k.__name__}")
    # 19. the family engines across ranks: K1 and K2 at a rank's shapes,
    # then the dd walker and the sharded bag on 1 and 4 ranks
    dd_cmp = dd_kernels(W, ops)
    dd_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        report["dd"] = phase_dd(W, TS, dd_dir, out_dir)
    finally:
        shutil.rmtree(dd_dir, ignore_errors=True)
    report["dd"]["kernels"] = dd_cmp
    dd_l = report["dd"]["launches"]
    # 20. the tuning search on the card (K1); the wavefront, the 2D bag
    # and the QMC lattice across ranks (no walk kernel)
    across_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        report["across"] = phase_across(
            W, TS, dict(k1=res, k1_launches=launches, k2=res0,
                        k2_launches=launches0), report, across_dir, out_dir)
    finally:
        shutil.rmtree(across_dir, ignore_errors=True)
    tune_l = report["across"]["tune"]["launches"]
    if tune_l["run_segment"] != 0:
        raise AssertionError(f"K3 ran on the tuning sweep: {tune_l}")
    # 21. the walker-dd stream across ranks (K1 on every rank)
    dds_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        with WorldStarts() as w21:
            report["dd_stream"] = phase_dd_stream(W, TS, dds_dir, out_dir,
                                                  ops)
    finally:
        shutil.rmtree(dds_dir, ignore_errors=True)
    dds_l = sum(report["dd_stream"]["launches"].values())
    # 22. the pool dispatcher (K1, and K2 at refill_slots=0)
    disp_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        with WorldStarts() as w22:
            report["dispatch"] = phase_dispatch(W, TS, disp_dir, out_dir,
                                                ops, report["stream"])
    finally:
        shutil.rmtree(disp_dir, ignore_errors=True)
    disp_l = report["dispatch"]["launches"]
    report["worlds_started"] = {"21": w21.as_dict(), "22": w22.as_dict()}
    log(f"[smoke] worlds started: phase 21 {w21.spawned} with spawned ranks "
        f"and {w21.single} of one rank in "
        f"{report['dd_stream']['seconds']:.1f} s; phase 22 {w22.spawned} "
        f"and {w22.single} in {report['dispatch']['seconds']:.1f} s; "
        f"together {w21.spawned + w22.spawned} spawned")
    # 23. the multi-process cluster (K1 and K2 in worker processes)
    clus_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        report["cluster"] = phase_cluster(W, TS, clus_dir, report["stream"])
    finally:
        shutil.rmtree(clus_dir, ignore_errors=True)
    clus_l = report["cluster"]["launches"]
    # 24. the diagnosis and post-mortem tools (K1, K2, the K3 probe;
    # K2's theta variant)
    tools_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        report["tools"] = phase_tools(
            W, TS, tools_dir, out_dir,
            dict(k1=(res, launches["run_segment_rf"]),
                 k2=(res0, launches0["run_segment_ee"])), serve_artifacts)
    finally:
        shutil.rmtree(tools_dir, ignore_errors=True)
    tools_l = report["tools"]["launches"]
    # 25. the host-level ds library, exact segment sums on demand (K1 and
    # K2 on the walker's forced credit), the workers' distributed
    # bootstrap (K1 in the workers)
    report["surface"] = phase_surface(W)
    surf_l = report["surface"]["launches"]
    body_paths = (red["k1"]["launches"], red["k2"]["launches"],
                  report["reference_problem"]["launches"],
                  report["gauss"]["launches"],
                  report["multihost_quad"][2]["launches"],
                  report["multihost_quad"][0]["launches"],
                  report["reduced_stream"]["launches"])
    body_launches = {k: sum(p[k] for p in body_paths)
                     for k in main_launches}
    if body_launches["run_segment"] != 0:
        raise AssertionError(f"K3 ran on a main path: {body_launches}")
    stream_launches = report["stream"]["launches"]
    theta_launches = (sum(leg["launches"]["run_segment_rf"]
                          for leg in report["theta_leg"]["legs"].values())
                      + report["theta_card_cpu"]["wide"]["launches"][
                          "run_segment_rf"])
    report.update(device=kind, smi=smi,
                  total_s=time.perf_counter() - t_start)
    with open(os.path.join(out_dir, "chip_smoke_main.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    log(f"[smoke] total {time.perf_counter() - t_start:.1f} s")

    def bodies(kernel):
        """The kernel's phase 12a records per body and step machine."""
        out = {}
        for name, rec in report["bodies"].items():
            out[name] = {}
            for mode, c in rec[kernel].items():
                out[name][mode] = {f: c[f] for f in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "us_per_step",
                    "max_abs_err")}
                if "reference_twin" in c:
                    out[name][mode]["reference_twin_us_per_step"] = \
                        c["reference_twin"]["us_per_step"]
        return out

    def row(name, source, replaces, launches, cmp, mode, body, **extra):
        c = cmp[mode]
        errs = [v["max_abs_err"] for v in cmp.values()] + [
            v["max_abs_err"] for b in body.values() for v in b.values()] + [
            extra[k]["max_abs_err"] for k in ("dd", "dd_stream")
            if k in extra]
        disp = extra.get("dispatch", {})
        errs += [v["max_abs_err"] for v in (
            [disp] if "max_abs_err" in disp else disp.values())]
        errs += [v["max_abs_err"] for v in extra.get("theta", {}).values()]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": None, "bodies": body, **extra}

    theta_rows = {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "us_per_step",
                                         "max_abs_err")}
                  for k, v in k1_theta.items()}
    theta_k2_rows = {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "us_per_step",
                                            "max_abs_err", "counters")}
                     for k, v in report["tools"]["k2_theta"].items()}

    def dd_row(c):
        """A kernel's record at a dd rank's shapes (19k)."""
        return {f: c[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "us_per_step", "max_abs_err")}

    def steps_256(cmp):
        """The 256-step launches of phase 3, per step machine."""
        return {mode: {f: c[f] for f in ("ms", "us_per_step", "bound_ms")}
                | {"steps": c["counters"][0]}
            for mode, c in cmp.items()}
    print(json.dumps({"kernels": [
        row("walk_rf", "ppls_tpu_torch/csrc/walk_rf.cu",
            "ppls_tpu/parallel/walker.py:993",
            main_launches["run_segment_rf"] + theta_launches
            + stream_launches["run_segment_rf"]
            + body_launches["run_segment_rf"]
            + ckpt_launches["run_segment_rf"]
            + serve_launches["run_segment_rf"]
            + cli_launches["run_segment_rf"]
            + bench_launches["run_segment_rf"] + dd_l["run_segment_rf"]
            + tune_l["run_segment_rf"] + dds_l + disp_l["run_segment_rf"]
            + clus_l["run_segment_rf"] + tools_l["run_segment_rf"]
            + surf_l["run_segment_rf"],
            {**k1, **k1_theta}, "step_scout", bodies("k1"),
            flagship_launches=main_launches["run_segment_rf"],
            theta_launches=theta_launches,
            stream_launches=stream_launches["run_segment_rf"],
            body_launches=body_launches["run_segment_rf"],
            checkpoint_launches=ckpt_launches["run_segment_rf"],
            serve_launches=serve_launches["run_segment_rf"],
            cli_launches=cli_launches["run_segment_rf"],
            bench_launches=bench_launches["run_segment_rf"],
            dd_launches=dd_l["run_segment_rf"], dd=dd_row(dd_cmp["k1"]),
            tune_launches=tune_l["run_segment_rf"],
            dd_stream_launches=dds_l,
            dd_stream=dd_row(report["dd_stream"]["k1"]),
            dispatch_launches=disp_l["run_segment_rf"],
            dispatch={k: dd_row(report["dispatch"]["kernels"][k])
                      for k in ("k1", "k1_simpson")},
            cluster_launches=clus_l["run_segment_rf"],
            tools_launches=tools_l["run_segment_rf"],
            surface_launches=surf_l["run_segment_rf"],
            stream_main_path_ms=report["stream"]["profile"]["kernel_ms"],
            theta=theta_rows,
            step_attribution=attribution,
            main_path_ms=report["profile_k1"]["kernel_ms"],
            reduced_main_path_ms=red["profile_k1"]["kernel_ms"],
            steps_256=steps_256(k1), registers=regs["walk_rf"]),
        row("walk_ee", "ppls_tpu_torch/csrc/walk_ee.cu",
            "ppls_tpu/parallel/walker.py:1279",
            main_launches["run_segment_ee"] + body_launches["run_segment_ee"]
            + ckpt_launches["run_segment_ee"]
            + serve_launches["run_segment_ee"]
            + cli_launches["run_segment_ee"]
            + bench_launches["run_segment_ee"] + dd_l["run_segment_ee"]
            + tune_l["run_segment_ee"] + disp_l["run_segment_ee"]
            + clus_l["run_segment_ee"] + tools_l["run_segment_ee"]
            + surf_l["run_segment_ee"],
            k2, "step", bodies("k2"),
            body_launches=body_launches["run_segment_ee"],
            checkpoint_launches=ckpt_launches["run_segment_ee"],
            serve_launches=serve_launches["run_segment_ee"],
            cli_launches=cli_launches["run_segment_ee"],
            bench_launches=bench_launches["run_segment_ee"],
            dd_launches=dd_l["run_segment_ee"], dd=dd_row(dd_cmp["k2"]),
            dispatch_launches=disp_l["run_segment_ee"],
            dispatch=dd_row(report["dispatch"]["kernels"]["k2"]),
            cluster_launches=clus_l["run_segment_ee"],
            tools_launches=tools_l["run_segment_ee"],
            surface_launches=surf_l["run_segment_ee"],
            theta_launches=report["tools"]["k2_theta_launches"],
            theta=theta_k2_rows,
            stream_launches=report["stream"]["overload"]["k2"]["launches"],
            main_path_ms=report["profile_k2"]["kernel_ms"],
            main_path_launches=launches0["run_segment_ee"],
            main_path_steps=res0.kernel_steps, steps_256=steps_256(k2),
            barrier=barrier, registers=regs["walk_ee"],
            coresident_blocks_min=min(k2_blocks.values())),
        row("walk_seg", "ppls_tpu_torch/csrc/walk_seg.cu",
            "ppls_tpu/parallel/walker.py:1253",
            main_launches["run_segment"], k3, "step", bodies("k3"),
            probe_launches=probe["launches"],
            tools_probe_launches=tools_l["run_segment"],
            steps_256=steps_256(k3),
            registers=regs["walk_seg"]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
