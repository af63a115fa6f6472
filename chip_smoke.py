#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one card and check them.

    python3 chip_smoke.py                      # on a machine with one H100

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device    — the card's name and power limit (nvidia-smi) and torch's name.
2. build     — nvcc builds the hand-written kernels from the sources in this
               checkout (skellysim_tpu_torch/csrc/*.cu, one nvcc per source,
               started together); prints seconds and the `-Xptxas -v` report
               (registers, spills), and fails on a spill, or an empty report,
               in kernels A / B (stokeslet_sums.cu), C / D
               (stresslet_sums.cu), E / F (ring_sums.cu) or G / H
               (tree_sums.cu).
3. kernels   — kernels A and B (Stokeslet, csrc/stokeslet_sums.cu) at the
               free-space path's shape (the 640,000 fiber nodes of the
               10k-fiber config as sources and as targets), by
               `design_check`: error against the plain f64 sum on 4,096
               target rows drawn at random and each plan's last target
               block (R x 128 rows; the plain times are those rows'),
               against the first design on every row, two launches bit
               for bit, and time (CUDA events after a warm-up:
               the median of 3 rounds of 3 launches, with the SM clock and
               temperature nvidia-smi reads right after) in turns with
               their first design, the tiled yardstick of csrc/pair_sums.cu
               (old, new, new, old); the plan, both designs' registers and
               shared bytes, the hot loop's instructions a pair of both
               designs counted from `cuobjdump -sass` and the issue-slot
               bound they give at the SM clock read; B's reciprocal square
               root against 1/sqrt; plain time, and the flop bound.
4. run       — the repo's 10k-fiber x 64-node free-space config
               (examples/free_fibers_10k/gen_config.py's recipe, with
               refine_pair_impl="pallas_df", one step with its frame) written with
               the port's own Config; every launch count set to 0, then
               `python -m skellysim_tpu_torch` in this process; the counts,
               per-step metrics and peak device memory are read and the
               trajectory is decoded with the port's own reader. (The CLI
               builds no mesh, so its pair_evaluator = "ring" runs direct.)
5. check     — a small coupled scene (a ~200-node spherical shell holding
               one sphere body with 8 bound fibers, plus free fibers) takes
               one mixed step on the card (kernels) and on the CPU (plain
               versions); the two agree to 1e-8.
6. confined  — the repo's ellipsoid config (examples/ellipsoid/gen_config.py:
               2,000 clamped fibers x 64 nodes inside an 8,000-node
               ellipsoidal shell, three steps of dt = 8e-3) written with the
               port's schema in a temporary directory outside the checkout;
               `python -m skellysim_tpu_torch.precompute` on the card (seconds of quadrature / assembly / inverse and
               ||M M_inv - I|| on 8 columns); kernels C and D (stresslet,
               csrc/stresslet_sums.cu) checked and timed like A and B in 3
               (`design_check`), with the shell's 8,000 nodes as sources
               and the 128,000 fiber nodes as targets; then the run, as in
               4, gated on every step accepted with true residual <=
               gmres_tol and health 0, on kernels A-D launching, and on
               frames that carry a finite shell density of 3 x 8,000
               values; then `python -m skellysim_tpu_torch --profile DIR
               --trace-file T` on the same config for two steps in a
               process of its own (`profile_cli`), with `python -m
               skellysim_tpu_torch.obs profile DIR --json` and `... timeline
               T --profile DIR -o OUT` after it (in the smoke's process):
               gated on its frames being
               the bits of the run's first frames, A-D present by name in
               `by_op`, >= 90% of the device time attributed to named
               phases, the shares summing to 1, T holding `device_phase`
               events and no `device_phase_error`, and the timeline holding
               a host and a device track; it prints the phase table, A-D's
               launches and device time, the card's busy share of the
               profiled loop, the dump's size and the parses' seconds.
               Before the run, A and B are checked and timed at
               the shape the run launches them with (the fiber nodes as
               sources, every node as targets: 128,000 x 136,000, a partial
               last target block, many source chunks) and with every node
               as sources and targets (136,000: a partial last source
               tile), each against the plain f64 sum on every row.
7. ring kernels — kernels E and F (the fused ring, 4 shards on the card):
               E with phase 3's 640,000 fiber nodes as sources and targets,
               F with phase 6's 8,000 shell nodes as sources and its 128,000
               fiber nodes as targets; each timed like phase 3 in turns with
               its first design (the `_v1` yardstick: old, new, new, old),
               held against its plain version (the ring accumulation over
               A's / C's plain block) on target rows sampled from every
               shard (each shard's last target block of R x 128 rows
               included), against kernel A's / C's full output and against
               the yardstick's on the same f32 inputs (1e-4 of max|u|), two
               launches bit for bit; its plan (R, chunks, grid a shard, busy
               share, scratch) printed, and both designs' hot-loop SASS
               instructions a pair counted with their issue-slot bounds;
               then E, F, E back to back with no host sync, each bit for
               bit its lone call.
8. ring run  — the ellipsoid config with pair_evaluator = "ring", built with
               `build_simulation(cfg, mesh=make_mesh(4, device=card))` on
               phase 6's precompute and stepped three times by `System.run`:
               gated like phase 6, on E, F, B and D launching and A and C
               launching 0 times, and on final fiber positions within 1e-6
               of phase 6's direct run. Then E and F are checked and timed
               as in 7 at the shapes this run launched them with (E:
               128,000 sources x 136,000 targets, a partial last target
               block in every shard), and B and D are checked on every row
               and timed at one f64-grade hop's shape (B 32,000 x 34,000,
               D 2,000 x 32,000).
10. ellipsoid_di — run after 8, on phase 6's shell precompute (then 9):
               a centrosome nucleating microtubules inside the cortex,
               phase 6's config plus one 600-node sphere of radius 0.5 at
               the origin with --di-sites (1,000) nucleation sites
               (`Body.generate_nucleation_sites`) and dynamic instability
               at the fibers' 64 nodes (v_growth 0.2, f_catastrophe 0.5,
               nucleation_rate 25, min_length 0.5); the body precomputed
               alone; `python -m skellysim_tpu_torch` for one step, then
               `--resume` with t_final raised for one more (cut from two
               and two). Gated on every
               step accepted, converged and healthy; nucleation and the
               fiber capacity passing the rung above the initial count
               (2,048 at full width); active = previous + nucleations -
               catastrophes each step; every frame's fiber count, bound
               minus ends within 1e-6 of their lab-frame sites, no site
               shared; across the resume a later first appended frame, a
               continued fiber, the RNG counters restored from the last
               frame and one metrics marker; A-D launching. Prints per
               step the wall, iterations, capacity, active fibers and the
               DI update's host seconds, the calls of A-D by shape and peak
               memory; then A-D checked and timed at every shape the run
               launched them with, on the last frame's state (A / B: the
               grown capacity's fiber slots and the body's centre of mass
               as sources; C / D: the shell's and the body's double
               layers), and gated on every launch's shape being checked.
9. bodies    — examples/stokes_tests/body_const_force (one 600-node sphere,
               force (0, 0, 1), three steps of dt = 0.1) precomputed and run
               the same way; the body's velocity must meet the reference's
               Stokes-drag gate |1 - v / (F / 6 pi eta r_eff)| < 1e-6, and
               kernels C and D must launch; then C and D are checked on
               every row and timed at the body's 600 x 600.

11. fast evaluators — run after 10, on phase 3's cloud and phase 6's
               precompute: the Ewald ("FMM") and spectral ("PVFMM") sums,
               plain PyTorch and torch.fft (no kernel of their own):
               a. the Ewald Stokeslet of phase 3's 640,000 nodes at tol
               1e-6 (host plan seconds, near mode, K, M, P), f32 and f64:
               the entry sum (`PairEvaluator.stokeslet`, what every flow
               calls) on the first 40 target blocks (cut from 100)
               against kernel B on
               those rows (rel 2-norm gates 3e-3 f32, 1e-5 f64), and its
               stages timed apart: near field, spread, FFTs and multiply,
               interp (each the median of 3 after a warm-up; the near
               field on those blocks, each block the same work, and scaled
               to all), beside kernel A's phase-3 time, two calls
               compared; the Ewald stresslet entry at phase 6's shape
               (8,000 shell nodes onto 136,000 nodes) against kernel D on
               every row, at tol 1e-6 (System's; gates 3e-2 f32, 2e-3
               f64) and 1e-8 (3e-2, 1e-5), beside kernel C's time.
               b. the 10k recipe cut to 500 fibers at its density through
               pair_evaluator = "FMM", one CLI step: gated like 4, on A
               launching 0 times and B launching; plan seconds printed.
               c. phase 6's ellipsoid config cut to its first 250 fibers
               (from 500)
               (its full 8,000-node shell and precompute), one direct
               step and one through "FMM": A and C launch 0 times in the
               latter (the shell is above ewald_min_sources), B and D
               launch, and the fibers end within 1e-5 of the direct
               step's.
               d. the spectral Stokeslet entry of the 640k cloud in the
               periodic box of side 20, f64, at tol 1e-6 and 1e-9, split
               and timed as in a: against a dense periodic oracle (plain
               real-space and wave-space sums) on 512 rows (gates 1e-5,
               1e-6) and 1e-6 against 1e-9 on every row (1e-5); then the
               recipe's fibers bent into arcs in its box made periodic
               through "PVFMM", one step cut to 2,000 fibers (from the
               full width's 10,000) in "full" and one cut to 2,000 fibers
               in "mixed", each at the recipe's density: gated as b, on A
               and B
               launching 0 times and on each step taking 2 or more
               iterations (a coupled solve).
               e. one "full" f64 step on the card and on the CPU of the
               small coupled scene through "ewald" (ewald_min_sources 150
               below its 200-node shell) and of 8 arcs in a periodic box
               of side 4 through "spectral": they agree to 1e-8.
               It prints {"fast_evaluators": {...}} before the kernels
               line.
12. treecode — run after 11, on phase 3's cloud and phase 6's precompute:
               the barycentric treecode (pair_evaluator = "tree"), its
               upward pass plain PyTorch and its near and far pair sums
               in kernels G (Stokeslet) and H (stresslet),
               csrc/tree_sums.cu:
               a. the tree Stokeslet of phase 3's 640,000 nodes at tol
               1e-4 and 1e-6, f32 and f64: the plan (host seconds, depth,
               order, max_occ, maxI), the entry sum against kernel B on
               every row by the JAX tests' field-normalized error (gates
               plan.tol in f64, max(plan.tol, 1e-5) in f32), its stages
               timed apart with CUDA events (one sum with the step's
               geometry kept and one with a fresh evaluator, gated equal
               bit for bit; the geometry alone; the payload's bucket
               scatter and upward pass; G on the near lists alone, the
               far lists alone and both), the real near and far pairs and
               the lane pairs issued (and the first design's), G's rate
               beside kernel A's / B's phase-3 times; gated on no leaf
               holding more than max_occ sources and on two launches bit
               for bit. At tol 1e-4, G timed in turns with its first
               design `tree_*_v1` over its own items (old, new, new, old)
               and held within the twin's gate of it.
               b. the tree stresslet (H) at phase 6's shape (8,000 shell
               nodes onto 136,000 nodes) at tol 1e-4, the same way,
               against kernel D (gate 10 x plan.tol: the double layer
               runs a few times the Stokeslet-calibrated tol), beside C's
               and D's times.
               c. G and H against their plain twin on the card, on a cut
               of whole target leaves of a's and b's lists (1e-5 of the
               largest velocity in f32, 1e-12 in f64); both designs' hot
               loop SASS, issue-slot bounds (real pairs and lane pairs),
               registers, shared bytes and spills.
               d. phase 6's ellipsoid config through "tree", one CLI step
               on its precompute in "mixed" (the card's "auto": G and H in
               f32, A and C 0 launches, B and D the f64 prep flows and
               refinement) and in "full" (G and H in f64), each gated
               like 11c on the fibers within 1e-5 of phase 6's first step;
               then the "mixed" config profiled like phase 6's (two CLI
               steps under --profile, `profile_cli`), gated besides on G
               and H in `by_op` with every launch under a Krylov phase's
               tree pass (`gmres/.../near/far`: one launch serves both
               lists) and B and D under `prep` and `gmres/refine`. At tol
               1e-4 G / H are also timed on each target-
               lane class's items alone.
               e. the 10k recipe's fibers bent into arcs (curvature 0.5),
               free space, through "tree" cut to 4,000 fibers at the
               recipe's density (from the full width's 10,000) in
               "mixed", one CLI step gated on its own result (accepted, true residual
               <= 1e-8, health 0, 2 or more iterations; A 0 launches).
               f. (run before e) the small coupled scene through "tree"
               (its shell and body too): one matvec's f32 pair flows
               once, to build the step's geometry, then again under
               torch.cuda.set_sync_debug_mode("error"), gated on no host
               sync, the same bits and G and H launching.
               It prints {"treecode": {...}} before the kernels line.
13. spmd     — run after 12, on phase 6's precompute: the sharded step
               (System.step_spmd, skellysim_tpu_torch/parallel/spmd.py)
               on 4 shards of the card (`make_mesh(4, device=card)`,
               `shard_state`: views, nothing copied), each step held
               against System.step from the same state (true residuals
               within 5e-9, __graft_entry__.py:83 PARITY_GATE; fibers
               within 1e-6), each timed to a synchronize with its own peak
               device memory, the sharded step's launches counted from 0:
               a. the ellipsoid config, three "mixed" steps (E / F the
               f32 ring, B / D a hop the f64 prep and refinement) and one
               "full" (B / D); the state's bytes a shard; the host syncs
               of one Krylov matvec and preconditioner application
               (torch.cuda.set_sync_debug_mode("warn")).
               b. the same plus a 600-node sphere at the centre with 16
               bound 16-node fibers (a second bucket): one "mixed" step,
               gated on the body's fields the same bits on all 4 shards
               and on A / C (the replicated rows' partials) launching.
               c. "tree", one "full" step from a's state before its
               "full" step: G on every shard, no NaN on any shard, fibers
               within 1e-5 of a's direct "full" step.
               Besides, one "full" step from the initial state on the 4
               shards: phase 14's second reference (its first: a's first
               "mixed" step).
               It prints {"spmd": {...}} before the kernels line.
14. spmd processes — run after 13, on phase 6's precompute: the sharded
               step across processes (skellysim_tpu_torch/parallel/
               multihost.py). Two worker processes of this script
               (`--spmd-worker`, started with subprocess) share the card,
               joined by `parallel.multihost.initialize` over gloo (NCCL
               refuses two processes on one card), each holding 2 of the 4
               shards of one mesh; the fused ring's layout rule
               (`compat.fused_ring_mode`) sends their ring hop by hop
               (A / C or B / D a hop, the hops between the processes by
               `batch_isend_irecv` staged through the host). Each builds
               phase 6's config, keeps its rows, and takes one "full" and
               one "mixed" step from that state, held against phase 13's
               one-process steps from the same state: "full" (B / D a hop
               on both sides) for the same bits (else its largest gap is
               printed), "mixed" (phase 13's rings through E / F) within
               PARITY_GATE in true residual and fibers within 1e-6; both
               processes' fibers the same bits. It prints each process's
               wall a step, the iterations, A-F's launches by process, the
               bytes staged through the host a step and the peak GiB; a
               worker that fails or outlives 300 s fails the phase. Its
               summary is {"spmd": {"processes": ...}}.
15. ensemble — run after 9: the batched ensemble through its front door.
               The member scene (`make_ensemble_config`): a sphere cortex
               of radius 3 with 2,000 quadrature nodes, a 400-node sphere
               body of radius 0.5 at the centre with 256 nucleation sites
               (`Body.generate_nucleation_sites`), 128 clamped 32-node
               fibers with motors on its first sites (the 128 capacity
               rung), dynamic instability at 32 nodes (v_growth 0.2,
               f_catastrophe 0.5, min_length 0.5, nucleation rate 5),
               "mixed", 4 rounds of dt = 0.01; precomputed on the card; a
               sweep of 8 replicas through 8 lanes (each member its own
               `SimRNG.member(i)` stream); `python -m
               skellysim_tpu_torch.ensemble --profile DIR` in this process
               ("vmap"; `--profile` on the card only), every launch count
               set to 0 just before; its dump parsed with A-D present and
               every launch of theirs under a named phase (the round walls
               below are under the profiler). Gated on every
               member finishing its rounds converged (true residual <=
               gmres_tol) with health 0, nucleation and a growth reseat
               happening, active = previous + nucleations - catastrophes a
               member a round, every trajectory read back (a finite frame
               a round with the round's active fibers), a start, step and
               retire record a member, A-D launching only through their
               member-batched wrappers (the lone ones 0 times). Members 0
               and 5 then run alone through `System` from their admitted
               states and streams (`ensemble_solo`): each "mixed" round
               within 1e-8 of the batched member's frame and its true
               residual <= gmres_tol (iterations printed beside); one
               "full" round (the shell preconditioner inverted in f64)
               with equal iterations and fibers within 1e-10; one
               "unroll" round of the two the solo rounds' bits. It prints
               per round the wall, lanes, capacity, iterations, active
               fibers, DI host seconds, A-D calls by (members, sources,
               targets) and peak memory; then A-D are checked at every
               batched shape the run launched (`batched_check`: against
               the plain f64 sum on sampled rows of every member, member
               by member against the lone launch, bit for bit at the lone
               plan's chunks, twice bit for bit, timed beside the B lone
               launches, with their flop and issue-slot bounds). It
               prints {"ensemble": ...} before the kernels line; A-D's
               entries carry the checks under "at_ensemble_shapes" and the
               batched launches under "launches_ensemble_batched".

16. options  — the step's solver and precision options, a-c run after 14
               on phase 6's precompute and phase 3's cloud, d after 15:
               a. phase 6's ellipsoid (its first state) one "full" and
               one "mixed" step at gmres_block_s = 4 against the
               block_s = 1 step (iterations, sweeps, true residual <=
               1e-8, no stagnation or nonfinite bit, fibers within 1e-6),
               then the same through `System.step_spmd` on 4 shards of
               the card with the reductions counted at the sharded
               solve's rdot seam (two batched Gram reductions a round; in
               "full" the entry norm and two norms a cycle besides),
               printed beside `collective_rounds`.
               b. the guard ladder, every stage armed (two dt halvings,
               the block fallback, the f64 fallback) in "mixed" at
               gmres_block_s = 4 and gmres_maxiter 16: under
               `chaos.zero_preconditioner` a stagnation verdict, 4
               retries and dt / 4; under `chaos.poison_state` a nonfinite
               verdict and no retry; unpatched, no retry and a's "mixed"
               s-step bit for bit.
               c. the "df" and "mxu" tiles (plain torch, as the JAX
               package computes them outside Pallas): two_sum / two_prod
               exact on 4M float32 pairs of the card; the float32 mxu
               Stokeslet on the JAX package's own envelope cloud within
               1e-2 of B (and A within 5e-5); the Stokeslet at phase 3's
               cloud cut to 32,768 nodes (from 65,536) and the stresslet at
               phase 6's 8,000 x 128,000: df (float64 in) within 1e-12 of B / D and
               mxu in float64 within 1e-9 (norms), mxu in float32 printed,
               each timed beside A / B or C / D, no kernel launched by
               either tile.
               d. phase 15's 8 members (on the next rung, the shell
               preconditioner inverted in f64) on a member mesh of 2
               shards of the card, 2 "full" rounds in "vmap" and in
               "unroll" against the one-card rounds: equal iterations,
               the one-card bits where the shards' launches took the
               one-card round's plans (always in "unroll"), else within
               1e-11 (a "vmap" shard's member-batched plans may split
               the sources otherwise); each round's case and walls
               printed beside the one-card round's.
               It prints {"options": ...} before the kernels line.
17. flight + listener — run after 16d, on phase 6's precompute and trajectory
               and phase 15's members; the listener process starts after
               a's timed steps and loads beside the rest of a and b:
               a. phase 6's ellipsoid in "mixed" with flight_window 32: 3
               steps armed against 3 unarmed from the same state, alone on
               the card, in alternating order (states and solutions the
               same bits; the armed - unarmed walls printed with their
               spread), each ring row against
               `obs.flight.record_step` recomputed on the CPU from copies
               of the same (entry, new) states (ids exactly, floats within
               1e-6), `record_step` again under
               `torch.cuda.set_sync_debug_mode("error")` (no host sync), a
               NaN at fiber 17 node 5 (the nonfinite bit, provenance (1,
               17, 5)); phase 13b's scene on 4 shards of the card, armed
               (every shard's ring the same bits, ids equal to the one-card
               row, floats within 1e-6, body_norm > 0); phase 15's 8
               members armed, two "vmap" rounds, one lane poisoned after
               the first (its failed record names fiber_x; the other
               lanes' rows carry no provenance), and the blast-radius
               report of their records.
               b. `System.velocity_field` of phase 6's last frame at
               262,144 grid targets over the shell's box (the frame's
               sources once and the pair sums at the targets, each timed
               with its launches, B and D launching); the frame cut to 200
               fibers at 4,096 of the targets, card against CPU: the pair
               sums from the same sources within 1e-10, the whole path
               (each side's own force densities) within 1e-8; through
               "tree" against direct within 10 x tree_tol
               (G and H launching); on the body-drag scene after one step,
               64 probes inside the body against v + omega x dx within
               1e-12.
               c. `python -m skellysim_tpu_torch --listen` driven by
               `io.Listener` over phase 6's trajectory: 64 streamline and
               16 vortex-line seeds and a 128 x 128 slice on its last
               frame (every line finite, each forward leg at its seed; the
               slice within 1e-12 of `velocity_at_targets` in this
               process); the same through "tree" (the slice within 10 x
               tree_tol); an invalid frame and an unknown evaluator
               answered empty, the request after them answered; the
               terminate frame (exit code 0). Each request's server wall,
               integrator steps, velocity evaluations and launches are
               printed from the server's log.
               It prints {"flight_listener": ...} before the kernels line.
18. serve    — after 17, on phase 15's scene and phase 6's first state:
               a. 10 DI tenants (phase 15's member scene without its
               cortex: serve tenants bring no periphery; seed and site
               draw differ) submitted to an in-process
               `serve.server.SimulationServer` ("vmap", --ensemble-lanes
               lanes, bucket_count 2 on the geometric ladder: capacities
               128 and 256, queue_depth 4, a journal), driven by
               `handle_request` / `tick`, the kernel libraries dropped
               first so that the warm-up loads them (compile events before
               warm). Gated on every tenant finishing healthy after a
               growth reseat happened; every step accepted with true
               residual <= gmres_tol, active = previous + nucleations -
               catastrophes, a finite streamed frame a round holding the
               step's active fibers; tenants 0 and 5 alone
               (`ensemble_solo`) within 1e-8 of their frames; /stats: 10
               tenants, a lane seat per admission and per reseat,
               compiles_after_warm 0 with compiles > 0, the three
               histograms with ordered p50 / p95 / p99, a Prometheus page
               whose every line parses; A-D launched through their
               member-batched wrappers only. It prints the warm-up seconds
               by bucket, the round walls by live lanes, the admission
               wait percentiles and a `stream` request's latency.
               b. an "unroll" server of 2 lanes: two free-space tenants of
               128 bent 32-node fibers stream their sequential
               `System.run` frames bit for bit; a third snapshotted after
               two rounds, cancelled and resubmitted from its snapshot
               streams the uninterrupted run's bits; A and B launch.
               c. `guard.smoke.main` over TCP against servers it spawns on
               the card (a NaN-poisoned tenant quarantined with its
               provenance while its sibling finishes; SIGKILL mid-flight,
               a restart on the journal, the tenant finished): exit code
               0; each request type's round trips printed.
               d. a step of phase 6's config by `System.run` with no
               tracer active against the same step with the tracer's
               instrumentation stubbed out, in turns: the same host syncs
               (`torch.cuda.set_sync_debug_mode("warn")`); then the step
               traced to a file (the libraries dropped again): its `step`
               and `run` spans and compile events, and `obs.summarize` of
               it with a's server events naming the lanes table and the
               admission wait.
               It prints {"serve": ...} before the kernels line; A-D's
               entries carry "launches_serve_batched" (a) and
               "launches_serve_unroll" (b).
19. cost     — after 18: the cost counter and the roofline.
               a. `python -m skellysim_tpu_torch.obs cost --check` on the
               card (in this process) over the 12 registered programs
               against the checked-in baselines, which were counted on
               the CPU: exit 0, and every program's pair-seam totals
               (`obs.cost`: 22 / 40 flops a pair at the seam, whatever
               computes it) equal to the CPU's; each program's counts,
               drifts and `max_memory_allocated` beside its counted
               temp_bytes printed; FLOPS_PER_PAIR checked against the
               seam's.
               b. phase 6's profiled CLI run (2 "mixed" steps of the
               ellipsoid) and 12d's ("tree") again in this process, the
               loop under `obs.cost.CostCounter` (the build outside it):
               gated on the profiled run's frames bit for bit and its
               iterations; their counts written as a `--cost-table`
               sidecar, then `obs roofline DUMP --cost-table T
               --executions 1` over the profiled dump: gated on exit 0,
               the "H100" row, one device lane and a window MFU in (0, 1).
               Prints the per-phase table, rated_as, totals.mfu, hbm_util
               and the intensity against the ridge.
               c. a step of phase 6's config with no counter active
               against the same step with every pair seam's hook taken
               out, in turns: the same host syncs; then A-D through the
               direct seam, A over a member axis and E through the ring,
               warm, under `torch.cuda.set_sync_debug_mode("error")`:
               none raising.
               It prints {"cost_roofline": ...} before the kernels line.
20. audit    — after 19: the program auditor on the card.
               a. `python -m skellysim_tpu_torch.audit` (in this process)
               over the 12 registered programs and the 6 kernel families
               (A-H): exit 0. Then each program's observed run
               (`audit.engine.ProgramRun`) against the same call on a
               fresh build under `torch.cuda.set_sync_debug_mode("warn")`:
               the observer's host syncs equal the debug mode's, program
               by program; the table of both printed.
               b. the mask check's poisoned runs on the card (dead slots
               NaN, then +/-inf): every live output keeps the clean run's
               bits; each padded program's pad classes printed.
               c. the `dma` check on A-H: each compiled function's
               registers, shared bytes and spills (the -Xptxas -v
               report) against the contracts and the card's per-block
               limit, and 20 back-to-back launches at a ragged shape with
               the same bits and the plain version's result; the resource
               table printed.
               It prints {"audit": ...} before the kernels line; phase 20's
               wall beside the card's name and power limit.
21. surface  — after 20: the rest of the JAX package's user surface.
               a. phase 4's last state (kept with its trajectory since
               phase 4; the directory goes after 21a): `frame_bytes`
               through the native encoder (native/frameenc.cpp, built by
               g++ at first use) against the numpy one, and `build_index`
               of the trajectory through the native scanner
               (native/trajscan.cpp) against the Python scan, each the
               median of 3 in host ms beside phase 4's step wall: the
               same bytes, the same offsets and times; both libraries
               built into skellysim_tpu_torch/_build/ and loaded.
               b. 17b's velocity field (card tensors) written by
               `io.trajectory.FieldWriter` and read back by
               skellysim_tpu_torch/paraview_utils/trajectory_utility.py
               exec'd standalone (`get_frame_info`, `load_field_frame`):
               the field's values exactly; phase 6's frames through
               `get_frame_info` / `load_frame` equal to
               `TrajectoryReader`'s.
               c. `fibers.container.flow` of phase 4's state in f32
               (kernel A) equal to `flow_multi`'s bits; its pair sums
               (no self block subtracted) of the fibers after
               `sort_fibers_morton`, permuted back, within 1e-5 of the
               unsorted ones (A's f32 sums reordered); A's launches in the
               flow under "container_flow_10k".
               d. the Chebyshev penalty fiber (`fibers.chebyshev_fiber
               .evolve`, N = 20, 20 steps, f64) on the card against the
               CPU within 1e-10, with its wall.
               It prints {"completion": ...} before the kernels line.

Then one JSON line {"kernels": [...]}: a kernel's ms, bound, errors and
shape are those of its check phase (3, 6 or 7); A's, B's, C's and D's
entries also carry their first design's time ("previous_ms"), the SASS
counts ("sass_per_pair", "previous_sass_per_pair"), the issue-slot bounds
("issue_bound_ms", "previous_issue_bound_ms"), registers, shared bytes and
the plan; A's and B's, under "at_ellipsoid_shape" and
"at_ragged_source_shape", their phase-6 checks; C's and D's, under
"at_body_shape", their phase-9 checks; A-D, under
"at_ellipsoid_di_shapes", their phase-10 checks (one a shape, with the
calls at that shape); G's and H's (tree_stokeslet_f32 / _f64,
tree_stresslet_f32 / _f64) their phase-12 time (in turns with their first
design, "previous_ms"), work, lane-busy share, bound, SASS, registers,
shared bytes and spills at 12a's (tol 1e-4) and 12b's shapes, with the
error against their plain twin and the twin's time on 12c's cut; E's and F's the same fields against
their `_v1` first design, and their plan; B's, D's, E's and F's, under
"at_ring_run_shape", the same check and time at the shapes of the ring run
(E and F: where their "launches" were counted; B and D: one hop); A's and
C's, the same at one hop's shapes (phase 14's "mixed" Krylov flows).
Every entry's "launches_by_path" holds its launches in each run counted,
phase 13's sharded runs included ("spmd_ellipsoid", "spmd_ellipsoid_full",
"spmd_body", "spmd_tree"), phase 14's, summed over its processes
("spmd_processes_full", "spmd_processes_mixed"), and phase 16's
("sstep_full", "sstep_mixed", "sstep_spmd_full", "sstep_spmd_mixed",
"ladder_stagnation", "ladder_healthy", "member_mesh_vmap",
"member_mesh_unroll") and phase 17's ("flight_ellipsoid": the armed steps;
"velocity_grid": the grid's pair sums), phase 18's ("serve_vmap",
"serve_unroll") and phase 21's ("container_flow_10k": 21c's flow).
Every run is gated on the yardstick kernels launching 0 times. Then the
nvidia-smi line, and last {"ok": true, "device": {...}}. Without a CUDA
card the script exits 2 before printing any result. Every file a phase
writes (configs, the ~6.9 GB shell precompute, trajectories) lives in one
temporary directory outside the checkout, removed at the end whether the
run passed or failed.

``--device=cpu`` with small ``--fibers``, ``--ellipsoid-fibers``,
``--shell-nodes`` and ``--di-sites`` rehearses the same phases on the CPU
with the plain versions (no build, no launch counts, no result line; the
mesh's 4 shards then lie on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet peaks (dense, 700 W): 67 TFLOP/s FP32 outside
#: the tensor cores, 34 TFLOP/s FP64 outside the tensor cores, 3.35 TB/s HBM3
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
#: flops per pair, the Pallas tiles' own cost estimates
#: (skellysim_tpu/ops/pallas_kernels.py `stokeslet_pallas` / `stresslet_pallas`);
#: phase 19 checks them equal to the pair seam's (`obs.cost.PAIR_FLOPS`)
FLOPS_PER_PAIR = {"stokeslet": 22, "stresslet": 40}
#: words a source carries: position + force (Stokeslet), position + the 9
#: stresslet components
SOURCE_WORDS = {"stokeslet": 6, "stresslet": 12}
#: one step of dt = 5e-3 on the free-space path
T_FINAL = 5e-3
#: the ellipsoid config's dt, three steps
ELLIPSOID_DT = 8e-3
ELLIPSOID_STEPS = 3
#: the centrosome scene: steps before and after the resume, and its DI
#: growth speed and nucleated length
DI_STEPS = 1
DI_V_GROWTH = 0.2
DI_MIN_LENGTH = 0.5
#: the body scene's dt, three steps
BODY_DT = 0.1
BODY_STEPS = 3
#: a kernel's time: the median of this many rounds of this many launches
KERNEL_ROUNDS = 3
KERNEL_LAUNCHES = 3
#: target rows drawn at random on which phase 3 holds A and B against the
#: plain f64 sum (each plan's last target block besides): the sum on every
#: one of the 640,000 rows took 161 s of the smoke's limit
KERNEL_SAMPLE = 4096
#: shards of the ring phases' mesh, all on the one card
RING_SHARDS = 4
#: target rows a shard, sampled at random, on which kernels E and F are
#: held against their plain version (each shard's last target block besides)
RING_SAMPLE = 1024
#: phase 13: the sharded step's shards (all on the one card), its "mixed"
#: steps, and its gates against System.step from the same state: the true
#: residuals within the reference's backend-agreement gate
#: (__graft_entry__.py:83 PARITY_GATE), the fiber positions within the ring
#: run's 1e-6; "tree" against the direct "full" step within 11c's 1e-5
SPMD_SHARDS = 4
SPMD_MIXED_STEPS = 3
PARITY_GATE = 5e-9
SPMD_DX = 1e-6
SPMD_TREE_DX = 1e-5
#: phase 13b's body: a sphere of radius 0.5 at the cell's centre with this
#: many nodes, and this many bound fibers of 16 nodes (length 0.6, clamped
#: on its sites, pointing outward); the count divides the shards
SPMD_BODY_NODES = 600
SPMD_BOUND_FIBERS = 16
#: phase 14: processes sharing the card, each holding SPMD_SHARDS / this
#: many shards, and the seconds they may take together
SPMD_PROCESSES = 2
SPMD_WORKER_TIMEOUT_S = 300
#: the fused ring's TPU kernel (skellysim_tpu/parallel/ring_fused.py)
RING_REPLACES = ("skellysim_tpu/parallel/ring_fused.py:99 (_ring_kernel, "
                 'kind="{}", driven by fused_ring_block_sum :178)')


def log(*a):
    print(*a, flush=True)


#: the host clock when the script started (`stamp`)
_T0 = time.perf_counter()


def stamp(what):
    """Log the seconds from the start when a phase ends (the smoke's time
    budget)."""
    log(f"[time] {what} done at {time.perf_counter() - _T0:.1f} s")


def card_state(device):
    """The SM clock and temperature as nvidia-smi reads them now (beside
    each kernel time, so a spread between calls has a cause)."""
    if device.type != "cuda":
        return "not measured (CPU)"
    index = device.index if device.index is not None else 0
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.sm,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    clock, temp = (v.strip() for v in out.split(","))
    return f"SM clock {clock}, {temp} C"


#: FP64-pipe opcodes (SASS)
FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")


def sass_functions(cuda_build, lib_path):
    """{mangled kernel name: [(address, opcode, branch target or None)]}
    from `cuobjdump -sass` of a built library (it prints a branch's target
    as a hex address)."""
    tool = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            ins = m.group(2)
            op = next(w for w in ins.split() if not w.startswith("@"))
            target = re.search(r"\b0x([0-9a-f]+)", ins)
            cur.append((int(m.group(1), 16), op,
                        int(target.group(1), 16)
                        if op.startswith("BRA") and target else None))
    return funcs


def hot_loop(rows):
    """The innermost loop (a backward branch with no other inside it)
    whose body holds the most MUFU.RSQ, one a pair: (instructions a pair,
    FP64-pipe instructions a pair, pairs a pass). NOPs are not counted."""
    loops = [(t, a) for a, op, t in rows if t is not None and t < a]
    best = None
    for lo, hi in loops:
        if any(lo <= t2 and a2 <= hi and (t2, a2) != (lo, hi)
               for t2, a2 in loops):
            continue  # holds another loop: not innermost
        body = [op for a, op, _ in rows if lo <= a <= hi and op != "NOP"]
        mufu = sum(op.startswith("MUFU.RSQ") for op in body)
        if mufu and (best is None or mufu > best[2]):
            fp64 = sum(op.split(".")[0] in FP64_OPS for op in body)
            best = (len(body) / mufu, fp64 / mufu, mufu)
    if best is None:
        raise SystemExit("no loop with MUFU.RSQ in the kernel's SASS")
    return best


def issue_bound_ms(per_pair, pairs, sms, mhz, lanes):
    """Least time at ``per_pair`` instructions a pair when each SM retires
    ``lanes`` thread-instructions a clock (128: 4 schedulers x 32 lanes;
    64: the FP64 pipe)."""
    return 1e3 * per_pair * pairs / (sms * lanes * mhz * 1e6)


def bound_ms(family, n_src, n_trg, itemsize, peak, same_points=False):
    """Least time for the same work: max(operations / peak, bytes / HBM
    rate); bytes = each input read once (the sources' words, the target
    positions unless they are the sources themselves) and the [n_trg, 3]
    output written once."""
    ops = FLOPS_PER_PAIR[family] * n_src * n_trg
    words = SOURCE_WORDS[family] * n_src + (0 if same_points else 3) * n_trg
    nbytes = itemsize * (words + 3 * n_trg)
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_ms(torch, fn, device):
    """A kernel's time: the median of KERNEL_ROUNDS rounds, each the mean
    of KERNEL_LAUNCHES back-to-back launches between CUDA events (after a
    warm-up launch). Events count the device's idle time too, so a round
    in which the host stalls between launches reads long; the median keeps
    one such round out. Returns (ms, the last output, every round's ms)."""
    timed(torch, fn, device, 1)
    rounds, out = [], None
    for _ in range(KERNEL_ROUNDS):
        ms, out = timed(torch, fn, device, KERNEL_LAUNCHES)
        rounds.append(ms)
    return sorted(rounds)[len(rounds) // 2], out, rounds


def rounds_note(rounds):
    return (f"median of {KERNEL_ROUNDS} rounds of {KERNEL_LAUNCHES} "
            f"launches; rounds {min(rounds):.3f}–{max(rounds):.3f} ms")


def timed(torch, fn, device, reps):
    """Mean ms of ``fn()`` over ``reps`` runs: CUDA events on the card,
    the host clock on the CPU (rehearsal only)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return 1e3 * (time.perf_counter() - t0) / reps, out


def make_config(path, n_fibers, t_final, box=20.0, pair_evaluator="ring",
                periodic=False, precision="auto", curvature=0.0):
    """The 10k free-fiber config (examples/free_fibers_10k/gen_config.py)
    written with the port's own schema; ``box`` is the side of the cube
    the fibers start in (20 in the recipe), ``periodic`` makes that cube
    the periodic box, ``precision`` is its solver_precision. With a
    ``curvature`` each fiber is a circular arc of that curvature (exact
    arclength) from the recipe's origin along its direction, bent in a
    random plane: the recipe's straight fibers under their uniform
    tangential motor force carry no implicit force, so their pair flows
    vanish from the solution."""
    import numpy as np

    from skellysim_tpu_torch.config import Config, Fiber

    rng = np.random.default_rng(100)
    bend = np.random.default_rng(101)
    config = Config()
    config.params.dt_write = 5e-3
    config.params.dt_initial = 5e-3
    config.params.dt_max = 5e-3
    config.params.t_final = t_final
    config.params.gmres_tol = 1e-8
    config.params.pair_evaluator = pair_evaluator
    if periodic:
        config.params.periodic_box = [box] * 3
    config.params.kernel_impl = "pallas"
    config.params.solver_precision = precision
    config.params.refine_pair_impl = "pallas_df"
    for _ in range(n_fibers):
        fib = Fiber(length=1.0, bending_rigidity=2.5e-3, force_scale=-0.05,
                    n_nodes=64)
        origin = rng.uniform(-box / 2, box / 2, 3)
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        fib.fill_node_positions(origin, direction)
        if curvature:
            perp = np.cross(direction, bend.normal(size=3))
            perp /= np.linalg.norm(perp)
            R = 1.0 / curvature
            s = np.linspace(0.0, fib.length, fib.n_nodes)[:, None]
            fib.x = (origin + R * np.sin(s / R) * direction
                     + R * (1.0 - np.cos(s / R)) * perp).ravel().tolist()
        config.fibers.append(fib)
    config.save(path)
    return config


def make_ellipsoid_config(path, n_fibers, n_shell):
    """examples/ellipsoid/gen_config.py's config written with the port's
    schema, three steps with a frame each and the card's tiers."""
    import numpy as np

    from skellysim_tpu_torch.config import ConfigEllipsoidal, Fiber

    rng = np.random.default_rng(100)
    config = ConfigEllipsoidal()
    config.params.dt_initial = ELLIPSOID_DT
    config.params.dt_max = ELLIPSOID_DT
    config.params.dt_write = ELLIPSOID_DT
    config.params.t_final = ELLIPSOID_STEPS * ELLIPSOID_DT
    config.params.kernel_impl = "pallas"
    config.params.solver_precision = "auto"
    config.params.refine_pair_impl = "pallas_df"
    config.fibers = [
        Fiber(length=1.0, bending_rigidity=2.5e-3, parent_body=-1,
              force_scale=-0.05, minus_clamped=True, n_nodes=64)
        for _ in range(n_fibers)]
    config.periphery.n_nodes = n_shell
    config.periphery.move_fibers_to_surface(config.fibers, ds_min=0.1,
                                            rng=rng, verbose=False)
    config.save(path)
    return config


def make_body_config(path):
    """examples/stokes_tests/body_const_force/gen_config.py's config with
    the port's schema, cut to three steps."""
    from skellysim_tpu_torch.config import Body, Config

    config = Config()
    config.params.eta = 1.0
    config.params.dt_initial = BODY_DT
    config.params.dt_write = BODY_DT
    config.params.t_final = BODY_STEPS * BODY_DT
    config.params.adaptive_timestep_flag = False
    config.bodies = [Body(position=[0.0, 0.0, 0.0], shape="sphere",
                          radius=0.5, n_nodes=600,
                          external_force=[0.0, 0.0, 1.0])]
    config.save(path)
    return config


#: kernels A-D by (family, precision): the data sheet's peak for the flop
#: bound, the gate against the plain f64 sum (share of max|u|), the Pallas
#: tile it replaces
PAIR_KERNELS = {
    ("stokeslet", "f32"): (
        PEAK_FP32, 1e-4,
        "skellysim_tpu/ops/pallas_kernels.py:110 (_stokeslet_kernel)"),
    ("stokeslet", "f64"): (
        PEAK_FP64, 1e-12,
        "skellysim_tpu/ops/pallas_df.py:158 (_stokeslet_df_kernel)"),
    ("stresslet", "f32"): (
        PEAK_FP32, 1e-4,
        "skellysim_tpu/ops/pallas_kernels.py:204 (_stresslet_kernel)"),
    ("stresslet", "f64"): (
        PEAK_FP64, 1e-12,
        "skellysim_tpu/ops/pallas_df.py:195 (_stresslet_df_kernel)")}


def _sass_loop(sass, pattern):
    """`hot_loop` of the one kernel whose mangled name matches."""
    names = [k for k in sass if re.search(pattern, k)]
    if len(names) != 1:
        raise SystemExit(f"SASS: {len(names)} kernels match {pattern!r}: "
                         f"{names} (of {list(sass)})")
    return hot_loop(sass[names[0]])


def ptxas_usage(report, pattern):
    """(registers, shared bytes) of the one kernel whose mangled name
    matches, from a `-Xptxas -v` report."""
    usage, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            smem = re.search(r"(\d+) bytes smem", line)
            usage[current] = (int(m.group(1)),
                              int(smem.group(1)) if smem else 0)
    names = [k for k in usage if re.search(pattern, k)]
    if len(names) != 1:
        raise SystemExit(f"ptxas: {len(names)} kernels match {pattern!r}: "
                         f"{names}")
    return usage[names[0]]


def rsqrt_probe(torch, ck, device):
    """Kernel B's reciprocal square root against 1/sqrt in f64 on the host
    over r^2 from DBL_MIN to 1e300: (the seed's max relative error, the
    result's)."""
    import numpy as np

    rng = np.random.default_rng(29)
    x = np.concatenate([10.0 ** rng.uniform(-307.6, 300, 1_000_000),
                        rng.uniform(1e-10, 1e3, 1_000_000)])
    seed, y = ck.rsqrt_f64_probe(torch.as_tensor(x, device=device))
    ref = 1.0 / np.sqrt(x)
    return (float(np.abs(seed.cpu().numpy() / ref - 1).max()),
            float(np.abs(y.cpu().numpy() / ref - 1).max()))


def last_block_rows(ck, family, n_trg):
    """The target rows of the last target block of A's and B's (C's and
    D's) plans: R x 128 rows each, partial where n_trg is not a multiple."""
    import numpy as np

    rows = []
    for r in (ck.STOKESLET_R if family == "stokeslet"
              else ck.STRESSLET_R).values():
        block = r * (ck.STOKESLET_THREADS if family == "stokeslet"
                     else ck.STRESSLET_THREADS)
        rows.append(np.arange((n_trg - 1) // block * block, n_trg))
    return np.unique(np.concatenate(rows))


def design_check(torch, ck, cuda_build, device, family, src, trg, pay, card,
                 tag, sample=None):
    """Kernels A and B (``family`` "stokeslet") or C and D ("stresslet") at
    one shape, each against the plain f64 sum, on the same inputs rounded
    to f32 once (widened for the f64 kernel: with f64 inputs the f32
    kernel's rounding of the positions alone would dominate its error), and
    against its first design (the tiled yardstick) on every row, the two
    timed in turns (old, new, new, old) in this call; two launches compared
    bit for bit; on the card, the plan, both designs' registers and shared
    bytes (`-Xptxas -v`), the SASS instructions a pair of both hot loops and
    the issue-slot bound they give at the SM clock nvidia-smi reads; and
    B's reciprocal square root measured. The plain f64 sum covers every
    target row, or with ``sample`` (a row count) that many rows drawn at
    random plus the last target block of each precision's plan
    (`last_block_rows`), and the plain times are those rows'. ``trg is
    src`` where the sources are the targets (the bytes bound reads them
    once). Returns the JSON entries (launches filled in after the runs)."""
    import numpy as np

    on_card = device.type == "cuda"
    same = trg is src
    src64, trg64, pay64 = (torch.as_tensor(a, dtype=torch.float32,
                                           device=device).double()
                           for a in (src, trg, pay))
    n_src, n_trg = src64.shape[0], trg64.shape[0]
    eta = 1.0
    rows = None
    if sample is not None and sample < n_trg:
        rows = torch.as_tensor(np.union1d(
            np.random.default_rng(41).choice(n_trg, sample, replace=False),
            last_block_rows(ck, family, n_trg)), device=device)
    trg_ref = trg64 if rows is None else trg64[rows]
    # the reference of both kernels: the plain version in f64 (also the f64
    # kernel's plain time)
    ref_ms, ref = timed(torch, lambda: getattr(ck, f"{family}_f64_plain")(
        src64, trg_ref, pay64, eta), device, 1)
    ref_max = ref.abs().max().item()
    n_rows = int(trg_ref.shape[0])
    source = ck.STOKESLET_SOURCE if family == "stokeslet" \
        else ck.STRESSLET_SOURCE
    sass, sms = {}, None
    if on_card:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        for lib in (source, ck.SOURCE):
            sass.update(sass_functions(cuda_build,
                                       cuda_build.library_path(lib)))
    entries = []
    for prec in ("f32", "f64"):
        peak, tol, replaces = PAIR_KERNELS[family, prec]
        dt = torch.float32 if prec == "f32" else torch.float64
        s, t, f = src64.to(dt), trg64.to(dt), pay64.to(dt)
        name = f"{family}_{prec}"
        new, old = getattr(ck, name), getattr(ck, f"{name}_tiled")
        turns = {"old": [], "new": []}
        for label, kern in (("old", old), ("new", new), ("new", new),
                            ("old", old)):
            ms, out, rounds = kernel_ms(torch, lambda: kern(s, t, f, eta),
                                        device)
            turns[label].append({"ms": ms, "rounds": rounds,
                                 "card_state": card_state(device)})
            if label == "new":
                got = out
            else:
                prev = out
            del out
        # the clock nvidia-smi read right after the last timed launches
        mhz = (float(re.search(r"SM clock (\d+)", turns["new"][-1][
            "card_state"]).group(1)) if on_card else None)
        bitwise = bool(torch.equal(new(s, t, f, eta), got))
        got_r = got if rows is None else got[rows]
        prev_r = prev if rows is None else prev[rows]
        err = (got_r.double() - ref).abs().max().item()
        rel = err / ref_max
        prev_rel = (prev_r.double() - ref).abs().max().item() / ref_max
        vs_prev = ((got.double() - prev.double()).abs().max().item()
                   / prev.double().abs().max().item())
        finite = bool(torch.isfinite(got).all())
        del got, prev, got_r, prev_r
        t_ref = t if rows is None else t[rows]
        plain_ms = ref_ms if prec == "f64" else timed(
            torch, lambda: getattr(ck, f"{name}_plain")(s, t_ref, f, eta),
            device, 1)[0]
        b_ms, b_by = bound_ms(family, n_src, n_trg, s.element_size(), peak,
                              same_points=same)
        ms = sum(x["ms"] for x in turns["new"]) / 2
        prev_ms = sum(x["ms"] for x in turns["old"]) / 2
        entry = {"name": name, "route": "cuda",
                 "source": f"skellysim_tpu_torch/csrc/{source}.cu",
                 "replaces": replaces, "launches": 0, "max_abs_err": err,
                 "max_rel_err": rel, "tolerance": tol, "ms": ms,
                 "ms_turns": turns["new"], "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "shape": [int(n_src), int(n_trg)], "plain_rows": n_rows,
                 "previous_ms": prev_ms,
                 "previous_ms_turns": turns["old"],
                 "previous_source": f"skellysim_tpu_torch/csrc/{ck.SOURCE}"
                                    f".cu ({name}_tiled)",
                 "previous_max_rel_err": prev_rel,
                 "max_rel_diff_vs_previous": vs_prev,
                 "same_bits_twice": bitwise, "sm_clock_mhz": mhz}
        notes = "plan, registers and SASS not read (CPU rehearsal)"
        if on_card:
            plan = ck.pair_card_plan(family, device, prec, n_trg, n_src)
            c = "f" if prec == "f32" else "d"
            new_kernel = rf"{family}_chunk_kernelI{c}Li{plan.r}E"
            old_kernel = (rf"pair_sum_kernelIN6skelly9{family.capitalize()}"
                          rf"I{c}EE")
            per, fp64, per_pass = _sass_loop(sass, new_kernel)
            o_per, o_fp64, _ = _sass_loop(sass, old_kernel)
            regs, smem = ptxas_usage(cuda_build.build(source)["ptxas"],
                                     new_kernel)
            o_regs, o_smem = ptxas_usage(cuda_build.build(ck.SOURCE)["ptxas"],
                                         old_kernel)
            pairs = n_src * n_trg

            def issue(per_pair, fp64_per_pair):
                b = issue_bound_ms(per_pair, pairs, sms, mhz, 128)
                if prec == "f64":  # the FP64 pipe: 64 lanes a clock an SM
                    b = max(b, issue_bound_ms(fp64_per_pair, pairs, sms, mhz,
                                              64))
                return b

            entry.update({
                "plan": {"r": plan.r, "threads": plan.threads,
                         "tile": plan.tile, "grid": plan.grid,
                         "chunk_len": plan.chunk_len, "slots": plan.slots,
                         "busy": plan.busy},
                "registers": regs, "shared_bytes": smem,
                "previous_registers": o_regs, "previous_shared_bytes": o_smem,
                "sass_per_pair": per, "sass_fp64_per_pair": fp64,
                "sass_pairs_a_pass": per_pass,
                "issue_bound_ms": issue(per, fp64),
                "previous_sass_per_pair": o_per,
                "previous_sass_fp64_per_pair": o_fp64,
                "previous_issue_bound_ms": issue(o_per, o_fp64)})
            notes = (
                f"SASS hot loop: {per:.3f} instructions a pair ({fp64:.3f} "
                f"FP64; {per_pass} pairs a pass) against the tiled design's "
                f"{o_per:.3f} ({o_fp64:.3f} FP64); issue-slot bound "
                f"{entry['issue_bound_ms']:.3f} ms against "
                f"{entry['previous_issue_bound_ms']:.3f} ms ({sms} SMs x "
                f"{'64 FP64 lanes' if prec == 'f64' else '128 issue slots'}"
                f" a clock at {mhz:.0f} MHz); kernel at "
                f"{100 * entry['issue_bound_ms'] / ms:.1f}% of its issue "
                f"bound; plan R = {plan.r}, grid {plan.grid}, "
                f"{plan.chunk_len} sources a chunk, busy {plan.busy:.3f} of "
                f"{plan.slots} slots; {regs} registers, {smem} bytes shared "
                f"(the tiled design's {o_regs}, {o_smem})")
            if name == "stokeslet_f64":
                entry["rsqrt_seed_max_rel_err"], entry["rsqrt_max_rel_err"] \
                    = rsqrt_probe(torch, ck, device)
                notes += (
                    f"; rsqrt: seed max rel err "
                    f"{entry['rsqrt_seed_max_rel_err']:.3e}, after the "
                    f"third-order step {entry['rsqrt_max_rel_err']:.3e} "
                    "(2e6 values of r^2 from 1e-307.6 to 1e300)")
        log(f"[{tag}] {name}: {n_src} sources x {n_trg} targets, max abs err "
            f"{err:.3e}, max rel err {rel:.3e} (tolerance {tol:g} of max|u|; "
            f"reference: plain f64 on {n_rows} target rows"
            + ("" if rows is None else ", sampled with each plan's last "
               "target block") + f"; the tiled design's {prev_rel:.3e}, new "
            f"vs tiled {vs_prev:.3e} on every row), same bits twice: "
            f"{bitwise}; kernel "
            f"{ms:.3f} ms (turns "
            + ", ".join(f"{x['ms']:.3f}" for x in turns["new"])
            + f"; {rounds_note(turns['new'][0]['rounds'])}) against the "
            f"tiled design's {prev_ms:.3f} ms (turns "
            + ", ".join(f"{x['ms']:.3f}" for x in turns["old"])
            + f"), {prev_ms / ms:.3f}x; plain {plain_ms:.1f} ms on "
            f"{n_rows} rows, bound "
            f"{b_ms:.3f} ms ({b_by}, {FLOPS_PER_PAIR[family]} flops a pair "
            f"at {peak / 1e12:g} TFLOP/s, the data sheet's rate at 700 W); "
            f"{notes}; this card: {card}; after the timed launches: "
            f"{turns['new'][-1]['card_state']})")
        if not (finite and rel <= tol and prev_rel <= tol and vs_prev <= tol
                and bitwise):
            raise SystemExit(f"{name} fails its checks: rel err {rel:.3e} "
                             f"(tiled {prev_rel:.3e}, new vs tiled "
                             f"{vs_prev:.3e}) > {tol:g}, finite={finite}, "
                             f"same bits twice={bitwise}")
        if name == "stokeslet_f64" and on_card and not (
                entry["rsqrt_max_rel_err"] <= 4 * 2.0 ** -52):
            raise SystemExit("kernel B's rsqrt misses f64 rounding: "
                             f"{entry['rsqrt_max_rel_err']:.3e}")
        entries.append(entry)
        del s, t, f, t_ref
    log(f"[{tag}] no single PyTorch call computes the singular {family} sum "
        "(it is not a convolution, attention or sparse product): library_ms "
        "is null")
    return entries


def reset_counts(ck):
    for w in ck.KERNEL_WRAPPERS + ck.MEMBER_WRAPPERS + ck.YARDSTICK_WRAPPERS:
        w.launches = 0


def read_counts(ck):
    return {w.__name__: w.launches for w in
            ck.KERNEL_WRAPPERS + ck.MEMBER_WRAPPERS + ck.YARDSTICK_WRAPPERS}


def phase_run(torch, ck, device, cfg_path, run_dir, extra=()):
    """`python -m skellysim_tpu_torch` on the config (``extra``: more
    flags, such as --resume), in this process, with every launch count set
    to 0 just before and read just after. Returns (wall seconds, launch
    counts, peak device memory, every line of the metrics file)."""
    metrics = os.path.join(run_dir, "metrics.jsonl")
    reset_counts(ck)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    argv = sys.argv
    sys.argv = ["skellysim_tpu_torch", f"--config-file={cfg_path}",
                f"--metrics-file={metrics}", f"--device={device.type}",
                "--log-level=WARNING", *extra]
    t0 = time.perf_counter()
    try:
        runpy.run_module("skellysim_tpu_torch", run_name="__main__",
                         alter_sys=True)
    finally:
        sys.argv = argv
    wall = time.perf_counter() - t0
    counts = read_counts(ck)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    steps = [json.loads(line) for line in open(metrics)]
    return wall, counts, peak, steps


def report_run(ck, tag, wall, counts, peak, steps, n_steps, tol, device,
               needed,
               what="whole CLI run (state build and frame writes included)"):
    """Print a run's per-step metrics and gate it: ``n_steps`` accepted
    steps, each with true residual <= ``tol``, finite fiber error and
    health 0, and every kernel in ``needed`` launched (on the card)."""
    for s in steps:
        log(f"[{tag}] step {s['step']}: t={s['t']:.4g} dt={s['dt']:.3g} wall "
            f"{s['wall_s']:.3f} s, GMRES iterations {s['iters']}, refinement "
            f"sweeps {s['refines']}, true residual {s['residual_true']:.3e}, "
            f"fiber error {s['fiber_error']:.3e}, accepted {s['accepted']}")
    log(f"[{tag}] {what}: {wall:.1f} s for {len(steps)} steps; launches "
        f"{counts}; peak device memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    if len(steps) != n_steps or not all(s["accepted"] for s in steps):
        raise SystemExit(f"{tag}: the run did not take its {n_steps} "
                         "accepted steps")
    for s in steps:
        if not (s["residual_true"] <= tol and math.isfinite(s["fiber_error"])
                and s["health"] == 0):
            raise SystemExit(f"{tag}: step {s['step']} is not "
                             f"converged/healthy: {s}")
    if device.type == "cuda" and not all(counts[k] > 0 for k in needed):
        raise SystemExit(f"{tag}: a kernel of the path never launched: "
                         f"{counts}")
    if any(counts[w.__name__] for w in ck.YARDSTICK_WRAPPERS):
        raise SystemExit(f"{tag}: a yardstick kernel launched on the path: "
                         f"{counts}")


def phase_check_small(torch, device):
    """One mixed step of the small coupled scene on ``device`` and on the
    CPU (`skellysim_tpu_torch.testing.make_coupled_scene`)."""
    import numpy as np

    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.testing import make_coupled_scene

    res = {}
    for dev in sorted({device.type, "cpu"}):
        p = Params(dt_initial=0.02, gmres_tol=1e-12, solver_precision="mixed",
                   kernel_impl="pallas", refine_pair_impl="pallas_df")
        shell, shape, bodies, fibers = make_coupled_scene(
            shell_n=200, body_n=100, device=dev, precond_dtype=torch.float32)
        system = System(p, shell_shape=shape, device=dev)
        new, sol, info = system.step(system.make_state(
            fibers=fibers, shell=shell, bodies=bodies))
        if not info.converged:
            raise SystemExit(f"small scene did not converge on {dev}")
        res[dev] = (sol.cpu().numpy(), new.fibers.x.cpu().numpy(),
                    new.bodies.position.cpu().numpy())
    a, b = res[device.type], res["cpu"]
    err_sol = float(np.abs(a[0] - b[0]).max() / np.abs(b[0]).max())
    err_x = float(np.abs(a[1] - b[1]).max())
    err_pos = float(np.abs(a[2] - b[2]).max())
    log(f"[check] small coupled scene (200-node shell, 100-node body with 8 "
        f"bound fibers, 4 free fibers x 16 nodes, mixed): card vs CPU max "
        f"rel |d solution| = {err_sol:.3e}, max |dx| = {err_x:.3e}, max "
        f"|d body position| = {err_pos:.3e} (tolerance 1e-8)")
    if not max(err_sol, err_x, err_pos) <= 1e-8:
        raise SystemExit("card and CPU disagree on the small scene")


def phase_confined(torch, ck, cuda_build, device, work, args, card):
    """Ellipsoid config: precompute on the device, kernels C and D at its
    shape against their first design (`design_check`), A and B checked at
    its shapes (`shape_times`), then the run, and two steps of it under
    `--profile` in a CLI process (`profile_cli`). Returns (C's and D's entries, the run's
    launch counts, the inputs of the ring phases, A's and B's checks by
    kernel name)."""
    import numpy as np

    from skellysim_tpu_torch import precompute
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader

    run_dir = os.path.join(work, "ellipsoid")
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "skelly_config.toml")
    t0 = time.perf_counter()
    config = make_ellipsoid_config(cfg_path, args.ellipsoid_fibers,
                                   args.shell_nodes)
    log(f"[confined] wrote {args.ellipsoid_fibers} x 64-node fibers in a "
        f"{args.shell_nodes}-node ellipsoid in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stats = precompute.main([cfg_path, f"--device={device.type}"])
    log(f"[confined] precompute {time.perf_counter() - t0:.1f} s in all "
        f"(with the npz write): quadrature {stats['quadrature_s']:.2f} s, "
        f"assembly {stats['assembly_s']:.2f} s, inverse "
        f"{stats['inverse_s']:.2f} s, max ||M M_inv e_j - e_j|| over 8 "
        f"columns {stats['inverse_residual']:.3e}")

    with np.load(os.path.join(run_dir, config.periphery.precompute_file)) as z:
        shell_nodes, shell_normals = z["nodes"], z["normals"]
    fiber_nodes = np.concatenate([np.asarray(f.x).reshape(-1, 3)
                                  for f in config.fibers])
    del config
    rho = np.random.default_rng(11).standard_normal(shell_nodes.shape)
    f_dl = 2.0 * shell_normals[:, :, None] * rho[:, None, :]   # eta = 1
    entries = design_check(torch, ck, cuda_build, device, "stresslet",
                           shell_nodes, fiber_nodes, f_dl.reshape(-1, 9),
                           card, "confined")
    checks = shape_times(torch, ck, device, fiber_nodes, shell_nodes, card)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    wall, counts, peak, steps = phase_run(torch, ck, device, cfg_path,
                                          run_dir)
    report_run(ck, "confined", wall, counts, peak, steps, ELLIPSOID_STEPS,
               1e-8, device, ["stokeslet_f32", "stokeslet_f64",
                              "stresslet_f32", "stresslet_f64"])
    reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
    ok = len(reader) == ELLIPSOID_STEPS + 1
    for i in range(len(reader)):
        dens = np.asarray(reader.load_frame(i)["shell"]["solution_vec_"])
        ok = ok and dens.shape == (3 * args.shell_nodes,)
        ok = ok and bool(np.isfinite(dens).all())
        ok = ok and (i == 0 or bool(np.abs(dens).max() > 0))
    log(f"[confined] trajectory: {len(reader)} frames, times {reader.times}, "
        f"shell density {dens.shape}, max |density| {np.abs(dens).max():.4g}")
    if not ok:
        raise SystemExit("the confined trajectory does not hold finite shell "
                         "densities of the expected length in every frame")
    profiled = profile_cli(torch, device, cfg_path, work, "profile",
                           ref_traj=os.path.join(run_dir, "skelly_sim.out"),
                           keep=True)
    last = reader.load_frame(len(reader) - 1)
    direct_x = np.stack([m["x_"] for m in last["fibers"][1]])
    direct_x1 = np.stack([m["x_"] for m in reader.load_frame(1)["fibers"][1]])
    ring_inputs = {"fiber_nodes": fiber_nodes, "shell_nodes": shell_nodes,
                   "f_dl": f_dl.reshape(-1, 9), "cfg_path": cfg_path,
                   "direct_x": direct_x, "direct_x1": direct_x1,
                   "profiled": profiled}
    return entries, counts, ring_inputs, checks


#: the hand-written kernels' names in a profiler dump (their template
#: instances: A / C run f32, B / D f64; G / H the tree pass, 3 or 9
#: payload components)
PROFILED_KERNELS = {
    "A": ("stokeslet_chunk_kernel<float,", "stokeslet_reduce_kernel<float>"),
    "B": ("stokeslet_chunk_kernel<double,",
          "stokeslet_reduce_kernel<double>"),
    "C": ("stresslet_chunk_kernel<float,", "stresslet_reduce_kernel<float>"),
    "D": ("stresslet_chunk_kernel<double,",
          "stresslet_reduce_kernel<double>"),
    "G": ("tree_kernel<float, 3>", "tree_kernel<double, 3>"),
    "H": ("tree_kernel<float, 9>", "tree_kernel<double, 9>"),
}


def kernel_letter(name):
    """The letter of `PROFILED_KERNELS` a dump's kernel name belongs to,
    or None."""
    for letter, marks in PROFILED_KERNELS.items():
        if any(m in name for m in marks):
            return letter
    return None


def frames_equal(np, path_a, path_b, n):
    """The largest |difference| of the fiber nodes and shell densities of
    the first ``n`` frames of two trajectories (0.0: the same bits)."""
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader

    ra, rb = TrajectoryReader(path_a), TrajectoryReader(path_b)
    worst = 0.0
    try:
        if len(ra) < n or len(rb) < n:
            raise SystemExit(f"{path_b}: {len(rb)} frames, {path_a}: "
                             f"{len(ra)}; {n} needed")
        for i in range(n):
            fa, fb = ra.load_frame(i), rb.load_frame(i)
            xa = np.stack([m["x_"] for m in fa["fibers"][1]])
            xb = np.stack([m["x_"] for m in fb["fibers"][1]])
            da = np.asarray(fa["shell"]["solution_vec_"])
            db = np.asarray(fb["shell"]["solution_vec_"])
            if xa.shape != xb.shape or da.shape != db.shape:
                raise SystemExit(f"frame {i}: shapes differ")
            worst = max(worst, float(np.abs(xa - xb).max()),
                        float(np.abs(da - db).max()))
    finally:
        ra.close()
        rb.close()
    return worst


def run_obs(argv):
    """``python -m skellysim_tpu_torch.obs ARGV`` in this process, as
    `phase_run` runs the main CLI: (exit code, standard output)."""
    import contextlib
    import io

    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["skellysim_tpu_torch.obs", *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module("skellysim_tpu_torch.obs", run_name="__main__",
                             alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        sys.argv = saved
    return rc, out.getvalue()


def profile_cli(torch, device, src_cfg, work, tag, evaluator="direct",
                needed=("A", "B", "C", "D"), ref_traj=None, steps=2,
                phase_of_kernels=None, keep=False):
    """``python -m skellysim_tpu_torch`` on phase 6's ellipsoid config
    through ``evaluator`` for ``steps`` steps, in a process of its own, with
    ``--profile DIR --trace-file T``; then ``python -m
    skellysim_tpu_torch.obs profile DIR --json`` and ``... timeline T
    --profile DIR -o OUT``. Gated on: the run exiting 0; its frames the
    bits of ``ref_traj``'s first frames (phase 6's unprofiled run); the
    kernels ``needed`` in ``by_op`` by name; >= 90% of the device time
    attributed to named phases; the shares summing to 1; T holding
    ``device_phase`` events and no ``device_phase_error``; the timeline
    loading with a host and a device track (the two obs commands run in
    this process, `run_obs`); ``phase_of_kernels(letter,
    phase)`` (when given) true for every needed kernel's phases. Prints
    the phase table, A-H's launches and device time, the dump's size and
    the parse's seconds. Returns the summary, or None on the CPU; with
    ``keep`` the run directory stays (phase 19 rates its dump) and the
    summary names it ("run_dir", "cfg", "dump", "metrics", "steps")."""
    import numpy as np

    if device.type != "cuda":
        log(f"[{tag}] not measured (CPU rehearsal)")
        return None
    cfg, run_dir = ellipsoid_run_dir(work, src_cfg, tag,
                                     pair_evaluator=evaluator)
    from skellysim_tpu_torch.config import schema

    config = schema.load_config(cfg)
    config.params.t_final = steps * ELLIPSOID_DT
    config.save(cfg)
    del config
    dump = os.path.join(run_dir, "profile")
    trace = os.path.join(run_dir, "trace.jsonl")
    metrics = os.path.join(run_dir, "metrics.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "skellysim_tpu_torch", f"--config-file={cfg}",
         f"--profile={dump}", f"--trace-file={trace}",
         f"--metrics-file={metrics}", "--log-level=WARNING"],
        cwd=run_dir, env=env, capture_output=True, text=True, timeout=600)
    run_s = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-3000:])
        log(proc.stderr[-3000:])
        raise SystemExit(f"{tag}: the profiled CLI run exited "
                         f"{proc.returncode}")
    dumps = [f for f in os.listdir(dump) if f.endswith(".pt.trace.json")]
    size = sum(os.path.getsize(os.path.join(dump, f)) for f in dumps)
    t0 = time.perf_counter()
    rc, text = run_obs(["profile", dump, "--json"])
    parse_s = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"{tag}: obs profile exited {rc}")
    doc = json.loads(text)
    timeline = os.path.join(run_dir, "timeline.json")
    t0 = time.perf_counter()
    rc, _ = run_obs(["timeline", trace, "--profile", dump, "-o", timeline])
    timeline_s = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"{tag}: obs timeline exited {rc}")
    recs = [json.loads(line) for line in open(trace)]
    tl_events = json.load(open(timeline))["traceEvents"]
    run_wall = next(r["dur_s"] for r in recs
                    if r["ev"] == "span" and r["name"] == "run")
    dev_s = doc["total_us"] / 1e6
    inferred = doc["inferred_us"] / max(doc["total_us"], 1e-9)
    log(f"[{tag}] `python -m skellysim_tpu_torch --profile` on phase 6's "
        f"config through \"{evaluator}\", {steps} steps: {run_s:.1f} s of "
        f"process ({run_wall:.3f} s of profiled loop); dump {size / 2**20:.1f}"
        f" MiB in {len(dumps)} file(s); `obs profile --json` {parse_s:.1f}"
        f" s, `obs timeline` {timeline_s:.1f} s (each the JSON parse and "
        f"its report, in this process)")
    log(f"[{tag}] device time {dev_s * 1e3:.3f} ms over the loop's "
        f"{run_wall:.3f} s: the card busy {100 * dev_s / run_wall:.1f}% of "
        f"the wall; {100 * doc['attributed_frac']:.1f}% attributed to named "
        f"phases ({100 * inferred:.1f}% of it inferred from neighbours)")
    for g in doc["by_phase"]:
        log(f"[{tag}]   {g['key']:<28} {g['dur_us'] / 1e3:10.3f} ms "
            f"{100 * g['share']:6.2f}%  {g['count']:7d} ops")
    letters = {}
    for g in doc["by_op"]:
        letter = kernel_letter(g["key"])
        if letter is not None:
            agg = letters.setdefault(letter, {"launches": 0, "ms": 0.0})
            agg["launches"] += g["count"]
            agg["ms"] += g["dur_us"] / 1e3
    log(f"[{tag}] hand-written kernels in by_op (launches, device ms, "
        f"chunk and reduce kernels together): "
        + ", ".join(f"{k} {v['launches']} / {v['ms']:.3f} ms"
                    for k, v in sorted(letters.items())))
    for g in doc["by_op"][:10]:
        log(f"[{tag}]   top op {g['dur_us'] / 1e3:9.3f} ms "
            f"{g['count']:6d}x {g['key'][:100]}")
    kinds = [r["ev"] for r in recs]
    host = [e for e in tl_events if e.get("ph") == "X" and e.get("pid") == 1]
    devt = [e for e in tl_events if e.get("ph") == "X"
            and e.get("pid") == 100]
    share_sum = sum(g["share"] for g in doc["by_phase"])
    missing = [k for k in needed if k not in letters]
    if missing:
        raise SystemExit(f"{tag}: kernels {missing} absent from the "
                         "profile's by_op")
    if not doc["attributed_frac"] >= 0.9:
        raise SystemExit(f"{tag}: {doc['attributed_frac']:.4f} of the "
                         "device time attributed to named phases (< 0.9)")
    if abs(share_sum - 1.0) > 1e-6:
        raise SystemExit(f"{tag}: the phase shares sum to {share_sum}")
    if "device_phase" not in kinds or "device_phase_error" in kinds:
        raise SystemExit(f"{tag}: the trace holds "
                         f"{kinds.count('device_phase')} device_phase and "
                         f"{kinds.count('device_phase_error')} "
                         "device_phase_error events")
    if not host or not devt:
        raise SystemExit(f"{tag}: the timeline holds {len(host)} host and "
                         f"{len(devt)} device slices")
    log(f"[{tag}] timeline: {len(host)} host slices, {len(devt)} device "
        f"slices; trace: {kinds.count('device_phase')} device_phase events")
    out = {"run_s": run_s, "loop_s": run_wall, "device_s": dev_s,
           "busy_share": dev_s / run_wall,
           "attributed_frac": doc["attributed_frac"],
           "inferred_share": inferred, "dump_mib": size / 2**20,
           "parse_s": parse_s, "timeline_s": timeline_s,
           "by_phase": [{k: g[k] for k in ("key", "dur_us", "share",
                                          "count")}
                        for g in doc["by_phase"]],
           "kernels": letters}
    if phase_of_kernels is not None:
        # each device slice of the timeline sits on its phase's thread
        # (" [dev k]" when the card ran several streams)
        labels = {e["tid"]: re.sub(r" \[dev \d+\]$", "",
                                   e["args"]["name"])
                  for e in tl_events if e.get("ph") == "M"
                  and e.get("pid") == 100 and e.get("name") == "thread_name"}
        phases = {}
        for e in devt:
            letter = kernel_letter(e["name"])
            if letter in needed:
                key = labels[e["tid"]]
                phases.setdefault(letter, {}).setdefault(key, 0)
                phases[letter][key] += 1
        log(f"[{tag}] kernels by phase: {phases}")
        bad = {k: p for k, v in phases.items() for p in v
               if not phase_of_kernels(k, p)}
        if bad:
            raise SystemExit(f"{tag}: kernels under unexpected phases: {bad}")
        out["kernel_phases"] = phases
    if ref_traj is not None:
        dx = frames_equal(np, ref_traj, os.path.join(run_dir,
                                                     "skelly_sim.out"),
                          steps + 1)
        log(f"[{tag}] frames 0-{steps} against phase 6's unprofiled run: "
            f"max |difference| {dx:.3e} (gate: the same bits)")
        if dx != 0.0:
            raise SystemExit(f"{tag}: the profiled run's frames differ from "
                             f"the unprofiled run's by {dx:.3e}")
        out["max_diff_vs_unprofiled"] = dx
    if keep:
        out.update(run_dir=run_dir, cfg=cfg, dump=dump, metrics=metrics,
                   steps=steps)
    else:
        shutil.rmtree(run_dir)
    return out


def family_check(torch, ck, device, family, src, trg, pay, precs, card,
                 tag):
    """Kernels A and / or B (``family`` "stokeslet") or C and / or D
    ("stresslet"), by ``precs``, at one shape: each held against the plain
    f64 sum on every target row, on the same inputs rounded to f32 once
    (1e-4 of max|u| for f32, 1e-12 for f64), and timed like phase 3; on the
    card, with the plan's ragged edges (targets in the last target block,
    sources in the last tile) and chunk count. Exits on a disagreement.
    Returns {kernel name: JSON fields}."""
    src64, trg64, pay64 = (torch.as_tensor(a, dtype=torch.float32,
                                           device=device).double()
                           for a in (src, trg, pay))
    n_src, n_trg = src64.shape[0], trg64.shape[0]
    ref_ms, ref = timed(torch, lambda: getattr(ck, f"{family}_f64_plain")(
        src64, trg64, pay64, 1.0), device, 1)
    ref_max = ref.abs().max().item()
    out = {}
    for prec in precs:
        tol = PAIR_KERNELS[family, prec][1]
        name = f"{family}_{prec}"
        kern = getattr(ck, name)
        dt = torch.float32 if prec == "f32" else torch.float64
        s, t, f = (a.to(dt) for a in (src64, trg64, pay64))
        ms, got, rounds = kernel_ms(torch, lambda: kern(s, t, f, 1.0),
                                    device)
        state = card_state(device)
        err = (got.double() - ref).abs().max().item()
        rel = err / ref_max
        finite = bool(torch.isfinite(got).all())
        fields = {"shape": [int(n_src), int(n_trg)], "max_abs_err": err,
                  "max_rel_err": rel, "tolerance": tol, "rows": int(n_trg),
                  "ms": ms, "ms_rounds": rounds, "plain_f64_ms": ref_ms,
                  "card_state": state}
        edges = "plan not read (CPU rehearsal)"
        if device.type == "cuda":
            plan = ck.pair_card_plan(family, device, prec, n_trg, n_src)
            fields.update({
                "chunks": plan.chunks, "target_blocks": plan.target_blocks,
                "last_block_targets": n_trg - (plan.target_blocks - 1)
                * plan.r * plan.threads,
                "last_tile_sources": n_src - (plan.tiles - 1) * plan.tile})
            edges = (f"{plan.target_blocks} target blocks of "
                     f"{plan.r * plan.threads}, the last holding "
                     f"{fields['last_block_targets']}; {plan.chunks} chunks "
                     f"of {plan.chunk_len} sources, the last tile holding "
                     f"{fields['last_tile_sources']}")
        log(f"[{tag}] {name}: {n_src} sources x {n_trg} targets ({edges}): "
            f"against the plain f64 sum on all {n_trg} rows max abs err "
            f"{err:.3e}, max rel err {rel:.3e} (tolerance {tol:g} of "
            f"max|u|); kernel {ms:.3f} ms ({rounds_note(rounds)}), plain f64 "
            f"{ref_ms:.1f} ms; this card: {card}; after the timed launches: "
            f"{state}")
        if not finite or not rel <= tol:
            raise SystemExit(f"{name} disagrees at {n_src} x {n_trg}: rel err "
                             f"{rel:.3e} > {tol:g} (finite={finite})")
        out[name] = fields
        del s, t, f, got
    del src64, trg64, pay64, ref
    return out


def shape_times(torch, ck, device, fiber_nodes, shell_nodes, card):
    """Kernels A and B checked and timed (`family_check`) at the shape
    the confined step launches them with, the fiber nodes as sources and
    every node as targets (the matvec's and the prep's fiber flow), and
    with every node as sources and targets (a partial last source tile at
    this scale); then the per-launch time of the dense [3N, 3N] shell
    products (operator in f32 and f64, the f32 inverse) as the step runs
    them, for the launches x time breakdown. Returns {kernel name: {shape
    key: the check's JSON fields}}."""
    import numpy as np

    rng = np.random.default_rng(13)
    every = np.concatenate([fiber_nodes, shell_nodes])
    force = rng.standard_normal(every.shape) / 63.0
    checks = {}
    for key, src, frc in (
            ("at_ellipsoid_shape", fiber_nodes, force[:len(fiber_nodes)]),
            ("at_ragged_source_shape", every, force)):
        for name, fields in family_check(
                torch, ck, device, "stokeslet", src, every, frc,
                ("f32", "f64"), card, "confined").items():
            checks.setdefault(name, {})[key] = fields
    parts = [f"{name} {c['at_ellipsoid_shape']['ms']:.3f} ms "
             f"({' x '.join(map(str, c['at_ellipsoid_shape']['shape']))})"
             for name, c in checks.items()]
    n3 = 3 * shell_nodes.shape[0]
    for dt in (torch.float32, torch.float64):
        M = torch.randn((n3, n3), dtype=dt, device=device)
        x = torch.randn(n3, dtype=dt, device=device)
        timed(torch, lambda: M @ x, device, 1)
        ms = timed(torch, lambda: M @ x, device, 5)[0]
        parts.append(f"dense [{n3}, {n3}] {str(dt)[6:]} matvec {ms:.3f} ms")
        del M, x
    log("[confined] per-launch times at this path's shapes: "
        + "; ".join(parts) + f" ({card_state(device)})")
    return checks


def _shards(torch, a, n, device):
    """f32 copy of [N, ...] on the device, cut into n equal shard blocks
    (the trailing N mod n rows dropped: only a rehearsal's small sizes
    have any)."""
    m = a.shape[0] // n
    t = torch.as_tensor(a[:n * m], dtype=torch.float32, device=device)
    return t, [b.contiguous() for b in t.split(m)]


def ring_sass(torch, ck, cuda_build, device):
    """The ring library's SASS by kernel (`sass_functions`) and the card's
    SM count, or ({}, None) in the CPU rehearsal."""
    if device.type != "cuda":
        return {}, None
    return (sass_functions(cuda_build, cuda_build.library_path(
        ck.RING_SOURCE)), torch.cuda.get_device_properties(
            device).multi_processor_count)


def ring_check(torch, ck, device, family, src, trg, pay, same, rng, card,
               tag, sass):
    """Kernel E or F (by ``family``) over RING_SHARDS shards of the device
    at one shape: timed in turns with its first design, the `_v1`
    yardstick (old, new, new, old; each turn like phase 3); held against
    its plain version on target rows sampled from every shard (each
    shard's last target block of R x 128 rows among them, partial where
    the shard's target count is not a multiple of it), against kernel A's
    / C's whole output on the same f32 inputs and against the yardstick's,
    all at 1e-4 of max|u|; two launches compared bit for bit; on the card,
    the plan (R, chunks, grid a shard, busy share, scratch) and both
    designs' SASS instructions a pair with the issue-slot bounds they give
    at the SM clock read (``sass`` = (`sass_functions` of the ring library,
    SMs)). Exits on a failure. Returns (the JSON fields, the per-shard
    arguments, the per-shard output)."""
    import numpy as np

    n = RING_SHARDS
    on_card = device.type == "cuda"
    kern = getattr(ck, f"ring_{family}_f32")
    old = getattr(ck, f"ring_{family}_f32_v1")
    plain = getattr(ck, f"ring_{family}_f32_plain")
    s_all, s_l = _shards(torch, src, n, device)
    t_all, t_l = (s_all, s_l) if same else _shards(torch, trg, n, device)
    p_all, p_l = _shards(torch, pay, n, device)
    nt, ns = t_l[0].shape[0], s_l[0].shape[0]
    turns = {"old": [], "new": []}
    for label, k in (("old", old), ("new", kern), ("new", kern),
                     ("old", old)):
        ms, out, rounds = kernel_ms(torch, lambda: k(t_l, s_l, p_l), device)
        turns[label].append({"ms": ms, "rounds": rounds,
                             "card_state": card_state(device)})
        if label == "new":
            got = out
        else:
            prev = out
        del out
    ms = sum(t["ms"] for t in turns["new"]) / 2
    prev_ms = sum(t["ms"] for t in turns["old"]) / 2
    state = turns["new"][-1]["card_state"]
    bitwise = all(bool(torch.equal(a, b))
                  for a, b in zip(kern(t_l, s_l, p_l), got))
    block = ck.RING_R * ck.RING_THREADS
    last_block = np.arange((nt - 1) // block * block, nt)
    rows = [torch.as_tensor(np.union1d(
        rng.choice(nt, min(nt, RING_SAMPLE), replace=False), last_block),
        device=device) for _ in range(n)]
    plain_ms, ref = timed(torch, lambda: plain(
        [t[r] for t, r in zip(t_l, rows)], s_l, p_l), device, 1)
    got_rows = torch.cat([g[r] for g, r in zip(got, rows)]).double()
    ref = torch.cat(ref).double()
    err = (got_rows - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    whole = getattr(ck, f"{family}_f32")(s_all, t_all, p_all).double()
    got_all = torch.cat(got).double()
    rel_whole = ((got_all - whole).abs().max() / whole.abs().max()).item()
    prev_all = torch.cat(prev).double()
    vs_prev = ((got_all - prev_all).abs().max()
               / prev_all.abs().max()).item()
    prev_rel = ((prev_all - whole).abs().max() / whole.abs().max()).item()
    del whole, got_all, prev_all, prev
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    # the bound: operations over FP32 peak, or the bytes — each input read
    # once and the output written once
    pairs = (n * ns) * (n * nt)
    ops_ms = 1e3 * FLOPS_PER_PAIR[family] * pairs / PEAK_FP32
    in_out = 4 * ((SOURCE_WORDS[family] * ns + (0 if same else 3) * nt
                   + 3 * nt) * n)
    bytes_ms = 1e3 * in_out / PEAK_BYTES
    b_ms, b_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    n_rows = int(sum(len(r) for r in rows))
    fields = {"max_abs_err": err, "max_rel_err": rel,
              "max_rel_err_vs_direct": rel_whole, "tolerance": 1e-4,
              "ms": ms, "ms_turns": turns["new"], "plain_ms": plain_ms,
              "plain_rows": n_rows, "last_block_rows": int(len(last_block)),
              "bound_ms": b_ms, "bound_by": b_by, "card_state": state,
              "shards": n, "shape": [int(n * ns), int(n * nt)],
              "previous_ms": prev_ms, "previous_ms_turns": turns["old"],
              "previous_source": f"skellysim_tpu_torch/csrc/{ck.RING_SOURCE}"
                                 f".cu (ring_{family}_f32_v1)",
              "previous_max_rel_err_vs_direct": prev_rel,
              "max_rel_diff_vs_previous": vs_prev,
              "same_bits_twice": bitwise}
    notes = "plan and SASS not read (CPU rehearsal)"
    functions, sms = sass
    if on_card:
        plan = ck.ring_card_plan(family, [t.device for t in t_l], nt, ns)
        scratch = 4 * n * math.prod(plan.scratch_shape)
        mhz = float(re.search(r"SM clock (\d+)", state).group(1))
        fam = family.capitalize()
        per, _, per_pass = _sass_loop(
            functions, rf"ring_kernel.*TilePath.*{fam}TilesELi{plan.r}E")
        o_per, _, o_pass = _sass_loop(
            functions, rf"ring_kernel.*RecordPath.*9{fam}IfE")
        issue = issue_bound_ms(per, pairs, sms, mhz, 128)
        o_issue = issue_bound_ms(o_per, pairs, sms, mhz, 128)
        fields.update({
            "plan": {"r": plan.r, "threads": ck.RING_THREADS,
                     "tile": ck.RING_TILE, "tiles": plan.tiles,
                     "target_blocks": plan.target_blocks,
                     "chunks": plan.chunks, "chunk_tiles": plan.chunk_tiles,
                     "grid_a_shard": plan.grid, "busy": plan.busy,
                     "scratch_bytes": scratch},
            "sm_clock_mhz": mhz, "sass_per_pair": per,
            "sass_pairs_a_pass": per_pass, "issue_bound_ms": issue,
            "previous_sass_per_pair": o_per,
            "previous_issue_bound_ms": o_issue})
        notes = (f"plan R = {plan.r}, {plan.target_blocks} target blocks x "
                 f"{plan.chunks} chunks of {plan.chunk_tiles} tiles ("
                 f"{plan.tiles} a slot), grid {plan.grid} a shard, busy "
                 f"{plan.busy:.3f}, scratch {scratch / 1e6:.1f} MB; SASS hot "
                 f"loop {per:.3f} instructions a pair ({per_pass} pairs a "
                 f"pass) against the first design's {o_per:.3f}; issue-slot "
                 f"bound {issue:.3f} ms against {o_issue:.3f} ms ({sms} SMs x "
                 f"128 issue slots a clock at {mhz:.0f} MHz); kernel at "
                 f"{100 * issue / ms:.1f}% of its issue bound")
    log(f"[{tag}] {kern.__name__}: {n} shards on one device, {n * ns} "
        f"sources x {n * nt} targets ({nt} a shard, its last target block "
        f"{len(last_block)} rows); against its plain version on {n_rows} "
        f"target rows sampled from every shard, each last target block "
        f"included: max abs err {err:.3e}, max rel err {rel:.3e}; against "
        f"{family}_f32 on all rows: max rel err {rel_whole:.3e} (the first "
        f"design's {prev_rel:.3e}, new vs first {vs_prev:.3e}; tolerance "
        f"1e-4 of max|u|); same bits twice: {bitwise}; kernel {ms:.3f} ms "
        f"(turns " + ", ".join(f"{t['ms']:.3f}" for t in turns["new"])
        + f"; {rounds_note(turns['new'][0]['rounds'])}) against the first "
        f"design's {prev_ms:.3f} ms (turns "
        + ", ".join(f"{t['ms']:.3f}" for t in turns["old"])
        + f"), {prev_ms / ms:.3f}x; plain {plain_ms:.1f} ms on the sampled "
        f"rows, bound {b_ms:.3f} ms ({b_by}; operations {ops_ms:.3f} ms at "
        f"{FLOPS_PER_PAIR[family]} flops a pair and {PEAK_FP32 / 1e12:g} "
        f"TFLOP/s, bytes {bytes_ms:.4f} ms); {notes}; this card: {card}; "
        f"after the timed launches: {state}")
    if not (finite and rel <= 1e-4 and rel_whole <= 1e-4 and prev_rel <= 1e-4
            and vs_prev <= 1e-4 and bitwise):
        raise SystemExit(f"{kern.__name__} fails its checks at {n * ns} x "
                         f"{n * nt}: rel err {rel:.3e} against its plain "
                         f"version, {rel_whole:.3e} against {family}_f32 "
                         f"(first design {prev_rel:.3e}, new vs first "
                         f"{vs_prev:.3e}), finite={finite}, same bits "
                         f"twice={bitwise}")
    return fields, (t_l, s_l, p_l), got


def phase_ring_kernels(torch, ck, device, e_in, f_in, card, sass):
    """Kernels E and F over RING_SHARDS shards on the card (`ring_check`),
    then E, F, E back to back, each held to its lone call bit for bit."""
    import numpy as np

    rng = np.random.default_rng(17)
    entries, results = [], {}
    for family, (src, trg, pay, same) in (("stokeslet", e_in),
                                          ("stresslet", f_in)):
        fields, args, got = ring_check(torch, ck, device, family, src, trg,
                                       pay, same, rng, card, "ring kernels",
                                       sass)
        results[family] = (args, got)
        entries.append({
            "name": f"ring_{family}_f32", "route": "cuda",
            "source": f"skellysim_tpu_torch/csrc/{ck.RING_SOURCE}.cu",
            "replaces": RING_REPLACES.format(family), "launches": 0,
            "library_ms": None, **fields})
    log("[ring kernels] no single PyTorch call computes a ring of singular "
        "pair sums: library_ms is null")

    (e_args, e_ref), (f_args, f_ref) = results["stokeslet"], \
        results["stresslet"]
    e1 = ck.ring_stokeslet_f32(*e_args)
    f1 = ck.ring_stresslet_f32(*f_args)
    e2 = ck.ring_stokeslet_f32(*e_args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    worst, bitwise = 0.0, True
    for got, ref in ((e1, e_ref), (f1, f_ref), (e2, e_ref)):
        got, ref = torch.cat(got), torch.cat(ref)
        bitwise = bitwise and bool(torch.equal(got, ref))
        worst = max(worst, ((got.double() - ref.double()).abs().max()
                            / ref.double().abs().max()).item())
    log(f"[ring kernels] back to back (E, F, E, no host sync): max rel "
        f"difference from the lone calls {worst:.3e}, bit for bit: {bitwise}")
    if not bitwise:
        raise SystemExit("the back-to-back ring launches differ from the "
                         "lone calls")
    return entries


def phase_ring_run(torch, ck, device, ring_inputs, card, sass):
    """The ellipsoid config through the ring evaluator on a 4-shard mesh of
    the card: `build_simulation(cfg, mesh=...)` and `System.run`; then E
    and F checked and timed at the shapes of the run (`ring_shape_times`).
    Returns (launch counts, those checks' fields by kernel name)."""
    import numpy as np

    from skellysim_tpu_torch.builder import build_simulation
    from skellysim_tpu_torch.config import schema
    from skellysim_tpu_torch.parallel import make_mesh

    cfg_path = ring_inputs["cfg_path"]
    run_dir = os.path.dirname(cfg_path)
    config = schema.load_config(cfg_path)
    config.params.pair_evaluator = "ring"
    mesh = make_mesh(RING_SHARDS, device=device)
    t0 = time.perf_counter()
    system, state, _ = build_simulation(config, config_dir=run_dir,
                                        device=device, mesh=mesh)
    build_s = time.perf_counter() - t0
    metrics = os.path.join(run_dir, "ring_metrics.jsonl")
    reset_counts(ck)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = system.run(state, max_steps=ELLIPSOID_STEPS, metrics_path=metrics)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(ck)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    steps = [json.loads(line) for line in open(metrics)]
    log(f"[ring run] {mesh.size} shards on {mesh.devices[0]}; state built "
        f"in {build_s:.1f} s (the 6.9 GB npz load included at full width)")
    report_run(ck, "ring run", wall, counts, peak, steps, ELLIPSOID_STEPS,
               1e-8, device, ["ring_stokeslet_f32", "ring_stresslet_f32",
                        "stokeslet_f64", "stresslet_f64"], what="System.run")
    if device.type == "cuda" and (counts["stokeslet_f32"]
                                  or counts["stresslet_f32"]):
        raise SystemExit("ring run: kernels A / C launched; the ring must "
                         f"carry every fiber and shell flow: {counts}")
    x = final.fibers.x[final.fibers.active].cpu().numpy()
    direct_x = ring_inputs["direct_x"]
    dx = float(np.abs(x - direct_x).max()) if x.shape == direct_x.shape \
        else math.inf
    log(f"[ring run] final fiber positions against phase 6's direct run: "
        f"max |dx| = {dx:.3e} over {x.shape} (tolerance 1e-6)")
    if not dx <= 1e-6:
        raise SystemExit("the ring run's final fiber positions differ from "
                         "the direct run's")
    return counts, ring_shape_times(torch, ck, device, ring_inputs, card,
                                    sass)


def ring_shape_times(torch, ck, device, ring_inputs, card, sass):
    """Kernels E and F at the shapes the ring step launches them with, the
    launches its counts come from: E with the fiber nodes as sources and
    every node as targets (128,000 x 136,000 at full width: 34,000 targets
    a shard, whose last tile is partial), F with the shell nodes as
    sources and the fiber nodes as targets; each checked and timed by
    `ring_check`. Then one hop of the hop-by-hop ring (the f64-grade
    flows, and the "mixed" Krylov flows where processes share a card,
    phase 14): kernels A and B with one shard's fiber-node block against
    one shard's targets, checked and timed by `family_check`, and kernels
    C and D with one shard's shell block against one shard's fiber nodes,
    the same way. Returns the checks' JSON fields by kernel name."""
    import numpy as np

    n = RING_SHARDS
    fib, shell = ring_inputs["fiber_nodes"], ring_inputs["shell_nodes"]
    every = np.concatenate([fib, shell])
    force = np.random.default_rng(19).standard_normal(fib.shape) / 63.0
    rng = np.random.default_rng(23)
    at_run = {}
    for family, src, trg, pay in (("stokeslet", fib, every, force),
                                  ("stresslet", shell, fib,
                                   ring_inputs["f_dl"])):
        at_run[f"ring_{family}_f32"] = ring_check(
            torch, ck, device, family, src, trg, pay, False, rng, card,
            "ring run", sass)[0]
    _, s_l = _shards(torch, fib, n, device)
    _, t_l = _shards(torch, every, n, device)
    _, f_l = _shards(torch, force, n, device)
    _, sh_l = _shards(torch, shell, n, device)
    _, d_l = _shards(torch, ring_inputs["f_dl"], n, device)
    at_run.update(family_check(torch, ck, device, "stokeslet", s_l[0],
                               t_l[0], f_l[0], ("f32", "f64"), card,
                               "ring run"))
    at_run.update(family_check(torch, ck, device, "stresslet", sh_l[0],
                               s_l[0], d_l[0], ("f32", "f64"), card,
                               "ring run"))
    log("[ring run] per-launch times of one ring hop: " + "; ".join(
        f"{k} {at_run[k]['ms']:.3f} ms "
        f"({' x '.join(map(str, at_run[k]['shape']))})"
        for k in ("stokeslet_f32", "stokeslet_f64", "stresslet_f32",
                  "stresslet_f64")) + f" ({card_state(device)})")
    return at_run


def phase_bodies(torch, ck, device, work, card):
    """The 600-node sphere under a constant force, through the CLIs; then
    kernels C and D checked and timed (`family_check`) at the shape of the
    body's double layer, its nodes as sources and targets with the density
    2 eta n rho^T of a random rho. Returns (the run's launch counts, the
    drag error, C's and D's checks by kernel name)."""
    import numpy as np

    from skellysim_tpu_torch import precompute
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader

    run_dir = os.path.join(work, "body_const_force")
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "skelly_config.toml")
    config = make_body_config(cfg_path)
    precompute.main([cfg_path, f"--device={device.type}"])
    wall, counts, peak, steps = phase_run(torch, ck, device, cfg_path,
                                          run_dir)
    report_run(ck, "bodies", wall, counts, peak, steps, BODY_STEPS,
               config.params.gmres_tol, device,
               ["stresslet_f32", "stresslet_f64"])
    with np.load(os.path.join(run_dir, config.bodies[0].precompute_file)) as z:
        nodes, normals = z["node_positions_ref"], z["node_normals_ref"]
    r_eff = float(np.linalg.norm(nodes[0]))
    reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
    first, last = reader.load_frame(0), reader.load_frame(len(reader) - 1)
    z0 = float(first["bodies"][0][0]["position_"][2])
    z1 = float(last["bodies"][0][0]["position_"][2])
    v = (z1 - z0) / (last["time"] - first["time"])
    force, eta = config.bodies[0].external_force[2], config.params.eta
    v_theory = force / (6 * math.pi * eta * r_eff)
    err = abs(1 - v / v_theory)
    log(f"[bodies] sphere radius 0.5 (quadrature radius r_eff = {r_eff:.6g}), "
        f"{len(reader)} frames: v = {v:.12g}, F / (6 pi eta r_eff) = "
        f"{v_theory:.12g}, |1 - v / v_theory| = {err:.3e} (gate 1e-6)")
    if not err < 1e-6:
        raise SystemExit("the body misses the Stokes-drag gate")
    rho = np.random.default_rng(31).standard_normal(nodes.shape)
    f_dl = 2.0 * eta * normals[:, :, None] * rho[:, None, :]
    checks = family_check(torch, ck, device, "stresslet", nodes, nodes,
                          f_dl.reshape(-1, 9), ("f32", "f64"), card,
                          "bodies")
    return counts, err, checks


class RunRecords:
    """Collects the run loop's per-trial log records while a phase runs:
    dynamic instability (nucleations, catastrophes, fiber capacity, the
    update's host seconds `di_s`) in ``rows``, and the fast evaluators'
    plans (evaluator, t, the plan's shape, host seconds `plan_s`) in
    ``plans``; the package's warnings still reach stderr."""

    def __init__(self):
        import logging

        self.rows = []
        self.plans = []
        self.logger = logging.getLogger("skellysim_tpu_torch")
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                if str(record.msg).startswith("dynamic instability"):
                    t, nuc, cat, cap, di_s = record.args
                    outer.rows.append({"t": t, "nucleations": nuc,
                                       "catastrophes": cat, "capacity": cap,
                                       "di_s": di_s})
                elif " plan before t=" in str(record.msg):
                    ev, t, shape, plan_s = record.args
                    outer.plans.append({"evaluator": ev, "t": t,
                                        "plan": shape, "plan_s": plan_s})
                elif record.levelno >= logging.WARNING:
                    print(self.format(record), file=sys.stderr, flush=True)

        self.handler = Handler()

    def __enter__(self):
        import logging

        self.saved = (self.logger.level, self.logger.propagate)
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.saved[0])
        self.logger.propagate = self.saved[1]


class ShapeTally:
    """Counts the calls of kernels A-D's wrappers by (sources, targets)
    while a phase runs, by wrapping the module attributes the pair seam
    (`ops.kernels._direct`) looks up; the wrappers' own launch counts are
    untouched. This attributes a path's launches to the shapes whose times
    the checks measure."""

    NAMES = ("stokeslet_f32", "stokeslet_f64", "stresslet_f32",
             "stresslet_f64")

    def __init__(self, ck):
        import collections

        self.ck = ck
        self.calls = collections.Counter()

    def __enter__(self):
        self.saved = {n: getattr(self.ck, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            def record(src, trg, *rest, _fn=fn, _name=name):
                self.calls[_name, src.shape[0], trg.shape[0]] += 1
                return _fn(src, trg, *rest)
            setattr(self.ck, name, record)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ck, name, fn)

    def of(self, name):
        """[((sources, targets), calls)] of one kernel, most calls first."""
        return sorted(((s, t), c) for (n, s, t), c in self.calls.items()
                      if n == name)[::-1]


def make_di_config(path, ellipsoid_cfg, n_sites, steps):
    """Phase 6's ellipsoid config (its shell precompute reused) with a
    centrosome: one 600-node sphere of radius 0.5 at the origin carrying
    ``n_sites`` nucleation sites (`Body.generate_nucleation_sites`), and
    dynamic instability at the clamped fibers' 64 nodes."""
    import numpy as np

    from skellysim_tpu_torch.config import Body, schema

    config = schema.load_config(ellipsoid_cfg)
    config.params.t_final = steps * ELLIPSOID_DT
    di = config.params.dynamic_instability
    di.n_nodes, di.v_growth, di.f_catastrophe = 64, DI_V_GROWTH, 0.5
    di.nucleation_rate, di.min_length = 25.0, DI_MIN_LENGTH
    body = Body(position=[0.0, 0.0, 0.0], shape="sphere", radius=0.5,
                n_nodes=600, n_nucleation_sites=n_sites,
                precompute_file="body_precompute.npz")
    # random sequential placement, 0.04 apart: 1,000 sites cover ~40% of
    # the sphere, below the ~55% where such a placement jams
    body.generate_nucleation_sites(ds_min=0.04, verbose=False,
                                   rng=np.random.default_rng(7))
    config.bodies = [body]
    config.save(path)
    return config


def check_di_frames(reader, config, steps, n_before):
    """Gate the DI run's trajectory (`phase_ellipsoid_di`): every frame's
    fiber count is the step's `active_fibers`; every bound fiber's minus
    end lies within 1e-6 of its site in the lab frame (the body moves), no
    two active fibers share a site; across the resume some fiber is
    continued (the continuation test of
    tests/test_resume_dynamic_instability.py) and the first appended frame
    comes after the last one before. Returns the worst site distance."""
    import numpy as np
    import torch

    from skellysim_tpu_torch.utils import quaternion as quat

    di = config.params.dynamic_instability
    sites_ref = (np.asarray(config.bodies[0].nucleation_sites).reshape(-1, 3)
                 - np.asarray(config.bodies[0].position))
    worst = 0.0
    frames = [reader.load_frame(i) for i in range(len(reader))]
    for i, (frame, s) in enumerate(zip(frames[1:], steps), start=1):
        fibers = frame["fibers"][1]
        if len(fibers) != s["active_fibers"]:
            raise SystemExit(f"ellipsoid_di: frame {i} holds {len(fibers)} "
                             f"fibers, step {s['step']} counted "
                             f"{s['active_fibers']} active")
        body = frame["bodies"][0][0]
        rot = quat.rotation_matrix(torch.as_tensor(
            np.asarray(body["orientation_"]))).numpy()
        lab = np.asarray(body["position_"]) + sites_ref @ rot.T
        bound = [(tuple(f["binding_site_"]), np.asarray(f["x_"])[0])
                 for f in fibers if f["binding_site_"][0] >= 0]
        if len({b for b, _ in bound}) != len(bound):
            raise SystemExit(f"ellipsoid_di: two active fibers share a site "
                             f"in frame {i}")
        for (_, site), x0 in bound:
            worst = max(worst, float(np.linalg.norm(x0 - lab[site])))
    if not worst <= 1e-6:
        raise SystemExit(f"ellipsoid_di: a bound fiber's minus end lies "
                         f"{worst:.3e} from its site")
    before, after = frames[n_before - 1], frames[n_before]
    if not after["time"] > before["time"]:
        raise SystemExit("ellipsoid_di: the first appended frame is not "
                         "after the last one before the resume")
    by_site = {tuple(f["binding_site_"]): f["length_"]
               for f in before["fibers"][1] if f["binding_site_"][0] >= 0}
    continued = 0
    for f in after["fibers"][1]:
        site = tuple(f["binding_site_"])
        if site not in by_site:
            continue
        if f["length_"] >= by_site[site] - 1e-12:
            continued += 1
        elif f["length_"] > di.min_length + di.v_growth * ELLIPSOID_DT + 1e-12:
            raise SystemExit("ellipsoid_di: a fiber shrank across the resume "
                             "without a re-nucleation")
    if not continued:
        raise SystemExit("ellipsoid_di: no fiber was continued across the "
                         "resume")
    return worst, continued


def phase_ellipsoid_di(torch, ck, device, ellipsoid_cfg, work, args, card):
    """A centrosome nucleating microtubules inside the cell cortex: phase
    6's ellipsoid config (its shell precompute reused) with one sphere body
    carrying ``--di-sites`` nucleation sites and dynamic instability at 64
    nodes (`make_di_config`); the body precomputed alone
    (`precompute_body`); `python -m skellysim_tpu_torch` for DI_STEPS
    steps, then `--resume` with t_final raised for DI_STEPS more. Gated on
    every step accepted, converged and healthy; nucleation happening and
    the fiber capacity growing past the rung above the initial fiber count
    (2,048 at full width); each step's active count = the previous +
    nucleations - catastrophes; the frames (`check_di_frames`); the
    restored RNG counters; the metrics file's resume marker; kernels A-D
    launching. Then A-D checked and timed (`family_check`) at each shape
    the run launched them with, on the last frame's state; a launch at a
    shape no check covers fails the phase. Returns (the summed launch
    counts, {kernel name: [the check's JSON fields, one a shape]})."""
    import numpy as np

    from skellysim_tpu_torch.config import schema
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader
    from skellysim_tpu_torch.periphery.precompute import precompute_body
    from skellysim_tpu_torch.system.buckets import next_fiber_capacity
    from skellysim_tpu_torch.utils import quaternion as quat

    run_dir = os.path.join(work, "ellipsoid_di")
    os.makedirs(run_dir)
    src_dir = os.path.dirname(ellipsoid_cfg)
    shell_file = make_di_config(os.path.join(run_dir, "skelly_config.toml"),
                                ellipsoid_cfg, args.di_sites,
                                DI_STEPS).periphery.precompute_file
    os.link(os.path.join(src_dir, shell_file),
            os.path.join(run_dir, shell_file))
    cfg_path = os.path.join(run_dir, "skelly_config.toml")
    t0 = time.perf_counter()
    np.savez(os.path.join(run_dir, "body_precompute.npz"),
             **precompute_body("sphere", 600, radius=0.5))
    log(f"[ellipsoid_di] body precompute {time.perf_counter() - t0:.2f} s; "
        f"shell precompute reused from phase 6")
    peak, counts, walls = 0, {}, []
    with RunRecords() as rec, ShapeTally(ck) as tally:
        for extra, steps in (((), DI_STEPS), (("--resume",), 2 * DI_STEPS)):
            if extra:
                n_before = len(TrajectoryReader(os.path.join(
                    run_dir, "skelly_sim.out")))
                config = schema.load_config(cfg_path)
                config.params.t_final = steps * ELLIPSOID_DT
                config.save(cfg_path)
            wall, c, pk, lines = phase_run(torch, ck, device, cfg_path,
                                           run_dir, extra)
            walls.append(wall)
            counts = {k: counts.get(k, 0) + v for k, v in c.items()}
            peak = max(peak, pk or 0)
    steps = [m for m in lines if "step" in m]
    markers = [m for m in lines if m.get("resume")]
    report_run(ck, "ellipsoid_di", sum(walls), counts,
               peak if device.type == "cuda" else None, steps, 2 * DI_STEPS,
               1e-8, device, ["stokeslet_f32", "stokeslet_f64",
                              "stresslet_f32", "stresslet_f64"],
               what=f"two CLI runs ({walls[0]:.1f} s, resumed "
                    f"{walls[1]:.1f} s; state builds and frame writes "
                    "included)")
    config = schema.load_config(cfg_path)
    n0 = len(config.fibers)
    rows = rec.rows
    prev = n0
    for s, r in zip(steps, rows):
        log(f"[ellipsoid_di] step {s['step']} t={s['t']:.4g}: wall "
            f"{s['wall_s']:.3f} s, GMRES iterations {s['iters']}, fiber "
            f"capacity {r['capacity']}, active fibers {s['active_fibers']} "
            f"(+{s['nucleations']} nucleated, -{s['catastrophes']} "
            f"catastrophes), DI update on the host {r['di_s']:.4f} s")
        if (s["nucleations"], s["catastrophes"]) != (r["nucleations"],
                                                     r["catastrophes"]) or \
                s["active_fibers"] != prev + s["nucleations"] \
                - s["catastrophes"]:
            raise SystemExit(f"ellipsoid_di: step {s['step']} counts "
                             f"{s['active_fibers']} active after {prev}, "
                             f"+{s['nucleations']} -{s['catastrophes']}")
        prev = s["active_fibers"]
    rung = next_fiber_capacity(n0)
    cap = max(r["capacity"] for r in rows)
    if len(rows) != len(steps) or not sum(s["nucleations"] for s in steps) \
            or not cap > rung:
        raise SystemExit(f"ellipsoid_di: no nucleation, or the capacity "
                         f"({cap}) never passed the rung {rung}")
    if len(markers) != 1:
        raise SystemExit(f"ellipsoid_di: {len(markers)} resume markers in "
                         "the metrics file")
    reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
    if len(reader) != n_before + DI_STEPS:
        raise SystemExit(f"ellipsoid_di: {len(reader)} frames, "
                         f"{n_before} before the resume")
    worst, continued = check_di_frames(reader, config, steps, n_before)
    # the resumed stream continues the last frame's counters: the first
    # resumed update spends one uniform, one Poisson and one draw a site
    before = dict(reader.load_frame(n_before - 1)["rng_state"])
    after = dict(reader.load_frame(n_before)["rng_state"])
    spent = int(after["distributed"].split(":")[2]) - int(
        before["distributed"].split(":")[2])
    want = 2 + steps[DI_STEPS]["nucleations"]
    if spent != want or after["shared"] != before["shared"]:
        raise SystemExit(f"ellipsoid_di: the resumed RNG spent {spent} "
                         f"counters in its first step, {want} expected: the "
                         "counters were not restored from the last frame")
    log(f"[ellipsoid_di] {len(reader)} frames ({n_before} before the resume, "
        f"marker {markers[0]}); bound minus ends within {worst:.3e} of their "
        f"sites; {continued} fibers continued across the resume; the "
        f"restored stream spent {spent} counters in its first step "
        f"(2 + {steps[DI_STEPS]['nucleations']} nucleations); capacity "
        f"{n0} -> {cap} (rung {rung} passed); peak device memory "
        f"{'not measured' if device.type != 'cuda' else f'{peak / 2**30:.2f} GiB'}")
    # A-D at every shape this path launched them with, on the last frame's
    # state: a capacity's fiber slots (the live nodes first, dead slots
    # pinned at the origin with zero force), the shell's and the body's
    # nodes with their densities as double layers, the body's centre of
    # mass
    last = reader.load_frame(len(reader) - 1)
    live = np.concatenate([np.asarray(f["x_"]) for f in last["fibers"][1]])
    eta = config.params.eta
    with np.load(os.path.join(run_dir, shell_file)) as z:
        shell_nodes, shell_normals = z["nodes"], z["normals"]
    with np.load(os.path.join(run_dir, "body_precompute.npz")) as z:
        body_ref, normals_ref = z["node_positions_ref"], z["node_normals_ref"]
    body = last["bodies"][0][0]
    rot = quat.rotation_matrix(torch.as_tensor(
        np.asarray(body["orientation_"]))).numpy()
    com = np.asarray(body["position_"]).reshape(1, 3)
    body_nodes, body_normals = com + body_ref @ rot.T, normals_ref @ rot.T
    shell_rho = np.asarray(last["shell"]["solution_vec_"]).reshape(-1, 3)
    body_rho = np.asarray(body["solution_vec_"])[:3 * len(body_ref)].reshape(
        -1, 3)
    rng = np.random.default_rng(37)
    n_shell, n_body = len(shell_nodes), len(body_nodes)

    def slots(n):
        out = np.zeros((n, 3))
        out[:min(n, len(live))] = live[:n]
        return out

    def inputs(family, n_src, n_trg):
        """(what, sources, targets, payload) of a launch at this shape."""
        if family == "stresslet" and n_src == n_shell:
            return ("shell double layer", shell_nodes, np.concatenate(
                [slots(n_trg - n_body), body_nodes]),
                (2.0 * eta * shell_normals[:, :, None]
                 * shell_rho[:, None, :]).reshape(-1, 9))
        every = np.concatenate([slots(n_trg - n_shell - n_body), shell_nodes,
                                body_nodes])
        if family == "stresslet" and n_src == n_body:
            return ("body double layer", body_nodes, every,
                    (2.0 * eta * body_normals[:, :, None]
                     * body_rho[:, None, :]).reshape(-1, 9))
        if family == "stokeslet" and n_src == 1:
            return ("body centre of mass", com, every,
                    rng.standard_normal((1, 3)))
        if family == "stokeslet" and n_trg == n_src + n_shell + n_body:
            force = np.zeros((n_src, 3))
            force[:len(live)] = rng.standard_normal(
                force[:len(live)].shape) / 63.0
            return "fiber slots", slots(n_src), every, force
        raise SystemExit(f"ellipsoid_di: {family} launched at {n_src} x "
                         f"{n_trg}, a shape this phase cannot rebuild")

    checks, parts = {}, []
    for family in ("stokeslet", "stresslet"):
        precs = {}
        for prec in ("f32", "f64"):
            for shape, _ in tally.of(f"{family}_{prec}"):
                precs.setdefault(shape, []).append(prec)
        for (n_src, n_trg), ps in sorted(precs.items())[::-1]:
            what, src, trg, pay = inputs(family, n_src, n_trg)
            for name, fields in family_check(
                    torch, ck, device, family, src, trg, pay, tuple(ps),
                    card, "ellipsoid_di").items():
                n = tally.calls[name, n_src, n_trg]
                fields.update({"sources": what, "calls_at_this_shape": n})
                checks.setdefault(name, []).append(fields)
                parts.append(f"{name} at {n_src} x {n_trg} ({what}) {n} x "
                             f"{fields['ms']:.3f} ms = "
                             f"{n * fields['ms'] / 1e3:.2f} s")
    for name in ShapeTally.NAMES:
        log(f"[ellipsoid_di] {name} calls by (sources, targets) over the "
            f"{2 * DI_STEPS} steps: " + ", ".join(f"{st}: {c}"
                                               for st, c in tally.of(name)))
    log(f"[ellipsoid_di] calls x checked time at every shape launched "
        f"({len(live)} fiber nodes live in the last frame): "
        + "; ".join(parts) + f", against "
        f"{sum(s['wall_s'] for s in steps):.2f} s of step wall")
    reader.close()
    shutil.rmtree(run_dir)
    return counts, checks


#: phase 11: the 640k Ewald sum is checked, and its near field timed, on
#: its first EWALD_ROW_BLOCKS target blocks; each target block pairs with
#: exactly K source blocks, so every block is the same work and the whole
#: near field takes that time x (target blocks / EWALD_ROW_BLOCKS); cut
#: from 100 blocks (the f32 and f64 entries and near fields, each timed 4
#: times, took ~40 s of the smoke's limit)
EWALD_ROW_BLOCKS = 40
#: phase 11b's run through "FMM": fibers, in a cube scaled to phase 4's
#: density (the full 10k scene's plain-torch near field takes about 90 s
#: a matvec, PERF.md §5, ~190 a step)
FMM_FIBERS = 500
#: phase 11c's run of the ellipsoid through "FMM" (and its direct
#: reference step) is cut to its first this many fibers: at full width its
#: plain-torch near field made it a ~165 s step, the largest single part of
#: the smoke (at 500 fibers its two runs took 31.7 + 13.3 s)
FMM_ELLIPSOID_FIBERS = 250
#: phase 11d's "mixed" run through "PVFMM" is cut to this many fibers at
#: the recipe's density (its full-width run is in "full": ~190 f32 sums
#: in "mixed" would take ~3 minutes of the smoke's limit)
PVFMM_MIXED_FIBERS = 2000
#: phase 11d's "full" run through "PVFMM" is cut to this many fibers at
#: the recipe's density (its full width, 10,000, took 46.8 s of the
#: smoke's limit: PERF.md §5; 4,000 took 18.3 s before phase 18 came)
PVFMM_FULL_FIBERS = 2000
#: curvature of phase 11d's fibers (circular arcs, `make_config`)
PVFMM_CURVATURE = 0.5
#: the tolerance the fast sums are planned at (the params default)
FAST_TOL = 1e-6
#: the Ewald stresslet is also checked at this tighter tolerance: the
#: double layer's multiplier carries one more power of k, and under the
#: planner's grid cap (M <= 448) its error at FAST_TOL is ~9e-4 at the
#: ellipsoid's shape
STRESSLET_CHECK_TOL = 1e-8
#: relative 2-norm gates of the fast sums against the dense f64-grade
#: kernels (B, D), by (family, tol, precision): 10 x tol where the sum
#: reaches it; else a few times the sound reading (PERF.md §6: f32
#: Stokeslet 9.0e-4, f32 stresslet 1.0e-2 / 7.4e-3, f64 stresslet at
#: FAST_TOL 8.9e-4), far below a wrong answer's O(1)
FAST_GATES = {("stokeslet", FAST_TOL, "f64"): 1e-5,
              ("stokeslet", FAST_TOL, "f32"): 3e-3,
              ("stresslet", FAST_TOL, "f64"): 2e-3,
              ("stresslet", FAST_TOL, "f32"): 3e-2,
              ("stresslet", STRESSLET_CHECK_TOL, "f64"): 1e-5,
              ("stresslet", STRESSLET_CHECK_TOL, "f32"): 3e-2}
#: phase 11d: rows of the 640k periodic sum held against the dense
#: periodic oracle (`periodic_oracle`), and its Ewald parameter
ORACLE_ROWS = 512
ORACLE_XI = 0.6


def staged_ms(torch, fn, device):
    """A stage's time: the median of KERNEL_ROUNDS single calls after a
    warm-up call. Returns (ms, the warm-up's output, the last output)."""
    first = fn()
    rounds, out = [], None
    for _ in range(KERNEL_ROUNDS):
        ms, out = timed(torch, fn, device, 1)
        rounds.append(ms)
    return sorted(rounds)[len(rounds) // 2], first, out


def _rel(torch, a, b):
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / torch.linalg.vector_norm(b.double()))


def fast_stages(torch, device, family, pair, src, pay, trg, rows, n_self):
    """One fast sum through its `ops.evaluator.PairEvaluator` ``pair``,
    at the first ``rows`` targets. The answer is the entry's
    (`pair.stokeslet` / `pair.stresslet`, what every flow calls); its
    stages are also timed one by one, each by `staged_ms`: the near field
    at those targets, the spread of every source, the Fourier stage (FFTs
    and multiply) and the interpolation at every target. Returns (the
    entry's sum, {stage: ms}, the entry's ms, the largest difference
    between two staged calls and whether they agree bit for bit, the
    largest difference between the staged and the entry's sum)."""
    from skellysim_tpu_torch.ops import evaluator as ev

    mod = ev.plan_module(pair.plan)
    plan, dt = pair.plan, src.dtype
    eta = plan.eta
    if family == "stokeslet":
        def entry():
            return pair.stokeslet(src, trg[:rows], pay, n_self, eta)
    else:
        def entry():
            return pair.stresslet(src, trg[:rows], pay, eta)
    entry_ms, u, _ = staged_ms(torch, entry, device)

    lo_box, lo_cell = pair.anchors[0].to(dt), pair.anchors[1].to(dt)
    periodic = mod.EVALUATOR == "spectral"
    if periodic:
        src = mod._wrap_positions(plan, lo_cell, src)
        trg = mod._wrap_positions(plan, lo_cell, trg)
    near_fn = {"stokeslet": mod.stokeslet_disp_block if periodic
               else mod.stokeslet_near_block,
               "stresslet": mod.stresslet_disp_block_ewald if periodic
               else mod.stresslet_near_block_ewald}[family]
    if family == "stokeslet" and getattr(plan, "near_mode", "") == "blocks":
        def near():
            return mod._near_field_blocks(plan, src, pay, trg[:rows])
    elif periodic:
        def near():
            return mod._near_field_per(plan, lo_cell, src, pay, trg[:rows],
                                       near_fn)
    else:
        def near():
            return mod._near_field(plan, lo_cell, src, pay, trg[:rows],
                                   near_fn)
    values = pay.reshape(-1, 9) if family == "stresslet" else pay
    fourier = (mod._fourier_stresslet if family == "stresslet"
               else mod._fourier_stokeslet)
    times = {}
    times["near"], u_near, u_near2 = staged_ms(torch, near, device)
    times["spread"], H, H2 = staged_ms(
        torch, lambda: mod._spread(plan, src - lo_box, values, dt), device)
    same = bool(torch.equal(u_near, u_near2) and torch.equal(H, H2))
    diff = max(float((u_near - u_near2).abs().max()),
               float((H - H2).abs().max()))
    del H2, u_near2
    times["fourier"], U, _ = staged_ms(torch, lambda: fourier(plan, H),
                                       device)
    del H
    times["interp"], u_far, _ = staged_ms(
        torch, lambda: mod._interp(plan, trg - lo_box, U, dt), device)
    del U
    u_far = u_far[:rows]
    if n_self:
        coeff = 4.0 * plan.xi / (math.sqrt(math.pi) * 8.0 * math.pi * eta)
        u_far[:n_self] += -coeff * pay[:n_self]
    staged_vs_entry = float((u_near + u_far - u).abs().max())
    return u, times, entry_ms, diff, same, staged_vs_entry


def _gate(tag, family, tol, prec, err):
    """Fail on a non-finite error or one above its FAST_GATES entry."""
    import numpy as np

    gate = FAST_GATES[family, tol, prec]
    if not np.isfinite(err) or err > gate:
        raise SystemExit(f"{tag} misses its gate: {err:.3e} > {gate:g}")
    return gate


def ewald_at_10k(torch, ck, device, nodes, f, a_ms):
    """Phase 11a, Stokeslet: the 640k cloud of phase 3 through the Ewald
    entry sum, f32 and f64, against kernel B on the first
    EWALD_ROW_BLOCKS x 128 rows (gated by FAST_GATES), and timed by stage
    beside kernel A's time at the shape (phase 3, this call)."""
    from skellysim_tpu_torch.ops import evaluator as ev
    from skellysim_tpu_torch.ops import ewald as ew

    t0 = time.perf_counter()
    plan = ew.plan_ewald(nodes, 1.0, tol=FAST_TOL)
    plan_s = time.perf_counter() - t0
    n = len(nodes)
    blocks = plan.near_mode == "blocks"
    rows = min(n, EWALD_ROW_BLOCKS * plan.block) if blocks else n
    scale = (-(-n // plan.block)) / (rows / plan.block) if blocks else 1.0
    log(f"[fast] Ewald plan of the {n} fiber nodes at tol {FAST_TOL:g}: "
        f"{plan_s:.3f} s on the host; near {plan.near_mode}, K = {plan.K} "
        f"of {-(-n // plan.block)} source blocks, M = {plan.M}, P = "
        f"{plan.P}, cells {plan.cells3}, max_occ {plan.max_occ}, xi "
        f"{plan.xi:.4f}, rc {plan.rc:.4f}")
    pair = ev.make_pair(plan, device)
    src64 = torch.as_tensor(nodes, dtype=torch.float32,
                            device=device).double()
    f64 = torch.as_tensor(f, dtype=torch.float32, device=device).double()
    ref = ck.stokeslet_f64(src64, src64[:rows], f64, 1.0)
    out = {"plan_s": plan_s, "near_mode": plan.near_mode, "K": plan.K,
           "M": plan.M, "P": plan.P, "rows_checked": rows,
           "near_scale": scale, "a_ms": a_ms}
    sums = {}
    for prec, dt in (("f32", torch.float32), ("f64", torch.float64)):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        u, times, entry_ms, diff, same, staged = fast_stages(
            torch, device, "stokeslet", pair, src64.to(dt), f64.to(dt),
            src64.to(dt), rows, rows)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device.type == "cuda" else None)
        err = _rel(torch, u, ref)
        sums[prec] = u
        whole = times["near"] * scale + sum(
            v for k, v in times.items() if k != "near")
        gate = FAST_GATES["stokeslet", FAST_TOL, prec]
        log(f"[fast] Ewald Stokeslet {prec} at {n} x {n}: the entry sum "
            f"on the first {rows} rows against B rel 2-norm err {err:.3e} "
            f"(gate {gate:g}; the staged sum within {staged:.1e} of it); "
            f"entry {entry_ms:.1f} ms on those rows; near field "
            f"{times['near']:.1f} ms on them (x {scale:g} = "
            f"{times['near'] * scale:.1f} ms for all), spread "
            f"{times['spread']:.2f} ms, FFTs and multiply "
            f"{times['fourier']:.2f} ms, interp {times['interp']:.2f} ms "
            f"(each the median of {KERNEL_ROUNDS} after a warm-up); one "
            f"sum {whole:.1f} ms against kernel A's {a_ms:.3f} ms; two "
            f"calls {'bit for bit' if same else 'differ'}, largest "
            f"difference {diff:.3e}; peak "
            f"{'not measured' if peak is None else f'{peak:.2f} GiB'}; "
            f"{card_state(device)}")
        _gate(f"Ewald Stokeslet {prec}", "stokeslet", FAST_TOL, prec, err)
        out[prec] = {"rel_err": err, "gate": gate, "stages_ms": times,
                     "ms": whole, "entry_ms_on_rows": entry_ms,
                     "staged_vs_entry": staged, "two_calls_equal": same,
                     "two_calls_max_diff": diff, "peak_gib": peak}
    out["f32_vs_f64"] = _rel(torch, sums["f32"], sums["f64"])
    log(f"[fast] Ewald Stokeslet f32 against f64 on the same plan and rows: "
        f"rel 2-norm {out['f32_vs_f64']:.3e}")
    return out


def ewald_stresslet_check(torch, ck, device, fiber_nodes, shell_nodes,
                          f_dl):
    """Phase 11a, stresslet: the shell's 8,000 nodes onto every node
    (phase 6's shape) through the Ewald stresslet entry, f32 and f64,
    against kernel D on every row, at FAST_TOL (the tolerance System
    plans at) and at STRESSLET_CHECK_TOL, gated by FAST_GATES, timed by
    stage beside kernel C's time."""
    import numpy as np

    from skellysim_tpu_torch.ops import evaluator as ev
    from skellysim_tpu_torch.ops import ewald as ew

    every = np.concatenate([fiber_nodes, shell_nodes])
    src64, trg64, S64 = (torch.as_tensor(a, dtype=torch.float32,
                                         device=device).double()
                         for a in (shell_nodes, every, f_dl))
    S64 = S64.reshape(-1, 3, 3)
    ref = ck.stresslet_f64(src64, trg64, S64, 1.0)
    c_ms = kernel_ms(torch, lambda: ck.stresslet_f32(
        src64.float(), trg64.float(), S64.float(), 1.0), device)[0]
    out = {"c_ms": c_ms, "shape": [len(shell_nodes), len(every)]}
    for tol in (FAST_TOL, STRESSLET_CHECK_TOL):
        t0 = time.perf_counter()
        plan = ew.plan_ewald(every, 1.0, tol=tol, n_src=len(fiber_nodes))
        plan_s = time.perf_counter() - t0
        pair = ev.make_pair(plan, device)
        rec = {"plan_s": plan_s, "M": plan.M, "P": plan.P}
        for prec, dt in (("f32", torch.float32), ("f64", torch.float64)):
            u, times, entry_ms, diff, same, staged = fast_stages(
                torch, device, "stresslet", pair, src64.to(dt),
                S64.to(dt), trg64.to(dt), len(every), 0)
            err = _rel(torch, u, ref)
            gate = FAST_GATES["stresslet", tol, prec]
            log(f"[fast] Ewald stresslet {prec} at tol {tol:g} (M = "
                f"{plan.M}, P = {plan.P}, plan {plan_s:.3f} s), "
                f"{len(shell_nodes)} x {len(every)}: the entry sum against "
                f"D on every row rel 2-norm err {err:.3e} (gate {gate:g}; "
                f"the staged sum within {staged:.1e} of it); entry "
                f"{entry_ms:.2f} ms: near {times['near']:.2f} ms, spread "
                f"{times['spread']:.2f}, FFTs and multiply "
                f"{times['fourier']:.2f}, interp {times['interp']:.2f}, "
                f"against kernel C's {c_ms:.3f} ms; two calls "
                f"{'bit for bit' if same else 'differ'}, largest difference "
                f"{diff:.3e}; {card_state(device)}")
            _gate(f"Ewald stresslet {prec} at tol {tol:g}", "stresslet",
                  tol, prec, err)
            rec[prec] = {"rel_err": err, "gate": gate, "stages_ms": times,
                         "ms": entry_ms, "staged_vs_entry": staged,
                         "two_calls_equal": same}
        out[f"tol_{tol:g}"] = rec
    return out


def periodic_oracle(torch, src, f, n_trg, box, xi=ORACLE_XI,
                    logtol=math.log(1e12)):
    """The triply periodic Stokeslet sum at the first ``n_trg`` sources
    (f64, eta = 1), summed plainly, apart from the port: the screened
    real-space kernel over every source at its minimum image (``xi`` is
    chosen so that erfc(xi L / 2) is below 1e-16) and the wave-space sum
    over an explicit k lattice (|k| <= 2 xi sqrt(logtol + 6)), the
    structure factors by matrix products, minus the smooth self term; the
    k = 0 mode dropped (zero mean flow). The dense oracle of the JAX
    package's `tests/test_spectral.py` (``oracle_tp``), on the card."""
    L = torch.tensor(box, dtype=torch.float64, device=src.device)
    trg = src[:n_trg]
    u = torch.zeros((n_trg, 3), dtype=torch.float64, device=src.device)
    sq = math.sqrt(math.pi)
    for t0 in range(0, n_trg, 8):
        d = trg[t0:t0 + 8, None, :] - src[None, :, :]
        d = d - L * torch.round(d / L)
        r2 = torch.sum(d * d, dim=-1)
        mask = r2 > 1e-14
        r = torch.sqrt(torch.where(mask, r2, 1.0))
        rinv = torch.where(mask, 1.0 / r, 0.0)
        erfc = torch.where(mask, torch.special.erfc(xi * r), 0.0)
        gauss = (2 * xi / sq) * torch.exp(-(xi * r) ** 2) * mask
        df = torch.einsum("tsk,sk->ts", d, f)
        u[t0:t0 + 8] = (((erfc * rinv - gauss) @ f)
                        + torch.einsum("ts,tsk->tk",
                                       df * (erfc * rinv ** 3
                                             + gauss * rinv * rinv), d))
    u /= 8 * math.pi
    kmax = 2 * xi * math.sqrt(logtol + 6)
    Kn = [int(math.ceil(kmax * Li / (2 * math.pi))) for Li in box]
    ks = [2 * math.pi * torch.arange(-K, K + 1, dtype=torch.float64,
                                     device=src.device) / Li
          for K, Li in zip(Kn, box)]
    nx, ny, nz = (len(k) for k in ks)
    S = torch.zeros((nx * ny, nz * 3), dtype=torch.complex128,
                    device=src.device)
    fc = f.to(torch.complex128)
    for j0 in range(0, len(src), 16384):
        x = src[j0:j0 + 16384]
        ex, ey, ez = (torch.exp(-1j * x[:, a, None] * ks[a][None, :])
                      for a in range(3))
        A = (ex[:, :, None] * ey[:, None, :]).reshape(len(x), -1)
        B = (ez[:, :, None] * fc[j0:j0 + 16384, None, :]).reshape(len(x),
                                                                 -1)
        S += A.T @ B
    S = S.reshape(nx, ny, nz, 3)
    kv = torch.stack(torch.meshgrid(*ks, indexing="ij"), dim=-1)
    k2 = torch.sum(kv * kv, dim=-1)
    keep = (k2 > 0) & (k2 <= 1.5 * kmax * kmax)
    kv, k2, S = kv[keep], k2[keep], S[keep]
    phi = (1 + k2 / (4 * xi * xi)) * torch.exp(-k2 / (4 * xi * xi))
    kS = torch.sum(kv * S, dim=-1)
    proj = S - kv * (kS / k2)[:, None]
    mult = proj * (phi / k2)[:, None]
    for t0 in range(0, n_trg, 64):
        phase = torch.exp(1j * (trg[t0:t0 + 64] @ kv.T))
        u[t0:t0 + 64] += (phase @ mult).real / math.prod(box)
    return u - 4 * xi / (sq * 8 * math.pi) * f[:n_trg]


def spectral_at_10k(torch, device, nodes, f, box):
    """Phase 11d's check: the 640k cloud in phase 4's periodic box (side
    20) through the spectral Stokeslet entry sum in f64, at FAST_TOL and
    at 1e-9, each timed by stage: on the first ORACLE_ROWS rows against
    `periodic_oracle` (gated at 1e-5 and 1e-6), and the FAST_TOL sum
    against the 1e-9 sum on every row (gated at 1e-5)."""
    from skellysim_tpu_torch.ops import evaluator as ev
    from skellysim_tpu_torch.ops import spectral as spc

    src = torch.as_tensor(nodes, dtype=torch.float64, device=device)
    pay = torch.as_tensor(f, dtype=torch.float64, device=device)
    n = len(nodes)
    rows = min(n, ORACLE_ROWS)
    t0 = time.perf_counter()
    oracle = periodic_oracle(torch, src, pay, rows, box)
    oracle_s = time.perf_counter() - t0
    out, sums = {"oracle_rows": rows, "oracle_s": oracle_s}, {}
    for tol, gate in ((FAST_TOL, 1e-5), (1e-9, 1e-6)):
        t0 = time.perf_counter()
        plan = spc.plan_spectral(nodes, box, 1.0, tol=tol)
        plan_s = time.perf_counter() - t0
        u, times, entry_ms, diff, same, staged = fast_stages(
            torch, device, "stokeslet", ev.make_pair(plan, device), src,
            pay, src, n, n)
        sums[tol] = u
        err = _rel(torch, u[:rows], oracle)
        log(f"[fast] spectral Stokeslet f64 at tol {tol:g}, {n} x {n} in "
            f"the box of side {box[0]:g}: plan {plan_s:.3f} s (M3 "
            f"{plan.M3}, P {plan.P}, cells {plan.cells3}, max_occ "
            f"{plan.max_occ}); the entry sum {entry_ms:.1f} ms (the staged "
            f"sum within {staged:.1e} of it): near {times['near']:.1f} ms, "
            f"spread {times['spread']:.1f}, FFTs and multiply "
            f"{times['fourier']:.1f}, interp {times['interp']:.1f}; against "
            f"the dense periodic oracle on the first {rows} rows rel "
            f"2-norm err {err:.3e} (gate {gate:g}; oracle {oracle_s:.1f} "
            f"s); two calls {'bit for bit' if same else 'differ'}, largest "
            f"difference {diff:.3e}; {card_state(device)}")
        if not err <= gate:
            raise SystemExit(f"spectral sum at {tol:g} is {err:.3e} off "
                             "the dense periodic oracle")
        out[f"tol_{tol:g}"] = {"plan_s": plan_s, "M3": list(plan.M3),
                               "P": plan.P, "stages_ms": times,
                               "ms": entry_ms, "rel_err_vs_oracle": err,
                               "staged_vs_entry": staged}
    err = _rel(torch, sums[FAST_TOL], sums[1e-9])
    log(f"[fast] spectral self-consistency: tol {FAST_TOL:g} against 1e-9 "
        f"on every row rel 2-norm {err:.3e} (gate 1e-5)")
    if not err <= 1e-5:
        raise SystemExit(f"spectral sum at {FAST_TOL:g} is {err:.3e} off "
                         "the 1e-9 sum")
    out["rel_err_vs_1e-9"] = err
    return out


def fast_run(torch, ck, device, tag, cfg_path, run_dir, n_steps, needed,
             idle, direct_x=None, min_iters=1):
    """A fast-evaluator CLI run (`phase_run`) with its plan records:
    gated like `report_run`, on the kernels in ``idle`` launching 0
    times, on every step taking at least ``min_iters`` GMRES iterations
    (a coupled scene), and (``direct_x``) on its last frame's fiber
    positions within 1e-5 of a direct run's. Returns its summary."""
    import numpy as np

    from skellysim_tpu_torch.io.trajectory import TrajectoryReader

    with RunRecords() as rec:
        wall, counts, peak, steps = phase_run(torch, ck, device, cfg_path,
                                              run_dir)
    report_run(ck, tag, wall, counts, peak, steps, n_steps, 1e-8, device,
               needed)
    for p in rec.plans:
        log(f"[{tag}] {p['evaluator']} plan before t={p['t']:.4g}: "
            f"{p['plan']}, {p['plan_s']:.3f} s on the host")
    if device.type == "cuda" and any(counts[k] for k in idle):
        raise SystemExit(f"{tag}: {idle} launched on a fast path: {counts}")
    if any(s["iters"] < min_iters for s in steps):
        raise SystemExit(f"{tag}: a step took fewer than {min_iters} "
                         "iterations: its pair flows left the solve "
                         "uncoupled")
    out = {"wall_s": wall, "steps": [
        {k: s[k] for k in ("wall_s", "iters", "refines", "residual_true")}
        for s in steps], "plans": rec.plans, "launches": counts,
        "peak_gib": None if peak is None else peak / 2**30}
    if direct_x is not None:
        reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
        x = np.stack([m["x_"] for m in
                      reader.load_frame(len(reader) - 1)["fibers"][1]])
        reader.close()
        dx = float(np.abs(x - direct_x).max())
        log(f"[{tag}] final fiber positions against the direct run's: max "
            f"|dx| = {dx:.3e} (gate 1e-5)")
        if not dx <= 1e-5:
            raise SystemExit(f"{tag}: {dx:.3e} off the direct run")
        out["max_dx_vs_direct"] = dx
    return out


def ellipsoid_run_dir(work, src_cfg, tag, n_fibers=None, **params):
    """Phase 6's ellipsoid config for one step in its own run directory
    under ``work``, on phase 6's shell precompute (a hard link), with
    ``params`` set in its [params] and, with ``n_fibers``, cut to its first
    that many fibers: (config path, run directory)."""
    from skellysim_tpu_torch.config import schema

    run_dir = os.path.join(work, tag)
    os.makedirs(run_dir)
    config = schema.load_config(src_cfg)
    if n_fibers is not None:
        config.fibers = config.fibers[:n_fibers]
    for k, v in params.items():
        setattr(config.params, k, v)
    config.params.t_final = ELLIPSOID_DT
    cfg = os.path.join(run_dir, "skelly_config.toml")
    config.save(cfg)
    shell_file = config.periphery.precompute_file
    os.link(os.path.join(os.path.dirname(src_cfg), shell_file),
            os.path.join(run_dir, shell_file))
    return cfg, run_dir


def cut_run(work, args, tag, n_fib, **kw):
    """The 10k recipe's config (`make_config`, one step) cut to ``n_fib``
    fibers (at most --fibers) in a cube scaled to phase 4's density, in
    its own run directory under ``work``: (config path, run directory)."""
    n_fib = min(n_fib, args.fibers)
    box = 20.0 * (n_fib / 10_000) ** (1.0 / 3.0)
    run_dir = os.path.join(work, tag)
    os.makedirs(run_dir)
    cfg = os.path.join(run_dir, "skelly_config.toml")
    make_config(cfg, n_fib, 5e-3, box=box, **kw)
    log(f"[{tag}] {n_fib} x 64-node fibers in a cube of side {box:.3f} "
        f"(phase 4's density), one step"
        + (f", arcs of curvature {kw['curvature']:g}"
           if kw.get("curvature") else ""))
    return cfg, run_dir


def fast_card_vs_cpu(torch, device):
    """Phase 11e: one "full" f64 step on the card and on the CPU, from the
    same state (so the same plan): the small coupled scene with
    ewald_min_sources below its 200-node shell through "ewald", and 8
    fibers in a periodic box through "spectral"; they agree to 1e-8."""
    import numpy as np

    from skellysim_tpu_torch.fibers import container as fc
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import BackgroundFlow, System
    from skellysim_tpu_torch.testing import make_coupled_scene

    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(8, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    perp = np.cross(dirs, rng.normal(size=(8, 3)))
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    # arcs of curvature 0.5: straight fibers in a uniform flow carry no
    # implicit force, and their pair flows would vanish from the solution
    t = np.linspace(0, 1.2, 16)[None, :, None]
    x = (rng.uniform(1.2, 2.8, (8, 3))[:, None, :]
         + 2.0 * np.sin(t / 2.0) * dirs[:, None, :]
         + 2.0 * (1.0 - np.cos(t / 2.0)) * perp[:, None, :])
    errs = {}
    for name in ("ewald", "spectral"):
        res = {}
        for dev in sorted({device.type, "cpu"}):
            if name == "ewald":
                p = Params(dt_initial=0.02, gmres_tol=1e-12,
                           solver_precision="full", pair_evaluator="ewald",
                           ewald_min_sources=150)
                shell, shape, bodies, fibers = make_coupled_scene(
                    shell_n=200, body_n=100, device=dev)
                system = System(p, shell_shape=shape, device=dev)
                state = system.make_state(fibers=fibers, shell=shell,
                                          bodies=bodies)
            else:
                p = Params(dt_initial=1e-3, gmres_tol=1e-12,
                           solver_precision="full",
                           pair_evaluator="spectral",
                           periodic_box=(4.0, 4.0, 4.0))
                system = System(p, device=dev)
                state = system.make_state(
                    fibers=fc.make_group(x, lengths=1.2,
                                         bending_rigidity=0.01,
                                         radius=0.0125, device=dev),
                    background=BackgroundFlow.make(
                        uniform=(1.0, 0.0, 0.0), device=dev))
            new, sol, info = system.step(state)
            if not info.converged:
                raise SystemExit(f"{name} small scene did not converge on "
                                 f"{dev}")
            res[dev] = (sol.cpu().numpy(), new.fibers.x.cpu().numpy())
        a, b = res[device.type], res["cpu"]
        errs[name] = max(float(np.abs(a[0] - b[0]).max()
                               / np.abs(b[0]).max()),
                         float(np.abs(a[1] - b[1]).max()))
        log(f"[fast] small {name} scene, one full f64 step: card vs CPU max "
            f"rel |d solution| / max |dx| = {errs[name]:.3e} (gate 1e-8)")
        if not errs[name] <= 1e-8:
            raise SystemExit(f"card and CPU disagree on the {name} scene")
    return errs


def phase_fast(torch, ck, device, work, args, nodes, f, a_ms, ring_inputs):
    """Phase 11, the fast evaluators (a-e). Returns (the phase's summary,
    launch counts by run)."""
    from skellysim_tpu_torch.config import schema

    out, launches = {}, {}
    # a. the Ewald sums at the 10k shape and at phase 6's
    out["ewald_10k"] = ewald_at_10k(torch, ck, device, nodes, f, a_ms)
    out["ewald_stresslet"] = ewald_stresslet_check(
        torch, ck, device, ring_inputs["fiber_nodes"],
        ring_inputs["shell_nodes"], ring_inputs["f_dl"])
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # b. the 10k recipe through "FMM", cut to FMM_FIBERS at its density
    cfg, run_dir = cut_run(work, args, "fmm", FMM_FIBERS,
                           pair_evaluator="FMM")
    out["fmm_run"] = fast_run(torch, ck, device, "fmm", cfg, run_dir, 1,
                              ["stokeslet_f64"], ["stokeslet_f32"])
    launches["fmm_free_fibers"] = out["fmm_run"]["launches"]
    shutil.rmtree(run_dir)

    # c. the ellipsoid config cut to its first FMM_ELLIPSOID_FIBERS fibers
    # (phase 6's shell and precompute) through "FMM", one step, against one
    # direct step of the same cut config
    import numpy as np

    from skellysim_tpu_torch.io.trajectory import TrajectoryReader

    src_cfg = ring_inputs["cfg_path"]
    n_cut = min(FMM_ELLIPSOID_FIBERS, args.ellipsoid_fibers)
    cfg, run_dir = ellipsoid_run_dir(work, src_cfg, "fmm_ellipsoid_direct",
                                     n_fibers=n_cut)
    log(f"[fmm_ellipsoid] phase 6's config cut to its first {n_cut} fibers: "
        "one direct step")
    wall, counts, peak, steps = phase_run(torch, ck, device, cfg, run_dir)
    report_run(ck, "fmm_ellipsoid_direct", wall, counts, peak, steps, 1,
               1e-8, device, ["stokeslet_f32", "stokeslet_f64",
                              "stresslet_f32", "stresslet_f64"])
    reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
    direct_x = np.stack([m["x_"] for m in
                         reader.load_frame(len(reader) - 1)["fibers"][1]])
    reader.close()
    shutil.rmtree(run_dir)
    cfg, run_dir = ellipsoid_run_dir(work, src_cfg, "fmm_ellipsoid",
                                     n_fibers=n_cut, pair_evaluator="FMM")
    big_shell = (len(ring_inputs["shell_nodes"])
                 >= schema.load_config(cfg).params.ewald_min_sources)
    out["fmm_ellipsoid_run"] = fast_run(
        torch, ck, device, "fmm_ellipsoid", cfg, run_dir, 1,
        ["stokeslet_f64", "stresslet_f64"],
        ["stokeslet_f32"] + (["stresslet_f32"] if big_shell else []),
        direct_x=direct_x)
    out["fmm_ellipsoid_run"]["fibers"] = n_cut
    launches["fmm_ellipsoid"] = out["fmm_ellipsoid_run"]["launches"]
    shutil.rmtree(run_dir)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # d. a periodic suspension through "PVFMM": the sums at the 10k shape
    # against the dense periodic oracle; then the recipe's fibers, bent
    # into arcs (straight ones would carry no implicit force, and the step
    # would take one iteration whatever the flows), in its box made
    # periodic: one step at full width in "full", and one cut to
    # PVFMM_MIXED_FIBERS at its density in "mixed" (the default on the
    # card; its f64 prep flows and refinement residual take the periodic
    # plan too). No dense kernel launches.
    out["spectral_10k"] = spectral_at_10k(torch, device, nodes, f,
                                          (20.0,) * 3)
    for tag, n_fib, prec in (("pvfmm", min(PVFMM_FULL_FIBERS, args.fibers),
                              "full"),
                             ("pvfmm_mixed", PVFMM_MIXED_FIBERS, "auto")):
        cfg, run_dir = cut_run(work, args, tag, n_fib,
                               pair_evaluator="PVFMM",
                               periodic=True, precision=prec,
                               curvature=PVFMM_CURVATURE)
        out[f"{tag}_run"] = fast_run(torch, ck, device, tag, cfg, run_dir,
                                     1, [], ["stokeslet_f32",
                                             "stokeslet_f64"], min_iters=2)
        launches[tag] = out[f"{tag}_run"]["launches"]
        shutil.rmtree(run_dir)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # e. small scenes, card against CPU
    out["card_vs_cpu"] = fast_card_vs_cpu(torch, device)
    return out, launches


#: phase 12: the treecode's tolerances, System's default tree_tol and a
#: tight one (where the tree stops paying: p = 9, 729 proxies a cell)
TREE_TOLS = (1e-4, 1e-6)
#: phase 12c: G and H are held against their plain twin on whole target
#: leaves, this many of the fullest and this many of the first
TREE_CUT_LEAVES = 8
#: phase 12b: the double layer's gate, this many times plan.tol: it carries
#: one more derivative than the Stokeslet the order rule is calibrated on,
#: and on phase 6's shell with its white-noise density the tree reads ~6 x
#: tol over every row. The JAX package's own tree, on the same depth-5
#: plan at the shell and an eighth of the fiber nodes, reads 5.2 x tol
#: there, the port's equal to 2e-14 (tests/torch_tree_stresslet_witness.py)
TREE_STRESSLET_GATE = 10.0
#: phase 12e's "tree" run of the 10k recipe's arcs is cut to this many
#: fibers at its density (the full width took 26.1 s of the smoke's limit)
TREE_ARCS_FIBERS = 4000
#: kernels G and H replace no Pallas kernel: the JAX package sums the
#: tree's near and far fields in plain XLA
TREE_REPLACES = ("no Pallas counterpart: skellysim_tpu/ops/treecode.py:555 "
                 "(_tree_eval's near_rows / far_rows, plain XLA)")


def tree_work(torch, ck, items, segs, v1=False):
    """(real pairs, lane pairs issued: each item's target slots
    (`cuda_kernels.tree_item_slots`: 2 T; ``v1``, the first design's, 32)
    times its segments' sources) of one pass of kernel G / H over its
    lists."""
    seg_len = segs[:, 1]
    cum = torch.cat([seg_len.new_zeros(1), torch.cumsum(seg_len, 0)])
    per = cum[items[:, 2] + items[:, 3]] - cum[items[:, 2]]
    return (int((items[:, 1] * per).sum()),
            int((ck.tree_item_slots(items, v1) * per).sum()))


def _field_rel(torch, u, ref):
    """The JAX treecode tests' field-normalized error, max_i |du_i| /
    max_i |u_i|."""
    return float(torch.linalg.vector_norm(u.double() - ref, dim=1).max()
                 / torch.linalg.vector_norm(ref, dim=1).max())


def _tensor_bytes(obj, seen=None):
    """Bytes of the distinct tensor storages reachable from ``obj``
    (a dataclass, dict, tuple or list of them)."""
    import dataclasses

    import torch

    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = obj.untyped_storage().data_ptr()
        if key in seen:
            return 0
        seen.add(key)
        return obj.untyped_storage().nbytes()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o, seen) for o in obj)
    return 0


def tree_stages(torch, ck, device, family, plan, src, pay, trg, turns):
    """One tree sum at viscosity 1 through the entry (`PairEvaluator
    .stokeslet` / `.stresslet`, what every flow calls), and its stages
    timed apart by `staged_ms`: the sum as a step's evaluator serves a
    matvec ("sum", its geometry kept from the first call) and as a fresh
    one does ("sum_cold": geometry, payload part and pass, as every call
    was before the geometry was kept; the same bits), the geometry alone
    (`tree_geometry`), then the payload part's stages: the buckets'
    scatter, the upward pass (anterpolation product and transfers), kernel
    G / H on the near lists alone, on the far lists alone and on both (the
    sum's one launch). With ``turns`` the pass is timed against the first
    design (`tree_*_v1` over its own items) in turns, old, new, new, old,
    each `kernel_ms`. Returns (the entry's sum, {stage: ms}, the pass's
    work, the lists' operands, the sources a leaf at most, the two staged
    launches bit for bit, the first design's record or None)."""
    from skellysim_tpu_torch.ops import evaluator as ev
    from skellysim_tpu_torch.ops import treecode as ttc

    dt = trg.dtype
    prec = "f32" if dt == torch.float32 else "f64"
    C = pay.shape[1]
    pay_e = pay if family == "stokeslet" else pay.reshape(-1, 3, 3)

    def entry(pair):
        if family == "stokeslet":
            return pair.stokeslet(src, trg, pay_e, 0, 1.0)
        return pair.stresslet(src, trg, pay_e, 1.0)

    times = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times["sum_cold"], cold, _ = staged_ms(
        torch, lambda: entry(ev.make_pair(plan, device)), device)
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else None)
    pair = ev.make_pair(plan, device)
    times["sum"], u, _ = staged_ms(torch, lambda: entry(pair), device)
    if not torch.equal(u, cold):
        raise SystemExit(f"tree {family} {prec}: the sum over a kept "
                         "geometry is not the fresh build's bit for bit")
    geometry_gib = _tensor_bytes(pair.geometry) / 2**30
    del cold
    pair.geometry.clear()
    times["geometry"], geom, _ = staged_ms(
        torch, lambda: ttc.tree_geometry(plan, pair.anchors, src, trg),
        device)
    times["bucket"], pay_b, _ = staged_ms(
        torch, lambda: ttc._bucket_payload(plan, geom.src_order, geom.slot,
                                           pay), device)
    times["upward"], proxy_f, _ = staged_ms(
        torch, lambda: ttc._upward_payload(geom.up, pay_b), device)
    pa = torch.cat([pay_b.reshape(-1, C), proxy_f.reshape(-1, C)])
    del pay_b, proxy_f
    trg_s, sa, items, segs = geom.trg, geom.src, geom.items, geom.segs
    leaf = ttc._leaf_ids(plan, pair.anchors[0].to(dt), trg_s)
    kern = getattr(ck, f"tree_{family}_{prec}")
    work = {}
    for field in ("near", "far"):
        it, sg = ttc._segment_lists(plan, geom.counts, geom.cell_n, leaf,
                                    (field,))
        times[field], _, _ = staged_ms(
            torch, lambda: kern(trg_s, sa, pa, it, sg, 1.0), device)
        work[field] = tree_work(torch, ck, it, sg)
        del it, sg
    times["kernel"], first, last = staged_ms(
        torch, lambda: kern(trg_s, sa, pa, items, segs, 1.0), device)
    same = bool(torch.equal(first, last))
    staged = torch.empty_like(first)
    staged[geom.trg_order] = first
    if not torch.equal(staged, u):
        raise SystemExit(f"tree {family} {prec}: the staged launch is not "
                         "the entry's sum bit for bit")
    del staged, last
    work["pairs"], work["lane_pairs"] = tree_work(torch, ck, items, segs)
    items_v1, _ = ttc._segment_lists(plan, geom.counts, geom.cell_n, leaf,
                                     v1=True)
    work["lane_pairs_v1"] = tree_work(torch, ck, items_v1, segs, True)[1]
    work.update({"items": int(items.shape[0]),
                 "items_v1": int(items_v1.shape[0]),
                 "segments": int(segs.shape[0]),
                 "n_src": int(src.shape[0]), "n_trg": int(trg.shape[0]),
                 "proxies": int((geom.cell_n[:-1] > 0).sum())
                 * plan.order ** 3,
                 "geometry_gib": geometry_gib, "peak_gib": peak})
    v1 = None
    if turns:
        old = getattr(ck, f"tree_{family}_{prec}_v1")
        rec = {"old": [], "new": []}
        for label, fn in (
                ("old", lambda: old(trg_s, sa, pa, items_v1, segs, 1.0)),
                ("new", lambda: kern(trg_s, sa, pa, items, segs, 1.0)),
                ("new", lambda: kern(trg_s, sa, pa, items, segs, 1.0)),
                ("old", lambda: old(trg_s, sa, pa, items_v1, segs, 1.0))):
            ms, out, rounds = kernel_ms(torch, fn, device)
            rec[label].append({"ms": ms, "rounds": rounds,
                               "card_state": card_state(device)})
            if label == "old":
                prev = out
            del out
        diff = (float((prev.double() - first.double()).abs().max())
                / float(first.double().abs().max()))
        del prev
        v1 = {"ms": sum(x["ms"] for x in rec["old"]) / 2,
              "ms_turns": rec["old"], "new_ms_turns": rec["new"],
              "new_ms": sum(x["ms"] for x in rec["new"]) / 2,
              "max_rel_diff": diff,
              "by_lanes": tree_lane_classes(torch, ck, device, kern,
                                            (trg_s, sa, pa), items, segs)}
        log(f"[treecode] {kern.__name__} in turns with its first design "
            f"{old.__name__} (old, new, new, old; each "
            f"{rounds_note(rec['new'][0]['rounds'])}): new "
            + ", ".join(f"{x['ms']:.3f}" for x in rec["new"]) + " ms, old "
            + ", ".join(f"{x['ms']:.3f}" for x in rec["old"])
            + f" ms ({v1['ms'] / v1['new_ms']:.3f}x); max |new - old| "
            f"{diff:.3e} of the largest velocity; lane pairs busy "
            f"{work['pairs'] / work['lane_pairs']:.3f} ({work['items']} "
            f"items) against {work['pairs'] / work['lane_pairs_v1']:.3f} "
            f"({work['items_v1']} items); {card_state(device)}")
    del first
    ops = (trg_s, sa, pa, items, segs)
    return u, times, work, ops, int(geom.counts.max()), same, v1


def tree_lane_classes(torch, ck, device, kern, ops, items, segs):
    """Kernel G / H on the items of each target-lane class T alone
    (`cuda_kernels.tree_item_lanes`): items, lane pairs, the real share
    and the lane pairs a second, each `staged_ms`. Returns {T: record}."""
    seg_len = segs[:, 1]
    cum = torch.cat([seg_len.new_zeros(1), torch.cumsum(seg_len, 0)])
    per = cum[items[:, 2] + items[:, 3]] - cum[items[:, 2]]
    lanes = ck.tree_item_lanes(items[:, 1])
    out = {}
    for T in (4, 8, 16, 32):
        pick = lanes == T
        it = items[pick].contiguous()
        if it.shape[0] == 0:
            continue
        lane_pairs = int((2 * T * per[pick]).sum())
        ms = staged_ms(torch, lambda: kern(*ops, it, segs, 1.0), device)[0]
        out[T] = {"items": int(it.shape[0]), "lane_pairs": lane_pairs,
                  "busy": int((it[:, 1] * per[pick]).sum()) / lane_pairs,
                  "ms": ms, "lane_pairs_s": lane_pairs / ms * 1e3}
    log(f"[treecode] {kern.__name__} by target lanes T (items of that class "
        "alone): " + "; ".join(
            f"T = {T}: {r['items']} items, {r['lane_pairs']:.3e} lane pairs "
            f"({r['busy']:.3f} busy), {r['ms']:.3f} ms, "
            f"{r['lane_pairs_s']:.3e} lane pairs/s" for T, r in out.items()))
    return out


def tree_bound_ms(family, work, itemsize, peak):
    """Least time for the pass's work: max(its real pairs' flops / peak,
    its bytes / HBM rate); bytes = the targets, the real sources and the
    proxies of the cells with a source below them (position + payload),
    and the lists read once, the [n_trg, 3] output written once."""
    cols = SOURCE_WORDS[family]
    nbytes = (itemsize * (6 * work["n_trg"]
                          + cols * (work["n_src"] + work["proxies"]))
              + 8 * (4 * work["items"] + 2 * work["segments"]))
    t_ops = FLOPS_PER_PAIR[family] * work["pairs"] / peak
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tree_twin_check(torch, ck, device, family, prec, ops):
    """G / H against their plain twin on the card, on a cut of whole
    target leaves of ``ops`` (the TREE_CUT_LEAVES fullest and first): the
    kernel against the f64 twin on the same inputs (gates 1e-5 of the
    largest velocity in f32, 1e-12 in f64), both timed on the cut (the
    twin in the kernel's precision). Returns its record."""
    trg_s, sa, pa, items, segs = ops
    # a leaf's items share its segment range: a new range is a new leaf
    g0 = items[:, 2]
    new = torch.ones_like(g0, dtype=torch.bool)
    new[1:] = g0[1:] != g0[:-1]
    leaf_of = torch.cumsum(new.to(torch.int64), 0) - 1
    n_t = torch.zeros(int(leaf_of[-1]) + 1, dtype=torch.int64,
                      device=device).index_add_(0, leaf_of, items[:, 1])
    k = min(TREE_CUT_LEAVES, n_t.shape[0])
    pick = torch.unique(torch.cat([torch.topk(n_t, k).indices,
                                   torch.arange(k, device=device)]))
    cut = items[torch.isin(leaf_of, pick)]
    rows = torch.cat([torch.arange(int(a), int(a) + int(n), device=device)
                      for a, n in cut[:, :2].tolist()])
    kern = getattr(ck, f"tree_{family}_{prec}")
    plain = getattr(ck, f"tree_{family}_{prec}_plain")
    ms, got, _ = staged_ms(torch, lambda: kern(trg_s, sa, pa, cut, segs, 1.0),
                           device)
    plain_ms, _, _ = staged_ms(
        torch, lambda: plain(trg_s, sa, pa, cut, segs, 1.0), device)
    ref = getattr(ck, f"tree_{family}_f64_plain")(
        trg_s.double(), sa.double(), pa.double(), cut, segs, 1.0)[rows]
    got = got[rows].double()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    tol = 1e-5 if prec == "f32" else 1e-12
    pairs, lanes = tree_work(torch, ck, cut, segs)
    log(f"[treecode] {kern.__name__} against its plain twin on the card: "
        f"{len(pick)} whole target leaves ({int(rows.shape[0])} targets, "
        f"{cut.shape[0]} items, {pairs:.3e} pairs), max abs err {err:.3e}, "
        f"rel {rel:.3e} (gate {tol:g} of the largest velocity; reference "
        f"the f64 twin on the same inputs); kernel {ms:.3f} ms, twin "
        f"{plain_ms:.1f} ms on the cut")
    if not rel <= tol:
        raise SystemExit(f"{kern.__name__} misses its twin: {rel:.3e}")
    return {"max_abs_err": err, "max_rel_err": rel, "tolerance": tol,
            "ms_at_cut": ms, "plain_ms": plain_ms, "cut_leaves": len(pick),
            "cut_targets": int(rows.shape[0]), "cut_pairs": pairs}


def tree_sums(torch, ck, device, family, plan, src, pay, trg, ref, gate,
              tag):
    """Phase 12a / b at one plan: the f32 and f64 sums by stage
    (`tree_stages`), each against the dense f64-grade kernel's ``ref`` by
    the field-normalized error, gated at ``gate(prec)``, and (at System's
    tolerance) G / H against their plain twin on a cut
    (`tree_twin_check`) and timed in turns with their first design (the
    two within the twin's gate of each other). Returns {prec: record}."""
    out = {}
    at_tol = plan.tol == TREE_TOLS[0]
    for prec, dt in (("f32", torch.float32), ("f64", torch.float64)):
        u, times, work, ops, occ, same, v1 = tree_stages(
            torch, ck, device, family, plan, src.to(dt), pay.to(dt),
            trg.to(dt), at_tol)
        err = _field_rel(torch, u, ref)
        g = gate(prec)
        rate = work["pairs"] / times["kernel"] * 1e3
        peak = work["peak_gib"]
        log(f"[treecode] {tag} {prec} at tol {plan.tol:g}: field-normalized "
            f"err against the dense sum {err:.3e} (gate {g:g}); one sum "
            f"{times['sum']:.1f} ms through the entry with the step's "
            f"geometry kept ({times['sum_cold']:.1f} ms with a fresh "
            f"evaluator: the geometry {times['geometry']:.1f} ms, kept in "
            f"{work['geometry_gib']:.2f} GiB); the sum's stages: bucket "
            f"{times['bucket']:.1f}, upward {times['upward']:.1f}, kernel "
            f"{times['kernel']:.1f} (near alone {times['near']:.1f}, far "
            f"alone {times['far']:.1f}) ms (each the median of "
            f"{KERNEL_ROUNDS} after a warm-up); pairs near "
            f"{work['near'][0]:.3e}, far {work['far'][0]:.3e}, all "
            f"{work['pairs']:.3e} ({work['pairs'] / work['lane_pairs']:.3f} "
            f"of the {work['lane_pairs']:.3e} lane pairs issued; the first "
            f"design's {work['pairs'] / work['lane_pairs_v1']:.3f}), "
            f"{work['items']} items, {work['segments']} segments; kernel "
            f"rate {rate:.3e} pairs/s; fullest leaf {occ} of max_occ "
            f"{plan.max_occ}; two launches "
            f"{'bit for bit' if same else 'differ'}; peak of a fresh sum "
            f"{'not measured' if peak is None else f'{peak:.2f} GiB'}; "
            f"{card_state(device)}")
        if occ > plan.max_occ:
            raise SystemExit(f"{tag}: a leaf holds {occ} sources, more than "
                             f"max_occ {plan.max_occ}: sources were dropped")
        if not err <= g:
            raise SystemExit(f"{tag} {prec} misses its gate: {err:.3e} > "
                             f"{g:g}")
        if not same:
            raise SystemExit(f"{tag} {prec}: two launches differ")
        out[prec] = {"field_rel_err": err, "gate": g, "stages_ms": times,
                     "work": work, "rate_pairs_s": rate,
                     "fullest_leaf": occ, "peak_gib": peak,
                     "card_state": card_state(device)}
        if at_tol:
            twin = tree_twin_check(torch, ck, device, family, prec, ops)
            out[prec]["twin"] = twin
            out[prec]["v1"] = v1
            if not v1["max_rel_diff"] <= twin["tolerance"]:
                raise SystemExit(f"{tag} {prec}: the redesign is "
                                 f"{v1['max_rel_diff']:.3e} off its first "
                                 "design")
        del u, ops
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def tree_plan_record(ttc, plan, plan_s, tag):
    maxI = ttc._interaction_lists(plan.depth)[0].shape[1]
    log(f"[treecode] {tag} plan at tol {plan.tol:g}: {plan_s:.3f} s on the "
        f"host; depth {plan.depth}, order p = {plan.order} ({plan.order ** 3} "
        f"proxies a cell), max_occ {plan.max_occ}, maxI {maxI}, box "
        f"{plan.box_L:.4f}")
    return {"plan_s": plan_s, "depth": plan.depth, "order": plan.order,
            "max_occ": plan.max_occ, "maxI": int(maxI)}


def tree_at_10k(torch, ck, device, nodes, f, a_ms, b_ms):
    """Phase 12a: the 640k cloud of phase 3 through the tree Stokeslet at
    each of TREE_TOLS, f32 and f64 (`tree_sums`), against kernel B on
    every row: gates plan.tol in f64 and max(plan.tol, 1e-5) in f32; one
    sum beside kernels A's and B's phase-3 times."""
    from skellysim_tpu_torch.ops import treecode as ttc

    src = torch.as_tensor(nodes, dtype=torch.float32, device=device).double()
    pay = torch.as_tensor(f, dtype=torch.float32, device=device).double()
    ref = ck.stokeslet_f64(src, src, pay, 1.0)
    n = len(nodes)
    out = {"a_ms": a_ms, "b_ms": b_ms, "shape": [n, n]}
    for tol in TREE_TOLS:
        t0 = time.perf_counter()
        plan = ttc.plan_tree(nodes, tol=tol)
        rec = tree_plan_record(ttc, plan, time.perf_counter() - t0,
                               f"Stokeslet {n} x {n}")
        rec.update(tree_sums(
            torch, ck, device, "stokeslet", plan, src, pay, src, ref,
            lambda prec: plan.tol if prec == "f64" else max(plan.tol, 1e-5),
            f"Stokeslet {n} x {n}"))
        for prec, dense in (("f32", a_ms), ("f64", b_ms)):
            r = rec[prec]
            dense_rate = n * n / dense * 1e3
            log(f"[treecode] Stokeslet {prec} at tol {tol:g}: one sum "
                f"{r['stages_ms']['sum']:.1f} ms against kernel "
                f"{'A' if prec == 'f32' else 'B'}'s {dense:.1f} ms (x "
                f"{r['stages_ms']['sum'] / dense:.3f}); G "
                f"{r['rate_pairs_s']:.3e} pairs/s against the dense kernel's "
                f"{dense_rate:.3e}")
        out[f"tol_{tol:g}"] = rec
    return out


def tree_stresslet_at_shell(torch, ck, device, fiber_nodes, shell_nodes,
                            f_dl):
    """Phase 12b: the shell's 8,000 nodes onto every node (phase 6's shape)
    through the tree stresslet at System's tree_tol (TREE_TOLS[0]), f32 and
    f64 (`tree_sums`), against kernel D on every row: gate
    TREE_STRESSLET_GATE x plan.tol; beside kernels C's and D's times at
    the shape."""
    import numpy as np

    from skellysim_tpu_torch.ops import treecode as ttc

    every = np.concatenate([fiber_nodes, shell_nodes])
    src, trg, S = (torch.as_tensor(a, dtype=torch.float32,
                                   device=device).double()
                   for a in (shell_nodes, every, f_dl))
    S = S.reshape(-1, 9)
    ref = ck.stresslet_f64(src, trg, S, 1.0)
    c_ms = kernel_ms(torch, lambda: ck.stresslet_f32(
        src.float(), trg.float(), S.float(), 1.0), device)[0]
    d_ms = kernel_ms(torch, lambda: ck.stresslet_f64(src, trg, S, 1.0),
                     device)[0]
    t0 = time.perf_counter()
    plan = ttc.plan_tree(every, tol=TREE_TOLS[0])
    tag = f"stresslet {len(shell_nodes)} x {len(every)}"
    rec = tree_plan_record(ttc, plan, time.perf_counter() - t0, tag)
    rec.update({"c_ms": c_ms, "d_ms": d_ms,
                "shape": [len(shell_nodes), len(every)]})
    rec.update(tree_sums(torch, ck, device, "stresslet", plan, src, S, trg,
                         ref, lambda prec: TREE_STRESSLET_GATE * plan.tol,
                         tag))
    for prec, dense, name in (("f32", c_ms, "C"), ("f64", d_ms, "D")):
        log(f"[treecode] {tag} {prec}: one sum "
            f"{rec[prec]['stages_ms']['sum']:.2f} ms against kernel {name}'s "
            f"{dense:.3f} ms")
    return rec


def ptxas_spills(report, pattern):
    """Spill bytes (stores + loads) of the one kernel whose mangled name
    matches, from a `-Xptxas -v` report."""
    spills, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            spills[current] = int(m.group(1)) + int(m.group(2))
    names = [k for k in spills if re.search(pattern, k)]
    if len(names) != 1:
        raise SystemExit(f"ptxas: {len(names)} kernels match {pattern!r}: "
                         f"{names}")
    return spills[names[0]]


def tree_entries(torch, ck, cuda_build, device, at_10k, at_shell, card):
    """The kernels line's entries of G and H (f32, f64): time (in turns
    with their first design), work, lane-busy share and bound at the
    phase-12a (G, System's tol) and 12b (H) shapes, the check against the
    plain twin on a cut (12c), both designs' hot-loop SASS, the issue-slot
    bounds they give at the SM clock read after the timed launches (on the
    real pairs and on the lane pairs each issues), registers, shared bytes
    and spills."""
    on_card = device.type == "cuda"
    sass, sms = {}, None
    if on_card:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        sass = sass_functions(cuda_build,
                              cuda_build.library_path(ck.TREE_SOURCE))
        report = cuda_build.build(ck.TREE_SOURCE)["ptxas"]
    entries = []
    for family, rec in (("stokeslet", at_10k[f"tol_{TREE_TOLS[0]:g}"]),
                        ("stresslet", at_shell)):
        for prec in ("f32", "f64"):
            r = rec[prec]
            work, twin, v1 = r["work"], r["twin"], r["v1"]
            peak = PEAK_FP32 if prec == "f32" else PEAK_FP64
            b_ms, b_by = tree_bound_ms(family, work,
                                       4 if prec == "f32" else 8, peak)
            ms = v1["new_ms"]
            name = f"tree_{family}_{prec}"
            entry = {"name": name, "route": "cuda",
                     "source": f"skellysim_tpu_torch/csrc/{ck.TREE_SOURCE}.cu",
                     "replaces": TREE_REPLACES, "launches": 0,
                     "max_abs_err": twin["max_abs_err"],
                     "max_rel_err": twin["max_rel_err"],
                     "tolerance": twin["tolerance"], "ms": ms,
                     "ms_turns": v1["new_ms_turns"],
                     "plain_ms": twin["plain_ms"],
                     "plain_ms_shape": "the cut of whole target leaves "
                                       "(ms_at_cut is the kernel's there)",
                     "ms_at_cut": twin["ms_at_cut"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "previous_ms": v1["ms"],
                     "previous_ms_turns": v1["ms_turns"],
                     "previous_source": f"skellysim_tpu_torch/csrc/"
                                        f"{ck.TREE_SOURCE}.cu ({name}_v1)",
                     "max_rel_diff_vs_previous": v1["max_rel_diff"],
                     "shape": [work["n_src"], work["n_trg"]],
                     "plan": {k: rec[k] for k in ("depth", "order",
                                                  "max_occ", "maxI")},
                     "pairs": work["pairs"], "lane_pairs": work["lane_pairs"],
                     "lane_busy": work["pairs"] / work["lane_pairs"],
                     "previous_lane_pairs": work["lane_pairs_v1"],
                     "previous_lane_busy": work["pairs"]
                     / work["lane_pairs_v1"],
                     "items": work["items"], "previous_items":
                         work["items_v1"],
                     "near_pairs": work["near"][0],
                     "far_pairs": work["far"][0],
                     "field_rel_err_vs_dense": r["field_rel_err"],
                     "stages_ms": r["stages_ms"]}
            if on_card:
                mhz = float(re.search(r"SM clock (\d+)", v1["new_ms_turns"][
                    -1]["card_state"]).group(1))
                c = "f" if prec == "f32" else "d"
                kind = rf"I{c}Li{SOURCE_WORDS[family] - 3}E"
                per, fp64, per_pass = _sass_loop(sass, rf"tree_kernel{kind}")
                o_per, o_fp64, _ = _sass_loop(sass,
                                              rf"tree_v1_kernel{kind}")
                regs, smem = ptxas_usage(report, rf"tree_kernel{kind}")
                o_regs, o_smem = ptxas_usage(report, rf"tree_v1_kernel{kind}")
                dyn = ck.tree_shared_bytes(family, prec)

                def issue(per_pair, fp64_per_pair, pairs):
                    b = issue_bound_ms(per_pair, pairs, sms, mhz, 128)
                    if prec == "f64":
                        b = max(b, issue_bound_ms(fp64_per_pair, pairs, sms,
                                                  mhz, 64))
                    return b

                entry.update({
                    "registers": regs, "shared_bytes": smem + dyn,
                    "spill_bytes": ptxas_spills(report,
                                                rf"tree_kernel{kind}"),
                    "previous_registers": o_regs,
                    "previous_shared_bytes": o_smem,
                    "previous_spill_bytes": ptxas_spills(
                        report, rf"tree_v1_kernel{kind}"),
                    "sass_per_pair": per, "sass_fp64_per_pair": fp64,
                    "sass_pairs_a_pass": per_pass,
                    "previous_sass_per_pair": o_per,
                    "previous_sass_fp64_per_pair": o_fp64,
                    "issue_bound_ms": issue(per, fp64, work["pairs"]),
                    "issue_bound_lane_pairs_ms":
                        issue(per, fp64, work["lane_pairs"]),
                    "previous_issue_bound_ms":
                        issue(o_per, o_fp64, work["pairs"]),
                    "previous_issue_bound_lane_pairs_ms":
                        issue(o_per, o_fp64, work["lane_pairs_v1"]),
                    "sm_clock_mhz": mhz})
                log(f"[treecode] {name}: {ms:.3f} ms against its first "
                    f"design's {v1['ms']:.3f} ms ({v1['ms'] / ms:.3f}x); "
                    f"SASS hot loop {per:.3f} instructions a pair "
                    f"({fp64:.3f} FP64; {per_pass} pairs a pass), the first "
                    f"design's {o_per:.3f} ({o_fp64:.3f} FP64); issue-slot "
                    f"bound {entry['issue_bound_ms']:.3f} ms on the real "
                    f"pairs ({100 * entry['issue_bound_ms'] / ms:.1f}%), "
                    f"{entry['issue_bound_lane_pairs_ms']:.3f} ms on its "
                    f"lane pairs "
                    f"({100 * entry['issue_bound_lane_pairs_ms'] / ms:.1f}%;"
                    f" busy {entry['lane_busy']:.3f}); the first design's "
                    f"{entry['previous_issue_bound_ms']:.3f} / "
                    f"{entry['previous_issue_bound_lane_pairs_ms']:.3f} ms "
                    f"(busy {entry['previous_lane_busy']:.3f}); flop bound "
                    f"{b_ms:.3f} ms ({b_by}, {100 * b_ms / ms:.1f}%); "
                    f"{regs} registers, {smem} + {dyn} dynamic bytes shared, "
                    f"{entry['spill_bytes']} bytes spilled (the first "
                    f"design's {o_regs}, {o_smem}, "
                    f"{entry['previous_spill_bytes']}); {sms} SMs at "
                    f"{mhz:.0f} MHz; this card: {card}")
            entries.append(entry)
    log("[treecode] no single PyTorch call computes the treecode's pair "
        "pass: library_ms is null")
    return entries


def tree_sync_check(torch, ck, device):
    """Phase 12f: one "tree" matvec's pair flows (the fiber, shell and
    body flows of `System._apply_matvec`'s f32 view in "mixed") on the
    small coupled scene (`testing.make_coupled_scene`, its shell and body
    through the tree: ewald_min_sources 50), run once to build the step's
    geometry, then again under `torch.cuda.set_sync_debug_mode("error")`,
    where a host sync raises; gated on the same bits both times and on G
    and H launching. Returns its record."""
    import numpy as np

    from skellysim_tpu_torch.bodies import bodies as bd
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.system.system import body_buckets
    from skellysim_tpu_torch.testing import make_coupled_scene

    p = Params(dt_initial=0.02, solver_precision="mixed",
               pair_evaluator="tree", ewald_min_sources=50)
    shell, shape, bodies, fibers = make_coupled_scene(shell_n=400,
                                                      body_n=100,
                                                      device=device)
    system = System(p, shell_shape=shape, device=device)
    state = system.make_state(fibers=fibers, shell=shell, bodies=bodies)
    pair = system._pair_args(state)
    state, caches, body_caches, _, _ = system._prep(state, pair=pair)
    lo_state, lo_caches, lo_bcaches = system._lo_view(state, caches,
                                                      body_caches)
    r_all = system._node_positions(lo_state, lo_bcaches)
    nf, ns, _ = system._counts(state)
    r_fb = torch.cat([r_all[:nf], r_all[nf + ns:]])
    rng = np.random.default_rng(5)
    forces = [torch.as_tensor(rng.standard_normal(tuple(c.xs.shape)),
                              dtype=torch.float32, device=device)
              for c in lo_caches]
    density = torch.as_tensor(rng.standard_normal(3 * ns),
                              dtype=torch.float32, device=device)
    groups = body_buckets(lo_state.bodies)
    x_b = [torch.as_tensor(rng.standard_normal((g.n_bodies, 3 * g.n_nodes)),
                           dtype=torch.float32, device=device)
           for g in groups]
    ft = [torch.zeros((g.n_bodies, 6), dtype=torch.float32, device=device)
          for g in groups]

    def flows():
        out = [system._fiber_flow(lo_state, lo_caches, r_all, forces,
                                  pair=pair),
               system._shell_flow(lo_state, r_fb, density, pair=pair)]
        for j, (g, bc, xb, f) in enumerate(zip(groups, lo_bcaches, x_b,
                                               ft)):
            out.append(bd.flow(g, bc, r_all, xb, f, p.eta,
                               pair=system._body_pair(g, pair, j)))
        return out

    first = flows()
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_counts(ck)
    if device.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        again = flows()
    finally:
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    counts = read_counts(ck)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"[tree_sync] the coupled scene's f32 pair flows through \"tree\" "
        f"(depth {pair.plan.depth}, {len(pair.geometry)} geometries kept): "
        f"again under torch.cuda.set_sync_debug_mode(\"error\"): no host "
        f"sync{'' if device.type == 'cuda' else ' (not checked: CPU)'}; "
        f"same bits {same}; launches G f32 {counts['tree_stokeslet_f32']}, "
        f"H f32 {counts['tree_stresslet_f32']}")
    if pair.plan.depth < 2 or not same:
        raise SystemExit("tree sync check: the scene is no tree, or the "
                         "flows changed bits")
    if device.type == "cuda" and not (counts["tree_stokeslet_f32"]
                                      and counts["tree_stresslet_f32"] >= 2):
        raise SystemExit(f"tree sync check: G / H did not launch: {counts}")
    return {"depth": pair.plan.depth, "geometries": len(pair.geometry),
            "same_bits": same, "launches": counts}


def shard_bytes(torch, st):
    """Bytes the tensors of one shard's state hold (a view counted at its
    own extent, not its storage's)."""
    total = 0
    for part in (st.fibers, st.shell, st.bodies, st.points, st.background):
        groups = part if isinstance(part, tuple) and not hasattr(
            part, "_fields") else [part]
        for g in groups:
            for v in (g or ()):
                if torch.is_tensor(v):
                    total += v.numel() * v.element_size()
    return total


def matvec_syncs(torch, device, system, mesh, sharded):
    """Host syncs of one matvec and one preconditioner application of the
    sharded step's Krylov interior ("mixed": its f32 view), counted under
    `torch.cuda.set_sync_debug_mode("warn")` after a first call of each;
    None on the CPU."""
    import warnings

    from skellysim_tpu_torch.parallel.spmd import ShardVec, build_spmd_step

    if device.type != "cuda":
        return None
    step = build_spmd_step(system, mesh, sharded)
    sts, caches, bcs, _, _ = step.prep(list(sharded.shards))
    if step.precision == "mixed":
        views = [system._lo_view(*a) for a in zip(sts, caches, bcs)]
        lo = tuple([v[i] for v in views] for i in range(3))
        matvec = step.make_matvec(sts, caches, bcs, lo=lo)
        precond = step.make_precond(*lo)
    else:
        matvec = step.make_matvec(sts, caches, bcs)
        precond = step.make_precond(sts, caches, bcs)
    x = ShardVec(torch.cat([c.RHS.reshape(-1) for c in cs]
                           + [st.shell.density])
                 for cs, st in zip(caches, sts))
    matvec(precond(x))
    torch.cuda.synchronize()
    counts = {}
    for name, fn in (("matvec", matvec), ("precond", precond)):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counts[name] = sum("synchroniz" in str(w.message) for w in seen)
        if seen:
            counts[f"{name}_messages"] = sorted({str(w.message)[:200]
                                                 for w in seen})
        if counts[name]:
            # where: the same call again, raising at the first sync
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(x)
            except RuntimeError as e:
                import traceback

                frames = traceback.extract_tb(e.__traceback__)[-3:]
                counts[f"{name}_first_at"] = [
                    f"{os.path.relpath(f.filename, REPO)}:{f.lineno} "
                    f"{f.line}" for f in frames]
            finally:
                torch.cuda.set_sync_debug_mode(0)
    return counts


def spmd_pair(torch, ck, device, system, mesh, sharded, state0, tag, i):
    """One `System.step` from the gathered sharded state (the shell's
    operators the very tensors the shards view) and one
    `System.step_spmd` from the sharded state, each timed to a
    `torch.cuda.synchronize()` with its own peak device memory; the sharded
    step alone with every launch count set to 0 just before and read just
    after. Returns (the sharded step's result, a record)."""
    from skellysim_tpu_torch.parallel import gather_state

    ref_in = gather_state(sharded, shell_operators=False)
    if ref_in.shell is not None:
        ref_in = ref_in._replace(shell=ref_in.shell._replace(
            M_inv=state0.shell.M_inv,
            stresslet_plus_complementary=(
                state0.shell.stresslet_plus_complementary)))

    def run(fn):
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device.type == "cuda" else None)
        return out, time.perf_counter() - t0, peak

    (r_state, r_sol, r_info), r_wall, r_peak = run(lambda: system.step(ref_in))
    del ref_in
    reset_counts(ck)
    (s_state, s_sol, s_info), s_wall, s_peak = run(
        lambda: system.step_spmd(sharded, mesh))
    counts = read_counts(ck)
    x_sp = gather_state(s_state, shell_operators=False)
    dx = max(float((a.x - b.x).abs().max()) for a, b in zip(
        fiber_groups(x_sp.fibers), fiber_groups(r_state.fibers)))
    gap = abs(s_info.residual_true - r_info.residual_true)
    nan = bool(torch.isnan(s_sol).any())
    rec = {"step": i, "wall_s": s_wall, "step_wall_s": r_wall,
           "iters": s_info.iters, "step_iters": r_info.iters,
           "refines": s_info.refines, "step_refines": r_info.refines,
           "residual_true": s_info.residual_true,
           "step_residual_true": r_info.residual_true, "residual_gap": gap,
           "max_dx": dx, "health": s_info.health, "nan": nan,
           "peak_gib": s_peak, "step_peak_gib": r_peak,
           "launches": {k: v for k, v in counts.items() if v}}
    peaks = ("not measured" if s_peak is None
             else f"{s_peak:.2f} GiB (System.step {r_peak:.2f})")
    log(f"[{tag}] step {i}: step_spmd {s_wall:.3f} s, {s_info.iters} "
        f"iterations / {s_info.refines} sweeps, true residual "
        f"{s_info.residual_true:.3e}; System.step {r_wall:.3f} s, "
        f"{r_info.iters} / {r_info.refines}, {r_info.residual_true:.3e}; "
        f"residual gap {gap:.3e} (gate {PARITY_GATE}), max |dx| {dx:.3e} "
        f"(gate {SPMD_DX}); peak {peaks}; launches {rec['launches']}")
    if not (s_info.converged and r_info.converged and s_info.health == 0
            and not nan and s_info.residual_true <= 1e-8):
        raise SystemExit(f"{tag}: step {i} of the sharded step is not "
                         f"converged / healthy: {s_info}")
    if any(counts[w.__name__] for w in ck.YARDSTICK_WRAPPERS):
        raise SystemExit(f"{tag}: a yardstick kernel launched: {counts}")
    return (s_state, s_sol, s_info, counts), rec, (r_state, r_sol)


def fiber_groups(fibers):
    return (fibers,) if hasattr(fibers, "_fields") else tuple(fibers)


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def spmd_body_state(torch, system, state):
    """Phase 13b's scene: ``state`` (the ellipsoid) plus one sphere body of
    `SPMD_BODY_NODES` nodes at the cell's centre with `SPMD_BOUND_FIBERS`
    sites, one clamped 16-node fiber of length 0.6 bound to each and
    pointing outward (`testing.make_coupled_scene`'s recipe at this
    size), a second fiber bucket; sites from default_rng(0)."""
    import numpy as np

    from skellysim_tpu_torch.bodies import bodies as bd
    from skellysim_tpu_torch.fibers import container as fc
    from skellysim_tpu_torch.periphery.precompute import precompute_body

    device = system.device
    rng = np.random.default_rng(0)
    u = rng.standard_normal((SPMD_BOUND_FIBERS, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sites = 0.5 * u
    pre = precompute_body("sphere", SPMD_BODY_NODES, radius=0.5)
    body = bd.make_group(
        pre["node_positions_ref"], pre["node_normals_ref"],
        pre["node_weights"], position=np.zeros((1, 3)),
        external_force=np.array([[0.0, 0.0, 0.5]]), nucleation_sites_ref=sites,
        radius=np.array([0.5]), kind="sphere", device=device)
    t = np.linspace(0.0, 1.0, 16)
    x = sites[:, None, :] + 0.6 * t[None, :, None] * u[:, None, :]
    n = SPMD_BOUND_FIBERS
    bound = fc.make_group(
        x, lengths=0.6, bending_rigidity=2.5e-3, radius=0.0125,
        force_scale=-0.05, minus_clamped=True, binding_body=np.zeros(n),
        binding_site=np.arange(n), device=device)
    return system.make_state(
        fibers=(fiber_groups(state.fibers)[0], bound), shell=state.shell,
        bodies=body)


def phase_spmd(torch, ck, device, ring_inputs):
    """Phase 13, the sharded step (`System.step_spmd`) on `SPMD_SHARDS`
    shards of the card, every step held against `System.step` from the
    same state (a-c). Returns (the phase's summary, launch counts by
    run)."""
    import dataclasses

    from skellysim_tpu_torch.builder import build_simulation
    from skellysim_tpu_torch.config import schema
    from skellysim_tpu_torch.parallel import make_mesh, shard_state
    from skellysim_tpu_torch.system import System

    cfg_path = ring_inputs["cfg_path"]
    config = schema.load_config(cfg_path)
    t0 = time.perf_counter()
    system, state, _ = build_simulation(
        config, config_dir=os.path.dirname(cfg_path), device=device)
    build_s = time.perf_counter() - t0
    mesh = make_mesh(SPMD_SHARDS, device=device)
    sharded = shard_state(state, mesh)
    per_shard = [shard_bytes(torch, st) for st in sharded.shards]
    log(f"[spmd] phase 6's ellipsoid config on {mesh.size} shards of "
        f"{mesh.devices[0]}: state built in {build_s:.1f} s (the shell "
        f"npz load included); state bytes a shard "
        f"{[round(b / 2**30, 3) for b in per_shard]} GiB (the whole state "
        f"{shard_bytes(torch, state) / 2**30:.3f} GiB); the shards view "
        f"the state's tensors (no copy)")
    out = {"shards": mesh.size, "build_s": build_s,
           "shard_gib": [b / 2**30 for b in per_shard],
           "state_gib": shard_bytes(torch, state) / 2**30}
    launches = {}

    # a. three "mixed" steps (the card's "auto") and one "full"
    initial = sharded
    recs, total, refs = [], {}, {}
    for i in range(SPMD_MIXED_STEPS):
        res, rec, _ = spmd_pair(torch, ck, device, system, mesh, sharded,
                                state, "spmd", i)
        if i == 0:
            refs["mixed"] = spmd_reference(torch, res[0], res[2])
        sharded = res[0]
        recs.append(rec)
        add_counts(total, res[3])
    out["syncs"] = matvec_syncs(torch, device, system, mesh, sharded)
    log(f"[spmd] host syncs of one Krylov matvec / preconditioner "
        f"application: {out['syncs'] or 'not measured (CPU rehearsal)'}")
    full = System(dataclasses.replace(system.params, solver_precision="full"),
                  shell_shape=system.shell_shape, device=device)
    # phase 14's other reference: one "full" step from the initial state
    new, _, info = full.step_spmd(initial, mesh)
    refs["full"] = spmd_reference(torch, new, info)
    del initial, new
    before_full = sharded
    res, rec, _ = spmd_pair(torch, ck, device, full, mesh, sharded, state,
                            "spmd_full", SPMD_MIXED_STEPS)
    full_sharded = res[0]
    recs.append(rec)
    launches["spmd_ellipsoid"] = total
    launches["spmd_ellipsoid_full"] = res[3]
    out["ellipsoid"] = recs
    if device.type == "cuda":
        need = {"spmd_ellipsoid": ["ring_stokeslet_f32", "ring_stresslet_f32",
                                   "stokeslet_f64", "stresslet_f64"],
                "spmd_ellipsoid_full": ["stokeslet_f64", "stresslet_f64"]}
        for run, names in need.items():
            if not all(launches[run][k] for k in names):
                raise SystemExit(f"spmd: a kernel of {run} never launched: "
                                 f"{launches[run]}")
    for r in recs:
        if not (r["residual_gap"] <= PARITY_GATE and r["max_dx"] <= SPMD_DX):
            raise SystemExit(f"spmd: step {r['step']} differs from "
                             f"System.step: {r}")

    # b. the ellipsoid plus a body with bound fibers: replicated rows
    bstate = spmd_body_state(torch, system, state)
    bsharded = shard_state(bstate, mesh)
    res, rec, _ = spmd_pair(torch, ck, device, system, mesh, bsharded,
                            bstate, "spmd_body", 0)
    bodies = [st.bodies for st in res[0].shards]
    same = all(torch.equal(getattr(bodies[0], f), getattr(b, f))
               for b in bodies[1:] for f in b._fields
               if torch.is_tensor(getattr(b, f)))
    rec["replicated_same_bits"] = same
    out["body"] = rec
    launches["spmd_body"] = res[3]
    log(f"[spmd_body] a {SPMD_BODY_NODES}-node sphere with "
        f"{SPMD_BOUND_FIBERS} bound 16-node fibers (a second bucket) in the "
        f"ellipsoid: the body's fields the same bits on all {mesh.size} "
        f"shards: {same}")
    if not (same and rec["residual_gap"] <= PARITY_GATE
            and rec["max_dx"] <= SPMD_DX):
        raise SystemExit(f"spmd_body: the step differs from System.step or "
                         f"the replicated rows differ between shards: {rec}")
    if device.type == "cuda" and not all(
            res[3][k] for k in ("stokeslet_f32", "stresslet_f32",
                                "ring_stokeslet_f32", "stokeslet_f64")):
        raise SystemExit(f"spmd_body: the replicated rows' partials did not "
                         f"launch A / C: {res[3]}")
    del bstate, bsharded, res
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # c. "tree", one "full" step from the state before a's "full" step
    tree = System(dataclasses.replace(system.params, solver_precision="full",
                                      pair_evaluator="tree"),
                  shell_shape=system.shell_shape, device=device)
    reset_counts(ck)
    t0 = time.perf_counter()
    t_state, t_sol, t_info = tree.step_spmd(before_full, mesh)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(ck)
    launches["spmd_tree"] = counts
    nan = [bool(torch.isnan(fiber_groups(st.fibers)[0].x).any())
           for st in t_state.shards]
    dx = max(float((fiber_groups(a.fibers)[0].x
                    - fiber_groups(b.fibers)[0].x).abs().max())
             for a, b in zip(t_state.shards, full_sharded.shards))
    out["tree"] = {"wall_s": wall, "iters": t_info.iters,
                   "residual_true": t_info.residual_true, "max_dx": dx,
                   "nan_by_shard": nan, "health": t_info.health,
                   "launches": {k: v for k, v in counts.items() if v}}
    log(f"[spmd_tree] one \"full\" step through \"tree\" on {mesh.size} "
        f"shards: {wall:.3f} s (the host plan included), {t_info.iters} "
        f"iterations, true residual {t_info.residual_true:.3e}, NaN by "
        f"shard {nan}, max |dx| against a's direct \"full\" step {dx:.3e} "
        f"(gate {SPMD_TREE_DX}); launches {out['tree']['launches']}")
    if any(nan) or not (t_info.converged and t_info.health == 0
                        and dx <= SPMD_TREE_DX):
        raise SystemExit(f"spmd_tree: the step failed its gate: {out['tree']}")
    if device.type == "cuda" and not counts["tree_stokeslet_f64"]:
        raise SystemExit(f"spmd_tree: G never launched: {counts}")
    return out, launches, refs


def spmd_reference(torch, sharded, info):
    """What phase 14 holds its steps against: the fibers of a sharded
    step's result (gathered, on the host) and its solve's numbers."""
    from skellysim_tpu_torch.parallel import gather_state

    g = gather_state(sharded, shell_operators=False)
    return {"x": [grp.x.cpu() for grp in fiber_groups(g.fibers)],
            "iters": info.iters, "refines": info.refines,
            "residual_true": info.residual_true}


def spmd_worker(argv) -> int:
    """One process of phase 14 (``chip_smoke.py --spmd-worker CFG PORT
    RANK WORLD DEVICE OUT``): joins the others
    (`parallel.multihost.initialize` over tcp://localhost:PORT on DEVICE,
    the card the processes share, so `gloo`), builds phase 6's config on
    the card, keeps its `SPMD_SHARDS` / WORLD shards of the mesh that spans
    the processes and drops the rest, then takes one "full" and one
    "mixed" `System.step_spmd` from that state, each with the launch
    counts and the staged bytes set to 0 just before and the peak device
    memory reset, timed to a synchronize; saves the records and the
    gathered fibers to OUT."""
    import dataclasses

    import torch
    import torch.distributed

    cfg_path, port, rank, world, card, out_path = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    from skellysim_tpu_torch.builder import build_simulation
    from skellysim_tpu_torch.config import schema
    from skellysim_tpu_torch.ops import cuda_kernels as ck
    from skellysim_tpu_torch.parallel import (gather_state,
                                              initialize_multihost,
                                              make_mesh, multihost,
                                              shard_state)
    from skellysim_tpu_torch.parallel.compat import fused_ring_mode
    from skellysim_tpu_torch.system import System

    t0 = time.perf_counter()
    initialize_multihost(f"localhost:{port}", world, rank, device=card)
    rt = multihost.runtime()
    device = rt.device
    on_card = device.type == "cuda"
    config = schema.load_config(cfg_path)
    system, state, _ = build_simulation(
        config, config_dir=os.path.dirname(cfg_path), device=device)
    mesh = make_mesh(SPMD_SHARDS // world, device=device)
    sharded = shard_state(state, mesh)
    del state
    build_peak = None
    if on_card:
        torch.cuda.synchronize()
        build_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.empty_cache()
    rec = {"rank": rank, "device": str(device), "backend": rt.backend,
           "route": fused_ring_mode("pallas", device, mesh),
           "shards": list(mesh.local), "build_s": time.perf_counter() - t0,
           "build_peak_gib": build_peak,
           "shard_gib": [shard_bytes(torch, st) / 2**30
                         for st in sharded.shards]}
    full = System(dataclasses.replace(system.params, solver_precision="full"),
                  shell_shape=system.shell_shape, device=device)
    for label, sys_ in (("full", full), ("mixed", system)):
        reset_counts(ck)
        rt.staged_bytes = 0
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        multihost.barrier()
        t = time.perf_counter()
        new, _, info = sys_.step_spmd(sharded, mesh)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts(ck)
        staged = rt.staged_bytes
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        ref = spmd_reference(torch, new, info)
        rec[label] = dict(ref, wall_s=wall, converged=info.converged,
                          health=info.health, staged_bytes=staged,
                          peak_gib=peak, launches=counts)
        del new
    torch.save(rec, out_path)
    multihost.barrier()
    torch.distributed.destroy_process_group()
    log(f"[spmd_processes] process {rank} done: "
        + json.dumps({k: v for k, v in rec.items()
                      if k not in ("full", "mixed")}))
    return 0


def phase_spmd_processes(torch, ck, device, ring_inputs, refs, work, smi):
    """Phase 14, the sharded step across processes: `SPMD_PROCESSES`
    worker processes of this script (`spmd_worker`, started with
    `subprocess`) on the card, each holding `SPMD_SHARDS` /
    `SPMD_PROCESSES` shards of one mesh, joined over `gloo` (NCCL refuses
    two processes on one card); each takes one "full" and one "mixed" step
    of phase 6's config, held against phase 13's one-process step on
    `SPMD_SHARDS` shards from the same state. A worker that fails or
    outlives `SPMD_WORKER_TIMEOUT_S` fails the phase (the others are
    killed). Returns (the phase's summary, launch counts by run, summed
    over the processes)."""
    from skellysim_tpu_torch.testing import free_port, run_all

    if device.type == "cuda":
        torch.cuda.empty_cache()
    port = free_port()
    outs = [os.path.join(work, f"spmd_worker_{r}.pt")
            for r in range(SPMD_PROCESSES)]
    card = str(device if device.type == "cpu" else torch.device(
        "cuda", torch.cuda.current_device()))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SKELLY_")}
    t0 = time.perf_counter()
    try:
        texts = run_all(
            [([sys.executable, os.path.abspath(__file__), "--spmd-worker",
               ring_inputs["cfg_path"], str(port), str(r),
               str(SPMD_PROCESSES), card, outs[r]], env, REPO)
             for r in range(SPMD_PROCESSES)],
            work, "spmd_worker", SPMD_WORKER_TIMEOUT_S)
    except RuntimeError as e:
        raise SystemExit(f"spmd_processes: {e}") from e
    wall = time.perf_counter() - t0
    for r, text in enumerate(texts):
        for ln in text.splitlines():
            if ln.startswith("[spmd_processes]"):
                log(f"[spmd_processes] worker {r}: {ln}")
    recs = [torch.load(o, weights_only=False) for o in outs]
    out = {"processes": SPMD_PROCESSES, "shards": SPMD_SHARDS,
           "wall_s": wall, "route": recs[0]["route"],
           "backend": recs[0]["backend"],
           "build_s": [r["build_s"] for r in recs],
           "build_peak_gib": [r["build_peak_gib"] for r in recs],
           "shard_gib": [r["shard_gib"] for r in recs]}
    launches = {}
    for label in ("full", "mixed"):
        ref = refs[label]
        steps = [r[label] for r in recs]
        same = all(torch.equal(a, b) for st in steps
                   for a, b in zip(st["x"], ref["x"]))
        dx = max(float((a - b).abs().max()) for st in steps
                 for a, b in zip(st["x"], ref["x"]))
        gap = max(abs(st["residual_true"] - ref["residual_true"])
                  for st in steps)
        agree = all(torch.equal(a, b) for a, b in zip(steps[0]["x"],
                                                      steps[-1]["x"]))
        by_process = {r: {k: v for k, v in st["launches"].items() if v}
                      for r, st in enumerate(steps)}
        launches[f"spmd_processes_{label}"] = {
            k: sum(st["launches"][k] for st in steps)
            for k in steps[0]["launches"]}
        out[label] = {
            "wall_s": [st["wall_s"] for st in steps],
            "iters": [st["iters"] for st in steps],
            "refines": [st["refines"] for st in steps],
            "one_process_iters": ref["iters"],
            "residual_true": steps[0]["residual_true"],
            "one_process_residual_true": ref["residual_true"],
            "residual_gap": gap, "max_dx": dx, "same_bits": same,
            "processes_same_bits": agree,
            "staged_bytes": [st["staged_bytes"] for st in steps],
            "peak_gib": [st["peak_gib"] for st in steps],
            "launches_by_process": by_process}
        log(f"[spmd_processes] {label}: step_spmd in {SPMD_PROCESSES} "
            f"processes x {SPMD_SHARDS // SPMD_PROCESSES} shards on {card} "
            f"(route {out['route']}, {out['backend']}): wall a step by "
            f"process {[round(w, 3) for w in out[label]['wall_s']]} s, "
            f"{steps[0]['iters']} iterations / {steps[0]['refines']} sweeps "
            f"(one process: {ref['iters']} / {ref['refines']}), true "
            f"residual {steps[0]['residual_true']:.3e} (one process "
            f"{ref['residual_true']:.3e}, gap {gap:.3e}, gate "
            f"{PARITY_GATE}), max |dx| {dx:.3e} (gate {SPMD_DX}), the "
            f"one-process step's bits: {same}, both processes' bits alike: "
            f"{agree}; bytes staged through the host a step by process "
            f"{out[label]['staged_bytes']}; peak GiB by process "
            f"{out[label]['peak_gib']}; launches by process {by_process}")
        if not all(st["converged"] and st["health"] == 0 for st in steps):
            raise SystemExit(f"spmd_processes: the {label} step is not "
                             f"converged / healthy: {out[label]}")
        if not (gap <= PARITY_GATE and dx <= SPMD_DX and agree):
            raise SystemExit(f"spmd_processes: the {label} step differs from "
                             f"phase 13's one-process step: {out[label]}")
        if any(st["launches"][w.__name__] for st in steps
               for w in ck.YARDSTICK_WRAPPERS):
            raise SystemExit(f"spmd_processes: a yardstick kernel launched: "
                             f"{by_process}")
    log(f"[spmd_processes] {SPMD_PROCESSES} workers in {wall:.1f} s (start, "
        f"state build on each, both steps, gathers); state build by process "
        f"{[round(b, 1) for b in out['build_s']]} s, peak GiB after it "
        f"(the whole state, then its own rows) {out['build_peak_gib']}; "
        f"this card: {smi}")
    if not out["full"]["same_bits"]:
        log(f"[spmd_processes] the \"full\" step is not the one-process "
            f"step's bits: largest fiber gap {out['full']['max_dx']:.3e}. "
            "Both take B / D a hop and add every cross-shard sum in shard "
            "order, so the gap comes from a product whose bits depend on "
            "the process it runs in")
    if out["route"] != "ppermute" or out["backend"] != "gloo":
        raise SystemExit(f"spmd_processes: two processes on one card must "
                         f"take gloo and the hop-by-hop ring, got "
                         f"{out['backend']} / {out['route']}")
    if device.type == "cuda":
        need = {"mixed": ["stokeslet_f32", "stresslet_f32", "stokeslet_f64",
                          "stresslet_f64"],
                "full": ["stokeslet_f64", "stresslet_f64"]}
        for label, names in need.items():
            for r, by in out[label]["launches_by_process"].items():
                if not all(by.get(k) for k in names) or any(
                        by.get(k) for k in ("ring_stokeslet_f32",
                                            "ring_stresslet_f32")):
                    raise SystemExit(
                        f"spmd_processes: process {r}'s {label} step did not "
                        f"launch {names} hop by hop (E / F must not launch "
                        f"on a shared card): {by}")
    return out, launches


def phase_tree(torch, ck, cuda_build, device, work, args, nodes, f, a_ms,
               b_ms, ring_inputs, card):
    """Phase 12, the treecode (a-e). Returns (the phase's summary, the
    kernels line's G / H entries, launch counts by run)."""
    out, launches = {}, {}
    # a / c. the Stokeslet at the 10k shape; b / c. the stresslet at phase
    # 6's
    out["stokeslet_10k"] = tree_at_10k(torch, ck, device, nodes, f, a_ms,
                                       b_ms)
    out["stresslet_shell"] = tree_stresslet_at_shell(
        torch, ck, device, ring_inputs["fiber_nodes"],
        ring_inputs["shell_nodes"], ring_inputs["f_dl"])
    entries = tree_entries(torch, ck, cuda_build, device,
                           out["stokeslet_10k"], out["stresslet_shell"], card)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # d. the ellipsoid config through "tree", one step on phase 6's
    # precompute, in "mixed" (the card's "auto") and in "full", against
    # phase 6's first step
    src_cfg = ring_inputs["cfg_path"]
    f32 = ["tree_stokeslet_f32", "tree_stresslet_f32"]
    f64 = ["tree_stokeslet_f64", "tree_stresslet_f64"]
    for tag, prec, needed, idle in (
            ("tree_ellipsoid", "auto", f32 + ["stokeslet_f64",
                                              "stresslet_f64"],
             f64 + ["stokeslet_f32", "stresslet_f32"]),
            ("tree_ellipsoid_full", "full", f64,
             f32 + ["stokeslet_f32", "stresslet_f32"])):
        cfg, run_dir = ellipsoid_run_dir(work, src_cfg, tag,
                                         pair_evaluator="tree",
                                         solver_precision=prec)
        log(f"[{tag}] phase 6's ellipsoid config through \"tree\", "
            f"solver_precision = \"{prec}\", one step")
        out[tag] = fast_run(torch, ck, device, tag, cfg, run_dir, 1, needed,
                            idle, direct_x=ring_inputs["direct_x1"])
        launches[tag] = out[tag]["launches"]
        log(f"[{tag}] B's and D's launches (the dense f64 prep flows and "
            f"refinement residuals): {launches[tag]['stokeslet_f64']}, "
            f"{launches[tag]['stresslet_f64']}")
        if prec == "auto":
            # two profiled steps of the same config in a CLI process of
            # their own: G / H inside the Krylov loop's pair flows, under
            # its phases' tree pass (one launch over the near and far
            # lists: "near/far")
            out[tag]["profiled"] = profile_cli(
                torch, device, src_cfg, work, "tree_profile", "tree",
                needed=("G", "H", "B", "D"),
                phase_of_kernels=lambda k, p: (
                    p.startswith("gmres/") and p.endswith("/near/far")
                    if k in ("G", "H") else p in ("prep", "gmres/refine")),
                keep=True)
        shutil.rmtree(run_dir)
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # f. a matvec's tree flows once their geometry is built: no host sync
    out["sync_check"] = tree_sync_check(torch, ck, device)
    launches["tree_sync_check"] = out["sync_check"]["launches"]

    # e. the 10k recipe's fibers bent into arcs, free space, through
    # "tree" in "mixed", cut to TREE_ARCS_FIBERS at the recipe's density;
    # no direct run to compare with: gated on its own result
    cfg, run_dir = cut_run(work, args, "tree_arcs",
                           min(TREE_ARCS_FIBERS, args.fibers),
                           pair_evaluator="tree", precision="auto",
                           curvature=PVFMM_CURVATURE)
    out["tree_arcs"] = fast_run(torch, ck, device, "tree_arcs", cfg, run_dir,
                                1, ["tree_stokeslet_f32", "stokeslet_f64"],
                                ["stokeslet_f32", "tree_stokeslet_f64"],
                                min_iters=2)
    launches["tree_arcs"] = out["tree_arcs"]["launches"]
    shutil.rmtree(run_dir)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, entries, launches


#: phase 15: the ensemble. Each member is one confined DI scene at the JAX
#: package's own resolutions (examples/ensemble_sweep's 32-node fibers):
#: a sphere cortex of this radius and quadrature, a sphere body of radius
#: 0.5 at the centre with this many nodes and nucleation sites, this many
#: bound fibers on the first sites (the capacity rung they fill), rounds
#: of this dt, lanes = replicas (the example's batch), and the members run
#: alone beside the batch
ENS_SHELL_RADIUS = 3.0
ENS_DT = 0.01
ENS_ROUNDS = 4
ENS_FIBER_NODES = 32
ENS_NUCLEATION_RATE = 5.0
#: the bound fibers' motor force a length (force_scale): the members' solve
#: couples their fibers through the shell and the body
ENS_FORCE_SCALE = -0.5
ENS_GMRES_TOL = 1e-10
ENS_SOLO = (0, 5)
#: gates of the batched members against their solo runs: "mixed" rounds,
#: and one "full" round
ENS_MIXED_DX = 1e-8
ENS_FULL_DX = 1e-10
#: target rows a member drawn at random for the batched kernels' plain
#: check (each plan's last target block besides)
ENS_SAMPLE = 512


def make_ensemble_config(path, n_shell, n_body, n_sites, n_bound):
    """The phase-15 member scene, written with the port's schema: a
    spherical cortex (ENS_SHELL_RADIUS, ``n_shell`` nodes), one sphere body
    of radius 0.5 at the origin with ``n_body`` nodes and ``n_sites``
    nucleation sites (`Body.generate_nucleation_sites`), ``n_bound``
    clamped ENS_FIBER_NODES-node fibers of length 1 on its first sites,
    pointing outward, with motors (ENS_FORCE_SCALE), and dynamic
    instability at the fibers' resolution;
    "mixed", ENS_ROUNDS rounds of ENS_DT, a frame a round."""
    import numpy as np

    from skellysim_tpu_torch.config import Body, ConfigSpherical, Fiber

    config = ConfigSpherical()
    config.periphery.radius = ENS_SHELL_RADIUS
    config.periphery.n_nodes = n_shell
    p = config.params
    p.eta = 1.0
    p.dt_initial = p.dt_write = p.dt_max = ENS_DT
    p.t_final = ENS_ROUNDS * ENS_DT
    p.adaptive_timestep_flag = False
    p.gmres_tol = ENS_GMRES_TOL
    p.solver_precision = "mixed"
    p.seed = 2024
    di = p.dynamic_instability
    di.n_nodes, di.v_growth, di.f_catastrophe = ENS_FIBER_NODES, 0.2, 0.5
    di.nucleation_rate, di.min_length = ENS_NUCLEATION_RATE, 0.5
    di.radius, di.bending_rigidity = 0.0125, 0.01
    body = Body(n_nucleation_sites=n_sites, position=[0.0, 0.0, 0.0],
                shape="sphere", radius=0.5, n_nodes=n_body)
    body.generate_nucleation_sites(0.03, verbose=False,
                                   rng=np.random.default_rng(5))
    config.bodies = [body]
    sites = np.asarray(body.nucleation_sites).reshape(-1, 3)
    fibers = []
    for k in range(n_bound):
        f = Fiber(n_nodes=ENS_FIBER_NODES, parent_body=0, parent_site=k,
                  minus_clamped=True, length=1.0, bending_rigidity=0.01,
                  force_scale=ENS_FORCE_SCALE)
        f.fill_node_positions(sites[k], sites[k] / np.linalg.norm(sites[k]))
        fibers.append(f)
    config.fibers = fibers
    config.save(path)
    return config


class EnsembleRounds:
    """Records every round of the ensemble's runner while a phase runs (by
    wrapping `EnsembleRunner.step`, which the CLI's runner calls): the
    round's wall (to a device synchronise), lanes and capacity, each
    lane's outcome, the host seconds of its DI updates, the batched A-D
    calls by (members, sources, targets) and the round's peak device
    memory."""

    NAMES = ("stokeslet_f32_batched", "stokeslet_f64_batched",
             "stresslet_f32_batched", "stresslet_f64_batched")

    def __init__(self, torch, ck, device):
        import collections

        self.torch, self.ck, self.device = torch, ck, device
        self.rows = []
        self.calls = collections.Counter()

    def __enter__(self):
        import collections

        from skellysim_tpu_torch.ensemble import runner as runner_mod

        self.cls = runner_mod.EnsembleRunner
        self.saved_step = self.cls.step
        self.saved = {n: getattr(self.ck, n) for n in self.NAMES}
        outer = self
        torch = self.torch

        for name, fn in self.saved.items():
            def record(src, trg, *rest, _fn=fn, _name=name, **kw):
                outer.calls[_name, trg.shape[0], src.shape[1],
                            trg.shape[1]] += 1
                outer.round_calls[_name, trg.shape[0], src.shape[1],
                                  trg.shape[1]] += 1
                return _fn(src, trg, *rest, **kw)
            setattr(self.ck, name, record)

        def step(runner, ens):
            outer.round_calls = collections.Counter()
            on_card = outer.device.type == "cuda"
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = outer.saved_step(runner, ens)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            info = out[1]
            outer.rows.append({
                "wall_s": wall, "lanes": int(len(info.running)),
                "capacity": int(ens.states.fibers.x.shape[1]),
                "running": info.running.tolist(),
                "needs_growth": info.needs_growth.tolist(),
                "accepted": info.accepted.tolist(),
                "iters": info.iters.tolist(),
                "active": info.active_fibers.tolist(),
                "nucleations": info.nucleations.tolist(),
                "catastrophes": info.catastrophes.tolist(),
                "di_s": info.di_s,
                "calls": {f"{n} {b}x{ns}x{nt}": c for (n, b, ns, nt), c
                          in outer.round_calls.items()},
                "peak_bytes": (torch.cuda.max_memory_allocated()
                               if on_card else None)})
            return out

        self.cls.step = step
        self.round_calls = collections.Counter()
        return self

    def __exit__(self, *exc):
        self.cls.step = self.saved_step
        for name, fn in self.saved.items():
            setattr(self.ck, name, fn)


def ensemble_solo(system, params, state, rng, rounds, policy):
    """A member alone: each round the device DI update from its stream
    (reseated on the next capacity rung when it outgrows its own, as
    `ScenarioEnsemble` does), then `System.trial_step`, the time advanced
    by dt (adaptive dt off). Returns [(state, StepInfo)] a round."""
    from skellysim_tpu_torch.ensemble.runner import rng_carry
    from skellysim_tpu_torch.fibers import container as fc
    from skellysim_tpu_torch.scenarios.di_device import (DRAWS_PER_STEP,
                                                         di_update)
    from skellysim_tpu_torch.system.buckets import next_fiber_capacity
    from skellysim_tpu_torch.system.system import _in_dtype

    carry = rng_carry(rng)
    dtype = state.fibers.x.dtype
    out = []
    for _ in range(rounds):
        while True:
            pre, info = di_update(state, params, carry)
            if not info.needs_growth:
                break
            state = state._replace(fibers=fc.grow_capacity(
                state.fibers,
                next_fiber_capacity(state.fibers.n_fibers + 1, policy)))
        new, _, sinfo = system.trial_step(pre)
        carry[2] += DRAWS_PER_STEP
        state = new._replace(time=_in_dtype(state.time + state.dt, dtype),
                             dt=state.dt)
        out.append((state, sinfo))
    return out


def live_x(state):
    """[fibers, n, 3] positions of the active fibers in config order (the
    trajectory's wire order)."""
    import numpy as np

    g = state.fibers
    act = g.active.cpu().numpy()
    rank = g.config_rank.cpu().numpy()[act]
    return g.x.cpu().numpy()[act][np.argsort(rank, kind="stable")]


def frame_x(frame):
    import numpy as np

    fibers = frame["fibers"][1]
    return (np.stack([np.asarray(f["x_"]).reshape(-1, 3) for f in fibers])
            if fibers else np.zeros((0, ENS_FIBER_NODES, 3)))


def batched_check(torch, ck, device, family, prec, src, trg, pay, card,
                  sass_per_pair, tag):
    """Kernel A / B / C / D over the member axis at one batched shape
    (``src`` / ``trg`` / ``pay`` numpy [B, n, .]): held against the plain
    f64 sum on ENS_SAMPLE target rows of every member drawn at random plus
    each plan's last target block; member by member against the lone
    launch, bit for bit with the batch forced to the lone plan's chunks
    (the largest gap printed at its own plan); two launches bit for bit;
    timed like phase 3 (median of KERNEL_ROUNDS rounds of KERNEL_LAUNCHES)
    beside the B lone launches of the same members, with its flop / byte
    bound and the issue-slot bound of its SASS hot loop (``sass_per_pair``
    = (instructions, FP64 instructions) a pair, from phase 3 / 6: the same
    kernel). Exits on a failure; returns the JSON fields."""
    import numpy as np

    peak, tol, _ = PAIR_KERNELS[family, prec]
    dt = torch.float32 if prec == "f32" else torch.float64
    s64, t64, p64 = (torch.as_tensor(a, dtype=torch.float32,
                                     device=device).double()
                     for a in (src, trg, pay))
    B, n_src, n_trg = s64.shape[0], s64.shape[1], t64.shape[1]
    s, t, p = s64.to(dt), t64.to(dt), p64.to(dt)
    kern = getattr(ck, f"{family}_{prec}_batched")
    lone = getattr(ck, f"{family}_{prec}")
    ms, got, rounds = kernel_ms(torch, lambda: kern(s, t, p, 1.0), device)
    state = card_state(device)
    again = bool(torch.equal(kern(s, t, p, 1.0), got))
    lone_ms, solo, lone_rounds = kernel_ms(
        torch, lambda: [lone(s[m], t[m], p[m], 1.0) for m in range(B)],
        device)
    on_card = device.type == "cuda"
    forced_bits, lone_chunks, chunks = None, None, None
    if on_card:
        lone_plan = ck.pair_card_plan(family, device, prec, n_trg, n_src)
        plan = ck.pair_card_plan(family, device, prec, n_trg, n_src, B)
        lone_chunks, chunks = lone_plan.chunks, plan.chunks
        forced = kern(s, t, p, 1.0, chunks=lone_chunks)
        forced_bits = all(bool(torch.equal(forced[m], solo[m]))
                          for m in range(B))
        del forced
    vs_lone = max(float((got[m].double() - solo[m].double()).abs().max()
                        / solo[m].double().abs().max().clamp_min(1e-300))
                  for m in range(B))
    rng = np.random.default_rng(43)
    last = last_block_rows(ck, family, n_trg)
    err, ref_max = 0.0, 0.0
    n_rows = 0
    plain_ms = 0.0
    for m in range(B):
        rows = torch.as_tensor(np.union1d(rng.choice(
            n_trg, min(ENS_SAMPLE, n_trg), replace=False), last),
            device=device)
        r_ms, ref = timed(torch, lambda: getattr(ck, f"{family}_f64_plain")(
            s64[m], t64[m][rows], p64[m], 1.0), device, 1)
        plain_ms += r_ms
        err = max(err, (got[m][rows].double() - ref).abs().max().item())
        ref_max = max(ref_max, ref.abs().max().item())
        n_rows += int(len(rows))
    rel = err / ref_max
    finite = bool(torch.isfinite(got).all())
    pairs = B * n_src * n_trg
    ops_ms = 1e3 * FLOPS_PER_PAIR[family] * pairs / peak
    nbytes = s.element_size() * B * (SOURCE_WORDS[family] * n_src
                                      + 3 * n_trg + 3 * n_trg)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    b_ms, b_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    issue = None
    if on_card and sass_per_pair[0] is not None:
        mhz = float(re.search(r"SM clock (\d+)", state).group(1))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        per, fp64 = sass_per_pair
        issue = issue_bound_ms(per, pairs, sms, mhz, 128)
        if prec == "f64":
            issue = max(issue, issue_bound_ms(fp64, pairs, sms, mhz, 64))
    fields = {"members": int(B), "shape": [int(n_src), int(n_trg)],
              "max_abs_err": err, "max_rel_err": rel, "tolerance": tol,
              "plain_rows": n_rows, "ms": ms, "ms_rounds": rounds,
              "lone_launches_ms": lone_ms, "lone_rounds": lone_rounds,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "issue_bound_ms": issue, "chunks": chunks,
              "lone_chunks": lone_chunks,
              "same_bits_as_lone_at_lone_chunks": forced_bits,
              "max_rel_diff_vs_lone": vs_lone, "same_bits_twice": again,
              "card_state": state}
    log(f"[{tag}] {kern.__name__}: {B} members x {n_src} sources x {n_trg} "
        f"targets, one launch: against the plain f64 sum on {n_rows} rows "
        f"of the {B} members (each plan's last target block included) max "
        f"abs err {err:.3e}, max rel err {rel:.3e} (tolerance {tol:g}); "
        f"member by member against the lone launch: "
        + ("not checked at the lone plan's chunks (CPU rehearsal)"
           if forced_bits is None else "same bits at the lone plan's chunks"
           if forced_bits else "bits differ at the lone plan's chunks")
        + f" ({lone_chunks} chunks; the batch's own plan takes {chunks}, "
        f"max rel diff {vs_lone:.3e}); same bits twice: {again}; kernel "
        f"{ms:.3f} ms ({rounds_note(rounds)}) against {B} lone launches "
        f"{lone_ms:.3f} ms ({lone_ms / ms:.2f}x); plain f64 {plain_ms:.1f} "
        f"ms on the sampled rows; bound {b_ms:.4f} ms ({b_by}; operations "
        f"{ops_ms:.4f} ms at {FLOPS_PER_PAIR[family]} flops a pair, bytes "
        f"{bytes_ms:.4f} ms)"
        + ("" if issue is None else f", issue-slot bound {issue:.4f} ms "
           f"({100 * issue / ms:.1f}% of it)")
        + f"; this card: {card}; after the timed launches: {state}")
    if not (finite and rel <= tol and again and vs_lone <= tol
            and forced_bits is not False):
        raise SystemExit(f"{kern.__name__} fails its checks at {B} x {n_src} "
                         f"x {n_trg}: rel err {rel:.3e}, vs lone {vs_lone:.3e},"
                         f" same bits twice {again}, at the lone chunks "
                         f"{forced_bits}, finite {finite}")
    del s, t, p, s64, t64, p64, got, solo
    return fields


def ensemble_profile(dump, wall):
    """Phase 15's drain ran under ``--profile``: its dump parsed
    (`obs.profile.load_device_trace`, in this process) with A-D (their
    member-batched launches run the same kernels) present and every one of
    their launches under a named phase; prints the phase table, A-D's
    phases, the dump's size and the parse's seconds."""
    from skellysim_tpu_torch.obs import profile as obs_profile

    t0 = time.perf_counter()
    dev = obs_profile.load_device_trace(dump)
    parse_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(dump, f))
               for f in os.listdir(dump) if f.endswith(".pt.trace.json"))
    log(f"[ensemble] the drain under --profile: dump {size / 2**20:.1f} MiB,"
        f" parsed in {parse_s:.1f} s; device time "
        f"{dev.total_us / 1e3:.3f} ms over the CLI's {wall:.1f} s, "
        f"{100 * dev.attributed_frac:.1f}% attributed to named phases "
        f"({100 * dev.inferred_us / max(dev.total_us, 1e-9):.1f}% inferred)")
    for g in dev.by_phase()[:12]:
        log(f"[ensemble]   {g['key']:<28} {g['dur_us'] / 1e3:10.3f} ms "
            f"{100 * g['share']:6.2f}%  {g['count']:7d} ops")
    phases = {}
    for r in dev.rows:
        letter = kernel_letter(r["module"])
        if letter is not None:
            key = r["phase"] or "(unattributed)"
            phases.setdefault(letter, {}).setdefault(key, 0)
            phases[letter][key] += r["count"]
    log(f"[ensemble] A-D launches by phase: {phases}")
    if sorted(phases) != ["A", "B", "C", "D"] or any(
            "(unattributed)" in v for v in phases.values()):
        raise SystemExit(f"ensemble: A-D in the profile by phase: {phases}")


def phase_ensemble(torch, ck, device, work, args, card, entries):
    """The batched ensemble on the card, through its front door: the
    member scene (`make_ensemble_config`) precomputed on the card, a sweep
    of ``--ensemble-lanes`` replicas through as many lanes, and `python -m
    skellysim_tpu_torch.ensemble` in this process (the "vmap" plan), every
    launch count set to 0 just before and read just after. Gated on every
    member finishing; every applied round's true residual <= gmres_tol and
    health 0; at least one nucleation and one growth reseat; each member's
    active count = the previous + nucleations - catastrophes, round by
    round; every trajectory read back (a frame a round, finite, its fiber
    count the round's active count); a start, step and retire record a
    member; A-D launching only through their member-batched entry points.
    Then members ENS_SOLO alone (`ensemble_solo`) from their admitted
    states and streams: after each "mixed" round the true residual <=
    gmres_tol and the fibers within ENS_MIXED_DX of the batched member's
    frame (iterations printed beside); one "full" round of a batch on the
    next rung against them, the shell preconditioner inverted in f64 for it
    (equal iterations, fibers within ENS_FULL_DX);
    one "unroll" round of the two against them, bit for bit. Then A-D
    checked and timed at every batched shape the run launched
    (`batched_check`). Returns (the launch counts, {kernel name: [the
    checks' fields]}, the summary, phase 16d's inputs)."""
    import numpy as np

    from skellysim_tpu_torch.ensemble.cli import _members_from_sweep
    from skellysim_tpu_torch.ensemble.runner import (EnsembleRunner,
                                                     lane_state)
    from skellysim_tpu_torch.fibers import container as fc
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader
    from skellysim_tpu_torch.precompute import precompute_from_config
    from skellysim_tpu_torch.scenarios.sweep import ensure_di_capacity
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.system.buckets import next_fiber_capacity
    from skellysim_tpu_torch.utils import quaternion as quat

    lanes = args.ensemble_lanes
    run_dir = os.path.join(work, "ensemble")
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "skelly_config.toml")
    config = make_ensemble_config(cfg_path, args.ensemble_shell_nodes,
                                  args.ensemble_body_nodes,
                                  args.ensemble_sites, args.ensemble_bound)
    t0 = time.perf_counter()
    stats = precompute_from_config(cfg_path, verbose=False,
                                   device=device.type)
    log(f"[ensemble] precompute {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.4g}" for k, v in stats.items()))
    sweep = os.path.join(run_dir, "ensemble.toml")
    with open(sweep, "w") as fh:
        fh.write(f'[ensemble]\nbase_config = "skelly_config.toml"\n'
                 f"replicas = {lanes}\nbatch = {lanes}\n")
    out_dir = os.path.join(run_dir, "out")
    dump = os.path.join(run_dir, "profile")
    reset_counts(ck)
    argv = sys.argv
    # on the card the drain runs under the profiler (a CPU rehearsal's
    # plain kernels are millions of small ops, tens of GB of events); no
    # trace file, so the dump is parsed once, below, not in the run too
    profiled = ["--profile=" + dump] if device.type == "cuda" else []
    sys.argv = ["skellysim_tpu_torch.ensemble", f"--sweep-file={sweep}",
                f"--output-dir={out_dir}", f"--device={device.type}",
                "--batch-impl=vmap", "--log-level=WARNING", *profiled]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with EnsembleRounds(torch, ck, device) as rec:
            runpy.run_module("skellysim_tpu_torch.ensemble",
                             run_name="__main__", alter_sys=True)
    finally:
        sys.argv = argv
    wall = time.perf_counter() - t0
    counts = read_counts(ck)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    recs = [json.loads(line) for line in
            open(os.path.join(out_dir, "ensemble_metrics.jsonl"))]
    members = sorted({r["member"] for r in recs})
    if profiled:
        ensemble_profile(dump, wall)
    else:
        log("[ensemble] not profiled (CPU rehearsal)")
    n0 = len(config.fibers)
    log(f"[ensemble] `python -m skellysim_tpu_torch.ensemble`: {lanes} "
        f"members ({config.periphery.n_nodes}-node cortex, "
        f"{config.bodies[0].n_nodes}-node body with "
        f"{config.bodies[0].n_nucleation_sites} sites, {n0} bound "
        f"{ENS_FIBER_NODES}-node fibers, DI, \"mixed\", {ENS_ROUNDS} rounds "
        f"of dt = {ENS_DT}) in {wall:.1f} s, {len(rec.rows)} batched "
        f"rounds; launches {counts}; peak device memory "
        + ("not measured" if peak is None else f"{peak / 2**30:.2f} GiB"))
    for i, r in enumerate(rec.rows):
        run = [k for k, v in enumerate(r["running"]) if v]
        log(f"[ensemble] round {i}: wall {r['wall_s']:.3f} s, capacity "
            f"{r['capacity']}, {len(run)} of {r['lanes']} lanes running, "
            f"{sum(r['needs_growth'])} frozen for a reseat; GMRES "
            f"iterations by lane {[r['iters'][k] for k in run]}, active "
            f"fibers {[r['active'][k] for k in run]} (+"
            f"{[r['nucleations'][k] for k in run]} nucleated, -"
            f"{[r['catastrophes'][k] for k in run]}); DI updates on the "
            f"host {r['di_s']:.3f} s; A-D calls by (members, sources, "
            f"targets) {r['calls']}; peak "
            + ("not measured" if r["peak_bytes"] is None
               else f"{r['peak_bytes'] / 2**30:.2f} GiB"))
    # gates: the records
    steps = [r for r in recs if r["event"] == "step"]
    growth = [r for r in recs if r["event"] == "growth"]
    for m in members:
        events = [r["event"] for r in recs if r["member"] == m]
        mine = [r for r in steps if r["member"] == m]
        if (events[0] != "start" or events[-1] != "retire"
                or len(mine) != ENS_ROUNDS):
            raise SystemExit(f"ensemble: member {m} did not finish its "
                             f"{ENS_ROUNDS} rounds: {events}")
        prev = n0
        for s in mine:
            if not (s["accepted"] and s["residual_true"] <= ENS_GMRES_TOL
                    and s["health"] == 0 and math.isfinite(s["fiber_error"])):
                raise SystemExit(f"ensemble: member {m} step {s['step']} is "
                                 f"not converged and healthy: {s}")
            if s["active_fibers"] != prev + s["nucleations"] \
                    - s["catastrophes"]:
                raise SystemExit(f"ensemble: member {m} step {s['step']}: "
                                 f"{s['active_fibers']} active after {prev}, "
                                 f"+{s['nucleations']} -{s['catastrophes']}")
            prev = s["active_fibers"]
    nuc = sum(s["nucleations"] for s in steps)
    if len(members) != lanes or not nuc or not growth:
        raise SystemExit(f"ensemble: {len(members)} members, {nuc} "
                         f"nucleations, {len(growth)} growth reseats")
    # the trajectories
    frames = {}
    for m in members:
        reader = TrajectoryReader(os.path.join(out_dir, f"{m}.out"))
        frames[m] = [reader.load_frame(i) for i in range(len(reader))]
        reader.close()
        mine = [s for s in steps if s["member"] == m]
        if len(frames[m]) != ENS_ROUNDS + 1 or any(
                len(f["fibers"][1]) != s["active_fibers"]
                or not np.isfinite(frame_x(f)).all()
                for f, s in zip(frames[m][1:], mine)):
            raise SystemExit(f"ensemble: member {m}'s trajectory does not "
                             "hold a finite frame a round with its active "
                             "fibers")
    if device.type == "cuda":
        batched = {n: counts[n] for n in EnsembleRounds.NAMES}
        lone = {n[:-len("_batched")]: counts[n[:-len("_batched")]]
                for n in EnsembleRounds.NAMES}
        if not all(batched.values()) or any(lone.values()):
            raise SystemExit(f"ensemble: the batched A-D launched "
                             f"{batched}, the lone A-D {lone}")
    if any(counts[w.__name__] for w in ck.YARDSTICK_WRAPPERS):
        raise SystemExit(f"ensemble: a yardstick kernel launched: {counts}")
    caps = sorted({r["capacity"] for r in rec.rows})
    log(f"[ensemble] {len(members)} members finished, {nuc} nucleations, "
        f"{sum(s['catastrophes'] for s in steps)} catastrophes, "
        f"{len(growth)} growth reseats onto capacity rungs {caps}; every "
        f"trajectory read back ({ENS_ROUNDS + 1} frames a member)")

    # the chosen members alone, from their admitted states and streams
    system, specs, _, policy = _members_from_sweep(sweep, device.type)
    params = system.params
    admitted = {s.member_id: ensure_di_capacity(s.state, params,
                                                policy=policy)
                for s in specs}
    rngs = {s.member_id: s.rng for s in specs}
    solo_ids = [i for i in ENS_SOLO if i < lanes] or [0]
    solo_report = {}
    for idx in solo_ids:
        m = f"m{idx:05d}"
        rounds = ensemble_solo(system, params, admitted[m], rngs[m],
                               ENS_ROUNDS, policy)
        mine = [s for s in steps if s["member"] == m]
        dxs = []
        for k, ((st, info), s) in enumerate(zip(rounds, mine)):
            a, b = live_x(st), frame_x(frames[m][k + 1])
            if a.shape != b.shape or not info.converged \
                    or not info.residual_true <= ENS_GMRES_TOL:
                raise SystemExit(f"ensemble: member {m} alone, round {k}: "
                                 f"{a.shape} fibers against the batch's "
                                 f"{b.shape}, {info}")
            dxs.append(float(np.abs(a - b).max()))
            log(f"[ensemble] member {m} alone, round {k}: GMRES iterations "
                f"{info.iters} (batched {s['iters']}), true residual "
                f"{info.residual_true:.3e} (batched "
                f"{s['residual_true']:.3e}), max |dx| against the batched "
                f"member {dxs[-1]:.3e} (gate {ENS_MIXED_DX:g})")
        if not max(dxs) <= ENS_MIXED_DX:
            raise SystemExit(f"ensemble: member {m} alone drifts "
                             f"{max(dxs):.3e} from the batched member")
        solo_report[m] = {"max_dx": max(dxs),
                          "iters": [i.iters for _, i in rounds],
                          "iters_batched": [s["iters"] for s in mine]}
    # one "full" round and one "unroll" round, on the next rung (no lane
    # outgrows it in one round), with the shell preconditioner inverted in
    # f64 (the card's precompute stores it in f32, whose rounding makes a
    # "full" solve's iteration count follow roundoff near gmres_tol)
    cap = next_fiber_capacity(n0 + 1, policy)
    shell0 = admitted[members[0]].shell
    m_inv = torch.linalg.inv(shell0.stresslet_plus_complementary
                             ).contiguous()
    grown = {m: st._replace(fibers=fc.grow_capacity(st.fibers, cap),
                            shell=st.shell._replace(M_inv=m_inv))
             for m, st in admitted.items()}
    full_sys = System(dataclasses.replace(params, solver_precision="full"),
                      shell_shape=system.shell_shape, device=system.device)
    runner = EnsembleRunner(full_sys, batch_impl="vmap")
    ens = runner.make_ensemble([grown[m] for m in members],
                               [params.t_final] * len(members),
                               rngs=[rngs[m] for m in members])
    t0 = time.perf_counter()
    ens, info = runner.step(ens)
    full_wall = time.perf_counter() - t0
    full_report = {}
    for idx in solo_ids:
        m = f"m{idx:05d}"
        (st, sinfo), = ensemble_solo(full_sys, full_sys.params, grown[m],
                                     rngs[m], 1, policy)
        lane = members.index(m)
        dx = float(np.abs(live_x(st) - live_x(lane_state(ens.states,
                                                          lane))).max())
        full_report[m] = {"iters": sinfo.iters,
                          "iters_batched": int(info.iters[lane]),
                          "max_dx": dx}
        log(f"[ensemble] \"full\" round of the {len(members)}-lane batch "
            f"({full_wall:.2f} s): member {m} alone {sinfo.iters} iterations "
            f"against the batch's {int(info.iters[lane])}, max |dx| "
            f"{dx:.3e} (gate {ENS_FULL_DX:g})")
        if sinfo.iters != int(info.iters[lane]) or not dx <= ENS_FULL_DX:
            raise SystemExit(f"ensemble: the \"full\" batched member {m} "
                             "does not match its solo round")
    unroll = EnsembleRunner(system, batch_impl="unroll")
    pair = [f"m{i:05d}" for i in solo_ids]
    ens = unroll.make_ensemble([grown[m] for m in pair],
                               [params.t_final] * len(pair),
                               rngs=[rngs[m] for m in pair])
    ens, uinfo = unroll.step(ens)
    for lane, m in enumerate(pair):
        (st, _), = ensemble_solo(system, params, grown[m], rngs[m], 1,
                                 policy)
        got = lane_state(ens.states, lane)
        if not (torch.equal(st.fibers.x, got.fibers.x)
                and torch.equal(st.shell.density, got.shell.density)):
            raise SystemExit(
                f"ensemble: the \"unroll\" lane of {m} is not its solo "
                f"round bit for bit: max |dx| "
                f"{float((st.fibers.x - got.fibers.x).abs().max()):.3e}, "
                f"max |d density| "
                f"{float((st.shell.density - got.shell.density).abs().max()):.3e}"
                f", iterations {int(uinfo.iters[lane])}")
    log(f"[ensemble] one \"unroll\" round of {pair}: the solo rounds' bits")

    # A-D at every batched shape the run launched
    sass = {e["name"]: (e.get("sass_per_pair"), e.get("sass_fp64_per_pair"))
            for e in entries}
    checks = {}
    with np.load(os.path.join(run_dir, config.periphery.precompute_file)) \
            as z:
        shell_nodes, shell_normals = z["nodes"], z["normals"]
    with np.load(os.path.join(run_dir, config.bodies[0].precompute_file)) \
            as z:
        body_ref, normals_ref = z["node_positions_ref"], z["node_normals_ref"]
    n_shell, n_body = len(shell_nodes), len(body_ref)
    rng = np.random.default_rng(47)

    def geometry(m):
        last = frames[m][-1]
        body = last["bodies"][0][0]
        rot = quat.rotation_matrix(torch.as_tensor(
            np.asarray(body["orientation_"]))).numpy()
        com = np.asarray(body["position_"]).reshape(1, 3)
        return (frame_x(last).reshape(-1, 3), com + body_ref @ rot.T,
                normals_ref @ rot.T, com,
                np.asarray(last["shell"]["solution_vec_"]).reshape(-1, 3),
                np.asarray(body["solution_vec_"])[:3 * n_body].reshape(-1, 3))

    def member_inputs(family, m, n_src, n_trg):
        live, bnodes, bnormals, com, srho, brho = geometry(m)

        def slots(n):
            out = np.zeros((n, 3))
            out[:min(n, len(live))] = live[:n]
            return out

        if family == "stresslet" and n_src == n_shell:
            return (shell_nodes, np.concatenate([slots(n_trg - n_body),
                                                 bnodes]),
                    (2.0 * shell_normals[:, :, None]
                     * srho[:, None, :]).reshape(-1, 9))
        every = np.concatenate([slots(n_trg - n_shell - n_body), shell_nodes,
                                bnodes])
        if family == "stresslet" and n_src == n_body:
            return (bnodes, every, (2.0 * bnormals[:, :, None]
                                    * brho[:, None, :]).reshape(-1, 9))
        if family == "stokeslet" and n_src == 1:
            return com, every, rng.standard_normal((1, 3))
        if family == "stokeslet" and n_trg == n_src + n_shell + n_body:
            force = np.zeros((n_src, 3))
            force[:len(live)] = rng.standard_normal(
                force[:len(live)].shape) / 63.0
            return slots(n_src), every, force
        raise SystemExit(f"ensemble: {family} launched at {n_src} x "
                         f"{n_trg}, a shape this phase cannot rebuild")

    parts = []
    for (name, B, n_src, n_trg), calls in sorted(rec.calls.items()):
        family, prec = name.split("_")[:2]
        ins = [member_inputs(family, members[k % len(members)], n_src, n_trg)
               for k in range(B)]
        fields = batched_check(
            torch, ck, device, family, prec,
            *(np.stack([x[j] for x in ins]) for j in range(3)), card,
            sass.get(f"{family}_{prec}", (None, None)), "ensemble")
        fields["calls_at_this_shape"] = calls
        checks.setdefault(f"{family}_{prec}", []).append(fields)
        parts.append(f"{name} at {B} x {n_src} x {n_trg}: {calls} x "
                     f"{fields['ms']:.3f} ms")
    log("[ensemble] batched calls x checked time: " + "; ".join(parts))
    summary = {"wall_s": wall, "rounds": rec.rows, "members": len(members),
               "nucleations": nuc, "reseats": len(growth),
               "capacities": caps, "peak_bytes": peak,
               "solo_mixed": solo_report, "solo_full": full_report}
    shutil.rmtree(run_dir)
    # phase 16d's members: the admitted states on the next rung, the "full"
    # system of this phase's "full" round
    mesh_inputs = {"system": full_sys, "states": grown, "rngs": rngs,
                   "members": members}
    return counts, checks, summary, mesh_inputs


#: phase 16: the s-step block size and its gate against the block_s = 1
#: step (the ring run's fiber gate); the guard ladder's iteration cap (each
#: retry bounded: a stagnant s-step solve runs to its cap, 16 inner
#: iterations a sweep, 8 sweeps, each attempt); the tiles' cut of phase 3's cloud and
#: their gates against B / D (df: the double-float tile's ~1e-14 pairs;
#: mxu: the JAX package's test gates, tests/test_kernels.py, 1e-2 of the
#: norm in float32 (`test_mxu_f32_accuracy_envelope`) and 1e-9 in
#: float64 (`test_stokeslet_mxu_impl_matches_exact`)); the member mesh's
#: shards of the card and rounds, and its gate where the shards' plans
#: differ from the one-card round's
SSTEP_S = 4
SSTEP_DX = 1e-6
LADDER_MAXITER = 16
TILE_CUT = 32768
DF_GATE = 1e-12
MXU_GATE = 1e-2
MXU64_GATE = 1e-9
MESH_SHARDS = 2
MESH_ROUNDS = 2
MESH_DX = 1e-11


def counted_step(torch, ck, device, fn):
    """(``fn()``'s result, host seconds to a synchronize, launch counts)
    with every launch count set to 0 just before."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_counts(ck)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts(ck)


def need_launched(ck, device, tag, counts, names):
    """Fail unless every kernel in ``names`` launched and no yardstick
    did (on the card; the CPU rehearsal counts nothing)."""
    if any(counts[w.__name__] for w in ck.YARDSTICK_WRAPPERS):
        raise SystemExit(f"{tag}: a yardstick kernel launched: {counts}")
    if device.type == "cuda" and not all(counts[n] for n in names):
        raise SystemExit(f"{tag}: a kernel of the path never launched: "
                         f"{ {n: counts[n] for n in names} }")


def fiber_dx(a, b):
    return max(float((x.x - y.x).abs().max())
               for x, y in zip(fiber_groups(a.fibers), fiber_groups(b.fibers)))


def phase_sstep(torch, ck, device, system, state):
    """Phase 16a: one "full" and one "mixed" step at ``gmres_block_s =
    SSTEP_S`` from phase 6's first state against the ``block_s = 1`` step,
    then both through `System.step_spmd` on `SPMD_SHARDS` shards of the
    card, the reductions counted at the sharded solve's ``rdot`` seam.
    Gated on each step converged with true residual <= 1e-8, no
    stagnation or nonfinite bit (a breakdown bit riding a converged
    restart is printed: the JAX package sets it the same way), fibers
    within SSTEP_DX of the block_s = 1 step; on the reductions counted
    at the seam being two batched Gram reductions a round and, in "full",
    the entry norm and two norms a cycle besides (printed beside
    `collective_rounds`). Returns (records, launch counts by run, the
    "mixed" s-step result)."""
    from skellysim_tpu_torch.guard import verdict
    from skellysim_tpu_torch.parallel import (gather_state, make_mesh,
                                              shard_state)
    from skellysim_tpu_torch.parallel import spmd as spmd_mod
    from skellysim_tpu_torch.solver.gmres import collective_rounds
    from skellysim_tpu_torch.system import System

    p = system.params
    need = {"full": ["stokeslet_f64", "stresslet_f64"],
            "mixed": ["stokeslet_f32", "stresslet_f32", "stokeslet_f64",
                      "stresslet_f64"]}
    recs, launches, keep = {}, {}, {}
    mesh = make_mesh(SPMD_SHARDS, device=device)
    sharded = shard_state(state, mesh)
    for prec in ("full", "mixed"):
        one = System(dataclasses.replace(p, solver_precision=prec),
                     shell_shape=system.shell_shape, device=device)
        four = System(dataclasses.replace(p, solver_precision=prec,
                                          gmres_block_s=SSTEP_S),
                      shell_shape=system.shell_shape, device=device)
        (n1, _, i1), w1, _ = counted_step(torch, ck, device,
                                          lambda: one.step(state))
        (n4, _, i4), w4, c4 = counted_step(torch, ck, device,
                                           lambda: four.step(state))
        dx = fiber_dx(n4, n1)
        rec = {"block_s": SSTEP_S, "wall_s": w4, "iters": i4.iters,
               "refines": i4.refines, "cycles": i4.cycles,
               "residual_true": i4.residual_true, "health": i4.health,
               "max_dx": dx, "s1_wall_s": w1, "s1_iters": i1.iters,
               "s1_refines": i1.refines,
               "launches": {k: v for k, v in c4.items() if v}}
        log(f"[sstep] \"{prec}\" step at gmres_block_s = {SSTEP_S}: {w4:.3f} "
            f"s, {i4.iters} iterations / {i4.refines} sweeps / {i4.cycles} "
            f"cycles, true residual {i4.residual_true:.3e}, health "
            f"{i4.health:#x} ({verdict.describe(i4.health)}); block_s = 1: "
            f"{w1:.3f} s, {i1.iters} / {i1.refines}, "
            f"{i1.residual_true:.3e}; max |dx| {dx:.3e} (gate {SSTEP_DX}); "
            f"launches {rec['launches']}")
        if not (i4.converged and i4.residual_true <= 1e-8
                and i4.health & ~verdict.BREAKDOWN == 0 and dx <= SSTEP_DX):
            raise SystemExit(f"sstep: the {prec} s-step failed its gate: "
                             f"{rec}")
        need_launched(ck, device, f"sstep_{prec}", c4, need[prec])
        launches[f"sstep_{prec}"] = c4
        if prec == "mixed":
            keep["mixed"] = (four, n4)

        # the same on the shards of the card, the reductions counted
        calls = []
        make = spmd_mod._make_rdot

        def counting(comm, nonrep_end, make=make):
            rdot = make(comm, nonrep_end)

            def counted(A, w):
                calls.append(getattr(w, "parts", [w])[0].ndim)
                return rdot(A, w)
            return counted

        spmd_mod._make_rdot = counting
        try:
            (ns, _, si), ws, cs = counted_step(
                torch, ck, device, lambda: four.step_spmd(sharded, mesh))
        finally:
            spmd_mod._make_rdot = make
        dxs = fiber_dx(gather_state(ns, shell_operators=False), n1)
        formula = collective_rounds(si.iters, si.cycles, SSTEP_S,
                                    restart=p.gmres_restart)
        srec = {"wall_s": ws, "iters": si.iters, "refines": si.refines,
                "residual_true": si.residual_true, "health": si.health,
                "max_dx": dxs, "reductions": len(calls),
                "gram_reductions": calls.count(2),
                "collective_rounds": formula,
                "launches": {k: v for k, v in cs.items() if v}}
        rec["spmd"] = srec
        log(f"[sstep] \"{prec}\" step_spmd on {mesh.size} shards at "
            f"gmres_block_s = {SSTEP_S}: {ws:.3f} s, {si.iters} iterations / "
            f"{si.refines} sweeps, true residual {si.residual_true:.3e}, "
            f"health {si.health:#x}; reductions counted at the rdot seam "
            f"{len(calls)} ({calls.count(2)} batched Gram reductions), "
            f"collective_rounds {formula}"
            + (" (+ the entry norm)" if prec == "full" else
               " (the sweeps' norms besides)")
            + f"; max |dx| against the block_s = 1 step {dxs:.3e}; "
            f"launches {srec['launches']}")
        if not (si.converged and si.residual_true <= 1e-8
                and si.health & ~verdict.BREAKDOWN == 0 and dxs <= SPMD_DX):
            raise SystemExit(f"sstep: the sharded {prec} s-step failed its "
                             f"gate: {srec}")
        # two batched Gram reductions a round; in "full" the entry norm and
        # two norms a restart cycle besides (collective_rounds counts the
        # rounds as ceil(iters / s), one short where a breakdown ends a
        # cycle inside a round)
        grams = calls.count(2)
        if grams % 2 or (prec == "full"
                         and len(calls) - grams != 1 + 2 * si.cycles):
            raise SystemExit(f"sstep: {len(calls)} reductions counted, "
                             f"{grams} of them Gram reductions, over "
                             f"{si.cycles} cycles")
        need_launched(ck, device, f"sstep_spmd_{prec}", cs,
                      ["stokeslet_f64", "stresslet_f64"]
                      + (["ring_stokeslet_f32", "ring_stresslet_f32"]
                         if prec == "mixed" else []))
        launches[f"sstep_spmd_{prec}"] = cs
        recs[prec] = rec
        del n1, n4, ns
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return recs, launches, keep


def phase_ladder(torch, ck, device, system, state, healthy):
    """Phase 16b: the guard ladder on phase 6's scene, every stage armed
    (``guard_dt_halvings`` 2, the block fallback, the f64 fallback) in
    "mixed" at ``gmres_block_s = SSTEP_S`` with ``gmres_maxiter`` capped
    at LADDER_MAXITER: under `chaos.zero_preconditioner` a stagnation
    verdict, 4 retries and dt / 4; under `chaos.poison_state` a nonfinite
    verdict and no retry; unpatched, 0 retries and the unarmed s-step's
    bits (16a's "mixed" step, ``healthy``)."""
    from skellysim_tpu_torch.guard import chaos, verdict
    from skellysim_tpu_torch.system import System

    unarmed, ref = healthy
    lp = dataclasses.replace(unarmed.params, guard_dt_halvings=2,
                             guard_block_fallback=True,
                             guard_f64_fallback=True)
    capped = dataclasses.replace(lp, gmres_maxiter=LADDER_MAXITER)
    out, launches = {}, {}
    stuck = chaos.zero_preconditioner(System(
        capped, shell_shape=system.shell_shape, device=device))
    (_, _, info), wall, counts = counted_step(torch, ck, device,
                                              lambda: stuck.step(state))
    out["stagnation"] = {"wall_s": wall, "health": info.health,
                         "retries": info.guard_retries,
                         "dt_used": info.dt_used, "dt": state.dt,
                         "iters": info.iters,
                         "residual_true": info.residual_true}
    log(f"[ladder] zero preconditioner, every stage armed, gmres_maxiter "
        f"{LADDER_MAXITER}: {wall:.3f} s, verdict {verdict.describe(info.health)}"
        f", {info.guard_retries} retries, dt_used {info.dt_used:.6g} of "
        f"dt {state.dt:.6g}, last attempt {info.iters} iterations, true "
        f"residual {info.residual_true:.3e}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if not (info.health & verdict.STAGNATION and info.guard_retries == 4
            and info.dt_used == state.dt / 4):
        raise SystemExit(f"ladder: the stagnant step did not climb the "
                         f"ladder: {out['stagnation']}")
    need_launched(ck, device, "ladder", counts,
                  ["stokeslet_f32", "stresslet_f32", "stokeslet_f64",
                   "stresslet_f64"])
    launches["ladder_stagnation"] = counts
    poisoned = System(capped, shell_shape=system.shell_shape, device=device)
    (_, _, pinfo), pwall, _ = counted_step(
        torch, ck, device, lambda: poisoned.step(chaos.poison_state(state)))
    out["nonfinite"] = {"wall_s": pwall, "health": pinfo.health,
                        "retries": pinfo.guard_retries}
    log(f"[ladder] poisoned state: {pwall:.3f} s, verdict "
        f"{verdict.describe(pinfo.health)}, {pinfo.guard_retries} retries")
    if not (pinfo.health & verdict.NONFINITE and pinfo.guard_retries == 0):
        raise SystemExit(f"ladder: the poisoned step: {out['nonfinite']}")
    armed = System(lp, shell_shape=system.shell_shape, device=device)
    (new, _, ainfo), awall, acounts = counted_step(
        torch, ck, device, lambda: armed.step(state))
    same = all(torch.equal(a.x, b.x) for a, b in zip(
        fiber_groups(new.fibers), fiber_groups(ref.fibers)))
    out["healthy"] = {"wall_s": awall, "health": ainfo.health,
                      "retries": ainfo.guard_retries, "same_bits": same}
    log(f"[ladder] armed healthy step: {awall:.3f} s, health "
        f"{ainfo.health:#x}, {ainfo.guard_retries} retries, the unarmed "
        f"s-step's bits: {same}")
    if not (same and ainfo.guard_retries == 0):
        raise SystemExit(f"ladder: the armed healthy step: {out['healthy']}")
    launches["ladder_healthy"] = acounts
    return out, launches


def two_sum_check(torch, device):
    """The error-free transforms on tensors of the card: hi + lo of
    `two_sum` / `two_prod` of float32 pairs is the float64 sum / product
    exactly (a fused multiply-add inside the chain would break it)."""
    from skellysim_tpu_torch.ops import df_kernels as tdf

    g = torch.Generator(device=device).manual_seed(9)
    n = 1 << 22
    a = torch.randn(n, generator=g, device=device)
    b = torch.randn(n, generator=g, device=device) * torch.exp2(
        torch.randint(-30, 30, (n,), generator=g, device=device).float())
    s, e = tdf.two_sum(a, b)
    p, q = tdf.two_prod(a, b)
    ok_sum = bool(torch.equal(s.double() + e.double(),
                              a.double() + b.double()))
    ok_prod = bool(torch.equal(p.double() + q.double(),
                               a.double() * b.double()))
    log(f"[tiles] error-free transforms on {n} float32 pairs of the card: "
        f"two_sum exact {ok_sum}, two_prod exact {ok_prod}")
    if not (ok_sum and ok_prod):
        raise SystemExit("tiles: an error-free transform is not exact on "
                         "the card")
    return {"pairs": n, "two_sum_exact": ok_sum, "two_prod_exact": ok_prod}


def tile_check(torch, ck, device, family, src, trg, pay, card):
    """The "df" and "mxu" tiles of ``family`` (plain torch) against the
    f64-grade kernel (B / D) on the same inputs, timed beside it and
    beside the f32 kernel (A / C). df on the float64 inputs, one call
    timed with CUDA events (plain torch compiles nothing: the call checked
    is the call timed); mxu on the float64 inputs, one call timed, and on
    their float32 copies, timed like a kernel. Gated on df within DF_GATE
    of the f64 kernel and mxu in float64 within MXU64_GATE (norms; the
    df's largest error over max |u| printed: its (hi, lo) split holds a
    coordinate to 2^-48, ~1e-12 of a neighbour 1/63 away), and on neither
    tile launching a kernel. The float32
    mxu error is printed and not gated here: these clouds hold pairs far
    closer than their chunk's extent (1/63 apart in chunks ~10 across),
    which the tile's mask drops (`mxu_envelope_check` gates it in its
    regime)."""
    from skellysim_tpu_torch.ops import df_kernels as tdf
    from skellysim_tpu_torch.ops import kernels as tk

    direct = getattr(tk, f"{family}_direct")
    t64 = [torch.as_tensor(a, dtype=torch.float64, device=device)
           for a in (src, trg, pay)]
    if family == "stresslet":
        t64[2] = t64[2].reshape(-1, 3, 3)
    t32 = [a.float() for a in t64]
    b_ms, ref, b_rounds = kernel_ms(torch, lambda: direct(*t64, 1.0), device)
    a_ms, _, a_rounds = kernel_ms(torch, lambda: direct(*t32, 1.0), device)
    dfn = getattr(tdf, f"{family}_direct_df")
    reset_counts(ck)
    df_ms, df = timed(torch, lambda: dfn(*t64, 1.0), device, 1)
    mxu64_ms, mxu64 = timed(
        torch, lambda: direct(*t64, 1.0, impl="mxu"), device, 1)
    mxu_ms, mxu, mxu_rounds = kernel_ms(
        torch, lambda: direct(*t32, 1.0, impl="mxu"), device)
    tile_launches = sum(read_counts(ck).values())

    def rel(u):
        return float(torch.linalg.vector_norm(u.double() - ref)
                     / torch.linalg.vector_norm(ref))

    df_err = rel(df)
    df_max = float((df - ref).abs().max() / ref.abs().max())
    prec64, prec32 = (("B", "A") if family == "stokeslet" else ("D", "C"))
    rec = {"family": family, "n_src": len(src), "n_trg": len(trg),
           "df_ms": df_ms, "df_err": df_err, "df_max_err": df_max,
           "mxu64_ms": mxu64_ms,
           "mxu64_err": rel(mxu64), "mxu_ms": mxu_ms, "mxu_err": rel(mxu),
           f"{prec64}_ms": b_ms, f"{prec32}_ms": a_ms,
           "tile_launches": tile_launches}
    log(f"[tiles] {family} {len(src)} x {len(trg)}: df {df_ms:.1f} ms "
        f"(float64 in, one call), error against {prec64} {df_err:.3e} of "
        f"the norm (gate {DF_GATE}; max error over max |u| {df_max:.3e}); "
        f"mxu float64 {mxu64_ms:.1f} ms (one "
        f"call), error {rec['mxu64_err']:.3e} of the norm (gate "
        f"{MXU64_GATE}); mxu float32 {mxu_ms:.3f} ms "
        f"({rounds_note(mxu_rounds)}), error {rec['mxu_err']:.3e} of the "
        f"norm (not gated: pairs closer than the mask's floor drop); "
        f"{prec64} {b_ms:.3f} ms ({rounds_note(b_rounds)}), {prec32} "
        f"{a_ms:.3f} ms ({rounds_note(a_rounds)}); kernels the tiles "
        f"launched {tile_launches}; this card: {card}; {card_state(device)}")
    if not (df_err <= DF_GATE and rec["mxu64_err"] <= MXU64_GATE
            and tile_launches == 0):
        raise SystemExit(f"tiles: the {family} tiles failed their gates: "
                         f"{rec}")
    return rec


def morton_order(x):
    """The fibers' order by the Morton code of their centroids
    (``x`` [nf, n, 3]): the JAX package's `sort_fibers_morton`, which
    keeps a chunk of consecutive fibers compact in space."""
    import numpy as np

    cent = x.mean(axis=1)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, np.finfo(np.float64).tiny)
    q = np.clip((cent - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def mxu_envelope_check(torch, device):
    """The float32 mxu Stokeslet in its regime, on the JAX package's own
    gate (tests/test_kernels.py `test_mxu_f32_accuracy_envelope`): 256
    straight 16-node fibers of unit length in a box of side 20, in Morton
    order, source chunks of 512 each recentered on its first point;
    within MXU_GATE of the float64 sum (kernel B) in norm, and kernel A
    within 5e-5."""
    import numpy as np

    from skellysim_tpu_torch.ops import kernels as tk

    rng = np.random.default_rng(9)
    nf, n = 256, 16
    origins = rng.uniform(-10, 10, (nf, 3))
    dirs = rng.normal(size=(nf, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.linspace(0, 1, n)
    x = origins[:, None, :] + t[None, :, None] * dirs[:, None, :]
    x = x[morton_order(x)]
    r64 = torch.as_tensor(x.reshape(-1, 3), device=device)
    f64_ = torch.as_tensor(rng.standard_normal((nf * n, 3)), device=device)
    ref = tk.stokeslet_direct(r64, r64, f64_, 1.0)
    r32, f32_ = r64.float(), f64_.float()
    exact = tk.stokeslet_direct(r32, r32, f32_, 1.0)
    mxu = tk.mxu_sum("stokeslet", r32, r32, f32_, centered_chunk=512) / (
        8.0 * math.pi)
    nrm = torch.linalg.vector_norm(ref)
    err_a = float(torch.linalg.vector_norm(exact.double() - ref) / nrm)
    err = float(torch.linalg.vector_norm(mxu.double() - ref) / nrm)
    log(f"[tiles] mxu float32 in its regime (the JAX package's envelope "
        f"cloud: 256 Morton-ordered 16-node fibers, chunks of 512): error "
        f"against B {err:.3e} of the norm (gate {MXU_GATE}), A's "
        f"{err_a:.3e} (gate 5e-5)")
    if not (err <= MXU_GATE and err_a <= 5e-5):
        raise SystemExit(f"tiles: the float32 mxu envelope: {err}, A {err_a}")
    return {"mxu_err": err, "a_err": err_a}


def phase_options(torch, ck, device, ring_inputs, nodes, f, card):
    """Phase 16 a-c, on phase 6's precompute and phase 3's cloud: the
    s-step solve (`phase_sstep`), the guard ladder (`phase_ladder`), and
    the "df" / "mxu" tiles (`tile_check`, with `two_sum_check`). Returns
    (its summary, launch counts by run)."""
    from skellysim_tpu_torch.builder import build_simulation
    from skellysim_tpu_torch.config import schema

    cfg_path = ring_inputs["cfg_path"]
    config = schema.load_config(cfg_path)
    t0 = time.perf_counter()
    system, state, _ = build_simulation(
        config, config_dir=os.path.dirname(cfg_path), device=device)
    log(f"[sstep] phase 6's ellipsoid config built in "
        f"{time.perf_counter() - t0:.1f} s (the shell npz load included)")
    out = {}
    out["sstep"], launches, keep = phase_sstep(torch, ck, device, system,
                                               state)
    out["ladder"], more = phase_ladder(torch, ck, device, system, state,
                                       keep["mixed"])
    launches.update(more)
    # phase 17 starts from this state (the shell npz loads once)
    ring_inputs["state"] = state
    ring_inputs["system_args"] = (system.params, system.shell_shape)
    del keep, state, system
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stamp("phase 16a-b")
    out["transforms"] = two_sum_check(torch, device)
    out["mxu_envelope"] = mxu_envelope_check(torch, device)
    n = min(TILE_CUT, len(nodes))
    out["tiles"] = [
        tile_check(torch, ck, device, "stokeslet", nodes[:n], nodes[:n],
                   f[:n], card),
        tile_check(torch, ck, device, "stresslet",
                   ring_inputs["shell_nodes"], ring_inputs["fiber_nodes"],
                   ring_inputs["f_dl"], card)]
    return out, launches


def recorded_plans(ck, fn):
    """(``fn()``'s result, the set of A-D launch plans it took: (family,
    prec, n_trg, n_src, chunks, chunk_len) a plan, which fix each member's
    summation order), read by wrapping `ck.pair_card_plan` for the call."""
    seen, orig = set(), ck.pair_card_plan

    def plan(family, device, prec, n_trg, n_src, members=1, chunks=None):
        got = orig(family, device, prec, n_trg, n_src, members, chunks)
        seen.add((family, prec, n_trg, n_src, got.chunks, got.chunk_len))
        return got

    ck.pair_card_plan = plan
    try:
        return fn(), seen
    finally:
        ck.pair_card_plan = orig


def phase_member_mesh(torch, ck, device, mesh_inputs):
    """Phase 16d, after 15: its 8 members (admitted, on the next capacity
    rung, the shell preconditioner inverted in f64) on
    `make_member_mesh(MESH_SHARDS, device=...)` (the shards on the one
    card, stepped one after the other), MESH_ROUNDS rounds in the "full"
    "vmap" plan and in "unroll", each round against the one-card round
    from the same states. Gated on equal iterations a member, and the
    one-card bits where the shards' launches took the one-card round's
    plans (`recorded_plans`: every "unroll" lane launches alone; a "vmap"
    shard's member-batched plans may split the sources otherwise), else
    fibers within MESH_DX; on the kernels of the plan launching. Prints
    which case each round is in, and the round walls beside the one-card
    round's. Returns (summary, launch counts by run)."""
    from skellysim_tpu_torch.ensemble.runner import EnsembleRunner
    from skellysim_tpu_torch.parallel import (gather_ensemble,
                                              make_member_mesh,
                                              shard_ensemble)

    full_sys, grown, rngs, members = (mesh_inputs[k] for k in
                                      ("system", "states", "rngs",
                                       "members"))
    mesh = make_member_mesh(MESH_SHARDS, device=device)
    out, launches = {}, {}
    need = {"vmap": ["stokeslet_f64_batched", "stresslet_f64_batched"],
            "unroll": ["stokeslet_f64", "stresslet_f64"]}
    for impl in ("vmap", "unroll"):
        runner = EnsembleRunner(full_sys, batch_impl=impl)
        ens = runner.make_ensemble([grown[m] for m in members],
                                   [full_sys.params.t_final] * len(members),
                                   rngs=[rngs[m] for m in members])
        one, sh = ens, shard_ensemble(ens, mesh)
        rows, total = [], {}
        for r in range(MESH_ROUNDS):
            ((one, oinfo), oplans), owall, _ = counted_step(
                torch, ck, device,
                lambda: recorded_plans(ck, lambda: runner.step(one)))
            ((sh, sinfo), splans), swall, counts = counted_step(
                torch, ck, device,
                lambda: recorded_plans(ck, lambda: runner.step(sh)))
            add_counts(total, counts)
            got = gather_ensemble(sh)
            # the plain versions on the CPU rehearsal take no plan
            same_plans = device.type == "cuda" and splans == oplans
            same = torch.equal(got.states.fibers.x, one.states.fibers.x)
            dx = float((got.states.fibers.x - one.states.fibers.x
                        ).abs().max())
            iters_same = bool((sinfo.iters == oinfo.iters).all())
            rows.append({"round": r, "wall_s": swall, "one_card_wall_s": owall,
                         "iters": sinfo.iters.tolist(),
                         "one_card_iters": oinfo.iters.tolist(),
                         "same_plans": same_plans,
                         "plans": sorted(splans),
                         "one_card_plans": sorted(oplans),
                         "same_bits": same, "max_dx": dx})
            case = ("the one-card plans: gate the one-card bits" if same_plans
                    else f"plans differ (shards {sorted(splans - oplans)}, "
                         f"one card {sorted(oplans - splans)}): gate "
                         f"{MESH_DX}")
            log(f"[member_mesh] \"{impl}\" round {r} on {mesh.size} member "
                f"shards of {mesh.devices[0]}: {swall:.3f} s (one card "
                f"{owall:.3f} s); iterations {sinfo.iters.tolist()} (one "
                f"card {oinfo.iters.tolist()}); {case}; the one-card bits: "
                f"{same}, max |dx| {dx:.3e}")
            if not (iters_same and (same if same_plans else dx <= MESH_DX)
                    and bool(sinfo.accepted.all())):
                raise SystemExit(f"member_mesh: {impl} round {r} differs "
                                 f"from the one-card round: {rows[-1]}")
            if impl == "unroll" and not (same and (
                    same_plans or device.type != "cuda")):
                raise SystemExit("member_mesh: an \"unroll\" lane is not the "
                                 "one-card lane, plan and bits")
        need_launched(ck, device, f"member_mesh_{impl}", total, need[impl])
        launches[f"member_mesh_{impl}"] = total
        out[impl] = rows
    return out, launches


#: phase 17: the flight recorder's window, its steps, and the gate of a
#: ring row against the row recomputed on the CPU (float32 columns); the
#: NaN planted at (fiber, node); the velocity grid's side (64^3 = 262,144
#: targets), the CPU cut of the frame and its gates (the pair sums from
#: the same sources; the whole path, whose fiber force densities differ
#: by the two BLAS's summation orders), the body probes' gate;
#: the listener's requests (seeds, the slice's side) and the slice's gate
#: against the field in this process; a tree answer's gate, in units of
#: tree_tol (phase 12b's stresslet gate: the field holds the shell's
#: double layer)
FLIGHT_WINDOW = 32
FLIGHT_STEPS = 3
FLIGHT_REL = 1e-6
FLIGHT_NAN = (17, 5)
VEL_GRID = 64
VEL_CPU_FIBERS = 200
VEL_CPU_TARGETS = 4096
VEL_CPU_GATE = 1e-10
VEL_PATH_GATE = 1e-8
VEL_BODY_GATE = 1e-12
LISTEN_STREAMLINES = 64
LISTEN_VORTEX = 16
LISTEN_SLICE = 128
LISTEN_GATE = 1e-12
LISTEN_TIMEOUT_S = 300


def light_cpu(torch, st):
    """A CPU copy of what the recorder and the velocity field read: the
    fiber groups, the shell without its dense operators, the bodies and
    the sources (the flight ring dropped)."""
    def to(obj):
        if obj is None:
            return None
        if torch.is_tensor(obj):
            return obj.cpu()
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*[to(v) for v in obj])
        if isinstance(obj, tuple):
            return tuple(to(v) for v in obj)
        return obj

    shell = st.shell
    if shell is not None:
        shell = shell._replace(M_inv=None, stresslet_plus_complementary=None)
    return to(st._replace(shell=shell, flight=None))


def cut_fibers(torch, st, n):
    """``st`` with its one fiber bucket cut to its first ``n`` fibers."""
    g = fiber_groups(st.fibers)[0]
    nf = g.n_fibers
    cut = type(g)(*[v[:n] if torch.is_tensor(v) and v.shape[:1] == (nf,)
                    else v for v in g])
    return st._replace(fibers=cut)


def flight_rows_match(np, got, ref, skip=()):
    """(ids equal, largest relative gap of the float columns) of two ring
    rows; ``skip``: columns each side records of its own solve."""
    from skellysim_tpu_torch.obs.flight import FLIGHT_FIELDS

    ids = [FLIGHT_FIELDS.index(k) for k in ("strain_fiber", "health",
                                            "prov_field", "prov_fiber",
                                            "prov_node")]
    floats = [i for i in range(len(FLIGHT_FIELDS))
              if i not in ids and FLIGHT_FIELDS[i] not in skip]
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    same_ids = bool(np.array_equal(got[ids], ref[ids]))
    a, b = got[floats], ref[floats]
    both_nan = np.isnan(a) & np.isnan(b)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(both_nan | (a == b), 0.0,
                       np.abs(a - b) / np.maximum(np.abs(b), 1e-300))
    return same_ids, float(np.nanmax(np.where(np.isnan(rel), np.inf, rel)))


def phase_flight(torch, ck, device, system, state, mesh_inputs, work, out,
                 after_timed=None):
    """17a: phase 6's ellipsoid "mixed" with flight_window = FLIGHT_WINDOW:
    FLIGHT_STEPS steps armed against as many unarmed from the same state
    (the states and solutions the same bits), each ring row against
    `record_step` recomputed on the CPU from copies of the same (entry,
    new) states, `record_step` again under the sync debug mode, a NaN's
    provenance; phase 13b's scene on SPMD_SHARDS shards of the card (every
    shard's ring the same bits, against the one-card row); phase 15's
    members, armed, one lane poisoned. ``after_timed`` (if given) is called
    once the timed steps are done, so that what it starts does not share
    the card with them. Fills ``out``; returns the launch counts of the
    armed steps."""
    import numpy as np

    from skellysim_tpu_torch.ensemble import (EnsembleRunner,
                                              EnsembleScheduler, MemberSpec)
    from skellysim_tpu_torch.guard import chaos
    from skellysim_tpu_torch.obs import flight
    from skellysim_tpu_torch.parallel import make_mesh, shard_state
    from skellysim_tpu_torch.system import System

    def armed_twin(sys_):
        return System(dataclasses.replace(sys_.params,
                                          flight_window=FLIGHT_WINDOW),
                      shell_shape=sys_.shell_shape, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    armed = armed_twin(system)
    s_off, s_on = state, armed.ensure_flight(state)
    walls, rows, launches = [], [], {}
    for i in range(FLIGHT_STEPS):
        # the pair's order alternates, so that what the second step of a
        # pair gains from running second falls on both sides
        armed_first = i % 2 == 1
        wall = {}
        for armed_now in (True, False) if armed_first else (False, True):
            reset_counts(ck)
            sync()
            t0 = time.perf_counter()
            if armed_now:
                n_on, x_on, i_on = armed.step(s_on)
            else:
                n_off, x_off, i_off = system.step(s_off)
            sync()
            wall[armed_now] = time.perf_counter() - t0
            if armed_now:
                add_counts(launches, read_counts(ck))
        same = (torch.equal(x_off, x_on)
                and torch.equal(fiber_groups(n_off.fibers)[0].x,
                                fiber_groups(n_on.fibers)[0].x)
                and torch.equal(n_off.shell.density, n_on.shell.density)
                and i_off == i_on)
        cpu_ring = flight.record_step(
            light_cpu(torch, s_on), light_cpu(torch, n_on)._replace(
                flight=flight.new_ring(FLIGHT_WINDOW)),
            x_on.cpu(), residual_true=i_on.residual_true,
            health=i_on.health, dt_used=i_on.dt_used,
            shell_shape=armed.shell_shape)
        row = n_on.flight.rows[i].cpu().numpy()
        same_ids, rel = flight_rows_match(np, row,
                                          cpu_ring.rows[0].numpy())
        walls.append((wall[False], wall[True], armed_first))
        rows.append({"step": i, "unarmed_wall_s": wall[False],
                     "armed_wall_s": wall[True], "armed_first": armed_first,
                     "same_bits": same,
                     "row_ids_equal_cpu": same_ids, "row_rel_cpu": rel,
                     "row": flight.decode_row(row)})
        log(f"[flight] step {i}: unarmed {wall[False]:.3f} s, armed "
            f"{wall[True]:.3f} s ({'armed' if armed_first else 'unarmed'} "
            f"first; iterations {i_on.iters}); states and "
            f"solutions the same bits: {same}; the row against record_step "
            f"on the CPU: ids equal {same_ids}, float columns within "
            f"{rel:.2e} (gate {FLIGHT_REL}); row "
            f"{json.dumps(flight.decode_row(row))}")
        if not (same and same_ids and rel <= FLIGHT_REL
                and i_on.health == 0):
            raise SystemExit(f"flight: step {i} failed its gates: "
                             f"{rows[-1]}")
        entry = s_on
        s_off = n_off._replace(time=n_off.time + n_off.dt)
        s_on = n_on._replace(time=n_on.time + n_on.dt)
    out["steps"] = rows
    diff_ms = [1e3 * (on - off) for off, on, _ in walls]
    off_ms = [1e3 * off for off, _, _ in walls]
    out["armed_minus_unarmed_ms"] = diff_ms
    marked = ", ".join(f"{d:+.1f}" + ("*" if w[2] else "")
                       for d, w in zip(diff_ms, walls))
    log(f"[flight] armed - unarmed wall a step (nothing else on the card; "
        f"the armed step first in the pairs marked *): {marked} ms, mean "
        f"{sum(diff_ms) / len(diff_ms):+.1f} ms; the unarmed steps' own "
        f"spread {max(off_ms) - min(off_ms):.1f} ms")
    if after_timed is not None:
        after_timed()

    # record_step alone under the sync debug mode (its matrices cached by
    # the steps above)
    sync()
    if device.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        ring = flight.record_step(entry, n_on, x_on,
                                  residual_true=i_on.residual_true,
                                  health=i_on.health, dt_used=i_on.dt_used,
                                  shell_shape=armed.shell_shape)
    finally:
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    same_again = torch.equal(ring.rows[FLIGHT_STEPS],
                             n_on.flight.rows[FLIGHT_STEPS - 1])
    out["record_step_no_sync"] = device.type == "cuda"
    log(f"[flight] record_step alone under torch.cuda.set_sync_debug_mode("
        f"\"error\"): no host sync"
        f"{'' if device.type == 'cuda' else ' (not checked: CPU)'}; its "
        f"row the step's bits: {same_again}")
    if not same_again:
        raise SystemExit("flight: record_step alone wrote another row")

    # a NaN at (fiber, node): the nonfinite bit and its provenance
    f_nan, n_nan = FLIGHT_NAN
    g = fiber_groups(s_on.fibers)[0]
    x = g.x.clone()
    x[f_nan, n_nan, 1] = float("nan")
    bad = s_on._replace(fibers=g._replace(x=x))
    sync()
    t0 = time.perf_counter()
    n_bad, _, i_bad = armed.step(bad)
    sync()
    prov = flight.read_last(n_bad.flight)
    out["nan"] = {"health": i_bad.health, "row": prov,
                  "wall_s": time.perf_counter() - t0}
    log(f"[flight] a NaN at fiber {f_nan} node {n_nan}: health "
        f"{i_bad.health:#x}, provenance {prov['provenance']} "
        f"({time.perf_counter() - t0:.3f} s)")
    if not (i_bad.health & 1 and (prov["prov_field"], prov["prov_fiber"],
                                  prov["prov_node"]) == (1, f_nan, n_nan)):
        raise SystemExit(f"flight: the NaN was not localized: {prov}")
    del bad, n_bad, n_off, x_off
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # phase 13b's scene on SPMD_SHARDS shards of the card
    bstate = spmd_body_state(torch, armed, state)
    mesh = make_mesh(SPMD_SHARDS, device=device)
    sync()
    t0 = time.perf_counter()
    new, _, sinfo = armed.step_spmd(shard_state(bstate, mesh), mesh)
    sync()
    swall = time.perf_counter() - t0
    rings = [st.flight for st in new.shards]
    same_shards = all(torch.equal(r.rows.view(torch.int32),
                                  rings[0].rows.view(torch.int32))
                      and torch.equal(r.count, rings[0].count)
                      for r in rings[1:])
    one, _, oinfo = armed.step(bstate)
    srow = rings[0].rows[0].cpu().numpy()
    orow = one.flight.rows[0].cpu().numpy()
    same_ids, rel = flight_rows_match(np, srow, orow,
                                      skip=("residual_true",))
    srec = flight.decode_row(srow)
    out["spmd"] = {"shards": mesh.size, "wall_s": swall,
                   "same_bits_every_shard": same_shards,
                   "ids_equal_one_card": same_ids, "rel_one_card": rel,
                   "row": srec, "one_card_row": flight.decode_row(orow)}
    log(f"[flight_spmd] phase 13b's scene on {mesh.size} shards of "
        f"{mesh.devices[0]}, armed: {swall:.3f} s, iterations {sinfo.iters} "
        f"(one card {oinfo.iters}); every shard's ring the same bits: "
        f"{same_shards}; against the one-card row: ids equal {same_ids}, "
        f"float columns within {rel:.2e} (gate {FLIGHT_REL}; the true "
        f"residual is each solve's own); body_norm {srec['body_norm']:.6g}")
    if not (same_shards and same_ids and rel <= FLIGHT_REL
            and srec["body_norm"] > 0):
        raise SystemExit(f"flight_spmd: failed its gates: {out['spmd']}")
    del bstate, new, one, rings
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # phase 15's members, armed; one lane poisoned after a healthy round
    full_sys, grown, rngs, members = (mesh_inputs[k] for k in
                                      ("system", "states", "rngs",
                                       "members"))
    ens_sys = armed_twin(full_sys)
    records = []
    sched = EnsembleScheduler(
        EnsembleRunner(ens_sys, batch_impl="vmap"),
        [MemberSpec(m, grown[m], ens_sys.params.t_final, rng=rngs[m])
         for m in members], len(members), metrics=records.append,
        on_failure="retire", on_growth="retire")
    sync()
    t0 = time.perf_counter()
    sched.poll()
    poisoned = len(members) // 2
    sched.ens = chaos.poison_lane(sched.ens, poisoned)
    sched.poll()
    sync()
    ewall = time.perf_counter() - t0
    fails = [r for r in records if r.get("event") == "failed"]
    steps = [r for r in records if r.get("event") == "step"]
    bad_m = members[poisoned]
    payload = fails[0]["flight"] if fails else None
    clean = all(r["flight"] is not None and r["flight"]["provenance"] is None
                for r in steps if r["member"] != bad_m)
    out["ensemble"] = {"members": len(members), "wall_s": ewall,
                       "failed": [r["member"] for r in fails],
                       "provenance": (payload or {}).get("provenance"),
                       "tail": len((payload or {}).get("tail") or []),
                       "others_clean": clean,
                       "step_records": len(steps)}
    log(f"[flight_ensemble] phase 15's {len(members)} members, armed "
        f"(window {FLIGHT_WINDOW}), two \"vmap\" rounds, lane {poisoned} "
        f"({bad_m}) poisoned after the first: {ewall:.3f} s; failed "
        f"{out['ensemble']['failed']} with provenance "
        f"{out['ensemble']['provenance']} and a tail of "
        f"{out['ensemble']['tail']} rows; the other lanes' rows carry no "
        f"provenance: {clean}")
    if not (len(fails) == 1 and fails[0]["member"] == bad_m and payload
            and payload["provenance"]
            and payload["provenance"]["field"] == "fiber_x" and clean):
        raise SystemExit(f"flight_ensemble: failed its gates: "
                         f"{out['ensemble']}")
    report = os.path.join(work, "flight_ensemble.jsonl")
    with open(report, "w") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")
    text = flight.render_flight_report([report])
    os.remove(report)
    for line in text.rstrip().splitlines():
        log(f"[flight_report] {line}")
    return launches


def velocity_grid(np, nodes, side):
    """side^3 points over the bounding box of ``nodes``."""
    lo, hi = nodes.min(axis=0), nodes.max(axis=0)
    axes = [np.linspace(lo[k], hi[k], side) for k in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return g.reshape(-1, 3)


def phase_velocity(torch, ck, device, system, frame_state, work, out):
    """17b: phase 6's last frame: the field built once and evaluated at
    VEL_GRID^3 points over the shell's box, each part timed with its
    launches; the card against the CPU on the frame cut to VEL_CPU_FIBERS
    fibers; "tree" against direct; on the body-drag scene, probes inside
    the body against v + omega x dx from the same solution. Fills ``out``;
    returns the launch counts of the grid evaluation."""
    import numpy as np

    from skellysim_tpu_torch import precompute
    from skellysim_tpu_torch.builder import build_simulation
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.system.system import solution_from_state

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    side = VEL_GRID if device.type == "cuda" else 16
    sol = solution_from_state(frame_state)
    grid = torch.as_tensor(velocity_grid(
        np, frame_state.shell.nodes.cpu().numpy(), side), device=device)
    sync()
    reset_counts(ck)
    t0 = time.perf_counter()
    field = system.velocity_field(frame_state, sol)
    sync()
    t1 = time.perf_counter()
    build_counts = {k: v for k, v in read_counts(ck).items() if v}
    reset_counts(ck)
    v = field(grid)
    sync()
    t2 = time.perf_counter()
    grid_counts = read_counts(ck)
    v_again = field(grid)
    sync()
    t3 = time.perf_counter()
    finite = bool(torch.isfinite(v).all())
    out["grid"] = {"targets": grid.shape[0], "build_s": t1 - t0,
                   "build_launches": build_counts, "first_s": t2 - t1,
                   "again_s": t3 - t2,
                   "launches": {k: c for k, c in grid_counts.items() if c},
                   "same_bits_again": torch.equal(v, v_again),
                   "finite": finite}
    log(f"[velocity] phase 6's last frame (t={frame_state.time:.4g}) at "
        f"{grid.shape[0]} grid targets over the shell's box: the frame's "
        f"sources once {t1 - t0:.3f} s (launches {build_counts}), the pair "
        f"sums at the targets {t2 - t1:.3f} s, again {t3 - t2:.3f} s (the "
        f"same bits: {out['grid']['same_bits_again']}); launches "
        f"{out['grid']['launches']}; max |v| "
        f"{float(v.abs().max()):.4g}")
    if not (finite and out["grid"]["same_bits_again"]):
        raise SystemExit(f"velocity: the grid field failed: {out['grid']}")
    if device.type == "cuda" and not (grid_counts["stokeslet_f64"]
                                      and grid_counts["stresslet_f64"]):
        raise SystemExit(f"velocity: B / D did not launch: {grid_counts}")

    # the card against the CPU on the cut frame: the pair sums from the
    # same sources (the card's, copied), and the whole path with each
    # side's own sources
    cut = cut_fibers(torch, frame_state, VEL_CPU_FIBERS)
    rng = np.random.default_rng(17)
    pts = grid[torch.as_tensor(rng.choice(grid.shape[0], VEL_CPU_TARGETS,
                                          replace=False), device=device)]
    card_field = system.velocity_field(cut, solution_from_state(cut))
    card = card_field(pts).cpu()
    cpu_sys = System(system.params, shell_shape=system.shell_shape,
                     device="cpu")
    cut_cpu = light_cpu(torch, cut)
    host_field = cpu_sys.velocity_field(cut_cpu,
                                        solution_from_state(cut_cpu))
    host = host_field(pts.cpu())
    f_host = torch.cat([f.reshape(-1) for f in host_field.forces])
    f_card = torch.cat([f.reshape(-1) for f in card_field.forces]).cpu()
    f_rel = float((f_card - f_host).abs().max() / f_host.abs().max())
    host_field.forces = [f.cpu() for f in card_field.forces]
    host_field.density = card_field.density.cpu()
    shared = host_field(pts.cpu())
    rel = float((card - shared).abs().max() / shared.abs().max())
    rel_path = float((card - host).abs().max() / host.abs().max())
    out["card_vs_cpu"] = {"fibers": VEL_CPU_FIBERS,
                          "targets": VEL_CPU_TARGETS, "sums_rel": rel,
                          "path_rel": rel_path, "forces_rel": f_rel}
    log(f"[velocity] the frame cut to {VEL_CPU_FIBERS} fibers at "
        f"{VEL_CPU_TARGETS} of the grid's targets, card against CPU: the "
        f"pair sums from the same sources max |dv| / max |v| = {rel:.3e} "
        f"(gate {VEL_CPU_GATE}); the whole path, each side's own sources, "
        f"{rel_path:.3e} (gate {VEL_PATH_GATE}), the fiber force densities "
        f"{f_rel:.3e} apart (the stiff fiber operator applied to smooth "
        f"positions cancels: cuBLAS and the host BLAS sum in other orders)")
    if not (rel <= VEL_CPU_GATE and rel_path <= VEL_PATH_GATE):
        raise SystemExit(f"velocity: card against CPU {rel:.3e}, "
                         f"{rel_path:.3e}")

    # "tree" against direct
    tree = System(dataclasses.replace(system.params, pair_evaluator="tree"),
                  shell_shape=system.shell_shape, device=device)
    sync()
    reset_counts(ck)
    t0 = time.perf_counter()
    v_tree = tree.velocity_at_targets(frame_state, sol, grid)
    sync()
    twall = time.perf_counter() - t0
    tcounts = {k: c for k, c in read_counts(ck).items() if c}
    trel = float((v_tree - v).abs().max() / v.abs().max())
    gate = TREE_STRESSLET_GATE * tree.params.tree_tol
    out["tree"] = {"wall_s": twall, "rel": trel, "gate": gate,
                   "launches": tcounts}
    log(f"[velocity] through \"tree\" (tree_tol {tree.params.tree_tol:g}, "
        f"the plan over the nodes and the grid): {twall:.3f} s (the host "
        f"plan included); field-normalized max |dv| against direct "
        f"{trel:.3e} (gate {gate:g}, phase 12b's stresslet gate); launches "
        f"{tcounts}")
    if not trel <= gate:
        raise SystemExit(f"velocity: tree against direct {trel:.3e}")
    if device.type == "cuda" and not (tcounts.get("tree_stokeslet_f64")
                                      and tcounts.get("tree_stresslet_f64")):
        raise SystemExit(f"velocity: G / H did not launch: {tcounts}")
    # the field itself is kept for phase 21b (FieldWriter)
    out["_field"] = (grid, v, float(frame_state.time))
    del field, v, v_again, v_tree, grid
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the body-drag scene: probes inside the body move with it
    run_dir = os.path.join(work, "flight_body")
    os.makedirs(run_dir)
    cfg = os.path.join(run_dir, "skelly_config.toml")
    make_body_config(cfg)
    precompute.main([cfg, f"--device={device.type}"])
    bsys, bst, _ = build_simulation(cfg, device=device)
    bnew, bsol, _ = bsys.step(bst)
    g = bnew.bodies
    center = g.position[0]
    offs = torch.as_tensor(np.random.default_rng(9).uniform(
        -0.25, 0.25, (64, 3)), device=device)
    v_in = bsys.velocity_at_targets(bnew, bsol, center + offs)
    fs, ss, _ = bsys._sizes(bnew)
    vel6 = bsol[fs + ss:].reshape(g.n_bodies, -1)[0, -6:]
    dx = (center + offs) - center
    rigid = vel6[:3] + torch.cross(vel6[3:].expand_as(dx), dx, dim=-1)
    brel = float((v_in - rigid).abs().max() / rigid.abs().max())
    out["body"] = {"probes": offs.shape[0], "rel": brel}
    log(f"[velocity] the body-drag scene after one step: {offs.shape[0]} "
        f"probes inside the body against v + omega x dx from the same "
        f"solution: max |dv| / max |v| = {brel:.3e} (gate {VEL_BODY_GATE})")
    shutil.rmtree(run_dir)
    if not brel <= VEL_BODY_GATE:
        raise SystemExit(f"velocity: inside the body {brel:.3e}")
    return grid_counts


def listener_seeds(np, frame_state, n, seed):
    """``n`` points inside the ellipsoid's middle half (default_rng)."""
    nodes = frame_state.shell.nodes.cpu().numpy()
    half = 0.5 * (nodes.max(axis=0) - nodes.min(axis=0)) / 2.0
    u = np.random.default_rng(seed).uniform(-1.0, 1.0, (4 * n, 3))
    u = u[np.sum(u * u, axis=1) < 1.0][:n]
    return u * half


def listener_slice(np, frame_state, side):
    """side^2 points on the z = 0 plane over the shell's box."""
    nodes = frame_state.shell.nodes.cpu().numpy()
    lo, hi = nodes.min(axis=0), nodes.max(axis=0)
    xs = np.linspace(lo[0], hi[0], side)
    ys = np.linspace(lo[1], hi[1], side)
    g = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)
    return np.concatenate([g, np.zeros((g.shape[0], 1))], axis=1)


def start_listener(torch, device, cfg_path, work):
    """`python -m skellysim_tpu_torch --listen` on ``cfg_path`` as a
    subprocess driven by the port's `Listener` (its standard error to a
    file): (listener, stderr path, start time)."""
    from skellysim_tpu_torch.io import Listener

    err_path = os.path.join(work, "listener.err")
    err = open(err_path, "w")
    env = dict(os.environ, PYTHONPATH=REPO)
    lis = Listener(toml_file=cfg_path, device=device.type, stderr=err,
                   env=env)
    err.close()
    return lis, err_path, time.perf_counter()


def phase_listener(torch, device, system, frame_state, n_frames, lis,
                   err_path, started, out):
    """17c: requests to the listener started by `start_listener` over
    phase 6's trajectory: LISTEN_STREAMLINES streamline seeds,
    LISTEN_VORTEX vortex-line seeds and a LISTEN_SLICE^2 velocity slice
    (against `velocity_at_targets` in this process), the same through
    "tree", an invalid frame, an unknown evaluator and the request after
    it, then the terminate frame (exit code 0). Fills ``out``."""
    import numpy as np

    from skellysim_tpu_torch.io import (Request, StreamlinesRequest,
                                        VelocityFieldRequest)
    from skellysim_tpu_torch.system.system import solution_from_state

    last = n_frames - 1
    side = LISTEN_SLICE if device.type == "cuda" else 16
    n_sl = LISTEN_STREAMLINES if device.type == "cuda" else 4
    n_vl = LISTEN_VORTEX if device.type == "cuda" else 2
    seeds_sl = listener_seeds(np, frame_state, n_sl, 1)
    seeds_vl = listener_seeds(np, frame_state, n_vl, 2)
    pts = listener_slice(np, frame_state, side)

    def full_request(evaluator):
        # the lines at the client's (the reference's) defaults: dt_init
        # 0.1, t_final 1, abs_err 1e-10, rel_err 1e-6, both legs
        return Request(frame_no=last, evaluator=evaluator,
                       streamlines=StreamlinesRequest(x0=seeds_sl),
                       vortexlines=StreamlinesRequest(x0=seeds_vl),
                       velocity_field=VelocityFieldRequest(x=pts))

    walls = {}

    def ask(tag, req):
        t0 = time.perf_counter()
        res = lis.request(req)
        walls[tag] = time.perf_counter() - t0
        return res

    dense = ask("dense", full_request("CPU"))
    tree = ask("tree", full_request("tree"))
    invalid = ask("invalid_frame", Request(frame_no=n_frames + 7))
    unknown = ask("unknown_evaluator", Request(frame_no=last,
                                               evaluator="no-such"))
    after = ask("after_unknown", Request(
        frame_no=0, evaluator="CPU",
        velocity_field=VelocityFieldRequest(x=pts[:8])))
    rc = lis.close(timeout=LISTEN_TIMEOUT_S)
    total = time.perf_counter() - started
    logs = [json.loads(ln.split("listener request ", 1)[1])
            for ln in open(err_path) if "listener request " in ln]

    # the slice against the field in this process
    here = system.velocity_at_targets(frame_state,
                                      solution_from_state(frame_state),
                                      pts).cpu().numpy()
    got = np.asarray(dense["velocity_field"]).reshape(-1, 3)
    rel = float(np.abs(got - here).max() / np.abs(here).max())
    tgot = np.asarray(tree["velocity_field"]).reshape(-1, 3)
    trel = float(np.abs(tgot - got).max() / np.abs(got).max())
    tgate = TREE_STRESSLET_GATE * system.params.tree_tol

    def lines_ok(lines, seeds):
        if len(lines) != len(seeds):
            return False
        for ln, s in zip(lines, seeds):
            x = np.asarray(ln["x"]).reshape(-1, 3)
            t = np.asarray(ln["time"]).reshape(-1)
            if not (np.isfinite(x).all() and np.isfinite(t).all()
                    and len(t) == len(x)):
                return False
            zero = np.flatnonzero(t == 0.0)
            if len(zero) != 1 or not np.array_equal(x[zero[0]], s):
                return False
        return True

    ok_sl = lines_ok(dense["streamlines"], seeds_sl)
    ok_vl = lines_ok(dense["vortexlines"], seeds_vl)
    samples = [len(np.asarray(ln["time"]).reshape(-1))
               for ln in dense["streamlines"]]
    out.update({
        "process_s": total, "rc": rc, "walls_s": walls,
        "slice_points": len(pts), "slice_rel_in_process": rel,
        "tree_rel": trel, "tree_gate": tgate,
        "streamlines_ok": ok_sl, "vortexlines_ok": ok_vl,
        "streamline_samples": [min(samples), max(samples)],
        "invalid_empty": invalid is None, "unknown_empty": unknown is None,
        "after_unknown_answered": after is not None, "requests": logs})
    for rec in logs:
        log(f"[listener] request frame {rec['frame_no']} through "
            f"{rec['evaluator']}: {rec['wall_s']:.3f} s in the server, "
            f"{rec['integrator_steps']} integrator steps, "
            f"{rec['velocity_calls']} velocity evaluations at "
            f"{rec['velocity_points']} points; launches {rec['launches']}")
    log(f"[listener] `python -m skellysim_tpu_torch --listen` over phase "
        f"6's {n_frames} frames (started after 17a's timed steps, so its "
        f"start-up ran beside the rest of 17a and 17b): request walls at "
        f"the client (the first request's includes what start-up was "
        f"left) "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}; "
        f"{len(seeds_sl)} streamlines of {min(samples)}-{max(samples)} "
        f"samples, finite, each forward leg at its seed: {ok_sl}; "
        f"{len(seeds_vl)} vortex lines: {ok_vl}; the {len(pts)}-point "
        f"slice against velocity_at_targets here: {rel:.3e} (gate "
        f"{LISTEN_GATE}); through \"tree\" against it: {trel:.3e} (gate "
        f"{tgate:g}); invalid frame answered empty: {invalid is None}; "
        f"unknown evaluator answered empty: {unknown is None}, the next "
        f"request answered: {after is not None}; exit code {rc}; "
        f"{total:.1f} s in all")
    if not (rc == 0 and ok_sl and ok_vl and rel <= LISTEN_GATE
            and trel <= tgate and invalid is None and unknown is None
            and after is not None and len(logs) == 4):
        raise SystemExit(f"listener: failed its gates: "
                         f"{ {k: v for k, v in out.items() if k != 'requests'} }")


def phase_flight_listener(torch, ck, device, ring_inputs, mesh_inputs,
                          work):
    """Phase 17 (after 16d, on phase 6's precompute and trajectory and
    phase 15's members): 17a (`phase_flight`) times its steps alone, then
    starts the listener in its own process, which loads while the rest of
    17a and 17b (`phase_velocity`) run here; then 17c (`phase_listener`).
    Returns (summary, launch counts by run)."""
    from skellysim_tpu_torch.io.trajectory import (TrajectoryReader,
                                                   frame_to_state)
    from skellysim_tpu_torch.system import System

    cfg_path = ring_inputs["cfg_path"]
    traj = os.path.join(os.path.dirname(cfg_path), "skelly_sim.out")
    listener = []
    try:
        # phase 16a's first state of phase 6's config
        state = ring_inputs["state"]
        params, shape = ring_inputs["system_args"]
        system = System(params, shell_shape=shape, device=device)
        out, launches = {"flight": {}, "velocity": {}, "listener": {}}, {}
        launches["flight_ellipsoid"] = phase_flight(
            torch, ck, device, system, state, mesh_inputs, work,
            out["flight"], after_timed=lambda: listener.append(
                start_listener(torch, device, cfg_path, work)))
        reader = TrajectoryReader(traj)
        n_frames = len(reader)
        frame_state = frame_to_state(reader.load_frame(n_frames - 1), state)
        reader.close()
        launches["velocity_grid"] = phase_velocity(
            torch, ck, device, system, frame_state, work, out["velocity"])
        phase_listener(torch, device, system, frame_state, n_frames,
                       *listener[0], out["listener"])
    finally:
        if listener:
            listener[0][0].close(timeout=LISTEN_TIMEOUT_S)
    return out, launches


#: phase 18: the service. Its tenants are phase 15's member scene without
#: its cortex (serve tenants bring no periphery): the sphere body with
#: --ensemble-body-nodes nodes and --ensemble-sites sites embedded in the
#: TOML, --ensemble-bound clamped fibers, DI at phase 15's rates; 18a
#: submits SERVE_TENANTS of them (seed and site draw differ) to a "vmap"
#: server of --ensemble-lanes lanes on two buckets of the geometric ladder;
#: 18b's "unroll" server takes two free-space tenants of as many bent
#: fibers; 18c is the chaos smoke over TCP; 18d counts host syncs
SERVE_TENANTS = 10
SERVE_QUEUE_DEPTH = 4
SERVE_UNROLL_LANES = 2
#: the bend of 18b's fibers (circular arcs of this curvature)
SERVE_CURVATURE = 0.5


def make_tenant_config(n_body, n_sites, n_bound, seed, site_seed):
    """One 18a tenant: phase 15's member scene without its cortex (a
    `Config`, nothing written)."""
    import numpy as np

    from skellysim_tpu_torch.config import Body, Config, Fiber

    config = Config()
    p = config.params
    p.eta = 1.0
    p.dt_initial = p.dt_write = p.dt_max = ENS_DT
    p.t_final = ENS_ROUNDS * ENS_DT
    p.adaptive_timestep_flag = False
    p.gmres_tol = ENS_GMRES_TOL
    p.solver_precision = "mixed"
    p.seed = seed
    di = p.dynamic_instability
    di.n_nodes, di.v_growth, di.f_catastrophe = ENS_FIBER_NODES, 0.2, 0.5
    di.nucleation_rate, di.min_length = ENS_NUCLEATION_RATE, 0.5
    di.radius, di.bending_rigidity = 0.0125, 0.01
    body = Body(n_nucleation_sites=n_sites, position=[0.0, 0.0, 0.0],
                shape="sphere", radius=0.5, n_nodes=n_body)
    body.generate_nucleation_sites(0.03, verbose=False,
                                   rng=np.random.default_rng(site_seed))
    config.bodies = [body]
    sites = np.asarray(body.nucleation_sites).reshape(-1, 3)
    fibers = []
    for k in range(n_bound):
        f = Fiber(n_nodes=ENS_FIBER_NODES, parent_body=0, parent_site=k,
                  minus_clamped=True, length=1.0, bending_rigidity=0.01,
                  force_scale=ENS_FORCE_SCALE)
        f.fill_node_positions(sites[k], sites[k] / np.linalg.norm(sites[k]))
        fibers.append(f)
    config.fibers = fibers
    return config


def make_free_tenant_config(n_fibers, seed):
    """One 18b tenant: ``n_fibers`` bent free fibers of ENS_FIBER_NODES
    nodes placed by ``seed`` in a uniform flow, "mixed", ENS_ROUNDS rounds
    of ENS_DT."""
    import numpy as np

    from skellysim_tpu_torch.config import BackgroundSource, Config, Fiber

    rng = np.random.default_rng(seed)
    config = Config()
    p = config.params
    p.eta = 1.0
    p.dt_initial = p.dt_write = p.dt_max = ENS_DT
    p.t_final = ENS_ROUNDS * ENS_DT
    p.adaptive_timestep_flag = False
    p.gmres_tol = ENS_GMRES_TOL
    p.solver_precision = "mixed"
    p.seed = seed
    t = np.linspace(0.0, 1.0, ENS_FIBER_NODES)[:, None]
    radius = 1.0 / SERVE_CURVATURE
    fibers = []
    for _ in range(n_fibers):
        origin = rng.uniform(-4.0, 4.0, 3)
        d = rng.standard_normal(3)
        d /= np.linalg.norm(d)
        perp = np.cross(d, rng.standard_normal(3))
        perp /= np.linalg.norm(perp)
        x = (origin + radius * np.sin(t / radius) * d
             + radius * (1.0 - np.cos(t / radius)) * perp)
        f = Fiber(n_nodes=ENS_FIBER_NODES, length=1.0, bending_rigidity=0.01,
                  force_scale=ENS_FORCE_SCALE)
        f.x = x.ravel().tolist()
        fibers.append(f)
    config.fibers = fibers
    config.background = BackgroundSource(uniform=[1.0, 0.0, 0.0])
    return config


def tenant_toml(config) -> str:
    from skellysim_tpu_torch.config import schema
    from skellysim_tpu_torch.config.toml_io import dumps

    return dumps(schema.unpack(config))


def percentiles(vals):
    import numpy as np

    if not vals:
        return None
    return {q: float(np.percentile(vals, int(q[1:])))
            for q in ("p50", "p95", "p99")}


def drain_server(srv, max_ticks=200):
    """Tick ``srv`` until no lane is live; returns the ticks' walls."""
    walls = []
    while srv.any_live():
        if len(walls) >= max_ticks:
            raise SystemExit(f"serve: the service did not drain in "
                             f"{max_ticks} ticks")
        t0 = time.perf_counter()
        srv.tick()
        walls.append(time.perf_counter() - t0)
    return walls


class ServeSteps:
    """Records the step records every `SimulationServer` built while the
    phase runs hands its scheduler callback (the records `/status` folds:
    iterations, residuals, DI counts)."""

    def __enter__(self):
        from skellysim_tpu_torch.serve.server import SimulationServer

        self.cls = SimulationServer
        self.saved = SimulationServer._on_sched_event
        self.records = []
        outer = self

        def record(srv, rec):
            outer.records.append(dict(rec))
            return outer.saved(srv, rec)

        SimulationServer._on_sched_event = record
        return self

    def __exit__(self, *exc):
        self.cls._on_sched_event = self.saved


def serve_vmap(torch, ck, device, work, args, card):
    """18a: SERVE_TENANTS DI tenants through an in-process "vmap" server
    of --ensemble-lanes lanes, two buckets of the geometric ladder, queue
    depth SERVE_QUEUE_DEPTH and a journal, driven by `handle_request` /
    `tick`. The kernel libraries are dropped first, so the warm-up loads
    them again (compile events before warm). Gated on every tenant
    finishing after at least one growth reseat; every step accepted,
    converged and healthy, active = previous + nucleations - catastrophes;
    a finite frame a round holding the step's active fibers; members
    ENS_SOLO within ENS_MIXED_DX of their solo rounds; /stats (tenants,
    lane seats, compiles_after_warm 0, three histograms with p50 / p95 /
    p99, a Prometheus page parsing line by line); A-D launched through
    their member-batched entry points only. Returns (launch counts,
    summary, the server's events)."""
    import numpy as np

    from skellysim_tpu_torch.builder import build_simulation
    from skellysim_tpu_torch.config import schema
    from skellysim_tpu_torch.scenarios.sweep import ensure_di_capacity
    from skellysim_tpu_torch.serve import protocol
    from skellysim_tpu_torch.serve.server import SimulationServer
    from skellysim_tpu_torch.system import buckets as bucket_mod

    lanes = args.ensemble_lanes
    run_dir = os.path.join(work, "serve_vmap")
    os.makedirs(run_dir)
    configs = [make_tenant_config(args.ensemble_body_nodes,
                                  args.ensemble_sites, args.ensemble_bound,
                                  seed=3000 + i, site_seed=500 + i)
               for i in range(SERVE_TENANTS)]
    cfg_path = os.path.join(run_dir, "serve_config.toml")
    configs[0].save(cfg_path)
    with open(cfg_path, "a") as fh:
        fh.write(f'\n[serve]\nmax_lanes = {lanes}\nbucket_count = 2\n'
                 f'queue_depth = {SERVE_QUEUE_DEPTH}\nbatch_impl = "vmap"\n'
                 f'journal_path = "{os.path.join(run_dir, "journal.bin")}"\n'
                 'journal_every = 2\n\n[runtime]\nbucket_ladder = [-1]\n')
    for src in (ck.STOKESLET_SOURCE, ck.STRESSLET_SOURCE):
        ck._libs.pop(src, None)
    with ServeSteps() as rec:
        t0 = time.perf_counter()
        srv = SimulationServer(cfg_path, device=device.type)
        build_s = time.perf_counter() - t0
        caps = [b.capacity for b in srv.buckets]
        warm = dict(srv.warmup_s)
        log(f"[serve] vmap server: buckets {caps} of {lanes} lanes, built "
            f"and warm in {build_s:.2f} s; warm-up seconds by bucket "
            + ", ".join(f"{c}: {s:.3f}" for c, s in warm.items())
            + f"; compile events at warm {srv.metrics.compiles}")
        reset_counts(ck)
        t0 = time.perf_counter()
        resp = []
        for cfg in configs:
            t1 = time.perf_counter()
            r = srv.handle_request({"type": "submit",
                                    "config": tenant_toml(cfg)})
            r["submit_s"] = time.perf_counter() - t1
            if not r["ok"]:
                raise SystemExit(f"serve: submit refused: {r['error']}")
            resp.append(r)
        ticks = drain_server(srv)
        wall = time.perf_counter() - t0
        counts = read_counts(ck)
    queued = sum(1 for r in resp if r["queued"])
    log(f"[serve] {SERVE_TENANTS} tenants submitted ({queued} queued; "
        f"submit {np.median([r['submit_s'] for r in resp]):.3f} s median "
        f"each, the scene built on the lanes' device) and served in "
        f"{wall:.1f} s, {len(ticks)} ticks; launches {counts}")
    tids = [r["tenant"] for r in resp]
    stream_s, frames = [], {}
    for tid in tids:
        t1 = time.perf_counter()
        s = srv.handle_request({"type": "stream", "tenant": tid})
        stream_s.append(time.perf_counter() - t1)
        frames[tid] = [protocol.unpack_message(bytes(f))
                       for f in s["frames"]]
        st = srv.handle_request({"type": "status", "tenant": tid})
        if st["status"] != "finished" or st["health"]:
            raise SystemExit(f"serve: tenant {tid} ended {st}")
    stats = srv.handle_request({"type": "stats"})["stats"]
    reseats = stats["growth_reseats"]
    steps = [r for r in rec.records if r["event"] == "step"]
    for tid in tids:
        mine = [s for s in steps if s["member"] == tid]
        prev = args.ensemble_bound
        if len(mine) != ENS_ROUNDS or len(frames[tid]) != ENS_ROUNDS + 1:
            raise SystemExit(f"serve: tenant {tid} took {len(mine)} steps "
                             f"and streamed {len(frames[tid])} frames")
        for s, fr in zip(mine, frames[tid][1:]):
            if not (s["accepted"] and s["residual_true"] <= ENS_GMRES_TOL
                    and s["health"] == 0):
                raise SystemExit(f"serve: tenant {tid} step {s['step']} is "
                                 f"not converged and healthy: {s}")
            if s["active_fibers"] != prev + s["nucleations"] \
                    - s["catastrophes"]:
                raise SystemExit(f"serve: tenant {tid} step {s['step']}: "
                                 f"{s['active_fibers']} active after {prev}, "
                                 f"+{s['nucleations']} -{s['catastrophes']}")
            x = frame_x(fr)
            if len(fr["fibers"][1]) != s["active_fibers"] \
                    or not np.isfinite(x).all():
                raise SystemExit(f"serve: tenant {tid}'s frame after step "
                                 f"{s['step']} holds {len(fr['fibers'][1])} "
                                 f"fibers ({s['active_fibers']} active) or a "
                                 "non-finite position")
            prev = s["active_fibers"]
    if not reseats:
        raise SystemExit("serve: no growth reseat happened")
    # the members alone, from their admitted states and streams
    policy = srv.policy
    params = srv.system.params
    solo = {}
    for idx in [i for i in ENS_SOLO if i < SERVE_TENANTS] or [0]:
        tid = tids[idx]
        _, state, rng = build_simulation(configs[idx], device=device.type,
                                         synthesize_body_precompute=True)
        state = ensure_di_capacity(state, params, capacity=1)
        state = bucket_mod.bucketize_to(state, srv.buckets[0].key)
        rounds = ensemble_solo(srv.system, params, state, rng, ENS_ROUNDS,
                               policy)
        dxs = []
        for k, (st, info) in enumerate(rounds):
            a, b = live_x(st), frame_x(frames[tid][k + 1])
            if a.shape != b.shape or not info.converged:
                raise SystemExit(f"serve: tenant {tid} alone, round {k}: "
                                 f"{a.shape} fibers against the served "
                                 f"{b.shape}, {info}")
            dxs.append(float(np.abs(a - b).max()))
        if not max(dxs) <= ENS_MIXED_DX:
            raise SystemExit(f"serve: tenant {tid} alone drifts "
                             f"{max(dxs):.3e} from its served frames")
        solo[tid] = dxs
        log(f"[serve] tenant {tid} alone: max |dx| against its served "
            f"frames by round {[f'{d:.2e}' for d in dxs]} (gate "
            f"{ENS_MIXED_DX:g})")
    # /stats
    prom = protocol.render_prometheus(stats)
    for line in prom.strip().splitlines():
        if not (line.startswith("# ") or (len(line.split()) == 2 and
                                          float(line.split()[1]) >= 0)):
            raise SystemExit(f"serve: Prometheus line {line!r}")
    hists = {k: stats[k] for k in ("admission_wait_s", "round_wall_s_hist",
                                   "frame_stream_s")}
    if (stats["tenants"] != SERVE_TENANTS
            or stats["admitted"] != SERVE_TENANTS + reseats
            or stats["compiles_after_warm"] != 0
            or (device.type == "cuda" and not srv.metrics.compiles)
            or any(not (h["n"] and h["p50"] <= h["p95"] <= h["p99"])
                   for h in hists.values())):
        raise SystemExit(f"serve: /stats {json.dumps(stats)[:2000]}")
    if device.type == "cuda":
        batched = {n: counts[n] for n in EnsembleRounds.NAMES}
        lone = {n[:-len("_batched")]: counts[n[:-len("_batched")]]
                for n in EnsembleRounds.NAMES}
        if not all(batched.values()) or any(lone.values()):
            raise SystemExit(f"serve: the batched A-D launched {batched}, "
                             f"the lone A-D {lone}")
    if any(counts[w.__name__] for w in ck.YARDSTICK_WRAPPERS):
        raise SystemExit(f"serve: a yardstick kernel launched: {counts}")
    rounds = [(e["live"], e["lanes"], e["dur_s"]) for e in srv.tracer.events
              if e["ev"] == "span" and e["name"] == "ensemble_step"]
    by_live = {}
    for live, _, dur in rounds:
        by_live.setdefault(live, []).append(dur)
    log(f"[serve] /stats: {stats['tenants']} tenants, {stats['admitted']} "
        f"lane seats ({reseats} growth reseats), {stats['rounds']} rounds, "
        f"{stats['steps']} member steps, compiles {stats['compiles']} "
        f"(after warm {stats['compiles_after_warm']}); admission wait "
        + ", ".join(f"{q} {hists['admission_wait_s'][q]:.4f} s"
                    for q in ("p50", "p95", "p99"))
        + "; round wall by live lanes "
        + ", ".join(f"{live}: {np.median(d):.3f} s (n={len(d)})"
                    for live, d in sorted(by_live.items()))
        + f"; a stream request {np.median(stream_s) * 1e3:.2f} ms median "
        f"in-process; frame_stream_s p50 "
        f"{hists['frame_stream_s']['p50'] * 1e3:.3f} ms")
    events = list(srv.tracer.events)
    srv.journal.close()
    summary = {"buckets": caps, "lanes": lanes, "warmup_s": warm,
               "build_s": build_s, "wall_s": wall, "ticks": len(ticks),
               "tick_walls": ticks, "rounds": rounds,
               "round_wall_by_live": {str(k): v for k, v in by_live.items()},
               "admission_wait_s": hists["admission_wait_s"],
               "round_wall_s": hists["round_wall_s_hist"],
               "frame_stream_s": hists["frame_stream_s"],
               "stream_request_s": stream_s,
               "submit_s": [r["submit_s"] for r in resp],
               "reseats": reseats, "admitted": stats["admitted"],
               "compiles": stats["compiles"],
               "compiles_after_warm": stats["compiles_after_warm"],
               "solo_dx": solo}
    shutil.rmtree(run_dir)
    return counts, summary, events


def serve_unroll(torch, ck, device, work, args):
    """18b: an "unroll" server of SERVE_UNROLL_LANES lanes takes two
    free-space tenants of --ensemble-bound bent fibers; each streams the
    bits of its sequential `System.run` on the card; a third tenant
    snapshotted after two rounds, cancelled and resubmitted from its
    snapshot streams the uninterrupted run's bits. Returns (launch counts,
    summary)."""
    from skellysim_tpu_torch.builder import build_simulation
    from skellysim_tpu_torch.config import schema
    from skellysim_tpu_torch.io.trajectory import frame_bytes
    from skellysim_tpu_torch.serve.server import SimulationServer

    def seq_frames(cfg):
        system, state, rng = build_simulation(cfg, device=device.type)
        rs = rng.dump_state()
        frames = [frame_bytes(state, rng_state=rs)]
        system.run(state, writer=lambda st, sol, **kw: frames.append(
            frame_bytes(st, rng_state=rs)))
        return frames

    def stream(srv, tid):
        return [bytes(f) for f in srv.handle_request(
            {"type": "stream", "tenant": tid})["frames"]]

    n = args.ensemble_bound
    cfgs = [make_free_tenant_config(n, seed=7000 + i) for i in range(3)]
    t0 = time.perf_counter()
    srv = SimulationServer(cfgs[0], device=device.type,
                           serve_cfg=schema.ServeConfig(
                               max_lanes=SERVE_UNROLL_LANES,
                               batch_impl="unroll"))
    build_s = time.perf_counter() - t0
    reset_counts(ck)
    t0 = time.perf_counter()
    tids = [srv.handle_request({"type": "submit",
                                "config": tenant_toml(c)})["tenant"]
            for c in cfgs[:2]]
    drain_server(srv)
    wall = time.perf_counter() - t0
    counts = read_counts(ck)
    same = []
    for tid, cfg in zip(tids, cfgs):
        got, ref = stream(srv, tid), seq_frames(cfg)
        same.append(got == ref)
        if got != ref:
            raise SystemExit(f"serve: the \"unroll\" tenant {tid} streams "
                             f"{len(got)} frames, not the {len(ref)} of its "
                             "sequential System.run bit for bit")
    r = srv.handle_request({"type": "submit", "config": tenant_toml(cfgs[2])})
    srv.tick()
    srv.tick()
    snap = srv.handle_request({"type": "snapshot", "tenant": r["tenant"]})
    srv.handle_request({"type": "cancel", "tenant": r["tenant"]})
    pre = stream(srv, r["tenant"])
    r2 = srv.handle_request({"type": "submit", "config": tenant_toml(cfgs[2]),
                             "resume_frame": bytes(snap["frame"])})
    if not (snap["ok"] and r2["ok"]):
        raise SystemExit(f"serve: snapshot / resume refused: {snap} {r2}")
    drain_server(srv)
    if pre + stream(srv, r2["tenant"]) != seq_frames(cfgs[2]):
        raise SystemExit("serve: snapshot, evict and resume is not the "
                         "uninterrupted run bit for bit")
    stats = srv.handle_request({"type": "stats"})["stats"]
    if stats["compiles_after_warm"]:
        raise SystemExit(f"serve: {stats['compiles_after_warm']} compiles "
                         "after warm in the \"unroll\" server")
    if device.type == "cuda" and not (counts["stokeslet_f32"]
                                      and counts["stokeslet_f64"]):
        raise SystemExit(f"serve: the \"unroll\" lanes launched {counts}")
    log(f"[serve] unroll server ({SERVE_UNROLL_LANES} lanes, built in "
        f"{build_s:.2f} s): 2 tenants of {n} bent {ENS_FIBER_NODES}-node "
        f"fibers in {wall:.2f} s, each its sequential System.run bit for "
        f"bit; snapshot at round 2, cancel and resume: the uninterrupted "
        f"run's bits; launches {counts}")
    return counts, {"build_s": build_s, "wall_s": wall, "same_bits": same,
                    "resume_same_bits": True}


def serve_chaos(work, device):
    """18c: the chaos smoke (`guard.smoke.main`) over TCP against servers
    it spawns on ``device``: a NaN-poisoned tenant quarantined while its
    sibling finishes, then SIGKILL mid-flight and recovery from the
    journal. Gated on its exit code 0; it prints each request type's
    round trips."""
    from skellysim_tpu_torch.guard import smoke

    t0 = time.perf_counter()
    rc = smoke.main(os.path.join(work, "chaos"), device=device.type)
    if rc != 0:
        raise SystemExit(f"serve: the chaos smoke exited {rc}")
    wall = time.perf_counter() - t0
    log(f"[serve] chaos smoke passed in {wall:.1f} s")
    return {"wall_s": wall}


def count_syncs(torch, fn):
    """Host syncs `fn()` makes under `torch.cuda.set_sync_debug_mode`
    ("warn"), as `matvec_syncs` counts them."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def serve_tracer(torch, ck, device, ring_inputs, work, serve_events):
    """18d: one step of phase 6's config (its first state) by `System.run`
    with no tracer active against the same step with the instrumentation
    stubbed out (the loop as it was before the tracer), in turns (A B B
    A) after a first counted step: the same host syncs, counted as
    `matvec_syncs` counts them. Then the step with a
    tracer writing a file, the kernel libraries dropped first so it loads
    them: the trace holds the step span and the compile events, and
    `obs.summarize` of it with 18a's server events renders the lanes table
    and the admission wait."""
    import contextlib

    from skellysim_tpu_torch.obs import summarize
    from skellysim_tpu_torch.obs import tracer as obs_tracer
    from skellysim_tpu_torch.system import System

    params, shape = ring_inputs["system_args"]
    system = System(params, shell_shape=shape, device=device)
    state = ring_inputs["state"]

    def step():
        system.run(state, max_steps=1)
        torch.cuda.synchronize(device)

    def stubbed():
        saved = (obs_tracer.span, obs_tracer.emit, obs_tracer.active)
        obs_tracer.span = lambda *a, **k: contextlib.nullcontext(
            obs_tracer._Span())
        obs_tracer.emit = lambda *a, **k: None
        obs_tracer.active = lambda: None
        try:
            step()
        finally:
            obs_tracer.span, obs_tracer.emit, obs_tracer.active = saved

    # a first counted step, not gated: torch's first call under the debug
    # mode adds one sync of its own (torch/cuda/__init__.py)
    first = count_syncs(torch, step)
    counts = {"inactive": [], "uninstrumented": []}
    for name, fn in (("inactive", step), ("uninstrumented", stubbed),
                     ("uninstrumented", stubbed), ("inactive", step)):
        counts[name].append(count_syncs(torch, fn))
    inactive, stubbed_n = counts["inactive"], counts["uninstrumented"]
    if len(set(inactive + stubbed_n)) != 1:
        raise SystemExit(f"serve: host syncs of a step with the tracer "
                         f"inactive {inactive}, uninstrumented {stubbed_n}")
    trace = os.path.join(work, "trace.jsonl")
    for src in (ck.STOKESLET_SOURCE, ck.STRESSLET_SOURCE):
        ck._libs.pop(src, None)
    t0 = time.perf_counter()
    system.run(state, max_steps=1, trace_path=trace)
    traced_s = time.perf_counter() - t0
    events = [json.loads(line) for line in open(trace)]
    spans = [e["name"] for e in events if e["ev"] == "span"]
    compiles = [e["name"] for e in events if e["ev"] == "compile"]
    s = summarize.Summary()
    s.add_file(trace)
    for e in serve_events:
        s.add_line(json.dumps(e))
    report = s.render()
    if (spans != ["step", "run"] or not compiles
            or "== ensemble lanes ==" not in report
            or "admission wait:" not in report):
        raise SystemExit(f"serve: the trace holds spans {spans}, compiles "
                         f"{compiles}; report:\n{report}")
    log(f"[serve] tracer: a phase-6 step makes {inactive} host syncs "
        f"with no tracer active and {stubbed_n} with the instrumentation "
        f"stubbed out, in turns (the first counted step {first}); traced "
        f"({traced_s:.2f} s): spans {spans}, compile events {compiles}; "
        "summarize renders the lanes table and the admission wait")
    os.remove(trace)
    return {"syncs_inactive": inactive, "syncs_uninstrumented": stubbed_n,
            "syncs_first_counted": first, "traced_step_s": traced_s,
            "compile_events": compiles}


def phase_serve(torch, ck, device, ring_inputs, work, args, card):
    """Phase 18: the service, 18a (`serve_vmap`), 18b (`serve_unroll`),
    18c (`serve_chaos`) and 18d (`serve_tracer`, the card only: it counts
    CUDA syncs). Returns (summary, launch counts by run)."""
    out, launches = {}, {}
    launches["serve_vmap"], out["vmap"], events = serve_vmap(
        torch, ck, device, work, args, card)
    stamp("phase 18a")
    launches["serve_unroll"], out["unroll"] = serve_unroll(
        torch, ck, device, work, args)
    stamp("phase 18b")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["chaos"] = serve_chaos(work, device)
    stamp("phase 18c")
    if device.type == "cuda":
        out["tracer"] = serve_tracer(torch, ck, device, ring_inputs, work,
                                     events)
    return out, launches


# ------------------------------------------------------- 19. cost, roofline

#: 19a's gate on a program's counted bytes against its CPU baseline (%)
BYTES_DRIFT_PCT = 1.0


def cost_check(torch, device):
    """19a: `python -m skellysim_tpu_torch.obs cost --check` on ``device``
    (in this process, `run_obs`) against the checked-in baselines, which
    were counted on the CPU: exit 0 (every gated metric within its
    tol_pct), every program's pair-seam totals equal to the baseline's
    ``[pair_seam]`` exactly, its flops the baseline's and its bytes within
    `BYTES_DRIFT_PCT`. Prints each program's counts and drifts, and
    on the card `torch.cuda.max_memory_allocated` beside the counted
    temp_bytes (not gated). Returns the summary."""
    from skellysim_tpu_torch.config import toml_io
    from skellysim_tpu_torch.obs import cost

    if FLOPS_PER_PAIR != cost.PAIR_FLOPS:
        raise SystemExit(f"19a: the bound column's flops a pair "
                         f"{FLOPS_PER_PAIR} differ from the pair seam's "
                         f"{cost.PAIR_FLOPS}")
    t0 = time.perf_counter()
    rc, text = run_obs(["cost", "--check", "--json",
                        f"--device={device.type}"])
    run_s = time.perf_counter() - t0
    docs = [json.loads(line) for line in text.splitlines()
            if line.startswith('{"device"')]
    if rc != 0 or len(docs) != 1:
        log(text[-6000:])
        raise SystemExit(f"19a: obs cost --check exited {rc}")
    out = {"run_s": run_s, "device": docs[0]["device"], "programs": {}}
    bad = []
    for row in docs[0]["rows"]:
        base = toml_io.load(cost.baseline_path(row["name"]))
        drift = {k: 100.0 * (row[k] - base["cost"][k])
                 / max(abs(base["cost"][k]), 1.0) for k in cost.COST_KEYS}
        seam = {k: row[k] for k in cost.PAIR_KEYS}
        out["programs"][row["name"]] = dict(
            {k: row.get(k) for k in (*cost.COST_KEYS, *cost.PAIR_KEYS,
                                     "ops", "run_s",
                                     "device_max_allocated")},
            drift_pct=drift, pair_seam_equal=seam == base["pair_seam"])
        log(f"[cost] {row['name']:<20} flops {row['flops']:.6e} "
            f"({drift['flops']:+.3f}% of the CPU's), bytes "
            f"{row['bytes_accessed']:.6e} ({drift['bytes_accessed']:+.3f}%),"
            f" pairs {row['pairs']} (CPU {base['pair_seam']['pairs']}), "
            f"temp {row['temp_bytes']} B ({drift['temp_bytes']:+.3f}%), "
            f"max_memory_allocated {row.get('device_max_allocated')} B, "
            f"{row['ops']} ops, {row['run_s']} s")
        if seam != base["pair_seam"]:
            bad.append((row["name"], seam, base["pair_seam"]))
        # the count is the work, not the backend's: flops the CPU's, bytes
        # within 1% (copies between devices count 0 on both)
        if (abs(drift["flops"]) > 1e-7
                or abs(drift["bytes_accessed"]) > BYTES_DRIFT_PCT):
            bad.append((row["name"], "flops / bytes", drift))
    log(f"[cost] obs cost --check on {out['device']}: exit {rc}, "
        f"{len(docs[0]['rows'])} programs in {run_s:.1f} s (the baselines "
        "are the CPU's)")
    if bad:
        raise SystemExit(f"19a: pair-seam totals, flops or bytes differ "
                         f"from the CPU's: {bad}")
    return out


def counted_roofline(torch, device, prof, tag):
    """19b: the profiled CLI run ``prof`` (`profile_cli` with ``keep``)
    again in this process, its loop under `obs.cost.CostCounter` (the
    build outside it, as outside the profiler's window): gated on the
    profiled run's frames bit for bit and its iterations step by step.
    Its counts go into a ``--cost-table`` sidecar, and `obs roofline` rates
    the profiled dump with it (``--executions 1``): gated on the exit
    code, the "H100" row, one device lane and a window MFU in (0, 1).
    Prints the per-phase table, rated_as, totals.mfu and hbm_util."""
    import numpy as np

    from skellysim_tpu_torch.builder import build_simulation
    from skellysim_tpu_torch.config import toml_io
    from skellysim_tpu_torch.config.schema import load_runtime_config
    from skellysim_tpu_torch.io.trajectory import TrajectoryWriter
    from skellysim_tpu_torch.obs import cost
    from skellysim_tpu_torch.system import buckets

    cfg, run_dir = prof["cfg"], prof["run_dir"]
    here = os.path.join(run_dir, "counted")
    os.makedirs(here)
    traj = os.path.join(here, "skelly_sim.out")
    metrics = os.path.join(here, "metrics.jsonl")
    t0 = time.perf_counter()
    system, state, rng = build_simulation(cfg, device=device)
    policy = buckets.BucketPolicy.from_runtime(load_runtime_config(cfg))
    system.grid_ladder = policy.grid_ladder
    state, _ = buckets.bucketize(
        state, policy, pair_evaluator=system.params.pair_evaluator)
    build_s = time.perf_counter() - t0
    writer = TrajectoryWriter(traj)
    writer.write_frame(state, rng_state=rng.dump_state())
    arg_b = cost.storage_bytes(state)
    on_card = device.type == "cuda"
    with writer:
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with cost.CostCounter() as counter:
            counter.exclude(state)
            final = system.run(state, writer=writer.write_frame, rng=rng,
                               metrics_path=metrics)
        if on_card:
            torch.cuda.synchronize(device)
        counted_s = time.perf_counter() - t0
    dx = frames_equal(np, os.path.join(run_dir, "skelly_sim.out"), traj,
                      prof["steps"] + 1)
    iters = [json.loads(line)["iters"] for line in open(metrics)]
    ref_iters = [json.loads(line)["iters"] for line in open(prof["metrics"])]
    log(f"[{tag}] the profiled run's {prof['steps']} steps again in this "
        f"process under the cost counter: built in {build_s:.1f} s, "
        f"counted loop {counted_s:.2f} s (profiled loop "
        f"{prof['loop_s']:.3f} s); iterations {iters} (profiled "
        f"{ref_iters}); frames max |difference| {dx:.3e}")
    if dx != 0.0 or iters != ref_iters:
        raise SystemExit(f"{tag}: the counted run is not the profiled "
                         f"run's (frames {dx:.3e}, iterations {iters} "
                         f"against {ref_iters})")
    out_b = cost.storage_bytes(final)
    table = {"flops": counter.flops, "bytes_accessed": counter.bytes_accessed,
             "argument_bytes": arg_b, "output_bytes": out_b,
             "temp_bytes": counter.temp_bytes,
             "peak_bytes": arg_b + out_b + counter.temp_bytes}
    data = {"program": {"name": tag}, "cost": table,
            "pair_seam": {"pairs": counter.pairs,
                          "pair_flops": counter.pair_flops,
                          "pair_bytes": counter.pair_bytes}}
    if counter.collectives:
        data["collectives"] = {k: {"max_bytes": int(v)} for k, v
                               in sorted(counter.collectives.items())}
    sidecar = os.path.join(run_dir, "cost_table.toml")
    toml_io.dump(data, sidecar)
    log(f"[{tag}] counted: {counter.flops:.6e} flops "
        f"({counter.pair_flops:.6e} in the pair seams: "
        + ", ".join(f"{k} {v['calls']} sums, {v['pairs']} pairs"
                    for k, v in sorted(counter.seams.items()))
        + f"), {counter.bytes_accessed:.6e} bytes, {counter.ops} aten ops "
        f"counted, temp {counter.temp_bytes} B")
    argv = ["roofline", prof["dump"], "--cost-table", sidecar,
            "--executions", "1"]
    t0 = time.perf_counter()
    rc, text = run_obs(argv)
    rc_json, js = run_obs(argv + ["--json"])
    roof_s = time.perf_counter() - t0
    for line in text.rstrip().splitlines():
        log(f"[{tag}] roofline | {line}")
    if rc != 0 or rc_json != 0:
        raise SystemExit(f"{tag}: obs roofline exited {rc} / {rc_json}")
    doc = json.loads(js)
    tot = doc["totals"]
    log(f"[{tag}] rated_as {doc['rated_as']!r} ({doc['device_kind']}), "
        f"{doc['n_devices']} lane(s): totals.mfu {tot['mfu']}, hbm_util "
        f"{tot['hbm_util']}, intensity {doc['ai']} flop/B (ridge "
        f"{doc['ridge_flops_per_byte']}), achieved "
        f"{tot['achieved_flops_per_s']} flop/s over "
        f"{doc['total_us'] / 1e3:.3f} ms of device time; both roofline "
        f"commands {roof_s:.1f} s")
    verdicts = {p["phase"]: p["verdict"] for p in doc["phases"]}
    if on_card and (doc["rated_as"] != "H100" or doc["n_devices"] != 1
                    or not (tot["mfu"] is not None
                            and 0.0 < tot["mfu"] < 1.0)):
        raise SystemExit(f"{tag}: roofline rated {doc['rated_as']!r} on "
                         f"{doc['n_devices']} lanes, mfu {tot['mfu']}")
    return {"iters": iters, "build_s": build_s, "counted_s": counted_s,
            "cost": table, "pair_seam": data["pair_seam"],
            "seams": counter.seams, "ops": counter.ops,
            "rated_as": doc["rated_as"], "n_devices": doc["n_devices"],
            "ai": doc["ai"], "ridge": doc["ridge_flops_per_byte"],
            "total_us": doc["total_us"], "totals": tot,
            "verdicts": verdicts, "roofline_s": roof_s,
            "phases": [{k: p[k] for k in ("phase", "wall_us", "share",
                                          "verdict", "achieved_vs_peak")}
                       for p in doc["phases"]]}


def seam_syncs(torch, ck, device, ring_inputs):
    """19c: a step of phase 6's config (its first state) by `System.run`
    with no counter active, in turns (A B B A, after a first step not
    gated) with the same step with every pair seam's hook taken out (the
    seams' uncounted bodies in their place: each seam's ``uncounted``,
    `obs.cost.seamed`): the same host syncs
    (`count_syncs`). The step under a counter is counted too, not gated.
    Then each seam's inactive path under
    `torch.cuda.set_sync_debug_mode("error")`, once warm: A-D through the
    direct seam, A over a member axis and E through the ring, none
    raising."""
    import numpy as np

    from skellysim_tpu_torch.obs import cost
    from skellysim_tpu_torch.ops import kernels
    from skellysim_tpu_torch.parallel import make_mesh
    from skellysim_tpu_torch.parallel.ring import ring_stokeslet
    from skellysim_tpu_torch.system import System

    params, shape = ring_inputs["system_args"]
    system = System(params, shell_shape=shape, device=device)
    state = ring_inputs["state"]
    names = [w.__name__ for w in (*ck.KERNEL_WRAPPERS, *ck.MEMBER_WRAPPERS)]

    def step():
        system.run(state, max_steps=1)
        torch.cuda.synchronize(device)

    def unhooked():
        saved = (kernels._direct, {n: getattr(ck, n) for n in names})
        kernels._direct = kernels._direct.uncounted
        for n in names:
            setattr(ck, n, getattr(ck, n).uncounted)
        try:
            step()
        finally:
            kernels._direct = saved[0]
            for n, w in saved[1].items():
                setattr(ck, n, w)

    def counted():
        with cost.CostCounter():
            step()

    first = count_syncs(torch, step)
    counts = {"inactive": [], "unhooked": []}
    for name, fn in (("inactive", step), ("unhooked", unhooked),
                     ("unhooked", unhooked), ("inactive", step)):
        counts[name].append(count_syncs(torch, fn))
    under_counter = count_syncs(torch, counted)
    log(f"[cost] host syncs of a phase-6 step: {counts['inactive']} with no "
        f"counter active, {counts['unhooked']} with the seams' hooks taken "
        f"out, in turns (the first counted step {first}); under a counter "
        f"{under_counter} (not gated)")
    if len(set(counts["inactive"] + counts["unhooked"])) != 1:
        raise SystemExit(f"19c: host syncs {counts}")

    rng = np.random.default_rng(19)
    n = 4096

    def t(*shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device)

    src, trg, f, S = t(n, 3), t(n, 3), t(n, 3), t(n, 3, 3)
    src64, trg64, f64 = src.double(), trg.double(), f.double()
    mesh = make_mesh(RING_SHARDS, device=device)
    calls = [
        ("A", lambda: kernels.stokeslet_direct(src, trg, f, 1.0)),
        ("B", lambda: kernels.stokeslet_direct(src64, trg64, f64, 1.0)),
        ("C", lambda: kernels.stresslet_direct(src, trg, S, 1.0)),
        ("D", lambda: kernels.stresslet_direct(src, trg, S, 1.0,
                                               impl="pallas_df")),
        ("A batched", lambda: kernels.stokeslet_direct(
            src.view(4, n // 4, 3), trg.view(4, n // 4, 3),
            f.view(4, n // 4, 3), 1.0)),
        ("E", lambda: ring_stokeslet(src, trg, f, 1.0, mesh=mesh,
                                     impl="pallas"))]
    before = read_counts(ck)
    for _, fn in calls:
        fn()                      # warm: plans, libraries, casts' inputs
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _, fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(device)
    after = read_counts(ck)
    launched = {k: after[k] - before[k] for k in after if after[k] - before[k]}
    log(f"[cost] {', '.join(c for c, _ in calls)} through their seams with no"
        f" counter under set_sync_debug_mode(\"error\"): no sync raised; "
        f"launches {launched}")
    for name in ("stokeslet_f32", "stokeslet_f64", "stresslet_f32",
                 "stresslet_f64", "stokeslet_f32_batched",
                 "ring_stokeslet_f32"):
        if not launched.get(name):
            raise SystemExit(f"19c: {name} did not launch")
    return {"syncs_inactive": counts["inactive"],
            "syncs_unhooked": counts["unhooked"],
            "syncs_first": first, "syncs_under_counter": under_counter,
            "error_mode_calls": [c for c, _ in calls], "launches": launched}


def phase_cost_roofline(torch, ck, device, ring_inputs, tree):
    """Phase 19: 19a (`cost_check`) on the device; on the card 19b
    (`counted_roofline`) over phase 6's and 12d's profiled runs and 19c
    (`seam_syncs`). Returns the summary."""
    out = {"cost_check": cost_check(torch, device)}
    stamp("phase 19a")
    if device.type != "cuda":
        log("[cost] 19b-c not measured (CPU rehearsal: no profiled dump, no "
            "CUDA syncs)")
        return out
    out["ellipsoid"] = counted_roofline(torch, device,
                                        ring_inputs["profiled"], "profile")
    out["tree"] = counted_roofline(
        torch, device, tree["tree_ellipsoid"]["profiled"], "tree_profile")
    stamp("phase 19b")
    out["syncs"] = seam_syncs(torch, ck, device, ring_inputs)
    return out


# ------------------------------------------------------------- 20. audit

def run_audit(argv):
    """``python -m skellysim_tpu_torch.audit ARGV`` in this process:
    (exit code, standard output)."""
    import contextlib
    import io

    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["skellysim_tpu_torch.audit", *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module("skellysim_tpu_torch.audit", run_name="__main__",
                             alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        sys.argv = saved
    return rc, out.getvalue()


def audit_syncs(torch, device):
    """20a's second half: each registered program's observed run against
    the same call on a fresh build (its dead slots made the same way,
    after a warm run) under the sync debug mode. Returns {program:
    {"observer", "debug", "kinds"}}; raises on the first that differs."""
    from skellysim_tpu_torch.audit import maskflow
    from skellysim_tpu_torch.audit.engine import ProgramRun, load_contract
    from skellysim_tpu_torch.audit.programs import all_programs

    count_syncs(torch, lambda: None)     # the debug mode's first use
    rows, bad = {}, []
    for prog in all_programs():
        contract, _ = load_contract(prog.name)
        run = ProgramRun(prog, device, contract)
        torch.cuda.synchronize(device)
        built = prog.build(device)
        args = maskflow.with_dead_slots(built.args, run.axes)
        torch.cuda.synchronize(device)
        debug = count_syncs(torch, lambda: built.fn(*args, **built.kwargs))
        obs = run.observation
        rows[prog.name] = {"observer": obs.syncs, "debug": debug,
                           "kinds": obs.sync_events()}
        log(f"[audit] {prog.name:<20} host syncs: observer {obs.syncs:>3}, "
            f"set_sync_debug_mode {debug:>3}  {obs.sync_events()}")
        if obs.syncs != debug:
            bad.append(prog.name)
    if bad:
        raise SystemExit(f"20a: the observer's host syncs differ from the "
                         f"sync debug mode's for {bad}")
    return rows


def audit_masks(device):
    """20b: the mask check's poisoned runs of the padded programs on
    ``device``: no finding (every live output the clean run's bits)."""
    from skellysim_tpu_torch.audit import maskflow
    from skellysim_tpu_torch.audit.engine import ProgramRun, load_contract
    from skellysim_tpu_torch.audit.programs import all_programs

    out = {}
    for prog in all_programs():
        contract, _ = load_contract(prog.name)
        if not contract["mask"].get("axes"):
            continue
        run = ProgramRun(prog, device, contract)
        report = maskflow.analyze(run)
        classes = {}
        for cls in report.observed.values():
            classes[cls] = classes.get(cls, 0) + 1
        pinned = contract["mask"]["outputs"]
        out[prog.name] = {"classes": classes, "findings": report.findings,
                          "pins_equal": report.observed == pinned}
        log(f"[audit] {prog.name:<20} poisoned dead slots (nan, +/-inf): "
            f"{classes}, {len(report.findings)} finding(s), pins "
            f"{'equal' if report.observed == pinned else 'DIFFER'}")
        if report.findings or report.observed != pinned:
            raise SystemExit(f"20b: {prog.name}: {report.findings[:3]}")
    return out


def audit_dma(torch, device):
    """20c: the dma check on A-H (`audit.dmaflow`): the resource table,
    the repeats and the plain-version gates; each family's contract
    clean. Returns {family: {"rows", "errors", "observed"}}."""
    from skellysim_tpu_torch.audit import dmaflow
    from skellysim_tpu_torch.audit.engine import run_kernel_audit
    from skellysim_tpu_torch.audit.kernels import all_kernels

    out = {}
    for kern in all_kernels():
        t0 = time.perf_counter()
        rep = dmaflow.analyze(kern.build(device))
        findings = run_kernel_audit(kern, checks=["dma"], device=device)
        for row in rep.table:
            log(f"[audit] dma {kern.kernels:<5} {row['case']:<22} "
                f"{row['function']:<44} {row['registers']:>3} registers, "
                f"{row['smem_static']:>6} + {row['smem_dynamic']:>6} shared "
                f"bytes, {row['spill_bytes']} spilled")
        log(f"[audit] dma {kern.name}: {dmaflow.REPEATS} launches a case "
            f"the same bits; from the plain version "
            + ", ".join(f"{k} {v:.3e}" for k, v in rep.errors.items())
            + f"; the card's per-block limit {rep.smem_limit} bytes; "
            f"{time.perf_counter() - t0:.1f} s")
        out[kern.name] = {"kernels": kern.kernels, "rows": rep.table,
                          "errors": rep.errors, "observed": rep.observed}
        if rep.findings or findings:
            raise SystemExit(f"20c: {kern.name}: {rep.findings or findings}")
    return out


def phase_audit(torch, device, smi):
    """Phase 20: 20a (the auditor's CLI, then the observer's host syncs
    against the sync debug mode's), 20b (`audit_masks`), 20c
    (`audit_dma`, the card only). Returns the summary."""
    t0 = time.perf_counter()
    rc, text = run_audit([f"--device={device.type}"])
    cli_s = time.perf_counter() - t0
    for line in text.rstrip().splitlines():
        log(f"[audit] cli | {line}")
    if rc != 0:
        raise SystemExit(f"20a: python -m skellysim_tpu_torch.audit exited "
                         f"{rc}")
    out = {"cli_rc": rc, "cli_s": cli_s}
    if device.type == "cuda":
        out["syncs"] = audit_syncs(torch, device)
    else:
        log("[audit] 20a's sync comparison not run (CPU rehearsal: no CUDA "
            "syncs)")
    stamp("phase 20a")
    out["masks"] = audit_masks(device)
    stamp("phase 20b")
    if device.type == "cuda":
        out["dma"] = audit_dma(torch, device)
    else:
        log("[audit] 20c not run (CPU rehearsal: dma launches A-H)")
    out["phase_s"] = time.perf_counter() - t0
    log(f"[audit] phase 20: {out['phase_s']:.1f} s (CLI {cli_s:.1f} s) on "
        f"{smi or 'the CPU'}")
    return out


# ----------------------------------------------- 21. the rest of the surface

#: phase 21a: each encode and scan timed this many times (the median kept)
SURFACE_REPEATS = 3
#: 21c: the Morton-sorted fibers' flow against the unsorted flow (A's f32
#: sums taken in another order)
MORTON_GATE = 1e-5
#: 21d: the Chebyshev fiber's run (tests/test_chebyshev_fiber.py's), card
#: against CPU
CHEB_N, CHEB_STEPS, CHEB_DT = 20, 20, 5e-3
CHEB_GATE = 1e-10
def median_s(fn, reps=SURFACE_REPEATS):
    """(median wall seconds of ``reps`` calls of ``fn``, its last result)."""
    times, res = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], res


def surface_state(torch, device, traj):
    """The last frame of ``traj`` as a fibers-only f64 state on
    ``device``."""
    import numpy as np

    from skellysim_tpu_torch.fibers import container as fc
    from skellysim_tpu_torch.io.trajectory import (TrajectoryReader,
                                                   frame_to_state)
    from skellysim_tpu_torch.system import SimState

    with TrajectoryReader(traj) as reader:
        frame = reader.load_frame(len(reader) - 1)
    n = int(frame["fibers"][1][0]["n_nodes_"])
    template = SimState(time=0.0, dt=0.0, fibers=fc.make_group(
        np.zeros((1, n, 3)), 1.0, 0.01, 0.0125, dtype=torch.float64,
        device=device))
    return frame_to_state(frame, template)


def surface_natives(torch, device, state, traj, step_s, out):
    """21a: `frame_bytes` of phase 4's last state (on the card), native
    against numpy, and `build_index` of its trajectory, native against
    Python: host seconds and the same bytes / offsets; both libraries built
    into skellysim_tpu_torch/_build/ and loaded."""
    from pathlib import Path
    from unittest import mock

    from skellysim_tpu_torch.io import trajectory as tt
    from skellysim_tpu_torch.native import build as nbuild

    g = state.fibers
    enc_nat_s, raw_nat = median_s(lambda: tt.frame_bytes(state))
    with mock.patch.object(tt, "_fiber_array_bytes_native", lambda g: None):
        enc_py_s, raw_py = median_s(lambda: tt.frame_bytes(state))
    idx_nat_s, idx_nat = median_s(lambda: tt.build_index(traj))
    idx_py_s, idx_py = median_s(lambda: tt.build_index(traj,
                                                       use_native=False))
    libs = {}
    for name in ("frameenc", "trajscan"):
        path = nbuild.library_path(name)
        lib = nbuild._CACHE.get(name)
        libs[name] = os.path.relpath(path, REPO)
        if not (lib is not None and lib._name == str(path) and path.exists()
                and path.parent == Path(REPO, "skellysim_tpu_torch",
                                        "_build")):
            raise SystemExit(f"21a: native/{name}.cpp was not built into "
                             f"skellysim_tpu_torch/_build/ and loaded: {path}")
    out["natives"] = {
        "fibers": g.n_fibers, "nodes": g.n_nodes, "frame_bytes": len(raw_nat),
        "encode_native_ms": 1e3 * enc_nat_s, "encode_numpy_ms": 1e3 * enc_py_s,
        "trajectory_bytes": os.path.getsize(traj), "frames": len(idx_nat[0]),
        "index_native_ms": 1e3 * idx_nat_s, "index_python_ms": 1e3 * idx_py_s,
        "step_wall_s": step_s, "libraries": libs}
    log(f"[surface] 21a {g.n_fibers} x {g.n_nodes}-node state on "
        f"{device.type}: frame_bytes {len(raw_nat)} bytes, native "
        f"{1e3 * enc_nat_s:.1f} ms against numpy {1e3 * enc_py_s:.1f} ms "
        f"(median of {SURFACE_REPEATS}; the host copies of the fields "
        f"included); build_index over the {os.path.getsize(traj)}-byte "
        f"trajectory ({len(idx_nat[0])} frames): native "
        f"{1e3 * idx_nat_s:.1f} ms against Python {1e3 * idx_py_s:.1f} ms; "
        f"phase 4's step {step_s:.3f} s; libraries {libs}")
    if raw_nat != raw_py:
        raise SystemExit("21a: the native frame bytes differ from numpy's")
    if idx_nat != idx_py:
        raise SystemExit(f"21a: the native index differs: {idx_nat} "
                         f"against {idx_py}")


def paraview_utility():
    """The port's `paraview_utils/trajectory_utility.py` exec'd standalone,
    as ParaView runs it (it imports `msgpack` and nothing of the repo)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trajectory_utility", os.path.join(
            REPO, "skellysim_tpu_torch", "paraview_utils",
            "trajectory_utility.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def surface_paraview(torch, device, work, field, traj6, out):
    """21b: phase 17b's velocity field written by `FieldWriter` (card
    tensors) and read back by the port's `trajectory_utility`
    (`load_field_frame`): the field's values exactly; phase 6's frames
    through `get_frame_info` / `load_frame` equal to `TrajectoryReader`'s."""
    import numpy as np

    from skellysim_tpu_torch.io.trajectory import (FieldWriter,
                                                   TrajectoryReader)

    pts, vel, t_frame = field
    path = os.path.join(work, "skelly_sim.vf")
    t0 = time.perf_counter()
    with FieldWriter(path) as fw:
        fw.write_frame(t_frame, pts, vel)
    write_s = time.perf_counter() - t0
    util = paraview_utility()
    t0 = time.perf_counter()
    fhs, fpos, times = util.get_frame_info([path])
    got = util.load_field_frame(fhs, fpos, 0)[0]
    read_s = time.perf_counter() - t0
    for fh in fhs:
        fh.close()
    n = pts.shape[0]
    same = (times == [t_frame] and got["x_grid"][:3] == ["__eigen__", 3, n]
            and got["v_grid"][:3] == ["__eigen__", 3, n]
            and np.array_equal(np.asarray(got["x_grid"][3:]),
                               pts.cpu().numpy().astype(np.float64).ravel())
            and np.array_equal(np.asarray(got["v_grid"][3:]),
                               vel.cpu().numpy().astype(np.float64).ravel()))

    fhs, fpos, times6 = util.get_frame_info([traj6])
    with TrajectoryReader(traj6) as reader:
        same6 = times6 == reader.times and len(times6) > 0
        for i in range(len(times6)):
            a, b = util.load_frame(fhs, fpos, i), reader.load_frame(i)
            same6 &= (a["time"] == b["time"] and a["dt"] == b["dt"]
                      and len(a["fibers"]) == len(b["fibers"][1])
                      and all(np.array_equal(np.asarray(fa["x_"][3:]),
                                             fb["x_"].ravel())
                              for fa, fb in zip(a["fibers"],
                                                b["fibers"][1]))
                      and np.array_equal(
                          np.asarray(a["shell"]["solution_vec_"][3:]),
                          b["shell"]["solution_vec_"].ravel())
                      and len(a["bodies"]) == sum(map(len, b["bodies"])))
    for fh in fhs:
        fh.close()
    out["paraview"] = {"field_points": n, "field_bytes": os.path.getsize(path),
                       "write_s": write_s, "read_s": read_s,
                       "field_equal": bool(same), "phase6_frames": len(times6),
                       "phase6_equal": bool(same6)}
    log(f"[surface] 21b phase 17b's field at {n} points through FieldWriter "
        f"({os.path.getsize(path)} bytes) in {write_s:.3f} s, read back by "
        f"paraview_utils/trajectory_utility.py (standalone) in "
        f"{read_s:.3f} s: equal "
        f"{same}; phase 6's {len(times6)} frames through get_frame_info / "
        f"load_frame against TrajectoryReader: equal {same6}")
    os.remove(path)
    if not (same and same6):
        raise SystemExit(f"21b: the ParaView reader disagrees: "
                         f"{out['paraview']}")


def surface_flow(torch, ck, device, state, out):
    """21c: `container.flow` of phase 4's last state in f32 (kernel A on the
    card) against `flow_multi`'s bits, and the pair sums of the
    Morton-sorted fibers (`sort_fibers_morton`) against the unsorted ones.
    Returns the flow's launch counts."""
    import numpy as np

    from skellysim_tpu_torch.fibers import container as fc

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    g = state.fibers
    g = type(g)(*[v.float() if torch.is_tensor(v) and v.is_floating_point()
                  else v for v in g])
    nf = g.n_fibers
    caches = fc.update_cache(g, T_FINAL, 1.0)
    forces = torch.as_tensor(np.random.default_rng(21).standard_normal(
        tuple(g.x.shape)), dtype=torch.float32, device=device)
    trg = fc.node_positions(g)
    sync()
    reset_counts(ck)
    t0 = time.perf_counter()
    v = fc.flow(g, caches, trg, forces, 1.0)
    sync()
    flow_s = time.perf_counter() - t0
    counts = read_counts(ck)
    same = torch.equal(v, fc.flow_multi((g,), (caches,), trg, (forces,),
                                        1.0))
    t0 = time.perf_counter()
    gs = fc.sort_fibers_morton(g)
    sync()
    sort_s = time.perf_counter() - t0
    order = gs.config_rank.long()
    cs = type(caches)(*[c[order] if torch.is_tensor(c) and c.shape[:1] == (nf,)
                        else c for c in caches])
    # the pair sums alone (no self block subtracted, whose cancellation
    # would scale A's roundoff by the near field's size), sorted and not
    vp = fc.flow(g, caches, trg, forces, 1.0, subtract_self=False)
    vs = fc.flow(gs, cs, fc.node_positions(gs), forces[order], 1.0,
                 subtract_self=False)
    back = torch.empty_like(vp).reshape(nf, -1, 3)
    back[order] = vs.reshape(nf, -1, 3)
    rel = float((back.reshape(-1, 3) - vp).abs().max() / vp.abs().max())
    moved = int((order != torch.arange(nf, device=device)).sum())
    out["flow"] = {"fibers": nf, "nodes": g.n_nodes, "flow_s": flow_s,
                   "equal_to_flow_multi": bool(same), "sort_s": sort_s,
                   "sorted_moved": moved, "sorted_rel": rel,
                   "gate": MORTON_GATE,
                   "launches": {k: c for k, c in counts.items() if c}}
    log(f"[surface] 21c container.flow of phase 4's last state in f32 "
        f"({nf} x {g.n_nodes} nodes, self subtracted): {flow_s:.3f} s, "
        f"launches {out['flow']['launches']}, flow_multi's bits: {same}; "
        f"sort_fibers_morton {sort_s:.3f} s moved {moved} fibers; the pair "
        f"sums (no self block subtracted) of the sorted fibers against the "
        f"unsorted max |dv| / max |v| = {rel:.3e} (gate {MORTON_GATE})")
    if not (same and rel <= MORTON_GATE and moved > 0):
        raise SystemExit(f"21c: container.flow failed: {out['flow']}")
    if device.type == "cuda" and not counts["stokeslet_f32"]:
        raise SystemExit(f"21c: kernel A did not launch: {counts}")
    if any(counts[w.__name__] for w in ck.YARDSTICK_WRAPPERS):
        raise SystemExit(f"21c: a yardstick kernel launched: {counts}")
    return counts


def surface_chebyshev(torch, device, out):
    """21d: the Chebyshev penalty fiber's evolve on the device against the
    same run on the CPU."""
    from skellysim_tpu_torch.fibers import chebyshev_fiber as cf

    def run(dev):
        solver, XX = cf.setup_solver_initialstate(CHEB_N, 1.0, device=dev)
        t0 = time.perf_counter()
        final, errs = cf.evolve(solver, XX, L=1.0, zeta=1.0, dt=CHEB_DT,
                                n_steps=CHEB_STEPS)
        final, errs = final.cpu(), errs.cpu()
        return time.perf_counter() - t0, final, errs

    dev_s, final, errs = run(device)
    cpu_s, final_c, errs_c = run("cpu")
    rel = max(float((final - final_c).abs().max() / final_c.abs().max()),
              float((errs - errs_c).abs().max() / errs_c.abs().max()))
    out["chebyshev"] = {"n": CHEB_N, "steps": CHEB_STEPS, "device_s": dev_s,
                        "cpu_s": cpu_s, "rel": rel, "gate": CHEB_GATE,
                        "ext_error": float(errs[-1])}
    log(f"[surface] 21d Chebyshev fiber N={CHEB_N}, {CHEB_STEPS} steps of "
        f"dt {CHEB_DT} (f64): {device.type} {dev_s:.2f} s, CPU "
        f"{cpu_s:.2f} s; max rel difference {rel:.3e} (gate {CHEB_GATE}); "
        f"extensibility error {float(errs[-1]):.3e}")
    if not (rel <= CHEB_GATE and torch.isfinite(final).all()):
        raise SystemExit(f"21d: the Chebyshev fiber disagrees: {rel:.3e}")


def phase_surface(torch, ck, device, work, p4_dir, step_s, field, traj6,
                  smi):
    """Phase 21: 21a (`surface_natives`, then phase 4's directory goes),
    21b (`surface_paraview`), 21c (`surface_flow`), 21d
    (`surface_chebyshev`). Returns (summary, 21c's launch counts)."""
    t0 = time.perf_counter()
    traj = os.path.join(p4_dir, "skelly_sim.out")
    out = {}
    state = surface_state(torch, device, traj)
    surface_natives(torch, device, state, traj, step_s, out)
    shutil.rmtree(p4_dir)
    stamp("phase 21a")
    surface_paraview(torch, device, work, field, traj6, out)
    stamp("phase 21b")
    counts = surface_flow(torch, ck, device, state, out)
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stamp("phase 21c")
    surface_chebyshev(torch, device, out)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[surface] phase 21: {out['phase_s']:.1f} s on "
        f"{smi or 'the CPU'}")
    return out, counts


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--spmd-worker"]:
        return spmd_worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fibers", type=int, default=10_000,
                    help="fibers of the free-space path")
    ap.add_argument("--ellipsoid-fibers", type=int, default=2000)
    ap.add_argument("--shell-nodes", type=int, default=8000)
    ap.add_argument("--di-sites", type=int, default=1000,
                    help="nucleation sites of phase 10's centrosome")
    ap.add_argument("--ensemble-lanes", type=int, default=8,
                    help="phase 15's members (replicas) and lanes")
    ap.add_argument("--ensemble-shell-nodes", type=int, default=2000)
    ap.add_argument("--ensemble-body-nodes", type=int, default=400)
    ap.add_argument("--ensemble-sites", type=int, default=256)
    ap.add_argument("--ensemble-bound", type=int, default=128,
                    help="phase 15's bound fibers (the first capacity rung)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the card and has nothing to run here",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader
    from skellysim_tpu_torch.ops import cuda_build
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    device = torch.device(args.device)
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="skelly_smoke_")
    try:
        (entries, launches, smi, fast, tree, spmd, ens, options,
         flight, serve, cost_roof, audit, completion) = run_phases(
             torch, ck, cuda_build, TrajectoryReader, device, args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")

    if device.type != "cuda":
        log("rehearsal on the CPU passed (no result line: nothing was "
            "measured on a card)")
        return 0
    for e in entries:
        e["launches_by_path"] = {path: c[e["name"]]
                                 for path, c in launches.items()}
    print(json.dumps({"fast_evaluators": fast}), flush=True)
    print(json.dumps({"treecode": tree}), flush=True)
    print(json.dumps({"spmd": spmd}), flush=True)
    print(json.dumps({"ensemble": ens}), flush=True)
    print(json.dumps({"options": options}), flush=True)
    print(json.dumps({"flight_listener": flight}, default=str), flush=True)
    print(json.dumps({"serve": serve}, default=str), flush=True)
    print(json.dumps({"cost_roofline": cost_roof}, default=str), flush=True)
    print(json.dumps({"audit": audit}, default=str), flush=True)
    print(json.dumps({"completion": completion}, default=str), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


def run_phases(torch, ck, cuda_build, TrajectoryReader, device, args, work):
    """Phases 1-21 (10-14 and 16a-c run after 8, on phase 6's precompute,
    then 9, then 15, 16d, 17, 18, 19, 20 and 21); returns (kernel entries,
    launch counts by path, the nvidia-smi line, phase 11's summary, phase
    12's, phase 13's with phase 14's, phase 15's, phase 16's, phase 17's,
    phase 18's, phase 19's, phase 20's, phase 21's)."""
    import numpy as np

    # 1. device
    smi = None
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        log(f"[device] nvidia-smi: {smi}")
        log(f"[device] torch: {torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.device_count()} device(s) visible, this run uses "
            f"one; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build: one nvcc per source, all started together
    if device.type == "cuda":
        names = ck.SOURCES
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(names)) as pool:
            infos = list(pool.map(cuda_build.build, names))
        log(f"[build] {len(names)} source(s) in parallel: "
            f"{time.perf_counter() - t0:.1f} s")
        for name, info in zip(names, infos):
            log(f"[build] {name}.cu: {info['seconds']:.1f} s "
                f"(cached={info['cached']}) -> "
                f"{os.path.relpath(info['path'], REPO)}")
            for line in info["ptxas"].splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling" in line or "warning" in line):
                    log(f"[build] ptxas: {line.strip()}")
            spills = [int(v) for v in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", info["ptxas"])]
            gated = name in (ck.STOKESLET_SOURCE, ck.STRESSLET_SOURCE,
                             ck.RING_SOURCE, ck.TREE_SOURCE)
            if gated and not spills:
                raise SystemExit(f"no ptxas report for {name}.cu: its spills "
                                 "are not verified")
            if gated and any(spills):
                raise SystemExit(f"ptxas reports spills in {name}.cu: "
                                 f"{spills}")

    stamp("phases 1-2")

    # 4's config first: its node positions are phase 3's inputs
    run_dir = os.path.join(work, "free_fibers_10k")
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "skelly_config.toml")
    t0 = time.perf_counter()
    config = make_config(cfg_path, args.fibers, T_FINAL)
    log(f"[run] wrote {args.fibers} x 64-node config in "
        f"{time.perf_counter() - t0:.1f} s")
    nodes = np.concatenate([np.asarray(f.x).reshape(-1, 3)
                            for f in config.fibers])
    del config

    # 3. kernels A and B vs plain and vs their first design
    f = np.random.default_rng(7).standard_normal(nodes.shape) / 63.0
    entries = design_check(torch, ck, cuda_build, device, "stokeslet", nodes,
                           nodes, f, smi, "kernels", sample=KERNEL_SAMPLE)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 3")

    # 4. the free-space path
    launches = {}
    wall, counts, peak, steps = phase_run(torch, ck, device, cfg_path,
                                          run_dir)
    report_run(ck, "run", wall, counts, peak, steps, round(T_FINAL / 5e-3),
               1e-8, device, ["stokeslet_f32", "stokeslet_f64"])
    launches["free_fibers_10k"] = counts
    reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
    last = reader.load_frame(len(reader) - 1)
    fibers = last["fibers"][1]
    xs = np.stack([m["x_"] for m in fibers])
    log(f"[run] trajectory: {len(reader)} frames, times {reader.times}, "
        f"last frame {len(fibers)} fibers, x {xs.shape}")
    if (len(reader) != len(steps) + 1 or abs(last["time"] - T_FINAL) > 1e-9
            or xs.shape != (args.fibers, 64, 3) or not np.isfinite(xs).all()):
        raise SystemExit("the trajectory does not hold the expected frames")
    reader.close()
    # phase 21a reads this trajectory again, then removes the directory
    p4_dir, p4_step_s = run_dir, steps[-1]["wall_s"]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 4")

    # 5. small reference check
    phase_check_small(torch, device)

    stamp("phase 5")

    # 6. the confined full-width path
    more, launches["ellipsoid"], ring_inputs, checks = phase_confined(
        torch, ck, cuda_build, device, work, args, smi)
    for e in entries:
        e.update(checks.get(e["name"], {}))
    entries += more
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 6")

    # 7. the fused ring kernels E and F
    sass = ring_sass(torch, ck, cuda_build, device)
    entries += phase_ring_kernels(
        torch, ck, device, (nodes, nodes, f, True),
        (ring_inputs["shell_nodes"], ring_inputs["fiber_nodes"],
         ring_inputs["f_dl"], False), smi, sass)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 7")

    # 8. the ellipsoid config through the ring evaluator
    launches["ellipsoid_ring"], at_run = phase_ring_run(
        torch, ck, device, ring_inputs, smi, sass)
    for e in entries:
        if e["name"] in at_run:
            e["at_ring_run_shape"] = at_run[e["name"]]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 8")

    # 10. the centrosome in the cell: DI, run and --resume, on phase 6's
    # precompute
    launches["ellipsoid_di"], at_di = phase_ellipsoid_di(
        torch, ck, device, ring_inputs["cfg_path"], work, args, smi)
    for e in entries:
        if e["name"] in at_di:
            e["at_ellipsoid_di_shapes"] = at_di[e["name"]]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 10")

    # 11. the fast evaluators, on phase 3's cloud and phase 6's precompute
    a_ms = next(e["ms"] for e in entries if e["name"] == "stokeslet_f32")
    fast, fast_launches = phase_fast(torch, ck, device, work, args, nodes, f,
                                     a_ms, ring_inputs)
    launches.update(fast_launches)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 11")

    # 12. the treecode, on phase 3's cloud and phase 6's precompute
    b_ms = next(e["ms"] for e in entries if e["name"] == "stokeslet_f64")
    tree, tree_entries_, tree_launches = phase_tree(
        torch, ck, cuda_build, device, work, args, nodes, f, a_ms, b_ms,
        ring_inputs, smi)
    entries += tree_entries_
    launches.update(tree_launches)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 12")

    # 13. the sharded step, on phase 6's precompute
    spmd, spmd_launches, spmd_refs = phase_spmd(torch, ck, device,
                                                ring_inputs)
    launches.update(spmd_launches)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 13")

    # 14. the sharded step across processes sharing the card
    spmd["processes"], p14_launches = phase_spmd_processes(
        torch, ck, device, ring_inputs, spmd_refs, work, smi)
    launches.update(p14_launches)

    stamp("phase 14")

    # 16 a-c. the step's options: s-step GMRES, the guard ladder, the
    # "df" / "mxu" tiles, on phase 6's precompute and phase 3's cloud
    options, opt_launches = phase_options(torch, ck, device, ring_inputs,
                                          nodes, f, smi)
    launches.update(opt_launches)
    del nodes, f
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 16a-c")

    # 9. the body scene at its published size
    launches["body_const_force"], _, at_body = phase_bodies(
        torch, ck, device, work, smi)
    for e in entries:
        if e["name"] in at_body:
            e["at_body_shape"] = at_body[e["name"]]

    stamp("phase 9")

    # 15. the batched ensemble through its front door
    launches["ensemble"], at_ens, ens, mesh_inputs = phase_ensemble(
        torch, ck, device, work, args, smi, entries)
    for e in entries:
        if e["name"] in at_ens:
            e["at_ensemble_shapes"] = at_ens[e["name"]]
            e["launches_ensemble_batched"] = launches["ensemble"][
                e["name"] + "_batched"]

    stamp("phase 15")

    # 16d. phase 15's members on a member mesh of the card
    options["member_mesh"], mesh_launches = phase_member_mesh(
        torch, ck, device, mesh_inputs)
    launches.update(mesh_launches)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 16d")

    # 17. the flight recorder on every step path, velocity_at_targets and
    # the listener, on phase 6's precompute and trajectory and phase 15's
    # members
    t17 = time.perf_counter()
    flight_out, flight_launches = phase_flight_listener(
        torch, ck, device, ring_inputs, mesh_inputs, work)
    flight_out["phase_s"] = time.perf_counter() - t17
    launches.update(flight_launches)
    # 17b's field (on the card), which phase 21b writes through FieldWriter
    field = flight_out["velocity"].pop("_field")
    del mesh_inputs
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 17")

    # 18. the service: phase 15's scene as tenants, then phase 6's first
    # state for the tracer's host syncs
    t18 = time.perf_counter()
    serve, serve_launches = phase_serve(torch, ck, device, ring_inputs, work,
                                        args, smi)
    serve["phase_s"] = time.perf_counter() - t18
    launches.update(serve_launches)
    for e in entries:
        if e["name"] in ("stokeslet_f32", "stokeslet_f64", "stresslet_f32",
                         "stresslet_f64"):
            e["launches_serve_batched"] = launches["serve_vmap"][
                e["name"] + "_batched"]
            e["launches_serve_unroll"] = launches["serve_unroll"][e["name"]]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 18")

    # 19. cost and roofline: the registry counted on the device against
    # the CPU's baselines; phase 6's and 12d's profiled runs counted and
    # their dumps rated against the H100 row; the seams' host syncs
    t19 = time.perf_counter()
    cost_roof = phase_cost_roofline(torch, ck, device, ring_inputs, tree)
    cost_roof["phase_s"] = time.perf_counter() - t19
    # phase 6's trajectory outlives its directory: phase 21b reads it
    traj6 = os.path.join(work, "phase6_skelly_sim.out")
    os.replace(os.path.join(os.path.dirname(ring_inputs["cfg_path"]),
                            "skelly_sim.out"), traj6)
    del ring_inputs
    shutil.rmtree(os.path.join(work, "ellipsoid"))
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 19")

    # 20. the program auditor on the card: the CLI, the observer's host
    # syncs against the sync debug mode's, the poisoned dead slots, dma
    audit = phase_audit(torch, device, smi)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 20")

    # 21. the rest of the surface: the trajectory natives on phase 4's
    # trajectory, FieldWriter and the ParaView reader on 17b's field and
    # phase 6's frames, container.flow and the Morton sort on phase 4's
    # state, the Chebyshev fiber
    completion, launches["container_flow_10k"] = phase_surface(
        torch, ck, device, work, p4_dir, p4_step_s, field, traj6, smi)
    del field
    if device.type == "cuda":
        torch.cuda.empty_cache()

    stamp("phase 21")

    # each kernel's launches: those of the path its slice ported it for
    path_of = {"stokeslet_f32": "free_fibers_10k",
               "stokeslet_f64": "free_fibers_10k",
               "stresslet_f32": "ellipsoid", "stresslet_f64": "ellipsoid",
               "ring_stokeslet_f32": "ellipsoid_ring",
               "ring_stresslet_f32": "ellipsoid_ring",
               "tree_stokeslet_f32": "tree_ellipsoid",
               "tree_stresslet_f32": "tree_ellipsoid",
               "tree_stokeslet_f64": "tree_ellipsoid_full",
               "tree_stresslet_f64": "tree_ellipsoid_full"}
    for e in entries:
        e["launches"] = launches[path_of[e["name"]]][e["name"]]
    return (entries, launches, smi, fast, tree, spmd, ens, options,
            flight_out, serve, cost_roof, audit, completion)


if __name__ == "__main__":
    sys.exit(main())
